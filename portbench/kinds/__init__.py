"""Event kinds, one module a kind, named by a traffic mix's `kind` key
(portbench/traffic/<mix>.json).  A kind is everything the harness knows of
one sort of user input; bench.py, check.py and control.py reach it only
through its module, so a new kind is a new file here and nothing else.

A kind's module supplies:

  PIECES                  True where a run keeps the atlas and each object's
                          piece list at a snapshot and the check compares them;
  prepare(spec, config, rng) -> params
                          the mix's parameters with what the seed fixes (a
                          phase);
  events(params, seed)    the endless stream of events, warm-up first;
  extra_snapshots(spec, n_warmup, rng)   (optional) events the check must see;
  open_session(desc, device, spans) -> port.Session
                          the port's view of the scene built for this kind;
  apply(session, ev)      one event through the port's entry points, each
                          call inside `session.spans.span(<name>)`; returns
                          when the calls have returned, unsynchronized;
  INITIAL, fold(state, ev)  the reference's state: what the events so far
                          did, from the events alone;
  outputs(ref, desc, state, memo) -> (content, display, layers or None)
                          the reference's frames at `state` (layers where
                          PIECES); `memo` is one dict over a run's states.

The reference side (INITIAL, fold, outputs) imports nothing of the
program; the port side imports the program inside its functions."""

from __future__ import annotations

import importlib

import numpy as np


def load(kind: str):
    """portbench/kinds/<kind>.py."""
    return importlib.import_module(f"{__name__}.{kind}")


def seeded(seed: int, stream: int) -> np.random.Generator:
    """The generator of one stream of draws under `seed` (any whole number)."""
    return np.random.default_rng([stream, seed % 2**64])
