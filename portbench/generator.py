"""The one traffic generator: a traffic mix is a data file under
portbench/traffic/, and this module turns it, with a configuration and a
seed, into the run's events.

A mix names an event kind (a module of portbench/kinds/, which makes its
events and applies them) and that kind's parameters, with the events of
set-up (`warmup`) and where the check samples (`snapshots`).  Every seed
gets the same amount of work in another order: the seed sets a drag's
starting phase, a zoom's pointers and the slider's starting radius, never a
size."""

from __future__ import annotations

import json
import os
from typing import Iterator, List, NamedTuple

import numpy as np

from . import kinds

HERE = os.path.dirname(os.path.abspath(__file__))


class Traffic(NamedTuple):
    name: str
    kind: str  # the module of portbench/kinds/ that the mix names
    params: dict
    seed: int
    n_warmup: int  # events of set-up: the first of events()
    snapshots: List[int]  # event indices whose outputs the run keeps for the reference

    @property
    def module(self):
        return kinds.load(self.kind)

    def events(self) -> Iterator[tuple]:
        return self.module.events(self.params, self.seed)


def load(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", name + ".json")) as f:
        return json.load(f)


def make(name: str, config: dict, seed: int) -> Traffic:
    """The traffic `name` for `config` under `seed`."""
    spec = load(name)
    mod = kinds.load(spec["kind"])
    rng = kinds.seeded(seed, 1)
    params = mod.prepare(spec, config, rng)
    n_warmup = spec["warmup"]
    snaps = spec["snapshots"]
    picks = rng.choice(np.arange(n_warmup, n_warmup + snaps["within"]), size=snaps["count"], replace=False)
    picks = {int(v) for v in picks}
    if hasattr(mod, "extra_snapshots"):
        picks |= set(mod.extra_snapshots(spec, n_warmup, rng))
    return Traffic(name, spec["kind"], params, seed, n_warmup, sorted(picks))
