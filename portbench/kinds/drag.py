"""A dragged blob: each event moves the blob by `step`, the sign flipping
every `reverse_every` moves; the seed sets the starting phase.  The blob is
built at the configuration's place for every seed, and the warm-up's first
event moves it to the phase's start: its sprite, cut to the frame's tile
grid where it is built, then has one size whatever the seed, and so has
each event's window.  `entry` names the port's route: `step_animated` (the
tile route's fused animated step) or `translate_step` (translate_object,
then step over the union of the old and new boxes).  Events: (entry, dx,
dy)."""

from __future__ import annotations

import itertools
from typing import Tuple

PIECES = False
INITIAL = (0, 0)  # the blob's move from where it began


def delta(params: dict, k: int) -> Tuple[int, int]:
    """The k-th move since the phase's start."""
    dx, dy = params["step"]
    return (dx, dy) if (k // params["reverse_every"]) % 2 == 0 else (-dx, -dy)


def prepare(spec: dict, config: dict, rng) -> dict:
    params = dict(spec)
    params["phase"] = int(rng.integers(0, 2 * params["reverse_every"]))
    return params


def events(params: dict, seed: int):
    moved = [delta(params, k) for k in range(params["phase"])]
    jump = (sum(d[0] for d in moved), sum(d[1] for d in moved))
    if jump != (0, 0):
        yield (params["entry"], *jump)
    for k in itertools.count(params["phase"]):
        yield (params["entry"], *delta(params, k))


def open_session(desc: dict, device, spans):
    from ..port import Session

    return Session(desc, device, animated=True, spans=spans)


def apply(session, ev) -> None:
    entry, dx, dy = ev
    sp = session.spans.span
    if entry == "step_animated":
        with sp("step_animated"):
            session.disp.step_animated(session.blob_key, dx, dy)
    elif entry == "translate_step":
        from coherence_tpu_torch.raster import region

        prev = session.view.sprites[session.blob_key].box
        with sp("translate_object"):
            session.view.translate_object(session.blob_key, dx, dy)
        with sp("step"):
            session.disp.step(region.box_union(prev, session.view.sprites[session.blob_key].box))
    else:
        raise ValueError(f"no such drag entry: {entry!r}")


def fold(state, ev):
    return (state[0] + ev[1], state[1] + ev[2])


def outputs(ref, desc: dict, state, memo: dict):
    from ..check import blob_outputs

    return blob_outputs(ref, desc, state, desc["blur_radius"], memo)
