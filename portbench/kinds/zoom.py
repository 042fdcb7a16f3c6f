"""Zoom cycles about a pointer drawn from the seed, uniform over
`pointer_box` (shares of the frame): the scene scaled by each factor of
`cycle` in turn, the first from the unzoomed scene, the rest from the last.
The warm-up's cycle is about the frame's centre.  Each event is
zoom_transform + transform_renderobject_many + reset_scene(tiled=True) +
full_refresh.  Events: ("zoom", px, py, factor, restart)."""

from __future__ import annotations

import itertools

from . import seeded

PIECES = True
INITIAL = ()  # the transform ops applied to the unzoomed scene, outermost first


def prepare(spec: dict, config: dict, rng) -> dict:
    params = dict(spec)
    params["frame"] = (config["width"], config["height"])
    return params


def events(params: dict, seed: int):
    rng = seeded(seed, 2)
    w, h = params["frame"]
    x0, y0, x1, y1 = params["pointer_box"]
    pointer = (w // 2, h // 2)
    for c in itertools.count():
        if c > 0:
            pointer = (int(rng.integers(int(x0 * w), int(x1 * w))), int(rng.integers(int(y0 * h), int(y1 * h))))
        for i, f in enumerate(params["cycle"]):
            yield ("zoom", pointer[0], pointer[1], f, i == 0)


def extra_snapshots(spec: dict, n_warmup: int, rng):
    """One sampled event is a cycle's first: a scene-build cache miss."""
    cyc = len(spec["cycle"])
    return [n_warmup + cyc * int(rng.integers(0, spec["snapshots"]["within"] // cyc))]


def open_session(desc: dict, device, spans):
    from ..port import Session

    return Session(desc, device, animated=False, spans=spans)


def apply(session, ev) -> None:
    from coherence_tpu_torch.scene import fastframe
    from coherence_tpu_torch.scene import render as R

    _, px, py, f, restart = ev
    with session.spans.span("zoom_transform"):
        tmat = fastframe.zoom_transform(float(px), float(py), f)
        session.cur = [R.transform_renderobject_many(tmat, o) for o in (session.base if restart else session.cur)]
    with session.spans.span("reset_scene"):
        session.view.reset_scene(session.cur, tiled=True)
    with session.spans.span("full_refresh"):
        session.disp.full_refresh()


def fold(state, ev):
    _, px, py, f, restart = ev
    ops = (("T", float(px), float(py)), ("S", 0.0, 0.0, f, f), ("T", -float(px), -float(py)))
    return ops + (() if restart else state)


def outputs(ref, desc: dict, state, memo: dict):
    layers = ref.layers([desc["blob"]] + desc["objects"], state)
    content = ref.content(layers)
    return content, ref.display(content, desc["blur_radius"]), layers
