"""The blur slider swept from radii[0] up to radii[1] and back, one event a
step: the display's kernel set to mkgaussian(r), then step over the lens's
box, as the fast server's set_blur does; the seed sets the starting radius.
Events: ("blur", r)."""

from __future__ import annotations

import itertools

PIECES = False
INITIAL = None  # the slider's radius; None: the configuration's


def _sweep(params: dict):
    lo, hi = params["radii"]
    return list(range(lo, hi + 1)) + list(range(hi - 1, lo, -1))


def prepare(spec: dict, config: dict, rng) -> dict:
    params = dict(spec)
    params["phase"] = int(rng.integers(0, len(_sweep(params))))
    return params


def events(params: dict, seed: int):
    sweep = _sweep(params)
    for k in itertools.count(params["phase"]):
        yield ("blur", sweep[k % len(sweep)])


def open_session(desc: dict, device, spans):
    from ..port import Session

    return Session(desc, device, animated=True, spans=spans)


def apply(session, ev) -> None:
    from coherence_tpu_torch.raster import convolve

    with session.spans.span("set_kernel"):
        session.disp.kernel = convolve.mkgaussian(ev[1])
    with session.spans.span("step"):
        session.disp.step(session.lens_box)


def fold(state, ev):
    return ev[1]


def outputs(ref, desc: dict, state, memo: dict):
    from ..check import blob_outputs

    return blob_outputs(ref, desc, (0, 0), desc["blur_radius"] if state is None else state, memo)
