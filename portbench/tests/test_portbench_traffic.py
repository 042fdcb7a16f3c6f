"""The traffic generator: every mix deterministic for a seed, the seed moving
only phases and pointers, never the amount of work."""

import itertools

import pytest

from portbench import generator
from portbench.kinds import drag
from portbench.tests.tiny import TINY

MIXES = {"animated_drag": "lion_1080p_blurfilter", "edit_drag": "interactive_4k", "zoom": "interactive_4k",
         "slider": "interactive_4k"}


def _first(t, n=60):
    return list(itertools.islice(t.events(), n))


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_same_seed_same_events(mix):
    cfg = TINY[MIXES[mix]]
    a, b = generator.make(mix, cfg, 2**31 + 7), generator.make(mix, cfg, 2**31 + 7)
    assert _first(a) == _first(b)
    assert (a.snapshots, a.n_warmup) == (b.snapshots, b.n_warmup)


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_seeds_differ_in_order_not_amount(mix):
    cfg = TINY[MIXES[mix]]
    runs = [generator.make(mix, cfg, s) for s in (1, 2, 3, 4, 5)]
    firsts = [_first(t) for t in runs]
    assert len({tuple(f) for f in firsts}) > 1
    # The same event kinds and sizes in every seed: only phases and pointers move.
    kinds = {tuple((e[0], len(e)) for e in f) for f in firsts}
    assert len(kinds) == 1
    for t in runs:
        assert all(t.n_warmup <= i < t.n_warmup + generator.load(mix)["snapshots"]["within"] for i in t.snapshots)


@pytest.mark.parametrize("mix", ["animated_drag", "edit_drag"])
def test_drag_jumps_to_the_phase_first(mix):
    """Every seed builds the blob at the configuration's place; the first
    event moves it by the phase's moves, then a whole period returns."""
    spec = generator.load(mix)
    for seed in range(40):
        t = generator.make(mix, TINY["lion_1080p_blurfilter"], seed)
        phase = t.params["phase"]
        moved = [drag.delta(spec, k) for k in range(phase)]
        jump = (sum(d[0] for d in moved), sum(d[1] for d in moved))
        ev = _first(t, 1 + 2 * spec["reverse_every"])
        assert all(e[0] == spec["entry"] for e in ev)
        if jump == (0, 0):
            ev = ev[:-1]
        else:
            assert ev[0][1:] == jump
            ev = ev[1:]
        assert ev[0][1:] == drag.delta(spec, phase)
        assert sum(e[1] for e in ev) == 0 and sum(e[2] for e in ev) == 0  # a whole period returns


def test_zoom_cycles_and_a_sampled_miss():
    t = generator.make("zoom", TINY["interactive_4k"], 77)
    ev = _first(t, 12)
    assert [e[3] for e in ev] == [2.0, 0.5, 2.0, 0.5] * 3
    assert [e[4] for e in ev] == [True, False, False, False] * 3
    w, h = TINY["interactive_4k"]["width"], TINY["interactive_4k"]["height"]
    assert ev[0][1:3] == (w // 2, h // 2)  # the warm-up's cycle
    for e in ev[4:]:
        assert w // 4 <= e[1] < 3 * w // 4 and h // 4 <= e[2] < 3 * h // 4
    assert any((i - t.n_warmup) % 4 == 0 for i in t.snapshots)


def test_slider_sweeps_one_to_ten_and_back():
    t = generator.make("slider", TINY["interactive_4k"], 5)
    radii = [e[1] for e in _first(t, 36)]
    assert sorted(set(radii)) == list(range(1, 11))
    assert all(abs(a - b) == 1 for a, b in zip(radii, radii[1:]))
