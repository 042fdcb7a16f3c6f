"""profile_frame.queued_chain's frame indices and pass count, on the CPU.

chip_smoke.py's animated_chain phase requires each of shatter_into,
composite_dirty and blur_blend to launch once a frame on both scenes of
the chain, and its frames move the blob by frame index (chip_smoke.delta).
A rep that is retaken used to run its frame indices a second time, which
carried the blob on past the frame's edge, where a step launches less, and
the required count assumed no retake.  Here a stand-in card and scene
record the indices each scene runs: every pass takes the next indices,
none twice, both scenes run the same ones, and "passes" counts every pass,
retakes included.
"""

import os
import sys
from types import SimpleNamespace

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import profile_frame  # noqa: E402


class _Event:
    def __init__(self, enable_timing: bool = False):
        pass

    def record(self, stream=None):
        pass

    def synchronize(self):
        pass

    def elapsed_time(self, other) -> float:
        return 1.0


def _card():
    """A stand-in for the torch module: events and waits that do nothing."""
    cuda = SimpleNamespace(Event=_Event, synchronize=lambda: None, _sleep=lambda cycles: None)
    return SimpleNamespace(cuda=cuda, equal=lambda a, b: a == b)


def _scene():
    """(view, display, key): the view's frame and the display hold the
    last frame index run; the object's box never moves here."""
    view = SimpleNamespace(frame=None, sprites={"blob": SimpleNamespace(box=(1, 1, 8, 8))})
    return view, SimpleNamespace(rgba=None), "blob"


def _require(ok, what):
    if not ok:
        raise RuntimeError(what)


@pytest.fixture
def clock(monkeypatch):
    """queued_chain's host clock, in seconds, moved on only by the frames."""
    now = [0.0]
    monkeypatch.setattr(profile_frame, "time", SimpleNamespace(perf_counter=lambda: now[0]))
    return now


@pytest.mark.parametrize("slow_passes", [(), (3,), (3, 4), (2, 5)])
def test_every_pass_takes_the_next_frames_and_retakes_are_counted(clock, slow_passes):
    """Passes listed in `slow_passes` (0 the unqueued one, 1 the warm one,
    then the reps and their retakes in order) queue slower than half of
    their wait and so are retaken, on the next frames."""
    n, reps, first = 4, 3, 7
    state, reference = _scene(), _scene()
    ran = {id(state): [], id(reference): []}

    def frame(st, k):
        view, disp, _ = st
        clock[0] += 0.001
        if st is state and k % n == first % n and (k - first) // n in slow_passes:
            clock[0] += 1.0  # the wait is 20 ms or a few times that: this pass outlasts half of it
        ran[id(st)].append(k)
        view.frame = disp.rgba = k

    cs = SimpleNamespace(sleep_cycles_per_ms=lambda torch: 1.0, require=_require)
    row = profile_frame.queued_chain(_card(), cs, frame, state, reference, first=first, n=n, reps=reps)
    retakes = sum(1 for p in slow_passes if p >= 2)
    assert row["retaken"] == retakes
    assert row["passes"] == reps + 2 + retakes
    assert ran[id(state)] == list(range(first, first + n * row["passes"]))
    assert ran[id(reference)] == ran[id(state)]
    assert len(row["readings"]) == reps


def test_a_third_retake_raises(clock):
    n = 2
    state, reference = _scene(), _scene()

    def frame(st, k):
        clock[0] += 0.001
        if st is state and k >= 2 * n and k % n == 0:
            clock[0] += 1.0
        st[0].frame = st[1].rgba = k

    cs = SimpleNamespace(sleep_cycles_per_ms=lambda torch: 1.0, require=_require)
    with pytest.raises(RuntimeError, match="queueing 2 frames took"):
        profile_frame.queued_chain(_card(), cs, frame, state, reference, first=0, n=n, reps=1)
