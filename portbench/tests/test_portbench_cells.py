"""Each cell's traffic run tiny on the CPU through the port's plain path and
held to the reference; then the same run with the timed path broken
underneath, which the check must call wrong; and the control, which it must
call wrong too."""

import pytest

from portbench import bench, control
from portbench.tests import tiny


@pytest.mark.parametrize("name", tiny.CELLS + list(tiny.KEPT))
def test_tiny_cell_is_correct(name, monkeypatch):
    tiny.small_traffic(monkeypatch)
    res = tiny.run(name, seconds=0.5 if "zoom" not in name else 2.0)
    assert res["failed"] == 0 and res["n"] >= 1
    assert res["checks"]["correct"], res["checks"]
    assert res["checks"]["answers"] >= 1
    assert all(v["value"] == 0 for v in res["checks"]["numbers"].values())
    assert bench.forbidden_modules() == []


def _unchanged(apply):
    """A step that returns its state unchanged."""
    return lambda session, ev: None


def _altered(apply):
    """An answer altered where it is produced: one display channel, one bit."""

    def altered(session, ev):
        apply(session, ev)
        session.disp.rgba[3, 5, 1] ^= 1

    return altered


def _break(name, fault, monkeypatch):
    """Break the cell's timed path underneath: its kind's `apply`."""
    kind = tiny.kind_of(name)
    monkeypatch.setattr(kind, "apply", fault(kind.apply))


@pytest.mark.parametrize("fault", [_unchanged, _altered], ids=["unchanged", "altered"])
@pytest.mark.parametrize("name", ["lion_1080p.drag", "interactive_4k.slider", "interactive_4k.drag"])
def test_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    tiny.small_traffic(monkeypatch)
    _break(name, fault, monkeypatch)
    res = tiny.run(name, seconds=0.3)
    assert not res["checks"]["correct"], res["checks"]


def test_broken_zoom_is_not_correct(monkeypatch):
    tiny.small_traffic(monkeypatch)
    _break("interactive_4k.zoom", _unchanged, monkeypatch)
    res = tiny.run("interactive_4k.zoom", seconds=1.0)
    assert not res["checks"]["correct"], res["checks"]


def test_zoom_misses_once_a_cycle(monkeypatch):
    tiny.small_traffic(monkeypatch)
    res = tiny.run("interactive_4k.zoom", seconds=3.0, trace=True)
    missed = res["traced"].missed
    assert len(missed) >= 4
    assert missed[::4] == [True] * len(missed[::4]) and not any(m for i, m in enumerate(missed) if i % 4)


@pytest.mark.parametrize("name", tiny.CELLS + list(tiny.KEPT))
def test_control_is_not_correct(name, monkeypatch):
    """The reference with its colour arithmetic in bfloat16, in the program's place."""
    tiny.small_traffic(monkeypatch)
    c, cfg = tiny.cell(name)
    for seed in (11, 12, 13):
        got = control.control_numbers(c, cfg, seed, "cpu")
        assert not got["correct"]
        assert all(v["value"] > v["limit"] for v in got["numbers"].values()), got["numbers"]


def test_traced_tiny_run_reads_its_metrics(monkeypatch):
    tiny.small_traffic(monkeypatch)
    res = tiny.run("lion_1080p.drag", seconds=0.3, trace=True)
    tr = res["traced"]
    assert tr.n_events == res["n"] and len(tr.host_ms) == res["n"]
    assert bench.metric_reader("host_ms_per_event")(tr) > 0
    assert bench.metric_reader("device_idle_share")(tr) is not None
