"""On the card: one short run of each cell from the command line, correct
and with its result line; and the control at the cell's own size, which the
check must call wrong.  Skips where there is no card:

    python -m pytest portbench/tests/test_portbench_card.py -q -p no:cacheprovider"""

import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
CELLS = ["lion_1080p.drag", "interactive_4k.zoom", "interactive_4k.drag"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct(card, name):
    out = subprocess.run([sys.executable, os.path.join(HERE, "run.py"), "--workload", name, "--seed", "2147483659",
                          "--seconds", "3", "--trace", "0"], capture_output=True, text=True, timeout=1200, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_at_full_size_is_not_correct(card, name):
    from portbench import bench, control

    c, entry, _, _ = bench.cell_of(bench.load_benchmark(), name)
    got = control.control_numbers(c, bench.load_config(entry), 2147483661, "cuda")
    assert all(v["value"] > v["limit"] for v in got["numbers"].values()), got["numbers"]
