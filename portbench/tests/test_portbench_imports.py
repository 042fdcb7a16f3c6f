"""What the benchmark loads: no module whose top-level name is jax, jaxlib,
flax or coherence_tpu anywhere in portbench/, and nothing of
coherence_tpu_torch in the reference.  Names are compared whole: the port's
name begins with the JAX package's."""

import ast
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def _top_imports(path):
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def _sources(sub=""):
    base = os.path.join(HERE, sub)
    return sorted(os.path.join(d, f) for d, _, fs in os.walk(base) for f in fs if f.endswith(".py"))


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_in_the_harness(path):
    assert not _top_imports(path) & {"jax", "jaxlib", "flax", "coherence_tpu"}


@pytest.mark.parametrize("path", _sources("reference"), ids=lambda p: os.path.relpath(p, HERE))
def test_reference_imports_nothing_of_the_program(path):
    assert "coherence_tpu_torch" not in _top_imports(path)


def test_whole_names(monkeypatch):
    from portbench import bench

    if {m.split(".")[0] for m in sys.modules} & set(bench.FORBIDDEN):
        pytest.skip("this process loaded the JAX package already")
    monkeypatch.setitem(sys.modules, "coherence_tpu_torch.fake_part", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert bench.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "coherence_tpu.fake_part", object())
    assert bench.forbidden_modules() == ["coherence_tpu"]


def test_reference_loads_alone():
    code = ("import sys; sys.path.insert(0, %r); import portbench.reference.render, portbench.check; "
            "bad = {m.split('.')[0] for m in sys.modules} & {'coherence_tpu_torch', 'coherence_tpu', 'jax'}; "
            "print(sorted(bad)); sys.exit(1 if bad else 0)") % ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_run_refuses_without_a_card():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    out = subprocess.run([sys.executable, os.path.join(HERE, "run.py"), "--workload", "lion_1080p.drag",
                          "--seed", "1", "--seconds", "1"], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
