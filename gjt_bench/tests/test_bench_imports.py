"""What the benchmark's command and its reference load: no module whose
top-level name is jax, jaxlib, flax or the JAX package `gps_jamming_tpu`
(compared whole: the port `gps_jamming_tpu_torch` begins with it), and the
reference loads nothing of the port."""
import ast
import json
import subprocess
import sys

import pytest

from gjt_bench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "gps_jamming_tpu"}
PROBE = """
import json, sys
sys.path.insert(0, {root!r})
from gjt_bench import harness, render, roofline, trace
from gjt_bench.reference import codes, detect, monitor, precision, track
bench = harness.spec()
for w in bench["workloads"]:
    cell = harness.make_cell(bench, w["name"], 1, "cpu")
    harness.loop_of(cell)
for m in bench["per_layer"]:
    harness.load_module(harness.BENCH_DIR / "metrics" / (m["name"] + ".py"),
                        "probe_" + m["name"].replace(".", "_"))
{extra}
print(json.dumps(sorted(sys.modules)))
"""


def _loaded(extra=""):
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=str(harness.ROOT),
                                             extra=extra)],
        capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _top(mods):
    return {m.split(".")[0] for m in mods}


def test_the_command_loads_no_jax():
    # the harness, every loop and metric, and the program's entry points
    # that the loops call
    mods = _loaded("import gps_jamming_tpu_torch.entry\n"
                   "import gps_jamming_tpu_torch.runtime.pipeline")
    assert "gps_jamming_tpu_torch" in _top(mods)
    assert not (_top(mods) & FORBIDDEN)


def test_the_whole_name_is_compared(monkeypatch):
    assert set(harness.FORBIDDEN) == FORBIDDEN
    import types
    for name in ("gps_jamming_tpu_torch.x", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "gps_jamming_tpu.ops",
                        types.ModuleType("gps_jamming_tpu.ops"))
    assert harness.forbidden_modules() == ["gps_jamming_tpu.ops"]


def test_the_reference_loads_nothing_of_the_port():
    out = subprocess.run(
        [sys.executable, "-c",
         f"import sys, json; sys.path.insert(0, {str(harness.ROOT)!r});"
         "from gjt_bench.reference import codes, detect, monitor, precision, track;"
         "print(json.dumps(sorted(sys.modules)))"],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    top = _top(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not (top & (FORBIDDEN | {"gps_jamming_tpu_torch"}))


@pytest.mark.parametrize("path", sorted(
    (harness.BENCH_DIR / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_sources_import_nothing_of_the_port(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert not (names & (FORBIDDEN | {"gps_jamming_tpu_torch"}))


@pytest.mark.parametrize("path", sorted(harness.BENCH_DIR.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(harness.BENCH_DIR)))
def test_no_benchmark_source_names_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops = {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops = {node.module.split(".")[0]}
        else:
            continue
        assert not (tops & FORBIDDEN), (path, tops)
