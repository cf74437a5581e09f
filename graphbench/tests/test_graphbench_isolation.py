"""No module the harness loads has ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``repro`` as its top-level name, compared whole (the port's
``repro_torch`` begins with ``repro``), up to the result line: one loaded
by the comparison or a reader after the window fails the run too. Checked in a subprocess: a test
worker imports every test file, the JAX package's included."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELL = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"][0]["name"]
ARGS = ["--workload", CELL, "--seed", "41", "--seconds", "1", "--trace", "1",
        "--cpu-rehearsal", "--scale", "12"]


def _run(prelude: str):
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"{prelude}\n"
        "from graphbench import run\n"
        f"rc = run.main({ARGS!r})\n"
        "print(json.dumps({'rc': rc, 'top': sorted({m.split('.')[0] for m in sys.modules})}))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.strip().splitlines(), proc.stderr


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    lines, _ = _run("")
    seen = json.loads(lines[-1])
    assert seen["rc"] == 0
    assert json.loads(lines[-2])["correct"] is True
    assert "repro_torch" in seen["top"]
    assert not {"jax", "jaxlib", "flax", "repro"} & set(seen["top"])


def test_a_loaded_jax_package_fails_the_run_without_a_result():
    # a stand-in module named ``repro``: the harness's own look must catch it
    lines, err = _run("import types; sys.modules['repro'] = types.ModuleType('repro')")
    assert json.loads(lines[-1])["rc"] != 0
    assert len(lines) == 1  # no result line
    assert "repro" in err


LATE = {
    # the reference's comparison, after the window
    "compare": """
import types
from graphbench import run as _r
_compare = _r.compare
def compare(*a, **k):
    sys.modules['repro'] = types.ModuleType('repro')
    return _compare(*a, **k)
_r.compare = compare
""",
    # a per-layer reader, after the comparison
    "reader": """
import types
from graphbench import run as _r
_plan = _r.cell_plan
def cell_plan(*a, **k):
    plan = _plan(*a, **k)
    reader = plan["per_layer"][-1][1]
    _read = reader.read
    def read(trace):
        sys.modules['repro'] = types.ModuleType('repro')
        return _read(trace)
    reader.read = read
    return plan
_r.cell_plan = cell_plan
""",
}


@pytest.mark.parametrize("where", sorted(LATE))
def test_a_jax_package_loaded_after_the_window_fails_the_run(where):
    lines, err = _run(LATE[where])
    assert json.loads(lines[-1])["rc"] != 0
    assert len(lines) == 1  # no result line
    assert "repro" in err
