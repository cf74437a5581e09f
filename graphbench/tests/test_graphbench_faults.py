"""The correctness check sees faults and its control. A run is driven on
the CPU (the rehearsal switch skips the look for a card) with the timed path
broken underneath, and ``correct`` has to come out false: a step that
returns its state unchanged; half of the edge stream left out (the sources of
every other phase send the reduce's identity); an answer altered where
the engine produces it. (The cells run on one card: there is no exchange
between chips to leave out.) The control, the plain reference in bfloat16
in the program's place, fails the same comparison."""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from graphbench import control  # noqa: E402

FAULTS = {
    "state_unchanged": """
orig = E.make_iteration
def make_iteration(*a, **k):
    it = orig(*a, **k)
    def unchanged(labels, frontier=None, prev_push=None, pop=None):
        if frontier is None:
            return labels
        out = (labels, torch.zeros_like(frontier))
        return out + ((False,) if prev_push is not None else ())
    return unchanged
E.make_iteration = make_iteration
""",
    "half_the_edges": """
orig = E._gather_local
def _gather_local(problem, pg, labels, m):
    block = orig(problem, pg, labels, m)
    return torch.full_like(block, problem.stored_identity) if m % 2 else block
E._gather_local = _gather_local
""",
    "answer_altered": """
orig = E.unpad_labels
def unpad_labels(labels, pg, u32_fields=()):
    out = orig(labels, pg, u32_fields)
    x = out["label"]
    i = int(np.argmin(x))
    x[i] = x[i] + x.dtype.type(1)
    return out
E.unpad_labels = unpad_labels
""",
}
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault, cell):
    args = ["--workload", cell, "--seed", "2147483659", "--seconds", "1", "--trace", "0",
            "--cpu-rehearsal", "--scale", "12"]
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "import numpy as np, torch\n"
        "import repro_torch.core.engine as E\n"
        f"{FAULTS[fault]}\n"
        "from graphbench import run\n"
        f"sys.exit(run.main({args!r}))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is False
    assert line["failed"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_bfloat16_control_is_not_correct(cell):
    for seed in (7, 2**31 + 3):
        got = control.readings(ROOT, cell, seed, torch.device("cpu"), scale=10)
        assert got["correct"] is False, got
