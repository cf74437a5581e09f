"""Each cell of BENCHMARK.json run end to end on the CPU (the harness's
rehearsal switch, scale 12, the kernels' plain versions), in a subprocess:
the result line's keys, its device, and what a run without a card does."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def run_cell(cell, trace, *extra, root=ROOT, env=None):
    cmd = [sys.executable, str(root / "graphbench" / "run.py"), "--workload", cell,
           "--seed", str(2**31 + 101), "--seconds", "2", "--trace", str(trace), *extra]
    return subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=root,
                          env=dict(os.environ, OMP_NUM_THREADS="2", **(env or {})))


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_rehearsal_end_to_end(cell, trace):
    proc = run_cell(cell, trace, "--cpu-rehearsal", "--scale", "12")
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    # the compared numbers come last, under a key of their own
    assert list(line)[-1] == "checks"
    assert set(line) - {"checks"} <= KEYS | ({"breakdown"} if trace else set())
    assert KEYS <= set(line)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert line["device"]["platform"] == "cpu" and "cpu" in line["device"]["kind"]
    want = {m["name"] for m in BENCH["per_layer" if trace else "end_to_end"]
            if cell in m.get("workloads", CELLS)}
    got = set(line["metrics"])
    assert got <= want
    if trace:  # the device readers find nothing on the CPU and stay silent
        assert "partition.build_s" in got
        if line["attempted"] >= 2:  # the last solve started runs past the close
            assert {"engine.ms_per_iteration", "engine.solve_ms_p95"} <= got
        if "bfs" in cell:
            assert {"schedule.skipped_tile_share", "schedule.push_iteration_share"} <= got
        assert not {m for m in got if m.startswith(("device.", "kernel."))}
    else:
        assert got == want
    # the last lines on standard error are the compared numbers and limits
    tail = proc.stderr.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("graphbench: check ") and " limit " in t for t in tail)


def test_a_run_without_a_card_fails_and_prints_no_result():
    proc = run_cell(CELLS[0], 0, env={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA device" in proc.stderr


def test_scale_is_refused_outside_the_rehearsal():
    proc = run_cell(CELLS[0], 0, "--scale", "12")
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_compared_solves_a_short_window_never_reached_are_issued_after_it():
    # the roots drawn for comparison are compared even where the window is
    # too short to reach them: issued after the close, counted in no metric
    proc = subprocess.run(
        [sys.executable, str(ROOT / "graphbench" / "run.py"), "--workload", CELLS[0],
         "--seed", "5", "--seconds", "0.001", "--trace", "0", "--cpu-rehearsal",
         "--scale", "12"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
    assert "compared solves issued after the close" in proc.stderr
