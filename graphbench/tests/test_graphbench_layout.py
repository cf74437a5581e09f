"""BENCHMARK.json against the contract's character rules and files, and the
harness driven by data: a configuration, a traffic mix, a cell and a
metric written as new files into a copy are found with no edit."""
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from graphbench.run import cell_plan  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_names_units_and_lines_use_the_allowed_characters():
    names = []
    for c in BENCH["configs"]:
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert LINE.match(c["source"]) and LINE.match(c["why"])
    for w in BENCH["workloads"]:
        names.append(w["name"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert LINE.match(w["why"]) and w["chips"] in (1, 4)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert LINE.match(m["layer"])
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    assert all(LINE.match(word) for word in BENCH["command"])


def test_every_named_file_exists_and_lies_under_paths():
    paths = [ROOT / p for p in BENCH["paths"]]
    for c in BENCH["configs"]:
        f = ROOT / c["file"]
        assert f.is_file() and any(p in f.parents for p in paths)
    for w in BENCH["workloads"]:
        plan = cell_plan(ROOT, w["name"])  # loads every file the cell names
        assert plan["config"]["name"] == w["config"]
        assert plan["cell"]["chips"] == 1
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert (ROOT / "graphbench" / "metrics" / f"{m['name']}.py").is_file()


def _copy(tmp_path, with_program=True):
    shutil.copytree(ROOT / "graphbench", tmp_path / "graphbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    if with_program:
        (tmp_path / "src").symlink_to(ROOT / "src")
    return tmp_path


def test_new_config_traffic_cell_and_metric_are_found_as_new_files(tmp_path):
    root = _copy(tmp_path)
    gb = root / "graphbench"
    cfg = json.loads((gb / "configs" / "gap-urand-s20.json").read_text())
    cfg.update(name="gap-urand-s12", scale=12)
    (gb / "configs" / "gap-urand-s12.json").write_text(json.dumps(cfg))
    traffic = json.loads((gb / "traffic" / "pagerank.json").read_text())
    traffic["solves"][0]["params"]["iterations"] = 5
    (gb / "traffic" / "pagerank-5.json").write_text(json.dumps(traffic))
    (gb / "metrics" / "engine.solves.py").write_text(
        "def read(t):\n    return float(len(t['solves']))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "gap-urand-s12", "source": "test",
                             "file": "graphbench/configs/gap-urand-s12.json",
                             "reduced": ["scale"], "why": "test"})
    bench["workloads"].append({"name": "gap-urand-s12.pagerank-5", "config": "gap-urand-s12",
                               "traffic": "pagerank-5", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "engine.solves", "unit": "solves", "better": "higher",
                               "source": "host_clock", "layer": "engine loop", "moves": "mteps",
                               "workloads": ["gap-urand-s12.pagerank-5"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    proc = subprocess.run(
        [sys.executable, str(gb / "run.py"), "--workload", "gap-urand-s12.pagerank-5",
         "--seed", "9", "--seconds", "3", "--trace", "1", "--cpu-rehearsal"],
        capture_output=True, text=True, timeout=300, cwd=root)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"]["engine.solves"]["unit"] == "solves"


def test_a_directory_without_the_program_fails_and_prints_no_result(tmp_path):
    root = _copy(tmp_path, with_program=False)
    proc = subprocess.run(
        [sys.executable, str(root / "graphbench" / "run.py"), "--workload",
         BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=root)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
