"""The port's benchmark: one cell of ``BENCHMARK.json`` on one card.

    python3 graphbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, solve kind or
per-layer metric sits in a file of its own, found by name:

- ``configs/<config>.json``: the graph's generator and its parameters, the
  partition, the source and what was cut from it;
- ``generators/<generator>.py``: ``generate(cfg, seed, device)``, the graph
  made on the device from the seed;
- ``traffic/<traffic>.json``: the solve sequence, its parameters and the
  root rule (``roots/<rule>.py``);
- ``solves/<kind>.py``: the port's ``Problem`` for a solve kind and the
  edges one solve covers;
- ``reference/<kind>.py``: the plain yardstick of a solve kind, with the
  numbers it compares and their limits;
- ``metrics/<metric>.py``: ``read(trace)``, one per-layer metric.

Set-up makes the graph from ``--seed`` on the device, partitions it with the
port's ``partition_2d`` on the host, and warms every solve kind of the
traffic once (the upload and the kernels' first load). The window then runs
the traffic's solves back to back through ``repro_torch.core.engine.run``
for ``--seconds``, one client, closed loop; a solve still running when the
window closes is not counted. With ``--trace 1`` the same window feeds the
per-layer readers, and a short profiled sub-window and the schedule traces
follow it. After the window the program's state is freed and the answers
of the solves chosen from the seed before the window (any that a short
window never reached are issued after it) are compared with the plain
reference on the same device.

``--cpu-rehearsal --scale N`` runs the same control flow on the CPU with the
kernels' plain versions; its last line names the CPU. Without it a run that
finds no card fails.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
PROFILE_SECONDS = 2.0  # the traced run's profiled sub-window, at least one unit


def _setup_paths(root: Path) -> None:
    """The checkout's harness and program on the import path."""
    for p in (str(root), str(root / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def load_json(root: Path, kind: str, name: str) -> dict:
    path = root / "graphbench" / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"graphbench: no {kind} file {path}")
    return json.loads(path.read_text())


def load_module(root: Path, kind: str, name: str):
    path = root / "graphbench" / kind / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"graphbench: no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"graphbench_{kind}_{re.sub(r'[^0-9A-Za-z_]', '_', name)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_plan(root: Path, cell: str) -> dict:
    """Everything a run of ``cell`` reads, found by name from
    ``BENCHMARK.json``: the cell, its configuration and traffic, the solve
    and reference modules of each solve kind, and its metrics."""
    _setup_paths(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise SystemExit(f"graphbench: no workload {cell!r} in BENCHMARK.json")
    w = cells[cell]

    def here(metric):
        return "workloads" not in metric or cell in metric["workloads"]

    traffic = load_json(root, "traffic", w["traffic"])
    kinds = sorted({s["kind"] for s in traffic["solves"]})
    return {
        "cell": w,
        "config": load_json(root, "configs", w["config"]),
        "traffic": traffic,
        "solves": {k: load_module(root, "solves", k) for k in kinds},
        "reference": {k: load_module(root, "reference", k) for k in kinds},
        "end_to_end": [m for m in bench["end_to_end"] if here(m)],
        "per_layer": [(m, load_module(root, "metrics", m["name"]))
                      for m in bench["per_layer"] if here(m)],
    }


class Graph:
    """The generated graph: the program's host ``COOGraph`` and, until
    ``release_device``, the same arrays on the device. Connected components
    (for root rules and the edges a rooted solve covers) are worked out on
    the device when first asked for."""

    def __init__(self, made: dict):
        import numpy as np

        from repro_torch.core.graph import COOGraph

        self.num_vertices = int(made["num_vertices"])
        self.num_edges = int(made["src"].numel())
        self._dev = (made["src"], made["dst"], made["weights"])
        w = made["weights"]
        self.coo = COOGraph(
            src=made["src"].cpu().numpy().astype(np.uint32),
            dst=made["dst"].cpu().numpy().astype(np.uint32),
            num_vertices=self.num_vertices,
            weights=w.cpu().numpy() if w is not None else None,
        )
        self.device = made["src"].device
        self._comp = None

    def device_arrays(self):
        """(src int64, dst int64, weights float32 | None) on the device."""
        import torch

        if self._dev is None:
            c = self.coo
            self._dev = (torch.from_numpy(c.src.astype("int64")).to(self.device),
                         torch.from_numpy(c.dst.astype("int64")).to(self.device),
                         torch.from_numpy(c.weights).to(self.device)
                         if c.weights is not None else None)
        return self._dev

    def release_device(self) -> None:
        self._dev = None

    def components(self):
        """Component label of each vertex (its smallest member), host numpy."""
        import torch

        if self._comp is None:
            src, dst, _ = self.device_arrays()
            lab = torch.arange(self.num_vertices, device=self.device)
            while True:
                nxt = lab.scatter_reduce(0, dst, lab[src], reduce="amin")
                nxt = nxt[nxt]  # labels only fall, and stay in the component
                if torch.equal(nxt, lab):
                    break
                lab = nxt
            edges = torch.bincount(lab[src], minlength=self.num_vertices)
            sizes = torch.bincount(lab, minlength=self.num_vertices)
            self._comp = (lab.cpu().numpy(), edges.cpu().numpy(), int(torch.argmax(sizes)))
        return self._comp[0]

    def largest_component(self) -> int:
        self.components()
        return self._comp[2]

    def component_edges(self, root: int) -> int:
        """Directed edges whose source lies in ``root``'s component."""
        comp = self.components()
        return int(self._comp[1][comp[root]])


@dataclass
class Solve:
    kind: str
    root: object
    t0: float
    t1: float
    iterations: int
    edges: int
    labels: object  # the program's answer (host numpy), kept where it is compared

    def record(self) -> dict:
        return {"kind": self.kind, "root": self.root, "wall_s": self.t1 - self.t0,
                "iterations": self.iterations, "edges": self.edges}


class Runner:
    """Issues the traffic's solves through the port's engine."""

    def __init__(self, plan: dict, graph: Graph, pg, dev, roots):
        from repro_torch.core.engine import EngineOptions

        self.plan, self.graph, self.pg, self.dev = plan, graph, pg, dev
        self.roots = roots
        self.opts = {}
        for spec in plan["traffic"]["solves"]:
            mod = plan["solves"][spec["kind"]]
            extra = mod.engine_options(spec["params"]) if hasattr(mod, "engine_options") else {}
            self.opts[spec["kind"]] = EngineOptions(**{**extra, **spec["engine"]})

    def problem(self, spec: dict, root):
        return self.plan["solves"][spec["kind"]].problem(spec["params"], root)

    def units(self, start: int = 0):
        """The solve sequence: for each root in turn (or forever, for traffic
        without roots), each solve of the traffic once."""
        k = start
        while True:
            root = int(self.roots[k % len(self.roots)]) if self.roots is not None else None
            for spec in self.plan["traffic"]["solves"]:
                yield spec, root
            k += 1

    def solve(self, spec: dict, root, label: bool = False, keep: bool = False) -> Solve:
        import torch

        from repro_torch.core.engine import run

        kind = spec["kind"]
        problem = self.problem(spec, root)
        with (torch.profiler.record_function(f"graphbench.solve.{kind}") if label
              else contextlib.nullcontext()):
            t0 = time.perf_counter()
            res = run(problem, self.graph.coo, self.pg, self.opts[kind], device=self.dev)
            t1 = time.perf_counter()
        edges = self.plan["solves"][kind].edges(self.graph, root)
        return Solve(kind, root, t0, t1, res.iterations, edges,
                     res.labels[problem.merge_field] if keep else None)


def launch_counts() -> dict:
    from repro_torch.kernels.csr_gather_reduce import kernel as K
    from repro_torch.kernels.csr_gather_reduce import scatter as S

    return {"gather_reduce_cores": dict(K.LAUNCHES), "scatter_reduce_cores": dict(S.LAUNCHES)}


def launch_delta(before: dict, after: dict) -> dict:
    return {k: {v: n - before[k].get(v, 0) for v, n in after[k].items()
                if n - before[k].get(v, 0)} for k in after}


def profiled_window(runner: Runner, stream, seconds: float, on_card: bool) -> dict:
    """Solves under ``torch.profiler`` for at least ``seconds`` and at least
    one whole unit of the traffic; the sub-window's solves, its launch
    counts, its host-clock length and the reduced device trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from graphbench.devtrace import reduce_events

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    n_unit = len(runner.plan["traffic"]["solves"])
    before = launch_counts()
    solves = []
    with profile(activities=acts) as prof:
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        while len(solves) < n_unit or time.perf_counter() - t0 < seconds:
            solves.append(runner.solve(*next(stream), label=True))
        if on_card:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    out = {"solves": [s.record() for s in solves], "window_s": window_s,
           "launches": launch_delta(before, launch_counts())}
    if on_card:
        out.update(reduce_events(prof.events(), DeviceType.CUDA))
    return out


def schedule_traces(runner: Runner, groups) -> list:
    """``run_frontier_trace`` on the compared roots, for each solve kind
    that has a frontier schedule (after the window: it reads the device
    each iteration)."""
    from repro_torch.core.engine import dynamic_skip_enabled, run_frontier_trace

    out = []
    for spec, root in groups:
        problem = runner.problem(spec, root)
        opts = runner.opts[spec["kind"]]
        if not dynamic_skip_enabled(problem, runner.pg, opts):
            continue
        tr = run_frontier_trace(problem, runner.graph.coo, runner.pg, opts, device=runner.dev)
        out.append({"kind": spec["kind"], "root": root, "iterations": tr["iterations"],
                    "push_iterations": tr["push_iterations"],
                    "mean_skipped": tr["mean_dynamic_skipped_tile_fraction"]})
    return out


def compared_groups(plan: dict, roots) -> list:
    """The (solve spec, root) pairs whose answers are compared, chosen from
    the seed before the window: every solve for traffic without roots; else
    each solve of the first ``compare_roots`` roots the window walks."""
    solves = plan["traffic"]["solves"]
    if roots is None:
        return [(spec, None) for spec in solves]
    picked = [int(r) for r in roots[1:1 + int(plan["traffic"]["compare_roots"])]]
    return [(spec, root) for root in picked for spec in solves]


def compare(plan: dict, graph: Graph, solves: list, groups: list) -> tuple[dict, int]:
    """Each compared group's reference, once, against every answer of that
    group: the largest reading of each number, and how many answers broke a
    limit."""
    import torch

    src, dst, w = graph.device_arrays()
    worst, failed = {}, 0
    for spec, root in groups:
        ref_mod = plan["reference"][spec["kind"]]
        want = ref_mod.solve(src, dst, w, graph.num_vertices, root, spec["params"],
                             dtype=torch.float64)
        for s in solves:
            if s.kind != spec["kind"] or s.root != root:
                continue
            nums = ref_mod.compare(s.labels, want)
            failed += any(v > ref_mod.LIMITS[k] for k, v in nums.items())
            for k, v in nums.items():
                worst[k] = max(worst.get(k, v), v)
    checks = {}
    for kind in sorted(plan["reference"]):
        for k, limit in plan["reference"][kind].LIMITS.items():
            if k in worst:
                checks[k] = {"value": worst[k], "limit": limit}
    return checks, failed


def card_name_and_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run the control flow on the CPU with the kernels' plain versions")
    ap.add_argument("--scale", type=int, default=None,
                    help="the graph's scale (rehearsal only)")
    args = ap.parse_args(argv)
    if args.scale is not None and not args.cpu_rehearsal:
        ap.error("--scale is for --cpu-rehearsal only: a cell runs at its configuration's scale")
    return args


def info(msg: str) -> None:
    print(f"graphbench: {msg}", file=sys.stderr, flush=True)


def main(argv=None, root: Path = ROOT) -> int:
    args = parse_args(argv)
    # build and kernel caches at fixed paths inside the checkout (the port's
    # nvcc builds already go to <checkout>/build/repro_torch)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(root / "build" / "graphbench" / sub)
    plan = cell_plan(root, args.workload)

    import numpy as np
    import torch

    on_card = not args.cpu_rehearsal
    if on_card:
        need = int(plan["cell"]["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            info(f"needs {need} CUDA device(s); found "
                 f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        dev = torch.device("cuda")
        info(f"card: {card_name_and_limit()}")
    else:
        dev = torch.device("cpu")
    cfg = dict(plan["config"])
    if args.scale is not None:
        cfg["scale"] = args.scale
    seed = args.seed % (1 << 63)

    from repro_torch.core.partition import PartitionConfig, partition_2d

    # -- set-up: the graph from the seed, the roots, the partition, warm solves
    made = load_module(root, "generators", cfg["generator"]).generate(cfg, seed, dev)
    graph = Graph(made)
    del made
    rule = plan["traffic"]["roots"]
    roots = load_module(root, "roots", rule).roots(graph, seed) if rule else None
    graph.release_device()
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    pg = partition_2d(graph.coo, PartitionConfig(**cfg["partition"]))
    partition_s = time.perf_counter() - t
    mem_before = torch.cuda.memory_allocated() if on_card else None
    runner = Runner(plan, graph, pg, dev, roots)
    for spec in plan["traffic"]["solves"]:  # the warm solve of each kind
        runner.solve(spec, int(roots[0]) if roots is not None else None)
    mem_after = torch.cuda.memory_allocated() if on_card else None

    # -- the window
    groups = compared_groups(plan, roots)
    kept = {root for _, root in groups}
    stream = runner.units(start=1)
    solves = []
    t_open = time.perf_counter()
    setup_s = t_open - T_PROCESS
    close = t_open + args.seconds
    while time.perf_counter() < close:
        spec, root = next(stream)
        solves.append(runner.solve(spec, root, keep=root in kept))
    done = [s for s in solves if s.t1 <= close]
    info(f"window: {len(done)} solves completed of {len(solves)} started; "
         f"set-up {setup_s:.3f} s (partition_2d {partition_s:.3f} s)")
    # a compared solve that a short window never reached is issued now, through
    # the same path, and counts in no metric
    reached = {(s.kind, s.root) for s in solves}
    late = [runner.solve(spec, root, keep=True) for spec, root in groups
            if (spec["kind"], root) not in reached]
    if late:
        info(f"{len(late)} compared solves issued after the close")

    trace = None
    if args.trace:
        profile = profiled_window(runner, stream, PROFILE_SECONDS if on_card else 0.0, on_card)
        trace = {
            "partition_s": partition_s,
            "device_bytes_upload": mem_after - mem_before if on_card else None,
            "num_vertices": graph.num_vertices,
            "num_edges": graph.num_edges,
            "solves": [s.record() for s in done],
            "profile": profile if profile.get("device_events") else None,
            "schedule": schedule_traces(runner, groups),
        }
        if on_card:
            seen = {k: v["events"] for k, v in profile.get("kernels", {}).items()
                    if "reduce_cores" in k}
            info(f"profiler: {profile.get('device_events', 0)} device events; the port's "
                 f"kernels: events seen {seen}, launches counted {profile['launches']}")

    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0

    # -- the program's state freed, then the comparison with the reference
    pg.device_cache.clear()
    del runner, pg
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks, failed = compare(plan, graph, solves + late, groups)
    info(f"reference comparison: {time.perf_counter() - t:.3f} s")
    correct = failed == 0 and bool(checks) and all(
        c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    if args.trace:
        for m, reader in plan["per_layer"]:
            v = reader.read(trace)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = {
            "mteps": sum(s.edges for s in done) / args.seconds / 1e6,
            "setup_s": setup_s,
        }
        for m in plan["end_to_end"]:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    if on_card:
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": int(plan["cell"]["chips"]), "memory_peak_bytes": int(memory_peak)}
    else:
        device = {"platform": "cpu", "kind": "cpu (rehearsal)", "count": 1,
                  "memory_peak_bytes": 0}
    result = {"correct": correct, "attempted": len(solves) + len(late), "failed": failed,
              "metrics": metrics, "device": device}
    if trace is not None and trace["profile"] is not None:
        prof = trace["profile"]
        device.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        result["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    result["checks"] = checks
    # last, once the comparison and the readers have run: whatever they
    # loaded counts too
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        info(f"modules loaded that the benchmark may not load: {loaded}")
        return 3
    for name, c in checks.items():
        info(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
