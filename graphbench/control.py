"""The control of each cell's correctness check: the plain reference put in
the program's place, computed one precision below the configuration's
(bfloat16 for its float32 solves), and judged by the same comparison and
limits as a run. It has to come out not correct.

    python3 graphbench/control.py --workload <cell> --seeds 11,12,13

For each seed it makes the cell's graph and roots as a run does, takes the
solves that a run of that seed compares (``run.compared_groups``), and
prints one JSON line with the largest reading of each number beside its
limit. No partition is built: the program does not
run here.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(root: Path, cell: str, seed: int, device, scale=None) -> dict:
    import torch

    from graphbench.run import Graph, cell_plan, compared_groups, load_module

    plan = cell_plan(root, cell)
    cfg = dict(plan["config"], **({"scale": scale} if scale is not None else {}))
    seed = seed % (1 << 63)
    graph = Graph(load_module(root, "generators", cfg["generator"]).generate(cfg, seed, device))
    rule = plan["traffic"]["roots"]
    order = load_module(root, "roots", rule).roots(graph, seed) if rule else None
    src, dst, w = graph.device_arrays()
    worst = {}
    for spec, root_v in compared_groups(plan, order):
        ref = plan["reference"][spec["kind"]]
        want = ref.solve(src, dst, w, graph.num_vertices, root_v, spec["params"],
                         dtype=torch.float64)
        low = ref.solve(src, dst, w, graph.num_vertices, root_v, spec["params"],
                        dtype=torch.bfloat16)
        for k, v in ref.compare(ref.program_form(low), want).items():
            worst[k] = max(worst.get(k, v), v)
    limits = {k: v for ref in plan["reference"].values() for k, v in ref.LIMITS.items()}
    return {"cell": cell, "seed": seed, "dtype": "bfloat16",
            "correct": all(v <= limits[k] for k, v in worst.items()),
            "checks": {k: {"value": v, "limit": limits[k]} for k, v in worst.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    for s in args.seeds.split(","):
        print(json.dumps(readings(ROOT, args.workload, int(s), torch.device("cuda"))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
