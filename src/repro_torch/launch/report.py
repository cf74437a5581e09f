"""Render the dry run's tables (all cells, both meshes) and the roofline per
mesh from its records.

Counterpart of ``repro.launch.report``:

    PYTHONPATH=src python -m repro_torch.launch.report > results/roofline.md
    PYTHONPATH=src python -m repro_torch.launch.report --out results/dryrun
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List

from repro_torch.launch.mesh import HW

__all__ = ["load", "dryrun_table", "roofline_table", "main"]

_LM = ("qwen3-14b", "smollm-135m", "llama3-8b", "granite-moe-1b-a400m", "qwen3-moe-30b-a3b")
_GNN = ("meshgraphnet", "schnet", "gat-cora", "gin-tu", "gcn-cora", "graphsage")


def load(out_dir: str = "results/dryrun") -> List[dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def dryrun_table(recs: List[dict]) -> str:
    fit = f"fits {HW.HBM_BYTES / 1e9:.0f}G"
    lines = [
        f"| cell | mesh | chips | trace s | peak bytes/dev GiB | {fit} | "
        "FLOPs/dev | bytes/dev | coll bytes/dev | collective mix | replicated work | "
        "peak held by |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(recs, key=lambda r: (r["key"], r["mesh"])):
        if r.get("status") != "ok":
            lines.append(f"| {r['key']} | {r['mesh']} | {r['chips']} | FAIL at "
                         f"`{r['op']}`: {r['error'].splitlines()[0][:120]} ||||||||")
            continue
        peak = r["memory"]["peak_bytes"]
        mix = ", ".join(f"{k}:{int(v)}" for k, v in r["collectives"]["count_by_kind"].items()
                        if v) or "none"
        lines.append(
            f"| {r['key']} | {r['mesh']} | {r['chips']} | {r['extras']['trace_s']:.1f} | "
            f"{peak / 2**30:.2f} | {'Y' if peak <= HW.HBM_BYTES else 'NO'} | "
            f"{r['flops_per_device']:.2e} | {r['bytes_per_device']:.2e} | "
            f"{r['collective_bytes_per_device']:.2e} | {mix} | {_replicated(r)} | "
            f"{_held(r)} |")
    return "\n".join(lines)


_SHORT = {"parameters": "params", "gradients": "grads", "optimizer_state": "opt",
          "activations": "act", "temporaries": "bwd", "inputs": "inputs", "buffers": "buf"}


def _held(r: dict) -> str:
    """What holds the peak: its two largest kinds' shares, and the largest
    tensor live at the peak with the op that made it."""
    mem = r.get("memory", {})
    kinds = sorted(mem.get("by_kind", {}).items(), key=lambda kv: -kv[1])
    total = mem.get("peak_bytes") or 1
    out = ", ".join(f"{_SHORT.get(k, k)} {100 * v / total:.0f}%" for k, v in kinds[:2])
    if mem.get("largest"):
        t = mem["largest"][0]
        op = t["op"].replace("aten.", "").replace("_c10d_functional.", "").replace(".default", "")
        out += (f"; {t['bytes'] / 2**30:.2f} GiB `{op}` "
                f"{'x'.join(map(str, t['shape']))} {t['dtype']}")
    return out or "-"


def _replicated(r: dict) -> str:
    """The kernels whose work every rank of a mesh dim repeats in this
    cell's trace (``launch.sharded.Replicated``), with the ranks that do
    it: their FLOPs, bytes and memory are those of a replicated form, not
    of a split."""
    return ", ".join(f"{k} x{v}" for k, v in sorted(r.get("replicated", {}).items())) or "none"


def _lever(r: dict) -> str:
    """One sentence: what would move this cell's dominant term down, on
    this card and the port's kernels."""
    key, dom = r["key"], r["dominant"]
    arch, shape = key.split("/")[0], key.split("/")[1]
    is_lm, is_gnn = arch in _LM, arch in _GNN
    if dom == "memory":
        if is_lm and shape in ("train_4k", "prefill_32k"):
            return ("a flash backward kernel (#6 has a forward only): the chunked float32 "
                    "twin's score tiles go through HBM, not shared memory")
        if is_lm:
            return "decode reads the whole cache: a bf16 -> fp8 cache halves the reads"
        if is_gnn:
            return ("fold the gather, message and segment sum into one kernel on #3's "
                    "schedule, the rows staying in shared memory")
        return "batch the per-user attention MLP into wider GEMMs (bf16 on the tensor cores)"
    if dom == "collective":
        if is_lm and shape == "train_4k":
            return ("parameter all-gathers and gradient reductions: overlap them with the "
                    "layers' compute, keep the model axis inside a node's NVLink")
        if is_lm and "flash_attention" in r.get("replicated", {}):
            return ("a causal offset in the flash kernel (#6): the queries split over the "
                    "sequence, not gathered by every model rank")
        if is_lm:
            return "keep the model axis inside a node's NVLink"
        if is_gnn:
            return ("the owner-computes GraphScale layout (dist/gat_parallel, "
                    "dist/gnn_parallel): one all-gather a layer")
        return "the crossbar exchange over NVLink within a node before InfiniBand"
    return "more work a card (a larger microbatch) to amortize the launches"


def roofline_table(recs: List[dict], mesh: str) -> str:
    lines = [
        "| cell | peak | compute s | memory s | collective s | dominant | MODEL_FLOPs | "
        "traced FLOPs (total) | useful | what moves the dominant term |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(recs, key=lambda r: r["key"]):
        if r["mesh"] != mesh or r.get("status") != "ok":
            continue
        lines.append(
            f"| {r['key']} | {r['peak']} | {r['compute_s']:.2e} | {r['memory_s']:.2e} | "
            f"{r['collective_s']:.2e} | **{r['dominant']}** | {r['model_flops']:.2e} | "
            f"{r['hlo_flops_total']:.2e} | {r['useful_ratio']:.3f} | {_lever(r)} |")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/dryrun", help="the dry run's records")
    args = ap.parse_args(argv)
    recs = load(args.out)
    print(f"<!-- {len(recs)} dry-run records -->\n")
    print("### Dry-run (all cells, both meshes)\n")
    print(dryrun_table(recs))
    for mesh in ("single", "multi"):
        print(f"\n### Roofline — mesh={mesh}\n")
        print(roofline_table(recs, mesh))
    doms = {}
    for r in recs:
        k = r["dominant"] if r.get("status") == "ok" else "FAIL"
        doms[k] = doms.get(k, 0) + 1
    print(f"\ndominant-term distribution: {doms}")


if __name__ == "__main__":
    main()
