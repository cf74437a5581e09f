#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py                 # on a machine with a CUDA card

Phases, one JSON line each (``{"phase": ..., "seconds": ...}``):

  card       nvidia-smi name and power limit (also printed raw)
  build      nvcc builds every CUDA source of the port (sm_90a), all at once
  graph      graph500 RMAT, scale 20, edge factor 16, seed 0, deduplicated
             and symmetrized, float32 weights from the seed
  partition  partition_2d(p=4, l=16, tile_vb=1024, tile_eb=128,
             build_push=True, push_block=65536) with memory_report()
  kernel     each kernel against its plain PyTorch version on the card:
             gather_reduce_cores on phase 0 of the real partition (static
             counts and a seeded fetch map keeping ~30% of the real tiles)
             and on a small graph in the 32-bit regime; scatter_reduce_cores
             on phase 0 of the real push stream (32-bit regime) and on a
             small partition in the 16-bit push regime, static and fetch.
             min u32 (BFS/WCC), min f32 + weights (SSSP), sum f32 (PageRank,
             gather only). Min must be bit-equal, sum within rtol=1e-5,
             atol=1e-9.
  timing     per variant, each kernel's and its plain version's device time
             per launch over all l phases (profiler), with the byte bound at
             3.35 TB/s; the gather min variants on the static counts, on a
             fetch map of all real tiles (the main path's arm) and on the
             ~30% map; the scatter variants with all real tiles active; the
             oracle backend's time per phase (no single PyTorch call
             computes either function)
  main_path  engine.run with the port's default options (dynamic tile skip,
             'auto' direction) for BFS (root 0), WCC, SSSP (root 0) and
             PageRank (twice), with iterations, seconds and MTEPS = E /
             seconds (label init on the host is timed apart as set-up).
             Should 'auto' never pick push for a variant, a forced-push BFS
             or SSSP run is added. The launch counts of both kernels are
             zeroed just before and read just after: together they must
             equal sum(iterations) * l, and every variant must have run.
             Then (static_path_run, not counted) BFS, WCC and SSSP on the
             static schedule, bit-equal to the default runs, for comparison
  schedule   run_frontier_trace for BFS, WCC and SSSP: the direction and the
             skipped-tile fraction of every iteration; labels and iterations
             equal to the main path's runs
  profile    torch.profiler over one iteration: a static iteration per
             problem, and BFS's dense-pull, dynamic-pull and push iterations
             (the last two on the same narrow frontier): device busy time,
             idle share, the kernels' share, the top device events
  oracle     the same runs with backend='oracle' (the static schedule):
             BFS/WCC/SSSP labels and iterations bit-equal, PageRank within
             rtol=1e-5, atol=1e-9 with equal iterations; the two kernel
             PageRank runs bit-equal
  reference  a small graph through the port on the card against the numpy
             oracles of ``repro_torch.core.reference``

This slice's paths (multi-query lanes and graph serving, K = 16):

  lanes_kernels  each lane arm against its plain version on phase 0 of the
             partition, counts and a ~30% fetch map: gather 'or' at W=1 and
             W=2 packed words (K=16, K=40), min_f32_add and sum_f32 at L=16,
             min_f32_add at L=64 (two lane chunks at vb=1024); scatter 'or'
             W=1 and min_f32_add L=16 on the real 32-bit push stream. Min and
             OR bit-equal; sum within rtol=1e-5, atol=1e-9 and the same bits
             on a second launch. Device time per launch over the l phases,
             the byte bound with the L-wide payload and output, and the
             laneless arm's time on the same streams
  lanes_engine   bfs_multi, sssp_multi and ppr_multi (twice, tol 1e-4, the
             router's) at K = 16 with the default options; launches counted
             (forced-push runs added should 'auto' never push a variant):
             they must equal sum(iterations) * l with every lane variant
             run. Then (not counted) columns 0 and 1 against laneless
             bfs/sssp runs, BFS/SSSP bit-equal to the oracle backend's
             K-lane runs, PPR within rtol=1e-5, atol=1e-9 of the oracle over
             the counted run's iteration count (no lane frozen), PPR
             bit-stable, and the schedule of each min/or run
DIN scoring and recommend-for (the embedding-bag kernel), at the published
DIN width (get("din").model: item_vocab 10,000,384, cate_vocab 10,000,
embed 18, seq_len 100, attention MLP 80-40, output MLP 200-80), its
parameters drawn on the card from a seeded generator:

  bag_kernel the embedding-bag kernel against its plain version, sum and
             mean, at four shapes: (a) DIN's profile bag at serve_p99 (B =
             512, L = 32, the 10,000 x 18 cate table, ~30% padding from
             recsys_batch), (b) the same at serve_bulk (B = 262,144), (c) the
             10,000,384 x 18 item table with B = 4096, L = 100 (the
             histories of recsys_batch; 8 id sets in rotation, ~160 MB of
             row sectors, so each launch finds its rows out of L2), (d) B = 1 (the
             retrieval profile) and an all-padding bag. Within rtol=1e-5,
             atol=1e-7, the same bits on a second launch. Device time per
             launch (profiler; the median and spread of readings that
             alternate sum and mean) of the kernel, the plain version (L
             takes added in id order) and the one
             library call (F.embedding_bag with the validity mask as
             per_sample_weights, / max(count, 1) for mean); the byte bound
             at 3.35 TB/s: ids + output + the distinct 32-B sectors of the
             rows the real ids touch
  din        pointwise score on recsys_batch(batch=512) and retrieval
             score_candidates on retrieval_batch(n_candidates=4096) in
             chunks of 512, as the reference CLI runs them (the item rows
             by a take): ms per call (host clock, each call synchronized:
             median, min, max), QPS and candidates/s (the rows scored over
             the wall of all timed calls); the
             kernel's launches (counted) equal the calls; the scores within
             rtol=1e-5, atol=1e-6 of a run whose bag is the plain version;
             three profiled calls of each
  serve      a GraphService over the built partition at K = 16 with a
             RecommendScorer at the published DIN config (pool 64, top 8,
             the crossbar lookup at one shard): 128 queries of
             mixed_query_workload(seed=0) with the reference's default mix
             (bfs 0.35, sssp 0.2, ppr 0.2, recommend 0.25) and 512 weighted
             insertions from edge_insertion_stream in 2 batches, each flushed
             mid-stream; QPS, latency percentiles, batches and their walls by
             kind, flushes, and torch.cuda.memory_allocated() around each
             flush (the retired partition's device copies must be freed);
             launches counted as above, one embedding-bag launch per
             recommend query. serve_equivalence: a cold partition_2d of the
             final graph, every answer (recommend-for's vertices and scores
             too, through the same scorer) replayed on both partitions bit
             for bit, then neighbors-of for every distinct root (checked,
             not timed: the default mix sends none), BFS/WCC/SSSP labels
             and iterations equal

The one-bucket gather kernel (after lanes_engine, on the same partition):

  bucket     ops.gather_reduce over every one of the p * l = 64 (core,
             phase) buckets, each tiled from pg.src_gidx/dst_lidx/valid/
             weights as the partition tiles it (its vb, eb, row packing and
             split threshold), in three forms: a BFS-level min on u32, an
             SSSP min-plus with weights, a PageRank sum, one seeded payload
             per phase; launches counted (64 a form). Each bucket's natural
             rows against the fused kernel's (channel_phase_reduce) on the
             same payload, three buckets' packed rows against the plain
             version: min bit-equal, sum within SUM_TOL and the same bits
             again. Device time per launch over the 64 buckets, plain ms, the
             byte bound, and the stream's bytes per edge beside the fused
             kernel's packed 4 B

GAT and the GNN trainer (after serve, whose partitions are freed first),
gat-cora at its published width (get("gat-cora").model: 2 layers, 8
heads x 8), attention vectors seeded non-zero:

  softmax_kernel  the segment-softmax kernel against its plain version at
             (a) GAT layer 1 at the Cora shape (full_graph_sm: 4096 nodes,
             16,384 edge slots, H = 8) and (b) the smoke graph as one GAT
             layout (H = 8): within SOFTMAX_TOL, the same bits again; device
             time, plain time, the byte bound, the layout's padding share and
             host build seconds
  gnn        train: 50 steps of make_gnn_train_step with AdamW(lr 1e-3) on
             full_graph_sm uncut (symmetrize(rmat(12, 2, seed=0)) padded to
             16,384 masked slots, d_feat 1433, 7 classes): ms per step
             (median, min, max), steps/s over the wall, the softmax kernel's
             launches (counted: 2 a step), the loss falling, and the first
             step's loss and grads against a plain-softmax run within
             GNN_TOL. infer: make_gnn_infer on the smoke graph's COO at
             ogbn-products' widths (d_feat 100, 47 classes; the graph cut from
             2,449,408 / 61,859,328 to 1,048,576 / 31,403,850 by chip time and
             the host build): ms per forward, edges/s, launches (2 a
             forward), device idle share of one profiled forward, peak
             memory, outputs within 1e-4 of a plain-softmax run. Then one
             train step at published width of each other arch on its cell
             (gcn-cora, schnet, meshgraphnet on full_graph_sm; graphsage on
             minibatch_lg's sizes, a seeded graph, loss on 1024 seed nodes;
             gin-tu on molecule): the loss must be finite

Then a ``{"kernels": [...]}`` line (the laneless variants' launches from
main_path, the lane variants' from lanes_engine, the embedding bag's from
din and serve, timed at shape (a); the bucket kernel's from bucket; the
softmax kernel's from gnn's timed train steps and forwards, timed at shape
(a)) and, last, ``{"ok": true, "device": ...}``.
Any failure raises and exits non-zero; it also exits non-zero, printing no
result, when no CUDA device is present or the port's sources are missing.

``--scale N`` shrinks the graph for a quick run. ``--cpu-rehearsal`` runs
every phase on the CPU through the plain versions at a small scale (DIN and
the five other GNNs at their smoke configs, GAT at 64 features, 3 train
steps), to check the script's control flow without a card; it always exits
3.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
SEED = 0
# push_block=65536 puts each core's whole gathered block (p * sub_size =
# 65,536 sources) in one push source block (B = 1). The push stream pads
# every (core, phase, block) to the fattest one's tile count, so on this
# skewed graph the auto-sized block (32 sources, B = 2048) would stack
# 2048 x 1391 tiles per bucket, about 187 GB of words; at B = 1 the push
# stream is about 5 GB beside the pull stream's 3.8 GB. Frontier skipping
# survives B = 1: edges in a block are sorted by source and each push tile
# has its own coverage words.
CFG = dict(p=4, l=16, tile_vb=1024, tile_eb=128, build_push=True, push_block=65536)
SUM_TOL = dict(rtol=1e-5, atol=1e-9)
GATHER = dict(source="src/repro_torch/csrc/gather_reduce_cores.cu",
              replaces="src/repro/kernels/csr_gather_reduce/kernel.py:221")
SCATTER = dict(source="src/repro_torch/csrc/scatter_reduce_cores.cu",
               replaces="src/repro/kernels/csr_gather_reduce/kernel.py:373")
FETCH_SHARE = 0.3  # share of real tiles a seeded fetch map keeps
INF_F32 = 3.4028234663852886e38  # float32 max, the SSSP identity
LANE_K = 16  # queries per multi-query batch (the serving width)
# lane arm -> (kind, edge_op, identity, payload lanes, payload kind, laneless variant)
LANE_ARMS = {
    "or_w1": ("or", "none", 0.0, 1, "words", "min_u32"),  # K = 16: one reach word
    "or_w2": ("or", "none", 0.0, 2, "words", "min_u32"),  # K = 40: two words
    "min_f32_add_l16": ("min", "add", INF_F32, 16, "dist", "min_f32_add"),
    "sum_f32_l16": ("sum", "none", 0.0, 16, "rank", "sum_f32"),
    "min_f32_add_l64": ("min", "add", INF_F32, 64, "dist", "min_f32_add"),  # lane chunks
}
PUSH_LANE_ARMS = ("or_w1", "min_f32_add_l16")
# lane variants the K = 16 paths launch, by kernel, and the arm that times each
LANE_ENTRIES = {
    "gather": (("or_u32_lanes", "or_w1"), ("min_f32_add_lanes", "min_f32_add_l16"),
               ("sum_f32_lanes", "sum_f32_l16")),
    "scatter": (("or_u32_lanes", "or_w1"), ("min_f32_add_lanes", "min_f32_add_l16")),
}
LANE_VARIANTS = {f"{k}_reduce_cores": tuple(v for v, _ in e) for k, e in LANE_ENTRIES.items()}
PPR_RUN_TOL = 1e-4  # the serving router's PPR tolerance
SERVE_QUERIES = 128
SERVE_INSERTS = 512
EMBAG = dict(source="src/repro_torch/csrc/embedding_bag.cu",
             replaces="src/repro/kernels/embedding_bag/kernel.py:75")
BUCKET = dict(source="src/repro_torch/csrc/gather_reduce.cu",
              replaces="src/repro/kernels/csr_gather_reduce/kernel.py:159")
SOFTMAX = dict(source="src/repro_torch/csrc/segment_softmax.cu",
               replaces="src/repro/kernels/segment_softmax/kernel.py:66")
BAG_TOL = dict(rtol=1e-5, atol=1e-7)  # both sum in id order (in fact the same bits)
DIN_TOL = dict(rtol=1e-5, atol=1e-6)
SOFTMAX_TOL = dict(rtol=1e-5, atol=1e-7)  # online rescaling vs the plain version's final max
GNN_TOL = dict(rtol=1e-5, atol=1e-6)
DIN_BATCH, DIN_CANDIDATES, DIN_CHUNK = 512, 4096, 512  # the reference CLI's sizes
BAG_ROUNDS = 2  # bag timing: (sum, mean, mean, sum) this many times per shape
COLD_SETS = 8  # id sets of shape (c) in rotation: ~160 MB of row sectors, past the 50 MB L2


def emit(phase: str, t0: float, **kw) -> None:
    print(json.dumps({"phase": phase, "seconds": time.perf_counter() - t0, **kw}), flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--cpu-rehearsal", action="store_true")
    args = ap.parse_args()

    import numpy as np
    import torch

    rehearsal = args.cpu_rehearsal
    if not rehearsal and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    # tile_vb=1024 must divide the l * sub_size rows per core: scale >= 12
    scale = 12 if rehearsal else args.scale
    if scale < 12:
        ap.error("--scale must be at least 12")
    dev = torch.device("cpu" if rehearsal else "cuda")
    # full float32 matmuls and convolutions (DIN's MLPs; the plain versions)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.core.graph as G
    from repro_torch.core import frontier_words as F
    from repro_torch.core import reference, u32
    from repro_torch.core.engine import (
        EngineOptions, _edge_constants, channel_phase_reduce, channel_phase_reduce_oracle,
        make_iteration, phase_consts_at, prepare_labels, run, run_frontier_trace,
    )
    from repro_torch.core.partition import PartitionConfig, partition_2d
    from repro_torch.core.problems import (
        bfs, bfs_multi, pagerank, ppr_multi, sssp, sssp_multi, wcc,
    )
    from repro_torch.configs.registry import get as get_arch
    from repro_torch.data.synthetic import (
        DEFAULT_QUERY_MIX, edge_insertion_stream, mixed_query_workload, recsys_batch,
        retrieval_batch,
    )
    from repro_torch.kernels.build import build_library, load_library
    from repro_torch.kernels.csr_gather_reduce import kernel as K
    from repro_torch.kernels.csr_gather_reduce import scatter as S
    from repro_torch.kernels.embedding_bag import embedding_bag, embedding_bag_reference
    from repro_torch.kernels.csr_gather_reduce import bucket as B
    from repro_torch.kernels.csr_gather_reduce import ops as BO
    from repro_torch.kernels.embedding_bag import kernel as EB
    from repro_torch.kernels.segment_softmax import kernel as SK
    from repro_torch.models.recsys import din

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    # -- card -----------------------------------------------------------------
    t0 = time.perf_counter()
    if rehearsal:
        smi, kind, count = "cpu rehearsal", "cpu", 0
    else:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip()
        kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
        print(smi, flush=True)
    emit("card", t0, nvidia_smi=smi, kind=kind, count=count,
         torch=torch.__version__, cuda=torch.version.cuda)

    # -- build: one nvcc per source, all started together ----------------------
    t0 = time.perf_counter()
    if not rehearsal:
        sources = (K.SOURCE, S.SOURCE, EB.SOURCE, B.SOURCE, SK.SOURCE)
        with ThreadPoolExecutor(len(sources)) as pool:
            logs = dict(zip(sources, pool.map(lambda s: build_library(s)[1], sources)))
        for s in sources:
            load_library(s)
        ptxas = {s: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
                 for s, log in logs.items()}
        emit("build", t0, sources=[m["source"] for m in (GATHER, SCATTER, EMBAG, BUCKET, SOFTMAX)],
             ptxas=ptxas)

    # -- graph ----------------------------------------------------------------
    t0 = time.perf_counter()
    g0 = G.symmetrize(G.rmat(scale, 16, a=0.57, b=0.19, c=0.19, seed=SEED))
    w = np.random.default_rng(SEED).random(g0.num_edges).astype(np.float32)
    g = G.COOGraph(src=g0.src, dst=g0.dst, num_vertices=g0.num_vertices, weights=w)
    n_edges = g.num_edges
    emit("graph", t0, scale=scale, edge_factor=16, vertices=g.num_vertices, edges=n_edges)

    # -- partition ------------------------------------------------------------
    t0 = time.perf_counter()
    pg = partition_2d(g, PartitionConfig(**CFG))
    rep = pg.memory_report()
    emit("partition", t0, config=CFG, src_bits=pg.src_bits, sub_size=pg.sub_size,
         tile_word_shape=list(pg.tile_word.shape), split_rows=pg.split_rows,
         row_map="split" if pg.tile_split_map is not None else "row_pos",
         skipped_tile_fraction=pg.skipped_tile_fraction,
         tile_padding_ratio=pg.tile_padding_ratio,
         push_word_shape=list(pg.push_word.shape), push_src_bits=pg.push_src_bits,
         push_block=pg.push_block, push_real_tiles=int(pg.push_counts.sum()),
         push_real_share=float(pg.push_counts.sum()) / pg.push_counts.size / pg.push_word.shape[3],
         coverage_shape=list(pg.tile_coverage.shape),
         device_bytes=rep["device"], device_total_bytes=rep["device_total_bytes"],
         device_bytes_per_edge=rep["device_bytes_per_edge"],
         host_flat_total_bytes=rep["host_flat_total_bytes"])

    # -- helpers shared by every path ------------------------------------------
    rng = np.random.default_rng(SEED + 1)
    problems = {"min_u32": bfs(0), "min_f32_add": sssp(0), "sum_f32": pagerank()}
    push_variants = ("min_u32", "min_f32_add")

    def payload_for(variant: str, n: int) -> torch.Tensor:
        if variant == "min_u32":
            v = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
            v[rng.random(n) < 0.1] = u32.U32_MAX
            return u32.to_bits(v).to(dev)
        if variant == "min_f32_add":
            v = (rng.random(n) * 100).astype(np.float32)
            v[rng.random(n) < 0.1] = np.finfo(np.float32).max
            return torch.from_numpy(v).to(dev)
        return torch.from_numpy((rng.random(n) / n).astype(np.float32)).to(dev)

    def seeded_fetch(counts: torch.Tensor, t_tiles: int, share: float) -> torch.Tensor:
        """A fetch map keeping about ``share`` of the real tiles (1.0: all)."""
        real = torch.arange(t_tiles, device=dev).view(1, 1, -1) < counts.unsqueeze(-1)
        keep = torch.from_numpy(rng.random(tuple(real.shape)) < share).to(dev)
        return F.active_fetch_map(real & keep)

    def streams(graph, problem):
        """(pull args per phase, push args per phase, pull kw, push kw)."""
        consts = _edge_constants(problem, graph, EngineOptions(), dev)
        pull = [phase_consts_at(consts, m) for m in range(graph.l)]
        pull = [(cm["word"], cm["counts"], cm["word_hi"], cm["w"]) for cm in pull]
        kw = dict(kind=problem.reduce_kind, edge_op=problem.edge_op, identity=problem.identity)
        gkw = dict(num_rows=graph.packed_rows_per_core, vb=graph.tile_vb,
                   src_bits=graph.src_bits, **kw)
        push, skw = None, None
        if consts["push_word"] is not None:
            push = [phase_consts_at(consts, m) for m in range(graph.l)]
            push = [(cm["push_word"], cm["push_counts"], cm["push_word_hi"], cm["push_w"])
                    for cm in push]
            skw = dict(num_rows=graph.vertices_per_core, src_bits=graph.push_src_bits, **kw)
        return pull, push, gkw, skw

    def agree(got, want, variant, label):
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{label} {variant}: shape/dtype {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
        if variant == "sum_f32":
            ok = torch.allclose(got, want, **SUM_TOL)
            err = float((got - want).abs().max())
        else:
            ok = torch.equal(got, want)
            a = u32.widen(got) if got.dtype == torch.int32 else got.double()
            b = u32.widen(want) if want.dtype == torch.int32 else want.double()
            err = float((a - b).abs().max())
        check(ok, f"{label} {variant}: kernel disagrees with plain version (max err {err})")
        return err

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def event_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    def profiled(fn):
        """Run ``fn`` under the profiler: (wall us, device-side events only,
        i.e. kernels and copies, not the CPU ops that launched them)."""
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            t = time.perf_counter()
            fn()
            sync()
            wall = (time.perf_counter() - t) * 1e6
        return wall, [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

    def device_ms(fn, reps, calls, name=None):
        """Device time per call: summed device events (those whose name holds
        ``name``, or all) over ``reps`` runs of ``fn``, each making ``calls``
        calls. Host launch gaps are not counted."""
        fn()
        sync()
        wall, evs = profiled(lambda: [fn() for _ in range(reps)])
        if dev.type != "cuda":
            return wall / 1e3 / (reps * calls)
        return sum(event_us(e) for e in evs if name is None or name in e.key) / 1e3 / (reps * calls)

    def kernel_ms(fn, reps, launches_per_call, name):
        """Device time per launch of the kernel named ``name``: the mean of
        its profiler events over ``reps`` calls of ``fn`` (each making
        ``launches_per_call`` launches), with the count of events seen, and
        the CUDA-event time of the same calls per launch, host gaps
        included, which stands in for the mean if the profiler saw none.
        Late in this run the profiler misses some launches of the kernels
        loaded with ctypes (the mean does not depend on how many it sees),
        and at times all of them."""
        if dev.type != "cuda":
            return dict(ms=device_ms(fn, reps, launches_per_call), events_seen=None,
                        events_expected=reps * launches_per_call, event_clock_ms=None)
        fn()
        sync()
        _, evs = profiled(lambda: [fn() for _ in range(reps)])
        hits = [e for e in evs if name in e.key]
        seen = sum(e.count for e in hits)
        clock = wall_ms(fn, reps) / launches_per_call
        return dict(ms=sum(event_us(e) for e in hits) / seen / 1e3 if seen else clock,
                    ms_from="profiler" if seen else "cuda_events", events_seen=seen,
                    events_expected=reps * launches_per_call, event_clock_ms=clock)

    def wall_ms(fn, reps):
        """CUDA-event time per run of ``fn``, host launch gaps included."""
        fn()
        sync()
        if dev.type != "cuda":
            t = time.perf_counter()
            for _ in range(reps):
                fn()
            return (time.perf_counter() - t) * 1e3 / reps
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def bound(real_slots, streams_per_slot, extra_bytes, lanes=1):
        """Least time for the work: each real slot's word (+ word_hi, +
        weight where streamed) read once, plus the other inputs read and the
        output written once, over 3.35 TB/s; one op per real slot and lane."""
        nbytes = real_slots * 4 * streams_per_slot + extra_bytes
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = real_slots * lanes / F32_OPS_PER_S * 1e3
        return dict(bound_ms=max(bytes_ms, ops_ms), bound_bytes=nbytes,
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations")

    def laneless_paths():
        """The laneless paths of the earlier slices: returns the launch counts
        of their main path, the kernel-vs-plain errors and the timings. Their
        device tensors die with this frame, so that the serving phase can
        see eviction free the partition's device copies."""
        # -- each kernel against its plain version --------------------------------
        t0 = time.perf_counter()
        errs = {("gather", v): 0.0 for v in problems}
        errs.update({("scatter", v): 0.0 for v in push_variants})

        def compare(graph, label, gather=True):
            for variant, problem in problems.items():
                pull, push, gkw, skw = streams(graph, problem)
                payload = payload_for(variant, graph.gathered_size)
                cases = []
                if gather:
                    word, counts, hi, wts = pull[0]
                    fetch = seeded_fetch(counts, word.shape[2], FETCH_SHARE)
                    cases += [("gather", (payload, word, counts, hi, wts), gkw),
                              ("gather", (payload, word, counts, hi, wts, fetch), gkw)]
                if variant in push_variants and push is not None:
                    word, counts, hi, wts = push[0]
                    fetch = seeded_fetch(counts, word.shape[2], FETCH_SHARE)
                    cases += [("scatter", (payload, word, counts, hi, wts), skw),
                              ("scatter", (payload, word, counts, hi, wts, fetch), skw)]
                for kern, args, kw in cases:
                    mod, plain = (K, K.gather_reduce_cores_plain) if kern == "gather" else \
                        (S, S.scatter_reduce_cores_plain)
                    fn = mod.gather_reduce_cores if kern == "gather" else mod.scatter_reduce_cores
                    got = fn(*args, **kw)
                    want = plain(*args, **kw)
                    sync()
                    arm = "fetch" if len(args) == 6 else "static"
                    err = agree(got, want, variant, f"{label} {kern} {arm}")
                    errs[(kern, variant)] = max(errs[(kern, variant)], err)

        compare(pg, "phase 0")
        # the push dst field holds the full row: 32-bit words once Vl > 2^15
        check(pg.push_src_bits == (32 if pg.vertices_per_core > 1 << 15 else 16),
              f"push stream in the {pg.push_src_bits}-bit regime at Vl={pg.vertices_per_core}")
        # unweighted, so SSSP's add runs on unit weights here (the main graph is weighted)
        g32 = G.symmetrize(G.rmat(min(scale, 12), 16, seed=SEED + 2))
        pg32 = partition_2d(g32, PartitionConfig(p=4, l=2, tile_vb=64, pack_src_bits=32,
                                                 build_push=False))
        check(pg32.src_bits == 32, "32-bit regime graph did not pack 32-bit words")
        compare(pg32, "32-bit")
        w16 = np.random.default_rng(SEED + 2).random(g32.num_edges).astype(np.float32)
        g16 = G.COOGraph(src=g32.src, dst=g32.dst, num_vertices=g32.num_vertices, weights=w16)
        pg16 = partition_2d(g16, PartitionConfig(p=4, l=2, tile_vb=64, push_block=256))
        check(pg16.push_src_bits == 16 and pg16.vertices_per_core <= 1 << 15,
              "small push partition is not in the 16-bit regime")
        compare(pg16, "16-bit push", gather=False)
        emit("kernel", t0, max_abs_err={f"{k}[{v}]": e for (k, v), e in errs.items()},
             gather_src_bits_checked=[pg.src_bits, pg32.src_bits],
             push_src_bits_checked=[pg.push_src_bits, pg16.push_src_bits],
             fetch_share=FETCH_SHARE, small_graph_edges=g32.num_edges)

        # -- timing: kernels, plain versions, bounds, oracle per phase ------------
        t0 = time.perf_counter()
        timing = {}
        reps = 3 if rehearsal else 20
        for variant, problem in problems.items():
            pull, push, gkw, skw = streams(pg, problem)
            payload = payload_for(variant, pg.gathered_size)
            has_hi, has_w = pull[0][2] is not None, pull[0][3] is not None

            def launch_all(fn, phase_args, kw, payload=payload):
                # one call = one launch per phase; the 16 phase streams exceed L2
                for a in phase_args:
                    fn(payload, *a, **kw)

            def time_arm(fn, plain, phase_args, kw, name):
                k_ms = device_ms(lambda: launch_all(fn, phase_args, kw), reps, pg.l, name=name)
                p_ms = device_ms(lambda: launch_all(plain, phase_args, kw), max(1, reps // 4), pg.l)
                return k_ms, p_ms

            out_bytes = pg.p * pg.packed_rows_per_core * 4
            real_slots = float(pg.tile_counts.sum()) * pg.tile_word.shape[4] / pg.l
            common = pg.tile_counts[:, 0].nbytes + pg.gathered_size * 4 + out_bytes
            row = dict(word_hi=has_hi, weights=has_w, real_slots_per_phase=real_slots)
            fn, plain, name = K.gather_reduce_cores, K.gather_reduce_cores_plain, \
                "gather_reduce_cores_kernel"
            row["static_ms"], row["static_plain_ms"] = time_arm(fn, plain, pull, gkw, name)
            row["launch_wall_ms"] = wall_ms(lambda: launch_all(fn, pull, gkw), reps) / pg.l
            if variant == "sum_f32":  # PageRank stays on the static schedule
                row["ms"], row["plain_ms"] = row["static_ms"], row["static_plain_ms"]
                row.update(bound(real_slots, 1 + has_hi + has_w, common))
            else:  # the main path's arm: the fetch map, also read once
                fetch_bytes = pg.tile_counts[:, 0].size * pg.tile_word.shape[3] * 4
                all_real = [a + (seeded_fetch(a[1], a[0].shape[2], 1.0),) for a in pull]
                part = [a + (seeded_fetch(a[1], a[0].shape[2], FETCH_SHARE),) for a in pull]
                row["ms"], row["plain_ms"] = time_arm(fn, plain, all_real, gkw, name)
                row.update(bound(real_slots, 1 + has_hi + has_w, common + fetch_bytes))
                row["fetch30_ms"], row["fetch30_plain_ms"] = time_arm(fn, plain, part, gkw, name)
                run_slots = float(sum(int((f[-1] == torch.arange(f[0].shape[2], device=dev)).sum())
                                      for f in part)) * pg.tile_word.shape[4] / pg.l
                row["fetch30_bound_ms"] = bound(run_slots, 1 + has_hi + has_w,
                                                common + fetch_bytes)["bound_ms"]
            oracle_consts = _edge_constants(problem, pg, EngineOptions(backend="oracle"), dev)
            o_phases = [phase_consts_at(oracle_consts, m) for m in range(pg.l)]

            def oracle_all(problem=problem, o_phases=o_phases, payload=payload):
                for cm in o_phases:
                    channel_phase_reduce_oracle(problem, pg, payload, cm)

            row["oracle_phase_ms"] = device_ms(oracle_all, max(1, reps // 4), pg.l)
            timing[("gather", variant)] = row
            if variant in push_variants:
                peb = pg.push_word.shape[4]
                p_slots = float(pg.push_counts.sum()) * peb / pg.l
                p_hi, p_w = push[0][2] is not None, push[0][3] is not None
                fetch_bytes = pg.push_counts[:, 0].size * pg.push_word.shape[3] * 4
                common = (pg.push_counts[:, 0].nbytes + pg.gathered_size * 4
                          + pg.p * pg.vertices_per_core * 4)
                fn, plain = S.scatter_reduce_cores, S.scatter_reduce_cores_plain
                srow = dict(word_hi=p_hi, weights=p_w, real_slots_per_phase=p_slots)
                all_real = [a + (seeded_fetch(a[1], a[0].shape[2], 1.0),) for a in push]
                srow["ms"], srow["plain_ms"] = time_arm(fn, plain, all_real, skw, "scatter_reduce")
                srow.update(bound(p_slots, 1 + p_hi + p_w, common + fetch_bytes))
                srow["static_ms"], srow["static_plain_ms"] = time_arm(fn, plain, push, skw,
                                                                      "scatter_reduce")
                srow["launch_wall_ms"] = wall_ms(lambda: launch_all(fn, all_real, skw), reps) / pg.l
                timing[("scatter", variant)] = srow
        emit("timing", t0, per_launch={f"{k}[{v}]": r for (k, v), r in timing.items()},
             note="ms, plain_ms, *_ms: device time per launch (profiler, the kernel's own "
                  "kernels only), averaged over the l phase streams; ms is the arm the main "
                  "path takes (the fetch map with every real tile active for the min variants, "
                  "the static counts for sum_f32); fetch30: a seeded map keeping ~30% of real "
                  "tiles, bounded by the slots it runs; launch_wall_ms: CUDA-event time per "
                  "launch with host launch gaps; no single PyTorch call computes either "
                  "function (library_ms null)")

        # -- main path: the port's engine, default options -------------------------
        runs = [("bfs", bfs(0)), ("wcc", wcc()), ("sssp", sssp(0)),
                ("pagerank", pagerank()), ("pagerank_repeat", pagerank())]
        for _, problem in runs:  # upload each problem's edge tensors (set-up)
            make_iteration(problem, pg, EngineOptions(), device=dev)
        make_iteration(sssp(0), pg, EngineOptions(direction="push"), device=dev)
        sync()
        K.reset_launch_counts()
        S.reset_launch_counts()
        t0 = time.perf_counter()
        results = {}

        def main_run(name, problem, opts):
            t = time.perf_counter()
            labels = prepare_labels(problem, g, pg, device=dev)  # host init (set-up)
            sync()
            init_sec = time.perf_counter() - t
            t1 = time.perf_counter()
            res = run(problem, g, pg, opts, labels=labels, device=dev)
            sync()
            sec = time.perf_counter() - t1
            results[name] = res
            lab = res.labels["label"]
            check(lab.shape == (g.num_vertices,), f"{name}: label shape {lab.shape}")
            check(res.converged, f"{name}: did not converge in {res.iterations} iterations")
            if lab.dtype == np.float32:
                check(bool(np.isfinite(lab).all()), f"{name}: non-finite labels")
            emit("main_path_run", t, problem=name, options=opts.direction,
                 iterations=res.iterations, init_seconds=init_sec, run_seconds=sec,
                 mteps=n_edges / sec / 1e6, edges=n_edges)

        for name, problem in runs:
            main_run(name, problem, EngineOptions())
        # should 'auto' never pick push for a variant, force it, so that every
        # scatter variant still lies on a path this run drives
        forced = [(v, name, prob) for v, name, prob in (("min_u32", "bfs", bfs(0)),
                                                       ("min_f32_add", "sssp", sssp(0)))
                  if S.LAUNCHES.get(v, 0) == 0]
        for _, name, problem in forced:
            main_run(f"{name}_push", problem, EngineOptions(direction="push"))
        launches = {"gather_reduce_cores": dict(K.LAUNCHES), "scatter_reduce_cores": dict(S.LAUNCHES)}
        expect = sum(r.iterations for r in results.values()) * pg.l
        total = sum(K.LAUNCHES.values()) + sum(S.LAUNCHES.values())
        emit("main_path", t0, launches=launches, total_launches=total, expected_launches=expect,
             forced_push=[f"{n}_push" for _, n, _ in forced])
        if not rehearsal:
            check(total == expect, f"kernel launches {launches} != sum(iterations) * l = {expect}")
            for variant in problems:
                check(K.LAUNCHES.get(variant, 0) > 0, f"gather variant {variant} was never launched")
            for variant in push_variants:
                check(S.LAUNCHES.get(variant, 0) > 0, f"scatter variant {variant} was never launched")
        for _, name, _ in forced:  # a forced direction changes the schedule, not the result
            a, b = results[name], results[f"{name}_push"]
            check(a.iterations == b.iterations and np.array_equal(a.labels["label"], b.labels["label"]),
                  f"{name}: forced push differs from the 'auto' run")
        # the static schedule on the same card, for comparison (not counted)
        for name, problem in runs[:3]:
            labels = prepare_labels(problem, g, pg, device=dev)
            sync()
            t = time.perf_counter()
            res = run(problem, g, pg, EngineOptions(dynamic_tile_skip=False), labels=labels,
                      device=dev)
            sync()
            sec = time.perf_counter() - t
            check(res.iterations == results[name].iterations
                  and np.array_equal(res.labels["label"], results[name].labels["label"]),
                  f"{name}: the default run differs from the static schedule")
            emit("static_path_run", t, problem=name, iterations=res.iterations, run_seconds=sec,
                 mteps=n_edges / sec / 1e6)

        # -- the schedule of each min problem, iteration by iteration -------------
        t0 = time.perf_counter()
        schedule = {}
        for name, problem in runs[:3]:
            tr = run_frontier_trace(problem, g, pg, device=dev)
            check(tr["iterations"] == results[name].iterations
                  and np.array_equal(tr["labels"]["label"], results[name].labels["label"]),
                  f"{name}: run_frontier_trace differs from run")
            schedule[name] = {k: tr[k] for k in ("iterations", "direction", "push_iterations",
                                                  "dense_iterations", "dynamic_skipped_tile_fraction")}
        emit("schedule", t0, per_problem=schedule,
             static_skipped_tile_fraction=pg.skipped_tile_fraction,
             push_static_skipped_tile_fraction=1.0 - float(pg.push_counts.sum())
             / pg.push_counts.size / pg.push_word.shape[3])

        # -- where one iteration's time goes (after the counts were read) ---------
        t0 = time.perf_counter()

        def breakdown(step):
            step()  # warm
            sync()
            wall_us, evs = profiled(step)
            dev_us = sum(event_us(e) for e in evs)
            kern_us = sum(event_us(e) for e in evs if "reduce_cores" in e.key)
            top = sorted(evs, key=event_us, reverse=True)[:8]
            return dict(
                iteration_wall_us=wall_us, device_busy_us=dev_us, kernel_us=kern_us,
                device_idle_share=1.0 - dev_us / wall_us if wall_us else None,
                device_launches=sum(e.count for e in evs),
                top_device_us={e.key[:80]: [event_us(e), e.count] for e in top},
            )

        static = {}
        for name, problem in runs[:4]:
            labels = prepare_labels(problem, g, pg, device=dev)
            iteration = make_iteration(problem, pg, EngineOptions(dynamic_tile_skip=False),
                                       device=dev)
            static[name] = breakdown(lambda: iteration(labels))
        # BFS under 'auto': keep each iteration's input state; the dense pull is
        # iteration 0, the dynamic pull and the push run on the last nonempty
        # frontier (the narrowest), so their times compare on the same input
        step = make_iteration(bfs(0), pg, EngineOptions(), device=dev)
        labels = prepare_labels(bfs(0), g, pg, device=dev)
        fw = F.full_frontier_words(pg.l, pg.sub_size, lead=(pg.p,), device=dev)
        pop, prev, states = pg.p * pg.l * pg.sub_size, False, []
        while pop > 0:
            states.append((labels, fw, pop))
            labels, fw, prev = step(labels, fw, prev, pop=pop)
            pop = int(F.frontier_popcount(fw))
        by_direction = {}
        for label, state, opts in (
            ("dense_pull", states[0], EngineOptions(direction="pull")),
            ("dynamic_pull", states[-1], EngineOptions(direction="pull", dynamic_skip_density=2.0)),
            ("push", states[-1], EngineOptions(direction="push")),
        ):
            lab, front, pc = state
            it_fn = make_iteration(bfs(0), pg, opts, device=dev, with_stats=True)
            stats = it_fn(lab, front, pop=pc)[-1]
            by_direction[label] = dict(breakdown(lambda: it_fn(lab, front, pop=pc)), popcount=pc,
                                       active_tiles=int(stats["active_tiles"]),
                                       use_dense=stats["use_dense"])
        emit("profile", t0, static_iteration=static, bfs_by_direction=by_direction,
             bfs_iterations_recorded=len(states),
             note="torch.profiler over one warm iteration (l phases); device events only; "
                  "the profiler's own host overhead inflates iteration_wall_us; kernel_us "
                  "sums both kernels' events")

        # -- oracle backend on the card, kernel PR bit-stability -------------------
        t0 = time.perf_counter()
        agree_o = {}
        for name, problem in runs[:4]:
            labels = prepare_labels(problem, g, pg, device=dev)
            sync()
            t = time.perf_counter()
            ref = run(problem, g, pg, EngineOptions(backend="oracle"), labels=labels, device=dev)
            sync()
            sec = time.perf_counter() - t
            for got_name in [name] + [f"{n}_push" for _, n, _ in forced if n == name]:
                got = results[got_name]
                check(ref.iterations == got.iterations,
                      f"{got_name}: iterations kernel {got.iterations} vs oracle {ref.iterations}")
                a, b = got.labels["label"], ref.labels["label"]
                if problem.reduce_kind == "min":
                    check(a.dtype == b.dtype and np.array_equal(a, b),
                          f"{got_name}: labels differ from oracle")
                    err = 0.0
                else:
                    err = float(np.max(np.abs(a - b)))
                    check(bool(np.allclose(a, b, **SUM_TOL)),
                          f"{got_name}: labels differ from oracle by {err}")
            agree_o[name] = dict(iterations=ref.iterations, oracle_seconds=sec,
                                 oracle_mteps=n_edges / sec / 1e6, max_abs_diff=err)
        pr_a = results["pagerank"].labels["label"]
        pr_b = results["pagerank_repeat"].labels["label"]
        check(pr_a.tobytes() == pr_b.tobytes(), "pagerank: two kernel runs gave different bits")
        emit("oracle", t0, agree=agree_o, pagerank_bit_stable=True)

        # -- small graph against the numpy oracles --------------------------------
        t0 = time.perf_counter()
        gs0 = G.symmetrize(G.rmat(10, 8, seed=SEED + 3))
        ws = np.random.default_rng(SEED + 3).random(gs0.num_edges).astype(np.float32)
        gs = G.COOGraph(src=gs0.src, dst=gs0.dst, num_vertices=gs0.num_vertices, weights=ws)
        pgs = partition_2d(gs, PartitionConfig(p=2, l=2, lane=8, tile_vb=64))
        for opts in (EngineOptions(), EngineOptions(direction="push")):
            check(np.array_equal(run(bfs(0), gs, pgs, opts, device=dev).labels["label"],
                                 reference.bfs_reference(gs, 0)), "small bfs != numpy oracle")
            check(np.array_equal(run(wcc(), gs, pgs, opts, device=dev).labels["label"],
                                 reference.wcc_reference(gs)), "small wcc != numpy oracle")
            check(np.allclose(run(sssp(0), gs, pgs, opts, device=dev).labels["label"],
                              reference.sssp_reference(gs, 0), rtol=1e-6),
                  "small sssp != numpy oracle")
        check(np.allclose(run(pagerank(), gs, pgs, device=dev).labels["label"],
                          reference.pagerank_reference(gs), atol=1e-4),
              "small pagerank != numpy oracle")
        emit("reference", t0, edges=gs.num_edges)
        return launches, errs, timing

    launches, errs, timing = laneless_paths()

    # -- the lane arms of both kernels against their plain versions -----------
    lrng = np.random.default_rng(SEED + 5)

    def lane_kernel_phase():
        """Each lane arm against its plain version on phase 0, and its device
        time over the l phase streams. Returns (timing, errors)."""
        t0 = time.perf_counter()
        reps = 3 if rehearsal else 20

        def lane_payload(pkind: str, n: int, lanes: int) -> torch.Tensor:
            if pkind == "words":  # packed reach words of K = 16 (W=1) or K = 40 (W=2)
                k = 16 if lanes == 1 else 40
                bits = lrng.random((n, 32 * lanes)) < 0.15
                bits[:, k:] = False
                words = (bits.reshape(n, lanes, 32).astype(np.uint64)
                         << np.arange(32, dtype=np.uint64)).sum(axis=-1).astype(np.uint32)
                return u32.to_bits(words).to(dev)
            if pkind == "dist":
                v = (lrng.random((n, lanes)) * 100).astype(np.float32)
                v[lrng.random((n, lanes)) < 0.1] = np.finfo(np.float32).max
                return torch.from_numpy(v).to(dev)
            return torch.from_numpy((lrng.random((n, lanes)) / n).astype(np.float32)).to(dev)

        def lane_agree(got, want, kind, label):
            check(got.shape == want.shape and got.dtype == want.dtype,
                  f"{label}: shape/dtype {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
            if kind == "sum":
                err = float((got - want).abs().max())
                check(torch.allclose(got, want, **SUM_TOL), f"{label}: kernel disagrees (max err {err})")
                return err
            a = u32.widen(got) if got.dtype == torch.int32 else got.double()
            b = u32.widen(want) if want.dtype == torch.int32 else want.double()
            check(torch.equal(got, want), f"{label}: kernel disagrees with plain version "
                                          f"(max err {float((a - b).abs().max())})")
            return 0.0

        lane_timing, lane_errs = {}, {}
        for arm, (kind, edge_op, identity, lanes, pkind, laneless) in LANE_ARMS.items():
            problem = {"or": bfs(0), "sum": pagerank()}.get(kind, sssp(0))
            pull, push, gkw, skw = streams(pg, problem)
            gkw = dict(gkw, kind=kind, edge_op=edge_op, identity=identity)
            skw = dict(skw, kind=kind, edge_op=edge_op, identity=identity) if skw else None
            payload = lane_payload(pkind, pg.gathered_size, lanes)
            err = 0.0
            word, counts, hi, wts = pull[0]
            for arm_name, extra in (("counts", ()), ("fetch", (seeded_fetch(counts, word.shape[2],
                                                                             FETCH_SHARE),))):
                args = (payload, word, counts, hi, wts) + extra
                got = K.gather_reduce_cores(*args, **gkw)
                want = K.gather_reduce_cores_plain(*args, **gkw)
                sync()
                err = max(err, lane_agree(got, want, kind, f"phase 0 gather {arm} {arm_name}"))
                if kind == "sum":  # lane-ordered, warp-ordered partials: the same bits again
                    again = K.gather_reduce_cores(*args, **gkw)
                    check(torch.equal(got.view(torch.int32), again.view(torch.int32)),
                          f"gather {arm} {arm_name}: two launches gave different bits")
            lane_errs[("gather", arm)] = err
            # timing over the l phase streams: the main path's arm (the fetch map
            # of all real tiles for min/or, the static counts for sum)
            has_hi, has_w = pull[0][2] is not None, pull[0][3] is not None
            real_slots = float(pg.tile_counts.sum()) * pg.tile_word.shape[4] / pg.l
            lane_bytes = pg.gathered_size * lanes * 4 + pg.p * pg.packed_rows_per_core * lanes * 4
            common = pg.tile_counts[:, 0].nbytes + lane_bytes
            if kind == "sum":
                phase_args = pull
            else:
                phase_args = [a + (seeded_fetch(a[1], a[0].shape[2], 1.0),) for a in pull]
                common += pg.tile_counts[:, 0].size * pg.tile_word.shape[3] * 4

            def launch_all(fn, args_list, kw, payload=payload):
                for a in args_list:
                    fn(payload, *a, **kw)

            chunk = None if rehearsal else K.lane_chunk(pg.tile_vb, lanes, kind)
            row = dict(lanes=lanes, lane_chunk=chunk, chunks=chunk and -(-lanes // chunk),
                       real_slots_per_phase=real_slots, laneless_variant=laneless,
                       laneless_ms=timing[("gather", laneless)]["ms"])
            row["ms"] = device_ms(lambda: launch_all(K.gather_reduce_cores, phase_args, gkw),
                                  reps, pg.l, name="gather_reduce_cores")
            row["plain_ms"] = device_ms(lambda: launch_all(K.gather_reduce_cores_plain, phase_args,
                                                           gkw), max(1, reps // 4), pg.l)
            row.update(bound(real_slots, 1 + has_hi + has_w, common, lanes))
            lane_timing[("gather", arm)] = row
            if arm not in PUSH_LANE_ARMS:
                continue
            word, counts, hi, wts = push[0]
            err = 0.0
            for arm_name, extra in (("counts", ()), ("fetch", (seeded_fetch(counts, word.shape[2],
                                                                             FETCH_SHARE),))):
                args = (payload, word, counts, hi, wts) + extra
                got = S.scatter_reduce_cores(*args, **skw)
                want = S.scatter_reduce_cores_plain(*args, **skw)
                sync()
                err = max(err, lane_agree(got, want, kind, f"phase 0 scatter {arm} {arm_name}"))
            lane_errs[("scatter", arm)] = err
            p_hi, p_w = push[0][2] is not None, push[0][3] is not None
            p_slots = float(pg.push_counts.sum()) * pg.push_word.shape[4] / pg.l
            all_real = [a + (seeded_fetch(a[1], a[0].shape[2], 1.0),) for a in push]
            srow = dict(lanes=lanes, real_slots_per_phase=p_slots, laneless_variant=laneless,
                        laneless_ms=timing[("scatter", laneless)]["ms"])
            srow["ms"] = device_ms(lambda: launch_all(S.scatter_reduce_cores, all_real, skw),
                                   reps, pg.l, name="scatter_reduce")
            srow["plain_ms"] = device_ms(lambda: launch_all(S.scatter_reduce_cores_plain, all_real,
                                                            skw), max(1, reps // 4), pg.l)
            s_common = (pg.push_counts[:, 0].nbytes + pg.push_counts[:, 0].size
                        * pg.push_word.shape[3] * 4 + pg.gathered_size * lanes * 4
                        + pg.p * pg.vertices_per_core * lanes * 4)
            srow.update(bound(p_slots, 1 + p_hi + p_w, s_common, lanes))
            lane_timing[("scatter", arm)] = srow
        emit("lanes_kernels", t0, max_abs_err={f"{k}[{a}]": e for (k, a), e in lane_errs.items()},
             per_launch={f"{k}[{a}]": r for (k, a), r in lane_timing.items()},
             arms={a: dict(kind=v[0], edge_op=v[1], lanes=v[3]) for a, v in LANE_ARMS.items()},
             note="ms, plain_ms: device time per launch (profiler, the kernel's own kernels), "
                  "averaged over the l phase streams, on the arm the main path takes (fetch map of "
                  "all real tiles for min/or, static counts for sum); bound_ms counts each real "
                  "slot's word (+ word_hi, + weight) once plus the L-wide payload and output; "
                  "chunks > 1: each lane chunk re-reads its tiles' words; laneless_ms: the laneless "
                  "arm's ms on the same streams (timing phase)")
        return lane_timing, lane_errs

    lane_timing, lane_errs = lane_kernel_phase()

    # -- main path of this slice: K-lane engine runs, default options ---------
    def lane_engine_phase():
        """bfs_multi, sssp_multi and ppr_multi (twice) at K = LANE_K with the
        default options, launches counted; then the checks against
        independent runs. Returns the launch counts."""
        roots = lrng.integers(0, g.num_vertices, LANE_K)
        lane_runs = [("bfs_multi", bfs_multi(roots)), ("sssp_multi", sssp_multi(roots)),
                     ("ppr_multi", ppr_multi(roots, tol=PPR_RUN_TOL)),
                     ("ppr_multi_repeat", ppr_multi(roots, tol=PPR_RUN_TOL))]
        for _, problem in lane_runs[:3]:  # upload each problem's edge tensors (set-up)
            make_iteration(problem, pg, EngineOptions(), device=dev)
        sync()
        K.reset_launch_counts()
        S.reset_launch_counts()
        t0 = time.perf_counter()
        lane_results = {}

        def lane_run(name, problem, opts):
            labels = prepare_labels(problem, g, pg, device=dev)  # host init (set-up)
            sync()
            t = time.perf_counter()
            res = run(problem, g, pg, opts, labels=labels, device=dev)
            sync()
            sec = time.perf_counter() - t
            lane_results[name] = res
            check(res.converged, f"{name}: did not converge in {res.iterations} iterations")
            for key, v in res.labels.items():
                if v.ndim == 2:  # packed reach words: one per 32 lanes
                    lanes = -(-LANE_K // 32) if key == "reach" else LANE_K
                    check(v.shape == (g.num_vertices, lanes), f"{name}: {key} shape {v.shape}")
                if v.dtype == np.float32:
                    check(bool(np.isfinite(v).all()), f"{name}: non-finite {key}")
            emit("lanes_engine_run", t, problem=name, options=opts.direction, lanes=LANE_K,
                 iterations=res.iterations, run_seconds=sec,
                 query_edges_per_s=LANE_K * n_edges / sec, edges=n_edges)

        for name, problem in lane_runs:
            lane_run(name, problem, EngineOptions(lanes=LANE_K))
        lane_push = [("or_u32_lanes", "bfs_multi", bfs_multi(roots)),
                     ("min_f32_add_lanes", "sssp_multi", sssp_multi(roots))]
        forced = [(n, prob) for v, n, prob in lane_push if S.LAUNCHES.get(v, 0) == 0]
        for name, problem in forced:  # 'auto' never pushed: drive the scatter lane arm anyway
            lane_run(f"{name}_push", problem, EngineOptions(lanes=LANE_K, direction="push"))
        lane_launches = {"gather_reduce_cores": {k: v for k, v in K.LAUNCHES.items()},
                         "scatter_reduce_cores": {k: v for k, v in S.LAUNCHES.items()}}
        expect = sum(r.iterations for r in lane_results.values()) * pg.l
        total = sum(K.LAUNCHES.values()) + sum(S.LAUNCHES.values())
        emit("lanes_engine", t0, launches=lane_launches, total_launches=total,
             expected_launches=expect, forced_push=[f"{n}_push" for n, _ in forced],
             roots=roots.tolist())
        if not rehearsal:
            check(total == expect, f"lane launches {lane_launches} != sum(iterations) * l = {expect}")
            for kern, variants in LANE_VARIANTS.items():
                for v in variants:
                    check(lane_launches[kern].get(v, 0) > 0, f"{kern} lane variant {v} never ran")
        for name, _ in forced:
            a, b = lane_results[name], lane_results[f"{name}_push"]
            check(a.iterations == b.iterations and all(np.array_equal(a.labels[k], b.labels[k])
                                                       for k in a.labels),
                  f"{name}: forced push differs from the 'auto' run")
        a = lane_results["ppr_multi"].labels["label"]
        check(a.tobytes() == lane_results["ppr_multi_repeat"].labels["label"].tobytes(),
              "ppr_multi: two kernel runs gave different bits")
        # checks against independent runs (not counted): laneless columns, the
        # oracle backend's K-lane runs, the schedule of each min/or problem
        t0 = time.perf_counter()
        for k in range(2):
            r = int(roots[k])
            check(np.array_equal(lane_results["bfs_multi"].labels["dist"][:, k],
                                 run(bfs(r), g, pg, device=dev).labels["label"]),
                  f"bfs_multi column {k} != bfs({r})")
            check(np.array_equal(lane_results["sssp_multi"].labels["label"][:, k],
                                 run(sssp(r), g, pg, device=dev).labels["label"]),
                  f"sssp_multi column {k} != sssp({r})")
        oracle = {}
        for name, problem in lane_runs[:2]:
            t = time.perf_counter()
            ref = run(problem, g, pg, EngineOptions(backend="oracle"), device=dev)
            sec = time.perf_counter() - t
            got = lane_results[name]
            check(ref.iterations == got.iterations,
                  f"{name}: iterations kernel {got.iterations} vs oracle {ref.iterations}")
            for key in ref.labels:
                check(np.array_equal(got.labels[key], ref.labels[key]),
                      f"{name}: {key} differs from the oracle backend")
            oracle[name] = dict(iterations=ref.iterations, oracle_seconds=sec)
        # PPR for as many iterations as the counted run took, with no lane
        # frozen (tol=0), so that no convergence threshold can split the two
        # backends; held to the PageRank check's relative tolerance
        n_ppr = lane_results["ppr_multi"].iterations
        fixed = EngineOptions(max_iters=n_ppr)
        pk = run(ppr_multi(roots, tol=0.0), g, pg, fixed, device=dev).labels["label"]
        t = time.perf_counter()
        po = run(ppr_multi(roots, tol=0.0), g, pg, dataclasses.replace(fixed, backend="oracle"),
                 device=dev).labels["label"]
        sec = time.perf_counter() - t
        ppr_err = float(np.max(np.abs(pk - po)))
        ppr_rel = float(np.max(np.abs(pk - po) / np.maximum(np.abs(po), np.finfo(np.float32).tiny)))
        check(bool(np.allclose(pk, po, **SUM_TOL)),
              f"ppr_multi: kernel vs oracle max |diff| {ppr_err}, max relative {ppr_rel}")
        oracle["ppr_multi"] = dict(iterations=n_ppr, oracle_seconds=sec, max_abs_diff=ppr_err,
                                   max_rel_diff=ppr_rel, max_abs_label=float(np.max(np.abs(po))),
                                   tolerance=SUM_TOL)
        schedule = {}
        for name, problem in lane_runs[:2]:
            tr = run_frontier_trace(problem, g, pg, EngineOptions(lanes=LANE_K), device=dev)
            check(tr["iterations"] == lane_results[name].iterations
                  and all(np.array_equal(tr["labels"][k], lane_results[name].labels[k])
                          for k in tr["labels"]), f"{name}: run_frontier_trace differs from run")
            schedule[name] = {k: tr[k] for k in ("iterations", "direction", "push_iterations",
                                                  "dense_iterations", "dynamic_skipped_tile_fraction")}
        emit("lanes_engine_checks", t0, columns_checked=2, oracle=oracle, schedule=schedule,
             ppr_bit_stable=True, ppr_iterations=lane_results["ppr_multi"].iterations,
             ppr_note="ppr iterations have no direction: sum problems stay pull")
        return lane_launches

    lane_launches = lane_engine_phase()

    # -- the one-bucket gather kernel over every (core, phase) bucket ---------
    def bucket_phase():
        """ops.gather_reduce over the 64 buckets of the partition, each tiled
        as the partition tiles it, in three forms (BFS-level min on u32,
        SSSP min-plus with weights, PageRank sum), against the fused kernel
        #1 on the same phase payload (natural rows) and the plain version
        (packed rows). Returns (launches, errors, timing)."""
        t0 = time.perf_counter()
        from repro_torch.core.partition import _bucket_split_threshold

        t = time.perf_counter()
        cfg = PartitionConfig(**CFG)
        vpc, vb, eb = pg.vertices_per_core, pg.tile_vb, pg.tile_word.shape[4]
        host = [[BO.prepare_tiles(
            pg.src_gidx[i, m], pg.dst_lidx[i, m], pg.valid[i, m], num_rows=vpc, vb=vb, eb=eb,
            weights=pg.weights[i, m] if pg.weights is not None else None,
            balance_rows=cfg.degree_aware_tiles,
            split_threshold=_bucket_split_threshold(cfg, int(pg.valid[i, m].sum()), vpc // vb))
            for m in range(pg.l)] for i in range(pg.p)]
        build_s = time.perf_counter() - t
        tiles = [[BO.layout_to(tl, dev) for tl in row] for row in host]
        sync()
        slots = sum(int(tl.valid.size) for row in host for tl in row)
        real = sum(int(tl.valid.sum()) for row in host for tl in row)
        split_buckets = sum(tl.row_orig is not None for row in host for tl in row)
        fused_real_slots = float(pg.tile_counts.sum()) * eb
        forms = {"min_u32": bfs(0), "min_f32_add": sssp(0), "sum_f32": pagerank()}
        payloads = {v: [payload_for(v, pg.gathered_size) for _ in range(pg.l)] for v in forms}
        errs, timing = {}, {}
        sync()
        B.reset_launch_counts()
        outs = {}
        for variant, problem in forms.items():  # the main path: ops.gather_reduce per bucket
            kw = dict(kind=problem.reduce_kind, edge_op=problem.edge_op,
                      identity=problem.identity)
            outs[variant] = [[BO.gather_reduce(payloads[variant][m], tiles[i][m], **kw)
                              for m in range(pg.l)] for i in range(pg.p)]
        sync()
        bucket_launches = dict(B.LAUNCHES)
        if not rehearsal:
            check(bucket_launches == {v: pg.p * pg.l for v in forms},
                  f"bucket launches {bucket_launches} != {pg.p * pg.l} per form")
        reps = 2 if rehearsal else 10
        for variant, problem in forms.items():
            kw = dict(kind=problem.reduce_kind, edge_op=problem.edge_op,
                      identity=problem.identity)
            consts = _edge_constants(problem, pg, EngineOptions(), dev)
            err = 0.0
            for m in range(pg.l):
                fused = channel_phase_reduce(problem, pg, payloads[variant][m],
                                             phase_consts_at(consts, m))
                for i in range(pg.p):
                    err = max(err, agree(outs[variant][i][m], fused[i], variant,
                                         f"bucket ({i}, {m}) vs fused"))
            del consts
            add = problem.edge_op == "add"

            def raw_args(i, m, variant=variant, add=add):
                tl = tiles[i][m]
                return ((payloads[variant][m], tl.src, tl.dstb, tl.valid,
                         tl.weights if add else None),
                        dict(num_rows=tl.src.shape[0] * vb, vb=vb, **kw))

            for i, m in ((0, 0), (pg.p - 1, pg.l - 1), (1, pg.l // 2)):
                a, k2 = raw_args(i, m)
                got = B.gather_reduce_bucket(*a, **k2)
                err = max(err, agree(got, B.gather_reduce_bucket_plain(*a, **k2), variant,
                                     f"bucket ({i}, {m}) kernel vs plain"))
                if variant == "sum_f32":
                    check(torch.equal(got.view(torch.int32),
                                      B.gather_reduce_bucket(*a, **k2).view(torch.int32)),
                          f"bucket ({i}, {m}) sum: two launches gave different bits")
            errs[variant] = err
            every = [raw_args(i, m) for i in range(pg.p) for m in range(pg.l)]
            n = len(every)
            row = dict(launches_per_call=n)
            row.update(kernel_ms(lambda: [B.gather_reduce_bucket(*a, **k2) for a, k2 in every],
                                 reps, n, "gather_reduce_kernel"))
            row["plain_ms"] = device_ms(
                lambda: [B.gather_reduce_bucket_plain(*a, **k2) for a, k2 in every],
                max(1, reps // 5), n)
            # each real slot's src, dstb, valid (and weight) once, plus the
            # payload and the output, per launch
            out_rows = sum(int(tl.src.shape[0]) * vb for row_ in host for tl in row_)
            nbytes = real * (9 + 4 * add) + n * pg.gathered_size * 4 + out_rows * 4
            row.update(bound(0, 0, nbytes / n))
            row["bound_ms"] = max(row["bound_ms"], real / n / F32_OPS_PER_S * 1e3)
            timing[variant] = row
        emit("bucket", t0, buckets=pg.p * pg.l, layout_build_seconds=build_s,
             split_buckets=split_buckets, slots=slots, real_edges=real,
             padding_share=1.0 - real / max(slots, 1), launches=bucket_launches,
             max_abs_err=errs, per_launch=timing,
             stream_bytes_per_edge={
                 "bucket_arrays": slots * 9 / real, "bucket_arrays_weighted": slots * 13 / real,
                 "bucket_read": (slots + 8 * real) / real,
                 "fused_packed_words": fused_real_slots * 4 * (1 + (pg.src_bits == 32)) / real},
             note="ms: device time per launch, the mean of the kernel's profiler events over "
                  "10 passes of the 64 buckets (events_seen of events_expected); "
                  "event_clock_ms: CUDA events around the same passes per launch, host gaps "
                  "included; plain_ms: device time per launch (profiler, all events); bound: each real slot's src, dstb, valid (and weight) "
                  "once plus the phase payload and the output at 3.35 TB/s; bucket_read: the "
                  "valid byte of every slot plus src and dstb of the real ones; "
                  "fused_packed_words: the fused kernel's 4 B word of every slot of its real "
                  "tiles; no single PyTorch call computes the function (library_ms null)")
        del tiles, outs, payloads
        return bucket_launches, errs, timing

    bucket_launches, bucket_errs, bucket_timing = bucket_phase()

    # -- DIN at the published width: parameters drawn on the card from the seed
    din_cfg = get_arch("din").smoke() if rehearsal else get_arch("din").model
    t0 = time.perf_counter()
    din_params = din.init(din_cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    sync()
    din_init_s = time.perf_counter() - t0

    def bag_bound(table, ids):
        """Least time for one launch: every id (4 B) read and the output
        written once, plus the distinct 32-B sectors of the rows the real ids
        touch (a row of the 10,000-row cate table read by many bags counts
        once); one add per real id and column at the float32 rate."""
        d = table.shape[1]
        row_bytes = d * 4
        real = ids[ids >= 0].long().unique()
        first, last = real * row_bytes // 32, (real * row_bytes + row_bytes - 1) // 32
        span = torch.arange((row_bytes + 31) // 32 + 1, device=ids.device)
        sec = first[:, None] + span[None, :]
        n_sec = int(sec[sec <= last[:, None]].unique().numel())
        nbytes = ids.numel() * 4 + ids.shape[0] * row_bytes + n_sec * 32
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = int((ids >= 0).sum()) * d / F32_OPS_PER_S * 1e3
        return dict(bound_ms=max(bytes_ms, ops_ms), bound_bytes=nbytes,
                    distinct_rows=int(real.numel()), sectors=n_sec,
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations")

    def library_call(table, ids, mode):
        """The one PyTorch call computing the same function (timed only)."""
        import torch.nn.functional as Fn

        idc, valid = ids.clamp(min=0), ids >= 0
        w = valid.to(table.dtype)
        cnt = valid.sum(dim=1, keepdim=True).clamp(min=1).to(table.dtype)
        if mode == "sum":
            return lambda: Fn.embedding_bag(idc, table, mode="sum", per_sample_weights=w)
        return lambda: Fn.embedding_bag(idc, table, mode="sum", per_sample_weights=w) / cnt

    def bag_kernel_phase():
        """The embedding-bag kernel against its plain version at the four
        shapes, with times and bounds. Returns ({shape[mode]: row}, {mode:
        max error})."""
        t0 = time.perf_counter()
        reps = 3 if rehearsal else 50
        c = din_cfg

        def recsys(batch, step, key):
            b = recsys_batch(SEED, step, batch, c.seq_len, c.item_vocab, c.cate_vocab,
                             c.profile_bag_len)[key]
            return torch.from_numpy(np.ascontiguousarray(b, dtype=np.int32)).to(dev)

        one = retrieval_batch(SEED, c.seq_len, 1, c.item_vocab, c.cate_vocab, c.profile_bag_len)
        shapes = {
            "a_serve_p99": (din_params["cate_table"], [recsys(DIN_BATCH, 0, "profile_bag")]),
            "b_serve_bulk": (din_params["cate_table"],
                             [recsys(4096 if rehearsal else 262_144, 1, "profile_bag")]),
            "c_cold_items": (din_params["item_table"],
                             [recsys(4096, 2 + k, "hist_items") for k in range(COLD_SETS)]),
            "d_one_bag": (din_params["cate_table"],
                          [torch.from_numpy(one["profile_bag"]).to(dev)]),
        }
        rows, errs = {}, {"sum": 0.0, "mean": 0.0}
        for shape, (table, id_sets) in shapes.items():
            ids0 = id_sets[0]
            for mode in ("sum", "mean"):  # checks; they also warm both modes
                got = embedding_bag(table, ids0, mode)
                want = embedding_bag_reference(table, ids0, mode)
                again = embedding_bag(table, ids0, mode)
                lib = library_call(table, ids0, mode)()
                sync()
                err = float((got - want).abs().max()) if got.numel() else 0.0
                check(got.shape == want.shape == (ids0.shape[0], table.shape[1]),
                      f"bag {shape} {mode}: shape {tuple(got.shape)}")
                check(torch.allclose(got, want, **BAG_TOL),
                      f"bag {shape} {mode}: kernel disagrees with plain version (max err {err})")
                check(torch.equal(got.view(torch.int32), again.view(torch.int32)),
                      f"bag {shape} {mode}: two launches gave different bits")
                errs[mode] = max(errs[mode], err)
                row = dict(bags=ids0.shape[0], length=ids0.shape[1], table_rows=table.shape[0],
                           d=table.shape[1], id_sets=len(id_sets), max_abs_err=err,
                           library_max_abs_err=float((lib - want).abs().max()),
                           padding_share=float((ids0 < 0).float().mean()))
                bounds = [bag_bound(table, ids) for ids in id_sets]
                row.update(bounds[0])
                row["bound_ms"] = float(np.mean([b["bound_ms"] for b in bounds]))
                rows[f"{shape}[{mode}]"] = row
            # readings alternate the modes (sum, mean, mean, sum, ...) so that
            # neither is always timed first; each launch takes the next id
            # set (shape (c): rows out of L2)
            cyc = {m: itertools.cycle(id_sets) for m in ("sum", "mean")}
            libs = {m: itertools.cycle([library_call(table, ids, m) for ids in id_sets])
                    for m in ("sum", "mean")}
            readings = {m: {"ms": [], "plain_ms": [], "library_ms": []} for m in ("sum", "mean")}
            for mode in ("sum", "mean", "mean", "sum") * BAG_ROUNDS:
                r = readings[mode]
                r["ms"].append(device_ms(lambda: embedding_bag(table, next(cyc[mode]), mode),
                                         reps, 1, name="embedding_bag_kernel"))
                r["plain_ms"].append(device_ms(
                    lambda: embedding_bag_reference(table, next(cyc[mode]), mode),
                    max(1, reps // 5), 1))
                r["library_ms"].append(device_ms(lambda: next(libs[mode])(), reps, 1))
            for mode, r in readings.items():
                row = rows[f"{shape}[{mode}]"]
                for key, vals in r.items():
                    row[key] = float(np.median(vals))
                    row[f"{key}_min_max"] = [min(vals), max(vals)]
        pad = torch.full((1, c.profile_bag_len), -1, dtype=torch.int32, device=dev)
        for mode in ("sum", "mean"):
            z = embedding_bag(din_params["cate_table"], pad, mode)
            sync()
            check(not bool(z.any()), f"bag all-padding {mode}: not zero")
        emit("bag_kernel", t0, per_launch=rows, max_abs_err=errs, tolerance=BAG_TOL,
             all_padding_bag_zero=True,
             note="ms, plain_ms, library_ms: device time per launch (profiler; ms the kernel's "
                  "own events), the median and the min/max of 2 * BAG_ROUNDS readings per mode, "
                  "the modes alternated (sum, mean, mean, sum, ...); each launch on the next of "
                  "id_sets; plain: L takes added in id order (serial); library: F.embedding_bag "
                  "(clamped ids, the validity mask as per_sample_weights), / max(count, 1) for "
                  "mean; bound_ms: ids + output + distinct 32-B row sectors at 3.35 TB/s, "
                  "averaged over the id sets")
        return rows, errs

    bag_rows, bag_errs = bag_kernel_phase()

    def din_phase():
        """DIN pointwise and retrieval scoring at the published width, as the
        reference CLI runs them, with the kernel's launches counted. Returns
        the launch counts."""
        t0 = time.perf_counter()
        c = din_cfg
        host = recsys_batch(SEED, 0, DIN_BATCH, c.seq_len, c.item_vocab, c.cate_vocab,
                            c.profile_bag_len)
        pb = din.batch_to({k: v for k, v in host.items() if k != "labels"}, dev)
        rb = din.batch_to(retrieval_batch(SEED, c.seq_len, DIN_CANDIDATES, c.item_vocab,
                                          c.cate_vocab, c.profile_bag_len), dev)
        calls = {
            "pointwise": lambda: din.score(din_params, pb, c),
            "retrieval": lambda: din.score_candidates(din_params, rb, c, chunk=DIN_CHUNK),
        }
        reps = {"pointwise": 3, "retrieval": 2} if rehearsal else \
            {"pointwise": 50, "retrieval": 20}
        for fn in calls.values():  # warm
            fn()
        sync()
        EB.reset_launch_counts()
        scores, ms = {}, {}
        for name, fn in calls.items():
            lat = []
            t_all = time.perf_counter()
            for _ in range(reps[name]):
                t = time.perf_counter()
                scores[name] = fn()
                sync()
                lat.append((time.perf_counter() - t) * 1e3)
            ms[name] = dict(total_ms=(time.perf_counter() - t_all) * 1e3,
                            median_ms=float(np.median(lat)), min_ms=min(lat), max_ms=max(lat))
        din_launches = dict(EB.LAUNCHES)
        n_calls = sum(reps.values())
        check(scores["pointwise"].shape == (DIN_BATCH,)
              and scores["retrieval"].shape == (DIN_CANDIDATES,), "DIN score shapes")
        for name, s in scores.items():
            check(bool(torch.isfinite(s).all()), f"DIN {name}: non-finite scores")
        if not rehearsal:
            check(din_launches == {"sum": n_calls},
                  f"DIN: embedding-bag launches {din_launches} != {n_calls} calls")
        # the same calls with the profile bag through the plain version
        kernel_bag = din.embedding_bag
        din.embedding_bag = lambda table, ids, mode: embedding_bag_reference(table, ids, mode)
        try:
            plain = {name: fn() for name, fn in calls.items()}
        finally:
            din.embedding_bag = kernel_bag
        diffs = {}
        for name in calls:
            diffs[name] = float((scores[name] - plain[name]).abs().max())
            check(torch.allclose(scores[name], plain[name], **DIN_TOL),
                  f"DIN {name}: scores differ from the plain-bag run by {diffs[name]}")
        prof, n_prof = {}, 3
        for name, fn in calls.items():
            wall_us, evs = profiled(lambda fn=fn: [fn() for _ in range(n_prof)])
            dev_us = sum(event_us(e) for e in evs)
            top = sorted(evs, key=event_us, reverse=True)[:6]
            prof[name] = dict(
                wall_us=wall_us / n_prof, device_busy_us=dev_us / n_prof,
                bag_kernel_us=sum(event_us(e) for e in evs if "embedding_bag" in e.key) / n_prof,
                device_idle_share=1.0 - dev_us / wall_us if wall_us else None,
                device_launches=sum(e.count for e in evs) / n_prof,
                top_device_us={e.key[:80]: [event_us(e) / n_prof, e.count / n_prof] for e in top})
        emit("din", t0, config={k: (str(v) if k == "dtype" else v)
                                for k, v in dataclasses.asdict(c).items() if k != "lookup"},
             lookup="take", init_seconds=din_init_s, batch=DIN_BATCH,
             candidates=DIN_CANDIDATES, chunk=DIN_CHUNK, calls=reps, ms_per_call=ms,
             pointwise_qps=DIN_BATCH * reps["pointwise"] / ms["pointwise"]["total_ms"] * 1e3,
             retrieval_candidates_per_s=DIN_CANDIDATES * reps["retrieval"]
             / ms["retrieval"]["total_ms"] * 1e3,
             launches=din_launches, expected_launches=n_calls,
             max_abs_diff_vs_plain_bag=diffs, tolerance=DIN_TOL, profile=prof,
             note="lookup: the item-table reads are a take, as the reference CLI runs DIN "
                  "(the config's 'crossbar' runs in serve's RecommendScorer); QPS and "
                  "candidates/s: the rows scored over the wall of all timed calls; "
                  "ms_per_call: host clock around one call ending in a synchronize; "
                  "profile: per call over 3 calls under torch.profiler, device events only")
        return din_launches

    din_launches = din_phase()

    # -- the serving path: GraphService over the built partition --------------
    t0 = time.perf_counter()
    import gc

    from repro_torch.launch.serve import _serve_events, check_replay_equivalence
    from repro_torch.serve import GraphService, LoopConfig, RecommendScorer, RequestLoop

    workload = mixed_query_workload(SERVE_QUERIES, g.num_vertices, seed=SEED)  # default mix
    n_recommend = sum(1 for q in workload if q["kind"] == "recommend")
    deltas = edge_insertion_stream(SERVE_INSERTS, g.num_vertices, num_batches=2, weighted=True,
                                   seed=SEED + 1)
    scorer = RecommendScorer(din_cfg, pool_size=64, topk=8, params=din_params, device=dev)
    service = GraphService(g, pg, lanes=LANE_K, scorer=scorer, device=dev)
    del pg  # the service owns the partition now: a flush retires it
    flush_memory = []
    service_flush = service.flush

    def measured_flush():
        """The service's flush, with the device memory before and after and
        the bytes of the retired partition's device copies."""
        gc.collect()
        sync()
        cached = sum(t.untyped_storage().nbytes() for t in service.pg.device_cache.values()
                     if t is not None and t.device.type == "cuda")
        before = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
        rec = service_flush()
        gc.collect()
        sync()
        after = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
        flush_memory.append(dict(memory_allocated_before=before, memory_allocated_after=after,
                                 retired_device_cache_bytes=cached, wall_s=rec.wall_s))
        print(f"flush {len(flush_memory)}: torch.cuda.memory_allocated() {before} -> {after} "
              f"(retired device copies {cached} B)", flush=True)
        return rec

    service.flush = measured_flush
    loop = RequestLoop(service, LoopConfig(max_wait_ms=20.0, host_batch=LANE_K))
    sync()
    K.reset_launch_counts()
    S.reset_launch_counts()
    EB.reset_launch_counts()
    completions = loop.run(_serve_events(workload, deltas))
    sync()
    serve_launches = {"gather_reduce_cores": dict(K.LAUNCHES),
                      "scatter_reduce_cores": dict(S.LAUNCHES), "embedding_bag": dict(EB.LAUNCHES)}
    summ = loop.metrics.summary()
    trav = [b for b in loop.metrics.batches if b.iterations > 0]
    expect = sum(b.iterations for b in trav) * service.pg.l
    total = sum(K.LAUNCHES.values()) + sum(S.LAUNCHES.values())
    emit("serve", t0, lanes=LANE_K, queries=summ["queries"], rejected=summ["rejected"],
         wall_s=summ["wall_s"], qps=summ["qps"], latency=summ["latency"],
         per_kind=summ["per_kind"], batches=summ["batches"], cold_batches=summ["cold_batches"],
         steady_batch_ms=summ["steady_batch_ms"], amortized_mteps=summ["amortized_mteps"],
         flushes=summ["flushes"], flush_memory=flush_memory, launches=serve_launches,
         total_launches=total, expected_launches=expect, mix=DEFAULT_QUERY_MIX,
         recommend_queries=n_recommend, inserted_edges=SERVE_INSERTS,
         batch_walls_ms_by_kind={k: [b.wall_s * 1e3 for b in loop.metrics.batches if b.kind == k]
                                 for k in sorted({b.kind for b in loop.metrics.batches})},
         batch_log=[dict(kind=b.kind, served=b.served, wall_ms=b.wall_s * 1e3,
                         iterations=b.iterations, cold=b.cold) for b in loop.metrics.batches])
    check(len(completions) == SERVE_QUERIES, f"{len(completions)} answers for {SERVE_QUERIES}")
    check(len(summ["flushes"]) == 2, f"{len(summ['flushes'])} flushes, expected 2")
    check(service.g.num_edges == n_edges + SERVE_INSERTS, "the served graph lost insertions")
    if not rehearsal:
        check(total == expect, f"serve launches {serve_launches} != sum(iterations) * l = {expect}")
        for v in LANE_VARIANTS["gather_reduce_cores"]:
            check(serve_launches["gather_reduce_cores"].get(v, 0) > 0,
                  f"serve: gather lane variant {v} never ran")
        check(n_recommend > 0 and serve_launches["embedding_bag"] == {"sum": n_recommend},
              f"serve: embedding-bag launches {serve_launches['embedding_bag']} != "
              f"{n_recommend} recommend queries")
        for rec in flush_memory:
            freed = rec["memory_allocated_before"] - rec["memory_allocated_after"]
            check(rec["retired_device_cache_bytes"] > 0
                  and freed >= rec["retired_device_cache_bytes"],
                  f"evict_from_cache freed {freed} B of {rec['retired_device_cache_bytes']} B")

    # the smoke's equivalence: a cold partition of the final graph, every
    # answer replayed on both partitions, BFS/WCC/SSSP labels and iterations
    t0 = time.perf_counter()
    g_final, pg_res = service.g, service.pg
    del service, loop, completions
    t = time.perf_counter()
    pg_cold = partition_2d(g_final, PartitionConfig(**CFG))
    cold_build_s = time.perf_counter() - t
    replayed = check_replay_equivalence(g_final, pg_res, pg_cold, workload, LANE_K, dev, scorer)
    check(replayed.get("recommend", 0) == n_recommend and replayed.get("neighbors", 0) > 0,
          f"serve_equivalence replayed {replayed}")
    emit("serve_equivalence", t0, cold_build_seconds=cold_build_s, answers_by_kind=replayed,
         labels_checked=["bfs", "wcc", "sssp"], bit_identical=True,
         note="neighbors: one neighbors-of answer per distinct root of the workload, checked "
              "here and not timed (the default mix sends none)")

    del g_final, pg_res, pg_cold, replayed
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- GAT's segment softmax: the kernel against its plain version ----------
    from repro_torch.data.synthetic import batched_molecules, graph_batch_from_coo
    from repro_torch.models.gnn import archs as gnn_archs
    from repro_torch.models.gnn.common import softmax_tiles
    from repro_torch.train import steps as train_steps
    from repro_torch.train.optim import AdamWConfig, tree_flatten

    def cora_batch(d_feat, n_classes):
        """The full_graph_sm cell uncut: 4096 nodes, 16,384 edge slots (the
        seeded graph's edges, the rest masked), d_feat, n_classes."""
        dims = get_arch("gat-cora").shape("full_graph_sm").dims
        n, slots = dims["n_nodes"], dims["n_edges"]
        gc_ = G.symmetrize(G.rmat(12, 2, seed=SEED))
        check(gc_.num_vertices == n and gc_.num_edges <= slots,
              f"Cora-shape graph: {gc_.num_vertices} nodes, {gc_.num_edges} edges")
        pad = slots - gc_.num_edges
        src = np.concatenate([gc_.src, np.zeros(pad, gc_.src.dtype)])
        dst = np.concatenate([gc_.dst, np.zeros(pad, gc_.dst.dtype)])
        b, lab = graph_batch_from_coo(src, dst, n, d_feat, seed=SEED, n_classes=n_classes)
        mask = torch.from_numpy(np.arange(slots) < gc_.num_edges)
        return dataclasses.replace(b, edge_mask=mask).to(dev), lab, gc_.num_edges

    def gat_params(cfg, d_in, d_out, seed):
        """Seeded parameters with non-zero attention vectors (the reference
        starts them at zero, which makes every softmax uniform)."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        p = gnn_archs.init(cfg, d_in, d_out, gen, dev)
        for k in ("l1_asrc", "l1_adst", "l2_asrc", "l2_adst"):
            p[k] = torch.randn(p[k].shape, generator=gen, device=dev) * 0.5
        return p

    @contextlib.contextmanager
    def plain_softmax():
        """Swap the softmax kernel for its plain version (a reference run)."""
        kernel_fn = SK.segment_softmax_tiles
        SK.segment_softmax_tiles = lambda s, d, v, vb: SK.segment_softmax_tiles_plain(
            s, d, v, vb=vb)
        try:
            yield
        finally:
            SK.segment_softmax_tiles = kernel_fn

    gat_cfg = get_arch("gat-cora").model  # published width: 2 layers, 8 heads x 8
    heads = gat_cfg.n_heads
    t0 = time.perf_counter()
    cora, cora_lab, cora_edges = cora_batch(1433 if not rehearsal else 64, 7)
    products = get_arch("gat-cora").shape("ogb_products").dims
    t = time.perf_counter()
    big, _ = graph_batch_from_coo(g.src, g.dst, g.num_vertices, products["d_feat"], seed=SEED,
                                  n_classes=products["n_classes"])
    big = big.to(dev)
    big_gen_s = time.perf_counter() - t
    sm_rows, sm_err = {}, 0.0
    for label, b in (("a_cora_layer1", cora), ("b_smoke_graph", big)):
        dt = softmax_tiles(b)
        host = b.__dict__["_softmax_host"]
        shape = tuple(dt.dstb.shape)
        srng = np.random.default_rng(SEED + 7)
        scores = torch.from_numpy(((srng.random((heads,) + shape, dtype=np.float32) - 0.5)
                                   * 8)).to(dev)
        sync()
        got = SK.segment_softmax_tiles(scores, dt.dstb, dt.valid, vb=dt.vb)
        want = SK.segment_softmax_tiles_plain(scores, dt.dstb, dt.valid, vb=dt.vb)
        again = SK.segment_softmax_tiles(scores, dt.dstb, dt.valid, vb=dt.vb)
        sync()
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, **SOFTMAX_TOL),
              f"softmax {label}: kernel disagrees with plain version (max err {err})")
        check(torch.equal(got.view(torch.int32), again.view(torch.int32)),
              f"softmax {label}: two launches gave different bits")
        sm_err = max(sm_err, err)
        n_slots = int(dt.valid.numel())
        n_valid = int(dt.valid.sum())
        reps = 2 if rehearsal else 20
        row = dict(heads=heads, rows_per_block=dt.vb, r_blocks=shape[0], tiles=shape[1],
                   slots_per_tile=shape[2], slots=n_slots, valid_slots=n_valid,
                   padding_share=host.padding_share, layout_build_seconds=host.build_seconds,
                   max_abs_err=err)
        row.update(kernel_ms(lambda: SK.segment_softmax_tiles(scores, dt.dstb, dt.valid,
                                                              vb=dt.vb),
                             reps, 1, "segment_softmax_kernel"))
        row["plain_ms"] = device_ms(lambda: SK.segment_softmax_tiles_plain(
            scores, dt.dstb, dt.valid, vb=dt.vb), max(1, reps // 5), 1)
        # scores read and weights written once per head, dstb and valid once;
        # 7 float operations per valid slot and head (max, 2 sub, 2 exp, add, div)
        nbytes = heads * n_slots * 8 + n_slots * 5
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = 7 * heads * n_valid / F32_OPS_PER_S * 1e3
        row.update(bound_ms=max(bytes_ms, ops_ms), bound_bytes=nbytes,
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations", library_ms=None)
        sm_rows[label] = row
        del scores, got, want, again
    emit("softmax_kernel", t0, per_launch=sm_rows, max_abs_err=sm_err, tolerance=SOFTMAX_TOL,
         smoke_graph_generation_seconds=big_gen_s,
         note="(a) GAT layer 1 at the Cora shape (full_graph_sm, 16,384 slots, H = 8); (b) "
              "the smoke graph as one GAT layout, H = 8; seeded scores in (-4, 4); ms: the mean "
              "of the kernel's profiler events over 20 launches (events_seen of "
              "events_expected) or, where it saw none (ms_from), event_clock_ms: CUDA events "
              "around the 20 back-to-back launches; plain_ms: device "
              "time per launch (profiler, all events); bound: "
              "scores read and weights written once per head, dstb and valid read once, at "
              "3.35 TB/s; padding_share: slots no edge fills (the layout has no tile counts, "
              "so the kernel reads them); no single PyTorch call computes a segment softmax "
              "(library_ms null)")

    # -- GNNs at published width: GAT training and inference, one step of each other arch
    def gnn_phase():
        """gat-cora: 50 train steps on the Cora shape, launches counted, and
        inference on the smoke graph at ogbn-products' widths; then one train
        step of each other arch on its cell. Returns the softmax launches."""
        t0 = time.perf_counter()
        n_steps = 3 if rehearsal else 50
        ocfg = AdamWConfig(lr=1e-3, total_steps=n_steps, warmup_steps=min(20, n_steps))
        d_in = cora.node_feat.shape[1]
        params = gat_params(gat_cfg, d_in, 7, SEED)
        labels = torch.from_numpy(cora_lab).to(dev)
        loss_fn = train_steps.make_gnn_loss(gat_cfg, "node_class")
        # the first step's loss and grads against a run with the plain softmax
        loss_k, grads_k = train_steps.value_and_grad(loss_fn, params, cora, labels)
        with plain_softmax():
            loss_p, grads_p = train_steps.value_and_grad(loss_fn, params, cora, labels)
        gk, gp = tree_flatten(grads_k)[0], tree_flatten(grads_p)[0]
        grad_err = max(float((a - b).abs().max()) for a, b in zip(gk, gp))
        check(torch.allclose(loss_k, loss_p, **GNN_TOL)
              and all(torch.allclose(a, b, **GNN_TOL) for a, b in zip(gk, gp)),
              f"gat first step: kernel vs plain softmax loss {float(loss_k)} / "
              f"{float(loss_p)}, max grad diff {grad_err}")
        step = train_steps.make_gnn_train_step(gat_cfg, ocfg, task="node_class")
        state = train_steps.init_train_state(params, ocfg)
        state, _ = step(state, cora, labels)  # warm (not counted)
        state = train_steps.init_train_state(params, ocfg)
        sync()
        SK.reset_launch_counts()
        lat, losses = [], []
        t_all = time.perf_counter()
        for _ in range(n_steps):
            t = time.perf_counter()
            state, m = step(state, cora, labels)
            losses.append(float(m["loss"]))  # waits for the step
            lat.append((time.perf_counter() - t) * 1e3)
        wall = time.perf_counter() - t_all
        train_launches = dict(SK.LAUNCHES)
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"gat train: loss did not fall ({losses[0]} -> {losses[-1]})")
        if not rehearsal:
            check(train_launches == {"f32": 2 * n_steps},
                  f"gat train: softmax launches {train_launches} != 2 x {n_steps} steps")
        wall_us, evs = profiled(lambda: step(state, cora, labels))
        dev_us = sum(event_us(e) for e in evs)
        train = dict(steps=n_steps, ms_per_step=dict(median=float(np.median(lat)),
                                                     min=min(lat), max=max(lat)),
                     steps_per_s=n_steps / wall, loss_first=losses[0], loss_last=losses[-1],
                     first_step_loss=[float(loss_k), float(loss_p)],
                     first_step_max_grad_diff=grad_err, launches=train_launches,
                     profiled_step=dict(wall_us=wall_us, device_busy_us=dev_us,
                                        device_idle_share=1.0 - dev_us / wall_us,
                                        device_events=sum(e.count for e in evs),
                                        softmax_events=[sum(e.count for e in evs
                                                            if "segment_softmax" in e.key), 2],
                                        softmax_us=sum(event_us(e) for e in evs
                                                       if "segment_softmax" in e.key)),
                     real_edges=cora_edges, edge_slots=cora.num_edges, d_feat=d_in)
        del state, params, grads_k, grads_p
        # inference on the smoke graph at ogbn-products' widths (d_feat 100, 47 classes)
        infer = train_steps.make_gnn_infer(gat_cfg)
        iparams = gat_params(gat_cfg, products["d_feat"], products["n_classes"], SEED + 1)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        out = infer(iparams, big)
        sync()
        check(out.shape == (big.num_nodes, products["n_classes"])
              and bool(torch.isfinite(out).all()), "gat infer: non-finite or misshapen output")
        with plain_softmax():
            out_p = infer(iparams, big)
        sync()
        infer_err = float((out - out_p).abs().max())
        check(torch.allclose(out, out_p, rtol=1e-4, atol=1e-4),
              f"gat infer: kernel vs plain softmax max diff {infer_err}")
        del out_p
        n_fwd = 2 if rehearsal else 5
        SK.reset_launch_counts()
        lat = []
        for _ in range(n_fwd):
            t = time.perf_counter()
            out = infer(iparams, big)
            sync()
            lat.append((time.perf_counter() - t) * 1e3)
        infer_launches = dict(SK.LAUNCHES)
        if not rehearsal:
            check(infer_launches == {"f32": 2 * n_fwd},
                  f"gat infer: softmax launches {infer_launches} != 2 x {n_fwd} forwards")
        wall_us, evs = profiled(lambda: infer(iparams, big))
        dev_us = sum(event_us(e) for e in evs)
        top = sorted(evs, key=event_us, reverse=True)[:6]
        med = float(np.median(lat))
        inference = dict(
            nodes=big.num_nodes, edges=big.num_edges, d_feat=products["d_feat"],
            classes=products["n_classes"], forwards=n_fwd,
            ms_per_forward=dict(median=med, min=min(lat), max=max(lat)),
            edges_per_s=big.num_edges / med * 1e3, max_abs_diff_vs_plain=infer_err,
            launches=infer_launches,
            peak_memory_bytes=torch.cuda.max_memory_allocated() if dev.type == "cuda" else None,
            profiled_forward=dict(wall_us=wall_us, device_busy_us=dev_us,
                                  device_idle_share=1.0 - dev_us / wall_us,
                                  device_events=sum(e.count for e in evs),
                                  softmax_events=[sum(e.count for e in evs
                                                      if "segment_softmax" in e.key), 2],
                                  softmax_us=sum(event_us(e) for e in evs
                                                 if "segment_softmax" in e.key),
                                  top_device_us={e.key[:80]: [event_us(e), e.count]
                                                 for e in top}))
        del out, iparams
        # one train step at published width for each other arch, on its cell
        others = {}
        for arch_id, cell in (("gcn-cora", "full_graph_sm"), ("graphsage", "minibatch_lg"),
                              ("schnet", "full_graph_sm"), ("meshgraphnet", "full_graph_sm"),
                              ("gin-tu", "molecule")):
            arch = get_arch(arch_id)
            cfg = arch.smoke() if rehearsal else arch.model
            dims = arch.shape(cell).dims
            loss_nodes, task = None, arch.gnn_task
            if cell == "molecule":
                b, lab = batched_molecules(SEED, dims["n_graphs"], dims["nodes_per"],
                                           dims["edges_per"], dims["d_feat"], dims["n_classes"])
                b, task = b.to(dev), "graph_class"
                out_dim = dims["n_classes"]
            elif cell == "minibatch_lg":  # a seeded graph at the sampler's sizes
                n, e = dims["n_nodes"], dims["n_edges"]
                if rehearsal:
                    n, e = n // 64, e // 64
                erng = np.random.default_rng(SEED + 9)
                b, lab = graph_batch_from_coo(erng.integers(0, n, e), erng.integers(0, n, e), n,
                                              dims["d_feat"], seed=SEED,
                                              n_classes=dims["n_classes"])
                b, loss_nodes = b.to(dev), dims["batch_nodes"]
                out_dim = dims["n_classes"]
            else:
                b = cora
                out_dim = dims["n_classes"] if task.endswith("class") else arch.gnn_out_dim
                lab = cora_lab
            if task == "node_reg":
                lab = np.random.default_rng(SEED + 11).standard_normal(
                    (b.num_nodes, out_dim)).astype(np.float32)
            d_in = b.node_feat.shape[1]
            gen = torch.Generator(device=dev).manual_seed(SEED)
            st = train_steps.init_train_state(gnn_archs.init(cfg, d_in, out_dim, gen, dev), ocfg)
            stp = train_steps.make_gnn_train_step(cfg, ocfg, task=task, loss_nodes=loss_nodes)
            lab_t = torch.from_numpy(lab).to(dev)
            sync()
            t = time.perf_counter()
            st, m = stp(st, b, lab_t)
            loss = float(m["loss"])
            ms = (time.perf_counter() - t) * 1e3
            check(np.isfinite(loss), f"{arch_id} on {cell}: loss {loss}")
            others[arch_id] = dict(cell=cell, task=task, loss=loss, first_step_ms=ms,
                                   nodes=b.num_nodes, edges=b.num_edges, d_feat=d_in,
                                   out_dim=out_dim, config=dataclasses.asdict(cfg) | {
                                       "dtype": str(cfg.dtype)})
            del st, stp
        emit("gnn", t0, config=dataclasses.asdict(gat_cfg) | {"dtype": str(gat_cfg.dtype)},
             train=train, infer=inference, other_archs=others, tolerance=GNN_TOL,
             note="train: gat-cora at published width on full_graph_sm uncut (Cora-shape "
                  "graph symmetrize(rmat(12, 2, seed=0)), padded to 16,384 masked slots), "
                  "AdamW lr 1e-3 as the CLI, host clock per step ending in a read of the loss; "
                  "steps_per_s over the wall of all timed steps; infer: the smoke graph's COO "
                  "(ogbn-products cut to 1,048,576 nodes / 31,403,850 edges) at d_feat 100, "
                  "47 classes; profiled_*: one step or forward under torch.profiler, device "
                  "events only (softmax_events: the softmax kernel's events seen, of 2 launched; "
                  "the profiler can miss events late in this run, so busy time is a floor); "
                  "other archs: one step at published width from a fresh state "
                  "(its first step, so it includes first-call costs)")
        return {"f32": train_launches.get("f32", 0) + infer_launches.get("f32", 0)}

    softmax_launches = gnn_phase()

    kernels = [
        dict(name=f"{kern}_reduce_cores[{v}]", route="cuda", **meta,
             launches=launches[f"{kern}_reduce_cores"].get(v, 0), max_abs_err=errs[(kern, v)],
             ms=timing[(kern, v)]["ms"], plain_ms=timing[(kern, v)]["plain_ms"],
             bound_ms=timing[(kern, v)]["bound_ms"], bound_by=timing[(kern, v)]["bound_by"],
             library_ms=None)
        for kern, meta, variants in (("gather", GATHER, problems), ("scatter", SCATTER, push_variants))
        for v in variants
    ] + [
        dict(name=f"{kern}_reduce_cores[{v}]", route="cuda", **meta,
             launches=lane_launches[f"{kern}_reduce_cores"].get(v, 0),
             max_abs_err=lane_errs[(kern, arm)], ms=lane_timing[(kern, arm)]["ms"],
             plain_ms=lane_timing[(kern, arm)]["plain_ms"],
             bound_ms=lane_timing[(kern, arm)]["bound_ms"],
             bound_by=lane_timing[(kern, arm)]["bound_by"], library_ms=None)
        for kern, meta in (("gather", GATHER), ("scatter", SCATTER))
        for v, arm in LANE_ENTRIES[kern]
    ] + [
        # the main path's bag: DIN's profile bag at serve_p99, shape (a)
        dict(name="embedding_bag[sum]", route="cuda", **EMBAG,
             launches=din_launches.get("sum", 0) + serve_launches["embedding_bag"].get("sum", 0),
             max_abs_err=bag_errs["sum"], ms=bag_rows["a_serve_p99[sum]"]["ms"],
             plain_ms=bag_rows["a_serve_p99[sum]"]["plain_ms"],
             bound_ms=bag_rows["a_serve_p99[sum]"]["bound_ms"],
             bound_by=bag_rows["a_serve_p99[sum]"]["bound_by"],
             library_ms=bag_rows["a_serve_p99[sum]"]["library_ms"])
    ] + [
        dict(name=f"gather_reduce[{v}]", route="cuda", **BUCKET,
             launches=bucket_launches.get(v, 0), max_abs_err=bucket_errs[v],
             ms=bucket_timing[v]["ms"], plain_ms=bucket_timing[v]["plain_ms"],
             bound_ms=bucket_timing[v]["bound_ms"], bound_by=bucket_timing[v]["bound_by"],
             library_ms=None)
        for v in ("min_u32", "min_f32_add", "sum_f32")
    ] + [
        # the trainer's shape: GAT layer 1 at the Cora shape, shape (a)
        dict(name="segment_softmax[f32]", route="cuda", **SOFTMAX,
             launches=softmax_launches.get("f32", 0), max_abs_err=sm_err,
             ms=sm_rows["a_cora_layer1"]["ms"], plain_ms=sm_rows["a_cora_layer1"]["plain_ms"],
             bound_ms=sm_rows["a_cora_layer1"]["bound_ms"],
             bound_by=sm_rows["a_cora_layer1"]["bound_by"], library_ms=None)
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    if rehearsal:
        print("chip_smoke: CPU rehearsal finished; not a chip result", file=sys.stderr)
        return 3
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
