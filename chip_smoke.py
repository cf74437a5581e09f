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

Then a ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": ...}``.
Any failure raises and exits non-zero; it also exits non-zero, printing no
result, when no CUDA device is present or the port's sources are missing.

``--scale N`` shrinks the graph for a quick run. ``--cpu-rehearsal`` runs
every phase on the CPU through the plain versions at a small scale, to check
the script's control flow without a card; it always exits 3.
"""
from __future__ import annotations

import argparse
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

    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.core.graph as G
    from repro_torch.core import frontier_words as F
    from repro_torch.core import reference, u32
    from repro_torch.core.engine import (
        EngineOptions, _edge_constants, channel_phase_reduce_oracle,
        make_iteration, phase_consts_at, prepare_labels, run, run_frontier_trace,
    )
    from repro_torch.core.partition import PartitionConfig, partition_2d
    from repro_torch.core.problems import bfs, pagerank, sssp, wcc
    from repro_torch.kernels.build import build_library, load_library
    from repro_torch.kernels.csr_gather_reduce import kernel as K
    from repro_torch.kernels.csr_gather_reduce import scatter as S

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
        sources = (K.SOURCE, S.SOURCE)
        with ThreadPoolExecutor(len(sources)) as pool:
            logs = dict(zip(sources, pool.map(lambda s: build_library(s)[1], sources)))
        for s in sources:
            load_library(s)
        ptxas = {s: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
                 for s, log in logs.items()}
        emit("build", t0, sources=[GATHER["source"], SCATTER["source"]], ptxas=ptxas)

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

    # -- each kernel against its plain version --------------------------------
    t0 = time.perf_counter()
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

    def bound(real_slots, streams_per_slot, extra_bytes):
        """Least time for the work: each real slot's word (+ word_hi, +
        weight where streamed) read once, plus the other inputs read and the
        output written once, over 3.35 TB/s; one op per real slot."""
        nbytes = real_slots * 4 * streams_per_slot + extra_bytes
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = real_slots / F32_OPS_PER_S * 1e3
        return dict(bound_ms=max(bytes_ms, ops_ms), bound_bytes=nbytes,
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations")

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

    kernels = [
        dict(name=f"{kern}_reduce_cores[{v}]", route="cuda", **meta,
             launches=launches[f"{kern}_reduce_cores"].get(v, 0), max_abs_err=errs[(kern, v)],
             ms=timing[(kern, v)]["ms"], plain_ms=timing[(kern, v)]["plain_ms"],
             bound_ms=timing[(kern, v)]["bound_ms"], bound_by=timing[(kern, v)]["bound_by"],
             library_ms=None)
        for kern, meta, variants in (("gather", GATHER, problems), ("scatter", SCATTER, push_variants))
        for v in variants
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
