#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py                 # on a machine with a CUDA card

Phases, one JSON line each (``{"phase": ..., "seconds": ...}``):

  card       nvidia-smi name and power limit (also printed raw)
  build      nvcc builds every CUDA source of the port (sm_90a)
  graph      graph500 RMAT, scale 20, edge factor 16, seed 0, deduplicated
             and symmetrized, float32 weights from the seed
  partition  partition_2d(p=4, l=16, tile_vb=1024, tile_eb=128,
             build_push=False) with memory_report()
  kernel     gather_reduce_cores against its plain PyTorch version on the
             card, on phase 0 of the real partition and on a small unweighted
             graph in the 32-bit regime: min u32 (BFS/WCC), min f32 + weights (SSSP),
             sum f32 (PageRank). Min must be bit-equal, sum within
             rtol=1e-5, atol=1e-9.
  timing     per variant, the kernel's and the plain version's device time
             per launch over all l phases (profiler), the byte bound at
             3.35 TB/s, and the oracle backend's time per phase (no single
             PyTorch call computes this function)
  main_path  engine.run(backend='kernel') for BFS (root 0), WCC, SSSP
             (root 0) and PageRank (twice), with iterations, seconds and
             MTEPS = E / seconds (label init on the host is timed apart as
             set-up); the launch counts are zeroed just before and read just
             after, and must equal sum(iterations) * l
  profile    torch.profiler over one iteration per problem: device busy
             time, the kernel's share, the top device events
  oracle     the same four runs with backend='oracle': BFS/WCC/SSSP labels
             and iterations bit-equal, PageRank within rtol=1e-5, atol=1e-9
             with equal iterations; the two kernel PageRank runs bit-equal
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
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
SEED = 0
CFG = dict(p=4, l=16, tile_vb=1024, tile_eb=128, build_push=False)
SUM_TOL = dict(rtol=1e-5, atol=1e-9)
KERNEL_SOURCE = "src/repro_torch/csrc/gather_reduce_cores.cu"
KERNEL_REPLACES = "src/repro/kernels/csr_gather_reduce/kernel.py:221"


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
    from repro_torch.core import reference, u32
    from repro_torch.core.engine import (
        EngineOptions, _edge_constants, channel_phase_reduce_oracle,
        make_iteration, phase_consts_at, prepare_labels, run,
    )
    from repro_torch.core.partition import PartitionConfig, partition_2d
    from repro_torch.core.problems import bfs, pagerank, sssp, wcc
    from repro_torch.kernels.build import load_library
    from repro_torch.kernels.csr_gather_reduce import kernel as K

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

    # -- build ----------------------------------------------------------------
    t0 = time.perf_counter()
    if not rehearsal:
        _, log = load_library(K.SOURCE)
        ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        emit("build", t0, source=KERNEL_SOURCE, ptxas=ptxas)

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
         device_bytes=rep["device"], device_total_bytes=rep["device_total_bytes"],
         device_bytes_per_edge=rep["device_bytes_per_edge"],
         host_flat_total_bytes=rep["host_flat_total_bytes"])

    # -- kernel against its plain version -------------------------------------
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 1)
    problems = {"min_u32": bfs(0), "min_f32_add": sssp(0), "sum_f32": pagerank()}

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

    def kernel_args(graph, problem):
        consts = _edge_constants(problem, graph, EngineOptions(), dev)
        kw = dict(num_rows=graph.packed_rows_per_core, vb=graph.tile_vb,
                  src_bits=graph.src_bits, kind=problem.reduce_kind,
                  edge_op=problem.edge_op, identity=problem.identity)
        return consts, kw

    def compare(graph, label):
        errs = {}
        for variant, problem in problems.items():
            consts, kw = kernel_args(graph, problem)
            cm = phase_consts_at(consts, 0)
            payload = payload_for(variant, graph.gathered_size)
            args = (payload, cm["word"], cm["counts"], cm["word_hi"], cm["w"])
            got = K.gather_reduce_cores(*args, **kw)
            want = K.gather_reduce_cores_plain(*args, **kw)
            sync()
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
            errs[variant] = err
        return errs

    errs_main = compare(pg, "phase 0")
    # unweighted, so SSSP's add runs on unit weights here (the main graph is weighted)
    g32 = G.symmetrize(G.rmat(min(scale, 12), 16, seed=SEED + 2))
    pg32 = partition_2d(g32, PartitionConfig(p=4, l=2, tile_vb=64, pack_src_bits=32,
                                             build_push=False))
    check(pg32.src_bits == 32, "32-bit regime graph did not pack 32-bit words")
    errs_32 = compare(pg32, "32-bit")
    max_err = {v: max(errs_main[v], errs_32[v]) for v in problems}
    emit("kernel", t0, max_abs_err=max_err, src_bits_checked=[pg.src_bits, pg32.src_bits],
         small_graph_edges=g32.num_edges)

    # -- timing: kernel, plain version, bound, oracle per phase ---------------
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

    timing = {}
    reps = 3 if rehearsal else 20
    for variant, problem in problems.items():
        consts, kw = kernel_args(pg, problem)
        phases = [phase_consts_at(consts, m) for m in range(pg.l)]
        payload = payload_for(variant, pg.gathered_size)

        def launch_all(fn, phases=phases, payload=payload, kw=kw):
            # one call = one launch per phase; the 16 phase streams exceed L2
            for cm in phases:
                fn(payload, cm["word"], cm["counts"], cm["word_hi"], cm["w"], **kw)

        k_ms = device_ms(lambda: launch_all(K.gather_reduce_cores), reps, pg.l,
                         name="gather_reduce_cores_kernel")
        k_wall = wall_ms(lambda: launch_all(K.gather_reduce_cores), reps) / pg.l
        p_ms = device_ms(lambda: launch_all(K.gather_reduce_cores_plain), max(1, reps // 4), pg.l)
        # least time for the same work: each real slot's word (+ word_hi,
        # + weight where streamed) read once, the counts, the payload block
        # read once, the output written once; one op per real slot
        real_slots = float(pg.tile_counts.sum()) * pg.tile_word.shape[4] / pg.l
        has_hi, has_w = phases[0]["word_hi"] is not None, phases[0]["w"] is not None
        nbytes = (real_slots * 4 * (1 + has_hi + has_w) + pg.tile_counts[:, 0].nbytes
                  + pg.gathered_size * 4 + pg.p * pg.packed_rows_per_core * 4)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = real_slots / F32_OPS_PER_S * 1e3
        oracle_consts = _edge_constants(problem, pg, EngineOptions(backend="oracle"), dev)
        o_phases = [phase_consts_at(oracle_consts, m) for m in range(pg.l)]

        def oracle_all(problem=problem, o_phases=o_phases, payload=payload):
            for cm in o_phases:
                channel_phase_reduce_oracle(problem, pg, payload, cm)

        o_ms = device_ms(oracle_all, max(1, reps // 4), pg.l)
        timing[variant] = dict(
            ms=k_ms, plain_ms=p_ms, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            bound_bytes=nbytes, word_hi=has_hi, weights=has_w,
            launch_wall_ms=k_wall, oracle_phase_ms=o_ms,
        )
    emit("timing", t0, per_launch=timing, real_tiles_per_phase=float(pg.tile_counts.sum()) / pg.l,
         note="ms, plain_ms, oracle_phase_ms: device time per launch (profiler, kernels "
              "only), averaged over the l phase streams; launch_wall_ms: CUDA-event time "
              "per launch with host launch gaps; no single PyTorch call computes this "
              "function (library_ms null)")

    # -- main path: the port's engine on the kernel backend --------------------
    runs = [("bfs", bfs(0)), ("wcc", wcc()), ("sssp", sssp(0)),
            ("pagerank", pagerank()), ("pagerank_repeat", pagerank())]
    for _, problem in runs:  # upload each problem's edge tensors (set-up)
        make_iteration(problem, pg, EngineOptions(), device=dev)
    sync()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    results = {}
    for name, problem in runs:
        t = time.perf_counter()
        labels = prepare_labels(problem, g, pg, device=dev)  # host init (set-up)
        sync()
        init_sec = time.perf_counter() - t
        t1 = time.perf_counter()
        res = run(problem, g, pg, EngineOptions(), labels=labels, device=dev)
        sync()
        sec = time.perf_counter() - t1
        results[name] = res
        lab = res.labels["label"]
        check(lab.shape == (g.num_vertices,), f"{name}: label shape {lab.shape}")
        check(res.converged, f"{name}: did not converge in {res.iterations} iterations")
        if lab.dtype == np.float32:
            check(bool(np.isfinite(lab).all()), f"{name}: non-finite labels")
        emit("main_path_run", t, problem=name, iterations=res.iterations, init_seconds=init_sec,
             run_seconds=sec, mteps=n_edges / sec / 1e6, edges=n_edges)
    launches = dict(K.LAUNCHES)
    expect = sum(r.iterations for r in results.values()) * pg.l
    emit("main_path", t0, launches=launches, expected_launches=expect)
    if not rehearsal:
        check(sum(launches.values()) == expect,
              f"kernel launches {launches} != sum(iterations) * l = {expect}")
        for variant in problems:
            check(launches.get(variant, 0) > 0, f"variant {variant} was never launched")

    # -- where one iteration's time goes (after the counts were read) ---------
    t0 = time.perf_counter()
    breakdown = {}
    for name, problem in runs[:4]:
        labels = prepare_labels(problem, g, pg, device=dev)
        iteration = make_iteration(problem, pg, EngineOptions(), device=dev)
        iteration(labels)  # warm
        sync()
        wall_us, evs = profiled(lambda: iteration(labels))
        dev_us = sum(event_us(e) for e in evs)
        kern_us = sum(event_us(e) for e in evs if "gather_reduce_cores_kernel" in e.key)
        top = sorted(evs, key=event_us, reverse=True)[:8]
        breakdown[name] = dict(
            iteration_wall_us=wall_us, device_busy_us=dev_us, kernel_us=kern_us,
            device_idle_share=1.0 - dev_us / wall_us if wall_us else None,
            device_launches=sum(e.count for e in evs),
            top_device_us={e.key[:80]: [event_us(e), e.count] for e in top},
        )
    emit("profile", t0, one_iteration=breakdown,
         note="torch.profiler over one warm iteration (l phases) per problem; device "
              "events only; the profiler's own host overhead inflates iteration_wall_us")

    # -- oracle backend on the card, kernel PR bit-stability -------------------
    t0 = time.perf_counter()
    agree = {}
    for name, problem in runs[:4]:
        labels = prepare_labels(problem, g, pg, device=dev)
        sync()
        t = time.perf_counter()
        ref = run(problem, g, pg, EngineOptions(backend="oracle"), labels=labels, device=dev)
        sync()
        sec = time.perf_counter() - t
        got = results[name]
        check(ref.iterations == got.iterations,
              f"{name}: iterations kernel {got.iterations} vs oracle {ref.iterations}")
        a, b = got.labels["label"], ref.labels["label"]
        if problem.reduce_kind == "min":
            check(a.dtype == b.dtype and np.array_equal(a, b), f"{name}: labels differ from oracle")
            err = 0.0
        else:
            err = float(np.max(np.abs(a - b)))
            check(bool(np.allclose(a, b, **SUM_TOL)), f"{name}: labels differ from oracle by {err}")
        agree[name] = dict(iterations=ref.iterations, oracle_seconds=sec,
                           oracle_mteps=n_edges / sec / 1e6, max_abs_diff=err)
    pr_a = results["pagerank"].labels["label"]
    pr_b = results["pagerank_repeat"].labels["label"]
    check(pr_a.tobytes() == pr_b.tobytes(), "pagerank: two kernel runs gave different bits")
    emit("oracle", t0, agree=agree, pagerank_bit_stable=True)

    # -- small graph against the numpy oracles --------------------------------
    t0 = time.perf_counter()
    gs0 = G.symmetrize(G.rmat(10, 8, seed=SEED + 3))
    ws = np.random.default_rng(SEED + 3).random(gs0.num_edges).astype(np.float32)
    gs = G.COOGraph(src=gs0.src, dst=gs0.dst, num_vertices=gs0.num_vertices, weights=ws)
    pgs = partition_2d(gs, PartitionConfig(p=2, l=2, lane=8, tile_vb=64, build_push=False))
    check(np.array_equal(run(bfs(0), gs, pgs, device=dev).labels["label"],
                         reference.bfs_reference(gs, 0)), "small bfs != numpy oracle")
    check(np.array_equal(run(wcc(), gs, pgs, device=dev).labels["label"],
                         reference.wcc_reference(gs)), "small wcc != numpy oracle")
    check(np.allclose(run(sssp(0), gs, pgs, device=dev).labels["label"],
                      reference.sssp_reference(gs, 0), rtol=1e-6),
          "small sssp != numpy oracle")
    check(np.allclose(run(pagerank(), gs, pgs, device=dev).labels["label"],
                      reference.pagerank_reference(gs), atol=1e-4),
          "small pagerank != numpy oracle")
    emit("reference", t0, edges=gs.num_edges)

    kernels = [
        dict(name=f"gather_reduce_cores[{v}]", route="cuda", source=KERNEL_SOURCE,
             replaces=KERNEL_REPLACES, launches=launches.get(v, 0), max_abs_err=max_err[v],
             ms=timing[v]["ms"], plain_ms=timing[v]["plain_ms"],
             bound_ms=timing[v]["bound_ms"], bound_by=timing[v]["bound_by"],
             library_ms=None)
        for v in problems
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
