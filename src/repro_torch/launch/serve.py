"""Serving CLI of the port: batched greedy decode for LM archs, DIN
pointwise/retrieval scoring and lane-batched graph query serving, on the
device.

Counterpart of ``repro.launch.serve`` in its LM (``--arch <lm arch>``), DIN
(``--arch din``) and graph (``--arch graph``) modes.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m --tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch din --mode retrieval
    PYTHONPATH=src python -m repro_torch.launch.serve --arch din --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch graph --lanes 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch graph --smoke
    PYTHONPATH=src python -m repro_torch.launch.serve --arch graph --smoke --device cpu

The graph workload is the reference's ``mixed_query_workload`` with its
default mix (bfs 0.35, sssp 0.2, ppr 0.2, recommend 0.25).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs.registry import ARCHS, get


def serve_lm(arch, tokens: int, batch: int, device="cuda", *, cfg=None, params=None,
             max_len=None):
    """The reference's greedy KV-cache decode loop: ``batch`` sequences from
    token 0, ``tokens`` steps, each feeding back the argmax. At the arch's
    smoke config with seeded weights unless ``cfg`` / ``params`` are given;
    the cache holds ``max_len`` (default ``tokens + 8``) positions in the
    config's type (the reference's float32 is its smoke configs' type).
    Returns (tokens (batch, tokens) int64 numpy, seconds of the loop)."""
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.models.transformer import init_kv_cache, init_params
    from repro_torch.train.steps import make_lm_decode_step

    dev = resolve_device(device)
    cfg = cfg if cfg is not None else arch.smoke()
    if params is None:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    max_len = max_len if max_len is not None else tokens + 8
    cache = init_kv_cache(cfg, batch, max_len, device=dev)
    step = make_lm_decode_step(cfg)
    tok = torch.zeros((batch, 1), dtype=torch.long, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = []
    for i in range(tokens):
        logits, cache = step(params, cache, tok, i)
        tok = torch.argmax(logits, dim=-1)[:, None]
        out.append(tok[:, 0])
    seq = torch.stack(out, 1).cpu().numpy()  # waits for the last step
    dt = time.perf_counter() - t0
    print(f"decoded {tokens} tokens x batch {batch} on {dev.type} in {dt:.2f}s "
          f"({tokens * batch / dt:.1f} tok/s)")
    print("sample:", seq[0][:16].tolist())
    return seq, dt


def serve_din(arch, mode: str, device="cuda"):
    """DIN scoring at the arch's smoke config with seeded random weights, as
    the reference CLI runs it: ``pointwise`` scores a ``recsys_batch`` of
    512, ``retrieval`` one user against 4096 candidates in chunks of 512.
    Times the second of two calls; returns the scores."""
    import torch

    from repro_torch.data.synthetic import recsys_batch, retrieval_batch
    from repro_torch.device import resolve_device
    from repro_torch.models.recsys import din

    dev = resolve_device(device)
    cfg = arch.smoke()
    params = din.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    if mode == "retrieval":
        batch = din.batch_to(retrieval_batch(0, cfg.seq_len, 4096, cfg.item_vocab,
                                             cfg.cate_vocab, cfg.profile_bag_len), dev)

        def fn():
            return din.score_candidates(params, batch, cfg, chunk=512)
    else:
        host = recsys_batch(0, 0, 512, cfg.seq_len, cfg.item_vocab, cfg.cate_vocab,
                            cfg.profile_bag_len)
        batch = din.batch_to({k: v for k, v in host.items() if k != "labels"}, dev)

        def fn():
            return din.score(params, batch, cfg)

    def timed():
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    timed()  # first call: builds and loads the kernel on the card
    s, dt = timed()
    if not bool(torch.isfinite(s).all()):
        raise AssertionError("non-finite DIN scores")
    if mode == "retrieval":
        top = int(batch["cand_items"][int(torch.argmax(s))])
        print(f"retrieval on {dev}: 4096 candidates in {dt * 1e3:.1f} ms; top item {top}")
    else:
        print(f"pointwise on {dev}: batch 512 in {dt * 1e3:.2f} ms ({512 / dt:.0f} QPS)")
    return s


def _serve_events(workload, deltas):
    """Interleave a mixed query workload with delta-ingest batches: each
    insertion batch (followed by an explicit flush) lands at an even split
    point of the query stream — the 'graph mutates mid-stream' scenario."""
    from repro_torch.serve import Query

    n = len(workload)
    cuts = {max(1, (i + 1) * n // (len(deltas) + 1)): d for i, d in enumerate(deltas)}
    events = []
    for i, q in enumerate(workload):
        if i in cuts:
            events.append(("delta", cuts[i]))
            events.append(("flush", None))
        events.append(("query", Query(kind=q["kind"], root=q["root"], target=q["target"], qid=i)))
    return events


def serve_graph(
    lanes: int,
    queries: int,
    scale: int,
    degree: int,
    seed: int,
    smoke: bool = False,
    delta_edges: int = 96,
    device="cuda",
):
    """Always-on graph serving: ONE resident partitioned graph answers a mixed
    distance-to (BFS + SSSP lanes) / PPR / recommend-for (DIN at the smoke
    config, a pool of 64, top 8) query stream, the reference's default mix, through
    the bounded-admission request loop, while streamed edge insertions are
    delta-ingested mid-stream — flushes re-tile only the dirty (core, phase)
    buckets and swap the resident partition between batches.

    ``smoke``: after the run, re-answer every query on BOTH the final
    resident partition (incrementally re-tiled) and a from-scratch
    repartition of the final graph, in the same batches on both, and assert
    the answers are bit-for-bit identical, and neighbors-of for every root
    of the stream likewise; also assert BFS/WCC/SSSP label
    and iteration equality and that every flush re-tiled at most every
    bucket it reports."""
    import repro_torch.core.graph as G
    from repro_torch.core.partition import PartitionConfig, partition_2d
    from repro_torch.data.synthetic import edge_insertion_stream, mixed_query_workload
    from repro_torch.device import resolve_device
    from repro_torch.serve import GraphService, LoopConfig, RecommendScorer, RequestLoop

    dev = resolve_device(device)
    g0 = G.symmetrize(G.rmat(scale, degree, seed=1))
    w = (np.random.default_rng(2).random(g0.num_edges) + 0.1).astype(np.float32)
    g = G.COOGraph(src=g0.src, dst=g0.dst, num_vertices=g0.num_vertices, weights=w)
    cfg = PartitionConfig(p=4, l=2)
    scorer = RecommendScorer(pool_size=64, topk=8, device=dev)
    service = GraphService(g, cfg, lanes=lanes, scorer=scorer, device=dev)
    loop = RequestLoop(service, LoopConfig(max_wait_ms=20.0, host_batch=lanes))

    workload = mixed_query_workload(queries, g.num_vertices, seed=seed)
    deltas = edge_insertion_stream(delta_edges, g.num_vertices, num_batches=2, weighted=True,
                                   seed=seed + 1)
    events = _serve_events(workload, deltas)
    completions = loop.run(events)
    s = loop.metrics.summary()

    lat = s["latency"]
    print(
        f"served {s['queries']} queries ({s['rejected']} rejected) on {dev} in "
        f"{s['wall_s']:.2f}s = {s['qps']:.1f} QPS; latency p50 "
        f"{lat['p50_ms']:.1f} / p95 {lat['p95_ms']:.1f} / p99 {lat['p99_ms']:.1f} ms"
    )
    steady = s["steady_batch_ms"]
    print(
        f"{s['batches']} batches ({s['cold_batches']} cold), steady batch "
        + (f"{steady:.2f} ms" if steady is not None else "n/a")
        + (f", amortized {s['amortized_mteps']:.2f} MTEPS" if s["amortized_mteps"] else "")
    )
    for f in s["flushes"]:
        print(
            f"flush: +{f['edges_added']} edges re-tiled {f['buckets_retiled']}/"
            f"{f['total_buckets']} buckets ({100 * f['repacked_fraction']:.0f}% of packed "
            f"bytes) in {f['wall_s'] * 1e3:.1f} ms"
        )
    if not smoke:
        return s

    # -- smoke equivalence: resident (incrementally re-tiled) partition vs a
    # from-scratch repartition of the final graph, bit for bit
    if len(completions) != len(workload):
        raise AssertionError(f"{len(completions)} completions for {len(workload)} queries")
    if not s["flushes"]:
        raise AssertionError("smoke must exercise delta ingest")
    for f in s["flushes"]:
        if f["buckets_retiled"] > f["total_buckets"] or f["repacked_fraction"] > 1.0:
            raise AssertionError(f"flush report out of range: {f}")
    g_final, pg_res = service.g, service.pg
    if g_final.num_edges != g.num_edges + delta_edges:
        raise AssertionError("the final graph lost inserted edges")
    pg_cold = partition_2d(g_final, cfg)
    counts = check_replay_equivalence(g_final, pg_res, pg_cold, workload, lanes, dev, scorer)
    print(
        "serve smoke OK: resident delta-retiled partition matches from-scratch "
        f"repartition bit-for-bit (answers {counts} + BFS/WCC/SSSP labels)"
    )
    return s


def check_replay_equivalence(g_final, pg_res, pg_cold, workload, lanes, device, scorer):
    """Answer every query of ``workload`` on both partitions and require
    bit-identical answers (recommend-for through the one ``scorer``: the
    same params, and the same pool from the same graph), then neighbors-of
    for every distinct root of the workload (the default mix sends none, so
    it is checked here and not timed), then BFS/WCC/SSSP labels and
    iterations equal; raises AssertionError on the first difference.
    Returns the answers compared, by kind.

    Both sides answer the SAME batches (same-kind queries in stream order,
    ``lanes`` at a time) through the router. A request-loop replay would
    form its batches from wall-clock deadlines, which differ from run to
    run, and a PPR answer depends on its batch (the lanes share one
    iteration count)."""
    from repro_torch.core.engine import EngineOptions, run
    from repro_torch.core.problems import bfs, sssp, wcc
    from repro_torch.serve import GraphService, Query

    by_kind: dict = {}
    for i, q in enumerate(workload):
        by_kind.setdefault(q["kind"], []).append(
            Query(kind=q["kind"], root=q["root"], target=q["target"], qid=i))
    roots = sorted({int(q["root"]) for q in workload})
    extra = [Query(kind="neighbors", root=r, qid=len(workload) + j) for j, r in enumerate(roots)]
    by_kind.setdefault("neighbors", []).extend(extra)
    svc_a = GraphService(g_final, pg_res, lanes=lanes, scorer=scorer, device=device)
    svc_b = GraphService(g_final, pg_cold, lanes=lanes, scorer=scorer, device=device)
    counts = {}
    for kind, queries in by_kind.items():
        for j in range(0, len(queries), lanes):
            batch = queries[j:j + lanes]
            res_a, res_b = svc_a.answer_batch(batch), svc_b.answer_batch(batch)
            if res_a.iterations != res_b.iterations:
                raise AssertionError(f"{kind} batch at query {batch[0].qid}: iterations "
                                     f"{res_a.iterations} vs {res_b.iterations}")
            for q, a, b in zip(batch, res_a.answers, res_b.answers):
                if isinstance(a, np.ndarray):
                    a, b = {"neighbors": a}, {"neighbors": b}
                for k in a:
                    if not np.array_equal(np.asarray(a[k]), np.asarray(b[k])):
                        raise AssertionError(f"{kind} query {q.qid}: {k} differs: "
                                             f"{a[k]} vs {b[k]}")
                counts[kind] = counts.get(kind, 0) + 1
    if sum(counts.values()) != len(workload) + len(extra):
        raise AssertionError(f"compared {counts} answers of {len(workload)} + {len(extra)}")
    # full-label equality (incl. WCC, which the router does not serve)
    for prob in (bfs(0), wcc(), sssp(0)):
        ra = run(prob, g_final, pg_res, EngineOptions(), device=device)
        rb = run(prob, g_final, pg_cold, EngineOptions(), device=device)
        if ra.iterations != rb.iterations:
            raise AssertionError(f"{prob.name}: iterations {ra.iterations} vs {rb.iterations}")
        for k in ra.labels:
            if not np.array_equal(ra.labels[k], rb.labels[k]):
                raise AssertionError(f"{prob.name}: labels {k} differ")
    return counts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS) + ["graph"],
                    help="a model arch (an LM arch or din; GNN archs run in "
                         "launch.train), or 'graph' for lane-batched graph query serving")
    ap.add_argument("--tokens", type=int, default=32, help="LM decode steps")
    ap.add_argument("--batch", type=int, default=4, help="LM decode batch")
    ap.add_argument("--mode", default="pointwise", choices=["pointwise", "retrieval"])
    ap.add_argument("--lanes", type=int, default=16, help="admission batch width K")
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--scale", type=int, default=9, help="rmat scale")
    ap.add_argument("--degree", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--delta-edges", type=int, default=96,
                    help="edge insertions streamed mid-run")
    ap.add_argument("--smoke", action="store_true",
                    help="bounded run: assert delta-retiled answers match a from-scratch "
                         "repartition bit-for-bit")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    if args.arch != "graph":
        arch = get(args.arch)
        if arch.family == "lm":
            serve_lm(arch, args.tokens, args.batch, device=args.device)
        elif arch.family == "recsys":
            serve_din(arch, args.mode, device=args.device)
        else:
            raise SystemExit("GNN archs serve via launch.train")
        return
    if args.smoke:
        # bounded: small graph, few queries, still covers every kind and two
        # mid-stream delta flushes
        serve_graph(lanes=8, queries=40, scale=8, degree=6, seed=args.seed, smoke=True,
                    delta_edges=64, device=args.device)
        return
    serve_graph(args.lanes, args.queries, args.scale, args.degree, args.seed,
                delta_edges=args.delta_edges, device=args.device)


if __name__ == "__main__":
    main()
