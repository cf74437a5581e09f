"""Rank bodies of tests/test_torch_distributed.py, test_torch_elastic.py,
test_torch_fault_tolerance.py, test_torch_compression.py,
test_torch_pipeline.py and test_torch_sharded_loss.py: functions that
``repro_torch.launch.mesh.spawn_ranks`` runs in every spawned rank (gloo, the
CPU). They import only the port, so a rank never loads JAX; the test files
hold their results against the reference's.

The graphs are built from the same numpy code in both packages
(``graph(name, G, skewed_graph)``), so the partitions are byte-identical.
"""
import numpy as np
import torch

# the cases of tests/test_distributed_equiv.py:54-140, plus forced push and
# lane batches: graph -> partition config
GRAPH_CONFIGS = {
    "stride": dict(p=4, l=2, lane=4, stride=100),
    "pr": dict(p=4, l=2, lane=4),
    "hub": dict(p=4, l=2, lane=8, tile_vb=32),
    "dyn": dict(p=4, l=2, lane=4, stride=100),
}
STATIC = dict(dynamic_tile_skip=False)
PUSH = dict(direction="push")
# (case id, graph, problem, problem args, problem kwargs, EngineOptions kwargs)
ENGINE_CASES = [
    ("stride-bfs", "stride", "bfs", (7,), {}, {}),
    ("stride-wcc", "stride", "wcc", (), {}, {}),
    ("stride-sssp", "stride", "sssp", (7,), {}, {}),
    ("pr-pagerank", "pr", "pagerank", (), dict(tol=1e-5), {}),
    ("hub-bfs", "hub", "bfs", (3,), {}, {}),
    ("hub-wcc", "hub", "wcc", (), {}, {}),
    ("hub-sssp", "hub", "sssp", (3,), {}, {}),
    ("hub-pagerank", "hub", "pagerank", (), dict(tol=1e-4), {}),
    ("dyn-bfs", "dyn", "bfs", (2,), {}, {}),
    ("dyn-wcc", "dyn", "wcc", (), {}, {}),
    ("dyn-sssp", "dyn", "sssp", (2,), {}, {}),
    ("dyn-bfs-static", "dyn", "bfs", (2,), {}, STATIC),
    ("dyn-wcc-static", "dyn", "wcc", (), {}, STATIC),
    ("dyn-sssp-static", "dyn", "sssp", (2,), {}, STATIC),
    ("dyn-bfs-push", "dyn", "bfs", (2,), {}, PUSH),
    ("dyn-sssp-push", "dyn", "sssp", (2,), {}, PUSH),
    ("stride-bfs-lanes", "stride", "bfs_multi", ((0, 7, 100, 500, 7),), {}, {}),
    ("stride-sssp-lanes", "stride", "sssp_multi", ((7, 3, 900),), {}, {}),
    ("hub-bfs-lanes-static", "hub", "bfs_multi", ((3, 0, 40),), {}, STATIC),
]


def graph(name, G, skewed_graph):
    """The named test graph, from either package's generators."""
    if name == "stride":
        return G.symmetrize(G.rmat(10, 8, seed=3))
    if name == "pr":
        return G.rmat(10, 8, seed=3)
    if name == "hub":
        return skewed_graph(n=512, kind="star", hub_in_degree=1500, avg_degree=2, seed=7)
    if name == "dyn":
        return G.symmetrize(G.rmat(10, 6, seed=11))
    if name == "grid":
        return G.grid_2d(80, 60)
    if name == "rmat8":
        return G.symmetrize(G.rmat(10, 8, seed=1))
    if name == "gnn":
        return G.symmetrize(G.rmat(9, 6, seed=1))
    if name == "gat":
        return G.symmetrize(G.rmat(8, 6, seed=3))
    raise KeyError(name)


def engine_and_gnn(rank, group, gat_params, gat_feat, gat_labels, agg_feat):
    """Every ENGINE_CASES run through ``run_distributed``, then the GNN
    feature aggregation and the GAT loss and gradients (f32 wires and bf16
    wires)."""
    import repro_torch.core.graph as G
    from repro_torch.core import problems as P
    from repro_torch.core.distributed import build_distributed_run, run_distributed
    from repro_torch.core.engine import EngineOptions
    from repro_torch.core.partition import PartitionConfig, partition_2d
    from repro_torch.data.synthetic import skewed_graph
    from repro_torch.dist.gat_parallel import make_gat_graphscale_loss
    from repro_torch.dist.gnn_parallel import make_graphscale_aggregate, shard_features
    from repro_torch.models.gnn import archs

    out = {"engine": {}}
    parts = {}
    for case, gname, pname, args, pkw, okw in ENGINE_CASES:
        if gname not in parts:
            g = graph(gname, G, skewed_graph)
            parts[gname] = (g, partition_2d(g, PartitionConfig(**GRAPH_CONFIGS[gname])))
        g, pg = parts[gname]
        res = run_distributed(getattr(P, pname)(*args, **pkw), g, pg, group,
                              EngineOptions(**okw), device="cpu")
        out["engine"][case] = (res.labels, res.iterations, res.converged)
    g, pg = parts["stride"]
    run_fn = build_distributed_run(P.bfs(7), pg, group, EngineOptions(), device="cpu")
    out["const_keys"] = run_fn.const_keys

    # GNN feature aggregation over the phased crossbar
    g = graph("gnn", G, skewed_graph)
    pg = partition_2d(g, PartitionConfig(p=4, l=3, lane=4, stride=50))
    sharded = shard_features(agg_feat, pg, group, device="cpu")
    out["aggregate"] = make_graphscale_aggregate(pg, group, device="cpu")(sharded).numpy()

    # GAT loss and parameter gradients
    g = graph("gat", G, skewed_graph)
    pg = partition_2d(g, PartitionConfig(p=4, l=1, lane=4))
    q = rank
    cfg = archs.GNNConfig(name="gat", n_layers=2, d_hidden=4, n_heads=4)
    params = archs.params_from_reference(gat_params, cfg, device="cpu")
    leaves = [t.requires_grad_() for t in _leaves(params)]
    feat = shard_features(gat_feat, pg, group, device="cpu")
    lab = np.zeros(pg.padded_vertices, np.int32)
    lab[: g.num_vertices] = gat_labels
    mask = np.zeros(pg.padded_vertices, np.float32)
    mask[: g.num_vertices] = 1.0
    vpc = pg.vertices_per_core
    edges = [torch.from_numpy(np.ascontiguousarray(a[q : q + 1]))
             for a in (pg.src_gidx, pg.dst_lidx, pg.valid)]
    lab_t = torch.from_numpy(lab[q * vpc : (q + 1) * vpc])
    mask_t = torch.from_numpy(mask[q * vpc : (q + 1) * vpc])
    for name, wire in (("gat", None), ("gat_bf16", torch.bfloat16)):
        loss_fn = make_gat_graphscale_loss(group, vpc, 4, 4, wire_dtype=wire)
        loss = loss_fn(params, feat, *edges, lab_t, mask_t)
        grads = torch.autograd.grad(loss, leaves)
        out[name] = (float(loss), [gr.numpy() for gr in grads])
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def frontier_and_lookup(rank, group, lookups):
    """The frontier engine over 8 ranks (BFS on a grid and on RMAT), then the
    crossbar lookup over a 2 x 4 mesh of the same 8 ranks: rows and the
    table gradient of each form, and the dropped counts at a small
    capacity."""
    import torch.distributed as dist

    import repro_torch.core.graph as G
    from repro_torch.core import problems as P
    from repro_torch.core.frontier import run_distributed_frontier
    from repro_torch.core.partition import PartitionConfig, partition_2d
    from repro_torch.data.synthetic import skewed_graph
    from repro_torch.dist.embedding import (
        crossbar_lookup_local, make_crossbar_lookup, make_exchange,
    )

    out = {"frontier": {}}
    for gname, cfg, root in (("grid", dict(p=8, l=2, lane=8, stride=100), 3),
                             ("rmat8", dict(p=8, l=2, lane=8), 5)):
        g = graph(gname, G, skewed_graph)
        pg = partition_2d(g, PartitionConfig(**cfg))
        res, stats = run_distributed_frontier(P.bfs(root), g, pg, group, budget=64, device="cpu")
        out["frontier"][gname] = (res.labels, res.iterations, stats)

    # a 2 x 4 mesh ("data", "model"): rank = data * 4 + model
    d_idx, m_idx = divmod(rank, 4)
    model = data = None
    for d in range(2):  # every rank takes part in creating every group
        grp = dist.new_group([d * 4 + m for m in range(4)])
        if d == d_idx:
            model = grp
    for m in range(4):
        grp = dist.new_group([m, m + 4])
        if m == m_idx:
            data = grp
    for form, groups, shard in (("model", model, m_idx), ("full", (data, model), rank)):
        table, ids, cap = lookups[form]
        n_shards = 4 if form == "model" else 8
        rows = table.shape[0] // n_shards
        local = torch.from_numpy(table[shard * rows : (shard + 1) * rows].copy()).requires_grad_()
        per = ids.shape[0] // 8
        my_ids = torch.from_numpy(ids[rank * per : (rank + 1) * per])
        got = make_crossbar_lookup(groups, capacity_factor=4.0)(local, my_ids)
        (grad,) = torch.autograd.grad((got ** 2).sum(), local)
        exchange, _ = make_exchange(groups)
        small, dropped = crossbar_lookup_local(local.detach(), my_ids.reshape(-1), exchange,
                                               n_shards, cap)
        out[form] = (got.detach().numpy(), grad.numpy(), small.numpy(), int(dropped))
    return out


def fail_on_rank_one(rank, group):
    if rank == 1:
        raise ValueError("rank one fails")
    import torch.distributed as dist

    dist.barrier(group)  # rank 0 would wait here forever
    return rank


def _data_mesh(group):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    torch.set_num_threads(1)  # up to 8 ranks share the CPU; the models are tiny
    return DeviceMesh("cpu", list(range(dist.get_world_size(group))), mesh_dim_names=("data",))


def elastic_restore(rank, group, ckpt_dir):
    """test_fault_tolerance.py's elastic case: the (8, 8) leaf restored onto
    this world's 1-D mesh, rows sharded over it."""
    from torch.distributed.tensor import DTensor

    from repro_torch.dist.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.dist.sharding import P, placements

    mesh = _data_mesh(group)
    like = {"w": torch.zeros((8, 8), dtype=torch.float32)}
    place = placements(P("data", None), mesh)
    got, meta = restore_checkpoint(ckpt_dir, like, shardings={"w": (mesh, place)})
    w = got["w"]
    resaved = save_checkpoint(ckpt_dir + "/resaved", 1, got, meta=meta)
    return dict(is_dtensor=isinstance(w, DTensor), placements=repr(w.placements),
                local=w.to_local().numpy(), full=w.full_tensor().numpy(), meta=meta,
                resaved=resaved)


def elastic_lm(rank, group, ckpt_dir, steps, tree, cfg_kw, ocfg_kw, sync):
    """tests/test_elastic.py's data-parallel LM run, one row of the global
    batch (= world size) a rank: restore the newest checkpoint under
    ``ckpt_dir`` onto this world (replicated leaves) or start from the
    reference's weights ``tree``, train ``steps`` steps with the gradients
    averaged over the group (``sync`` "mean": an all-reduce; "int8": int8
    error feedback), save from rank 0. Returns the global loss, the step
    and the final parameters."""
    import torch.distributed as dist

    from repro_torch.core.distributed import _all_reduce_sum
    from repro_torch.data.pipeline import ShardedLoader
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.dist.checkpoint import latest_step, restore_checkpoint, save_checkpoint
    from repro_torch.dist.compression import make_error_feedback
    from repro_torch.dist.sharding import P, placements
    from repro_torch.models import transformer as tfm
    from repro_torch.train.optim import AdamWConfig, tree_flatten, tree_map
    from repro_torch.train.steps import init_train_state, make_lm_train_step

    world = dist.get_world_size(group)
    mesh = _data_mesh(group)
    cfg = tfm.LMConfig(**cfg_kw, dtype=torch.float32)
    ocfg = AdamWConfig(**ocfg_kw)
    state = init_train_state(tfm.params_from_reference(tree, cfg, "cpu"), ocfg)
    start = 0
    if latest_step(ckpt_dir) is not None:
        replicated = tree_map(lambda _: (mesh, placements(P(), mesh)), state)
        state, meta = restore_checkpoint(ckpt_dir, state, shardings=replicated)
        state = tree_map(lambda t: t.to_local(), state)
        start = meta["next_step"]
    if sync == "int8":
        ef_init, ef_apply = make_error_feedback("int8")
        ef = [ef_init(state["params"])]

        def transform(grads):
            synced, ef[0] = ef_apply(grads, ef[0], group)
            return synced
    else:
        def transform(grads):
            return tree_map(lambda g: _all_reduce_sum(g, group) / world, grads)

    rows = (mesh, placements(P("data", None), mesh))
    loader = ShardedLoader(
        lambda seed, i: lm_batch(seed=seed, step=i, batch=world, seq=32, vocab=cfg.vocab),
        seed=0, shardings={"tokens": rows, "labels": rows}, start_step=start, device="cpu")
    step = make_lm_train_step(cfg, ocfg, grad_transform=transform)
    for _ in range(steps):
        batch = {k: v.to_local() for k, v in next(loader).items()}
        state, m = step(state, batch)
    loss = float(_all_reduce_sum(m["loss"], group)) / world
    end = loader.state()["next_step"]
    if rank == 0:
        save_checkpoint(ckpt_dir, end, state, meta={"next_step": end})
    dist.barrier(group)
    return dict(loss=loss, step=end,
                params=[t.numpy() for t in tree_flatten(state["params"])[0]])


def compression_sync(rank, group, grads, rounds):
    """``compressed_psum`` (int8, top-k) of this rank's first gradient, and
    ``rounds`` rounds of int8 and top-k error feedback over this rank's
    gradient trees (one a round)."""
    from repro_torch.dist.compression import compressed_psum, make_error_feedback

    torch.set_num_threads(1)
    mine = [{k: torch.from_numpy(v) for k, v in g.items()} for g in grads[rank]]
    out = {mode: compressed_psum(mine[0]["a"], group, mode).numpy() for mode in ("int8", "topk")}
    for mode in ("int8", "topk"):
        init, apply = make_error_feedback(mode, frac=0.25)
        ef = init(mine[0])
        synced = []
        for r in range(rounds):
            s, ef = apply(mine[r], ef, group)
            synced.append({k: v.numpy() for k, v in s.items()})
        out["ef/" + mode] = (synced, {k: v.numpy() for k, v in ef.items()})
    return out


# recommend-for at 4 table shards (tests/test_torch_distributed.py): case ->
# (graph, item_vocab, history length, roots). "spread": interior grid
# vertices (4 in-neighbours, no padding) and a pool spread over the shards,
# so no queue overflows; "skewed": RMAT hubs crowd one shard's queue;
# "uneven": item_vocab % 4 != 0, one shard
REC_CASES = {
    "spread": ("grid", 8, 4, (100, 200, 300)),
    "skewed": ("hub", 500, 12, (0, 3, 9, 40)),
    "uneven": ("stride", 501, 12, (0, 7, 100)),
}


def recommend_sharded(rank, group, params_by_case):
    """recommend-for through the router's table-sharded crossbar lookup on
    every rank: per case the answers, the scorer's shard count and the ids
    each query's two lookups dropped (summed over the ranks)."""
    import dataclasses

    import repro_torch.core.graph as G
    from repro_torch.configs.registry import get
    from repro_torch.core.partition import PartitionConfig, partition_2d
    from repro_torch.data.synthetic import skewed_graph
    from repro_torch.models.recsys import din
    from repro_torch.serve import RecommendScorer

    torch.set_num_threads(1)
    out = {}
    for case, (gname, vocab, seq, roots) in REC_CASES.items():
        g = graph(gname, G, skewed_graph)
        pg = partition_2d(g, PartitionConfig(p=2, l=2))
        cfg = dataclasses.replace(get("din").smoke(), item_vocab=vocab, seq_len=seq)
        s = RecommendScorer(cfg, pool_size=64, topk=8, device="cpu",
                            params=din.params_from_reference(params_by_case[case], "cpu"))
        s.refresh_pool(g)
        answers, drops = [], []
        for r in roots:
            before = len(s.dropped)
            answers.append(s.recommend_for(pg, r))
            drops.append(sum(s.dropped[before:]))
        out[case] = (answers, drops, s.table_shards)
    return out


def vocab_parallel_xent(rank, group, cases):
    """``losses.softmax_xent`` (or, given a row mask, ``masked_softmax_xent``)
    of DTensor logits on a (2, 2) CPU mesh under
    ``launch.sharded.ShardedForms`` (the vocab-parallel form), the padded
    vocab masked first as the LM loss does: per case (logits, labels,
    vocab_real, the logits' split dim on each mesh dim, mask or None) the
    loss, the logits' whole gradient and the loss's placements."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.sharded import ShardedForms
    from repro_torch.train.losses import masked_softmax_xent, softmax_xent
    from repro_torch.train.steps import mask_vocab_padding

    torch.set_num_threads(1)
    mesh = DeviceMesh("cpu", [[0, 1], [2, 3]], mesh_dim_names=("data", "model"))
    out = {}
    for name, (logits, labels, vocab_real, dims, mask) in cases.items():
        place = [Shard(d) if d is not None else Replicate() for d in dims]
        rows = [p if isinstance(p, Shard) and p.dim < logits.ndim - 1 else Replicate()
                for p in place]
        lg = distribute_tensor(torch.from_numpy(logits), mesh, place).requires_grad_(True)
        lab = distribute_tensor(torch.from_numpy(labels), mesh, rows)
        with implicit_replication():  # the mask is a plain tensor, as in a dry run
            with ShardedForms():
                masked = mask_vocab_padding(lg, vocab_real)
                loss = (softmax_xent(masked, lab) if mask is None else masked_softmax_xent(
                    masked, lab, distribute_tensor(torch.from_numpy(mask), mesh, rows)))
            loss.backward()
        out[name] = (float(loss.full_tensor()), lg.grad.full_tensor().numpy(),
                     [type(p).__name__ for p in loss.placements])
    return out


def moe_dispatch_grads(rank, group, args, cfg_kw, capacity, groups, cotangent):
    """``moe_ffn_grouped`` (``groups`` > 1) or ``moe_ffn`` on DTensors of a
    (2, 2) CPU mesh under ``ShardedForms`` (``launch.sharded.moe_dispatch``),
    placed as a dry run places them: tokens over ``data`` (replicated over
    ``model``, as the sequence gather leaves them), the router's columns and
    the experts over ``model``, the experts' d_model over ``data``. The
    output, the aux loss and the gradients of ``sum(out * cotangent) + aux``
    with respect to every input, whole."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.sharded import ShardedForms
    from repro_torch.models import layers

    torch.set_num_threads(1)
    mesh = DeviceMesh("cpu", [[0, 1], [2, 3]], mesh_dim_names=("data", "model"))
    place = [[Shard(0) if groups > 1 else Replicate(), Replicate()],  # x (T, d)
             [Replicate(), Shard(1)],  # router (d, E)
             [Shard(1), Shard(0)], [Shard(1), Shard(0)],  # w1, w3 (E, d, f)
             [Shard(2), Shard(0)]]  # w2 (E, f, d)
    ins = [distribute_tensor(torch.from_numpy(a), mesh, p).requires_grad_(True)
           for a, p in zip(args, place)]
    cfg = layers.MoEConfig(**cfg_kw)
    with ShardedForms():
        if groups > 1:
            out, aux = layers.moe_ffn_grouped(*ins, cfg, capacity, groups,
                                              expert_sharding=(mesh, [Shard(0), Shard(1)]))
        else:
            out, aux = layers.moe_ffn(*ins, cfg, capacity,
                                      expert_sharding=(mesh, [Replicate(), Shard(0)]))
    ct = distribute_tensor(torch.from_numpy(cotangent), mesh, [Replicate(), Replicate()])
    ((out * ct).sum() + aux).backward()
    return dict(out=out.full_tensor().detach().numpy(), aux=float(aux.full_tensor()),
                grads=[t.grad.full_tensor().numpy() for t in ins])


def row_take_and_segment_sum(rank, group, cases):
    """Per case (table, ids, values, dst, num_rows): ``table[ids]`` and
    ``zeros(num_rows).index_add(0, dst, values)`` under ``ShardedForms`` on
    a (2, 2) CPU mesh, every operand's rows split over both axes (a graph's
    nodes and edges): the take's output and its table gradient (of
    ``sum(out * out)``), the segment sum and its values gradient (of the
    same), whole."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.sharded import ShardedForms

    torch.set_num_threads(1)
    mesh = DeviceMesh("cpu", [[0, 1], [2, 3]], mesh_dim_names=("data", "model"))
    rows = [Shard(0), Shard(0)]
    out = []
    for table, ids, values, dst, num_rows in cases:
        tab = distribute_tensor(torch.from_numpy(table), mesh, rows).requires_grad_(True)
        val = distribute_tensor(torch.from_numpy(values), mesh, rows).requires_grad_(True)
        idx = distribute_tensor(torch.from_numpy(ids), mesh, rows)
        dsts = distribute_tensor(torch.from_numpy(dst), mesh, rows)
        with implicit_replication():  # the plain zeros, as in a dry run
            with ShardedForms():
                took = tab[idx]
                summed = torch.zeros((num_rows, values.shape[1])).index_add(0, dsts, val)
            ((took * took).sum() + (summed * summed).sum()).backward()
        out.append(dict(took=took.full_tensor().detach().numpy(),
                        tab_grad=tab.grad.full_tensor().numpy(),
                        summed=summed.full_tensor().detach().numpy(),
                        val_grad=val.grad.full_tensor().numpy(),
                        placements=[repr(took.placements), repr(summed.placements)]))
    return out
