"""The port's launch tooling (``repro_torch.launch``: production meshes,
cells, the dry run, the roofline and report, the GAT hillclimb) against
``repro.launch``, on the CPU.

* ``build_cell`` for every arch x shape on a (1, 1) mesh against the
  reference's cell on its (1, 1) mesh (``tests/test_system.py:121-139``):
  the key, the input leaves' shapes and dtypes in ``jax.tree`` order, the
  in and out spec trees, ``donate_argnums`` and ``meta`` (``model_flops``
  equal as floats). Exact.
* ``collective_bytes`` against the reference's HLO parser per kind (the
  three lines of ``test_roofline_collective_parser``, a reduce-scatter and
  an all-to-all): within 1 byte, counts equal.
* ``roofline_report`` against the reference's with its ``HW`` set to the
  port's constants: every term equal (the same float arithmetic).
* ``segment_reduce_rows``: min bit-equal (float32 and uint32), sum within
  rtol 1e-5.
* The dry run (a subprocess: a fake world must not reach this worker): one
  small cell a family on a one-rank mesh, its fake trace's aten FLOPs equal
  to ``FlopCounterMode`` on the same step on real CPU tensors (exact); the
  same cells on a fake (2, 2) mesh trace ``ok``, each device's FLOPs
  between a quarter of the step's and all of it; ``_wsc`` redistributes a
  DTensor; the production meshes' shapes and axis rules; a real group of
  another size refused. On fake (2, 2) and (2, 2, 2) meshes a rank's FLOPs
  are exactly the one-rank trace's over the rank count, times the
  replication each record names (granite-moe's MoE dispatch, grouped and
  ungrouped, included).
* The hillclimb at p = 4 and 8 on a scale-10 R-MAT: its collective bytes
  equal the count from the layout (a subprocess).
"""
import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as R_ARCHS
from repro.launch import roofline as rroof

from repro_torch.configs.registry import ARCHS
from repro_torch.launch import roofline as troof
from repro_torch.launch.mesh import HW

ROOT = Path(__file__).resolve().parents[1]


def _env():
    return dict(os.environ, JAX_PLATFORMS="cpu",
                PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))


# ---------------------------------------------------------------------------
# cells


@pytest.fixture(scope="module")
def meshes():
    """The port's (1, 1) DeviceMesh on a fake world of one rank (destroyed
    after this module) and the reference's (1, 1) mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    import repro.dist  # noqa: F401 -- the jax shims of make_mesh(axis_types=...)

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        port = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        ref = jax.make_mesh((1, 1), ("data", "model"),
                            axis_types=(jax.sharding.AxisType.Auto,) * 2)
        yield port, ref
    finally:
        dist.destroy_process_group()


def _port_leaves(tree):
    """Tensor leaves in ``jax.tree`` order: a GraphBatch is its registered
    dataclass's data fields (``n_graphs`` is metadata, None no leaf); the
    decode step's Python position is a () int32 leaf."""
    from repro_torch.models.gnn.common import GraphBatch
    from repro_torch.train.optim import tree_flatten

    def expand(t):
        if type(t).__name__ == "P":  # a spec: a leaf
            return t
        if isinstance(t, GraphBatch):
            return [getattr(t, f.name) for f in dataclasses.fields(t) if f.name != "n_graphs"]
        if isinstance(t, dict):
            return {k: expand(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)) and not hasattr(t, "_fields"):
            return type(t)(expand(v) for v in t)
        if hasattr(t, "_fields"):
            return type(t)(*(expand(v) for v in t))
        return t

    from repro_torch.launch.cells import spec_leaves

    leaves = tree_flatten(expand(tree), is_leaf=lambda x: type(x).__name__ == "P")[0]
    return leaves, spec_leaves


def _shape_dtype(x):
    if isinstance(x, int):
        return (), "int32"
    return tuple(x.shape), str(x.dtype).replace("torch.", "")


def _spec(p):
    """A spec as a tuple without trailing Nones (PartitionSpec or P)."""
    t = tuple(tuple(a) if isinstance(a, tuple) and len(a) > 1 else
              (a[0] if isinstance(a, tuple) and len(a) == 1 else a) for a in p)
    while t and t[-1] is None:
        t = t[:-1]
    return t


@pytest.mark.parametrize("arch_id", list(ARCHS))
def test_build_cell_matches_reference(arch_id, meshes):
    from repro.launch.cells import build_cell as r_build
    from repro_torch.launch.cells import build_cell

    port_mesh, ref_mesh = meshes
    for shape in ARCHS[arch_id].shapes:
        c = build_cell(ARCHS[arch_id], shape.name, port_mesh)
        r = r_build(R_ARCHS[arch_id], shape.name, ref_mesh)
        assert c.key == r.key
        assert c.donate_argnums == r.donate_argnums
        assert c.meta == r.meta and c.meta["model_flops"] == r.meta["model_flops"]
        r_leaves = jax.tree.leaves(r.args)
        leaves, spec_leaves = _port_leaves(c.args)
        assert len(leaves) == len(r_leaves), c.key
        for got, want in zip(leaves, r_leaves):
            assert _shape_dtype(got) == (tuple(want.shape), str(want.dtype)), c.key
        specs = [s for tree in c.specs for s in _port_leaves(tree)[0]]
        assert [_spec(s) for s in specs] == [_spec(w.sharding.spec) for w in r_leaves], c.key
        outs = spec_leaves(c.out_specs)
        r_outs = jax.tree.leaves(r.out_shardings)
        assert [_spec(s) for s in outs] == [_spec(w.spec) for w in r_outs], c.key


# ---------------------------------------------------------------------------
# roofline


HLO = """
  %ag = f32[16,1024]{1,0} all-gather(f32[16,64]{1,0} %x), replica_groups=[16,16]<=[256], dimensions={1}
  %ar = bf16[8,128]{1,0} all-reduce(bf16[8,128]{1,0} %y), replica_groups={{0,1,2,3}}, to_apply=%sum
  %cp = f32[4]{0} collective-permute(f32[4]{0} %z), source_target_pairs={{0,1}}
  %rs = f32[4,128]{1,0} reduce-scatter(f32[16,128]{1,0} %w), replica_groups={{0,1,2,3}}, dimensions={0}
  %aa = bf16[8,64]{1,0} all-to-all(bf16[8,64]{1,0} %v), replica_groups=[32,8]<=[256], dimensions={0}
"""
# the same collectives as the dry run records them: (kind, output bytes, group)
RECORDS = [("all-gather", 16 * 1024 * 4, 16), ("all-reduce", 8 * 128 * 2, 4),
           ("collective-permute", 4 * 4, 2), ("reduce-scatter", 4 * 128 * 4, 4),
           ("all-to-all", 8 * 64 * 2, 8)]


def test_collective_bytes_matches_reference_parser():
    want = rroof.collective_bytes(HLO, 256)
    got = troof.collective_bytes(RECORDS)
    for kind in troof.COLLECTIVES:
        assert abs(got["bytes_by_kind"][kind] - want["bytes_by_kind"][kind]) < 1, kind
        assert got["count_by_kind"][kind] == want["count_by_kind"][kind] == 1
    assert abs(got["total_wire_bytes_per_device"] - want["total_wire_bytes_per_device"]) < 1
    assert troof.collective_bytes([("all-reduce", 64, 1)])["total_wire_bytes_per_device"] == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_roofline_report_matches_reference(dtype, monkeypatch):
    peak = troof.peak_flops(dtype)[1]
    monkeypatch.setattr(rroof.HW, "PEAK_FLOPS_BF16", peak)
    monkeypatch.setattr(rroof.HW, "HBM_BW", HW.HBM_BW)
    monkeypatch.setattr(rroof.HW, "ICI_BW", HW.IB_BW)
    cost = {"flops": 3.7e14, "bytes accessed": 2.2e12}
    mem = types.SimpleNamespace(argument_size_in_bytes=5e9, output_size_in_bytes=1e9,
                                temp_size_in_bytes=7e9, alias_size_in_bytes=1e9)
    for coll_bytes in (0.0, 1e9, 1e12):
        coll = {"total_wire_bytes_per_device": coll_bytes}
        want = rroof.roofline_report("a/b", "single", 256, cost, coll, 9.1e16, memory_stats=mem)
        got = troof.roofline_report("a/b", "single", 256, cost, coll, 9.1e16, dtype=dtype,
                                    memory_bytes=12e9)
        for f in ("flops_per_device", "bytes_per_device", "collective_bytes_per_device",
                  "compute_s", "memory_s", "collective_s", "dominant", "model_flops",
                  "hlo_flops_total", "useful_ratio", "memory_per_device_bytes"):
            assert getattr(got, f) == getattr(want, f), f
        assert got.peak_flops == peak
    assert troof.peak_flops(torch.float32)[1] == 67e12
    assert troof.peak_flops(torch.bfloat16)[1] == 989e12


# ---------------------------------------------------------------------------
# segment_reduce_rows


@pytest.mark.parametrize("kind", ["min", "sum"])
def test_segment_reduce_rows_matches_reference(kind):
    import jax.numpy as jnp

    from repro.kernels.csr_gather_reduce.ops import segment_reduce_rows as ref
    from repro_torch.kernels.csr_gather_reduce.ops import segment_reduce_rows

    rng = np.random.default_rng(3)
    contrib = rng.standard_normal((3, 500)).astype(np.float32)
    dst = np.sort(rng.integers(0, 90, (3, 500)), axis=1).astype(np.int32)
    dst[1, -7:] = 120  # rows past num_rows drop
    want = np.asarray(ref(jnp.asarray(contrib), jnp.asarray(dst), num_rows=100, kind=kind,
                          identity=0.0))
    got = segment_reduce_rows(torch.from_numpy(contrib), torch.from_numpy(dst), num_rows=100,
                              kind=kind, identity=0.0).numpy()
    if kind == "min":
        np.testing.assert_array_equal(got, want)  # empty rows +inf in both
        u = rng.integers(0, 2 ** 32, (2, 300), dtype=np.uint64).astype(np.uint32)
        want_u = np.asarray(ref(jnp.asarray(u), jnp.asarray(dst[:2, :300]), num_rows=100,
                                kind="min", identity=0))
        got_u = segment_reduce_rows(torch.from_numpy(u.view(np.int32)).view(torch.uint32),
                                    torch.from_numpy(dst[:2, :300]), num_rows=100, kind="min",
                                    identity=0)
        np.testing.assert_array_equal(got_u.view(torch.int32).numpy().view(np.uint32), want_u)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the dry run and the meshes, in a subprocess


_DRY = r'''
import dataclasses, json, sys
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs.base import ShapeCell
from repro_torch.configs.registry import get
from repro_torch.dist.sharding import rules_for_mesh
from repro_torch.launch.cells import build_cell
from repro_torch.launch.dryrun import check_on_card, trace_cell

# one small cell a family: the smoke models at small shapes
CELLS = {
    "lm": (dataclasses.replace(get("smollm-135m"), model=get("smollm-135m").smoke(),
                               shapes=(ShapeCell("tiny", "decode", dict(seq=64, batch=4)),))),
    "gnn": (dataclasses.replace(get("gin-tu"), model=get("gin-tu").smoke(), shapes=(
        ShapeCell("tiny", "gnn_molecule", dict(n_graphs=8, nodes_per=8, edges_per=16,
                                               d_feat=16, n_classes=2)),))),
    "din": (dataclasses.replace(get("din"), model=dataclasses.replace(
        get("din").smoke(), lookup="crossbar"), shapes=(ShapeCell("tiny", "serve",
                                                                  dict(batch=8)),))),
}
out = {}
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
for fam, arch in CELLS.items():
    r = check_on_card(arch, "tiny", seed=0, device="cpu", reps=1)
    out[fam] = dict(fake=r["fake_aten_flops"], real=r["card_aten_flops"])
dist.destroy_process_group()

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
for fam, arch in CELLS.items():
    got = trace_cell(build_cell(arch, "tiny", mesh))
    out[fam]["mesh22"] = got["flops"]
    out[fam]["mesh22_aten"] = got["aten_flops"]
# _wsc: a DTensor redistributed to the pair's placements
from repro_torch.models.transformer import _wsc
from torch._subclasses.fake_tensor import FakeTensorMode
with FakeTensorMode():
    x = DTensor.from_local(torch.empty(2, 8), mesh, (Shard(0), Replicate()), run_check=False,
                           shape=(4, 8), stride=(8, 1))
    y = _wsc(x, (mesh, (Replicate(), Shard(1))))
    out["wsc"] = [type(p).__name__ + str(getattr(p, "dim", "")) for p in y.placements] \
        + [list(y.shape), list(y.to_local().shape)]
    out["wsc_plain"] = _wsc(torch.empty(3), (mesh, (Replicate(), Shard(0)))).shape == (3,)
dist.destroy_process_group()

from repro_torch.launch.mesh import make_graph_mesh, make_production_mesh
m = make_production_mesh()
out["single"] = [list(m.mesh_dim_names), list(m.shape), str(rules_for_mesh(m))]
m = make_production_mesh(multi_pod=True)
out["multi"] = [list(m.mesh_dim_names), list(m.shape), str(rules_for_mesh(m))]
dist.destroy_process_group()
dist.init_process_group("gloo", init_method="file://" + sys.argv[1], rank=0, world_size=1)
try:
    make_production_mesh()
    out["refused"] = False
except RuntimeError:
    out["refused"] = True
g = make_graph_mesh(1, axis="table")
out["graph_mesh"] = [list(g.mesh_dim_names), list(g.shape)]
dist.destroy_process_group()
print("RESULT " + json.dumps(out))
'''


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    store = tmp_path_factory.mktemp("dry") / "store"
    res = subprocess.run([sys.executable, "-c", _DRY, str(store)], capture_output=True,
                         text=True, env=_env(), cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-6000:]
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("family", ["lm", "gnn", "din"])
def test_dry_run_flops_equal_flop_counter_on_cpu_tensors(family, dry):
    r = dry[family]
    assert r["fake"] == r["real"] > 0
    # on the fake (2, 2) mesh each device does exactly a quarter of the step's
    # aten work: every dim the specs split divides by 2
    assert r["mesh22_aten"] * 4 == r["real"]


_SPLIT = r'''
import dataclasses, json, sys
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs.base import ShapeCell
from repro_torch.configs.registry import get
from repro_torch.launch.cells import build_cell
from repro_torch.launch.dryrun import trace_cell


def cell(arch_id, kind, model=None, **dims):
    a = get(arch_id)
    return dataclasses.replace(a, model=model or a.smoke(), shapes=(ShapeCell("t", kind, dims),))


lm = dataclasses.replace(get("smollm-135m").smoke(), n_layers=1)
heads = dataclasses.replace(lm, n_heads=4, n_kv_heads=1)  # K/V heads fewer than the ranks
# 8 experts over a 2-wide model axis; a padded vocab that splits; 512 tokens,
# so that each group's capacity is the one group's over the group count
moe = dataclasses.replace(get("granite-moe-1b-a400m").smoke(), n_layers=1, vocab=256,
                          vocab_real=250)
din = dataclasses.replace(get("din").smoke(), lookup="crossbar")
CELLS = {
    "lm": {"train": cell("smollm-135m", "train", heads, seq=32, batch=8),
           "prefill": cell("smollm-135m", "prefill", heads, seq=32, batch=8),
           "decode": cell("smollm-135m", "decode", heads, seq=32, batch=8),
           "train_3_heads": cell("smollm-135m", "train", lm, seq=32, batch=8)},
    "lm_moe": {"moe_train": cell("granite-moe-1b-a400m", "train", moe, seq=64, batch=8),
               "moe_prefill": cell("granite-moe-1b-a400m", "prefill", moe, seq=64, batch=8),
               "moe_decode": cell("granite-moe-1b-a400m", "decode", moe, seq=32, batch=3)},
    "gnn": {"gat_full": cell("gat-cora", "gnn_full", n_nodes=256, n_edges=1024, d_feat=32,
                             n_classes=7),
            "gin_minibatch": cell("gin-tu", "gnn_minibatch", batch_nodes=32, fanout1=3,
                                  fanout2=2, n_nodes=256, n_edges=1024, d_feat=32, n_classes=7),
            "gat_molecule": cell("gat-cora", "gnn_molecule", n_graphs=8, nodes_per=8,
                                 edges_per=16, d_feat=16, n_classes=2)},
    "din": {"train": cell("din", "serve_train", din, batch=1024),
            "serve": cell("din", "serve", din, batch=64),
            "retrieval": cell("din", "retrieval", din, batch=1, n_candidates=1024)},
}[sys.argv[1]]
out = {name: {} for name in CELLS}
for shape, names in (((1, 1), ("data", "model")), ((2, 2), ("data", "model")),
                     ((2, 2, 2), ("pod", "data", "model"))):
    n = 1
    for v in shape:
        n *= v
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    for name, arch in CELLS.items():
        got = trace_cell(build_cell(arch, "t", mesh))
        out[name][n] = dict(aten=got["aten_flops"], kernel=got["kernel_flops"],
                            calls=got["kernel_calls"], replicated=got["replicated"],
                            replicated_flops=got["replicated_flops"])
    dist.destroy_process_group()
print("RESULT " + json.dumps(out))
'''

# the kernels whose work each cell's DTensor forms leave on every rank of a
# mesh dim, as ``launch.sharded.Replicated`` records them: GAT's softmax runs
# on the gathered edges (its layout is the whole batch's), the retrieval bag
# is one user's, 3 heads do not split over a 2-wide model axis, and a decode
# batch of 3 splits over no data axis: its MoE dispatch is ungrouped (the
# experts split over the model axis) and its attention splits as the cache
# does, over the model axis only
REPLICATED = {
    ("lm", "train_3_heads"): {4: {"flash_attention": 2}, 8: {"flash_attention": 2}},
    ("lm", "moe_decode"): {4: {"moe_experts": 2, "decode_attention": 2},
                           8: {"moe_experts": 4, "decode_attention": 4}},
    ("gnn", "gat_full"): {4: {"segment_softmax": 4}, 8: {"segment_softmax": 8}},
    ("gnn", "gat_molecule"): {4: {"segment_softmax": 4}, 8: {"segment_softmax": 8}},
    ("din", "retrieval"): {4: {"embedding_bag": 4}, 8: {"embedding_bag": 8}},
}


@pytest.mark.parametrize("family", ["lm", "gnn", "din"])
def test_dry_run_splits_work_as_the_specs_imply(family):
    """On fake (2, 2) and (2, 2, 2) meshes, a rank's aten FLOPs are exactly
    the one-rank trace's over the rank count (every split divides evenly, so
    no tolerance), and its kernels' FLOPs too, times the ranks that the
    recorded replication says do the same work: the aten FLOPs a replicating
    form ran (``replicated_flops``) count once a group of that many ranks.
    The grouped MoE dispatch (train, prefill) splits exactly; an ungrouped
    one (decode) repeats over the data axes."""
    # the LM family's MoE cells in a second process beside the first
    procs = [subprocess.Popen([sys.executable, "-c", _SPLIT, part], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=_env(), cwd=ROOT)
             for part in ([family, "lm_moe"] if family == "lm" else [family])]
    got = {}
    for proc in procs:
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, out[-3000:] + err[-6000:]
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")][-1]
        got.update(json.loads(line[len("RESULT "):]))
    for name, by_n in got.items():
        one = by_n["1"]
        assert one["aten"] > 0 and one["replicated"] == {}, name
        for n in (4, 8):
            r = by_n[str(n)]
            want = REPLICATED.get((family, name), {}).get(n, {})
            assert r["replicated"] == want, (name, n)
            factor = max(want.values(), default=1)
            if "flash_attention" in want:  # its backward (aten) is replicated as well
                assert one["aten"] < r["aten"] * n < one["aten"] * factor, (name, n)
            else:
                rep = r["replicated_flops"]
                assert set(rep) <= set(want) and all(v * n % want[k] == 0
                                                     for k, v in rep.items()), (name, n)
                split = r["aten"] - sum(rep.values())
                assert split * n + sum(v * n // want[k] for k, v in rep.items()) \
                    == one["aten"], (name, n)
                assert ("moe_experts" in rep) == (name == "moe_decode"), (name, n)
            assert r["kernel"] * n == one["kernel"] * factor, (name, n)
            assert r["calls"] == one["calls"], (name, n)


def test_wsc_redistributes_dtensors_and_production_meshes(dry):
    assert dry["wsc"] == ["Replicate", "Shard1", [4, 8], [4, 4]]
    assert dry["wsc_plain"]
    assert dry["single"][:2] == [["data", "model"], [16, 16]]
    assert dry["multi"][:2] == [["pod", "data", "model"], [2, 16, 16]]
    assert "fsdp=('pod', 'data'), tp='model'" in dry["multi"][2]
    assert "fsdp='data', tp='model'" in dry["single"][2]
    assert dry["refused"] and dry["graph_mesh"] == [["table"], [1]]


def test_hillclimb_collective_bytes_equal_the_layout_count(tmp_path):
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.hillclimb_gat", "--scale",
                          "10", "--p", "4,8", "--device", "cpu", "--out", str(tmp_path)],
                         capture_output=True, text=True, env=_env(), cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    recs = [json.loads(p.read_text()) for p in sorted(tmp_path.glob("*.json"))]
    assert len(recs) == 4
    for r in recs:
        assert r["collectives_match_layout"], r["key"]
        want = r["expected_collectives"]
        assert r["collectives"]["total_wire_bytes_per_device"] == \
            want["total_wire_bytes_per_device"] > 0
        assert r["collectives"]["count_by_kind"] == {**want["count_by_kind"]}
        assert r["kernel_calls"] == {"segment_softmax": 2}


def test_report_renders_records(tmp_path):
    from repro_torch.launch import report

    ok = dict(key="din/serve_p99", mesh="single", chips=256, status="ok", dominant="memory",
              peak="float32 outside the tensor cores", compute_s=1e-5, memory_s=2e-4,
              collective_s=1e-6, model_flops=1.5e9, hlo_flops_total=4e11, useful_ratio=0.004,
              flops_per_device=1.6e9, bytes_per_device=5e8, collective_bytes_per_device=3e4,
              memory=dict(peak_bytes=9e7, by_kind=dict(parameters=6e7, activations=3e7),
                          largest=[dict(op="_c10d_functional.all_gather_into_tensor.default",
                                        shape=[4, 1024], dtype="float32",
                                        bytes=2 ** 29)]),
              extras=dict(trace_s=0.7),
              collectives=dict(count_by_kind={"all-to-all": 4, "all-gather": 0}))
    bad = dict(key="qwen3-moe-30b-a3b/train_4k", mesh="single", chips=256, status="FAIL",
               op="aten.index_add_.default", error="AssertionError: x")
    for i, r in enumerate((ok, bad)):
        (tmp_path / f"{i}.json").write_text(json.dumps(r))
    recs = report.load(str(tmp_path))
    table = report.dryrun_table(recs)
    assert "| din/serve_p99 | single | 256 | 0.7 | 0.08 | Y |" in table
    assert "all-to-all:4" in table and "FAIL at `aten.index_add_.default`" in table
    assert table.splitlines()[2].endswith(
        "| all-to-all:4 | none | params 67%, act 33%; 0.50 GiB `all_gather_into_tensor` "
        "4x1024 float32 |")
    roof = report.roofline_table(recs, "single")
    assert "**memory**" in roof and "qwen3-moe" not in roof



def test_kernel_output_rules_on_fake_cpu_tensors():
    """On fake tensors every kernel entry point takes its output rule (a CPU
    dry run counts the kernels, not their plain versions): the plain
    version's shape and dtype on the same inputs, no launch counted, and the
    kernel's own work reported."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    import repro_torch.core.graph as TG
    from repro_torch.core.partition import PartitionConfig as TConfig
    from repro_torch.core.partition import partition_2d as t_partition
    from repro_torch.kernels.csr_gather_reduce import bucket as B
    from repro_torch.kernels.csr_gather_reduce import kernel as K
    from repro_torch.kernels.csr_gather_reduce import scatter as S
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.fake import KernelWork, is_fake
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.segment_softmax import kernel as SK

    rng = np.random.default_rng(31)
    pg = t_partition(TG.symmetrize(TG.rmat(9, 8, seed=5)),
                     TConfig(p=2, l=2, tile_vb=64, build_push=True))
    pay = torch.from_numpy((rng.random(pg.gathered_size) / 7).astype(np.float32))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    shape = (3, 4, 32)
    src, dstb = t(rng.integers(0, 100, shape).astype(np.int32)), \
        t(rng.integers(0, 16, shape).astype(np.int32))
    valid = t(rng.random(shape) < 0.7)
    cases = [
        ("gather_reduce_cores", K.gather_reduce_cores,
         (pay, t(pg.tile_word[:, 0]), t(pg.tile_counts[:, 0])),
         dict(num_rows=pg.packed_rows_per_core, vb=pg.tile_vb, src_bits=pg.src_bits,
              kind="sum")),
        ("scatter_reduce_cores", S.scatter_reduce_cores,
         (pay, t(pg.push_word[:, 0]), t(pg.push_counts[:, 0])),
         dict(num_rows=pg.vertices_per_core, src_bits=pg.push_src_bits, kind="min",
              identity=3.4e38)),
        ("gather_reduce", B.gather_reduce_bucket, (pay[:100], src, dstb, valid),
         dict(num_rows=48, vb=16, kind="sum")),
        ("embedding_bag", embedding_bag, (t(rng.random((50, 18)).astype(np.float32)),
                                          t(rng.integers(-1, 50, (6, 9)).astype(np.int32))), {}),
        ("segment_softmax", SK.segment_softmax_tiles,
         (t(rng.standard_normal((2,) + shape).astype(np.float32)), dstb, valid), dict(vb=16)),
        ("flash_attention", FK.flash_attention_tiles,
         (t(rng.standard_normal((2, 4, 40, 16)).astype(np.float32)),
          t(rng.standard_normal((2, 2, 40, 16)).astype(np.float32)),
          t(rng.standard_normal((2, 2, 40, 16)).astype(np.float32))),
         dict(block_q=32, block_k=32)),
    ]
    counters = (K.LAUNCHES, S.LAUNCHES, B.LAUNCHES, SK.LAUNCHES, FK.LAUNCHES)
    before = [dict(c) for c in counters]
    for name, fn, args, kw in cases:
        want = fn(*args, **kw)  # the plain version
        mode = FakeTensorMode()
        with mode, KernelWork() as work:
            got = fn(*[mode.from_tensor(a) for a in args], **kw)
        assert is_fake(got) and got.shape == want.shape and got.dtype == want.dtype, name
        assert work.calls == {name: 1} and work.flops > 0 and work.bytes > 0, name
    assert [dict(c) for c in counters] == before
