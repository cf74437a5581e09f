"""The dry run's vocab-parallel cross-entropy and peak breakdown
(``repro_torch.launch.sharded``, ``launch.dryrun``), on the CPU.

* ``softmax_xent`` on DTensor logits in 4 gloo ranks (a (2, 2) mesh, rank
  bodies in ``tests/_torch_ranks.py``), the padded vocab masked as the LM
  loss masks it: the loss and the logits' gradient of the plain
  ``softmax_xent`` on the whole logits, within 1e-6. The LM's placement
  (rows over ``data``, vocab over ``model``) and the vocab over both axes;
  and ``masked_softmax_xent`` on a GNN's (N, classes) logits, rows over
  both axes.
* The MoE dispatch's form (``launch.sharded.moe_dispatch``) in the same 4
  ranks, grouped (a group a ``data`` rank, the experts over ``model``) and
  ungrouped: the output, the aux loss and every input's gradient of the
  plain ``moe_ffn_grouped`` / ``moe_ffn`` within 1e-5 (the experts'
  partial sums add in another order).
* A graph's row take (``table[ids]``) and segment sum (``index_add``) in
  the same 4 ranks, rows split over both axes: the values and gradients of
  plain indexing and ``index_add``, with more ids than rows (the rows
  gathered) and fewer (the ids gathered); each collective over both axes
  at once.
* A fake-mesh trace of a smoke LM (granite-moe's, padded vocab) train and
  prefill step on a (2, 2) mesh (a subprocess: the fake world must not
  reach this worker): no all-gather moves as many bytes as a rank's logit
  rows with the whole vocab, and the peak's breakdown by kind sums to the
  peak.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.launch.mesh import spawn_ranks
from repro_torch.train import losses
from repro_torch.train.steps import mask_vocab_padding

import _torch_ranks

ROOT = Path(__file__).resolve().parents[1]


def _plain(logits, labels, vocab_real, mask):
    lg = torch.from_numpy(logits).requires_grad_(True)
    masked = mask_vocab_padding(lg, vocab_real)
    lab = torch.from_numpy(labels)
    loss = (losses.softmax_xent(masked, lab) if mask is None
            else losses.masked_softmax_xent(masked, lab, torch.from_numpy(mask)))
    loss.backward()
    return float(loss.detach()), lg.grad.numpy()


def test_vocab_parallel_xent_matches_plain_on_four_ranks(tmp_path):
    rng = np.random.default_rng(11)
    b, s, v, vocab_real = 4, 6, 64, 60
    logits = (rng.standard_normal((b, s, v)) * 3).astype(np.float32)
    labels = rng.integers(0, vocab_real, (b, s)).astype(np.int32)
    labels[0, :4] = [0, 15, 16, vocab_real - 1]  # the first and last column of a shard
    nodes = (rng.standard_normal((24, 7)) * 3).astype(np.float32)  # a GNN's (N, classes)
    node_labels = rng.integers(0, 7, 24).astype(np.int32)
    node_mask = (rng.random(24) < 0.6).astype(np.float32)
    cases = {"lm": (logits, labels, vocab_real, (0, 2), None),  # rows over data, vocab model
             "vocab_2d": (logits, labels, vocab_real, (2, 2), None),
             "masked_rows": (nodes, node_labels, None, (0, 0), node_mask)}
    got = spawn_ranks(_torch_ranks.vocab_parallel_xent, 4, (cases,), backend="gloo",
                      timeout=120, init_dir=tmp_path)
    for name, (lg, lab, vr, _, mask) in cases.items():
        want_loss, want_grad = _plain(lg, lab, vr, mask)
        for rank in got:
            loss, grad, place = rank[name]
            assert abs(loss - want_loss) <= 1e-6 * max(1.0, abs(want_loss)), (name, loss)
            np.testing.assert_allclose(grad, want_grad, rtol=0, atol=1e-6)
            assert "Partial" in place or name == "vocab_2d", (name, place)
        if vr is not None:
            assert np.abs(want_grad[..., vr:]).max() == 0  # padded columns


def test_moe_dispatch_form_matches_plain_on_four_ranks(tmp_path):
    from repro_torch.models import layers

    rng = np.random.default_rng(4)
    t, d, e, f = 32, 8, 4, 6
    args = [rng.standard_normal(shape).astype(np.float32) * scale for shape, scale in (
        ((t, d), 1.0), ((d, e), 0.5), ((e, d, f), 0.3), ((e, d, f), 0.3), ((e, f, d), 0.3))]
    cotangent = rng.standard_normal((t, d)).astype(np.float32)
    cfg_kw = dict(num_experts=e, top_k=2, d_ff_expert=f)
    for groups, capacity in ((2, 12), (1, 16)):  # capacity drops some tokens
        got = spawn_ranks(_torch_ranks.moe_dispatch_grads, 4,
                          (args, cfg_kw, capacity, groups, cotangent), backend="gloo",
                          timeout=120, init_dir=tmp_path)
        ins = [torch.from_numpy(a).requires_grad_(True) for a in args]
        cfg = layers.MoEConfig(**cfg_kw)
        out, aux = (layers.moe_ffn_grouped(*ins, cfg, capacity, groups) if groups > 1
                    else layers.moe_ffn(*ins, cfg, capacity))
        ((out * torch.from_numpy(cotangent)).sum() + aux).backward()
        for r in got:
            np.testing.assert_allclose(r["out"], out.detach().numpy(), rtol=1e-5, atol=1e-6)
            assert abs(r["aux"] - float(aux.detach())) <= 1e-6
            for g, want in zip(r["grads"], ins):
                np.testing.assert_allclose(g, want.grad.numpy(), rtol=1e-5, atol=1e-5)


def test_graph_row_take_and_segment_sum_forms_match_plain_on_four_ranks(tmp_path):
    rng = np.random.default_rng(6)
    cases = []
    for n, e, h in ((16, 40, 3), (64, 16, 3)):  # rows gathered; ids gathered
        cases.append((rng.standard_normal((n, h)).astype(np.float32),
                      rng.integers(0, n, e).astype(np.int64),
                      rng.standard_normal((e, h)).astype(np.float32),
                      rng.integers(0, n, e).astype(np.int64), n))
    got = spawn_ranks(_torch_ranks.row_take_and_segment_sum, 4, (cases,), backend="gloo",
                      timeout=120, init_dir=tmp_path)
    for c, (table, ids, values, dst, n) in enumerate(cases):
        tab = torch.from_numpy(table).requires_grad_(True)
        val = torch.from_numpy(values).requires_grad_(True)
        took = tab[torch.from_numpy(ids)]
        summed = torch.zeros((n, table.shape[1])).index_add(0, torch.from_numpy(dst), val)
        ((took * took).sum() + (summed * summed).sum()).backward()
        for rank in got:
            r = rank[c]
            np.testing.assert_array_equal(r["took"], took.detach().numpy())
            np.testing.assert_allclose(r["tab_grad"], tab.grad.numpy(), rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(r["summed"], summed.detach().numpy(), rtol=1e-6,
                                       atol=1e-6)
            np.testing.assert_allclose(r["val_grad"], val.grad.numpy(), rtol=1e-6, atol=1e-6)
            assert r["placements"] == ["(Shard(dim=0), Shard(dim=0))"] * 2


_TRACE = r'''
import dataclasses, json
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs.base import ShapeCell
from repro_torch.configs.registry import get
from repro_torch.launch.cells import build_cell
from repro_torch.launch.dryrun import trace_cell

moe = dataclasses.replace(get("granite-moe-1b-a400m").smoke(), n_layers=1, vocab=256,
                          vocab_real=250)
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
out = {}
for kind in ("train", "prefill"):
    arch = dataclasses.replace(get("granite-moe-1b-a400m"), model=moe,
                               shapes=(ShapeCell("t", kind, dict(seq=64, batch=8)),))
    got = trace_cell(build_cell(arch, "t", mesh))
    out[kind] = dict(gathers=[c[1] for c in got["collectives"] if c[0] == "all-gather"],
                     peak=got["peak_bytes"], by_kind=got["peak_by_kind"],
                     largest=got["peak_largest"])
dist.destroy_process_group()
print("RESULT " + json.dumps(out))
'''


def test_traced_lm_step_gathers_no_vocab_and_its_peak_adds_up():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, "-c", _TRACE], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-6000:]
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    got = json.loads(line[len("RESULT "):])
    rows_whole_vocab = 4 * 64 * 256 * 4  # a rank's 4 x 64 rows of float32 logits
    for kind, r in got.items():
        assert r["gathers"] and max(r["gathers"]) < rows_whole_vocab / 2, kind
        # MemTracker's kinds at the peak are its total (each storage once,
        # in whole bytes on the CPU: nothing to round)
        assert sum(r["by_kind"].values()) == r["peak"] > 0, kind
        sizes = [t["bytes"] for t in r["largest"]]
        assert sizes == sorted(sizes, reverse=True) and sum(sizes) <= r["peak"], kind
        assert all(t["op"] != "?" for t in r["largest"]), kind
    assert set(got["train"]["by_kind"]) >= {"parameters", "optimizer_state", "inputs"}
