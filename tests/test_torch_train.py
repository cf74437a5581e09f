"""The port's trainer pieces against the JAX reference, on the CPU.

  * the four losses;
  * ``adamw_update`` over 3 steps with clipping active (params, moments and
    step), and ``warmup_cosine`` through warmup and decay;
  * ``make_gnn_train_step`` for 3 steps of GAT (node_class, attention
    vectors seeded non-zero), GIN (graph_class) and SchNet (node_reg) from
    the reference's weights: losses and params within rtol 1e-5, atol 1e-6;
  * ``python -m repro_torch.launch.train --arch gat-cora --steps 3 --device
    cpu`` runs and prints its final line, as do ``--arch smollm-135m`` and
    ``--arch granite-moe-1b-a400m`` with a finite loss, and ``--arch din``
    (3 steps, its final line); ``--ckpt`` saves and a rerun resumes.

Inputs come from numpy seeds.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.graph as RG
import repro.data.synthetic as RS
from repro.configs.registry import get as r_get
from repro.models.gnn import archs as rarchs
from repro.train import losses as rlosses
from repro.train import optim as roptim
from repro.train import steps as rsteps

import repro_torch.data.synthetic as TS
from repro_torch.configs.registry import get as t_get
from repro_torch.models.gnn import archs
from repro_torch.train import losses, optim, steps
from repro_torch.train.optim import tree_flatten

TOL = dict(rtol=1e-5, atol=1e-6)
ROOT = Path(__file__).resolve().parents[1]


def _t(a):
    return torch.tensor(np.asarray(a))


def test_losses_match_reference():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((13, 6)) * 3).astype(np.float32)
    labels = rng.integers(0, 6, 13).astype(np.int32)
    mask = (rng.random(13) < 0.6).astype(np.float32)
    pred = rng.standard_normal((13, 2)).astype(np.float32)
    target = rng.standard_normal((13, 2)).astype(np.float32)
    blog = (rng.standard_normal(17) * 4).astype(np.float32)
    blab = (rng.random(17) < 0.5).astype(np.float32)
    pairs = [
        (rlosses.softmax_xent(jnp.asarray(logits), jnp.asarray(labels)),
         losses.softmax_xent(_t(logits), _t(labels))),
        (rlosses.masked_softmax_xent(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask)),
         losses.masked_softmax_xent(_t(logits), _t(labels), _t(mask))),
        (rlosses.masked_softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                                     jnp.zeros(13)),
         losses.masked_softmax_xent(_t(logits), _t(labels), torch.zeros(13))),
        (rlosses.binary_xent(jnp.asarray(blog), jnp.asarray(blab)),
         losses.binary_xent(_t(blog), _t(blab))),
        (rlosses.mse(jnp.asarray(pred), jnp.asarray(target)), losses.mse(_t(pred), _t(target))),
    ]
    for want, got in pairs:
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _tree(rng):
    return {"b": [rng.standard_normal((3, 4)).astype(np.float32),
                  rng.standard_normal(5).astype(np.float32)],
            "a": {"z": rng.standard_normal((2, 2)).astype(np.float32),
                  "m": rng.standard_normal(()).astype(np.float32)}}


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


def _close(port_tree, ref_tree, **tol):
    want = [np.asarray(x) for x in jax.tree.leaves(ref_tree)]
    got = [x.detach().numpy() for x in tree_flatten(port_tree)[0]]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **(tol or TOL))


def test_adamw_three_steps_with_clipping_match_reference():
    rng = np.random.default_rng(1)
    params = _tree(rng)
    cfg_r = roptim.AdamWConfig(lr=1e-2, clip_norm=0.5, warmup_steps=2, total_steps=5)
    cfg_t = optim.AdamWConfig(lr=1e-2, clip_norm=0.5, warmup_steps=2, total_steps=5)
    rp, rs = jax.tree.map(jnp.asarray, params), roptim.init_adamw(params, cfg_r)
    tp, ts = _to_torch(params), optim.init_adamw(_to_torch(params), cfg_t)
    for step in range(3):
        grads = jax.tree.map(lambda a: (a * 0 + rng.standard_normal(a.shape) * 3)
                             .astype(np.float32), params)
        assert float(roptim.global_norm(grads)) > cfg_r.clip_norm  # clipping is active
        np.testing.assert_allclose(optim.global_norm(_to_torch(grads)).numpy(),
                                   np.asarray(roptim.global_norm(grads)), **TOL)
        rp, rs = roptim.adamw_update(rp, jax.tree.map(jnp.asarray, grads), rs, cfg_r)
        tp, ts = optim.adamw_update(tp, _to_torch(grads), ts, cfg_t)
        assert int(ts.step) == int(rs.step) == step + 1
        _close(tp, rp)
        _close(ts.mu, rs.mu)
        _close(ts.nu, rs.nu)


def test_warmup_cosine_matches_reference():
    for cfg in (dict(warmup_steps=20, total_steps=100), dict(warmup_steps=0, total_steps=7)):
        r = roptim.AdamWConfig(lr=1e-3, **cfg)
        t = optim.AdamWConfig(lr=1e-3, **cfg)
        for s in (0, 1, 5, 20, 21, 60, 99, 100, 150):
            np.testing.assert_allclose(
                optim.warmup_cosine(t, torch.tensor(s, dtype=torch.int32)).numpy(),
                np.asarray(roptim.warmup_cosine(r, jnp.asarray(s, jnp.int32))), rtol=1e-6)


def _case(name):
    """(arch_id, task, port batch, numpy labels) at smoke size."""
    if name == "gin":
        b, lab = TS.batched_molecules(1, n_graphs=6, nodes_per=8, edges_per=16, d_feat=10)
        return "gin-tu", "graph_class", b, lab % 3
    g = RG.symmetrize(RG.rmat(7, 4, seed=2))
    b, lab = TS.graph_batch_from_coo(g.src, g.dst, g.num_vertices, 10, seed=4, n_classes=3)
    if name == "gat":
        return "gat-cora", "node_class", b, lab
    y = np.random.default_rng(5).standard_normal((g.num_vertices, 3)).astype(np.float32)
    return "schnet", "node_reg", b, y


@pytest.mark.parametrize("name", ["gat", "gin", "schnet"])
def test_gnn_train_steps_match_reference(name):
    arch_id, task, b, lab = _case(name)
    cfg_r, cfg_t = r_get(arch_id).smoke(), t_get(arch_id).smoke()
    tree = jax.tree.map(np.asarray, rarchs.init(jax.random.key(0), cfg_r, 10, 3))
    if cfg_r.name == "gat":  # non-zero attention, or every softmax is uniform
        rng = np.random.default_rng(6)
        for k in ("l1_asrc", "l1_adst", "l2_asrc", "l2_adst"):
            tree[k] = (rng.standard_normal(tree[k].shape) * 0.5).astype(np.float32)
    ocfg = dict(lr=1e-3, total_steps=3, warmup_steps=2)
    r_step = jax.jit(rsteps.make_gnn_train_step(cfg_r, roptim.AdamWConfig(**ocfg), task=task))
    t_step = steps.make_gnn_train_step(cfg_t, optim.AdamWConfig(**ocfg), task=task)
    kw = {f.name: getattr(b, f.name) for f in dataclasses.fields(b)}
    rb = RS.GraphBatch(**{k: (jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v)
                          for k, v in kw.items()})
    rs = rsteps.init_train_state(jax.tree.map(jnp.asarray, tree), roptim.AdamWConfig(**ocfg))
    ts = steps.init_train_state(archs.params_from_reference(tree, cfg_t, "cpu"),
                                optim.AdamWConfig(**ocfg))
    r_losses, t_losses = [], []
    for _ in range(3):
        rs, rm = r_step(rs, rb, jnp.asarray(lab))
        ts, tm = t_step(ts, b, torch.from_numpy(lab))
        r_losses.append(float(rm["loss"]))
        t_losses.append(float(tm["loss"]))
    np.testing.assert_allclose(t_losses, r_losses, **TOL)
    assert t_losses[-1] != t_losses[0]
    _close(ts["params"], rs["params"])


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)


def test_train_cli_runs_gat_on_cpu():
    proc = _cli("--arch", "gat-cora", "--steps", "3", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    last = proc.stdout.strip().splitlines()[-1]
    assert last.startswith("final: loss ") and "'steps': 3" in last, last


@pytest.mark.parametrize("arch", ["smollm-135m", "granite-moe-1b-a400m"])
def test_train_cli_runs_lm_on_cpu(arch):
    proc = _cli("--arch", arch, "--steps", "3", "--batch", "4", "--seq", "32", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0].startswith("step     0  loss ")
    last = lines[-1]
    assert last.startswith("final: loss ") and "'steps': 3" in last, last
    first, final = (float(x) for x in last.split("final: loss ")[1].split(";")[0].split(" -> "))
    assert np.isfinite(first) and np.isfinite(final)


def test_train_cli_runs_din_on_cpu():
    proc = _cli("--arch", "din", "--steps", "3", "--batch", "16", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0].startswith("step     0  loss ")
    last = lines[-1]
    assert last.startswith("final: loss ") and "'steps': 3" in last, last
    first, final = (float(x) for x in last.split("final: loss ")[1].split(";")[0].split(" -> "))
    assert np.isfinite(first) and np.isfinite(final)


@pytest.mark.parametrize("args,says", [(("--arch", "gin-tu", "--ckpt", "x"), "--ckpt"),
                                       (("--arch", "din", "--ckpt", "x"), "--ckpt")])
def test_train_cli_names_what_waits(args, says, tmp_path):
    """``--ckpt`` no longer waits: the run saves under the directory (the
    ``x`` of ``args``, here under ``tmp_path``) and a rerun resumes there."""
    args = tuple(str(tmp_path / a) if a == "x" else a for a in args)
    proc = _cli(*args, "--steps", "1", "--ckpt-every", "1", "--device", "cpu")
    assert proc.returncode == 0 and says not in proc.stderr, proc.stderr
    assert (tmp_path / "x" / "step_00000001" / "manifest.json").exists()
    proc = _cli(*args, "--steps", "2", "--ckpt-every", "1", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    assert "resume: step 1 under" in proc.stdout and "'steps': 1" in proc.stdout
