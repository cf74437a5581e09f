"""Elastic scaling of the port: a data-parallel LM job checkpointed at one
world size restores and CONTINUES TRAINING at another. Counterpart of
tests/test_elastic.py; the reference's forced host devices are spawned
gloo ranks here (``launch.mesh.spawn_ranks``, rank bodies in
``tests/_torch_ranks.py``), the mesh a 1-D ``DeviceMesh`` ("data",), each
rank one row of the global batch (= world size) through
``data.pipeline.ShardedLoader``'s shardings, the gradients averaged over the
group, the restore replicated through ``dist.checkpoint``'s shardings.

  * 4 -> 8 ranks: 3 steps at 4, 3 more at 8; the resumed loss is finite and
    every rank holds the same parameters;
  * 4 + 4 ranks: an interrupted 3 + 3 run equals an uninterrupted 6-step
    run at 4 ranks within 1e-6, and both are within test_torch_lm.py's
    tolerance of ``repro``'s uninterrupted 6 steps at batch 4 (one device,
    the reference's weights carried across);
  * 2 -> 4 ranks with int8 error feedback (``dist.compression``) before the
    save, as the smoke's ``recovery`` (d) runs it on the card: finite.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.data.synthetic import lm_batch as r_lm_batch
from repro.models import transformer as rtfm
from repro.train.optim import AdamWConfig as RAdamWConfig
from repro.train.steps import init_train_state as r_init_state
from repro.train.steps import make_lm_train_step as r_make_step

import _torch_ranks as ranks
from repro_torch.launch.mesh import spawn_ranks

SPAWN_TIMEOUT = 60
RTOL = 1e-5  # test_torch_lm.py's
# tests/test_elastic.py's model and optimizer
CFG = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64, vocab=128,
           attn_chunk=16)
OCFG = dict(lr=1e-3, total_steps=100)


@pytest.fixture(scope="module")
def tree():
    cfg = rtfm.LMConfig(**CFG, dtype=jnp.float32)
    return jax.tree.map(np.asarray, rtfm.init_params(jax.random.key(0), cfg))


def _run(world, ckpt, steps, tree, tmp_path, sync="mean"):
    outs = spawn_ranks(ranks.elastic_lm, world, (str(ckpt), steps, tree, CFG, OCFG, sync),
                       backend="gloo", timeout=SPAWN_TIMEOUT, init_dir=tmp_path)
    for o in outs[1:]:  # the same global loss and parameters on every rank
        assert o["loss"] == outs[0]["loss"] and o["step"] == outs[0]["step"]
        for a, b in zip(o["params"], outs[0]["params"]):
            np.testing.assert_array_equal(a, b)
    return outs[0]


def _close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(1e-6, np.abs(want).max()))


def test_elastic_4_to_8_ranks(tmp_path, tree):
    """Train 3 steps on 4 ranks, resume and train 3 more on 8: the global
    batch differs by world size, so the run must only be finite and
    progressed (as the reference asserts)."""
    r1 = _run(4, tmp_path / "elastic", 3, tree, tmp_path)
    assert r1["step"] == 3
    r2 = _run(8, tmp_path / "elastic", 3, tree, tmp_path)
    assert r2["step"] == 6 and np.isfinite(r2["loss"])


def test_elastic_same_mesh_exact(tmp_path, tree):
    """Same world size: interrupted (3 + 3) == uninterrupted (6) within 1e-6,
    and both within RTOL of the reference's 6 steps at batch 4."""
    _run(4, tmp_path / "int", 3, tree, tmp_path)
    r_int = _run(4, tmp_path / "int", 3, tree, tmp_path)
    r_unint = _run(4, tmp_path / "unint", 6, tree, tmp_path)
    assert r_int["step"] == r_unint["step"] == 6
    assert abs(r_int["loss"] - r_unint["loss"]) < 1e-6
    for a, b in zip(r_int["params"], r_unint["params"]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)

    cfg = rtfm.LMConfig(**CFG, dtype=jnp.float32)
    ocfg = RAdamWConfig(**OCFG)
    step = jax.jit(r_make_step(cfg, ocfg))
    state = r_init_state(jax.tree.map(jnp.asarray, tree), ocfg)
    for i in range(6):
        b = r_lm_batch(seed=0, step=i, batch=4, seq=32, vocab=cfg.vocab)
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
    _close(r_int["loss"], float(m["loss"]))
    for a, b in zip(r_int["params"], jax.tree.leaves(state["params"])):
        _close(a, np.asarray(b), rtol=1e-4)  # AdamW's update ~ lr * sign(g) where g ~ 0


def test_elastic_int8_error_feedback_2_to_4_ranks(tmp_path, tree):
    r1 = _run(2, tmp_path / "ef", 3, tree, tmp_path, sync="int8")
    r2 = _run(4, tmp_path / "ef", 3, tree, tmp_path, sync="int8")
    assert r1["step"] == 3 and r2["step"] == 6 and np.isfinite(r2["loss"])
