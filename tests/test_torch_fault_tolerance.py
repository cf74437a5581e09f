"""The port's checkpoints and recovery loop against the reference's, on the
CPU.

  * counterparts of the 10 cases of tests/test_fault_tolerance.py: round
    trip, GC, the checksum, no .tmp left, kill-and-resume exactness,
    retries, the straggler monitor, the elastic restore onto a 1-rank
    ``DeviceMesh`` (a spawned gloo rank), PageRank killed and resumed
    through the engine's ``make_iteration`` (labels bit-equal to the
    uninterrupted run's, within the PageRank tolerance of ``repro``'s:
    the two packages' kernels fix different sum orders, and ``repro``'s
    own Pallas and XLA backends differ in 76 of 256 labels' bits), and
    the compression unit;
  * files byte-identical across the packages (float32, int32, a 0-d step,
    a Python scalar, an ``AdamWState``, a bf16 leaf), each package
    restoring the other's bit for bit (the reference cannot restore bf16:
    ``jnp.asarray`` rejects numpy's ``|V2``; the port can);
  * a stale ``step_*.tmp`` of a killed writer is ignored, then overwritten;
  * a device fault is raised at once, never retried;
  * ``python -m repro_torch.launch.train --ckpt`` on ``--device cpu``
    SIGKILLed once step 20 is saved, then rerun: it resumes from the newest
    complete step past a planted ``.tmp`` and ends on the uninterrupted
    run's last loss, bit for bit.
"""
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.dist.checkpoint as RC
from repro.train.optim import AdamWState as RAdamWState

import _torch_ranks as ranks
from repro_torch.dist.checkpoint import (
    latest_step, list_steps, restore_checkpoint, save_checkpoint,
)
from repro_torch.dist.fault_tolerance import (
    CheckpointPolicy, StepMonitor, is_device_fault, run_with_recovery,
)
from repro_torch.kernels.build import KernelLaunchError
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.train.optim import AdamWState, tree_flatten

ROOT = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT = 60
PR_TOL = dict(rtol=2e-5, atol=1e-8)  # ROADMAP's sum-problem tolerance


def _toy_state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "w": torch.randn((8, 8), generator=g),
        "opt": {"mu": torch.zeros((8, 8)), "step": torch.tensor(0, dtype=torch.int32)},
    }


def test_checkpoint_roundtrip(tmp_path):
    state = _toy_state()
    save_checkpoint(str(tmp_path), 3, state, meta={"next_step": 3, "seed": 7})
    like = {"w": torch.zeros(8, 8), "opt": {"mu": torch.ones(8, 8),
                                            "step": torch.tensor(5, dtype=torch.int32)}}
    restored, meta = restore_checkpoint(str(tmp_path), like)
    for a, b in zip(tree_flatten(state)[0], tree_flatten(restored)[0]):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    assert meta["seed"] == 7


def test_checkpoint_gc_keeps_newest(tmp_path):
    state = _toy_state()
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(str(tmp_path), s, state, keep=2)
    assert list_steps(str(tmp_path)) == [4, 5]


def test_checkpoint_integrity_check(tmp_path):
    state = _toy_state()
    path = save_checkpoint(str(tmp_path), 1, state)
    victim = os.path.join(path, "leaf_00000.npy")
    arr = np.load(victim)
    arr.flat[0] += 1
    np.save(victim, arr)
    with pytest.raises(IOError, match="checksum"):
        restore_checkpoint(str(tmp_path), state, step=1)


def test_checkpoint_atomic_no_tmp_left(tmp_path):
    save_checkpoint(str(tmp_path), 1, _toy_state())
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_stale_tmp_is_ignored_then_overwritten(tmp_path):
    """A writer killed mid-save leaves ``step_*.tmp``: resume ignores it,
    and the next save of that step replaces it."""
    save_checkpoint(str(tmp_path), 2, _toy_state())
    stale = tmp_path / "step_00000004.tmp"
    stale.mkdir()
    (stale / "leaf_00000.npy").write_bytes(b"half a leaf")
    assert list_steps(str(tmp_path)) == [2] and latest_step(str(tmp_path)) == 2
    restore_checkpoint(str(tmp_path), _toy_state())  # step 2, the .tmp unread
    save_checkpoint(str(tmp_path), 4, _toy_state(1))
    assert not stale.exists() and list_steps(str(tmp_path)) == [2, 4]
    got, _ = restore_checkpoint(str(tmp_path), _toy_state())
    assert torch.equal(got["w"], _toy_state(1)["w"])


def test_kill_and_resume_exact(tmp_path):
    """A 'preempted' run resumed from checkpoint ends in the exact state of
    an uninterrupted run (deterministic data cursor)."""

    def step(state, i):
        x = torch.tensor(float(i + 1))
        return {"w": state["w"] + x}, {"w": state["w"]}

    def init():
        return {"w": torch.tensor(0.0)}

    final_a, _ = run_with_recovery(step, init, 7, CheckpointPolicy(str(tmp_path / "a"), 2))
    pol_b = CheckpointPolicy(directory=str(tmp_path / "b"), every_steps=2)
    run_with_recovery(step, init, 4, pol_b)
    assert latest_step(str(tmp_path / "b")) == 4
    final_b, _ = run_with_recovery(step, init, 7, pol_b)
    assert float(final_a["w"]) == float(final_b["w"]) == 28.0


def test_step_retry_on_transient_failure(tmp_path):
    calls = {"n": 0, "step2_attempts": 0}

    def flaky_step(state, i):
        calls["n"] += 1
        if i == 2:
            calls["step2_attempts"] += 1
            if calls["step2_attempts"] <= 2:  # fails twice, then recovers
                raise RuntimeError("transient")
        return state, {}

    pol = CheckpointPolicy(directory=str(tmp_path), every_steps=100)
    run_with_recovery(flaky_step, lambda: {"w": torch.tensor(0.0)}, 5, pol)
    assert calls["n"] == 7  # 5 successes + 2 retries
    assert calls["step2_attempts"] == 3


@pytest.mark.parametrize("fault", [
    KernelLaunchError("gather_reduce_cores launch failed: CUDA error 700"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("CUDA error: CUBLAS_STATUS_EXECUTION_FAILED when calling `cublasSgemm( handle, "
                 "opa, opb, m, n, k, &alpha, a, lda, b, ldb, &beta, c, ldc)`"),
    RuntimeError("cuBLAS error: CUBLAS_STATUS_EXECUTION_FAILED"),
    RuntimeError("cuDNN error: CUDNN_STATUS_EXECUTION_FAILED"),
    torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
])
def test_device_fault_is_never_retried(tmp_path, fault):
    calls = []

    def step(state, i):
        calls.append(i)
        raise fault

    assert is_device_fault(fault) and not is_device_fault(RuntimeError("transient"))
    with pytest.raises(type(fault)):
        run_with_recovery(step, lambda: {}, 3, CheckpointPolicy(str(tmp_path), max_retries=3))
    assert calls == [0]


def test_retries_spent_reraise(tmp_path):
    def step(state, i):
        raise ValueError("always")

    with pytest.raises(ValueError, match="always"):
        run_with_recovery(step, lambda: {}, 2, CheckpointPolicy(str(tmp_path), max_retries=2))


def test_straggler_monitor_flags_slow_steps():
    mon = StepMonitor(deadline_factor=3.0)
    for i in range(10):
        mon.record(i, 0.1)
    assert mon.record(10, 1.0)  # 10x median -> straggler
    assert not mon.record(11, 0.12)
    s = mon.summary()
    assert s["stragglers"] == 1 and s["steps"] == 12


def test_elastic_restore_resharding(tmp_path):
    """Restore onto another layout than the save's: a 1-rank mesh, the rows
    sharded over it, each rank keeping its own shard (no collective)."""
    w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    save_checkpoint(str(tmp_path), 1, {"w": w}, meta={"next_step": 1})
    (out,) = spawn_ranks(ranks.elastic_restore, 1, (str(tmp_path),), backend="gloo",
                         timeout=SPAWN_TIMEOUT, init_dir=tmp_path)
    assert out["is_dtensor"] and "Shard(dim=0)" in out["placements"]
    np.testing.assert_array_equal(out["local"], w.numpy())
    np.testing.assert_array_equal(out["full"], w.numpy())
    assert out["meta"] == {"next_step": 1}
    # the restored DTensor state saves as its logical value: the same bytes
    assert _files(out["resaved"]) == _files(tmp_path / "step_00000001")


def test_pagerank_kill_and_resume_reaches_identical_convergence(tmp_path):
    """The engine's label tree (rank / inv_deg / mask / scalar n) through
    save and restore: a PageRank run driven step-wise through
    run_with_recovery, killed after 20 steps and resumed from step 15, lands
    on the bitwise labels of an uninterrupted run, within PR_TOL of
    ``repro``'s run (kernel #1 fixes the port's sum order, not the Pallas
    kernel's), and near the oracle ranks. ``repro``'s own two backends
    (Pallas and XLA) differ beyond bit equality on this graph, so bit
    equality across the packages would ask more than the reference keeps
    between its own backends."""
    import repro.core.graph as RG
    from repro.core.engine import EngineOptions as REngineOptions
    from repro.core.engine import make_iteration as r_make_iteration
    from repro.core.engine import prepare_labels as r_prepare_labels
    from repro.core.engine import unpad_labels as r_unpad_labels
    from repro.core.partition import PartitionConfig as RConfig
    from repro.core.partition import partition_2d as r_partition
    from repro.core.problems import pagerank as r_pagerank
    from repro.core.reference import pagerank_reference

    import repro_torch.core.graph as G
    from repro_torch.core.engine import EngineOptions, make_iteration, prepare_labels, unpad_labels
    from repro_torch.core.partition import PartitionConfig, partition_2d
    from repro_torch.core.problems import pagerank

    g = G.rmat(8, 6, seed=4)
    pg = partition_2d(g, PartitionConfig(p=2, l=2, lane=8))
    prob = pagerank(tol=0.0)  # fixed-step power iteration
    iteration = make_iteration(prob, pg, EngineOptions(), device="cpu")

    def init():
        return prepare_labels(prob, g, pg, device="cpu")

    def step_fn(state, i):
        return iteration(state), {}

    steps = 40
    final_a, _ = run_with_recovery(step_fn, init, steps, CheckpointPolicy(str(tmp_path / "a"), 15))
    pol_b = CheckpointPolicy(directory=str(tmp_path / "b"), every_steps=15)
    run_with_recovery(step_fn, init, 20, pol_b)  # 'preempted' after 20 steps
    assert latest_step(str(tmp_path / "b")) == 15
    final_b, _ = run_with_recovery(step_fn, init, steps, pol_b)  # resume @ 15
    a, b = unpad_labels(final_a, pg), unpad_labels(final_b, pg)
    np.testing.assert_array_equal(a["label"], b["label"])  # bitwise

    rg = RG.rmat(8, 6, seed=4)
    rpg = r_partition(rg, RConfig(p=2, l=2, lane=8))
    rprob = r_pagerank(tol=0.0)

    def r_run(backend):
        r_iter = jax.jit(r_make_iteration(rprob, rpg, REngineOptions(backend=backend)))
        labels = r_prepare_labels(rprob, rg, rpg)
        for _ in range(steps):
            labels = r_iter(labels)
        return r_unpad_labels({k: np.asarray(v) for k, v in labels.items()}, rpg)["label"]

    want, want_xla = r_run("pallas"), r_run("xla")
    assert not np.array_equal(want, want_xla)  # the reference's own sum orders differ
    np.testing.assert_allclose(want_xla, want, **PR_TOL)
    np.testing.assert_allclose(b["label"], want, **PR_TOL)
    np.testing.assert_allclose(b["label"], pagerank_reference(rg), atol=1e-4)


def test_compression_error_feedback_unit():
    from repro_torch.dist.compression import int8_compress, int8_decompress, topk_sparsify

    x = torch.from_numpy(np.random.default_rng(0).standard_normal(1000).astype(np.float32))
    q, s = int8_compress(x)
    err = (int8_decompress(q, s) - x).abs().max()
    assert float(err) <= float(s) * 0.51 + 1e-6  # half-step quantization error
    sp, mask = topk_sparsify(x, 0.1)
    assert int(mask.sum()) >= 100
    np.testing.assert_allclose(sp[mask].numpy(), x[mask].numpy())


# -- files across the packages ------------------------------------------------


def _cross_states():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((5, 7)).astype(np.float32)
    ids = rng.integers(-9, 9, (4, 3)).astype(np.int32)
    mu = rng.standard_normal((5, 7)).astype(np.float32)
    nu = rng.random((5, 7)).astype(np.float32)
    bf = rng.standard_normal((3, 4)).astype(np.float32)
    ref = {
        "w": jnp.asarray(w), "ids": jnp.asarray(ids), "scalar": 7,
        "opt": RAdamWState(step=jnp.int32(3), mu={"w": jnp.asarray(mu)}, nu={"w": jnp.asarray(nu)}),
        "bf16": jnp.asarray(bf, jnp.bfloat16), "skip": None,
    }
    port = {
        "w": torch.from_numpy(w), "ids": torch.from_numpy(ids), "scalar": 7,
        "opt": AdamWState(step=torch.tensor(3, dtype=torch.int32), mu={"w": torch.from_numpy(mu)},
                          nu={"w": torch.from_numpy(nu)}),
        "bf16": torch.from_numpy(bf).to(torch.bfloat16), "skip": None,
    }
    return ref, port


def _files(path):
    return {n: (Path(path) / n).read_bytes() for n in sorted(os.listdir(path))}


def test_checkpoint_files_byte_identical_across_packages(tmp_path):
    ref, port = _cross_states()
    meta = {"next_step": 3, "seed": 7, "arr": np.arange(3)}
    a = RC.save_checkpoint(str(tmp_path / "ref"), 3, ref, meta=meta)
    b = save_checkpoint(str(tmp_path / "port"), 3, port, meta=meta)
    fa, fb = _files(a), _files(b)
    assert list(fa) == list(fb) == [f"leaf_{i:05d}.npy" for i in range(7)] + ["manifest.json"]
    for name in fa:
        assert fa[name] == fb[name], name
    assert b"'descr': '<V2'" in fb["leaf_00000.npy"]  # "bf16" sorts first


def test_port_restores_reference_files_bit_for_bit(tmp_path):
    ref, port = _cross_states()
    RC.save_checkpoint(str(tmp_path), 3, ref, meta={"next_step": 3})
    like = {"w": torch.zeros(5, 7), "ids": torch.zeros(4, 3, dtype=torch.int32), "scalar": 0,
            "opt": AdamWState(step=torch.tensor(0, dtype=torch.int32),
                              mu={"w": torch.zeros(5, 7)}, nu={"w": torch.zeros(5, 7)}),
            "bf16": torch.zeros(3, 4, dtype=torch.bfloat16), "skip": None}
    got, meta = restore_checkpoint(str(tmp_path), like)
    assert meta == {"next_step": 3}
    assert isinstance(got["opt"], AdamWState) and got["skip"] is None
    assert got["scalar"] == 7 and type(got["scalar"]) is int
    assert got["bf16"].dtype == torch.bfloat16
    assert torch.equal(got["bf16"].view(torch.int16), port["bf16"].view(torch.int16))
    for x, y in zip(tree_flatten(got)[0], tree_flatten(port)[0]):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)


def test_reference_restores_port_files_except_bf16(tmp_path):
    """The reference reads the port's files bit for bit; a bf16 leaf it
    cannot restore at all (its own files neither): numpy reads '<V2' as
    void, which ``jnp.asarray`` rejects."""
    ref, port = _cross_states()
    save_checkpoint(str(tmp_path), 3, port)
    bf16_free = {k: v for k, v in ref.items() if k != "bf16"}
    like = dict(bf16_free, bf16=jnp.zeros(()))  # a leaf in the bf16 slot, not read
    with pytest.raises(TypeError):
        RC.restore_checkpoint(str(tmp_path), like)
    RC.save_checkpoint(str(tmp_path / "own"), 1, ref)
    with pytest.raises(TypeError):
        RC.restore_checkpoint(str(tmp_path / "own"), ref)
    # without the bf16 leaf both packages' files restore in the reference
    save_checkpoint(str(tmp_path / "nobf"), 3, {k: v for k, v in port.items() if k != "bf16"})
    got, _ = RC.restore_checkpoint(str(tmp_path / "nobf"), bf16_free)
    for x, y in zip(jax.tree.leaves(got), tree_flatten({k: v for k, v in port.items()
                                                        if k != "bf16"})[0]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_port_restores_reference_u32_labels_as_int32_bits(tmp_path):
    """The reference keeps BFS labels as uint32, the port as int32 bits
    (``core.u32``): a restore into an int32 template views the words."""
    labels = np.array([0, 7, 0xFFFFFFFF, 0x80000000], np.uint32)
    RC.save_checkpoint(str(tmp_path), 1, {"label": jnp.asarray(labels)})
    got, _ = restore_checkpoint(str(tmp_path), {"label": torch.zeros(4, dtype=torch.int32)})
    assert got["label"].dtype == torch.int32
    assert got["label"].numpy().tobytes() == labels.tobytes()


def test_bf16_restore_keeps_device_dtype_and_scalars(tmp_path):
    bits = torch.tensor([0x3F80, 0x7F7F, 0x0001, -0x8000, 0x7FC1], dtype=torch.int16)
    state = {"h": bits.view(torch.bfloat16), "f": 2.5, "flag": True}
    save_checkpoint(str(tmp_path), 1, state)
    got, _ = restore_checkpoint(str(tmp_path), {"h": torch.zeros(5, dtype=torch.bfloat16),
                                                "f": 0.0, "flag": False})
    assert torch.equal(got["h"].view(torch.int16), bits)
    assert got["f"] == 2.5 and type(got["f"]) is float and got["flag"] is True


# -- the trainer CLI, killed for real -------------------------------------------


def _train(ckpt, steps=60):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return [sys.executable, "-m", "repro_torch.launch.train", "--arch", "smollm-135m",
            "--steps", str(steps), "--batch", "2", "--seq", "16", "--ckpt", str(ckpt),
            "--ckpt-every", "10", "--device", "cpu"], env


def _last_loss(stdout):
    last = stdout.strip().splitlines()[-1]
    return last.split("last loss ")[1].split(";")[0]


def test_trainer_ckpt_killed_and_resumed(tmp_path):
    cmd, env = _train(tmp_path / "killed")
    proc = subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 240
        while not (tmp_path / "killed" / "step_00000020").exists():
            assert proc.poll() is None, proc.stderr.read().decode()
            assert time.monotonic() < deadline, "no step 20 checkpoint"
            time.sleep(0.002)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert proc.returncode == -signal.SIGKILL
    newest = latest_step(str(tmp_path / "killed"))
    assert 20 <= newest < 60
    stale = tmp_path / "killed" / f"step_{newest + 10:08d}.tmp"
    stale.mkdir(exist_ok=True)  # as a save killed mid-write leaves it
    (stale / "manifest.json").write_text("{")
    rerun = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert rerun.returncode == 0, rerun.stderr
    assert f"resume: step {newest} under" in rerun.stdout
    assert f"'steps': {60 - newest}" in rerun.stdout
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path / "killed"))
    cmd_u, _ = _train(tmp_path / "whole")
    whole = subprocess.run(cmd_u, env=env, cwd=ROOT, capture_output=True, text=True,
                           timeout=300)
    assert whole.returncode == 0, whole.stderr
    assert _last_loss(rerun.stdout) == _last_loss(whole.stdout)
