"""Process groups for the multi-channel engine, rank start-up, and the card's
roofline constants.

Counterpart of the part of ``repro.launch.mesh`` the engine needs. The
reference's graph mesh is one device per graph core; here it is one process
(rank) per graph core in a ``torch.distributed`` group:
``make_graph_group(num_cores, ...)`` returns that group and checks that the
world has exactly ``num_cores`` ranks, as ``run_distributed`` asserts
``pg.p == mesh.shape[axis]``.

The crossbar's transport is the group's backend, chosen once when the group
is made:

  * ``"nccl"``: one card per rank (rank r on ``cuda:r``); the exchanges move
    device tensors.
  * ``"gloo"``: the CPU tests, and p ranks sharing one card. Gloo has no
    all-gather or all-to-all of CUDA tensors, so the crossbar copies a CUDA
    sub-interval to the host, exchanges it there and copies the result back
    (``core.distributed``); the kernels still run on the card.

``make_production_mesh`` is the reference's production mesh as a
``torch.distributed`` ``DeviceMesh`` with its shape and axis names, on a
fake world (``FakeProcessGroup``: no rank exists but this one, no card is
touched, every collective returns a tensor of the right shape and no
meaningful values). The dry run (``launch.dryrun``) traces a cell's step on
it with fake tensors. ``make_graph_mesh`` is a 1-D mesh over the current
group (the ``graph`` or ``table`` axis).

``spawn_ranks`` starts the ranks (``spawn``, a ``file://`` rendezvous in a
fresh directory, so concurrent runs never share a port), gives each its
group and collects what each returns, within a time limit: a rank that
fails or a run that hangs past it ends every rank and raises.
"""
from __future__ import annotations

import math
import os
import queue as queue_mod
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

__all__ = ["make_graph_group", "spawn_ranks", "make_production_mesh", "make_graph_mesh",
           "fake_world", "HW"]

TRANSPORTS = ("gloo", "nccl")


def make_graph_group(num_cores: int, *, backend: str | None = None,
                     init_method: str | None = None, rank: int | None = None):
    """The process group of the ``graph`` axis: one rank per graph core.

    Initialises ``torch.distributed`` when it is not yet (then ``backend``,
    ``init_method`` and ``rank`` are required; the world size is
    ``num_cores``). Under NCCL, rank r takes ``cuda:r``. Raises unless the
    world holds exactly ``num_cores`` ranks."""
    if not dist.is_initialized():
        if backend not in TRANSPORTS or init_method is None or rank is None:
            raise ValueError(
                "torch.distributed is not initialised: pass backend ('gloo' or 'nccl'), "
                f"init_method and rank (got {backend!r}, {init_method!r}, {rank!r})"
            )
        if backend == "nccl":
            if torch.cuda.device_count() < num_cores:
                raise RuntimeError(
                    f"NCCL takes one card a rank: {num_cores} ranks, "
                    f"{torch.cuda.device_count()} cards"
                )
            torch.cuda.set_device(rank)
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=num_cores)
    elif backend is not None and dist.get_backend() != backend:
        raise ValueError(f"the group's backend is {dist.get_backend()!r}, not {backend!r}")
    if dist.get_world_size() != num_cores:
        raise ValueError(f"the world has {dist.get_world_size()} ranks, the graph "
                         f"{num_cores} cores")
    return dist.group.WORLD


def _rank_main(rank, world_size, backend, init_method, fn, args, results):
    try:
        group = make_graph_group(world_size, backend=backend, init_method=init_method,
                                 rank=rank)
        out = fn(rank, group, *args)
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which ends every rank
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn, world_size: int, args=(), *, backend: str, timeout: float,
                init_dir: str | os.PathLike | None = None) -> list:
    """Run ``fn(rank, group, *args)`` in ``world_size`` spawned ranks and
    return their results in rank order.

    ``fn`` must be importable by name (a module-level function) and its
    arguments and result picklable. The rendezvous is a file in a fresh
    directory under ``init_dir`` (the system's temporary directory when
    None). A rank that raises, dies or is still running after ``timeout``
    seconds makes every rank end and this raise."""
    if backend not in TRANSPORTS:
        raise ValueError(f"backend must be one of {TRANSPORTS}, got {backend!r}")
    rendezvous = tempfile.mkdtemp(prefix="ranks-", dir=init_dir)
    init_method = "file://" + os.path.join(os.path.abspath(rendezvous), "init")
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world_size, backend, init_method, fn, args, results))
             for r in range(world_size)]
    for proc in procs:
        proc.start()
    got, failure = {}, None
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world_size and failure is None:
            left = deadline - time.monotonic()
            if left <= 0:
                failure = f"ranks {sorted(set(range(world_size)) - set(got))} still running " \
                          f"after {timeout} s"
                break
            try:
                rank, ok, out = results.get(timeout=min(left, 0.5))
            except queue_mod.Empty:
                dead = [r for r, proc in enumerate(procs)
                        if r not in got and proc.exitcode not in (None, 0)]
                if dead:
                    failure = f"rank {dead[0]} exited with code {procs[dead[0]].exitcode}"
                continue
            if not ok:
                failure = f"rank {rank} failed:\n{out}"
            got[rank] = out
    finally:
        for proc in procs:
            proc.join(timeout=5 if failure is None else 0.1)
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
        results.close()
    if failure is not None:
        raise RuntimeError(f"spawn_ranks({fn.__name__}, {world_size} x {backend}): {failure}")
    bad = [r for r, proc in enumerate(procs) if proc.exitcode != 0]
    if bad:
        raise RuntimeError(f"spawn_ranks({fn.__name__}): rank {bad[0]} exited with code "
                           f"{procs[bad[0]].exitcode} after returning")
    return [got[r] for r in range(world_size)]


def fake_world(size: int) -> None:
    """Make the current group a fake world of ``size`` ranks (this process
    rank 0). A fake world of another size is replaced; a real group of
    another size is refused."""
    if dist.is_initialized():
        if dist.get_world_size() == size:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a real {dist.get_backend()!r} group of {dist.get_world_size()} ranks is "
                f"initialised; the mesh needs {size}")
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The reference's production mesh as a ``DeviceMesh``: ``(data=16,
    model=16)``, or ``(pod=2, data=16, model=16)`` with ``multi_pod``.

    256 cards are 32 nodes of 8 H100s: NVLink joins the 8 cards of a node,
    and one 400 Gb/s InfiniBand port a card joins the nodes. The 16-wide
    ``model`` axis therefore crosses two NVLink domains, so its collectives
    are priced at the scale-out link (``HW.IB_BW``), the reference's
    conservative one-link rule kept; ``pod`` crosses pods (data parallel
    only). The mesh lives on a fake world of 256 or 512 ranks (made here
    when no group is initialised; a fake world of another size is
    replaced, a real group of another size refused): nothing is allocated
    and no card is touched."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    fake_world(math.prod(shape))
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_graph_mesh(num_cores: int, axis: str = "graph"):
    """A 1-D ``DeviceMesh`` of ``num_cores`` ranks named ``axis`` over the
    current group, which must hold exactly that many ranks (the GraphScale
    engine's ``graph`` axis, or the router's ``table`` axis). The device
    type is the group's: ``cuda`` under NCCL, else ``cpu``."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized() or dist.get_world_size() != num_cores:
        raise ValueError(f"the current group must hold {num_cores} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (num_cores,), mesh_dim_names=(axis,))


class HW:
    """Roofline constants of one card: NVIDIA's data sheet for the H100 SXM
    (dense rates, no sparsity), which assumes the full power limit; the
    card these constants describe reads "NVIDIA H100 80GB HBM3, 700.00 W"
    from ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``.
    A card set to a lower limit runs slower under load."""

    PEAK_FLOPS_BF16 = 989e12  # FLOP/s, dense bf16 tensor cores (H100 80GB HBM3, 700 W)
    HBM_BW = 3.35e12  # B/s (H100 80GB HBM3, 700 W)
    PEAK_FLOPS_F32 = 67e12  # FLOP/s, float32 outside the tensor cores (H100 80GB HBM3, 700 W)
    NVLINK_BW = 900e9  # B/s per card, both directions of its 18 NVLink 4 links (H100 80GB HBM3, 700 W)
    # B/s per card across nodes: one 400 Gb/s NDR InfiniBand port a card (H100 80GB HBM3,
    # 700 W, in the 8-card nodes the production mesh assumes); the counterpart of the
    # reference's ICI_BW, the one-link price of every collective
    IB_BW = 50e9
    HBM_BYTES = 80e9  # bytes of HBM3 (H100 80GB HBM3, 700 W)
