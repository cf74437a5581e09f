"""Dry run: trace every (arch x shape x mesh) cell's step once on fake tensors
on a production mesh, and record per device its FLOPs, bytes, collectives,
peak memory, whether it fits the card, and its roofline terms.

Counterpart of ``repro.launch.dryrun``. Run it as its own process: the fake
world of 256 or 512 ranks it makes (``launch.mesh.make_production_mesh``)
must not reach other code.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi --out results/dryrun
    PYTHONPATH=src python -m repro_torch.launch.dryrun --on-card din/serve_p99

Per cell, the real step (``cells.build_cell``) runs once on the cell's fake
inputs (DTensors of fake CUDA tensors, this rank's shards) under
``FakeTensorMode``; nothing is allocated and no card is touched. A dispatch
mode below DTensor sees each rank-local aten op and records:

  * FLOPs: ``torch.utils.flop_counter``'s formulas (what ``FlopCounterMode``
    counts) plus the kernels' own formulas (``kernels.fake.note``);
  * bytes: each op's operands read and results written (views move none),
    plus the kernels' bytes: the counterpart of XLA's "bytes accessed";
  * collectives: every functional and c10d collective with its group size,
    priced by ``roofline.collective_bytes``;
  * peak memory: ``MemTracker`` over the step, the inputs tracked (params,
    optimizer state, batch, cache) and every activation and temporary; the
    record keeps the peak by kind (``KINDS``) and the largest tensors live
    at the peak, each with the op that made it.

The reference compiles two more probes (L = 1, 2) because XLA costs a scan
body once; the eager trace sees every layer, so there are none. A cell whose
trace fails (an op whose output shape depends on values, an op DTensor
cannot shard) is recorded ``FAIL`` with the op and the error, and the run
exits 1, as the reference's does.

``--on-card CELL[,CELL]`` checks the prediction against the card: each cell
is built on a mesh of one rank, traced fake, then the same step runs on the
card on inputs drawn from ``--seed``; the record holds both FLOP counts
(``FlopCounterMode`` on the card), the predicted and measured peak memory
(``torch.cuda.max_memory_allocated``) and the step's milliseconds.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import signal
import time
import traceback
from typing import Any, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch import sharded

__all__ = ["TraceCounter", "trace_cell", "run_cell", "check_on_card", "main"]

METHOD = ("one eager trace of the real step under FakeTensorMode on the fake production "
          "mesh (DTensor inputs, this rank's shards); every layer traced, so no L = 1, 2 "
          "probes; FLOPs: flop_counter's formulas on rank-local aten ops plus the kernels' "
          "own; bytes: rank-local operands and results (views none) plus the kernels'; "
          "collectives: functional and c10d ops seen below DTensor; peak: MemTracker")

# a trace past this is recorded FAIL (DTensor's planning on the 3-D mesh can
# take many minutes a cell on the host)
CELL_TIMEOUT_S = 1200

_VIEW_FREE = ("empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided")


def _tensors(x) -> List[torch.Tensor]:
    """The tensors in ``x``: dicts, lists, tuples and dataclasses (a
    ``GraphBatch``) walked."""
    out: List[torch.Tensor] = []

    def walk(t):
        if isinstance(t, torch.Tensor):
            out.append(t)
        elif isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        elif dataclasses.is_dataclass(t) and not isinstance(t, type):
            for f in dataclasses.fields(t):
                walk(getattr(t, f.name))

    walk(x)
    return out


def _bytes(x) -> int:
    """The bytes of ``x``'s tensors, each element once: a broadcast dim
    (stride 0, an ``expand``) holds one copy."""
    total = 0
    for t in _tensors(x):
        n = 1
        for size, stride in zip(t.shape, t.stride()):
            n *= size if stride != 0 else min(size, 1)
        total += n * t.element_size()
    return total


def _collective(func, args, kwargs, out):
    """(kind, output bytes, group size) of a collective op, else None."""
    import torch.distributed as dist

    ns, name = func.namespace, func._overloadpacket.__name__
    if ns in ("_c10d_functional", "_c10d_functional_autograd"):
        from torch.distributed.distributed_c10d import _resolve_process_group

        kinds = {"all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
                 "reduce_scatter_tensor": "reduce-scatter",
                 "all_to_all_single": "all-to-all", "broadcast": "all-gather"}
        if name not in kinds:
            return None
        group = _resolve_process_group(args[-1] if isinstance(args[-1], str)
                                       else kwargs["group_name"])
        return kinds[name], _bytes(out), dist.get_world_size(group)
    if ns == "c10d":
        kinds = {"allgather_": "all-gather", "_allgather_base_": "all-gather",
                 "allgather_into_tensor_coalesced_": "all-gather",
                 "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
                 "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
                 "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
                 "broadcast_": "all-gather", "send": "collective-permute"}
        if name not in kinds:
            return None
        group = next(a for a in args if isinstance(a, torch.ScriptObject))
        moved = _bytes(args[0])  # the output (or in-place) tensors
        return kinds[name], moved, dist.ProcessGroup.unbox(group).size()
    return None


class TraceCounter(TorchDispatchMode):
    """Counts rank-local work: FLOPs by ``torch.utils.flop_counter``'s
    formulas (decomposing what has none, as ``FlopCounterMode`` does), bytes
    of operands and results, collectives. Below DTensor: a DTensor op is
    passed on (``NotImplemented``) so its local ops and collectives come
    back here, as ``CommDebugMode`` sees them."""

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives: List[tuple] = []
        self.flops_by_op: Dict[str, int] = {}
        self.last_op: Optional[str] = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types) or func in _metadata_ops():
            return NotImplemented
        self.last_op = str(func)
        packet = func._overloadpacket
        if packet not in flop_registry and func is not torch.ops.prim.device.default \
                and func.namespace not in ("c10d", "_c10d_functional",
                                           "_c10d_functional_autograd"):
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        coll = _collective(func, args, kwargs, out)
        if coll is not None:
            self.collectives.append(coll)
            return out
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += flops
            self.flops_by_op[packet.__name__] = self.flops_by_op.get(packet.__name__, 0) + flops
            sharded.note_flops(flops)
        outs = _tensors(out)  # none: a query of metadata (prim.device), no bytes
        if outs and not func.is_view and packet.__name__ not in _VIEW_FREE:
            self.bytes += _bytes((args, kwargs)) + _bytes(outs)
        return out


def _metadata_ops() -> frozenset:
    """Ops that read a tensor's metadata only (``FlopCounterMode`` passes
    them on the same way)."""
    a = torch.ops.aten
    return frozenset({
        a.sym_is_contiguous.default, a.is_contiguous.default, a.is_contiguous.memory_format,
        a.is_strides_like_format.default, a.is_non_overlapping_and_dense.default,
        a.size.default, a.sym_size.default, a.stride.default, a.sym_stride.default,
        a.storage_offset.default, a.sym_storage_offset.default, a.numel.default,
        a.sym_numel.default, a.dim.default, torch.ops.prim.layout.default})


@contextlib.contextmanager
def _dtensor_bookkeeping_unseen():
    """Run DTensor's own bookkeeping with every mode off, so that the
    counters see only the step's rank-local ops. Two of its methods run
    tensor ops: the output metadata of an op (``ShardingPropagator``: the op
    once more on global-shape fakes of the active fake mode, which the
    counters and ``MemTracker`` would take for work) and a strided shard's
    size and offsets (``_StridedShard``: index tensors whose ``tolist``
    fails on fakes). With the modes off the first makes its own fake mode
    and the second runs on the host; no op of the step is skipped."""
    from torch.distributed.tensor import _sharding_prop, placement_types as pt
    from torch.utils._python_dispatch import _disable_current_modes

    prop = _sharding_prop.ShardingPropagator
    targets = [(getattr(pt, "_StridedShard", None), ("local_shard_size_and_offset",
                                                      "_local_shard_size_and_offset")),
               (prop, tuple(n for n in vars(prop) if n.startswith("_propagate_tensor_meta")))]
    saved = [(cls, n, cls.__dict__[n]) for cls, names in targets if cls is not None
             for n in names if n in cls.__dict__]
    for cls, name, attr in saved:
        wrapper = type(attr) if isinstance(attr, (staticmethod, classmethod)) else None
        fn = attr.__func__ if wrapper else attr

        def unseen(*a, _fn=fn, **k):
            with _disable_current_modes():
                return _fn(*a, **k)

        setattr(cls, name, wrapper(unseen) if wrapper else unseen)
    try:
        yield
    finally:
        for cls, name, attr in saved:
            setattr(cls, name, attr)


def _local_inputs(args) -> List[torch.Tensor]:
    out = []
    for t in _tensors(args):
        out.append(t.to_local() if hasattr(t, "to_local") else t)
    return out


# MemTracker's kinds as a record names them: the inputs by role (``_input
# kinds``), the forward's tensors, the backward's (recompute, activation
# grads), what the backward leaves alive when it ends (the gradients), and
# what the optimizer update makes after it (with the moments it was given)
KINDS = {"Parameter": "parameters", "Gradient": "gradients", "Optstate": "optimizer_state",
         "Activation": "activations", "Temp": "temporaries", "Other": "inputs",
         "Buffer": "buffers"}
LARGEST = 8  # the live tensors a record keeps from the peak


def _peak_tracker():
    """A ``MemTracker`` that also keeps the peak's largest live tensors, each
    with the op that made it, and sorts memory into ``KINDS``. The snapshot
    of the live tensors is taken at the first free after a new peak (the
    live set then is the peak's) or at the end."""
    from torch.distributed._tools.common_utils import get_untyped_storages
    from torch.distributed._tools.mem_tracker import MemTracker, _MemRefType, _UpdateType
    from torch.distributed.tensor import DTensor

    class PeakTracker(MemTracker):
        def __init__(self) -> None:
            super().__init__()
            self._dirty = False
            self._seen_bw = False
            self.largest: List[dict] = []

        def track_inputs(self, roles) -> None:
            """``roles``: (tensor, MemTracker kind name, label) of each input."""
            for t, kind, label in roles:
                for w in self._update_and_maybe_create_winfos(t, _MemRefType(kind)):
                    w.made_by = (label, tuple(t.shape), str(t.dtype).replace("torch.", ""))

        def _update_peak_stats(self, peak_state) -> None:
            before = dict(self._peak_mem)
            super()._update_peak_stats(peak_state)
            if self._peak_mem != before:
                self._dirty = True

        def _delete_callback(self, winfo, w_st) -> None:
            if self._dirty:
                self.snapshot_live(winfo)
            super()._delete_callback(winfo, w_st)

        def snapshot_live(self, dying=None) -> None:
            """Keep the largest live tensors (the peak's while no free has come
            since the last new peak)."""
            self._dirty = False
            live = {id(w): w for w, _ in self._WINFO.values()}
            if dying is not None:
                live[id(dying)] = dying
            ws = sorted(live.values(), key=lambda w: -w.mem_consumed)
            self.largest = [dict(zip(("op", "shape", "dtype"), getattr(w, "made_by", ("?",) * 3)),
                                 bytes=w.mem_consumed, kind=KINDS[w.reftype.value])
                            for w in ws[:LARGEST]]

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not any(t == DTensor for t in types):
                if torch._C._current_graph_task_id() != -1:
                    self._seen_bw = True
                elif self._seen_bw and not self._in_opt:
                    # the backward has ended: what it left alive are the
                    # gradients; what comes now is the optimizer update's
                    self._in_opt = True
                    for w, _ in list(self._WINFO.values()):
                        if w.reftype == _MemRefType.TEMP:
                            w.reftype = _MemRefType.GRAD
                            self._update_snap(_UpdateType.REF, w, old_reftype=_MemRefType.TEMP)
            res = super().__torch_dispatch__(func, types, args, kwargs)
            if res is not NotImplemented:
                for t in _tensors(res):
                    for st in get_untyped_storages(t):
                        w = self._WINFO.get(st, (None, None))[0]
                        if w is not None and not hasattr(w, "made_by"):
                            w.made_by = (str(func), tuple(t.shape),
                                         str(t.dtype).replace("torch.", ""))
            return res

    return PeakTracker()


def _input_kinds(args) -> List[tuple]:
    """(local tensor, MemTracker kind, label) of a cell's inputs: a train
    state's params and optimizer moments, a serving step's params (its first
    argument), everything else (batches, labels, a KV cache) inputs."""
    roles = []

    def add(tree, kind, label):
        for t in _local_inputs(tree):
            roles.append((t, kind, label))

    for i, a in enumerate(args):
        if i == 0 and isinstance(a, dict) and "params" in a and "opt" in a:
            add(a["params"], "Parameter", "input: params")
            add(a["opt"], "Optstate", "input: optimizer state")
        elif i == 0:
            add(a, "Parameter", "input: params")
        else:
            add(a, "Other", f"input: argument {i}")
    return roles


def trace_cell(cell) -> Dict[str, Any]:
    """Trace ``cell.fn(*cell.args)`` once under the cell's fake mode: the
    per-device counts ({"flops", "aten_flops", "kernel_flops", "bytes",
    "collectives", "peak_bytes", "input_bytes", "kernel_calls", "replicated":
    the kernels and forms whose work a DTensor form ran on gathered operands,
    with the number of ranks doing the same work; "replicated_flops": the
    aten FLOPs each such form ran; "flops_by_op": the aten FLOPs by op;
    "peak_by_kind": the peak in ``KINDS``; "peak_largest": the ``LARGEST``
    largest tensors live at the peak with the op that made each}).
    Raises what the trace raises, with ``last_op`` set on the counter."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.kernels.fake import KernelWork
    from repro_torch.launch.sharded import Replicated, ShardedForms

    if cell.setup is not None:
        cell.setup()
    counter = TraceCounter()
    cell.trace_counter = counter  # the last op, for a failure's record
    roles = _input_kinds(cell.args)
    inputs = [t for t, _, _ in roles]
    mt = _peak_tracker()
    with cell.mode:
        mt.track_inputs(roles)
        with _dtensor_bookkeeping_unseen(), implicit_replication(), KernelWork() as kw, \
                Replicated() as rep, ShardedForms(), mt, counter:
            out = cell.fn(*cell.args)
        if mt._dirty:
            mt.snapshot_live()
        del out
    peak = mt.get_tracker_snapshot("peak")
    dev_snap = max(peak.values(), key=lambda v: v.get("Total", 0), default={"Total": 0})
    by_kind = {}
    for k, v in dev_snap.items():
        if k != "Total" and v:
            by_kind[KINDS[k.value]] = by_kind.get(KINDS[k.value], 0) + v
    return dict(flops=counter.flops + kw.flops, aten_flops=counter.flops,
                kernel_flops=kw.flops, bytes=counter.bytes + kw.bytes,
                kernel_bytes=kw.bytes, collectives=counter.collectives,
                peak_bytes=dev_snap.get("Total", 0), input_bytes=_bytes(inputs),
                kernel_calls=dict(kw.calls), replicated=dict(rep.factors),
                replicated_flops=dict(rep.flops), flops_by_op=dict(counter.flops_by_op),
                peak_by_kind=by_kind, peak_largest=mt.largest)


def run_cell(arch_id: str, shape_name: str, mesh_name: str, out_dir: str,
             model_overrides=None, tag: str = "", seed: int = 0,
             device_type: str = "cuda") -> dict:
    """Build and trace one cell on the named production mesh; write its
    record to ``out_dir`` and return it (``status`` "ok" or "FAIL").
    ``device_type`` "cpu" traces the plain versions where the kernels would
    run (a CPU-only build of torch cannot differentiate fake CUDA tensors)."""
    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import HW, make_production_mesh
    from repro_torch.launch.roofline import collective_bytes, roofline_report

    arch = ARCHS[arch_id]
    mesh = make_production_mesh(multi_pod=(mesh_name == "multi"), device_type=device_type)
    chips = mesh.size()
    key = f"{arch_id}/{shape_name}"
    t0 = time.time()
    cell = None
    def out_of_time(*_):
        raise TimeoutError(f"the trace ran past {CELL_TIMEOUT_S} s")

    old_handler = signal.signal(signal.SIGALRM, out_of_time)
    signal.alarm(CELL_TIMEOUT_S)
    try:
        cell = build_cell(arch, shape_name, mesh, model_overrides=model_overrides, seed=seed)
        got = trace_cell(cell)
    except Exception as e:  # noqa: BLE001 -- a cell that cannot be traced is a FAIL record
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old_handler)
        counter = getattr(cell, "trace_counter", None)
        rec = dict(key=key, mesh=mesh_name, chips=chips, status="FAIL",
                   op=counter.last_op if counter is not None else "build_cell",
                   error=f"{type(e).__name__}: {e}"[:2000], method=METHOD)
        print(f"[FAIL] {key} mesh={mesh_name} op={rec['op']}: {rec['error'][:300]}", flush=True)
        traceback.print_exc()
        _write(rec, out_dir, arch_id, shape_name, mesh_name, tag)
        return rec
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old_handler)
    t_trace = time.time() - t0
    coll = collective_bytes(got["collectives"])
    coll["method"] = "exact (every layer traced)"
    terms = roofline_report(
        key=cell.key, mesh_name=mesh_name, chips=chips,
        cost={"flops": got["flops"], "bytes accessed": got["bytes"]}, coll=coll,
        model_flops=cell.meta.get("model_flops", 0.0), dtype=cell.dtype,
        memory_bytes=got["peak_bytes"],
        extras={"meta": {k: v for k, v in cell.meta.items() if isinstance(v, (int, float, str))},
                "trace_s": t_trace})
    rec = terms.to_dict()
    rec["memory"] = dict(peak_bytes=got["peak_bytes"], input_bytes=got["input_bytes"],
                         hbm_bytes=HW.HBM_BYTES, fits=got["peak_bytes"] <= HW.HBM_BYTES,
                         by_kind=got["peak_by_kind"], largest=got["peak_largest"])
    rec["flops_split"] = dict(aten=got["aten_flops"], kernels=got["kernel_flops"])
    rec["flops_by_op"] = got["flops_by_op"]
    rec["kernel_calls"] = got["kernel_calls"]
    rec["replicated"] = got["replicated"]
    rec["replicated_flops"] = got["replicated_flops"]
    rec["kernel_bytes"] = got["kernel_bytes"]
    rec["collectives"] = coll
    rec["method"] = METHOD
    rec["device_type"] = device_type
    rec["status"] = "ok"
    _write(rec, out_dir, arch_id, shape_name, mesh_name, tag)
    print(
        f"[OK] {cell.key} mesh={mesh_name} chips={chips} trace={t_trace:.1f}s "
        f"flops/dev={terms.flops_per_device:.3e} bytes/dev={terms.bytes_per_device:.3e} "
        f"coll/dev={terms.collective_bytes_per_device:.3e} dominant={terms.dominant} "
        f"mem/dev={got['peak_bytes'] / 2**30:.2f}GiB", flush=True)
    return rec


def _write(rec, out_dir, arch_id, shape_name, mesh_name, tag):
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    fname = f"{arch_id}__{shape_name}__{mesh_name}{suffix}.json".replace("/", "_")
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(rec, f, indent=1)


def _one_rank_mesh(device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    return init_device_mesh(device_type, (1, 1), mesh_dim_names=("data", "model"))


def _kernel_modules() -> dict:
    """The kernel modules whose ``LAUNCHES`` count each launch, by kernel."""
    from repro_torch.kernels.csr_gather_reduce import bucket, kernel, scatter
    from repro_torch.kernels.embedding_bag import kernel as bag
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.segment_softmax import kernel as softmax
    from repro_torch.kernels.segment_sum import kernel as segsum

    return {"gather_reduce_cores": kernel, "scatter_reduce_cores": scatter,
            "gather_reduce": bucket, "embedding_bag": bag, "segment_softmax": softmax,
            "flash_attention": flash, "segment_sum": segsum}


def check_on_card(arch, shape_name: str, seed: int = 0, device: str = "cuda",
                  reps: int = 3) -> dict:
    """The cell (``arch``: an id of the registry or an ``ArchConfig``) on a
    mesh of one rank, traced fake, then the same step on
    ``device`` on inputs drawn from ``seed``: FLOPs (``FlopCounterMode``,
    and the kernels' formulas) of both, the predicted peak memory (the
    trace's, plus the cuBLAS workspaces the step allocates on the card,
    measured on a first run) and the measured one, the step's ms (host
    clock ending in a synchronize; the run after that first one, and the
    median of ``reps`` more), the launches the kernels' own counters took
    over these runs, and the roofline terms."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.registry import ARCHS
    from repro_torch.kernels.fake import KernelWork
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.roofline import collective_bytes, roofline_report

    dev = torch.device(device)
    mesh = _one_rank_mesh(dev.type)
    cell = build_cell(ARCHS[arch] if isinstance(arch, str) else arch, shape_name, mesh,
                      seed=seed)
    fake = trace_cell(cell)
    terms = roofline_report(cell.key, "one card", 1,
                            {"flops": fake["flops"], "bytes accessed": fake["bytes"]},
                            collective_bytes(fake["collectives"]),
                            cell.meta["model_flops"], dtype=cell.dtype,
                            memory_bytes=fake["peak_bytes"])
    cell.args = ()  # the fakes go; the same inputs, real, from the seed
    args = cell.make_real(dev, seed)
    if cell.setup is not None:
        cell.setup(args[1])

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    kernels = _kernel_modules()
    for mod in kernels.values():
        mod.reset_launch_counts()
    sync()
    workspace = 0
    if dev.type == "cuda":
        # what an earlier cell left (cuBLAS's workspaces, cached blocks) goes
        # first; then one run measures the cuBLAS workspaces the step
        # allocates, which no trace sees: the bytes it leaves allocated that
        # clearing the workspaces frees. They join the prediction.
        gc.collect()
        torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.empty_cache()
        out = cell.fn(*args)
        sync()
        del out
        gc.collect()
        before = torch.cuda.memory_allocated()
        torch._C._cuda_clearCublasWorkspaces()
        workspace = before - torch.cuda.memory_allocated()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
    flop_mode = FlopCounterMode(display=False)
    t = time.perf_counter()
    with flop_mode, KernelWork() as kw:
        out = cell.fn(*args)
    sync()
    first_ms = (time.perf_counter() - t) * 1e3
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
    del out
    times = []
    for _ in range(reps):
        sync()
        t = time.perf_counter()
        out = cell.fn(*args)
        sync()
        times.append((time.perf_counter() - t) * 1e3)
        del out
    # the kernels' own counters: every launch of this check's runs
    launches = {name: dict(mod.LAUNCHES) for name, mod in kernels.items()
                if any(mod.LAUNCHES.values())}
    times.sort()
    card_aten = flop_mode.get_total_flops()
    return dict(
        key=cell.key, seed=seed, device=str(dev),
        fake_aten_flops=fake["aten_flops"], card_aten_flops=card_aten,
        fake_kernel_flops=fake["kernel_flops"], card_kernel_flops=kw.flops,
        flops_equal=card_aten == fake["aten_flops"] and kw.flops == fake["kernel_flops"],
        kernel_calls_fake=fake["kernel_calls"], kernel_calls_card=dict(kw.calls),
        launches=launches,
        predicted_peak_bytes=fake["peak_bytes"] + workspace, traced_peak_bytes=fake["peak_bytes"],
        cublas_workspace_bytes=workspace, input_bytes=fake["input_bytes"],
        card_peak_bytes=peak, card_bytes_at_reset=base,
        peak_ratio=(peak / (fake["peak_bytes"] + workspace)) if peak and fake["peak_bytes"]
        else None,
        first_ms=first_ms, ms=times[len(times) // 2], ms_all=times,
        roofline=dict(compute_s=terms.compute_s, memory_s=terms.memory_s,
                      collective_s=terms.collective_s, dominant=terms.dominant,
                      peak=terms.peak, bytes=fake["bytes"], flops=fake["flops"],
                      bound_ms=max(terms.compute_s, terms.memory_s) * 1e3))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="shape name (default: all)")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--on-card", default=None, metavar="ARCH/SHAPE[,ARCH/SHAPE]",
                    help="check these cells' predictions against the card (one rank)")
    ap.add_argument("--device", default="cuda",
                    help="--on-card's device; otherwise the fake tensors' device type (cpu: "
                         "the plain versions, for a CPU-only build of torch)")
    args = ap.parse_args(argv)

    if args.on_card:
        failed = 0
        for spec in args.on_card.split(","):
            arch_id, shape_name = spec.split("/")
            try:
                rec = check_on_card(arch_id, shape_name, seed=args.seed, device=args.device)
                rec["status"] = "ok"
            except Exception as e:  # noqa: BLE001 -- reported, and the exit code says so
                traceback.print_exc()
                rec = dict(key=spec, status="FAIL", error=f"{type(e).__name__}: {e}"[:2000])
                failed += 1
            print(json.dumps({"on_card": rec}), flush=True)
            if args.device == "cuda":
                torch.cuda.empty_cache()
        return 1 if failed else 0

    from repro_torch.configs.registry import ARCHS

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    arch_ids = [args.arch] if args.arch else list(ARCHS)
    failures, n_ok = [], 0
    for mesh_name in meshes:  # one fake world a mesh
        for arch_id in arch_ids:
            arch = ARCHS[arch_id]
            shape_names = [args.shape] if args.shape else [s.name for s in arch.shapes]
            for shape_name in shape_names:
                rec = run_cell(arch_id, shape_name, mesh_name, args.out, seed=args.seed,
                               device_type=args.device)
                if rec["status"] == "ok":
                    n_ok += 1
                else:
                    failures.append((arch_id, shape_name, mesh_name, rec["op"], rec["error"]))
    print(f"\ndry-run complete: {n_ok} ok, {len(failures)} failed")
    for f in failures:
        print("  FAILED:", *f[:4], "--", f[4][:200])
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
