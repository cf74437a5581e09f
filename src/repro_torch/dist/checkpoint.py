"""Atomic, checksummed, mesh-elastic checkpoints.

Counterpart of ``repro.dist.checkpoint``, and byte for byte the same on disk:
``<dir>/step_<08d>/`` holds one ``leaf_<05d>.npy`` per tree leaf (the
reference's leaf order: dict keys sorted, list, tuple and NamedTuple items
in order, ``None`` no leaf; ``train.optim.tree_flatten``) and
``manifest.json`` (the step, the leaf count, each leaf's CRC32 and the
caller's meta, in the reference's keys). A write goes to ``<final>.tmp``
and is renamed into place, so a killed writer never leaves a half
checkpoint that ``latest_step`` could resume from; a restore checks every
leaf's checksum and raises ``IOError`` on a mismatch.

A bfloat16 leaf is written as the reference writes one (``np.save`` of an
``ml_dtypes.bfloat16`` array: the descriptor ``'<V2'`` and the raw 2-byte
words), without ``ml_dtypes``. A restore goes by the template leaf: it
lands on that leaf's device with its dtype (a bfloat16 leaf from the raw
words, viewed, never through float; the reference's uint32 fields into the
port's int32 bit labels, viewed), and a Python scalar comes back a Python
scalar.

Elastic restore: leaves are stored as LOGICAL (unsharded) values, so a
restore may bring any mesh. ``shardings`` is a tree matching ``like`` whose
leaves are ``(DeviceMesh, placements)`` pairs: each rank reads the logical
leaf and keeps only its own shard (``dist.sharding.local_shard``), returned
as a ``DTensor``. No collective is involved.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.train.optim import tree_flatten

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
    "list_steps",
]

_STEP_PREFIX = "step_"
_BF16_DESCR = "<V2"  # numpy's descriptor of an ml_dtypes.bfloat16 array


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"{_STEP_PREFIX}{step:08d}")


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def _json_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON-serializable: {type(o)}")


def list_steps(directory: str) -> List[int]:
    """Completed checkpoint steps, ascending (.tmp half-writes excluded)."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if name.startswith(_STEP_PREFIX) and not name.endswith(".tmp"):
            try:
                steps.append(int(name[len(_STEP_PREFIX) :]))
            except ValueError:
                continue
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    steps = list_steps(directory)
    return steps[-1] if steps else None


def _host_array(leaf) -> Tuple[np.ndarray, Optional[str]]:
    """(the leaf's logical value as a C-ordered numpy array, the .npy
    descriptor to write when numpy's own would differ from the
    reference's)."""
    if isinstance(leaf, torch.Tensor):
        from torch.distributed.tensor import DTensor

        t = leaf.full_tensor() if isinstance(leaf, DTensor) else leaf
        t = t.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), _BF16_DESCR
        return t.numpy(), None
    return np.asarray(leaf), None


def _save_leaf(path: str, arr: np.ndarray, descr: Optional[str]) -> None:
    if descr is None:
        np.save(path, arr)
        return
    # np.save's bytes with the reference's descriptor: the same header
    # (version 1.0, padded alike) and the raw words after it
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": descr, "fortran_order": False, "shape": arr.shape})
        f.write(arr.tobytes())


def save_checkpoint(
    directory: str,
    step: int,
    state: Any,
    meta: Optional[dict] = None,
    keep: Optional[int] = None,
) -> str:
    """Write ``state`` atomically as step ``step``; returns the final path.
    ``keep``: garbage-collect all but the newest ``keep`` checkpoints. A
    sharded ``DTensor`` leaf is gathered first (a collective: every rank of
    its mesh calls this); a replicated one is read locally."""
    os.makedirs(directory, exist_ok=True)
    final = _step_dir(directory, step)
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    leaves, _ = tree_flatten(state)
    checksums = []
    for i, leaf in enumerate(leaves):
        arr, descr = _host_array(leaf)
        _save_leaf(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr, descr)
        checksums.append(_crc(arr))
    manifest = {
        "step": int(step),
        "n_leaves": len(leaves),
        "checksums": checksums,
        "meta": meta or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, default=_json_default)
    shutil.rmtree(final, ignore_errors=True)
    os.rename(tmp, final)  # the atomic commit point
    if keep is not None:
        for old in list_steps(directory)[:-keep]:
            shutil.rmtree(_step_dir(directory, old), ignore_errors=True)
    return final


def _like_template(arr: np.ndarray, like, device=None):
    """``arr`` (as ``np.load`` read it) in the template leaf's type, on
    ``device`` (default: the template's)."""
    if isinstance(like, (bool, int, float)):
        return type(like)(arr.item())
    dtype = like.dtype
    if dtype == torch.bfloat16 and arr.dtype.itemsize == 2 and arr.dtype.kind in "Vui":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    elif arr.dtype == np.uint32 and dtype == torch.int32:  # the port's u32 bit labels
        t = torch.from_numpy(arr.view(np.int32).copy())
    else:
        t = torch.from_numpy(np.array(arr, copy=True)).to(dtype)
    return t.to(like.device if device is None else device)


def restore_checkpoint(
    directory: str,
    like: Any,
    step: Optional[int] = None,
    shardings: Optional[Any] = None,
) -> Tuple[Any, dict]:
    """Restore the checkpoint at ``step`` (default: latest) into ``like``'s
    tree structure. ``shardings``: optional tree matching ``like`` of
    ``(DeviceMesh, placements)`` pairs: each rank keeps its own shard of
    each leaf as a ``DTensor`` on that mesh (elastic restore onto another
    mesh than the save's). Returns ``(state, meta)``; raises ``IOError`` on
    a checksum mismatch."""
    from repro_torch.dist.sharding import is_sharding, local_shard

    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory!r}")
    path = _step_dir(directory, step)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat, rebuild = tree_flatten(like)
    if manifest["n_leaves"] != len(flat):
        raise IOError(
            f"checkpoint {path} has {manifest['n_leaves']} leaves, "
            f"restore template has {len(flat)}"
        )
    sh_flat = tree_flatten(shardings, is_leaf=is_sharding)[0] if shardings is not None else None
    if sh_flat is not None and len(sh_flat) != len(flat):
        raise IOError("shardings tree does not match the restore template")
    out = []
    for i, like_leaf in enumerate(flat):
        arr = np.load(os.path.join(path, f"leaf_{i:05d}.npy"))
        if _crc(arr) != manifest["checksums"][i]:
            raise IOError(f"checksum mismatch on leaf {i} of {path}")
        if sh_flat is None:
            out.append(_like_template(arr, like_leaf))
        else:
            mesh, place = sh_flat[i]
            out.append(local_shard(_like_template(arr, like_leaf, "cpu"), mesh, place))
    return rebuild(out), manifest["meta"]
