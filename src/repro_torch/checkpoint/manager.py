"""Atomic checkpointing (numpy + atomic rename). Port of
``repro/checkpoint/manager.py``, with the same on-disk layout, so that
each package restores the other's checkpoints bit for bit.

Layout: <dir>/step_<N>/  (N zero-padded to 8 digits)
  shard_<k>.npz          leaf_<i>: leaf i as a uint8 byte view
  manifest.json          leaf names, dtypes, shapes
  meta.json              {"step": N, "extra": {...}}
  COMMIT                 written LAST: a checkpoint without it is ignored

Leaves are numbered in the reference's order (JAX's pytree flattening):
dict keys sorted, list and tuple entries by index, NamedTuple fields in
declaration order, None an empty subtree. Names join the keys, indices
and field names of a leaf's path with "/". A bfloat16 leaf is stored by
its bits and named "bfloat16", as ``ml_dtypes`` names it.

Fault tolerance, as in the reference: ``save`` writes
``step_<N>.tmp-<pid>``, ``os.replace``s it into place, and only then writes
COMMIT; after a successful save only the newest ``keep_k`` committed steps
are kept; ``restore_latest`` returns the newest committed step.

A state placed on a device mesh (``DTensor`` leaves) keeps the reference's
single-host layout (``shard_0``, leaves gathered whole as its
``device_get`` does): ``save`` gathers each leaf on every rank, rank 0
writes, and no rank goes on before the checkpoint is committed;
``restore`` reads the whole arrays and places each as the ``like`` tree's
leaf is placed. So a checkpoint saved on one mesh restores on another, or
as plain tensors, and a plain one on a mesh.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from repro_torch._tree import is_dtensor

PyTree = Any

def _walk(tree: PyTree, path=()):
    """(path, leaf) pairs in the reference's leaf order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _walk(getattr(tree, f), path + (f,))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _walk(x, path + (str(i),))
    else:
        yield path, tree


def _flatten_with_names(tree: PyTree):
    pairs = list(_walk(tree))
    return [leaf for _, leaf in pairs], ["/".join(p) for p, _ in pairs]


def _unflatten(like: PyTree, it):
    """``like``'s structure with its leaves taken from ``it`` in leaf order."""
    if like is None:
        return None
    if isinstance(like, dict):
        new = {k: _unflatten(like[k], it) for k in sorted(like)}
        return {k: new[k] for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(getattr(like, f), it) for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(x, it) for x in like)
    return next(it)


def _to_numpy(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    """A leaf as numpy (bf16 by its bits, as int16) and the dtype name the
    reference writes for it."""
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    return t.numpy(), str(t.numpy().dtype)


def _encode(leaf) -> np.ndarray:
    """Byte view: survives npz whatever the dtype (bfloat16 included)."""
    return np.atleast_1d(np.ascontiguousarray(_to_numpy(leaf)[0])).view(np.uint8)


def _decode(raw: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """Bytes -> a tensor of ``like``'s dtype, shape and device (a
    ``DTensor`` placed as ``like``)."""
    wide = torch.int16 if like.dtype == torch.bfloat16 else like.dtype
    t = torch.from_numpy(np.ascontiguousarray(raw).view(
        torch.empty(0, dtype=wide).numpy().dtype).copy())
    t = t.view(like.dtype).reshape(like.shape).to(like.device)
    if is_dtensor(like):
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(t, like.device_mesh, like.placements)
    return t


def _gathered(tree: PyTree) -> tuple[PyTree, bool]:
    """``tree`` with every ``DTensor`` leaf gathered whole (a collective:
    every rank calls it), and whether any leaf was one."""
    leaves, _ = _flatten_with_names(tree)
    if not any(is_dtensor(l) for l in leaves):
        return tree, False
    return _unflatten(tree, iter(
        l.full_tensor() if is_dtensor(l) else l for l in leaves)), True


def _writer() -> bool:
    """Whether this process writes: rank 0 of a process group, or a
    process without one."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def save_pytree(path: str, tree: PyTree, shard_id: int = 0) -> None:
    leaves, names = _flatten_with_names(tree)
    arrays = {f"leaf_{i}": _encode(l) for i, l in enumerate(leaves)}
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, f"shard_{shard_id}.npz"), **arrays)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"names": names,
                   "dtypes": [_to_numpy(l)[1] for l in leaves],
                   "shapes": [list(l.shape) for l in leaves]}, f)


def restore_pytree(path: str, like: PyTree, shard_id: int = 0) -> PyTree:
    leaves, _ = _flatten_with_names(like)
    with np.load(os.path.join(path, f"shard_{shard_id}.npz")) as z:
        cast = [_decode(z[f"leaf_{i}"], l) for i, l in enumerate(leaves)]
    return _unflatten(like, iter(cast))


class CheckpointManager:
    def __init__(self, directory: str, keep_k: int = 3, shard_id: int = 0):
        self.dir = directory
        self.keep_k = keep_k
        self.shard_id = shard_id
        os.makedirs(directory, exist_ok=True)

    # -- write --------------------------------------------------------------
    def save(self, step: int, tree: PyTree, extra: Optional[dict] = None):
        """Write ``tree`` as step ``step``. A tree of ``DTensor``s is
        gathered on every rank, written by rank 0, and every rank returns
        once it is committed."""
        final = os.path.join(self.dir, f"step_{step:08d}")
        tree, placed = _gathered(tree)
        if not placed or _writer():
            self._write(step, final, tree, extra)
        if placed:
            import torch.distributed as dist
            dist.barrier()
        return final

    def _write(self, step: int, final: str, tree: PyTree,
               extra: Optional[dict]) -> None:
        tmp = final + f".tmp-{os.getpid()}"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        save_pytree(tmp, tree, self.shard_id)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "extra": extra or {}}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        # COMMIT marker last: a checkpoint without it is invisible
        with open(os.path.join(final, "COMMIT"), "w") as f:
            f.write("ok")
        self._prune()

    def _prune(self):
        steps = self.committed_steps()
        for s in steps[:-self.keep_k] if self.keep_k > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- read ---------------------------------------------------------------
    def committed_steps(self) -> list[int]:
        out = []
        for name in sorted(os.listdir(self.dir)):
            full = os.path.join(self.dir, name)
            if (name.startswith("step_") and not name.endswith(".tmp")
                    and os.path.exists(os.path.join(full, "COMMIT"))):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.committed_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: PyTree) -> tuple[PyTree, dict]:
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        return restore_pytree(path, like, self.shard_id), meta

    def restore_latest(self, like: PyTree) -> Optional[tuple[int, PyTree, dict]]:
        step = self.latest_step()
        if step is None:
            return None
        tree, meta = self.restore(step, like)
        return step, tree, meta
