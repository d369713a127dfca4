"""Nested dicts / lists of tensors (the port's stand-in for JAX pytrees)."""
from __future__ import annotations

import numpy as np
import torch


def map_with_path(fn, tree, *rest, path=()):
    """Apply ``fn(path, leaf, *other_leaves)`` over parallel trees; ``path``
    is the tuple of dict keys and list indices leading to the leaf."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, *(r[k] for r in rest), path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_with_path(fn, v, *(r[i] for r in rest), path=path + (i,))
                for i, v in enumerate(tree)]
    return fn(path, tree, *rest)


def tree_map(fn, tree, *rest):
    return map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)


def leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def tensor_from_numpy(a, device) -> torch.Tensor:
    """One numpy leaf -> a tensor on ``device``. A bfloat16 array (the
    ``ml_dtypes`` type that ``np.asarray`` gives for a bf16 JAX array) comes
    over by bit pattern, as int16 viewed as ``torch.bfloat16``, so that
    ``ml_dtypes`` is never imported."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.as_tensor(np.array(a)).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """One tensor -> numpy. numpy has no bfloat16 of its own, so a bf16
    tensor comes back as float32, which holds every bf16 value exactly."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``DTensor`` (a tensor placed on a device mesh)."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)
