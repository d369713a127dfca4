"""Dispatch for the GCN aggregation (port of ``repro/kernels/gcn_spmm/ops.py``).

A CUDA tensor goes to the hand-written kernel, a CPU tensor to the plain
version in ``ref.py`` (the reference's ``interpret = backend != "tpu"``
switch). A meta tensor goes to the plain version too: it computes nothing,
and a shape-only run (``analysis.program_cost``) prices the plain function's
work there. Any other device raises. The kernel masks its own ragged edges, so
unlike the TPU wrapper nothing is padded. ``force_ref=True`` (the
reference's keyword) runs the plain version on any device, CUDA included,
and launches nothing; like the reference's, it does not cast the scales.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gcn_spmm import kernel as _k
from repro_torch.kernels.gcn_spmm import ref as _ref


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type in ("cpu", "meta"):
        return False
    raise ValueError(f"gcn_spmm runs on CUDA or CPU tensors (or meta for "
                     f"pricing), got {t.device}")


def spmm(adj: torch.Tensor, feats: torch.Tensor, *,
         force_ref: bool = False) -> torch.Tensor:
    """adj (M, N) @ feats (N, D) -> (M, D)."""
    if force_ref:
        return _ref.spmm_ref(adj, feats)
    if _on_cuda(feats):
        return _k.spmm(adj, feats)
    return _ref.spmm_ref(adj, feats)


def scaled_spmm(adj: torch.Tensor, feats: torch.Tensor, row_scale: torch.Tensor,
                col_scale: torch.Tensor, *, force_ref: bool = False) -> torch.Tensor:
    """(diag(row_scale) @ adj @ diag(col_scale)) @ feats -> (M, D) in one
    fused masked-aggregate op. The scales are cast to feats' dtype first, as
    the reference wrapper does before its kernel."""
    if force_ref:
        return _ref.scaled_spmm_ref(adj, feats, row_scale, col_scale)
    r = row_scale.to(feats.dtype)
    c = col_scale.to(feats.dtype)
    if _on_cuda(feats):
        return _k.scaled_spmm(adj, feats, r, c)
    return _ref.scaled_spmm_ref(adj, feats, r, c)
