"""Dispatch for decode attention (port of
``repro/kernels/decode_attention/ops.py``).

A CUDA tensor goes to the hand-written kernel, a CPU tensor to the plain
version in ``ref.py``. A meta tensor goes to the plain version too: it
computes nothing, and a shape-only run (``analysis.program_cost``) prices the
plain function's work there. Any other device raises. The kernel reads a boolean
slot mask as it is, so a bool ``valid`` costs no extra launch. It leaves
slots past T out, so nothing is padded.

The reference's keywords: ``force_ref=True`` runs the plain version on any
device, CUDA included, and launches nothing; ``block_kv`` (the reference's
``DEFAULT_BLOCK_KV``, 512) must be a positive int, as the reference's tiling
needs; the kernel splits the cache over a thread-block cluster by its own
rule, so it is checked and not used.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import check_block
from repro_torch.kernels.decode_attention import kernel as _k
from repro_torch.kernels.decode_attention import ref as _ref

DEFAULT_BLOCK_KV = 512   # the reference's kernel.DEFAULT_BLOCK_KV


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor, *, block_kv: int = DEFAULT_BLOCK_KV,
                     force_ref: bool = False) -> torch.Tensor:
    """Model layout: q (B, 1, H, D); k/v (B, T, KV, D); valid (T,) bool/int.
    Returns (B, 1, H, D)."""
    if force_ref:
        return _ref.decode_attention_ref(q, k, v, valid)
    if q.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"decode_attention runs on CUDA or CPU tensors (or "
                         f"meta for pricing), got {q.device}")
    check_block(block_kv, "block_kv")
    if q.device.type == "cuda":
        return _k.decode_attention(
            q, k, v, valid if valid.dtype == torch.bool else valid > 0)
    return _ref.decode_attention_ref(q, k, v, valid)
