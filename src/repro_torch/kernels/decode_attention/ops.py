"""Dispatch for decode attention (port of
``repro/kernels/decode_attention/ops.py``).

A CUDA tensor goes to the hand-written kernel, a CPU tensor to the plain
version in ``ref.py``. A meta tensor goes to the plain version too: it
computes nothing, and a shape-only run (``analysis.program_cost``) prices the
plain function's work there. Any other device raises. The kernel reads a boolean
slot mask as it is, so a bool ``valid`` costs no extra launch. It leaves
slots past T out, so nothing is padded.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import kernel as _k
from repro_torch.kernels.decode_attention import ref as _ref


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """Model layout: q (B, 1, H, D); k/v (B, T, KV, D); valid (T,) bool/int.
    Returns (B, 1, H, D)."""
    if q.device.type == "cuda":
        return _k.decode_attention(
            q, k, v, valid if valid.dtype == torch.bool else valid > 0)
    if q.device.type in ("cpu", "meta"):
        return _ref.decode_attention_ref(q, k, v, valid)
    raise ValueError(f"decode_attention runs on CUDA or CPU tensors (or meta "
                     f"for pricing), got {q.device}")
