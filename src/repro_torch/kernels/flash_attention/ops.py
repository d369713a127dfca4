"""Dispatch for flash attention (port of
``repro/kernels/flash_attention/ops.py``).

A CUDA tensor goes to the hand-written kernel, a CPU tensor to the plain
version in ``ref.py`` (the reference's ``interpret = backend != "tpu"``
switch). Any other device raises. The kernel reads the model layout and
masks its own ragged edges, so unlike the TPU wrapper nothing is transposed
or padded.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel as _k
from repro_torch.kernels.flash_attention import ref as _ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None) -> torch.Tensor:
    """Model layout: q (B, S, H, D); k/v (B, T, KV, D) -> (B, S, H, D)."""
    if q.device.type == "cuda":
        return _k.flash_attention(q, k, v, causal=causal, window=window)
    if q.device.type == "cpu":
        return _ref.attention_ref(q, k, v, causal=causal, window=window)
    raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got {q.device}")
