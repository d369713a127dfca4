"""Dispatch for flash attention (port of
``repro/kernels/flash_attention/ops.py``).

A CUDA tensor goes to the hand-written kernel, a CPU tensor to the plain
version in ``ref.py`` (the reference's ``interpret = backend != "tpu"``
switch). A meta tensor goes to the plain version too: it computes nothing,
and a shape-only run (``analysis.program_cost``) prices the plain function's
work there. Any other device raises. The kernel reads the model layout and
masks its own ragged edges, so unlike the TPU wrapper nothing is transposed
or padded.

Training: on a CUDA tensor that requires grad the call goes through
``FlashAttention``, an ``autograd.Function`` whose forward is the kernel
(keeping the rows' log-sum-exp) and whose backward is the hand-written
backward kernel. On the CPU the plain version's own autograd gives the
gradient, as ``jax.grad`` of the reference's function does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel as _k
from repro_torch.kernels.flash_attention import ref as _ref


class FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v) with the kernels on both passes. The kernels
    see detached tensors (their wrappers refuse inputs that require grad).
    q, k, v, o and the log-sum-exp go through ``save_for_backward``, so
    under ``torch.utils.checkpoint`` the recomputed forward's tensors, its
    log-sum-exp among them, are the ones the backward reads."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window):
        o, lse = _k.flash_attention(q.detach(), k.detach(), v.detach(),
                                    causal=causal, window=window,
                                    return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _k.flash_attention_bwd(
            q.detach(), k.detach(), v.detach(), o.detach(), lse,
            do.detach().contiguous(), causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None) -> torch.Tensor:
    """Model layout: q (B, S, H, D); k/v (B, T, KV, D) -> (B, S, H, D)."""
    if q.device.type == "cuda":
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return FlashAttention.apply(q, k, v, causal, window)
        return _k.flash_attention(q, k, v, causal=causal, window=window)
    if q.device.type in ("cpu", "meta"):
        return _ref.attention_ref(q, k, v, causal=causal, window=window)
    raise ValueError(f"flash_attention runs on CUDA or CPU tensors (or meta "
                     f"for pricing), got {q.device}")
