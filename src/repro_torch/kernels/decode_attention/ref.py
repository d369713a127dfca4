"""Plain PyTorch version of single-token decode attention with slot
validity (port of ``repro/kernels/decode_attention/ref.py``), fp32 math.
The CPU path runs it; on the card it serves only to check the kernel."""
from __future__ import annotations

import torch


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         valid: torch.Tensor) -> torch.Tensor:
    """q (B, 1, H, D); k/v (B, T, KV, D); valid (T,) bool/int.
    Returns (B, 1, H, D) in q's dtype."""
    b, _, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qf = q.float().reshape(b, kvh, g, d)
    kf = k.float().transpose(1, 2)                          # (B, KV, T, D)
    vf = v.float().transpose(1, 2)
    s = torch.einsum("bkgd,bktd->bkgt", qf, kf) * d ** -0.5
    s = torch.where((valid > 0)[None, None, None, :], s,
                    torch.tensor(-1e30, device=q.device))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,bktd->bkgd", w, vf)
    return o.reshape(b, 1, h, d).to(q.dtype)
