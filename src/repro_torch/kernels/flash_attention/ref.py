"""Plain PyTorch version of flash attention (port of
``repro/kernels/flash_attention/ref.py``): GQA + causal + sliding window,
fp32 math. The CPU path runs it; on the card it serves only to check the
kernel."""
from __future__ import annotations

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window=None) -> torch.Tensor:
    """q (B, S, H, D); k/v (B, T, KV, D) -> (B, S, H, D) in q's dtype."""
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qf = q.float().reshape(b, s, kvh, g, d)
    scores = torch.einsum("bskgd,btkd->bksgt", qf, k.float()) * d ** -0.5
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    scores = torch.where(mask[None, None, :, None, :], scores,
                         torch.tensor(-1e30, device=q.device))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bksgt,btkd->bskgd", w, v.float())
    return out.reshape(b, s, h, d).to(q.dtype)
