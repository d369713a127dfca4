"""Plain PyTorch versions of flash attention (port of
``repro/kernels/flash_attention/ref.py``): GQA + causal + sliding window,
fp32 math. The CPU path runs ``attention_ref``; on the card these serve
only to check the kernels. ``attention_lse_ref`` and ``attention_bwd_ref``
are the plain versions of the forward's log-sum-exp output and of the
backward kernel's function (the gradient rebuilt from the log-sum-exp, as
the kernel rebuilds it)."""
from __future__ import annotations

import torch


def _scores(q, k, causal: bool, window, scale=None):
    """Scaled scores (B, KV, S, G, T) in fp32 (by ``scale``, D^-0.5 when
    None), masked to -1e30, and the (S, T) mask."""
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, s, kvh, h // kvh, d)
    scores = torch.einsum("bskgd,btkd->bksgt", qf, k.float()) \
        * (d ** -0.5 if scale is None else scale)
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    scores = torch.where(mask[None, None, :, None, :], scores,
                         torch.tensor(-1e30, device=q.device))
    return scores, mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window=None,
                  scale: float | None = None) -> torch.Tensor:
    """q (B, S, H, D); k (B, T, KV, D), v (B, T, KV, Dv) -> (B, S, H, Dv) in
    q's dtype; ``scale`` as the kernel's."""
    b, s, h, _ = q.shape
    scores, _ = _scores(q, k, causal, window, scale)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bksgt,btkd->bskgd", w, v.float())
    return out.reshape(b, s, h, v.shape[-1]).to(q.dtype)


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
                      window=None, scale: float | None = None) -> torch.Tensor:
    """The rows' log-sum-exp of the scaled, masked scores: fp32 (B, H, S),
    head kvh * G + g, as the forward kernel returns it; ``scale`` as the
    kernel's."""
    b, s, h, _ = q.shape
    scores, _ = _scores(q, k, causal, window, scale)
    lse = torch.logsumexp(scores, dim=-1)               # (B, KV, S, G)
    return lse.permute(0, 1, 3, 2).reshape(b, h, s)


def attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                      window=None):
    """(dq, dk, dv) of ``attention_ref`` from its output ``o`` and the
    log-sum-exp ``lse``, in fp32 math: P = exp(s - lse) on visible pairs,
    delta = rowsum(dO o O), dS = P (dP - delta). A row that sees no key
    (its output the uniform average over the T keys) adds dO / T to every
    key's dV and nothing to dQ and dK, as autograd of ``attention_ref``
    gives. Returns each in its input's dtype and layout."""
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = d ** -0.5
    scores, mask = _scores(q, k, causal, window)
    lse_r = lse.float().reshape(b, kvh, g, s).permute(0, 1, 3, 2)
    p = torch.where(mask[None, None, :, None, :],
                    torch.exp(scores - lse_r[..., None]),
                    torch.zeros((), device=q.device))
    qf = q.float().reshape(b, s, kvh, g, d)
    dof = do.float().reshape(b, s, kvh, g, d)
    delta = (dof * o.float().reshape(b, s, kvh, g, d)).sum(-1)   # (B, S, KV, G)
    dp = torch.einsum("bskgd,btkd->bksgt", dof, v.float())
    ds = p * (dp - delta.permute(0, 2, 1, 3)[..., None])
    dq = torch.einsum("bksgt,btkd->bskgd", ds, k.float()) * scale
    dk = torch.einsum("bksgt,bskgd->btkd", ds, qf) * scale
    nokey = ~mask.any(-1)                                        # (S,)
    p = p + (nokey.float() / t)[None, None, :, None, None]
    dv = torch.einsum("bksgt,bskgd->btkd", p, dof)
    return (dq.reshape(b, s, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
