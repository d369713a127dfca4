"""The plain reference of the decoder LMs the benchmark runs.

Plain PyTorch in float32 (TF32 off, ``fp32_matmuls``), written from the
configuration files under ``bench/configs``: token embedding, then per
layer an RMSNorm, attention (RoPE with the half-rotation convention,
optional per-head RMSNorm of q and k, causal softmax over the earlier
positions, grouped heads) and a residual add, an RMSNorm and a SwiGLU MLP,
then a final RMSNorm and the head. With a ``sliding_window`` of w, a query
at position i sees the keys at positions i - w + 1 .. i. It imports
nothing of the program. Weights come from an accessor ``W(name, layer)``
that returns float32 tensors (``bench/weights.py`` leaf names).

``precision="fp8"`` is the control, the step below the configuration's
bfloat16: every projection (attention, MLP, head) as float8 training and
serving run it, operands in e4m3 and gradients in e5m2, one scale per
tensor; the norms and softmax stay in float32.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Q_BLOCK = 512


@contextlib.contextmanager
def fp32_matmuls():
    """Full float32 matmuls: TF32 off for the block's duration."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _q(t: torch.Tensor, dtype) -> torch.Tensor:
    """t rounded to a float8 type with one scale for the whole tensor."""
    top = torch.finfo(dtype).max
    scale = t.abs().amax().clamp(min=1e-30) / top
    return (t / scale).to(dtype).float() * scale


class _FP8Matmul(torch.autograd.Function):
    """x @ w as float8 training runs it: both operands in e4m3, the
    incoming gradient in e5m2, a scale per tensor; the products in float32."""

    @staticmethod
    def forward(ctx, x, w):
        xq, wq = _q(x, torch.float8_e4m3fn), _q(w, torch.float8_e4m3fn)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, gy):
        xq, wq = ctx.saved_tensors
        g = _q(gy, torch.float8_e5m2)
        gw = xq.reshape(-1, xq.shape[-1]).T @ g.reshape(-1, g.shape[-1])
        return g @ wq.T, gw


def linear(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        return _FP8Matmul.apply(x, w)
    return x @ w


def rmsnorm(x, scale, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, pos, theta: float):
    """x: (..., T, heads, D); pos: (T,) int."""
    half = x.shape[-1] // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
    ang = pos.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend_block(q, k, v, q0: int, k0: int, window):
    """Attention of the queries at positions q0.. over the keys at k0..:
    q (Tq, H, D); k, v (Tk, H, D) with k0 + Tk = q0 + Tq."""
    s = torch.einsum("qhd,khd->hqk", q, k) * q.shape[-1] ** -0.5
    qpos = q0 + torch.arange(q.shape[0], device=q.device)
    kpos = k0 + torch.arange(k.shape[0], device=q.device)
    hide = kpos[None, :] > qpos[:, None]
    if window is not None:
        hide |= kpos[None, :] <= qpos[:, None] - window
    s = s.masked_fill(hide[None], float("-inf"))
    return torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v)


def attention(q, k, v, window=None):
    """q (R, T, H, D); k, v (R, T, KV, D). Causal, within ``window`` if
    set, grouped heads; one row and one block of queries at a time, over
    the keys the block can see (each block under a checkpoint when a
    backward follows, so one block's probabilities live at once)."""
    r, t, h, _ = q.shape
    g = h // k.shape[2]
    k, v = k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)
    rows = []
    for i in range(r):
        blocks = []
        for q0 in range(0, t, Q_BLOCK):
            q1 = min(t, q0 + Q_BLOCK)
            k0 = 0 if window is None else max(0, q0 - window + 1)
            args = (q[i, q0:q1], k[i, k0:q1], v[i, k0:q1], q0, k0, window)
            blocks.append(checkpoint(_attend_block, *args, use_reentrant=False)
                          if torch.is_grad_enabled() else _attend_block(*args))
        rows.append(torch.cat(blocks, dim=0))
    return torch.stack(rows)


def mlp(h, W, layer: int, precision: str):
    a = F.silu(linear(h, W("layers.mlp.w_gate", layer), precision)) \
        * linear(h, W("layers.mlp.w_up", layer), precision)
    return linear(a, W("layers.mlp.w_down", layer), precision)


def block(x, cfg: dict, W, layer: int, precision: str):
    """One layer over x (R, T, d)."""
    r, t, _ = x.shape
    hn, kvn, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                   cfg["head_dim"])
    eps = cfg["rms_norm_eps"]
    pos = torch.arange(t, device=x.device)
    h = rmsnorm(x, W("layers.norm1.scale", layer), eps)
    q = linear(h, W("layers.attn.wq", layer), precision).view(r, t, hn, hd)
    k = linear(h, W("layers.attn.wk", layer), precision).view(r, t, kvn, hd)
    v = linear(h, W("layers.attn.wv", layer), precision).view(r, t, kvn, hd)
    if cfg.get("qk_norm"):
        q = rmsnorm(q, W("layers.attn.q_norm.scale", layer), eps)
        k = rmsnorm(k, W("layers.attn.k_norm.scale", layer), eps)
    q, k = rope(q, pos, cfg["rope_theta"]), rope(k, pos, cfg["rope_theta"])
    o = attention(q, k, v, cfg["sliding_window"]).reshape(r, t, hn * hd)
    x = x + linear(o, W("layers.attn.wo", layer), precision)
    h = rmsnorm(x, W("layers.norm2.scale", layer), eps)
    return x + mlp(h, W, layer, precision)


def hidden(tokens, cfg: dict, W, precision: str = "fp32", remat: bool = False):
    """tokens (R, T) -> the final normed hidden (R, T, d). With ``remat``
    each layer runs under a checkpoint."""
    x = W("embed", None)[tokens]
    for layer in range(cfg["num_hidden_layers"]):
        if remat and torch.is_grad_enabled():
            x = checkpoint(block, x, cfg, W, layer, precision,
                           use_reentrant=False)
        else:
            x = block(x, cfg, W, layer, precision)
    return rmsnorm(x, W("final_norm.scale", None), cfg["rms_norm_eps"])


def head(x, cfg: dict, W, precision: str = "fp32"):
    w = W("embed", None).T if cfg["tie_word_embeddings"] else W("lm_head", None)
    return linear(x, w, precision)


@torch.no_grad()
def served_logits(prompts, served, cfg: dict, W, precision: str = "fp32"):
    """The logits from which each served token was chosen: prompts (R, P)
    and served (R, G) -> (R, G, vocab), the head at positions P-1 ..
    P+G-2 of prompt + served[:, :-1]."""
    p, g = prompts.shape[1], served.shape[1]
    tokens = torch.cat([prompts, served[:, :-1]], dim=1)
    x = hidden(tokens, cfg, W, precision)
    return head(x[:, p - 1:p + g - 1], cfg, W, precision)
