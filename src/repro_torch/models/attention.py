"""GQA attention (sliding window, qk-norm) with full and ring KV caches.
Port of the GQA half of ``repro/models/attention.py``; MLA and
``attn_cross`` wait for the slices that serve DeepSeek-V2 and Whisper.

Two execution paths per layer:
  * full sequence (prefill): the hand-written flash-attention kernel when
    ``RUNTIME["use_flash"]`` is on (its plain version for CPU tensors),
    else the grouped einsum or the q-chunked form;
  * one-token decode against a KV cache, full or ring (sliding window),
    through the decode-attention kernel when ``use_flash`` is on.

Shapes: x (B, S, d_model); q (B, S, H, D); k/v (B, T, KV, D). The decode
step writes the new K/V into the cache in place, the torch form of the
reference's donated cache (``launch/serve.py``): ``attn_decode`` returns
the same dict it was given.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import AttnSpec
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.common import RUNTIME as FLAGS  # launcher-set knobs
from repro_torch.models.common import (apply_norm, apply_rope, causal_mask,
                                       dense_init)

NEG_INF = -1e30


def init_attn(gen: torch.Generator, spec: AttnSpec, d_model: int, dtype) -> dict:
    h, kv, dh = spec.n_heads, spec.n_kv_heads, spec.head_dim
    p = {
        "wq": dense_init(gen, d_model, h * dh, dtype),
        "wk": dense_init(gen, d_model, kv * dh, dtype),
        "wv": dense_init(gen, d_model, kv * dh, dtype),
        "wo": dense_init(gen, h * dh, d_model, dtype),
    }
    if spec.qk_norm:
        p["q_norm"] = {"scale": torch.ones((dh,), device=gen.device)}
        p["k_norm"] = {"scale": torch.ones((dh,), device=gen.device)}
    return p


def _project_qkv(p, spec: AttnSpec, x, positions):
    b, s, _ = x.shape
    h, kv, dh = spec.n_heads, spec.n_kv_heads, spec.head_dim
    q = (x @ p["wq"]).reshape(b, s, h, dh)
    k = (x @ p["wk"]).reshape(b, s, kv, dh)
    v = (x @ p["wv"]).reshape(b, s, kv, dh)
    if spec.qk_norm:
        q = apply_norm(p["q_norm"], q, "rmsnorm")
        k = apply_norm(p["k_norm"], k, "rmsnorm")
    if spec.use_rope:
        q = apply_rope(q, positions, spec.rope_theta)
        k = apply_rope(k, positions, spec.rope_theta)
    return q, k, v


def _gqa_attend(q, k, v, mask):
    """q: (B,S,H,D) k/v: (B,T,KV,D); grouped einsum, no KV repetition."""
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, s, kvh, g, dh)
    scores = torch.einsum("bskgd,btkd->bksgt", qg, k).float()
    scores = scores * dh ** -0.5
    m = mask[:, None, :, None, :] if mask.dim() == 3 \
        else mask[None, None, :, None, :]
    scores = scores.masked_fill(~m, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bksgt,btkd->bskgd", w, v)
    return out.reshape(b, s, h, dh)


def _chunked_attend(q, k, v, spec: AttnSpec, q_chunk: int):
    """q-block attention: only a (bq, T) score tile per chunk is live.
    q: (B, S, H, D); k/v: (B, T, KV, D). S % q_chunk == 0 (callers pad)."""
    b, s, h, dh = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    kr = k.repeat_interleave(g, dim=2)              # (B, T, H, D)
    vr = v.repeat_interleave(g, dim=2)
    kpos = torch.arange(t, dtype=torch.int32, device=q.device)
    outs = []
    for q0 in range(0, s, q_chunk):
        qpos = q0 + torch.arange(q_chunk, dtype=torch.int32, device=q.device)
        scores = torch.einsum("bqhd,bthd->bhqt", q[:, q0:q0 + q_chunk],
                              kr).float() * dh ** -0.5
        if spec.causal:
            m = kpos[None, :] <= qpos[:, None]
            if spec.window is not None:
                m &= kpos[None, :] > (qpos[:, None] - spec.window)
            scores = scores.masked_fill(~m[None, None], NEG_INF)
        w = torch.softmax(scores, dim=-1).to(q.dtype)
        outs.append(torch.einsum("bhqt,bthd->bqhd", w, vr))
    return torch.cat(outs, dim=1)


def attn_full(p, spec: AttnSpec, x, positions, return_kv: bool = False):
    """Training / prefill self-attention (causal unless spec.causal=False)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, spec, x, positions)
    q_chunk = FLAGS["q_chunk"]
    if FLAGS["use_flash"] and spec.causal:
        out = flash_ops.flash_attention(q, k, v, window=spec.window)
    elif q_chunk and s % q_chunk == 0 and s > q_chunk:
        out = _chunked_attend(q, k, v, spec, q_chunk)
    else:
        if spec.causal:
            mask = causal_mask(positions, positions, spec.window)
        else:
            shape = (s, s) if positions.dim() == 1 else (b, s, s)
            mask = torch.ones(shape, dtype=torch.bool, device=x.device)
        out = _gqa_attend(q, k, v, mask)
    y = out.reshape(b, s, -1) @ p["wo"]
    if return_kv:
        return y, (k, v)
    return y


# -- KV caches ---------------------------------------------------------------
def cache_len(spec: AttnSpec, max_len: int) -> int:
    return max_len if spec.window is None else min(spec.window, max_len)


def init_cache(spec: AttnSpec, batch: int, max_len: int, dtype,
               device) -> dict:
    """Full cache, or ring cache bounded at the sliding window."""
    t = cache_len(spec, max_len)
    kv, dh = spec.n_kv_heads, spec.head_dim
    cache = {
        "k": torch.zeros((batch, t, kv, dh), dtype=dtype, device=device),
        "v": torch.zeros((batch, t, kv, dh), dtype=dtype, device=device),
    }
    if spec.window is not None:
        # per-slot absolute positions (-1 = empty)
        cache["slot_pos"] = torch.full((t,), -1, dtype=torch.int32,
                                       device=device)
    return cache


def attn_prefill(p, spec: AttnSpec, x, positions, max_len: int):
    """Full forward that also fills the decode cache. Assumes positions are
    0..S-1 (no padding). Returns (y, cache)."""
    b, s, _ = x.shape
    y, (k, v) = attn_full(p, spec, x, positions, return_kv=True)
    cache = init_cache(spec, b, max_len, x.dtype, x.device)
    if spec.window is None:
        cache["k"][:, :s] = k
        cache["v"][:, :s] = v
    else:
        # last min(S, W) tokens land in their ring slots
        w = cache["k"].shape[1]
        take = min(s, w)
        idx = torch.arange(s - take, s, dtype=torch.int32, device=x.device)
        slots = (idx % w).long()
        cache["k"][:, slots] = k[:, s - take:]
        cache["v"][:, slots] = v[:, s - take:]
        cache["slot_pos"][slots] = idx
    return y, cache


def attn_decode(p, spec: AttnSpec, x, pos, cache: dict):
    """One-token decode. x: (B,1,d); pos: the current position, an int or a
    0-d int32 tensor on x's device (the reference's traced scalar). Writes
    the new K/V into ``cache`` in place. Returns (y, cache).

    Nothing here reads a value back to the host, so the step can be
    captured in a CUDA graph and replayed at later positions: an int pos
    becomes a 0-d tensor by a fill on the device, the slot is written with
    ``index_copy_`` and the masks are built from tensors."""
    b = x.shape[0]
    if not isinstance(pos, torch.Tensor):
        pos = torch.full((), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, spec, x, pos.view(1, 1).expand(b, 1))

    t = cache["k"].shape[1]
    slot = (pos if spec.window is None else pos % t).long().view(1)
    cache["k"].index_copy_(1, slot, k_new)
    cache["v"].index_copy_(1, slot, v_new)
    if spec.window is None:
        valid = torch.arange(t, device=x.device) <= pos
    else:
        cache["slot_pos"].index_copy_(0, slot, pos.view(1))
        slot_pos = cache["slot_pos"]
        valid = (slot_pos >= 0) & (slot_pos <= pos) \
            & (slot_pos > pos - spec.window)

    if FLAGS["use_flash"]:
        out = dec_ops.decode_attention(q, cache["k"], cache["v"], valid)
    else:
        out = _gqa_attend(q, cache["k"], cache["v"], valid[None, None, :])
    y = out.reshape(b, 1, -1) @ p["wo"]
    return y, cache
