"""Attention layers: GQA (sliding window, qk-norm) with full and ring KV
caches, the encoder-decoder's cross-attention, and DeepSeek-style MLA with
its compressed cache. Port of ``repro/models/attention.py``.

Two execution paths per layer:
  * full sequence (prefill): GQA through the hand-written flash-attention
    kernel when ``RUNTIME["use_flash"]`` is on (its plain version for CPU
    tensors), else the grouped einsum or the q-chunked form; MLA through
    the same flash forward when ``use_flash`` is on and no gradient is
    wanted (the serving prefill: q and k at nope + rope, v widened to it),
    else as plain einsums (the reference has no kernel for it), q-chunked
    under ``q_chunk``;
  * one-token decode against a cache: GQA's full or ring (sliding window)
    cache through the decode-attention kernel when ``use_flash`` is on;
    MLA's compressed cache in the plain or the absorbed matmul order.

Cross-attention (``attn_cross``, the Whisper decoder) reads K/V computed
once from the encoder's output, with every encoder position visible. It is
plain for the full sequence and the one-token step alike: the reference has
no kernel for it.

Shapes: x (B, S, d_model); q (B, S, H, D); k/v (B, T, KV, D). The decode
step writes the new entries into the cache in place, the torch form of the
reference's donated cache (``launch/serve.py``): ``attn_decode`` and
``mla_decode`` return the same dict they were given.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import AttnSpec, MLASpec
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import common as cc
from repro_torch.models.common import RUNTIME as FLAGS  # launcher-set knobs
from repro_torch.models.common import (apply_norm, apply_rope, causal_mask,
                                       dense_init, logical_constraint)

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
    q = logical_constraint(q, cc.BATCH, None, cc.HEADS, None)
    k = logical_constraint(k, cc.BATCH, None, cc.HEADS, None)
    v = logical_constraint(v, cc.BATCH, None, cc.HEADS, None)
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
    y = logical_constraint(y, cc.BATCH, cc.SEQ, cc.EMBED)
    if return_kv:
        return y, (k, v)
    return y


def attn_cross(p, spec: AttnSpec, x, kv_cache):
    """Cross-attention (Whisper decoder): K, V precomputed from the encoder.
    x (B, S, d); kv_cache (k, v), each (B, T, KV, D). No RoPE on the query
    and no mask: every encoder position is visible."""
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, spec.n_heads, spec.head_dim)
    k, v = kv_cache
    mask = torch.ones((b, s, k.shape[1]), dtype=torch.bool, device=x.device)
    out = _gqa_attend(q, k, v, mask)
    return out.reshape(b, s, -1) @ p["wo"]


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


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): low-rank Q and compressed KV with decoupled RoPE.
# ---------------------------------------------------------------------------
def init_mla(gen: torch.Generator, spec: MLASpec, d_model: int, dtype) -> dict:
    """MLA's params: q through the LoRA pair ``wq_a`` / ``q_norm`` / ``wq_b``,
    or without q compression (``q_lora_rank`` None, the port-only
    DeepSeek-V2-Lite) one ``wq``."""
    h = spec.n_heads
    qd = spec.qk_nope_dim + spec.qk_rope_dim
    if spec.q_lora_rank is None:
        q = {"wq": dense_init(gen, d_model, h * qd, dtype)}
    else:
        q = {"wq_a": dense_init(gen, d_model, spec.q_lora_rank, dtype),
             "q_norm": {"scale": torch.ones((spec.q_lora_rank,),
                                            device=gen.device)},
             "wq_b": dense_init(gen, spec.q_lora_rank, h * qd, dtype)}
    return {
        **q,
        "wkv_a": dense_init(gen, d_model,
                            spec.kv_lora_rank + spec.qk_rope_dim, dtype),
        "kv_norm": {"scale": torch.ones((spec.kv_lora_rank,),
                                        device=gen.device)},
        "wkv_b": dense_init(gen, spec.kv_lora_rank,
                            h * (spec.qk_nope_dim + spec.v_head_dim), dtype),
        "wo": dense_init(gen, h * spec.v_head_dim, d_model, dtype),
    }


def mla_softmax_scale(spec: MLASpec) -> float:
    """(nope + rope)^-0.5; under YaRN times mscale(``mscale_all_dim``)^2, as
    DeepSeek-V2 scales it (192^-0.5 x 1.5896 at DeepSeek-V2-Lite)."""
    scale = (spec.qk_nope_dim + spec.qk_rope_dim) ** -0.5
    sc = spec.rope_scaling
    if sc is not None and sc.mscale_all_dim:
        m = cc.yarn_mscale(sc.factor, sc.mscale_all_dim)
        scale = scale * m * m
    return scale


def _mla_q(p, spec: MLASpec, x, positions):
    b, s, _ = x.shape
    if spec.q_lora_rank is None:
        q = x @ p["wq"]
    else:
        q = apply_norm(p["q_norm"], x @ p["wq_a"], "rmsnorm") @ p["wq_b"]
    q = q.reshape(b, s, spec.n_heads, spec.qk_nope_dim + spec.qk_rope_dim)
    q_nope, q_rope = q.split([spec.qk_nope_dim, spec.qk_rope_dim], dim=-1)
    return q_nope, apply_rope(q_rope, positions, spec.rope_theta,
                              spec.rope_scaling)


def _mla_ckv(p, spec: MLASpec, x, positions):
    """Returns (normalized compressed kv (B,S,L), rotated shared k_rope
    (B,S,R))."""
    c_kv, k_rope = (x @ p["wkv_a"]).split(
        [spec.kv_lora_rank, spec.qk_rope_dim], dim=-1)
    c_kv = apply_norm(p["kv_norm"], c_kv, "rmsnorm")
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        spec.rope_theta, spec.rope_scaling)[:, :, 0, :]
    return c_kv, k_rope


def _mla_chunked(q_nope, q_rope, k_nope, k_rope, v, scale, q_chunk: int,
                 dtype):
    """q-block chunked MLA attention: one (bq, T) score tile per chunk
    (k_rope is shared across heads, so it never repeats). Scores accumulate
    in fp32, as the reference's ``preferred_element_type``."""
    b, s = q_nope.shape[:2]
    t = k_nope.shape[1]
    k_nope, k_rope = k_nope.float(), k_rope.float()
    kpos = torch.arange(t, dtype=torch.int32, device=q_nope.device)
    outs = []
    for q0 in range(0, s, q_chunk):
        qpos = q0 + torch.arange(q_chunk, dtype=torch.int32,
                                 device=q_nope.device)
        scores = (torch.einsum("bqhn,bthn->bhqt",
                               q_nope[:, q0:q0 + q_chunk].float(), k_nope)
                  + torch.einsum("bqhr,btr->bhqt",
                                 q_rope[:, q0:q0 + q_chunk].float(),
                                 k_rope)) * scale
        scores = scores.masked_fill(~(kpos[None, :] <= qpos[:, None]),
                                    NEG_INF)
        w = torch.softmax(scores, dim=-1).to(dtype)
        outs.append(torch.einsum("bhqt,bthd->bqhd", w, v))
    return torch.cat(outs, dim=1).reshape(b, s, -1)


def _mla_flash(q_nope, q_rope, k_nope, k_rope, v, scale):
    """MLA attention through the flash forward kernel (its plain version on
    CPU tensors): q and k at nope + rope (k_rope shared by the heads,
    broadcast), v at its own width, read in place (a column slice of the
    up-projection). No (B, H, S, S) scores exist."""
    b, s, h, dv = v.shape
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, -1)], dim=-1)
    out = flash_ops.flash_attention(q, k, v, scale=scale)
    return out.reshape(b, s, h * dv)


def mla_full(p, spec: MLASpec, x, positions, return_ckv: bool = False):
    """Full-sequence MLA in the plain order (K and V expanded from the
    compressed cache). With ``use_flash`` on and no gradient wanted (the
    serving prefill) the attention runs through the flash forward kernel
    (``_mla_flash``); else q-chunked under ``q_chunk``, else one einsum.
    ``return_ckv``: also (normalized compressed kv, rotated k_rope), what
    the decode cache holds."""
    b, s, _ = x.shape
    h = spec.n_heads
    q_nope, q_rope = _mla_q(p, spec, x, positions)
    c_kv, k_rope = _mla_ckv(p, spec, x, positions)
    kv = (c_kv @ p["wkv_b"]).reshape(b, s, h,
                                     spec.qk_nope_dim + spec.v_head_dim)
    k_nope, v = kv.split([spec.qk_nope_dim, spec.v_head_dim], dim=-1)
    k_nope = logical_constraint(k_nope, cc.BATCH, None, cc.HEADS, None)
    v = logical_constraint(v, cc.BATCH, None, cc.HEADS, None)
    scale = mla_softmax_scale(spec)
    q_chunk = FLAGS["q_chunk"]
    if FLAGS["use_flash"] and not torch.is_grad_enabled():
        out = _mla_flash(q_nope, q_rope, k_nope, k_rope, v, scale)
    elif q_chunk and s % q_chunk == 0 and s > q_chunk:
        out = _mla_chunked(q_nope, q_rope, k_nope, k_rope, v, scale, q_chunk,
                           x.dtype)
    else:
        scores = (torch.einsum("bshd,bthd->bhst", q_nope, k_nope)
                  + torch.einsum("bshr,btr->bhst", q_rope, k_rope)).float()
        scores = scores * scale
        mask = causal_mask(positions, positions)
        scores = scores.masked_fill(~(mask[:, None] if mask.dim() == 3
                                      else mask[None, None]), NEG_INF)
        w = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.einsum("bhst,bthd->bshd", w, v).reshape(b, s, -1)
    y = out @ p["wo"]
    return (y, (c_kv, k_rope)) if return_ckv else y


def init_mla_cache(spec: MLASpec, batch: int, max_len: int, dtype,
                   device) -> dict:
    """The MLA win: cache only (kv_lora_rank + rope_dim) per token."""
    return {
        "ckv": torch.zeros((batch, max_len, spec.kv_lora_rank), dtype=dtype,
                           device=device),
        "k_rope": torch.zeros((batch, max_len, spec.qk_rope_dim), dtype=dtype,
                              device=device),
    }


def mla_prefill(p, spec: MLASpec, x, positions, max_len: int):
    s = x.shape[1]
    y, (c_kv, k_rope) = mla_full(p, spec, x, positions, return_ckv=True)
    cache = init_mla_cache(spec, x.shape[0], max_len, x.dtype, x.device)
    cache["ckv"][:, :s] = c_kv
    cache["k_rope"][:, :s] = k_rope
    return y, cache


def mla_decode(p, spec: MLASpec, x, pos, cache: dict, absorb: bool = False):
    """One-token MLA decode at ``pos`` (an int or a 0-d int32 tensor on x's
    device). Writes the token's compressed entries into ``cache`` in place
    (``index_copy_`` at the tensor position; the validity mask compares
    with it, so a captured step replays at later positions). Returns
    (y, cache). absorb=True uses the matmul-absorbed order, which never
    re-expands K/V over the whole cache."""
    b = x.shape[0]
    h = spec.n_heads
    if not isinstance(pos, torch.Tensor):
        pos = torch.full((), pos, dtype=torch.int32, device=x.device)
    positions = pos.view(1, 1).expand(b, 1)
    q_nope, q_rope = _mla_q(p, spec, x, positions)            # (B,1,H,*)
    c_new, r_new = _mla_ckv(p, spec, x, positions)            # (B,1,L),(B,1,R)
    slot = pos.long().view(1)
    cache["ckv"].index_copy_(1, slot, c_new)
    cache["k_rope"].index_copy_(1, slot, r_new)
    ckv, k_rope = cache["ckv"], cache["k_rope"]

    t = ckv.shape[1]
    valid = torch.arange(t, device=x.device) <= pos
    scale = mla_softmax_scale(spec)
    wkv_b = p["wkv_b"].reshape(spec.kv_lora_rank, h,
                               spec.qk_nope_dim + spec.v_head_dim)
    w_k = wkv_b[..., :spec.qk_nope_dim]    # (L,H,N)
    w_v = wkv_b[..., spec.qk_nope_dim:]    # (L,H,V)

    if absorb:
        q_eff = torch.einsum("bqhn,lhn->bqhl", q_nope, w_k)   # (B,1,H,L)
        scores = (torch.einsum("bqhl,btl->bhqt", q_eff, ckv)
                  + torch.einsum("bqhr,btr->bhqt", q_rope, k_rope))
    else:
        kv = (ckv @ p["wkv_b"]).reshape(b, t, h,
                                        spec.qk_nope_dim + spec.v_head_dim)
        k_nope, v_full = kv.split([spec.qk_nope_dim, spec.v_head_dim], dim=-1)
        scores = (torch.einsum("bqhn,bthn->bhqt", q_nope, k_nope)
                  + torch.einsum("bqhr,btr->bhqt", q_rope, k_rope))
    scores = scores.float() * scale
    scores = scores.masked_fill(~valid, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(x.dtype)

    if absorb:
        ctx = torch.einsum("bhqt,btl->bqhl", w, ckv)          # (B,1,H,L)
        out = torch.einsum("bqhl,lhv->bqhv", ctx, w_v)
    else:
        out = torch.einsum("bhqt,bthv->bqhv", w, v_full)
    y = out.reshape(b, 1, -1) @ p["wo"]
    return y, cache
