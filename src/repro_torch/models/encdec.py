"""Encoder-decoder backbone (Whisper-style). Port of
``repro/models/encdec.py``.

The conv/mel frontend is a stub, as in the reference: the inputs are
precomputed frame embeddings (B, S_enc, d_model) in the config's activation
dtype. The encoder runs ``cfg.encoder_segments`` bidirectionally: its
attention spec has ``causal=False``, so ``attn_full`` takes the plain path
even with ``use_flash`` on, as the reference does. The decoder is
``decoder_lm``'s block API (params stacked per segment, the same layer
functions) with a cross-attention after each layer, over K/V computed once
from the encoder's output; every decoder layer is an attention layer (the
cross block reuses its ``AttnSpec``).

Caches: ``{"self": [...], "cross": [...]}``, the decoder's self-attention
caches in ``decoder_lm``'s layout and the cross K/V per segment (stacked
over count), written once at prefill and only read by ``decode_step``,
which updates the self-attention caches in place. A Python loop over the
stacked blocks takes the place of the reference's ``lax.scan``.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import _device
from repro_torch.configs.base import ModelConfig, Segment
from repro_torch.models import attention as attn_mod
from repro_torch.models import decoder_lm as dlm
from repro_torch.models.common import apply_norm, cross_entropy, generator

PyTree = Any


def _per_segment(make, count: int):
    """``count`` blocks from ``make()``: the block itself, or stacked on a
    leading (count,) axis."""
    blocks = [make() for _ in range(count)]
    return blocks[0] if count == 1 else dlm._stack(blocks)


def _blocks(seg_tree, count: int) -> list:
    return [seg_tree] if count == 1 else dlm._unstack(seg_tree)


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> PyTree:
    """The decoder's params (``decoder_lm``'s tree), then ``enc_segments``,
    ``enc_norm`` and ``cross`` (one norm and attention per decoder layer,
    stacked per segment): the reference's tree, drawn from one generator
    seeded with ``seed`` on ``device``."""
    dev = _device.resolve(device)
    gen = generator(dev, seed)
    params = dlm.init_params_from(cfg, gen)
    dt = dlm._dtype(cfg)
    params["enc_segments"] = [
        _per_segment(lambda s=seg: dlm.init_block(gen, s, cfg), seg.count)
        for seg in cfg.encoder_segments]
    params["enc_norm"] = dlm._norm_params(cfg, cfg.d_model, dev)

    def cross_block(seg: Segment) -> list:
        return [{"norm": dlm._norm_params(cfg, cfg.d_model, dev),
                 "attn": attn_mod.init_attn(gen, l.attn, cfg.d_model, dt)}
                for l in seg.layers]

    params["cross"] = [_per_segment(lambda s=seg: cross_block(s), seg.count)
                       for seg in cfg.segments]
    return params


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


def encode(params, cfg: ModelConfig, frames):
    """frames: (B, S_enc, d_model) precomputed frontend embeddings."""
    b, s, _ = frames.shape
    positions = _positions(b, s, frames.device)
    policy = dlm._remat_policy(cfg, False)
    x = frames
    for seg, seg_p in zip(cfg.encoder_segments, params["enc_segments"]):
        # the reference rematerializes the scanned (count > 1) segments only
        p = policy if seg.count > 1 else ""
        for block_p in _blocks(seg_p, seg.count):
            x, _, _ = dlm._run_block(block_p, seg, cfg, x, positions, False, s,
                                     p)
    return apply_norm(params["enc_norm"], x, cfg.norm)


def _cross_kv(params, cfg: ModelConfig, enc_out):
    """Cross-attention K/V per decoder layer (the decode cache): per
    segment a list of (k, v), each (B, T, KV, D), stacked over count."""
    b, t, _ = enc_out.shape

    def one_block(block_p, seg: Segment) -> list:
        out = []
        for p, l in zip(block_p, seg.layers):
            spec = l.attn
            k = (enc_out @ p["attn"]["wk"]).reshape(b, t, spec.n_kv_heads,
                                                    spec.head_dim)
            v = (enc_out @ p["attn"]["wv"]).reshape(b, t, spec.n_kv_heads,
                                                    spec.head_dim)
            out.append((k, v))
        return out

    kvs = []
    for seg, xp in zip(cfg.segments, params["cross"]):
        blocks = [one_block(bp, seg) for bp in _blocks(xp, seg.count)]
        kvs.append(blocks[0] if seg.count == 1 else dlm._stack(blocks))
    return kvs


def _dec_block_full(block_p, block_x, block_kv, seg: Segment,
                    cfg: ModelConfig, x, positions, want_cache: bool,
                    max_len: int, remat_branches: bool = False):
    """Each layer of the block (self-attention and MLP), then its
    cross-attention. Returns (x, [caches])."""
    caches = []
    for p_i, xp_i, kv_i, layer in zip(block_p, block_x, block_kv, seg.layers):
        x, _, cache = dlm.layer_full(p_i, layer, cfg, x, positions,
                                     want_cache, max_len, remat_branches)
        h = apply_norm(xp_i["norm"], x, cfg.norm)
        x = x + attn_mod.attn_cross(xp_i["attn"], layer.attn, h, kv_i)
        caches.append(cache)
    return x, caches


def _run_dec_block(args, policy: str):
    """``_dec_block_full(*args)`` under the remat policy (see
    ``decoder_lm._remat_policy``)."""
    if policy == "nothing":
        return checkpoint(_dec_block_full, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return _dec_block_full(*args, policy == "outputs")


def _decoder_hidden(params, cfg: ModelConfig, tokens, enc_out,
                    want_cache: bool, max_len: int, cross_kv):
    """The decoder through its final norm. Returns (x, self caches)."""
    x = dlm.embed_lookup(params["embed"], tokens)
    b, s = x.shape[:2]
    positions = _positions(b, s, x.device)
    max_len = max_len or s
    if cross_kv is None:
        cross_kv = _cross_kv(params, cfg, enc_out)
    policy = dlm._remat_policy(cfg, want_cache)
    caches = []
    for seg, seg_p, xp, kv in zip(cfg.segments, params["segments"],
                                  params["cross"], cross_kv):
        if seg.count == 1:
            x, cache = _dec_block_full(seg_p, xp, kv, seg, cfg, x, positions,
                                       want_cache, max_len)
            caches.append(cache)
            continue
        seg_caches = []
        for p_i, xp_i, kv_i in zip(dlm._unstack(seg_p), dlm._unstack(xp),
                                   dlm._unstack(kv)):
            x, cache = _run_dec_block((p_i, xp_i, kv_i, seg, cfg, x,
                                       positions, want_cache, max_len), policy)
            seg_caches.append(cache)
        caches.append(dlm._stack(seg_caches))
    return apply_norm(params["final_norm"], x, cfg.norm), caches


def _decoder(params, cfg: ModelConfig, tokens, enc_out, want_cache=False,
             max_len=0, cross_kv=None):
    """(logits (B, S, V), self caches)."""
    x, caches = _decoder_hidden(params, cfg, tokens, enc_out, want_cache,
                                max_len, cross_kv)
    return dlm._logits(params, cfg, x), caches


def loss_and_metrics(params, cfg: ModelConfig, batch: dict):
    """batch: frames (B, S_enc, d), tokens (B, S_dec), labels (B, S_dec),
    tensors on the params' device. Returns (ce, {"loss", "ce", "aux"})."""
    enc_out = encode(params, cfg, batch["frames"])
    logits, _ = _decoder(params, cfg, batch["tokens"], enc_out)
    labels = batch["labels"]
    ce = cross_entropy(logits, labels.clamp(min=0), (labels >= 0).float())
    return ce, {"loss": ce, "ce": ce,
                "aux": torch.zeros((), device=ce.device)}


def prefill(params, cfg: ModelConfig, frames, tokens, max_len: int = 0):
    """Returns (logits_last (B, 1, V), {"self", "cross"} caches). The head
    runs on the last position only, as ``decoder_lm.prefill``'s does: the
    reference's ``logits[:, -1:]``."""
    enc_out = encode(params, cfg, frames)
    cross_kv = _cross_kv(params, cfg, enc_out)
    x, caches = _decoder_hidden(params, cfg, tokens, enc_out, True, max_len,
                                cross_kv)
    return dlm._logits(params, cfg, x[:, -1:]), {"self": caches,
                                                 "cross": cross_kv}


def _dec_block_decode(block_p, block_x, block_kv, block_c, seg: Segment,
                      cfg: ModelConfig, x, pos):
    for p_i, xp_i, kv_i, c_i, layer in zip(block_p, block_x, block_kv,
                                           block_c, seg.layers):
        x, _ = dlm.layer_decode(p_i, layer, cfg, x, pos, c_i)
        h = apply_norm(xp_i["norm"], x, cfg.norm)
        x = x + attn_mod.attn_cross(xp_i["attn"], layer.attn, h, kv_i)
    return x


def decode_step(params, cfg: ModelConfig, token, pos, caches):
    """token (B, 1) int; pos an int or a 0-d int32 tensor on the params'
    device (then the step can be captured in a CUDA graph). Updates the
    self-attention caches in place. Returns (logits (B, 1, V), caches)."""
    x = dlm.embed_lookup(params["embed"], token)
    for seg, seg_p, xp, kv, seg_c in zip(cfg.segments, params["segments"],
                                         params["cross"], caches["cross"],
                                         caches["self"]):
        if seg.count == 1:
            x = _dec_block_decode(seg_p, xp, kv, seg_c, seg, cfg, x, pos)
            continue
        for i in range(seg.count):
            x = _dec_block_decode(dlm._index(seg_p, i), dlm._index(xp, i),
                                  dlm._index(kv, i), dlm._index(seg_c, i),
                                  seg, cfg, x, pos)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return dlm._logits(params, cfg, x), caches
