"""Generic decoder-only LM over config segments. Port of
``repro/models/decoder_lm.py``.

A segment is ``count`` repetitions of a *block* of layers, possibly
heterogeneous (Jamba's 7 Mamba + 1 attention, Gemma-3's 5 local + 1
global, xLSTM's mLSTM + sLSTM). Segment parameters are a list (one entry
per layer-in-block) of layer param dicts; for count > 1 every leaf has a
leading (count,) axis, as in the reference, so weights carry across one
to one. Caches mirror that
layout. A Python loop over the (count,) axis takes the place of the
reference's ``lax.scan``; indexing gives views, so a decode step writes each
layer's cache entries (K/V, MLA's compressed KV, Mamba's and xLSTM's
recurrent states) into the stacked cache in place.

Entry points: ``init_params``, ``init_caches``, ``forward``,
``loss_and_metrics`` (the training objective), ``prefill`` and
``decode_step``; ``params_from_numpy`` / ``params_to_numpy`` carry weights
across from the reference. Every layer kind of the reference runs: ``attn``,
``mla``, ``mamba``, ``mlstm`` and ``slstm`` sequence mixers, each followed
by a ``dense`` MLP, a ``moe`` layer (whose aux loss joins the training
objective) or nothing.

Training memory, as in the reference: with ``cfg.remat`` each block runs
under ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of the
scan body, see ``_remat_policy``), and a long sequence's cross-entropy is
taken one ``ce_chunk`` at a time under its own checkpoint
(``_chunked_ce``), so the (B, S, vocab) fp32 logits never exist whole.

With a recorder installed (``obs.recording``) the model's parts are spans
(``obs/device.py``): ``model.embed``; per layer ``model.attn`` (norm1 and
an attention or MLA mixer: projections, RoPE, the cache write, the kernel,
the out projection; the recurrent mixers have none) and ``model.mlp`` or
``model.moe`` (norm2 and the MLP; inside it ``model.moe.route`` and
``model.moe.experts``, and the counters ``moe.choices`` and
``moe.dropped``, ``models/mlp.py``); ``model.head`` (the final norm, the
logits, the cross-entropy).
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import _device
from repro_torch._tree import (leaves, tensor_from_numpy, tensor_to_numpy,
                               tree_map)
from repro_torch.configs.base import LayerSpec, ModelConfig, Segment
from repro_torch.models import attention as attn_mod
from repro_torch.models import common as cc
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.common import (DTYPES, RUNTIME, apply_norm,
                                       cross_entropy, generator,
                                       layernorm_params, logical_constraint,
                                       rmsnorm_params, truncnorm_init)
from repro_torch.obs.device import span

PyTree = Any
# the span of a layer's sequence mixer, by layer kind
_MIXER_SPAN = {"attn": "model.attn", "mla": "model.attn"}

def _norm_params(cfg: ModelConfig, d: int, device):
    return layernorm_params(d, device) if cfg.norm == "layernorm" \
        else rmsnorm_params(d, device)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def _stack(trees: list):
    """Stack parallel trees on a new leading axis (None leaves stay None)."""
    return tree_map(lambda *xs: None if xs[0] is None else torch.stack(xs),
                    trees[0], *trees[1:])


def _index(tree, i: int):
    """Views of entry ``i`` of a stacked tree."""
    return tree_map(lambda t: t[i], tree)


def _whole_dim0(t):
    if not cc.is_dtensor(t) or not any(p.is_shard(0) for p in t.placements):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, tuple(
        Replicate() if p.is_shard(0) else p for p in t.placements))


def _unstack(tree) -> list:
    """Views of every entry of a stacked tree, by one ``unbind`` per leaf:
    its backward stacks the entries' gradients into one tensor, where
    indexing each entry would add one full-size zero-filled gradient per
    entry. A ``DTensor`` split along the stacked axis (the reference
    shards a scanned axis freely) is gathered along it first."""
    parts = [_whole_dim0(t).unbind(0) for t in leaves(tree)]
    out = []
    for i in range(len(parts[0])):
        it = iter([p[i] for p in parts])
        out.append(tree_map(lambda _: next(it), tree))
    return out


# ---------------------------------------------------------------------------
# Single layer
# ---------------------------------------------------------------------------
def init_layer(gen: torch.Generator, layer: LayerSpec, cfg: ModelConfig) -> dict:
    dt = _dtype(cfg)
    d = cfg.d_model
    p: dict = {"norm1": _norm_params(cfg, d, gen.device)}
    if layer.kind == "attn":
        p["attn"] = attn_mod.init_attn(gen, layer.attn, d, dt)
    elif layer.kind == "mla":
        p["mla"] = attn_mod.init_mla(gen, layer.mla, d, dt)
    elif layer.kind == "mamba":
        p["mamba"] = ssm_mod.init_mamba(gen, layer.mamba, d, dt)
    elif layer.kind == "mlstm":
        p["mlstm"] = xlstm_mod.init_mlstm(gen, layer.xlstm, d, dt)
    elif layer.kind == "slstm":
        p["slstm"] = xlstm_mod.init_slstm(gen, layer.xlstm, d, dt)
    else:
        raise ValueError(layer.kind)
    if layer.mlp == "dense":
        p["norm2"] = _norm_params(cfg, d, gen.device)
        p["mlp"] = mlp_mod.init_mlp(gen, d, layer.d_ff, cfg.act, dt)
    elif layer.mlp == "moe":
        p["norm2"] = _norm_params(cfg, d, gen.device)
        p["moe"] = mlp_mod.init_moe(gen, layer.moe, d, cfg.act, dt)
    return p


def init_block(gen: torch.Generator, seg: Segment, cfg: ModelConfig) -> list:
    return [init_layer(gen, l, cfg) for l in seg.layers]


def layer_cache_init(layer: LayerSpec, cfg: ModelConfig, batch: int,
                     max_len: int, device) -> Optional[dict]:
    dt = _dtype(cfg)
    if layer.kind == "attn":
        return attn_mod.init_cache(layer.attn, batch, max_len, dt, device)
    if layer.kind == "mla":
        return attn_mod.init_mla_cache(layer.mla, batch, max_len, dt, device)
    if layer.kind == "mamba":
        return ssm_mod.init_mamba_cache(layer.mamba, cfg.d_model, batch, dt,
                                        device)
    if layer.kind == "mlstm":
        return xlstm_mod.init_mlstm_cache(layer.xlstm, cfg.d_model, batch, dt,
                                          device)
    if layer.kind == "slstm":
        return xlstm_mod.init_slstm_state(layer.xlstm, cfg.d_model, batch,
                                          device)
    raise ValueError(layer.kind)


def _mixer_full(p, layer: LayerSpec, h, positions):
    """The layer's sequence mixer over the normed input h."""
    if layer.kind == "attn":
        return attn_mod.attn_full(p["attn"], layer.attn, h, positions)
    if layer.kind == "mla":
        return attn_mod.mla_full(p["mla"], layer.mla, h, positions)
    if layer.kind == "mamba":
        return ssm_mod.mamba_full(p["mamba"], layer.mamba, h)
    if layer.kind == "mlstm":
        return xlstm_mod.mlstm_full(p["mlstm"], layer.xlstm, h)
    if layer.kind == "slstm":
        return xlstm_mod.slstm_full(p["slstm"], layer.xlstm, h)
    raise ValueError(layer.kind)


def _mixer_prefill(p, layer: LayerSpec, h, positions, max_len: int):
    """The mixer's forward and its decode cache: (y, cache)."""
    if layer.kind == "attn":
        return attn_mod.attn_prefill(p["attn"], layer.attn, h, positions,
                                     max_len)
    if layer.kind == "mla":
        return attn_mod.mla_prefill(p["mla"], layer.mla, h, positions, max_len)
    if layer.kind == "mamba":
        return ssm_mod.mamba_prefill(p["mamba"], layer.mamba, h)
    if layer.kind == "mlstm":
        return xlstm_mod.mlstm_prefill(p["mlstm"], layer.xlstm, h)
    if layer.kind == "slstm":
        return xlstm_mod.slstm_prefill(p["slstm"], layer.xlstm, h)
    raise ValueError(layer.kind)


def _normed(p_norm, cfg: ModelConfig, x):
    """The norm's output, pinned as the sequence-parallel boundary (the
    reference's constraint on the low-precision norm output)."""
    return logical_constraint(apply_norm(p_norm, x, cfg.norm),
                              cc.BATCH, cc.SEQ, cc.EMBED)


def _mixer_branch(p, layer: LayerSpec, cfg: ModelConfig, x, positions):
    return _mixer_full(p, layer, _normed(p["norm1"], cfg, x), positions)


def _mlp_branch(p, cfg: ModelConfig, x):
    return mlp_mod.mlp(p["mlp"], _normed(p["norm2"], cfg, x), cfg.act)


def _moe_branch(p, layer: LayerSpec, cfg: ModelConfig, x):
    """(y, aux) of the MoE layer."""
    return mlp_mod.moe(p["moe"], layer.moe, _normed(p["norm2"], cfg, x),
                       cfg.act, seq_chunk=cfg.moe_seq_chunk)


def _branch(fn, remat: bool, *args):
    """``fn(*args)``; with ``remat`` under its own checkpoint, which keeps
    only the branch's input (the residual stream) and recomputes its
    internals in the backward."""
    if remat:
        # the model draws no random numbers: no RNG state to stash
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def layer_full(p, layer: LayerSpec, cfg: ModelConfig, x, positions,
               want_cache: bool, max_len: int, remat_branches: bool = False):
    """Full-sequence layer. Returns (x, aux, cache_or_None): aux is the MoE
    layer's load-balance loss (0 without one). ``remat_branches``: the
    mixer and MLP branches each under their own checkpoint (remat policy
    "outputs")."""
    cache = None
    with span(_MIXER_SPAN.get(layer.kind)):
        if want_cache:
            h = _normed(p["norm1"], cfg, x)
            y, cache = _mixer_prefill(p, layer, h, positions, max_len)
        else:
            y = _branch(_mixer_branch, remat_branches, p, layer, cfg, x,
                        positions)
    x = x + y
    aux = torch.zeros((), device=x.device)
    if layer.mlp == "dense":
        with span("model.mlp"):
            y2 = _branch(_mlp_branch, remat_branches, p, cfg, x)
        x = x + y2
    elif layer.mlp == "moe":
        with span("model.moe"):
            y2, aux = _branch(_moe_branch, remat_branches, p, layer, cfg, x)
        x = x + y2
    x = logical_constraint(x, cc.BATCH, cc.SEQ, cc.EMBED)
    return x, aux, cache


def layer_decode(p, layer: LayerSpec, cfg: ModelConfig, x, pos, cache):
    """Single-token layer step at ``pos`` (an int or a 0-d int32 tensor);
    updates ``cache`` in place. Returns (x, cache)."""
    with span(_MIXER_SPAN.get(layer.kind)):
        y, cache = _mixer_decode(p, layer, cfg, x, pos, cache)
    x = x + y
    if layer.mlp == "dense":
        with span("model.mlp"):
            y2 = mlp_mod.mlp(p["mlp"], apply_norm(p["norm2"], x, cfg.norm),
                             cfg.act)
        x = x + y2
    elif layer.mlp == "moe":
        with span("model.moe"):
            y2, _ = mlp_mod.moe(p["moe"], layer.moe,
                                apply_norm(p["norm2"], x, cfg.norm), cfg.act,
                                decode=True, pos=pos)
        x = x + y2
    return x, cache


def _mixer_decode(p, layer: LayerSpec, cfg: ModelConfig, x, pos, cache):
    """norm1 and the mixer's step at ``pos``: (y, cache)."""
    h = apply_norm(p["norm1"], x, cfg.norm)
    if layer.kind == "attn":
        return attn_mod.attn_decode(p["attn"], layer.attn, h, pos, cache)
    if layer.kind == "mla":
        return attn_mod.mla_decode(p["mla"], layer.mla, h, pos, cache,
                                   absorb=cfg.mla_absorb)
    if layer.kind == "mamba":
        return ssm_mod.mamba_decode(p["mamba"], layer.mamba, h, cache)
    if layer.kind == "mlstm":
        return xlstm_mod.mlstm_decode(p["mlstm"], layer.xlstm, h, cache)
    if layer.kind == "slstm":
        return xlstm_mod.slstm_decode(p["slstm"], layer.xlstm, h, cache)
    raise ValueError(layer.kind)


def block_full(block_p, seg: Segment, cfg: ModelConfig, x, positions,
               want_cache: bool, max_len: int, remat_branches: bool = False):
    """One block (all layers of a segment repetition). Returns
    (x, aux_sum, [caches])."""
    aux_sum = torch.zeros((), device=x.device)
    caches = []
    for p_i, layer in zip(block_p, seg.layers):
        x, aux, cache = layer_full(p_i, layer, cfg, x, positions, want_cache,
                                   max_len, remat_branches)
        aux_sum = aux_sum + aux
        caches.append(cache)
    return x, aux_sum, caches


def block_decode(block_p, block_c, seg: Segment, cfg: ModelConfig, x, pos):
    new_caches = []
    for p_i, c_i, layer in zip(block_p, block_c, seg.layers):
        x, c = layer_decode(p_i, layer, cfg, x, pos, c_i)
        new_caches.append(c)
    return x, new_caches


# ---------------------------------------------------------------------------
# Whole model
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> PyTree:
    """Fresh params with the reference's tree and distributions (truncated
    normals), drawn on ``device`` from a ``torch.Generator`` seeded with
    ``seed``. ``jax.random`` draws other numbers: compare with the
    reference by injecting its params (``params_from_numpy``)."""
    dev = _device.resolve(device)
    return init_params_from(cfg, generator(dev, seed))


def init_params_from(cfg: ModelConfig, gen: torch.Generator) -> PyTree:
    """``init_params`` drawing from ``gen`` on its device, which the
    encoder-decoder and VLM inits go on drawing from (the reference splits
    one key among the parts)."""
    dt = _dtype(cfg)
    params: dict = {
        "embed": truncnorm_init(gen, (cfg.vocab_size, cfg.d_model), 0.02, dt),
        "final_norm": _norm_params(cfg, cfg.d_model, gen.device),
        "segments": [],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = truncnorm_init(gen, (cfg.d_model, cfg.vocab_size),
                                           0.02, dt)
    for seg in cfg.segments:
        blocks = [init_block(gen, seg, cfg) for _ in range(seg.count)]
        params["segments"].append(blocks[0] if seg.count == 1
                                  else _stack(blocks))
    return params


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device=None) -> list:
    dev = _device.resolve(device)
    caches = []
    for seg in cfg.segments:
        block = [layer_cache_init(l, cfg, batch, max_len, dev)
                 for l in seg.layers]
        caches.append(block if seg.count == 1
                      else _stack([block] * seg.count))
    return caches


def _remat_policy(cfg: ModelConfig, want_cache: bool) -> str:
    """The reference's ``_maybe_remat``: "" (no remat), "nothing" (the
    whole block under one checkpoint, ``nothing_saveable``) or "outputs"
    (``save_only_these_names("block_out")``: each attention and MLP branch
    under its own checkpoint, so what is kept per layer is the residual
    stream before each branch, which with the block's input holds what the
    reference's saved block outputs hold). Remat only matters when a
    backward follows: not under ``no_grad`` nor for a prefill."""
    if not cfg.remat or want_cache or not torch.is_grad_enabled():
        return ""
    return RUNTIME.get("remat_policy", "") or "nothing"


def _run_block(block_p, seg: Segment, cfg: ModelConfig, x, positions,
               want_cache: bool, max_len: int, policy: str):
    if policy == "nothing":
        return checkpoint(block_full, block_p, seg, cfg, x, positions,
                          want_cache, max_len, use_reentrant=False,
                          preserve_rng_state=False)
    return block_full(block_p, seg, cfg, x, positions, want_cache, max_len,
                      policy == "outputs")


def backbone_full(params, cfg: ModelConfig, x, positions, want_cache: bool,
                  max_len: int):
    """Run all segments over embeddings x. Returns (x, aux, caches)."""
    policy = _remat_policy(cfg, want_cache)
    aux_total = torch.zeros((), device=x.device)
    caches = []
    for seg, seg_p in zip(cfg.segments, params["segments"]):
        if seg.count == 1:
            x, aux, cache = _run_block(seg_p, seg, cfg, x, positions,
                                       want_cache, max_len, policy)
            aux_total = aux_total + aux
            caches.append(cache)
            continue
        seg_caches = []
        for block_p in _unstack(seg_p):
            x, aux, cache = _run_block(block_p, seg, cfg, x, positions,
                                       want_cache, max_len, policy)
            aux_total = aux_total + aux
            seg_caches.append(cache)
        caches.append(_stack(seg_caches))
    return x, aux_total, caches


def embed_lookup(table, tokens):
    """Rows ``tokens`` of the embedding table. A table placed on a device
    mesh with its vocab split (over ``model``; the embed dim may be split
    over ``data``) goes through ``F.embedding``, which DTensor shards: each
    rank looks up the rows of its vocab block and the partial rows are
    summed (the gather on which the reference's sharded loop stops). Any
    other table is indexed, as the plain loop does, so its gradient sums a
    repeated token's rows in the plain loop's order (``F.embedding``'s
    backward sums them in another)."""
    with span("model.embed"):
        if cc.is_dtensor(table) and any(
                p.is_shard(0) and n > 1
                for p, n in zip(table.placements,
                                table.device_mesh.mesh.shape)):
            return torch.nn.functional.embedding(tokens, table)
        return table[tokens]


def _logits(params, cfg: ModelConfig, x):
    with span("model.head"):
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        logits = x @ head.to(x.dtype)
        if cfg.logits_fp32:
            logits = logits.float()
        return logical_constraint(logits, cc.BATCH, None, cc.VOCAB)


def _hidden(params, cfg: ModelConfig, tokens, embeds, want_cache: bool,
            max_len: int):
    """Embeddings through every segment and the final norm."""
    if embeds is None:
        embeds = embed_lookup(params["embed"], tokens)
    embeds = logical_constraint(embeds, cc.BATCH, cc.SEQ, cc.EMBED)
    b, s = embeds.shape[:2]
    positions = torch.arange(s, dtype=torch.int32,
                             device=embeds.device)[None].expand(b, s)
    x, aux, caches = backbone_full(params, cfg, embeds, positions, want_cache,
                                   max_len or s)
    with span("model.head"):
        x = apply_norm(params["final_norm"], x, cfg.norm)
    return x, aux, caches


def forward(params, cfg: ModelConfig, tokens=None, embeds=None,
            want_cache: bool = False, max_len: int = 0):
    """tokens: (B,S) int (or embeds (B,S,d)). Returns (logits, aux, caches)."""
    x, aux, caches = _hidden(params, cfg, tokens, embeds, want_cache, max_len)
    return _logits(params, cfg, x), aux, caches


def _ce_chunk(x_blk, l_blk, head):
    """Summed NLL and label count of one sequence chunk, fp32 logits."""
    logits = (x_blk @ head.to(x_blk.dtype)).float()
    logits = logical_constraint(logits, cc.BATCH, None, cc.VOCAB)
    m = (l_blk >= 0).float()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, l_blk.clamp(min=0)[..., None].long())[..., 0]
    return (nll * m).sum(), m.sum()


def _chunked_ce(params, cfg: ModelConfig, x, labels):
    """Seq-chunked CE: the logits of one ``ce_chunk`` of the sequence at a
    time, each chunk under checkpoint (recomputed in the backward), so the
    (B, S, V) fp32 logits never exist whole: at gemma3-1b, B 4 and S 1024
    they would be 4.3 GB, one chunk of 512 is 2.1 GB. Exact: CE decomposes
    over positions."""
    s = x.shape[1]
    chunk = cfg.ce_chunk
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    nlls, counts = [], []
    with span("model.head"):
        for c0 in range(0, s, chunk):
            args = (x[:, c0:c0 + chunk], labels[:, c0:c0 + chunk], head)
            nll, count = checkpoint(_ce_chunk, *args, use_reentrant=False,
                                    preserve_rng_state=False) \
                if torch.is_grad_enabled() else _ce_chunk(*args)
            nlls.append(nll)
            counts.append(count)
        return torch.stack(nlls).sum() / torch.clamp(
            torch.stack(counts).sum(), min=1.0)


def loss_and_metrics(params, cfg: ModelConfig, batch: dict):
    """batch: {"tokens": (B,S), "labels": (B,S)} int tensors on the params'
    device; labels -100 = masked. Returns (loss, {"loss", "ce", "aux"}),
    0-d fp32 tensors. The chunked CE runs exactly when the reference's
    does: ``s % ce_chunk == 0 and s > ce_chunk``."""
    tokens, labels = batch["tokens"], batch["labels"]
    s = tokens.shape[1]
    if cfg.ce_chunk and s % cfg.ce_chunk == 0 and s > cfg.ce_chunk:
        x, aux, _ = _hidden(params, cfg, tokens, None, False, s)
        ce = _chunked_ce(params, cfg, x, labels)
    else:
        logits, aux, _ = forward(params, cfg, tokens=tokens)
        with span("model.head"):
            ce = cross_entropy(logits, labels.clamp(min=0),
                               (labels >= 0).float())
    loss = ce + aux
    return loss, {"loss": loss, "ce": ce, "aux": aux}


def prefill(params, cfg: ModelConfig, tokens=None, embeds=None,
            max_len: int = 0):
    """Returns (logits_last (B,1,V), caches). The head runs on the last
    position only: the same numbers as the reference's ``logits[:, -1:]``
    without its (B, S, V) fp32 logits (4.3 GB at gemma3-1b, B 4, S 1024)."""
    x, _, caches = _hidden(params, cfg, tokens, embeds, True, max_len)
    return _logits(params, cfg, x[:, -1:]), caches


def decode_step(params, cfg: ModelConfig, token, pos, caches):
    """token: (B,1) int; pos: the token's position, an int or a 0-d int32
    tensor on the params' device (then nothing syncs with the host and the
    step can be captured in a CUDA graph). Updates ``caches`` in place.
    Returns (logits (B,1,V), caches)."""
    x = embed_lookup(params["embed"], token)
    for seg, seg_p, seg_c in zip(cfg.segments, params["segments"], caches):
        if seg.count == 1:
            x, _ = block_decode(seg_p, seg_c, seg, cfg, x, pos)
            continue
        for i in range(seg.count):
            x, _ = block_decode(_index(seg_p, i), _index(seg_c, i), seg, cfg,
                                x, pos)
    with span("model.head"):
        x = apply_norm(params["final_norm"], x, cfg.norm)
    return _logits(params, cfg, x), caches


def param_count(params) -> int:
    return sum(int(p.numel()) for p in leaves(params))


def params_from_numpy(tree, device=None) -> PyTree:
    """Reference params (``jax.tree.map(np.asarray, params)``) -> the port's
    tree of tensors on ``device``; bfloat16 leaves come over by bit
    pattern."""
    dev = _device.resolve(device)
    return tree_map(lambda a: tensor_from_numpy(a, dev), tree)


def params_to_numpy(params) -> PyTree:
    """The port's tree -> numpy (bfloat16 leaves widened to float32, which
    is exact)."""
    return tree_map(tensor_to_numpy, params)
