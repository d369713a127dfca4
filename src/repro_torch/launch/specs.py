"""Meta-tensor stand-ins + sharding specs for every entry point. Port of
``repro/launch/specs.py``.

No allocation anywhere: param/cache structures come from the real
initializers run on the meta device (the reference's ``jax.eval_shape``),
so the dry-run prices exactly what the runtime would execute.

Cache sharding policy (decode shapes):
  * batch dim        -> (pod, data)   [dropped when indivisible, e.g. B=1]
  * KV-cache seq dim -> (model, data) minus already-used axes — sharding the
    cache T dim turns the decode softmax/dot into partial+all-reduce
    (a flash-decode schedule); with B=1 (long_500k) the cache spreads over
    the whole pod.
  * mamba/xlstm state feature dims -> model.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.data.synthetic import batch_struct
from repro_torch.models import decoder_lm as dlm
from repro_torch.models.common import DTYPES
from repro_torch.models.registry import get_api
from repro_torch.parallel.sharding import (P, ShardingRules, _fit_axes,
                                           distribute, param_specs)
from repro_torch.training.optimizer import AdamState, AdamWConfig
from repro_torch.training.train_step import TrainState, init_train_state

PyTree = Any
META = torch.device("meta")


def _act_dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def _meta(shape, dtype) -> torch.Tensor:
    if not isinstance(dtype, torch.dtype):       # a numpy dtype
        dtype = torch.from_numpy(np.empty(0, dtype)).dtype
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Meta-tensor batch for train/prefill."""
    skel = batch_struct(cfg, shape.global_batch, shape.seq_len,
                        _act_dtype(cfg))
    return {k: _meta(s, d) for k, (s, d) in skel.items()}


def param_struct(cfg: ModelConfig) -> PyTree:
    return get_api(cfg).init_params(cfg, seed=0, device=META)


def train_state_struct(cfg: ModelConfig, opt_cfg: AdamWConfig) -> TrainState:
    return init_train_state(cfg, 0, opt_cfg=opt_cfg, device=META)


# ---------------------------------------------------------------------------
# Sharding spec trees
# ---------------------------------------------------------------------------
def train_state_specs(rules: ShardingRules, state_struct: TrainState) -> TrainState:
    pspecs = param_specs(rules, state_struct.params)
    mspecs_mu = param_specs(rules, state_struct.opt.mu)
    mspecs_nu = param_specs(rules, state_struct.opt.nu)
    return TrainState(params=pspecs,
                      opt=AdamState(step=P(), mu=mspecs_mu, nu=mspecs_nu))


def distribute_state(rules: ShardingRules, state: TrainState) -> TrainState:
    """``state`` (whole on every rank) as ``DTensor``s on ``rules.mesh``
    placed by ``train_state_specs``: params and moments by the param
    rules, the step counter replicated (``P()``)."""
    specs = train_state_specs(rules, state)
    return TrainState(
        params=distribute(rules.mesh, state.params, specs.params),
        opt=AdamState(step=distribute(rules.mesh, state.opt.step,
                                      specs.opt.step),
                      mu=distribute(rules.mesh, state.opt.mu, specs.opt.mu),
                      nu=distribute(rules.mesh, state.opt.nu, specs.opt.nu)))


def batch_partition_specs(rules: ShardingRules, batch: dict) -> dict:
    out = {}
    for k, v in batch.items():
        fitted = _fit_axes(v.shape[0], ("pod",) + tuple(rules.data_axes),
                           rules.mesh, set())
        spec = [None] * len(v.shape)
        if fitted:
            spec[0] = fitted if len(fitted) > 1 else fitted[0]
        out[k] = P(*spec)
    return out


# -- caches -------------------------------------------------------------------
_BATCH_AXES = ("pod", "data")
_SEQ_AXES = ("model", "data")


def _cache_leaf_spec(kind: str, name: str, shape: tuple, stacked: bool,
                     rules: ShardingRules) -> P:
    mesh = rules.mesh
    off = 1 if stacked else 0
    spec: list = [None] * len(shape)
    used: set = set()

    def put(i, axes):
        fitted = _fit_axes(shape[i], tuple(a for a in axes if a not in used),
                           mesh, used)
        if fitted:
            spec[i] = fitted if len(fitted) > 1 else fitted[0]
            used.update(fitted)

    core_rank = len(shape) - off
    if name == "slot_pos":
        return P(*spec)
    if kind in ("attn",) and name in ("k", "v") and core_rank == 4:
        put(off + 0, _BATCH_AXES)
        put(off + 1, _SEQ_AXES)        # flash-decode style cache split
    elif kind == "mla" and name in ("ckv", "k_rope") and core_rank == 3:
        put(off + 0, _BATCH_AXES)
        put(off + 1, _SEQ_AXES)
    elif kind == "mamba":
        put(off + 0, _BATCH_AXES)
        if name == "h" and core_rank == 3:
            put(off + 1, ("model",))
        elif name == "conv" and core_rank == 3:
            put(off + 2, ("model",))
    elif kind in ("mlstm", "slstm"):
        put(off + 0, _BATCH_AXES)
        if name == "conv" and core_rank == 3:
            put(off + 2, ("model",))
        elif core_rank >= 2:
            put(off + 1, ("model",))   # heads (usually dropped: few heads)
    elif name == "cross_kv" and core_rank == 4:   # (B, T_enc, KV, dh)
        put(off + 0, _BATCH_AXES)
        put(off + 2, ("model",))
    else:                               # generic fallback
        put(off + 0, _BATCH_AXES)
    return P(*spec)


def decode_cache_struct(cfg: ModelConfig, batch: int, max_len: int) -> PyTree:
    if cfg.family == "audio":
        api = get_api(cfg)
        frames = _meta((batch, cfg.encoder_max_len, cfg.d_model),
                       _act_dtype(cfg))
        tokens = _meta((batch, 1), torch.int32)
        _, caches = api.prefill(param_struct(cfg), cfg, frames, tokens,
                                max_len=max_len)
        return caches
    return dlm.init_caches(cfg, batch, max_len, device=META)


def decode_cache_specs(rules: ShardingRules, cfg: ModelConfig, batch: int,
                       max_len: int) -> PyTree:
    """PartitionSpec tree mirroring decode_cache_struct — built by walking
    cfg.segments exactly as init_caches does (no rank heuristics)."""

    def block_specs(seg, stacked: bool):
        out = []
        for layer in seg.layers:
            c = dlm.layer_cache_init(layer, cfg, batch, max_len, META)
            spec = {k: _cache_leaf_spec(layer.kind, k, ((0,) if stacked else ())
                                        + tuple(v.shape), stacked, rules)
                    for k, v in c.items()}
            out.append(spec)
        return out

    self_specs = [block_specs(seg, seg.count > 1) for seg in cfg.segments]
    if cfg.family != "audio":
        return self_specs

    def cross_specs(seg, stacked):
        out = []
        for layer in seg.layers:
            kv_shape = (batch, cfg.encoder_max_len, layer.attn.n_kv_heads,
                        layer.attn.head_dim)
            s = _cache_leaf_spec("attn", "cross_kv",
                                 ((0,) if stacked else ()) + kv_shape,
                                 stacked, rules)
            out.append((s, s))
        return out

    return {"self": self_specs,
            "cross": [cross_specs(seg, seg.count > 1)
                      for seg in cfg.segments]}


def token_specs(rules: ShardingRules, batch: int) -> P:
    fitted = _fit_axes(batch, _BATCH_AXES, rules.mesh, set())
    spec = [None, None]
    if fitted:
        spec[0] = fitted if len(fitted) > 1 else fitted[0]
    return P(*spec)
