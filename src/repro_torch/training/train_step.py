"""train_step / serve_step builders. Port of
``repro/training/train_step.py``.

Every builder returns a plain function: ``make_train_step`` and
``make_eval_step`` over (state or params, batch), ``make_prefill`` and
``make_decode_step`` over (params, batch / token, caches). PyTorch runs
them eagerly (the reference jits them); on the card ``launch/serve.py``
captures the decode step in a CUDA graph, and ``launch/train.py`` the
donating train step (``make_train_step(..., donate=True)``).
TrainState = (params, opt), as in the reference.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch._tree import leaves, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import DTYPES
from repro_torch.models.registry import ModelApi, get_api
from repro_torch.parallel.sharding import replicate
from repro_torch.training.optimizer import (AdamState, AdamWConfig, adamw_init,
                                            adamw_update, adamw_update_)

PyTree = Any


class TrainState(NamedTuple):
    params: PyTree
    opt: AdamState


def init_train_state(cfg: ModelConfig, seed: int = 0,
                     opt_cfg: AdamWConfig | None = None,
                     device=None, rules=None) -> TrainState:
    """Fresh params (``init_params(cfg, seed, device)``) and zero AdamW
    moments in ``opt_cfg.moment_dtype``. With ``rules`` (``ShardingRules``
    on a ``DeviceMesh``) every rank draws the same whole state from the
    seed and keeps its shards of it: the state as ``DTensor``s placed by
    ``launch.specs.train_state_specs``."""
    params = get_api(cfg).init_params(cfg, seed=seed, device=device)
    moment_dtype = opt_cfg.moment_dtype if opt_cfg else "float32"
    state = TrainState(params=params, opt=adamw_init(params, moment_dtype))
    if rules is None:
        return state
    from repro_torch.launch.specs import distribute_state
    return distribute_state(rules, state)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    api: ModelApi | None = None, *,
                    donate: bool = False) -> Callable:
    """(state, batch) -> (state, metrics). ``batch``: {"tokens", "labels"}
    int tensors on the params' device, and a family's ``frames`` or
    ``patches`` (``device_batch``). One step: the loss, its gradient by
    ``torch.autograd.grad`` over every param leaf, then ``adamw_update``
    (global-norm clip, schedule, decoupled decay). ``metrics``: loss, ce,
    aux, grad_norm and lr as 0-d tensors on the device; reading one waits
    for the step. The given state is not modified.

    ``donate=True``: the step updates ``state``'s tensors in place
    (``adamw_update_``, the same numbers bit for bit) and returns that same
    state, the counterpart of the reference's ``jax.jit(step,
    donate_argnums=(0,))``: the old and the new state are never held at
    once, and a CUDA graph of the step reads and writes fixed buffers.

    A state of ``DTensor``s (``init_train_state(..., rules=)``) steps on
    its device mesh (``sharded_step``)."""
    api = api or get_api(cfg)

    def train_step(state: TrainState, batch: dict):
        if isinstance(state.opt.step, DTensor):
            return sharded_step(state, batch)
        params = tree_map(lambda t: t.detach().requires_grad_(True),
                          state.params)
        loss, metrics = api.loss_and_metrics(params, cfg, batch)
        grads = iter(torch.autograd.grad(loss, leaves(params)))
        grads = tree_map(lambda _: next(grads), params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        if donate:
            metrics.update(adamw_update_(opt_cfg, grads, state.opt,
                                         state.params))
            return state, metrics
        new_params, opt, om = adamw_update(opt_cfg, grads, state.opt,
                                           state.params)
        metrics.update(om)
        return TrainState(params=new_params, opt=opt), metrics

    def sharded_step(state: TrainState, batch: dict):
        """The step on a device mesh, in place (the reference's jitted step
        with ``out_shardings = in_shardings`` and the state donated). The
        batch enters whole on every rank (``in_shardings=None``); the
        pushed activation rules split it. Plain tensors that meet a
        ``DTensor`` (positions, masks, RoPE tables, the step, the LR) are
        replicated on the mesh (``implicit_replication``). The loss is
        reduced to one value on every rank before its gradient, each
        gradient is placed as its param (a reduce-scatter of FSDP's pending
        sums), and ``adamw_update_`` writes every rank's shards. Metrics
        are plain tensors, the same on every rank."""
        if not donate:
            raise ValueError("a state on a device mesh steps in place: "
                             "make_train_step(..., donate=True)")
        mesh = state.opt.step.device_mesh
        whole = (Replicate(),) * mesh.ndim
        batch = replicate(mesh, batch)
        with implicit_replication():
            params = tree_map(lambda t: t.detach().requires_grad_(True),
                              state.params)
            loss, metrics = api.loss_and_metrics(params, cfg, batch)
            loss = loss.redistribute(mesh, whole)
            grads = iter(torch.autograd.grad(loss, leaves(params)))
            grads = tree_map(
                lambda p: _placed_as(next(grads), p), params)
            metrics = {k: (v.redistribute(mesh, whole).to_local()
                           if isinstance(v, DTensor) else v).detach()
                       for k, v in metrics.items()}
            metrics.update(adamw_update_(opt_cfg, grads, state.opt,
                                         state.params))
        return state, metrics

    return train_step


def _placed_as(g, p):
    """The gradient ``g`` with its param's placements."""
    if tuple(g.placements) == tuple(p.placements):
        return g
    return g.redistribute(p.device_mesh, p.placements)


def make_eval_step(cfg: ModelConfig, api: ModelApi | None = None) -> Callable:
    """(params, batch) -> metrics (loss, ce, aux), without gradients."""
    api = api or get_api(cfg)

    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = api.loss_and_metrics(params, cfg, batch)
        return metrics

    return eval_step


def device_batch(cfg: ModelConfig, batch: dict, device) -> dict:
    """A numpy batch (``data.synthetic.make_batch``) as tensors on
    ``device``, with ``frames`` / ``patches`` in the config's activation
    dtype, as the reference's input specs declare them
    (``launch/specs.py``). ``make_batch`` gives them in float32 by default:
    JAX promotes float32 inputs against bf16 weights, torch refuses the
    mixed product, so the model functions expect them in that dtype."""
    act = DTYPES[cfg.dtype]
    return {k: (torch.as_tensor(np.asarray(v), device=device).to(act)
                if k in ("frames", "patches")
                else torch.as_tensor(np.asarray(v), device=device))
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def make_prefill(cfg: ModelConfig, api: ModelApi | None = None) -> Callable:
    """(params, batch, max_len) -> (last_logits, caches). ``batch`` holds
    ``tokens`` and the family's ``frames`` (audio) or ``patches`` (vlm)."""
    api = api or get_api(cfg)

    def prefill_step(params, batch, max_len: int):
        if cfg.family == "audio":
            return api.prefill(params, cfg, batch["frames"], batch["tokens"],
                               max_len=max_len)
        if cfg.family == "vlm":
            return api.prefill(params, cfg, batch["patches"], batch["tokens"],
                               max_len=max_len)
        return api.prefill(params, cfg, tokens=batch["tokens"], max_len=max_len)

    return prefill_step


def make_decode_step(cfg: ModelConfig, api: ModelApi | None = None,
                     greedy: bool = True) -> Callable:
    """(params, token (B,1), pos, caches) -> (next_token (B,1) int32,
    caches). ``pos`` is an int or a 0-d int32 tensor on the params' device,
    as the reference's ``serve_step`` takes a traced scalar. Greedy: the
    argmax of the last logits, whatever ``greedy`` says (the reference takes
    the keyword and never reads it). The caches are updated in place."""
    api = api or get_api(cfg)

    def serve_step(params, token, pos, caches):
        logits, caches = api.decode_step(params, cfg, token, pos, caches)
        next_token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_token[:, None], caches

    return serve_step


def init_serve_caches(cfg: ModelConfig, batch: int, max_len: int,
                      device=None):
    """Decode caches for serve_step (lm/vlm families; audio builds its own
    via prefill because of the cross-attention KV)."""
    from repro_torch.models import decoder_lm as dlm
    return dlm.init_caches(cfg, batch, max_len, device=device)
