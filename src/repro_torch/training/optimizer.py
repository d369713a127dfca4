"""Functional optimizers over nested dicts of tensors (port of
``repro/training/optimizer.py``).

AdamW with decoupled weight decay, global-norm gradient clipping and a
warmup+cosine LR schedule. The state mirrors the params tree.
``adamw_update`` returns new tensors (the reference is pure);
``adamw_update_`` computes the same numbers and writes them into the given
params and state, the counterpart of the reference's donated buffers
(``launch/train.py`` donates the train state to its jitted step). The math
is fp32 whatever the moment dtype. Nothing here reads a tensor's value on
the host, so a step can be captured in a CUDA graph.

On the card the global norm and ``adamw_update_``'s update run in
``kernels/adamw``'s multi-tensor passes, which refuse a leaf they cannot
take (``takes_leaf``, ``takes_grads``); on the CPU they run the eager code
here (``_eager_norm``, ``_update_leaf_``), their plain versions.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch._tree import is_dtensor
from repro_torch._tree import leaves as _leaves
from repro_torch._tree import map_with_path as _map
from repro_torch.kernels.adamw import kernel as adamw_kernel
from repro_torch.obs.device import count

Params = Any


class AdamState(NamedTuple):
    step: torch.Tensor  # scalar int32
    mu: Params          # first moment, params' shape, moment dtype
    nu: Params          # second moment


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    warmup_steps: int = 0
    total_steps: int = 0          # 0 => constant LR after warmup
    min_lr_ratio: float = 0.1
    # Moment dtype: "bfloat16" halves optimizer memory; math stays fp32
    # (moments are upcast at the update).
    moment_dtype: str = "float32"


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr_ratio (constant if total_steps=0)."""
    step = step.to(torch.float32)
    # a fill, not torch.tensor(): a copy from the host would stop a capture
    peak = torch.full((), cfg.learning_rate, dtype=torch.float32,
                      device=step.device)
    if cfg.warmup_steps > 0:
        warm = peak * (step + 1.0) / float(cfg.warmup_steps)
    else:
        warm = peak
    if cfg.total_steps > 0:
        frac = torch.clamp(
            (step - cfg.warmup_steps) / max(1, cfg.total_steps - cfg.warmup_steps),
            0.0, 1.0)
        cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
            1 + torch.cos(math.pi * frac))
        decayed = peak * cos
    else:
        decayed = peak
    return torch.where(step < cfg.warmup_steps, warm, decayed)


def _local(t: torch.Tensor) -> torch.Tensor:
    """A ``DTensor``'s shard on this rank (the tensor it holds, so writing
    it writes the ``DTensor``); a plain tensor as it is."""
    return t.to_local() if is_dtensor(t) else t


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _eager_norm(ls: list) -> torch.Tensor:
    """The plain norm: each leaf's squares summed in fp32, the sums added
    in leaf order."""
    return torch.sqrt(sum(torch.sum(torch.square(l.float())) for l in ls))


def _squared_sums(ts: list) -> list:
    """Each tensor's sum of squares, 0-d: on the card in fp64 by the kernel
    (``adamw_kernel.squared_sums``, the sums its ``global_norm`` adds), on
    the CPU in fp32."""
    if ts and _on_card(ts[0]):
        return adamw_kernel.squared_sums(ts)
    return [torch.sum(torch.square(t.float())) for t in ts]


def _summed_over_shards(ls: list) -> list:
    """The squared sum of each leaf, reduced over the mesh dims that split
    it and over nothing else (a replicated leaf is whole on every rank):
    each leaf's pending sum is reduced exactly once, with one collective
    per set of splitting mesh dims. Plain tensors, the same on every rank.
    The local sums are ``_squared_sums``', so that on one card the norm
    has the plain leaves' bits."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    local = _squared_sums([_local(l) for l in ls])
    groups: dict = {}
    for i, l in enumerate(ls):
        if is_dtensor(l):
            split = tuple(p.is_shard() for p in l.placements)
            if any(split):
                groups.setdefault((l.device_mesh, split), []).append(i)
    for (mesh, split), idx in groups.items():
        part = DTensor.from_local(
            torch.stack([local[i] for i in idx]), mesh,
            tuple(Partial() if s else Replicate() for s in split),
            run_check=False)
        whole = part.redistribute(mesh, (Replicate(),) * len(split))
        for i, v in zip(idx, whole.to_local().unbind(0)):
            local[i] = v
    return local


def global_norm(tree: Params) -> torch.Tensor:
    """The norm of every leaf taken together. Over ``DTensor`` leaves (a
    state placed on a device mesh) it is a plain tensor, the same on every
    rank, summed in leaf order as for plain leaves. On the card the kernel
    sums the leaves, or the ``DTensor`` leaves' local shards, in fp64 (the
    same bits on every call); on the CPU it is ``_eager_norm``."""
    ls = _leaves(tree)
    if ls and is_dtensor(ls[0]):
        return torch.sqrt(sum(_summed_over_shards(ls))).float()
    if ls and _on_card(ls[0]):
        return adamw_kernel.global_norm(ls)
    return _eager_norm(ls)


def clip_by_global_norm(tree: Params, max_norm: float) -> tuple[Params, torch.Tensor]:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return _map(lambda _, g: g * scale.to(g.dtype), tree), norm


def adamw_init(params: Params, moment_dtype: str = "float32") -> AdamState:
    mdt = torch.bfloat16 if moment_dtype == "bfloat16" else torch.float32
    zeros = lambda _, p: torch.zeros(p.shape, dtype=mdt, device=p.device)
    device = _leaves(params)[0].device
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=device),
                     mu=_map(zeros, params), nu=_map(zeros, params))


def _decay_mask(path) -> bool:
    """No weight decay on biases / norm scales / 1-d params (list indices
    carry no name, as in the reference's key paths)."""
    joined = "/".join(k if isinstance(k, str) else "" for k in path)
    return not any(t in joined for t in ("bias", "scale", "norm", "ln_"))


def _update_leaf_(cfg: AdamWConfig, decay: bool, p, g, m, v, scale, lr, c1,
                  c2) -> None:
    """``adamw_update``'s step of one leaf in place, in eager kernels: the
    plain version of the kernel's update. ``decay``: weight decay on this
    leaf; ``scale`` the clip's 0-d scale or None."""
    if scale is not None:
        g = g * scale.to(g.dtype)
    g = g.float()
    m.copy_(cfg.b1 * m.float() + (1 - cfg.b1) * g)
    v.copy_(cfg.b2 * v.float() + (1 - cfg.b2) * g * g)
    update = (m.float() / c1) / (torch.sqrt(v.float() / c2) + cfg.eps)
    if decay:
        update = update + cfg.weight_decay * p.float()
    p.copy_(p.float() - lr * update)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Params, state: AdamState,
                 params: Params) -> tuple[Params, AdamState, dict]:
    """One AdamW step. Returns (new_params, new_state, metrics)."""
    if cfg.grad_clip_norm > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip_norm)
    else:
        gnorm = global_norm(grads)
    step = state.step
    lr = _schedule(cfg, step)
    t = (step + 1).to(torch.float32)
    c1 = 1.0 - torch.pow(cfg.b1, t)
    c2 = 1.0 - torch.pow(cfg.b2, t)

    def upd_mu(_, g, m):
        out = cfg.b1 * m.float() + (1 - cfg.b1) * g.float()
        return out.to(m.dtype)

    def upd_nu(_, g, v):
        g = g.float()
        out = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        return out.to(v.dtype)

    mu = _map(upd_mu, grads, state.mu)
    nu = _map(upd_nu, grads, state.nu)

    def upd_param(path, p, m, v):
        m = m.float()
        v = v.float()
        update = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        if cfg.weight_decay > 0 and _decay_mask(path):
            update = update + cfg.weight_decay * p.float()
        return (p.float() - lr * update).to(p.dtype)

    new_params = _map(upd_param, params, mu, nu)
    new_state = AdamState(step=step + 1, mu=mu, nu=nu)
    return new_params, new_state, {"lr": lr, "grad_norm": gnorm}


@torch.no_grad()
def adamw_update_(cfg: AdamWConfig, grads: Params, state: AdamState,
                  params: Params) -> dict:
    """One AdamW step in place: the new params, ``mu``, ``nu`` and ``step``
    are written into ``params`` and ``state``'s tensors. Returns the
    metrics of ``adamw_update``, whose numbers it computes bit for bit: the
    same fp32 expressions in the same order, leaf by leaf, so that the
    temporaries of one leaf live at a time and the state is never held
    twice.

    On a state placed on a device mesh (``DTensor`` leaves, the gradients
    placed as their params) every update is elementwise, so each rank
    writes its own shards of ``p``, ``m`` and ``v`` and the placements
    stay; only the global norm sums across ranks (``global_norm``). The
    metrics are then plain tensors, the same on every rank.

    Leaves on the card are updated together by the kernel's multi-tensor
    pass, which refuses (``ValueError``, before it writes anything) a leaf
    it cannot take (``adamw_kernel.takes_leaf``); leaves on the CPU run
    ``_update_leaf_``. The counters ``train.optimizer.fused_leaves`` and
    ``train.optimizer.eager_leaves`` (``obs/device.py``) count them, once a
    call."""
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip_norm / (gnorm + 1e-9), max=1.0)
             if cfg.grad_clip_norm > 0 else None)
    step = _local(state.step)
    lr = _schedule(cfg, step)
    t = (step + 1).to(torch.float32)
    c1 = 1.0 - torch.pow(cfg.b1, t)
    c2 = 1.0 - torch.pow(cfg.b2, t)
    fused, eager = [], []

    def sort(path, p, g, m, v):
        leaf = (_local(p), _local(g), _local(m), _local(v))
        decay = cfg.weight_decay > 0 and _decay_mask(path)
        (fused if _on_card(leaf[0]) else eager).append((decay, leaf))

    _map(sort, params, grads, state.mu, state.nu)
    adamw_kernel.adamw_update_(
        [leaf for _, leaf in fused], [decay for decay, _ in fused],
        scale, lr, c1, c2, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
        weight_decay=cfg.weight_decay)
    for decay, leaf in eager:
        _update_leaf_(cfg, decay, *leaf, scale, lr, c1, c2)
    count("train.optimizer.fused_leaves", len(fused))
    count("train.optimizer.eager_leaves", len(eager))
    step.add_(1)
    return {"lr": lr, "grad_norm": gnorm}


@torch.no_grad()
def sgd_update(lr: float, grads: Params, params: Params) -> Params:
    return _map(lambda _, p, g: (p.float() - lr * g.float()).to(p.dtype),
                params, grads)
