"""Shared layer primitives: inits, norms, activations, RoPE, logical
sharding annotations, masks, loss. Port of ``repro/models/common.py``.

Parameters are plain nested dicts of tensors. Activation sharding hints use
``logical_constraint`` with *logical axis names*; ``parallel/sharding.py``
resolves them against the active mesh (and drops non-divisible axes). With
no rule set pushed the call returns its input at once; a plain tensor is
left as it is, a ``DTensor`` is redistributed to the resolved placements.

Every init draws from an explicit ``torch.Generator`` (``generator``);
``jax.random`` draws other numbers, so parity tests inject the reference's
params instead of comparing two inits. On the meta device an init draws
nothing: it gives the tree's shapes and dtypes only.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch._tree import is_dtensor

# Runtime execution knobs, set by the launcher per device:
#   use_flash — route attention through the hand-written CUDA kernels
#               (their plain versions for CPU tensors)
#   q_chunk   — q-block chunked attention in plain torch (0 = off)
#   ssm_chunk — chunkwise Mamba scan (bounds the (B, S, d_inner, d_state)
#               discretized tensors to one chunk; 0 = whole sequence)
#   mlstm_chunk — chunkwise-recurrent mLSTM (bounds the quadratic form)
#   moe_chunk — MoE sequence chunk, overriding ``cfg.moe_seq_chunk`` (0 = use
#               the config's)
#   remat_policy — what a rematerialized block keeps for the backward:
#               "" or "nothing" (recompute the whole block) or "outputs"
#               (keep the attention and MLP block outputs)
#   moe_combine_bf16 — build the MoE routing tensors in bf16, not fp32
#   moe_capacity_factor — chunked-MoE capacity factor override (0.0 = the
#               spec's)
RUNTIME = {"use_flash": False, "q_chunk": 0, "ssm_chunk": 0,
           "mlstm_chunk": 0, "moe_chunk": 0, "remat_policy": "",
           "moe_combine_bf16": False, "moe_capacity_factor": 0.0}

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# Logical activation axes -> resolved by parallel/sharding.py
BATCH = "act_batch"
SEQ = "act_seq"
HEADS = "act_heads"
KV_SEQ = "act_kv_seq"
FF = "act_ff"
EXPERT = "act_expert"
EMBED = "act_embed"
VOCAB = "act_vocab"

_MESH_RULES_STACK: list = []


def push_logical_rules(rules):
    """Make ``rules`` (``parallel.sharding.activation_resolver``'s
    ``resolve(shape, axes) -> PartitionSpec | None``) the active rule set."""
    _MESH_RULES_STACK.append(rules)


def pop_logical_rules():
    _MESH_RULES_STACK.pop()


def logical_constraint(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Annotate activation sharding if a rule set is active (no-op
    otherwise). The resolved spec places a ``DTensor`` on its own mesh (the
    reference's ``with_sharding_constraint``); a plain tensor lives on one
    device and is returned as it is."""
    if not _MESH_RULES_STACK:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = _MESH_RULES_STACK[-1](tuple(x.shape), axes)
    if spec is None:
        return x
    from repro_torch.parallel.sharding import compute_placements
    return x.redistribute(x.device_mesh,
                          compute_placements(spec, x.device_mesh))


def whole(x: torch.Tensor) -> torch.Tensor:
    """A ``DTensor`` replicated on every mesh dim (the whole tensor on each
    rank, any pending sum reduced)."""
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, (Replicate(),) * x.device_mesh.ndim)


def shardwise(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` for an elementwise ``fn`` that DTensor has no sharding rule
    for (``F.logsigmoid``'s backward). A plain tensor goes to ``fn``; on a
    ``DTensor`` ``fn`` runs on each rank's shard, which is exact for an
    elementwise function (a pending sum is reduced first), and the result
    and its gradient keep the input's placements."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import DTensor, Replicate
    keep = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    x = x.redistribute(x.device_mesh, keep)
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, keep,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


class _ShapeOnlyGenerator(torch.Generator):
    """The generator of a meta-device init: meta tensors hold no data, so
    nothing is drawn; ``device`` puts every leaf on the meta device."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def generator(device: torch.device, seed: int) -> torch.Generator:
    """The init generator on ``device`` seeded with ``seed``; on the meta
    device one that draws nothing (torch has no meta generator)."""
    if device.type == "meta":
        return _ShapeOnlyGenerator()
    return torch.Generator(device=device).manual_seed(seed)


def truncnorm_init(gen: torch.Generator, shape, scale=0.02,
                   dtype=torch.float32) -> torch.Tensor:
    """``scale`` x a standard normal truncated to [-2, 2] (the reference's
    ``jax.random.truncated_normal``), drawn on ``gen``'s device."""
    t = torch.empty(shape, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (scale * t).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, scale=None) -> torch.Tensor:
    scale = scale if scale is not None else d_in ** -0.5
    return truncnorm_init(gen, (d_in, d_out), scale, dtype)


def rmsnorm_params(d: int, device) -> dict:
    return {"scale": torch.ones((d,), device=device)}


def layernorm_params(d: int, device) -> dict:
    return {"scale": torch.ones((d,), device=device),
            "bias": torch.zeros((d,), device=device)}


def apply_norm(p, x: torch.Tensor, kind: str, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:  # rmsnorm
        ms = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * p["scale"]
    return out.to(x.dtype)


def activate(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default
    return F.silu(x)


# ---------------------------------------------------------------------------
# Rotary position embeddings (GPT-NeoX half-rotation convention).
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's magnitude correction: 0.1 m ln(factor) + 1 (1 unscaled)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


# (head_dim, theta, scaling, device) -> yarn_freqs' table, made once: a
# decode step would otherwise launch its ~14 small kernels in every layer
_YARN_FREQS: dict = {}


def yarn_freqs(head_dim: int, theta: float, scaling, device=None) -> torch.Tensor:
    """YaRN's inverse frequencies, as DeepSeek-V2's
    ``DeepseekV2YarnRotaryEmbedding`` computes them: the pairs below the
    correction range keep ``rope_freqs``, those from its top up are divided
    by ``scaling.factor``, with a linear ramp between. The range is where a
    pair turns ``beta_fast`` and ``beta_slow`` times over the original
    context (pairs 10 and 23 of 32 at DeepSeek-V2-Lite's 64, 10,000, 4096,
    32 and 1). Kept per device after the first call made outside a CUDA
    graph's capture (a table made inside one would live in the graph's
    memory)."""
    key = (head_dim, theta, scaling, torch.device(device or "cpu"))
    table = _YARN_FREQS.get(key)
    if table is None:
        table = _yarn_freqs(head_dim, theta, scaling, key[3])
        capturing = key[3].type == "cuda" \
            and torch.cuda.is_current_stream_capturing()
        if key[3].type != "meta" and not capturing:
            _YARN_FREQS[key] = table
    return table


def _yarn_freqs(head_dim: int, theta: float, scaling, device) -> torch.Tensor:
    half = head_dim // 2

    def pair(rotations):
        return head_dim * math.log(scaling.original_max_position
                                   / (rotations * 2 * math.pi)) \
            / (2 * math.log(theta))

    low = max(math.floor(pair(scaling.beta_fast)), 0)
    high = min(math.ceil(pair(scaling.beta_slow)), head_dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(half, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    extra = 1.0 / (theta ** exps)
    inter = 1.0 / (scaling.factor * theta ** exps)
    keep = 1.0 - ramp
    return inter * (1 - keep) + extra * keep


def rope_scale(scaling) -> float:
    """The factor on cos and sin: mscale(``mscale``) / mscale(``mscale_all_dim``)
    (1 without scaling, and at DeepSeek-V2-Lite's equal 0.707s)."""
    if scaling is None:
        return 1.0
    return yarn_mscale(scaling.factor, scaling.mscale) \
        / yarn_mscale(scaling.factor, scaling.mscale_all_dim)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float, scaling=None) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) int. ``scaling``:
    a ``configs.base.YarnScaling`` or None (plain RoPE)."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device) if scaling is None \
        else yarn_freqs(x.shape[-1], theta, scaling, x.device)   # (half,)
    angles = positions[..., None].float() * freqs              # (..., seq, half)
    cos = torch.cos(angles)[..., None, :]                      # (..., seq, 1, half)
    sin = torch.sin(angles)[..., None, :]
    m = rope_scale(scaling)
    if m != 1.0:
        cos, sin = cos * m, sin * m
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


def causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                window: Optional[int] = None) -> torch.Tensor:
    """(..., q, k) boolean mask: True = attend. Sliding window if set."""
    m = k_pos[..., None, :] <= q_pos[..., :, None]
    if window is not None:
        m &= k_pos[..., None, :] > (q_pos[..., :, None] - window)
    return m


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean NLL over (optionally masked) positions; logits fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
