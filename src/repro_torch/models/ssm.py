"""Mamba (selective SSM) block, Jamba's recurrent layer. Port of
``repro/models/ssm.py``.

Training and prefill run the selective scan h_t = dA_t·h_{t-1} + dBu_t over
the sequence as a log-depth scan in plain torch (``_linear_scan``: log2(S)
doubling steps of whole-tensor ops), the counterpart of the reference's
``jax.lax.associative_scan``; with ``RUNTIME["ssm_chunk"]`` it runs one
chunk at a time, carrying the state across chunks, so the (B, S, d_inner,
d_state) discretized tensors live one chunk at a time. Both forms sum in
another order than the reference's scan tree, so they agree with it, and
with each other, to fp32 rounding, not bit for bit. Decode keeps O(1)
state: h (B, d_inner, d_state) fp32 and the conv window (B, d_conv-1,
d_inner), which ``mamba_decode`` updates in place (the reference donates
them), so the step can be captured in a CUDA graph.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import MambaSpec
from repro_torch.models import common as cc
from repro_torch.models.common import dense_init, logical_constraint


def dt_rank(spec: MambaSpec, d_model: int) -> int:
    return spec.dt_rank or max(1, math.ceil(d_model / 16))


def d_inner(spec: MambaSpec, d_model: int) -> int:
    return spec.expand * d_model


def init_mamba(gen: torch.Generator, spec: MambaSpec, d_model: int,
               dtype) -> dict:
    di = d_inner(spec, d_model)
    dr = dt_rank(spec, d_model)
    dev = gen.device
    # S4D-real initialization for A
    a = torch.arange(1, spec.d_state + 1, dtype=torch.float32,
                     device=dev)[None, :].repeat(di, 1)
    log_dt = torch.empty((di,), device=dev).uniform_(
        math.log(1e-3), math.log(1e-1), generator=gen)
    return {
        "in_proj": dense_init(gen, d_model, 2 * di, dtype),
        "conv_w": (torch.randn((spec.d_conv, di), generator=gen, device=dev)
                   * 0.1).to(dtype),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "x_proj": dense_init(gen, di, dr + 2 * spec.d_state, dtype),
        "dt_proj": dense_init(gen, dr, di, dtype),
        "dt_bias": torch.log(torch.expm1(torch.exp(log_dt))),
        "a_log": torch.log(a),
        "d_skip": torch.ones((di,), device=dev),
        "out_proj": dense_init(gen, di, d_model, dtype),
    }


def _ssm_params(p, spec: MambaSpec, u):
    """u: (B, S, di) -> discretized (dA (B,S,di,ds), dBu (B,S,di,ds), C)."""
    dr = p["dt_proj"].shape[0]
    dt_in, b_mat, c_mat = (u @ p["x_proj"]).split(
        [dr, spec.d_state, spec.d_state], dim=-1)
    dt = F.softplus((dt_in @ p["dt_proj"]).float() + p["dt_bias"])  # (B,S,di)
    a = -torch.exp(p["a_log"])                                      # (di, ds)
    da = torch.exp(dt[..., None] * a)
    dbu = (dt * u.float())[..., None] * b_mat.float()[..., None, :]
    return da, dbu, c_mat.float()


def causal_conv(w, b, u):
    """Depthwise causal conv over the sequence, then SiLU. u: (B, S, C),
    w: (K, C). The products are summed in fp32 and rounded to u's dtype
    once."""
    k, s = w.shape[0], u.shape[1]
    x = F.pad(u, (0, 0, k - 1, 0)).float()
    wf = w.float()
    out = sum(x[:, i:i + s] * wf[i] for i in range(k))
    return F.silu(out.to(u.dtype) + b)


def _linear_scan(a, b):
    """Inclusive scan of h_t = a_t·h_{t-1} + b_t along axis 1 from h = 0, in
    log2(S) doubling steps (Hillis-Steele). Returns (a_0···a_t, h_t)."""
    s = a.shape[1]
    off = 1
    while off < s:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], 1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], 1)
        off *= 2
    return a, b


def _scan_chunk(p, spec: MambaSpec, h0, u_i):
    """One chunk of the scan from state h0: (y_i, h_last)."""
    da, dbu, c_i = _ssm_params(p, spec, u_i)
    cum_a, hs = _linear_scan(da, dbu)
    hs = hs + cum_a * h0[:, None]                            # carry in
    return torch.einsum("bsdn,bsn->bsd", hs, c_i), hs[:, -1]


def _scan_ssm(p, spec: MambaSpec, u):
    """Selective scan over u (B,S,di) -> (y_ssm fp32 (B,S,di), h_last).

    With RUNTIME["ssm_chunk"] set (and S a longer multiple of it), one
    chunk at a time, each under a checkpoint when a backward follows."""
    b, s, di = u.shape
    chunk = cc.RUNTIME["ssm_chunk"]
    if not chunk or s <= chunk or s % chunk != 0:
        da, dbu, c_mat = _ssm_params(p, spec, u)
        hs = _linear_scan(da, dbu)[1]
        return torch.einsum("bsdn,bsn->bsd", hs, c_mat), hs[:, -1]
    h = torch.zeros((b, di, spec.d_state), device=u.device)
    ys = []
    for c0 in range(0, s, chunk):
        args = (p, spec, h, u[:, c0:c0 + chunk])
        y_i, h = checkpoint(_scan_chunk, *args, use_reentrant=False,
                            preserve_rng_state=False) \
            if torch.is_grad_enabled() else _scan_chunk(*args)
        ys.append(y_i)
    return torch.cat(ys, dim=1), h


def _mamba(p, spec: MambaSpec, x):
    """(y, pre-conv activations u_pre, final state)."""
    u_pre, gate = (x @ p["in_proj"]).chunk(2, dim=-1)        # (B,S,di) each
    u_pre = logical_constraint(u_pre, cc.BATCH, None, cc.FF)
    u = causal_conv(p["conv_w"], p["conv_b"], u_pre)
    y, h_last = _scan_ssm(p, spec, u)
    y = (y + p["d_skip"] * u.float()).to(x.dtype)
    y = y * F.silu(gate)
    y = logical_constraint(y, cc.BATCH, None, cc.FF)
    return y @ p["out_proj"], u_pre, h_last


def mamba_full(p, spec: MambaSpec, x):
    """Train/prefill. x: (B,S,d) -> (B,S,d)."""
    return _mamba(p, spec, x)[0]


def mamba_prefill(p, spec: MambaSpec, x):
    """Forward + final recurrent state. x: (B,S,d) -> (y, cache)."""
    y, u_pre, h_last = _mamba(p, spec, x)
    # final state + conv tail (pre-conv activations feed the decode window)
    tail = spec.d_conv - 1
    s = x.shape[1]
    conv_tail = u_pre[:, -tail:] if s >= tail \
        else F.pad(u_pre, (0, 0, tail - s, 0))
    return y, {"h": h_last, "conv": conv_tail.contiguous()}


def init_mamba_cache(spec: MambaSpec, d_model: int, batch: int, dtype,
                     device) -> dict:
    di = d_inner(spec, d_model)
    return {
        "h": torch.zeros((batch, di, spec.d_state), device=device),
        "conv": torch.zeros((batch, spec.d_conv - 1, di), dtype=dtype,
                            device=device),
    }


def mamba_decode(p, spec: MambaSpec, x, cache: dict):
    """One-token step. x: (B,1,d). Updates ``cache`` in place; returns
    (y, cache)."""
    u, gate = (x @ p["in_proj"]).chunk(2, dim=-1)            # (B,1,di)
    window = torch.cat([cache["conv"], u], dim=1)            # (B,K,di)
    conv_out = torch.einsum("bkd,kd->bd", window.float(),
                            p["conv_w"].float()) + p["conv_b"]
    u1 = F.silu(conv_out)[:, None, :].to(x.dtype)            # (B,1,di)
    da, dbu, c_mat = _ssm_params(p, spec, u1)
    h = cache["h"] * da[:, 0] + dbu[:, 0]                    # (B,di,ds)
    y = torch.einsum("bdn,bn->bd", h, c_mat[:, 0])
    y = (y + p["d_skip"] * u1[:, 0].float()).to(x.dtype)
    y = (y[:, None, :] * F.silu(gate)) @ p["out_proj"]
    cache["h"].copy_(h)
    cache["conv"].copy_(window[:, 1:])
    return y, cache
