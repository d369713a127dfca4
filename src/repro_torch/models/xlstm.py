"""xLSTM blocks: mLSTM (matrix memory, parallel form for training) and sLSTM
(scalar memory, sequential recurrence), arXiv:2405.04517. Port of
``repro/models/xlstm.py``.

mLSTM runs the stabilized quadratic parallel form (a decay matrix D from
cumulative log forget gates) or, with ``RUNTIME["mlstm_chunk"]``, the
chunkwise-recurrent form, whose quadratic tile is one chunk square and
whose chunks compose through the O(1) state (C (B,H,dk,dv), n (B,H,dk),
m (B,H)) with the running maxima of the log gates that keep the
exponentials finite. Decode keeps that state. sLSTM has a true
hidden-to-hidden recurrence, so its full pass is a Python loop over the
sequence (the reference's ``lax.scan``). Decode steps update their caches
in place (the reference donates them), so a step can be captured in a CUDA
graph.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import XLSTMSpec
from repro_torch.models import common as cc
from repro_torch.models.common import activate, dense_init
from repro_torch.models.ssm import causal_conv


def _logsigmoid(x):
    """``F.logsigmoid``, shard by shard on a ``DTensor`` (DTensor has no
    rule for its backward)."""
    return cc.shardwise(F.logsigmoid, x)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def _dims(spec: XLSTMSpec, d_model: int):
    d_in = int(spec.proj_factor * d_model)
    return d_in, d_in // spec.n_heads


def init_mlstm(gen: torch.Generator, spec: XLSTMSpec, d_model: int,
               dtype) -> dict:
    d_in, _ = _dims(spec, d_model)
    dev = gen.device
    return {
        "up": dense_init(gen, d_model, 2 * d_in, dtype),
        "conv_w": (torch.randn((spec.conv_width, d_in), generator=gen,
                               device=dev) * 0.1).to(dtype),
        "conv_b": torch.zeros((d_in,), dtype=dtype, device=dev),
        "wq": dense_init(gen, d_in, d_in, dtype),
        "wk": dense_init(gen, d_in, d_in, dtype),
        "wv": dense_init(gen, d_in, d_in, dtype),
        "w_if": dense_init(gen, d_in, 2 * spec.n_heads, torch.float32),
        "b_i": torch.zeros((spec.n_heads,), device=dev),
        "b_f": torch.full((spec.n_heads,), 3.0, device=dev),  # open forget gates
        "ogate_skip": dense_init(gen, d_model, d_in, dtype),
        "down": dense_init(gen, d_in, d_model, dtype),
    }


def _qkv_gates(p, spec: XLSTMSpec, x_main, conv_out):
    b, s, d_in = x_main.shape
    nh = spec.n_heads
    dh = d_in // nh
    q = (conv_out @ p["wq"]).reshape(b, s, nh, dh)
    k = (conv_out @ p["wk"]).reshape(b, s, nh, dh) * dh ** -0.5
    v = (x_main @ p["wv"]).reshape(b, s, nh, dh)
    gates = (x_main.float() @ p["w_if"]).reshape(b, s, nh, 2)
    return q, k, v, gates[..., 0] + p["b_i"], gates[..., 1] + p["b_f"]


def _decay_matrix(cum, i_pre):
    """D~[t, s] = (F_t - F_s) + i~_s for s <= t, -inf above the diagonal:
    (B, T, S, H) from the cumulative log forget gates F (B, S, H)."""
    s = cum.shape[1]
    dmat = cum[:, :, None, :] - cum[:, None, :, :] + i_pre[:, None, :, :]
    tril = torch.ones((s, s), dtype=torch.bool, device=cum.device).tril()
    return dmat.masked_fill(~tril[None, :, :, None], float("-inf"))


def _mlstm_quadratic(q, k, v, i_pre, f_pre):
    """Stabilized quadratic parallel form over one (sub)sequence with no
    incoming state. Returns h (B,S,H,dh) fp32."""
    dmat = _decay_matrix(torch.cumsum(_logsigmoid(f_pre), dim=1), i_pre)
    # rows are all -inf only off the diagonal
    m = dmat.amax(dim=2, keepdim=True).clamp(min=-1e30)      # (B,T,1,H)
    dexp = torch.exp(dmat - m)
    scores = torch.einsum("bthd,bshd->btsh", q.float(), k.float())
    sd = scores * dexp
    norm = torch.maximum(sd.sum(dim=2, keepdim=True).abs(), torch.exp(-m))
    return torch.einsum("btsh,bshd->bthd", sd / norm, v.float())


def _mlstm_chunk(c0, n0, m0, q_, k_, v_, i_, f_):
    """One chunk (B,L,H,*) from state (c0, n0, m0): (h, c, n, m)."""
    logf = _logsigmoid(f_)                                   # (B,L,H)
    fc = torch.cumsum(logf, dim=1)
    dmat = _decay_matrix(fc, i_)                             # (B,L,L,H)
    m_intra = dmat.amax(dim=2).clamp(min=-1e30)              # (B,L,H)
    m_inter = fc + m0[:, None]                               # (B,L,H)
    m_t = torch.maximum(m_intra, m_inter)
    dexp = torch.exp(dmat - m_t[:, :, None, :])
    qf, kf, vf = q_.float(), k_.float(), v_.float()
    sd = torch.einsum("bthd,bshd->btsh", qf, kf) * dexp
    inter_w = torch.exp(m_inter - m_t)                       # (B,L,H)
    num = (torch.einsum("btsh,bshd->bthd", sd, vf)
           + inter_w[..., None] * torch.einsum("bthk,bhkv->bthv", qf, c0))
    den = sd.sum(dim=2) + inter_w * torch.einsum("bthk,bhk->bth", qf, n0)
    h = num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]
    # state across the chunk boundary
    fl = fc[:, -1]                                           # (B,H)
    wlog = (fl[:, None, :] - fc) + i_                        # (B,L,H)
    m_new = torch.maximum(fl + m0, wlog.amax(dim=1))
    carry = torch.exp(fl + m0 - m_new)                       # (B,H)
    wexp = torch.exp(wlog - m_new[:, None, :])
    c_new = carry[..., None, None] * c0 + torch.einsum(
        "bsh,bshk,bshv->bhkv", wexp, kf, vf)
    n_new = carry[..., None] * n0 + torch.einsum("bsh,bshk->bhk", wexp, kf)
    return h, c_new, n_new, m_new


def _mlstm_chunkwise(q, k, v, i_pre, f_pre, chunk: int, state=None):
    """Chunkwise-recurrent mLSTM: the quadratic D matrix lives one
    (chunk x chunk) tile at a time, and chunks compose through the O(1)
    (C, n, m) state with the decode step's stabilization (chunked == full
    up to float associativity). Each chunk runs under a checkpoint when a
    backward follows. Returns (h (B,S,H,dh) fp32, final state dict)."""
    b, s, nh, dh = q.shape
    if state is None:
        state = {"c": torch.zeros((b, nh, dh, dh), device=q.device),
                 "n": torch.zeros((b, nh, dh), device=q.device),
                 "m": torch.full((b, nh), -1e30, device=q.device)}
    c, n, m = state["c"], state["n"], state["m"]
    hs = []
    # split, not a slice per chunk: split's backward concatenates the
    # chunks' gradients, where each slice's would fill a zero tensor of the
    # whole sequence (quadratic in the number of chunks)
    for parts in zip(*(t.split(chunk, dim=1)
                       for t in (q, k, v, i_pre, f_pre))):
        args = (c, n, m) + parts
        h, c, n, m = checkpoint(_mlstm_chunk, *args, use_reentrant=False,
                                preserve_rng_state=False) \
            if torch.is_grad_enabled() else _mlstm_chunk(*args)
        hs.append(h)
    return torch.cat(hs, dim=1), {"c": c, "n": n, "m": m}


def _closed_form_state(k, v, i_pre, f_pre) -> dict:
    """The (C, n, m) state after a whole sequence, in closed form."""
    cum = torch.cumsum(_logsigmoid(f_pre), dim=1)
    wlog = (cum[:, -1:, :] - cum) + i_pre                    # (B,S,H)
    m = wlog.amax(dim=1)                                     # (B,H)
    wexp = torch.exp(wlog - m[:, None, :])
    kf = k.float()
    return {"c": torch.einsum("bsh,bshk,bshv->bhkv", wexp, kf, v.float()),
            "n": torch.einsum("bsh,bshk->bhk", wexp, kf), "m": m}


def _mlstm_inner(p, spec: XLSTMSpec, x, want_state: bool):
    b, s, _ = x.shape
    x_main, z = (x @ p["up"]).chunk(2, dim=-1)
    conv_out = causal_conv(p["conv_w"], p["conv_b"], x_main)
    q, k, v, i_pre, f_pre = _qkv_gates(p, spec, x_main, conv_out)
    chunk = cc.RUNTIME["mlstm_chunk"]
    state = None
    if chunk and s > chunk and s % chunk == 0:
        h, state = _mlstm_chunkwise(q, k, v, i_pre, f_pre, chunk)
    else:
        h = _mlstm_quadratic(q, k, v, i_pre, f_pre)
        if want_state:
            state = _closed_form_state(k, v, i_pre, f_pre)
    h = h.reshape(b, s, -1).to(x.dtype)
    h = h * F.silu(z + x @ p["ogate_skip"])
    y = h @ p["down"]
    if not want_state:
        return y, None
    tail = spec.conv_width - 1
    conv_tail = x_main[:, -tail:] if s >= tail \
        else F.pad(x_main, (0, 0, tail - s, 0))
    return y, {**state, "conv": conv_tail.contiguous()}


def mlstm_full(p, spec: XLSTMSpec, x):
    """Parallel stabilized form (chunkwise when RUNTIME asks). x: (B,S,d)."""
    return _mlstm_inner(p, spec, x, want_state=False)[0]


def mlstm_prefill(p, spec: XLSTMSpec, x):
    """Forward + the final state (closed form, or the chunkwise carry)."""
    return _mlstm_inner(p, spec, x, want_state=True)


def init_mlstm_cache(spec: XLSTMSpec, d_model: int, batch: int, dtype,
                     device) -> dict:
    d_in, dh = _dims(spec, d_model)
    nh = spec.n_heads
    return {
        "c": torch.zeros((batch, nh, dh, dh), device=device),
        "n": torch.zeros((batch, nh, dh), device=device),
        "m": torch.full((batch, nh), -1e30, device=device),
        "conv": torch.zeros((batch, spec.conv_width - 1, d_in), dtype=dtype,
                            device=device),
    }


def mlstm_decode(p, spec: XLSTMSpec, x, cache: dict):
    """O(1) recurrent step. x: (B,1,d). Updates ``cache`` in place; returns
    (y, cache)."""
    b = x.shape[0]
    x_main, z = (x @ p["up"]).chunk(2, dim=-1)               # (B,1,d_in)
    window = torch.cat([cache["conv"], x_main], dim=1)
    conv_out = F.silu(torch.einsum("bkd,kd->bd", window.float(),
                                   p["conv_w"].float()) + p["conv_b"])
    conv_out = conv_out[:, None, :].to(x.dtype)
    q, k, v, i_pre, f_pre = _qkv_gates(p, spec, x_main, conv_out)
    q, k, v = q[:, 0].float(), k[:, 0], v[:, 0]              # (B,H,dh)
    i_pre, f_pre = i_pre[:, 0], f_pre[:, 0]                  # (B,H)

    logf = _logsigmoid(f_pre)
    m_new = torch.maximum(logf + cache["m"], i_pre)
    f_eff = torch.exp(logf + cache["m"] - m_new)[..., None]
    i_eff = torch.exp(i_pre - m_new)[..., None]
    c = cache["c"] * f_eff[..., None] + i_eff[..., None] \
        * k[..., :, None] * v[..., None, :]                  # (B,H,dk,dv)
    n = cache["n"] * f_eff + i_eff * k
    denom = torch.maximum(torch.einsum("bhk,bhk->bh", n, q).abs(),
                          torch.exp(-m_new))[..., None]
    h = torch.einsum("bhkv,bhk->bhv", c, q) / denom
    h = h.reshape(b, 1, -1).to(x.dtype)
    h = h * F.silu(z + x @ p["ogate_skip"])
    y = h @ p["down"]
    for key, val in (("c", c), ("n", n), ("m", m_new), ("conv", window[:, 1:])):
        cache[key].copy_(val)
    return y, cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def init_slstm(gen: torch.Generator, spec: XLSTMSpec, d_model: int,
               dtype) -> dict:
    nh = spec.n_heads
    dh = d_model // nh
    d_ff = int(d_model * 4 / 3)
    dev = gen.device
    ffn_gate = dense_init(gen, d_model, d_ff, dtype)
    return {
        "w_gates": dense_init(gen, d_model, 4 * d_model, torch.float32),
        # block-diagonal recurrent weights: per head (dh, 4*dh)
        "r_gates": torch.randn((nh, dh, 4 * dh), generator=gen, device=dev)
        / dh ** 0.5,
        "b_gates": torch.cat([
            torch.zeros((d_model,), device=dev),
            torch.full((d_model,), 3.0, device=dev),         # i, f
            torch.zeros((2 * d_model,), device=dev)]),       # z, o
        "ffn_gate": ffn_gate,
        # the reference draws ffn_gate and ffn_up from one key: equal at init
        "ffn_up": ffn_gate.clone(),
        "ffn_down": dense_init(gen, d_ff, d_model, dtype),
    }


def init_slstm_state(spec: XLSTMSpec, d_model: int, batch: int,
                     device) -> dict:
    """Zero c and h, n at 1e-6, m at -1e30: four tensors of their own, so
    that a decode step can write each in place."""
    shape = (batch, spec.n_heads, d_model // spec.n_heads)
    return {"c": torch.zeros(shape, device=device),
            "n": torch.full(shape, 1e-6, device=device),
            "h": torch.zeros(shape, device=device),
            "m": torch.full(shape, -1e30, device=device)}


def _slstm_step(p, spec: XLSTMSpec, state, x_t):
    """x_t: (B, d_model) fp32. Returns (new_state, h_out (B, d_model))."""
    b, d = x_t.shape
    nh = spec.n_heads
    dh = d // nh
    rec = torch.einsum("bhd,hde->bhe", state["h"], p["r_gates"])  # (B,H,4dh)
    gates = (x_t @ p["w_gates"] + p["b_gates"]).reshape(b, nh, 4, dh) \
        + rec.reshape(b, nh, 4, dh)
    i_pre, f_pre, z_pre, o_pre = gates.unbind(dim=2)
    logf = _logsigmoid(f_pre)
    m_new = torch.maximum(logf + state["m"], i_pre)
    i_eff = torch.exp(i_pre - m_new)
    f_eff = torch.exp(logf + state["m"] - m_new)
    c = f_eff * state["c"] + i_eff * torch.tanh(z_pre)
    n = f_eff * state["n"] + i_eff
    h = torch.sigmoid(o_pre) * c / torch.clamp(n, min=1e-6)
    return {"c": c, "n": n, "h": h, "m": m_new}, h.reshape(b, d)


def _slstm_ffn(p, h):
    """Gated FFN (pf 4/3) as in the paper's sLSTM block."""
    return (activate(h @ p["ffn_gate"], "gelu") * (h @ p["ffn_up"])) \
        @ p["ffn_down"]


def _slstm_scan(p, spec: XLSTMSpec, x):
    """The recurrence over the sequence: (h (B,S,d) in x's dtype, final
    state)."""
    b, _, d = x.shape
    state = init_slstm_state(spec, d, b, x.device)
    hs = []
    # unbind, not x[:, t]: unbind's backward stacks the steps' gradients,
    # where each index's would fill a zero tensor of the whole sequence
    # (quadratic in its length)
    for x_t in x.float().unbind(1):
        state, h_t = _slstm_step(p, spec, state, x_t)
        hs.append(h_t)
    return torch.stack(hs, dim=1).to(x.dtype), state


_SCAN_WEIGHTS = ("w_gates", "r_gates", "b_gates")


def _slstm_scan_local(p, spec: XLSTMSpec, x):
    """``_slstm_scan`` of a ``DTensor`` x: each rank runs the recurrence on
    its shard of the batch, every other dim whole, with the gate weights
    whole (gathered once, not once per token), and ``h`` leaves split as
    the batch was. A rank's weight gradients cover its batch rows, so they
    leave as pending sums over the batch-splitting mesh dims. The final
    state stays on each rank (a training step drops it)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = x.device_mesh
    xp = tuple(p_ if p_ == Shard(0) else Replicate() for p_ in x.placements)
    whole = (Replicate(),) * mesh.ndim
    grad_wp = tuple(Partial() if p_ == Shard(0) else Replicate() for p_ in xp)
    x = x.redistribute(mesh, xp)
    w = {k: p[k].redistribute(mesh, whole).to_local(grad_placements=grad_wp)
         for k in _SCAN_WEIGHTS}
    h, state = _slstm_scan(w, spec, x.to_local())
    return DTensor.from_local(h, mesh, xp, run_check=False, shape=x.shape,
                              stride=x.stride()), state


def slstm_prefill(p, spec: XLSTMSpec, x):
    """Sequential loop over the sequence (a true recurrence). x: (B,S,d).
    Returns (y, final state). A ``DTensor`` x runs the loop per rank on
    local shards (``_slstm_scan_local``)."""
    scan = _slstm_scan_local if cc.is_dtensor(x) else _slstm_scan
    h, state = scan(p, spec, x)
    return _slstm_ffn(p, h), state


def slstm_full(p, spec: XLSTMSpec, x):
    return slstm_prefill(p, spec, x)[0]


def slstm_decode(p, spec: XLSTMSpec, x, cache: dict):
    """x: (B,1,d). Updates the state ``cache`` in place; returns
    (y, cache)."""
    new_state, h = _slstm_step(p, spec, cache, x[:, 0].float())
    for key, val in new_state.items():
        cache[key].copy_(val)
    return _slstm_ffn(p, h[:, None, :].to(x.dtype)), cache
