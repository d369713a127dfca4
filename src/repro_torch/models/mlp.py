"""MLP layers: dense (gated SiLU or plain GeLU) and Mixture-of-Experts.
Port of ``repro/models/mlp.py``.

MoE keeps the reference's GShard formulation: top-k capacity routing in
which every group routes on its own with a per-group capacity, one-hot
dispatch and combine tensors (G, n, E, C) contracted with einsums (batched
matmuls, cuBLAS on the card), the Switch load-balance aux loss, no dropping
on small token counts (decode, or n <= 256), and long sequences taken one
``moe_seq_chunk`` at a time (a loop over chunks, each under its own
checkpoint when a backward follows, the reference's rematerialized scan).

Two places where torch and JAX differ, and the port keeps the reference's
decisions token for token:

* Ties in top-k. ``jax.lax.top_k`` puts the lower expert index first on a
  tie; ``torch.topk`` promises no order. The port takes the first k of a
  stable descending sort, which orders ties by index on the CPU and CUDA.
* One-hots of out-of-range indices. ``jax.nn.one_hot`` gives a zero row for
  an index past its range, and the reference's ``_route`` leans on that for
  choices past an expert's capacity. The port never builds those one-hots:
  it writes each kept choice's gate weight into the combine tensor at
  (expert, slot) with one ``scatter_``, and a dropped choice writes 0 at
  slot 0 of its expert, a cell no other choice of the same token writes
  (a token's top-k experts are distinct). The result equals the
  reference's sum of one-hot products: each cell has at most one term.
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import obs
from repro_torch.configs.base import MoESpec
from repro_torch.models import common as cc
from repro_torch.models.common import (activate, dense_init, logical_constraint,
                                       truncnorm_init)
from repro_torch.obs.device import count, span


# ---------------------------------------------------------------------------
# Dense MLP
# ---------------------------------------------------------------------------
def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, act: str,
             dtype) -> dict:
    p = {
        "w_up": dense_init(gen, d_model, d_ff, dtype),
        "w_down": dense_init(gen, d_ff, d_model, dtype),
    }
    if act == "silu":  # gated (SwiGLU)
        p["w_gate"] = dense_init(gen, d_model, d_ff, dtype)
    return p


def mlp(p, x: torch.Tensor, act: str) -> torch.Tensor:
    h = x @ p["w_up"]
    if "w_gate" in p:
        h = activate(x @ p["w_gate"], act) * h
    else:
        h = activate(h, act)
    h = logical_constraint(h, cc.BATCH, None, cc.FF)
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------
# Read-only recorder of routing decisions, for comparing two runs of one
# model: None, or the list that ``record_routing`` installs, to which every
# ``moe`` call appends (gate_idx, keep, margin): the expert of each choice
# and whether it fit in the expert's capacity, (B, S, top_k), and each
# token's margin (B, S), the least gap between neighbours among its k + 1
# largest router probabilities, which says how near a tie its choices and
# their order (which decides who gets a slot first) were. It changes no
# result.
_ROUTING: list | None = None


@contextlib.contextmanager
def record_routing():
    """Record every ``moe`` call's routing decisions while the block runs;
    yields the list they are appended to, in call order."""
    global _ROUTING
    prev, _ROUTING = _ROUTING, []
    try:
        yield _ROUTING
    finally:
        _ROUTING = prev


class RoutingRecord:
    """The experts each MoE layer chose for each (row, position), kept on the
    device: ``experts`` (n_layers, batch, max_len, top_k), uint8 (int16 past
    256 experts). The calls of ``moe`` fill it in turn, layer after layer,
    as a forward or a decode step makes them: a full-sequence call writes
    positions 0 .. S-1 of every row, a decode call writes its step's
    position with an ``index_copy_`` at the 0-d ``pos`` tensor, so a
    captured decode step writes each replay's position. Nothing is read
    back to the host; a caller copies ``experts`` out when it wants them."""

    def __init__(self, n_layers: int, batch: int, max_len: int, top_k: int,
                 n_experts: int, device):
        dtype = torch.uint8 if n_experts <= 256 else torch.int16
        self.experts = torch.zeros((n_layers, batch, max_len, top_k),
                                   dtype=dtype, device=device)
        self.calls = 0

    def write(self, gate_idx: torch.Tensor, pos=None) -> None:
        """gate_idx (B, S, top_k) of the next layer in turn; ``pos``: None
        (positions 0 .. S-1) or the one position of a decode step."""
        layer = self.calls % self.experts.shape[0]
        self.calls += 1
        idx = gate_idx.to(self.experts.dtype)
        if pos is None:
            self.experts[layer, :, :idx.shape[1]].copy_(idx)
            return
        if not isinstance(pos, torch.Tensor):
            pos = torch.full((), pos, dtype=torch.int32, device=idx.device)
        self.experts[layer].index_copy_(1, pos.long().view(1), idx)


_DEVICE_RECORD: RoutingRecord | None = None


@contextlib.contextmanager
def record_routing_on_device(record: RoutingRecord):
    """Every ``moe`` call in the block writes its choices into ``record``
    (which a CUDA graph captured in the block goes on writing at each
    replay)."""
    global _DEVICE_RECORD
    prev, _DEVICE_RECORD = _DEVICE_RECORD, record
    try:
        yield record
    finally:
        _DEVICE_RECORD = prev


def init_moe(gen: torch.Generator, spec: MoESpec, d_model: int, act: str,
             dtype) -> dict:
    e, f = spec.n_experts, spec.d_ff_expert
    p = {
        "router": dense_init(gen, d_model, e, torch.float32, scale=0.01),
        "w_up": truncnorm_init(gen, (e, d_model, f), 1.0, dtype)
        * d_model ** -0.5,
        "w_down": truncnorm_init(gen, (e, f, d_model), 1.0, dtype)
        * f ** -0.5,
    }
    if act == "silu":
        p["w_gate"] = truncnorm_init(gen, (e, d_model, f), 1.0, dtype) \
            * d_model ** -0.5
    if spec.n_shared:
        p["shared"] = init_mlp(gen, d_model, f * spec.n_shared, act, dtype)
    return p


def _expert_ffn(p, x_gecd, act: str):
    """x: (G, E, C, d) -> (G, E, C, d), batched over groups x experts."""
    h = torch.einsum("gecd,edf->gecf", x_gecd, p["w_up"])
    if "w_gate" in p:
        g = torch.einsum("gecd,edf->gecf", x_gecd, p["w_gate"])
        h = activate(g, act) * h
    else:
        h = activate(h, act)
    h = logical_constraint(h, cc.BATCH, cc.EXPERT, None, None)
    return torch.einsum("gecf,efd->gecd", h, p["w_down"])


def _sorted(probs: torch.Tensor):
    """Descending along the last axis, ties lower index first (the order of
    ``jax.lax.top_k``)."""
    return torch.sort(probs, dim=-1, descending=True, stable=True)


def _gates(top_vals: torch.Tensor, spec: MoESpec) -> torch.Tensor:
    """The chosen experts' gate weights from their router probabilities:
    normalized to sum 1 (``norm_topk_prob``, the reference's rule), else
    the probabilities times ``routed_scaling_factor`` (DeepSeek-V2's)."""
    if spec.norm_topk_prob:
        return top_vals / torch.clamp(top_vals.sum(-1, keepdim=True), min=1e-9)
    return top_vals * spec.routed_scaling_factor


def _margin(sorted_vals: torch.Tensor, k: int) -> torch.Tensor:
    """The least gap between neighbours among the k + 1 largest
    probabilities (``record_routing``'s margin)."""
    top = sorted_vals[..., :k + 1]
    return (top[..., :-1] - top[..., 1:]).amin(-1) if top.shape[-1] > 1 \
        else torch.ones_like(top[..., 0])


def _route(router_w, x, spec: MoESpec, capacity: int, decisions=None,
           chosen=None):
    """GShard grouped top-k capacity routing. x: (G, n, d): every group
    routes on its own with per-group capacity, so the dispatch tensor is
    (G, n, E, C) with C ~ n·k/E. Returns (dispatch, combine (G,n,E,C),
    aux_loss); with a list for ``decisions``, appends (gate_idx, keep,
    margin): (G, n, k), (G, n, k) and (G, n); with a list for ``chosen``,
    appends gate_idx alone."""
    g_, n, _ = x.shape
    e = spec.n_experts
    if cc.is_dtensor(x):
        # a group's capacity slots are a scan over all its tokens: route on
        # whole groups on every rank (DTensor's scan and scatter rules do
        # not see a split token axis)
        x, router_w = cc.whole(x), cc.whole(router_w)
    logits = torch.einsum("gnd,de->gne", x.float(), router_w)
    probs = torch.softmax(logits, dim=-1)
    sorted_vals, sorted_idx = _sorted(probs)
    gate_vals = _gates(sorted_vals[..., :spec.top_k], spec)  # (G, n, k)
    gate_idx = sorted_idx[..., :spec.top_k]

    # one-hot of every choice over the experts, (G, k, E, n): n innermost,
    # so the cumsum over tokens below scans the contiguous axis
    hit = (gate_idx.transpose(1, 2)[:, :, None, :]
           == torch.arange(e, device=x.device)[:, None]).to(torch.int32)

    # aux load-balance loss (Switch): E * sum_e f_e * P_e, averaged over groups
    me = probs.mean(dim=1)                                   # (G, E)
    ce = hit.float().mean(dim=-1).sum(dim=1)                 # (G, E)
    aux = e * (me * ce / spec.top_k).sum(-1).mean()

    # slot of each choice in its expert: all choices of a lower rank come
    # first, then earlier tokens' choices of the same rank
    counts = hit.sum(dim=-1, dtype=torch.int32)              # (G, k, E)
    before = counts.cumsum(dim=1, dtype=torch.int32) - counts
    pos = hit.cumsum(dim=-1, dtype=torch.int32) - 1 + before[..., None]
    slot = pos.gather(2, gate_idx.transpose(1, 2)[:, :, None, :])[:, :, 0]
    keep = (slot < capacity).transpose(1, 2)                 # (G, n, k)
    slot = slot.transpose(1, 2).long()

    # bf16 routing tensors halve the (G,n,E,C) traffic (the reference's
    # moe_combine_bf16 knob); gate weights in [0, 1] route the same
    rdt = torch.bfloat16 if cc.RUNTIME.get("moe_combine_bf16") else torch.float32
    flat = gate_idx * capacity + torch.where(keep, slot, 0)
    vals = torch.where(keep, gate_vals, 0.0).to(rdt)
    combine = torch.zeros((g_, n, e * capacity), dtype=rdt, device=x.device)
    combine = combine.scatter(2, flat, vals).view(g_, n, e, capacity)
    combine = logical_constraint(combine, cc.BATCH, None, cc.EXPERT, None)
    dispatch = combine > 0
    if decisions is not None:
        decisions.append((gate_idx, keep, _margin(sorted_vals, spec.top_k)))
    if chosen is not None:
        chosen.append(gate_idx)
    return dispatch, combine, aux


def _moe_grouped(p, spec: MoESpec, x_gnd, act: str, capacity: int,
                 decisions=None, chosen=None):
    """x: (G, n, d) -> (y (G, n, d), aux)."""
    with span("model.moe.route"):
        dispatch, combine, aux = _route(p["router"], x_gnd, spec, capacity,
                                        decisions, chosen)
    with span("model.moe.experts"):
        dispatched = torch.einsum("gnec,gnd->gecd", dispatch.to(x_gnd.dtype),
                                  x_gnd)
        dispatched = logical_constraint(dispatched, cc.BATCH, cc.EXPERT, None,
                                        None)
        del dispatch
        out = _expert_ffn(p, dispatched, act)
        y = torch.einsum("gnec,gecd->gnd", combine.to(x_gnd.dtype), out)
    return y, aux


# tokens a dropless call routes and computes at once: bounds its (tokens x
# top_k, d) transients (~5 GB at DeepSeek-V2-Lite's widths) whatever the
# batch
DROPLESS_CHUNK = 32_768


def expert_rows(p, xs, counts, act: str, grouped: bool | None = None):
    """The experts' FFN over rows sorted by expert: xs (m, d) holds
    ``counts[e]`` rows for expert e, in expert order -> (m, d). ``grouped``
    (None: where it runs, a bf16 CUDA tensor and a torch that has it): one
    ``torch._grouped_mm`` a projection over every expert, reading the row
    offsets on the device; else a loop of one matmul a projection and
    expert, whose sizes the host reads."""
    if grouped is None:
        grouped = (xs.is_cuda and xs.dtype == torch.bfloat16
                   and hasattr(torch, "_grouped_mm"))
    if grouped:
        offs = counts.cumsum(0).to(torch.int32)

        def mm(a, w):
            return torch._grouped_mm(a, w, offs=offs)
    else:
        ends = counts.cumsum(0).tolist()
        rows = [(e, s0, s1) for e, (s0, s1) in enumerate(zip([0] + ends, ends))
                if s1 > s0]

        def mm(a, w):
            return torch.cat([a[s0:s1] @ w[e] for e, s0, s1 in rows])
    h = mm(xs, p["w_up"])
    h = activate(mm(xs, p["w_gate"]), act) * h if "w_gate" in p \
        else activate(h, act)
    return mm(h, p["w_down"])


def _moe_dropless(p, spec: MoESpec, x, act: str, decisions=None):
    """x (n, d) -> (y (n, d), the router probabilities summed over the
    tokens (E,), the choices per expert (E,), the choices (n, k)). Every
    choice is computed:
    the choices sorted by expert (stable, so a token's rows keep token
    order within an expert), the rows gathered, the experts' FFN over them
    (``expert_rows``), the outputs put back in (token, choice) order and
    summed with their gates in fp32."""
    n, d = x.shape
    k, e = spec.top_k, spec.n_experts
    with span("model.moe.route"):
        probs = torch.softmax(x.float() @ p["router"], dim=-1)
        sorted_vals, sorted_idx = _sorted(probs)
        gate_idx = sorted_idx[:, :k]
        gates = _gates(sorted_vals[:, :k], spec)
        flat = gate_idx.reshape(-1)
        order = torch.argsort(flat, stable=True)
        counts = torch.bincount(flat, minlength=e)
    with span("model.moe.experts"):
        out = expert_rows(p, x[order // k], counts, act)
        out = torch.empty_like(out).index_copy_(0, order, out)
        y = (out.view(n, k, d).float() * gates[..., None]).sum(1).to(x.dtype)
    if decisions is not None:
        decisions.append((gate_idx[None], torch.ones_like(gate_idx[None],
                                                          dtype=torch.bool),
                          _margin(sorted_vals, k)[None]))
    return y, probs.sum(0), counts, gate_idx


def moe(p, spec: MoESpec, x, act: str, seq_chunk: int = 0,
        decode: bool = False, pos=None):
    """x: (B, S, d) -> (y, aux_loss).

    Dropless path (``spec.dropless``, not decoding): every choice of every
    token computed (``_moe_dropless``), ``DROPLESS_CHUNK`` tokens at a time.
    Chunked path (``seq_chunk`` set, not decoding, S a multiple of it and
    longer): groups are the batch rows, one sequence chunk at a time, with
    per-group capacity C = chunk·k/E·cf; each chunk runs under a checkpoint
    when a backward follows. Otherwise one group of all B·S tokens, with no
    dropping when decoding or at n <= 256 tokens.

    ``pos``: a decode step's position (an int or a 0-d tensor), where a
    ``RoutingRecord`` installed by ``record_routing_on_device`` writes the
    step's choices. With a recorder installed (``obs.recording``) the
    routing and the experts are the spans ``model.moe.route`` and
    ``model.moe.experts``, and the call adds its choices (B·S·k) to the
    counter ``moe.choices`` and those past an expert's capacity to
    ``moe.dropped`` (0 on the dropless path and wherever the capacity holds
    every token; otherwise read with a sync, and not counted inside a CUDA
    graph's capture)."""
    b, s, d = x.shape
    n = b * s
    # launcher/perf-iteration overrides (0 = use the config's values)
    seq_chunk = cc.RUNTIME.get("moe_chunk", 0) or seq_chunk
    cf = cc.RUNTIME.get("moe_capacity_factor", 0.0) or spec.capacity_factor
    counting = obs.current().enabled
    dropless = spec.dropless and not decode
    chunked = (not dropless and seq_chunk and not decode
               and s % seq_chunk == 0 and s > seq_chunk)
    if dropless:
        may_drop = False
    elif chunked:
        n_chunks = s // seq_chunk
        cap = max(1, int(seq_chunk * spec.top_k / spec.n_experts * cf))
        may_drop = cap < seq_chunk
    else:
        if decode or n <= 256:
            capacity = n                   # no dropping on small token counts
        else:
            capacity = max(1, int(n * spec.top_k / spec.n_experts
                                  * spec.capacity_factor))
        may_drop = capacity < n
    # (gate_idx, keep, margin) for the host recorder, and for the drop
    # counter where a choice can be dropped; the choices alone for the
    # device record
    decisions = [] if (_ROUTING is not None or (counting and may_drop)) \
        else None
    chosen = [] if _DEVICE_RECORD is not None else None

    if dropless:
        x_flat = x.reshape(n, d)
        parts, local = [], [] if decisions is not None else None
        for c0 in range(0, n, DROPLESS_CHUNK):
            parts.append(_moe_dropless(p, spec, x_flat[c0:c0 + DROPLESS_CHUNK],
                                       act, local))
        y = torch.cat([q[0] for q in parts]) if len(parts) > 1 else parts[0][0]
        prob_sum = sum(q[1] for q in parts)
        counts = sum(q[2] for q in parts)
        aux = spec.n_experts * (prob_sum / n * counts.float() / n
                                / spec.top_k).sum()
        if local is not None:
            decisions.append(tuple(torch.cat(ts, dim=1) for ts in zip(*local)))
        if chosen is not None:
            chosen.append(torch.cat([q[3] for q in parts])
                          if len(parts) > 1 else parts[0][3])
    elif chunked:
        ys, aux_sum = [], torch.zeros((), device=x.device)
        for c0 in range(0, s, seq_chunk):
            args = (p, spec, x[:, c0:c0 + seq_chunk], act, cap, decisions,
                    chosen)
            # (a recompute in the backward appends to ``decisions`` again,
            # after this call has read it)
            yi, aux_i = checkpoint(_moe_grouped, *args, use_reentrant=False,
                                   preserve_rng_state=False) \
                if torch.is_grad_enabled() else _moe_grouped(*args)
            ys.append(yi)
            aux_sum = aux_sum + aux_i
        y = torch.cat(ys, dim=1).reshape(n, d)
        aux = aux_sum / n_chunks
    else:
        y, aux = _moe_grouped(p, spec, x.reshape(1, n, d), act, capacity,
                              decisions, chosen)
        y = y.reshape(n, d)

    if decisions is not None:
        gate_idx, keep, margin = (torch.cat([t.reshape(b, -1, *t.shape[2:])
                                             for t in ts], dim=1)
                                  for ts in zip(*decisions))
        if _ROUTING is not None:
            _ROUTING.append((gate_idx, keep, margin))
    if chosen is not None:
        _DEVICE_RECORD.write(
            torch.cat([t.reshape(b, -1, spec.top_k) for t in chosen], dim=1)
            if len(chosen) > 1 else chosen[0].reshape(b, s, spec.top_k),
            pos if decode else None)
    if counting:
        count("moe.choices", n * spec.top_k)
        if not may_drop:
            count("moe.dropped", 0)
        elif not (x.is_cuda and torch.cuda.is_current_stream_capturing()):
            count("moe.dropped", int((~keep).sum()))
    x_flat = x.reshape(n, d)
    if spec.n_shared:
        y = y + mlp(p["shared"], x_flat, act)
    return y.reshape(b, s, d), aux * spec.router_aux_weight
