"""Geo-distributed training time model (paper §5-§6).

Separates per-step time into communication and computation, the two bars of
the paper's Figs. 8/10. Two communication models are provided:

* ``PaperLinearComm`` — faithful to the paper's Table 1 semantics: the cost of
  moving B bytes over link (i,j) is ``lat_ms[i,j] * B / 64`` (the table is "time
  to send 64 bytes"). Used for the reproduction figures.
* ``AlphaBetaComm`` — beyond-paper refinement: ``lat_ms + B / bandwidth`` with a
  bandwidth estimated from the latency class (WAN links get 0.05-1 GB/s, LAN
  10 GB/s). More realistic for bulk tensors; reported alongside.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.graph import ClusterGraph

MS = 1e-3


def routed_latency(latency_ms: np.ndarray) -> np.ndarray:
    """Shortest-path latency matrix: blocked pairs (0) relay through
    intermediates (real WANs route). Keeps System C finite on fleets with
    policy-blocked links. Diagonal stays 0."""
    from scipy.sparse.csgraph import shortest_path
    w = latency_ms.astype(np.float64).copy()
    w[w <= 0] = np.inf
    np.fill_diagonal(w, 0.0)
    sp = shortest_path(w, method="D", directed=False)
    sp[~np.isfinite(sp)] = 0.0  # truly disconnected stays "blocked"
    np.fill_diagonal(sp, 0.0)
    return sp.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class ModelTask:
    """A training job (paper §5.1/§6.3): e.g. OPT-175B, T5-11B, GPT-2, BERT."""
    name: str
    params: float                 # parameter count
    n_layers: int
    d_model: int
    batch_tokens: int = 524_288   # global tokens per step (e.g. 256 x 2048)
    microbatches: int = 8
    dtype_bytes: int = 2

    @property
    def param_bytes(self) -> float:
        return self.params * self.dtype_bytes

    @property
    def min_memory_gb(self) -> float:
        """Algorithm 1's minimum memory threshold M_n: params + grads + Adam
        moments (~16 bytes/param mixed-precision)."""
        return self.params * 16 / 1e9

    @property
    def flops_per_step(self) -> float:
        return 6.0 * self.params * self.batch_tokens

    @property
    def act_bytes_per_microbatch(self) -> float:
        """Activation tensor crossing a pipeline boundary for one microbatch."""
        tokens = self.batch_tokens / self.microbatches
        return tokens * self.d_model * self.dtype_bytes


# The paper's evaluated tasks (§6.3 four models, §6.4 six models).
OPT_175B = ModelTask("OPT-175B", 175e9, 96, 12288)
T5_11B = ModelTask("T5-11B", 11e9, 24, 1024)
GPT2_1_5B = ModelTask("GPT-2", 1.5e9, 48, 1600)
BERT_LARGE = ModelTask("BERT-large", 0.34e9, 24, 1024)
ROBERTA = ModelTask("RoBERTa", 0.355e9, 24, 1024)
XLNET = ModelTask("XLNet", 0.34e9, 24, 1024)

FOUR_TASKS = [OPT_175B, T5_11B, GPT2_1_5B, BERT_LARGE]
SIX_TASKS = [OPT_175B, T5_11B, GPT2_1_5B, BERT_LARGE, ROBERTA, XLNET]


# ---------------------------------------------------------------------------
# Communication models
# ---------------------------------------------------------------------------
class PaperLinearComm:
    """time(i, j, B) = lat[i,j] ms * B / 64 — the paper's literal model."""

    def __init__(self, latency_ms: np.ndarray, route: bool = True):
        self.lat = routed_latency(latency_ms) if route else latency_ms

    def time_s(self, i: int, j: int, nbytes: float) -> float:
        lat = self.lat[i, j]
        if i == j:
            return 0.0
        if lat <= 0:
            return np.inf  # blocked pair
        return lat * MS * nbytes / 64.0


# Latency-class capacity table shared by the scalar and vectorized
# link_bandwidth: (upper latency bound in ms, bytes/s). Order matters.
_BW_CLASSES = ((2.0, 10e9),      # same-region LAN
               (120.0, 1e9),     # good WAN
               (250.0, 0.3e9))
_BW_FLOOR = 0.05e9               # poor intercontinental link


def link_bandwidth_array(lat_ms: np.ndarray,
                         model: str = "alphabeta") -> np.ndarray:
    """Vectorized ``link_bandwidth`` over a latency matrix/vector: entries
    with ``lat <= 0`` (diagonal, blocked, unreachable) get bandwidth 0.
    Same ``_BW_CLASSES`` table as the scalar version — the repro.sim network
    model builds its whole-fleet capacity tables through this in one pass
    instead of an O(n^2) Python loop."""
    lat = np.asarray(lat_ms, np.float64)
    pos = lat > 0
    if model == "paper":
        out = np.zeros(lat.shape, np.float64)
        np.divide(64.0, lat * MS, out=out, where=pos)
        return out
    conds = [~pos] + [lat <= bound for bound, _ in _BW_CLASSES]
    choices = [0.0] + [bw for _, bw in _BW_CLASSES]
    return np.select(conds, choices, default=_BW_FLOOR)


def link_bandwidth(lat_ms: float, model: str = "alphabeta") -> float:
    """Bytes/s capacity of a link with the given latency. Single source of
    truth shared by the analytic comm models and the repro.sim network model
    (whose zero-contention limit must equal them, asserted in tests):

    * ``alphabeta`` — class inferred from the latency (LAN 10 GB/s down to
      0.05 GB/s intercontinental);
    * ``paper``     — the paper's Table 1 semantics, where lat_ms is the time
      to move 64 bytes (so the "bandwidth" is 64 bytes / lat)."""
    if model == "paper":
        return 64.0 / (lat_ms * MS)
    for bound, bw in _BW_CLASSES:
        if lat_ms <= bound:
            return bw
    return _BW_FLOOR


class AlphaBetaComm:
    """time = latency + bytes/bandwidth; bandwidth inferred from latency class."""

    def __init__(self, latency_ms: np.ndarray, route: bool = True):
        self.lat = routed_latency(latency_ms) if route else latency_ms

    def bandwidth(self, i: int, j: int) -> float:
        return link_bandwidth(float(self.lat[i, j]))

    def time_s(self, i: int, j: int, nbytes: float) -> float:
        if i == j:
            return 0.0
        lat = self.lat[i, j]
        if lat <= 0:
            return np.inf
        return lat * MS + nbytes / self.bandwidth(i, j)


def make_comm(graph: ClusterGraph, model: str = "paper"):
    return (PaperLinearComm if model == "paper" else AlphaBetaComm)(graph.latency)


# ---------------------------------------------------------------------------
# Parallelism strategy timings. All return (comm_s, compute_s) per step.
# ---------------------------------------------------------------------------
def _fits_whole_model(graph: ClusterGraph, ids: Sequence[int], task: ModelTask):
    """System A keeps machines that 'accommodate the entire model' (weights)."""
    mem = graph.memory_gb()
    return [i for i in ids if mem[i] * 1e9 >= task.param_bytes]


def dp_best_server(fit: Sequence[int], task: ModelTask,
                   comm) -> tuple[int, float]:
    """Parameter-server choice for DP sync: the fitting machine minimizing the
    worst worker exchange time of 2 x P bytes. Shared by the analytic model
    and the discrete-event simulator (repro.sim) so both place the PS on the
    same machine. Returns (server id, worst exchange seconds)."""
    best_server, best = fit[0], np.inf
    for server in fit:
        worst = max((comm.time_s(i, server, 2 * task.param_bytes)
                     for i in fit if i != server), default=0.0)
        if worst < best:
            best_server, best = server, worst
    return best_server, best


def dp_time(graph: ClusterGraph, ids: Sequence[int], task: ModelTask,
            comm) -> tuple[float, float]:
    """System A: data parallelism over machines that can hold the full model;
    parameter-server gradient sync (send grads, receive params)."""
    fit = _fits_whole_model(graph, ids, task)
    if not fit:
        return np.inf, np.inf
    tf = graph.tflops()
    total = sum(tf[i] for i in fit)
    compute = task.flops_per_step / (total * 1e12)
    # PS at the best-connected fitting machine; each worker exchanges 2 x P.
    _, best = dp_best_server(fit, task, comm)
    return best, compute


def gpipe_time(graph: ClusterGraph, ids: Sequence[int], task: ModelTask,
               comm, order: Sequence[int] | None = None) -> tuple[float, float]:
    """System B / Hulk intra-group: GPipe chain. Stage sizes proportional to
    per-machine compute, activations hop between consecutive stages per
    microbatch (fwd + bwd), bubble factor (S-1)/M on compute."""
    ids = list(order) if order is not None else list(ids)
    mem = graph.memory_gb()
    if sum(mem[i] for i in ids) < task.min_memory_gb:
        return np.inf, np.inf
    tf = graph.tflops()
    total_tf = sum(tf[i] for i in ids)
    s = len(ids)
    bubble = 1.0 + (s - 1) / task.microbatches
    compute = task.flops_per_step / (total_tf * 1e12) * bubble
    comm_s = 0.0
    for a, b in zip(ids[:-1], ids[1:]):
        hop = comm.time_s(a, b, task.act_bytes_per_microbatch)
        comm_s += 2.0 * task.microbatches * hop  # fwd act + bwd grad
    return comm_s, compute


def tp_time(graph: ClusterGraph, ids: Sequence[int], task: ModelTask,
            comm) -> tuple[float, float]:
    """System C: Megatron tensor parallelism across ALL machines: per layer,
    2 all-reduces fwd + 2 bwd of the activation tensor; ring all-reduce pays
    2(N-1)/N x bytes over the slowest link in the ring."""
    ids = list(ids)
    n = len(ids)
    mem = graph.memory_gb()
    if sum(mem[i] for i in ids) < task.min_memory_gb:
        return np.inf, np.inf
    tf = graph.tflops()
    compute = task.flops_per_step / (sum(tf[i] for i in ids) * 1e12)
    act = task.act_bytes_per_microbatch * task.microbatches  # full batch
    ring_factor = 2.0 * (n - 1) / max(n, 1)
    worst_hop = max(comm.time_s(ids[k], ids[(k + 1) % n], act * ring_factor)
                    for k in range(n)) if n > 1 else 0.0
    comm_s = 4.0 * task.n_layers * worst_hop
    return comm_s, compute


def greedy_chain_order(graph: ClusterGraph, ids: Sequence[int]) -> list[int]:
    """Nearest-neighbour chain through the group (cheap TSP heuristic) so the
    GPipe boundary hops ride the fastest links — part of Hulk's placement.

    Vectorized: the k-step chain walk does one numpy argmin over the free
    row per step instead of a Python ``min`` over a lambda (the O(k^2)
    Python loop inside every labeler ``_group_cost`` call). Produces the
    same order as ``greedy_chain_order_reference`` (asserted in
    tests/test_fast_path.py): both scan candidates in ascending machine-id
    order, so latency ties — including the all-inf ties of unreachable
    candidates in blocked topologies — break identically."""
    ids = list(ids)
    k = len(ids)
    if k <= 2:
        return ids
    idx = np.asarray(ids)
    sub = graph.latency[np.ix_(idx, idx)].copy()
    sub[sub <= 0] = np.inf
    # start at the node with the best total connectivity; row sums use the
    # same float dtype/order as the reference's np.nansum over lat[i, ids]
    start_scores = np.where(np.isinf(sub), 1e12, sub).sum(axis=1)
    cur = int(np.argmin(start_scores))        # first minimum == min() over ids
    # free positions kept in ascending machine-id order (reference tie-break)
    by_id = np.argsort(idx, kind="stable")
    free = np.ones(k, bool)
    free[cur] = False
    order = [int(idx[cur])]
    for _ in range(k - 1):
        cand = by_id[free[by_id]]
        nxt = int(cand[int(np.argmin(sub[cur, cand]))])
        order.append(int(idx[nxt]))
        free[nxt] = False
        cur = nxt
    return order


def greedy_chain_order_reference(graph: ClusterGraph,
                                 ids: Sequence[int]) -> list[int]:
    """The historical Python-loop implementation, kept as the readable
    reference the equivalence test compares against. One deliberate change
    from the original: candidates iterate in sorted id order (the original
    iterated a ``set``, whose order for hash-colliding ids is an accident of
    CPython's table size — i.e. the tie-break between equally-distant or
    equally-unreachable candidates was unspecified). Ties now break to the
    smallest machine id, the same rule the vectorized path uses."""
    ids = list(ids)
    if len(ids) <= 2:
        return ids
    lat = graph.latency.copy()
    lat[lat <= 0] = np.inf
    remaining = set(ids)
    # start at the node with the best total connectivity
    cur = min(ids, key=lambda i: np.nansum(np.where(np.isinf(lat[i, ids]), 1e12, lat[i, ids])))
    order = [cur]
    remaining.remove(cur)
    while remaining:
        nxt = min(sorted(remaining), key=lambda j: lat[cur, j])
        order.append(nxt)
        remaining.remove(nxt)
        cur = nxt
    return order


def group_step_time(graph: ClusterGraph, ids: Sequence[int], task: ModelTask,
                    comm, strategy: str = "gpipe") -> tuple[float, float]:
    if strategy == "dp":
        return dp_time(graph, ids, task, comm)
    if strategy == "tp":
        return tp_time(graph, ids, task, comm)
    order = greedy_chain_order(graph, ids)
    return gpipe_time(graph, ids, task, comm, order)


def placement_makespan(graph: ClusterGraph, groups: dict[str, list[int]],
                       tasks: Sequence[ModelTask], comm,
                       strategy: str = "gpipe") -> dict:
    """Hulk runs tasks concurrently on disjoint groups: makespan = max over
    tasks; returns per-task (comm, compute) too."""
    per_task = {}
    for t in tasks:
        ids = groups.get(t.name, [])
        if not ids:
            per_task[t.name] = (np.inf, np.inf)
            continue
        per_task[t.name] = group_step_time(graph, ids, t, comm, strategy)
    total = {k: c + p for k, (c, p) in per_task.items()}
    return {"per_task": per_task,
            "makespan": max(total.values()) if total else np.inf,
            "sum_comm": sum(c for c, _ in per_task.values()),
            "sum_compute": sum(p for _, p in per_task.values())}
