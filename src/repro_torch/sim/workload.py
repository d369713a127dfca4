"""Step executors: training-step event DAGs (port of ``repro/sim/workload.py``,
its training half).

Each executor simulates ONE training step of a task on its machine group and
reports ``done_cb(compute_phase_s, comm_phase_s)``. The DAG shapes are chosen
so that, with zero jitter and no competing traffic, the simulated step time
equals the analytic ``core.cost_model`` prediction *exactly*:

* ``gpipe`` — an (S stages x M microbatches) wavefront where every op takes
  ``T_c / M`` (stage sizes are proportional to machine compute, so per-stage
  times are equal); the wavefront makespan is ``(M + S - 1) * T_c / M``
  = ``T_c * (1 + (S-1)/M)`` — the bubble formula. The 2M activation/gradient
  boundary transfers per hop then run as a serial chain, matching the
  analytic sum (the paper's model assumes no comm/compute overlap; the
  simulator keeps that assumption and adds contention on top).
* ``dp``    — parallel compute barrier, then all workers exchange 2 x P bytes
  with the parameter server concurrently (server chosen by
  ``cost_model.dp_best_server``); the join is the analytic worst-worker max.
* ``tp``    — parallel compute barrier, then ``4 * n_layers`` sequential ring
  all-reduces; each all-reduce is a concurrent barrier over the ring hops, so
  its zero-contention duration is the analytic worst-hop time.

Under contention (shared links, relay hubs), stragglers (compute jitter) and
re-plans these DAGs diverge from the closed form — that divergence is the
quantity the simulator exists to measure.

Numpy copies of the reference's executors, so a step gives the same events
and times. The reference module's second half, the serving request executor
(``RequestRecord``, ``_Attempt``, ``ServeExecutor``), needs ``serve.replica``,
``serve.router`` and ``serve.resilience`` and is not ported yet.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from repro_torch.core import cost_model as cm
from repro_torch.core.graph import ClusterGraph
from repro_torch.sim.compute import ComputeModel
from repro_torch.sim.engine import Barrier, Simulator
from repro_torch.sim.network import NetworkModel

DoneCb = Callable[[float, float], None]

# tags keep the counter-based jitter RNG streams of distinct phases disjoint
_TAG_PIPE, _TAG_DP, _TAG_TP = 1, 2, 3


def analytic_step_time(graph: ClusterGraph, ids: Sequence[int],
                       task: cm.ModelTask, comm, strategy: str,
                       order: Sequence[int] | None = None) -> tuple[float, float]:
    """(comm_s, compute_s) the cost model predicts for this placement — used
    both for feasibility checks (inf => don't simulate) and calibration."""
    if strategy == "dp":
        return cm.dp_time(graph, ids, task, comm)
    if strategy == "tp":
        return cm.tp_time(graph, ids, task, comm)
    order = list(order) if order is not None else cm.greedy_chain_order(graph, ids)
    return cm.gpipe_time(graph, ids, task, comm, order)


def run_step(sim: Simulator, net: NetworkModel, compute: ComputeModel,
             graph: ClusterGraph, task: cm.ModelTask, ids: Sequence[int],
             strategy: str, order: Sequence[int], step: int,
             done_cb: DoneCb, comm=None) -> None:
    """``comm`` is the analytic comm model for ``graph`` (used by DP to place
    the parameter server); pass the one you already built — constructing it
    here would redo the all-pairs shortest-path routing every step."""
    if strategy == "dp":
        if comm is None:
            comm = cm.make_comm(graph, net.comm_model)
        _dp_step(sim, net, compute, graph, task, ids, step, done_cb, comm)
    elif strategy == "tp":
        _tp_step(sim, net, compute, graph, task, ids, step, done_cb)
    elif strategy == "gpipe":
        _gpipe_step(sim, net, compute, graph, task, order, step, done_cb)
    else:
        raise ValueError(f"unknown strategy {strategy!r}")


# ---------------------------------------------------------------------------
# GPipe
# ---------------------------------------------------------------------------
def _gpipe_step(sim, net, compute, graph, task, order, step, done_cb):
    order = list(order)
    s_n, m_n = len(order), task.microbatches
    tf = graph.tflops()
    total_tf = float(sum(tf[i] for i in order))
    t0 = sim.now

    if s_n == 1:
        # degenerate chain: M serial microbatches, no boundary traffic
        work = task.flops_per_step / m_n
        def run_mb(m: int):
            if m == m_n:
                done_cb(sim.now - t0, 0.0)
                return
            sim.schedule(compute.duration(order[0], work, step, m, _TAG_PIPE),
                         run_mb, m + 1)
        run_mb(0)
        return

    # stage sizes proportional to machine compute => equal per-op base times
    deps = np.zeros((s_n, m_n), np.int32)
    deps[1:, :] += 1
    deps[:, 1:] += 1

    def comm_phase():
        t1 = sim.now
        hops = list(zip(order[:-1], order[1:]))
        # per hop: M forward activations a->b, M backward gradients b->a —
        # the duplex directions matter because the network model contends
        # each direction separately (latency/bandwidth are symmetric, so the
        # zero-contention serial sum still matches the analytic model)
        transfers = [t for a, b in hops
                     for t in [(a, b)] * m_n + [(b, a)] * m_n]

        def next_transfer(k: int):
            if k == len(transfers):
                done_cb(t1 - t0, sim.now - t1)
                return
            a, b = transfers[k]
            net.transfer(sim, a, b, task.act_bytes_per_microbatch,
                         lambda: next_transfer(k + 1))
        next_transfer(0)

    barrier = Barrier(s_n * m_n, comm_phase)

    def finish_op(s: int, m: int):
        barrier.arrive()
        for (cs, mm) in ((s + 1, m), (s, m + 1)):
            if cs < s_n and mm < m_n:
                deps[cs, mm] -= 1
                if deps[cs, mm] == 0:
                    start_op(cs, mm)

    def start_op(s: int, m: int):
        machine = order[s]
        work = task.flops_per_step * (float(tf[machine]) / total_tf) / m_n
        sim.schedule(compute.duration(machine, work, step, m, _TAG_PIPE),
                     finish_op, s, m)

    start_op(0, 0)


# ---------------------------------------------------------------------------
# Data parallelism (parameter server)
# ---------------------------------------------------------------------------
def _dp_step(sim, net, compute, graph, task, ids, step, done_cb, comm):
    fit = cm._fits_whole_model(graph, ids, task)
    tf = graph.tflops()
    total_tf = float(sum(tf[i] for i in fit))
    server, _ = cm.dp_best_server(fit, task, comm)
    t0 = sim.now

    def comm_phase():
        t1 = sim.now
        workers = [i for i in fit if i != server]
        sync = Barrier(len(workers), lambda: done_cb(t1 - t0, sim.now - t1))
        for i in workers:
            net.transfer(sim, i, server, 2.0 * task.param_bytes, sync.arrive)

    barrier = Barrier(len(fit), comm_phase)
    for i in fit:
        work = task.flops_per_step * (float(tf[i]) / total_tf)
        sim.schedule(compute.duration(i, work, step, 0, _TAG_DP),
                     barrier.arrive)


# ---------------------------------------------------------------------------
# Tensor parallelism (ring all-reduce per layer)
# ---------------------------------------------------------------------------
def _tp_step(sim, net, compute, graph, task, ids, step, done_cb):
    ids = list(ids)
    n = len(ids)
    tf = graph.tflops()
    total_tf = float(sum(tf[i] for i in ids))
    act = task.act_bytes_per_microbatch * task.microbatches
    ring_bytes = act * 2.0 * (n - 1) / max(n, 1)
    rounds = 4 * task.n_layers
    t0 = sim.now

    def comm_phase():
        t1 = sim.now
        if n == 1:
            done_cb(t1 - t0, 0.0)
            return

        def all_reduce(r: int):
            if r == rounds:
                done_cb(t1 - t0, sim.now - t1)
                return
            ring = Barrier(n, lambda: all_reduce(r + 1))
            for k in range(n):
                net.transfer(sim, ids[k], ids[(k + 1) % n], ring_bytes,
                             ring.arrive)
        all_reduce(0)

    barrier = Barrier(n, comm_phase)
    for i in ids:
        work = task.flops_per_step * (float(tf[i]) / total_tf)
        sim.schedule(compute.duration(i, work, step, 0, _TAG_TP),
                     barrier.arrive)
