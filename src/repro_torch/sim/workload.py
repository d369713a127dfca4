"""Step executors: training-step event DAGs + the serving request executor
(port of ``repro/sim/workload.py``).

Training: each executor simulates ONE training step of a task on its machine
group and reports ``done_cb(compute_phase_s, comm_phase_s)``. The DAG shapes
are chosen so that, with zero jitter and no competing traffic, the simulated
step time equals the analytic ``core.cost_model`` prediction *exactly*:

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

Serving (``ServeExecutor``): requests from ``serve.traffic`` flow as
first-class events — arrival at the region's entry node, a routed network
transfer of the prompt, continuous-batching iterations on a
``serve.replica.Replica``, the response transfer back — so serving latency
inherits every fleet effect the training DAGs see (fair-share link
contention, relay hubs, stragglers, diurnal capacity squeeze). Replica
failures re-route interrupted requests; the ``serve.autoscale`` controller
scales the replica set, provisioning spare machines into the live graph
(``NetworkModel.add_machine`` / ``ComputeModel.add_machine``) with a
cold-start weight transfer from the nearest live replica, and — under the
Hulk policy — re-planning placement through
``runtime.elastic.ElasticRuntime.on_join``. Scale-downs deprovision: once
the drained replica goes idle its machine is tombstoned out of the network
and compute models (``remove_machine``), and a later scale-up revives it.

``data_plane="fast"`` (default) runs the fleet-scale request path: the
vectorized dirty-link flow solver, a cached healthy-replica list, router
entry/score caches invalidated on replica-set or topology changes, and the
replicas' O(1) integer-counter backlog. ``data_plane="reference"`` selects
the kept reference implementations (per-event rebalance loop, O(queue)
backlog sweep) — the reference's ``benchmarks/fleet_bench.py`` drives both
and asserts equivalence.

Numpy copies of the reference's executors, so a step or a request gives the
same events and times; under the Hulk policy the placement GNN runs where
its params lie (``serve.router.HulkPlacement``).
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch import obs as obs_mod
from repro_torch.core import cost_model as cm
from repro_torch.core.graph import ClusterGraph, Machine
from repro_torch.sim import faults as faults_mod
from repro_torch.sim.compute import ComputeModel, JitterConfig
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


# ---------------------------------------------------------------------------
# Serving executor: requests as first-class events
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class RequestRecord:
    """End-to-end bookkeeping for one request."""
    req: "object"                       # serve.traffic.Request
    t_complete: Optional[float] = None
    latency_s: Optional[float] = None
    t_first_token: Optional[float] = None
    n_routes: int = 0
    dropped: bool = False
    drop_reason: Optional[str] = None   # max_routes|unreachable|deadline|retry_budget
    retries: int = 0                    # timeout-driven re-dispatches
    hedges: int = 0                     # speculative extra attempts launched
    machines: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _Attempt:
    """One dispatch of a request onto a replica (resilient path): the unit
    the retry timeout, the hedging race and the breaker account in. ``done``
    attempts are inert — every callback that might fire late (timeout,
    prompt delivery, replica completion) checks it first, which is what
    makes 'completes or drops exactly once' a local invariant."""
    rep: object                         # serve.replica.Replica
    t_start: float
    hedged: bool = False
    seq: object = None                  # set once admitted at the replica
    done: bool = False
    timeout_ev: object = None


class ServeExecutor:
    """Drive one routing policy through one serving workload.

    Construction wires the placement (static for the baseline policies,
    ``serve.router.HulkPlacement`` for ``policy="hulk"``), the router, the
    replica set, the optional autoscaler and the fault schedule; ``run()``
    returns the records plus infrastructure stats for
    ``serve.evaluate.summarize``.
    """

    MAX_ROUTES = 5       # re-route attempts before a request is dropped

    def __init__(self, graph: ClusterGraph, model, trace: Sequence,
                 policy: str, *, params=None, cfg=None,
                 comm_model: str = "alphabeta",
                 jitter: Optional[JitterConfig] = None,
                 n_replicas: int = 2, max_batch: int = 8,
                 prefill_chunk: int = 256,
                 autoscale=None, spares: Sequence[Machine] = (),
                 fault_fracs: Sequence[float] = (), kills_per_fault: int = 1,
                 fault_plan=None, resilience=None,
                 max_routes: Optional[int] = None,
                 seed: int = 0, run_until_s: Optional[float] = None,
                 data_plane: str = "fast", obs=None,
                 sim=None, net=None, compute=None,
                 external_load=None):
        from repro_torch.serve.autoscale import Autoscaler
        from repro_torch.serve.replica import Replica
        from repro_torch.serve.resilience import CircuitBreaker
        from repro_torch.serve.router import HulkPlacement, Router, StaticPlacement

        self.obs = obs if obs is not None else obs_mod.NULL
        self.graph = graph
        self.model = model
        self.trace = list(trace)
        self.policy = policy
        self.seed = seed
        self.max_batch = max_batch
        self.prefill_chunk = prefill_chunk
        self.kills_per_fault = kills_per_fault
        self.max_routes = (int(max_routes) if max_routes is not None
                           else int(self.MAX_ROUTES))
        self._Replica = Replica

        if data_plane not in ("fast", "reference"):
            raise ValueError(f"unknown data plane {data_plane!r}")
        self.data_plane = data_plane
        # shared-fleet (colocated) mode: adopt an externally owned engine +
        # network/compute planes so a training tenant contends on the same
        # fabric. The caller (sim.colocate) is responsible for building the
        # shared NetworkModel with the matching solver/data plane.
        self._shared = any(m is not None for m in (sim, net, compute))
        if self._shared and (sim is None or net is None or compute is None):
            raise ValueError("shared-fleet mode needs all of sim=, net= and "
                             "compute=")
        self.sim = sim if sim is not None else Simulator(obs=self.obs)
        self.net = net if net is not None else NetworkModel(
            graph, comm_model, solver=data_plane, obs=self.obs)
        self.compute = compute if compute is not None else ComputeModel(
            graph, jitter, seed=seed)

        if policy == "hulk":
            if params is None or cfg is None:
                raise ValueError("hulk policy needs trained GNN (params, cfg)")
            self.placement = HulkPlacement(graph, model, n_replicas, params,
                                           cfg, external_load=external_load)
        else:
            self.placement = StaticPlacement(graph, model, n_replicas)
        self.router = Router(policy, graph, self.net,
                             scores=getattr(self.placement, "scores", None))

        self.replicas: dict[int, Replica] = {}
        self.retired: list[Replica] = []
        for mid in self.placement.desired():
            self._add_replica(mid)

        self.records = {r.rid: RequestRecord(req=r) for r in self.trace}
        self.horizon = (max(r.t_arrival for r in self.trace)
                        if self.trace else 0.0)
        self.run_until = (run_until_s if run_until_s is not None
                          else 8.0 * max(self.horizon, 1.0) + 600.0)
        self.fault_fracs = tuple(fault_fracs)
        # the legacy fields are a thin shim over the fault plan: each
        # fraction becomes one drawn-victim MachineCrash, compiled to the
        # exact event schedule (and rng keys) the old loop produced
        if fault_plan is None and self.fault_fracs:
            fault_plan = faults_mod.plan_from_fracs(self.fault_fracs,
                                                    kills_per_fault)
        self.fault_plan = fault_plan if fault_plan else None

        # resilience policies (serve.resilience.ResilienceConfig); None = the
        # legacy blind-reroute path, bit-identical to pre-chaos behavior
        self.resilience = resilience
        self._breaker = (CircuitBreaker(resilience.breaker)
                         if resilience is not None
                         and resilience.breaker is not None else None)
        self._attempts: dict[int, list[_Attempt]] = {}
        self._pending_retry: dict[int, int] = {}

        self.scale_log: list[dict] = []
        self._spares = collections.deque(spares)

        # machines whose cold-start weight transfer is still in flight —
        # they count against the autoscaler's replica cap (else every tick
        # past the cooldown re-provisions while slow WAN transfers run) and
        # a scale-down can abort them before they open
        self._provisioning: set[int] = set()
        self._cancelled_starts: set[int] = set()
        # per-request fast path: the healthy-replica list is cached between
        # replica-set changes instead of being rebuilt for every arrival
        self._rep_cache: Optional[list] = None

        self.autoscaler = None
        if autoscale is not None:
            self.autoscaler = Autoscaler(
                self.sim, autoscale,
                n_replicas=lambda: (sum(r.alive for r in
                                        self.replicas.values())
                                    + len(self._provisioning)),
                pending_per_replica=self._pending_per_replica,
                scale_up=self._scale_up, scale_down=self._scale_down)

    # -- replica lifecycle ---------------------------------------------------
    def _routing_changed(self) -> None:
        """The replica set (or topology) changed: drop the cached replica
        list and every router-side score/entry cache."""
        self._rep_cache = None
        self.router.invalidate()

    def _replica_list(self) -> list:
        if self._rep_cache is None:
            self._rep_cache = list(self.replicas.values())
        return self._rep_cache

    def _add_replica(self, mid: int) -> None:
        mem = float(self.graph.memory_gb()[mid])
        self.replicas[mid] = self._Replica(
            self.sim, self.compute, mid, self.model, mem,
            max_batch=self.max_batch, prefill_chunk=self.prefill_chunk,
            reference_backlog=self.data_plane == "reference", obs=self.obs)
        self._routing_changed()

    def _cold_start(self, mid: int) -> None:
        """Weights stream from the nearest live replica (or appear instantly
        when this is the very first one), then the replica opens — unless a
        scale-down cancelled the start while the transfer was in flight."""
        # routed_ms uses 0 as the unreachable sentinel, so filter on
        # reachability BEFORE taking the min (else a partitioned peer
        # looks like the closest one)
        peers = [m for m, r in self.replicas.items()
                 if r.alive and self.net.reachable(m, mid)]
        src = min(peers, key=lambda m: float(self.net.routed_ms[m, mid])) \
            if peers else mid
        self._provisioning.add(mid)
        t_cs = self.sim.now

        def up() -> None:
            if self.obs.enabled:
                self.obs.trace.async_span(
                    f"replica/{mid}", "cold_start", f"cs{mid}", t_cs,
                    self.sim.now, cat="serve",
                    args={"src": src,
                          "bytes": float(self.model.weight_bytes)})
                self.obs.metrics.inc("serve.cold_starts")
                self.obs.metrics.observe("serve.cold_start_s",
                                         self.sim.now - t_cs)
            self._provisioning.discard(mid)
            if mid in self._cancelled_starts:
                self._cancelled_starts.discard(mid)
                self.scale_log.append({"t": self.sim.now,
                                       "event": "replica_start_aborted",
                                       "machine": mid})
                # the machine was released while its weights streamed: it
                # must not linger as a live relay/entry candidate
                self._deprovision(mid)
                return
            old = self.replicas.get(mid)
            if old is not None:
                self.retired.append(old)
            self._add_replica(mid)
            self.scale_log.append({"t": self.sim.now, "event": "replica_up",
                                   "machine": mid})
        self.net.transfer(self.sim, src, mid, self.model.weight_bytes, up)

    def _pending_per_replica(self) -> float:
        alive = [r for r in self.replicas.values() if r.alive]
        if not alive:
            return float("inf")
        return sum(r.n_pending() for r in alive) / len(alive)

    def _scale_up(self) -> bool:
        mid = self.placement.acquire()
        if mid is None and self._spares:
            machine = self._spares.popleft()
            self.graph = self.graph.add_machine(machine)
            self.net.add_machine(self.graph)
            self.compute.add_machine(machine)
            mid = self.placement.on_machine_joined(machine, self.graph)
            # the join may be a strictly better entry node for some region:
            # the router re-derives its entry/score caches from the new graph
            self.router.on_machine_joined(
                self.graph, getattr(self.placement, "scores", None))
            self._rep_cache = None
            self.scale_log.append({"t": self.sim.now, "event": "join",
                                   "machine": mid, "region": machine.region})
        if mid is None:
            return False
        if mid in self.net.tombstoned:
            # re-provisioning a machine an earlier scale-down released
            self.net.revive_machine(mid)
            self.compute.revive_machine(mid)
            self._routing_changed()
            self.scale_log.append({"t": self.sim.now,
                                   "event": "machine_reprovisioned",
                                   "machine": mid})
        self._cold_start(mid)
        return True

    def _scale_down(self) -> bool:
        mid = self.placement.release()
        if mid is None:
            return False
        rep = self.replicas.pop(mid, None)
        if rep is None:
            if mid in self._provisioning:
                # released while its weights were still streaming: abort
                # the start (the machine already left placement.active, so
                # nothing goes orphaned)
                self._cancelled_starts.add(mid)
                return True
            return False
        self.retired.append(rep)
        self._routing_changed()
        self.scale_log.append({"t": self.sim.now, "event": "replica_down",
                               "machine": mid})
        drained = rep.drain()
        if self.resilience is not None:
            # only the drained (queued) attempts detach — in-flight sequences
            # finish on the draining replica and resolve normally
            for req in drained:
                for a in self._attempts.get(req.rid, []):
                    if a.done or a.rep is not rep or a.seq is None:
                        continue
                    a.done = True
                    if a.timeout_ev is not None:
                        a.timeout_ev.cancel()
                        a.timeout_ev = None
        for req in drained:
            self._dispatch(req)
        # release the machine once its in-flight sequences finish and their
        # responses have left: deprovisioned nodes stop relaying traffic
        rep.when_idle(lambda: self._deprovision(mid))
        return True

    def _deprovision(self, mid: int) -> None:
        if mid in self._provisioning \
                or (mid in self.replicas and self.replicas[mid].alive):
            return  # a scale-up re-hosted the machine while it drained
        self.net.remove_machine(mid)
        self.compute.remove_machine(mid)
        self._routing_changed()
        self.scale_log.append({"t": self.sim.now,
                               "event": "machine_deprovisioned",
                               "machine": mid})

    # -- faults --------------------------------------------------------------
    def _apply_fault(self, act) -> None:
        """Dispatch one compiled ``sim.faults.FaultAction``."""
        if self.obs.enabled:
            self.obs.metrics.inc("faults.injected")
            self.obs.metrics.inc(f"faults.{act.kind}")
            self.obs.trace.instant(
                "faults", act.kind, cat="fault",
                args={"injector": act.injector,
                      **{k: v for k, v in act.payload.items()
                         if isinstance(v, (int, float, str, bool))
                         and v is not None}})
        if act.kind == "crash":
            self._apply_crash(act.payload, act.injector)
        elif act.kind == "link":
            self.net.apply_link_fault(act.injector, act.payload["pairs"],
                                      bw_factor=act.payload["bw_factor"],
                                      lat_factor=act.payload["lat_factor"],
                                      cut=act.payload["cut"], sim=self.sim)
            self._routing_changed()
        elif act.kind == "link_clear":
            self.net.clear_link_fault(act.payload["fault_id"], sim=self.sim)
            self._routing_changed()
        elif act.kind == "gray":
            self.compute.set_gray(act.payload["machine"],
                                  act.payload["factor"])
        elif act.kind == "gray_clear":
            self.compute.set_gray(act.payload["machine"], 1.0)
        else:
            raise ValueError(f"unknown fault action {act.kind!r}")

    def _apply_crash(self, payload: dict, k: int) -> None:
        """Machines (or the replica processes on drawn victims) die.

        Explicit victims are *machine-level*: the node tombstones out of the
        network/compute models and stops relaying traffic. Drawn victims
        (``machines=()``) keep the legacy ``fault_fracs`` semantics — the
        replica process dies, the machine keeps routing — including the
        legacy rng key, which is what makes the shim bit-identical."""
        explicit = payload.get("machines", ())
        if explicit:
            victims = [int(v) for v in dict.fromkeys(explicit)
                       if int(v) < self.graph.n
                       and int(v) not in self.net.tombstoned]
            machine_level = True
        else:
            alive = sorted(m for m, r in self.replicas.items() if r.alive)
            if len(alive) <= 1:
                return
            rng = np.random.default_rng(
                (self.seed, faults_mod.CRASH_STREAM, k))
            kills = min(int(payload["kills"]), len(alive) - 1)
            victims = sorted(int(v) for v in
                             rng.choice(alive, size=kills, replace=False))
            machine_level = False
        if not victims:
            return
        if self.obs.enabled:
            # one instant per victim (the bulk crash instant's machine tuple
            # is filtered out of its args); trace analytics pairs these with
            # the per-machine "recover" instants into downtime intervals
            for v in victims:
                self.obs.trace.instant("faults", "machine_down", cat="fault",
                                       args={"machine": int(v),
                                             "machine_level": machine_level})
        interrupted = []
        hosted = set()
        for v in victims:
            rep = self.replicas.pop(v, None)
            if rep is not None:
                hosted.add(v)
                if self.resilience is not None:
                    self._detach_attempts(rep, record_failure=True)
                interrupted.extend(rep.fail())
                self.retired.append(rep)
                self.placement.on_machine_failed(v)
                self.scale_log.append({"t": self.sim.now,
                                       "event": "replica_failed",
                                       "machine": v})
            if machine_level:
                if v in self._provisioning:
                    # crash hit a cold start mid-stream: abort it
                    self._cancelled_starts.add(v)
                if v not in self.net.tombstoned:
                    self.net.remove_machine(v)
                    self.compute.remove_machine(v)
                self.scale_log.append({"t": self.sim.now,
                                       "event": "machine_crashed",
                                       "machine": v})
        self._routing_changed()
        for req in interrupted:
            self._dispatch(req)
        rec_after = payload.get("recover_after_s")
        if rec_after is not None and victims:
            self.sim.schedule(rec_after, self._apply_recover, tuple(victims),
                              machine_level, frozenset(hosted),
                              pin_epoch=False)

    def _apply_recover(self, victims, machine_level: bool, hosted) -> None:
        """Crashed machines come back: revive the tombstones, clear breaker
        history, and re-host a replica (nearest-peer cold start) on every
        machine that was hosting one when it died — unless the autoscaler
        already re-used the slot."""
        for v in victims:
            if v in self._provisioning or \
                    (v in self.replicas and self.replicas[v].alive):
                continue  # already re-provisioned through autoscaling
            if machine_level and v in self.net.tombstoned:
                self.net.revive_machine(v)
                self.compute.revive_machine(v)
            if self._breaker is not None:
                self._breaker.reset(v)
            self.scale_log.append({"t": self.sim.now,
                                   "event": "machine_recovered",
                                   "machine": v})
            if self.obs.enabled:
                self.obs.metrics.inc("faults.recoveries")
                self.obs.trace.instant("faults", "recover", cat="fault",
                                       args={"machine": int(v)})
            if v in hosted:
                self.placement.on_machine_recovered(v)
                self._cold_start(v)
        self._routing_changed()

    def _detach_attempts(self, rep, record_failure: bool = False) -> None:
        """Mark every live attempt admitted at ``rep`` done (its requests are
        about to be handed back via ``drain``/``fail`` and re-dispatched —
        without this they would resolve twice). Attempts whose prompt is
        still in flight stay live: ``_r_deliver`` re-dispatches those."""
        for atts in self._attempts.values():
            for a in atts:
                if a.done or a.rep is not rep or a.seq is None:
                    continue
                a.done = True
                if a.timeout_ev is not None:
                    a.timeout_ev.cancel()
                    a.timeout_ev = None
                if record_failure:
                    self._r_record_failure(rep.machine)

    # -- request flow --------------------------------------------------------
    def _on_arrival(self, req) -> None:
        if self.obs.enabled:
            self.obs.metrics.inc("serve.requests")
        if self.resilience is not None:
            self._r_arrival(req)
        else:
            self._route(req)

    def _dispatch(self, req) -> None:
        """Route (or re-route) through whichever request path is active."""
        if self.resilience is not None:
            self._r_dispatch(req)
        else:
            self._route(req)

    def _drop(self, rec, reason: str) -> None:
        if rec.dropped or rec.t_complete is not None:
            return
        rec.dropped = True
        rec.drop_reason = reason
        if self.resilience is not None:
            # no zombie work: outstanding attempts are cancelled with the drop
            for att in self._attempts.pop(rec.req.rid, []):
                if att.done:
                    continue
                att.done = True
                if att.timeout_ev is not None:
                    att.timeout_ev.cancel()
                    att.timeout_ev = None
                if att.seq is not None and att.rep.alive:
                    att.rep.abort(att.seq)
            self._pending_retry.pop(rec.req.rid, None)
        if self.obs.enabled:
            self.obs.metrics.inc("serve.dropped")
            self.obs.metrics.inc(f"serve.dropped.{reason}")
            self.obs.trace.instant("requests", "dropped", cat="request",
                                   args={"rid": rec.req.rid, "reason": reason,
                                         "n_routes": rec.n_routes})

    def _route(self, req) -> None:
        rec = self.records[req.rid]
        if rec.dropped or rec.t_complete is not None:
            return
        if rec.n_routes >= self.max_routes:
            self._drop(rec, "max_routes")
            return
        rep = self.router.pick(req, self._replica_list())
        if rep is None:
            self._drop(rec, "unreachable")
            return
        if rec.n_routes > 0 and self.obs.enabled:
            # failover edge: this request already ran (or queued) elsewhere
            self.obs.metrics.inc("serve.failovers")
            self.obs.trace.instant("requests", "failover", cat="request",
                                   args={"rid": req.rid,
                                         "to_machine": rep.machine,
                                         "attempt": rec.n_routes + 1})
        rec.n_routes += 1
        rec.machines.append(rep.machine)
        src = self.router.entry(req.region)
        nbytes = req.prompt_tokens * self.model.request_bytes_per_token
        self.net.transfer(self.sim, src, rep.machine, nbytes,
                          lambda: self._deliver(req, rep))

    def _deliver(self, req, rep) -> None:
        if not (rep.alive and rep.accepting):
            self._route(req)      # died/drained while the prompt was in flight
            return
        rep.submit(req, lambda seq, m=rep.machine: self._on_served(seq, m))

    def _on_served(self, seq, machine: int) -> None:
        req = seq.req
        dst = self.router.entry(req.region)
        if not self.net.reachable(machine, dst):
            # the response's only relay was deprovisioned mid-generation:
            # the reply is lost (the request path is guarded at pick time,
            # but a sequence admitted before the tombstone can finish after)
            self._drop(self.records[req.rid], "unreachable")
            return
        nbytes = req.gen_tokens * self.model.response_bytes_per_token
        self.net.transfer(self.sim, machine, dst,
                          nbytes, lambda: self._complete(req, seq))

    def _complete(self, req, seq) -> None:
        rec = self.records[req.rid]
        rec.t_complete = self.sim.now
        rec.latency_s = self.sim.now - req.t_arrival
        rec.t_first_token = seq.t_first_token
        if self.obs.enabled:
            m = self.obs.metrics
            m.inc("serve.completed")
            m.observe("serve.latency_s", rec.latency_s)
            if seq.t_first_token is not None:
                m.observe("serve.ttft_s", seq.t_first_token - req.t_arrival)
            # end-to-end request span on the fleet-wide requests lane
            # (replica-side queued/prefill/decode phases live on the
            # replica lanes — see serve.replica)
            self.obs.trace.async_span(
                "requests", "request", f"r{req.rid}", req.t_arrival,
                self.sim.now, cat="request",
                args={"rid": req.rid, "region": req.region,
                      "machines": list(rec.machines),
                      "n_routes": rec.n_routes,
                      "prompt_tokens": req.prompt_tokens,
                      "gen_tokens": req.gen_tokens})
        if self.autoscaler is not None and rec.latency_s is not None:
            self.autoscaler.observe_completion(rec.latency_s)

    # -- resilient request path (serve.resilience) ---------------------------
    # One request fans out into _Attempts. Liveness: every attempt either
    # completes, times out (retry policy), or dies with its replica (crash
    # handler / _r_deliver); retries are budget-bounded and every dispatch
    # consumes n_routes, so a request always terminates in _complete or in
    # _drop with a recorded reason — the invariant the chaos fuzzer checks.
    def _live_attempts(self, rid: int) -> list:
        return [a for a in self._attempts.get(rid, []) if not a.done]

    def _r_arrival(self, req) -> None:
        shed = self.resilience.shed
        if shed is not None and self._r_should_shed(req):
            if self.obs.enabled:
                self.obs.metrics.inc("serve.shed")
            self._drop(self.records[req.rid], "deadline")
            return
        self._r_dispatch(req)
        hp = self.resilience.hedge
        if hp is not None:
            self.sim.schedule(hp.delay_s, self._r_hedge, req,
                              pin_epoch=False)

    def _r_should_shed(self, req) -> bool:
        """Deadline-aware load shedding: drop on arrival if even the BEST
        replica's completion estimate (round-trip latency + backlog drain +
        zero-contention service time) blows the deadline. Estimates only —
        gray slowdowns and contention are invisible here, like real
        admission control working from advertised capacity."""
        pol = self.resilience.shed
        src = self.router.entry(req.region)
        best = math.inf
        for rep in self._replica_list():
            if not (rep.alive and rep.accepting and rep.fits(req)):
                continue
            if not self.net.reachable(src, rep.machine):
                continue
            lat = float(self.net.routed_ms[src, rep.machine]) * 1e-3
            est = 2.0 * lat + rep.est_wait_s() + self.model.service_s(
                req.prompt_tokens, req.gen_tokens,
                float(self.compute.tflops[rep.machine]))
            best = min(best, est)
        if not math.isfinite(best):
            return False    # nothing viable: let dispatch record unreachable
        return best > pol.deadline_s * pol.slack

    def _r_dispatch(self, req, hedge: bool = False) -> None:
        rec = self.records[req.rid]
        if rec.dropped or rec.t_complete is not None:
            return
        if rec.n_routes >= self.max_routes:
            if not hedge and not self._live_attempts(req.rid) \
                    and self._pending_retry.get(req.rid, 0) == 0:
                self._drop(rec, "max_routes")
            return
        exclude = tuple(a.rep.machine for a in self._live_attempts(req.rid)) \
            if hedge else ()
        rep = self.router.pick(req, self._replica_list(), exclude=exclude,
                               breaker=self._breaker, now=self.sim.now)
        if rep is None:
            if not hedge and not self._live_attempts(req.rid) \
                    and self._pending_retry.get(req.rid, 0) == 0:
                self._drop(rec, "unreachable")
            return
        if rec.n_routes > 0 and self.obs.enabled:
            self.obs.metrics.inc("serve.failovers")
            self.obs.trace.instant("requests", "failover", cat="request",
                                   args={"rid": req.rid,
                                         "to_machine": rep.machine,
                                         "attempt": rec.n_routes + 1})
        rec.n_routes += 1
        rec.machines.append(rep.machine)
        att = _Attempt(rep=rep, t_start=self.sim.now, hedged=hedge)
        self._attempts.setdefault(req.rid, []).append(att)
        if hedge:
            rec.hedges += 1
            if self.obs.enabled:
                self.obs.metrics.inc("serve.hedges")
                self.obs.trace.instant("requests", "hedge", cat="request",
                                       args={"rid": req.rid,
                                             "to_machine": rep.machine})
        pol = self.resilience.retry
        if pol is not None:
            att.timeout_ev = self.sim.schedule(pol.timeout_s,
                                               self._r_timeout, req, att,
                                               pin_epoch=False)
        src = self.router.entry(req.region)
        nbytes = req.prompt_tokens * self.model.request_bytes_per_token
        self.net.transfer(self.sim, src, rep.machine, nbytes,
                          lambda: self._r_deliver(req, att))

    def _r_deliver(self, req, att) -> None:
        if att.done:
            return
        rec = self.records[req.rid]
        if rec.dropped or rec.t_complete is not None:
            att.done = True
            return
        rep = att.rep
        if not (rep.alive and rep.accepting):
            # replica died/drained while the prompt was in flight
            att.done = True
            if att.timeout_ev is not None:
                att.timeout_ev.cancel()
                att.timeout_ev = None
            self._r_record_failure(rep.machine)
            self._r_dispatch(req)
            return
        att.seq = rep.submit(req, lambda seq, a=att: self._r_served(req, a))

    def _r_timeout(self, req, att) -> None:
        att.timeout_ev = None
        if att.done:
            return
        rec = self.records[req.rid]
        if rec.dropped or rec.t_complete is not None:
            return
        att.done = True
        if att.seq is not None and att.rep.alive:
            att.rep.abort(att.seq)
        self._r_record_failure(att.rep.machine)
        if self.obs.enabled:
            self.obs.metrics.inc("serve.attempt_timeouts")
        pol = self.resilience.retry
        if rec.retries >= pol.max_retries:
            if not self._live_attempts(req.rid) \
                    and self._pending_retry.get(req.rid, 0) == 0:
                self._drop(rec, "retry_budget")
            return
        rec.retries += 1
        if self.obs.enabled:
            self.obs.metrics.inc("serve.retries")
        backoff = pol.backoff_base_s * pol.backoff_mult ** (rec.retries - 1)
        self._pending_retry[req.rid] = \
            self._pending_retry.get(req.rid, 0) + 1
        self.sim.schedule(backoff, self._r_retry_fire, req, pin_epoch=False)

    def _r_retry_fire(self, req) -> None:
        left = self._pending_retry.get(req.rid, 0) - 1
        if left > 0:
            self._pending_retry[req.rid] = left
        else:
            self._pending_retry.pop(req.rid, None)
        rec = self.records[req.rid]
        if rec.dropped or rec.t_complete is not None:
            return
        self._r_dispatch(req)

    def _r_served(self, req, att) -> None:
        if att.done:
            return
        att.done = True
        if att.timeout_ev is not None:
            att.timeout_ev.cancel()
            att.timeout_ev = None
        rec = self.records[req.rid]
        if rec.dropped or rec.t_complete is not None:
            return
        dst = self.router.entry(req.region)
        if not self.net.reachable(att.rep.machine, dst):
            # response lost (see _on_served); resilient mode re-dispatches
            # instead of dropping — the work is gone, the request is not
            self._r_record_failure(att.rep.machine)
            self._r_dispatch(req)
            return
        self._r_record_success(att.rep.machine)
        nbytes = req.gen_tokens * self.model.response_bytes_per_token
        self.net.transfer(self.sim, att.rep.machine, dst, nbytes,
                          lambda: self._r_complete(req, att))

    def _r_complete(self, req, att) -> None:
        rec = self.records[req.rid]
        if rec.dropped or rec.t_complete is not None:
            return      # a faster attempt already resolved this request
        if att.hedged and self.obs.enabled:
            self.obs.metrics.inc("serve.hedge_wins")
        # first completion wins: cancel the losers at their replicas
        for other in self._attempts.pop(req.rid, []):
            if other is att or other.done:
                continue
            other.done = True
            if other.timeout_ev is not None:
                other.timeout_ev.cancel()
                other.timeout_ev = None
            if other.seq is not None and other.rep.alive:
                other.rep.abort(other.seq)
        self._pending_retry.pop(req.rid, None)
        self._complete(req, att.seq)

    def _r_hedge(self, req) -> None:
        rec = self.records[req.rid]
        if rec.dropped or rec.t_complete is not None:
            return
        hp = self.resilience.hedge
        if rec.hedges >= hp.max_hedges:
            return
        if self._live_attempts(req.rid):
            self._r_dispatch(req, hedge=True)
        if rec.hedges < hp.max_hedges and not rec.dropped \
                and rec.t_complete is None:
            self.sim.schedule(hp.delay_s, self._r_hedge, req,
                              pin_epoch=False)

    def _r_record_failure(self, machine: int) -> None:
        if self._breaker is None:
            return
        if self.obs.enabled:
            self.obs.metrics.inc("serve.breaker_failures")
        if self._breaker.record_failure(machine, self.sim.now):
            if self.obs.enabled:
                self.obs.metrics.inc("serve.breaker_ejections")
                self.obs.trace.instant("requests", "breaker_open",
                                       cat="serve",
                                       args={"machine": int(machine)})

    def _r_record_success(self, machine: int) -> None:
        if self._breaker is not None:
            self._breaker.record_success(machine)

    # -- entry point ---------------------------------------------------------
    def start(self) -> None:
        """Schedule arrivals, the fault plan and the autoscaler — everything
        ``run()`` does before draining the heap. Split out so a colocated
        host can start several tenants on one shared ``Simulator``."""
        for req in self.trace:
            self.sim.schedule(req.t_arrival, self._on_arrival, req,
                              pin_epoch=False)
        if self.fault_plan is not None:
            for act in faults_mod.compile_plan(self.fault_plan, self.graph,
                                               max(self.horizon, 1.0),
                                               self.seed):
                self.sim.schedule(act.t, self._apply_fault, act,
                                  pin_epoch=False)
        if self.autoscaler is not None:
            self.autoscaler.start()

    def run(self) -> dict:
        self.start()
        self.sim.run(until=self.run_until)
        return self.collect()

    def collect(self) -> dict:
        if self.autoscaler is not None:
            self.autoscaler.stop()
        all_reps = list(self.replicas.values()) + self.retired
        # metrics snapshot: the cheap core counters always; the full obs
        # registry (flattened) when a recorder was attached
        metrics = {
            "engine.events_dispatched": self.sim.events_dispatched,
            "engine.events_scheduled": self.sim.events_scheduled,
            "net.solver.solves": self.net.n_solves,
            "net.bytes_moved": float(self.net.bytes_moved),
        }
        if self.obs.enabled:
            metrics.update(self.obs.metrics.flat())
        return {
            "policy": self.policy,
            "records": self.records,
            "horizon_s": self.horizon,
            "end_s": self.sim.now,
            "n_events": self.sim.events_dispatched,
            "bytes_moved": self.net.bytes_moved,
            "metrics": metrics,
            "replicas": [r.stats() for r in all_reps],
            "scale_log": list(self.scale_log),
            "autoscale_log": (list(self.autoscaler.log)
                              if self.autoscaler else []),
            "final_replicas": sorted(m for m, r in self.replicas.items()
                                     if r.alive),
        }
