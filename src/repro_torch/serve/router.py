"""Geo-aware request routing + replica placement.

Routing policies score every healthy replica for a request entering the
fleet at its region's entry node and pick the minimum:

* ``nearest``       — routed network latency only (anycast-to-closest; the
  classic CDN default and the baseline Hulk must beat);
* ``least_loaded``  — latency + the replica's estimated backlog drain time
  (weighted least-loaded);
* ``hulk``          — the least-loaded score shaped by the Hulk GNN's
  per-machine serve-class probability, so traffic prefers machines the
  placement network scored highly (well-connected, high-capability).

Placement decides WHICH machines host replicas:

* ``StaticPlacement`` — the first N machines (id order) with room for the
  weights: what an operator who never looked at the topology would deploy.
* ``HulkPlacement``   — ``core.assign.task_assignments`` over a pseudo-task
  sized for N replicas (``serve.costs.serve_task_for``), replica hosts
  ranked by GNN score; wraps a ``runtime.elastic.ElasticRuntime`` so
  autoscale joins and failures re-plan through the same Algorithm 1
  machinery training placements use.

Port of ``repro/serve/router.py``: numpy copies, so routing and placement
decide as the reference does; the GNN behind ``HulkPlacement`` runs where
its params lie.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

from repro_torch import _device
from repro_torch.core import assign as assign_mod
from repro_torch.core import train as gnn_train
from repro_torch.core.graph import ClusterGraph, Machine, region_latency_ms
from repro_torch.runtime import ElasticRuntime, FailureEvent
from repro_torch.serve.costs import ServeModel, serve_task_for
from repro_torch.serve.replica import Replica
from repro_torch.serve.traffic import Request

POLICIES = ("nearest", "least_loaded", "hulk")


def entry_node(graph: ClusterGraph, region: str,
               exclude: Sequence[int] = ()) -> int:
    """Where a user region's traffic enters the fleet: the machine in that
    region, else the machine with the lowest inter-region latency estimate.
    ``exclude`` skips deprovisioned machines."""
    dead = set(exclude)
    for i, m in enumerate(graph.machines):
        if m.region == region and i not in dead:
            return i

    def est(i: int) -> float:
        if i in dead:
            return math.inf
        w = region_latency_ms(region, graph.machines[i].region)
        return math.inf if np.isnan(w) else float(w)
    return min(range(graph.n), key=est)


class Router:
    def __init__(self, policy: str, graph: ClusterGraph, net,
                 scores: Optional[np.ndarray] = None):
        if policy not in POLICIES:
            raise ValueError(f"unknown routing policy {policy!r}; "
                             f"known: {POLICIES}")
        self.policy = policy
        self.graph = graph
        self.net = net
        # GNN serve-class probability per machine (hulk policy); grows when
        # machines join the fleet
        self.scores = scores
        self._entry: dict[str, int] = {}
        # static half of a replica's routing score — routed latency and GNN
        # probability per (entry node, machine). Only the backlog term is
        # dynamic, so per-request scoring never re-reads the latency table;
        # invalidated whenever the topology or the replica set changes.
        self._static: dict[tuple[int, int], tuple[float, float]] = {}

    def invalidate(self) -> None:
        """Topology or replica set changed: drop every derived cache."""
        self._entry.clear()
        self._static.clear()

    def on_machine_joined(self, graph: ClusterGraph,
                          scores: Optional[np.ndarray] = None) -> None:
        """A provisioned machine joined the fleet: adopt the new graph (and
        refreshed GNN scores) and re-derive entry nodes, so a join that is a
        strictly better entry for a region actually takes it over."""
        self.graph = graph
        if scores is not None:
            self.scores = scores
        self.invalidate()

    def entry(self, region: str) -> int:
        if region not in self._entry:
            self._entry[region] = entry_node(
                self.graph, region, getattr(self.net, "tombstoned", ()))
        return self._entry[region]

    def _static_parts(self, src: int, machine: int) -> tuple[float, float]:
        key = (src, machine)
        v = self._static.get(key)
        if v is None:
            lat_s = float(self.net.routed_ms[src, machine]) * 1e-3
            prob = 0.0
            if self.scores is not None and machine < len(self.scores):
                prob = float(self.scores[machine])
            v = (lat_s, prob)
            self._static[key] = v
        return v

    def _score(self, req: Request, src: int, rep: Replica) -> float:
        lat_s, prob = self._static_parts(src, rep.machine)
        if self.policy == "nearest":
            return lat_s
        wait = rep.est_wait_s()
        if self.policy == "least_loaded":
            return lat_s + wait
        return (lat_s + wait) / (0.25 + prob)

    def pick(self, req: Request, replicas: Sequence[Replica],
             exclude: Sequence[int] = (), breaker=None,
             now: float = 0.0) -> Optional[Replica]:
        """Best healthy, accepting, reachable replica that can ever hold the
        request; None if no replica qualifies (request is dropped).

        ``exclude`` skips machines already attempted (hedging picks a
        *different* replica); ``breaker`` is an optional
        ``serve.resilience.CircuitBreaker`` consulted per machine at ``now``.
        If the breaker banned every otherwise-viable candidate the router
        fails open — ejecting the whole fleet must degrade to naive routing,
        never to serving nothing."""
        src = self.entry(req.region)
        best, best_score = None, math.inf
        banned = False
        for rep in replicas:
            if not (rep.alive and rep.accepting and rep.fits(req)):
                continue
            if rep.machine in exclude:
                continue
            if not self.net.reachable(src, rep.machine):
                continue
            if breaker is not None and not breaker.allow(rep.machine, now):
                banned = True
                continue
            s = self._score(req, src, rep)
            if s < best_score:
                best, best_score = rep, s
        if best is None and banned:
            return self.pick(req, replicas, exclude=exclude)
        return best


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------
def _eligible(graph: ClusterGraph, model: ServeModel) -> list[int]:
    mem = graph.memory_gb()
    return [i for i in range(graph.n)
            if model.kv_capacity_tokens(float(mem[i])) > 0]


class StaticPlacement:
    """First-N-by-id replica hosts; scale-up takes the next id."""

    name = "static"

    def __init__(self, graph: ClusterGraph, model: ServeModel,
                 n_replicas: int):
        self.graph = graph
        self.model = model
        self.active: list[int] = _eligible(graph, model)[:n_replicas]
        self.scores = None

    def desired(self) -> list[int]:
        return list(self.active)

    def acquire(self) -> Optional[int]:
        for i in _eligible(self.graph, self.model):
            if i not in self.active:
                self.active.append(i)
                return i
        return None

    def release(self) -> Optional[int]:
        return self.active.pop() if len(self.active) > 1 else None

    def on_machine_failed(self, machine_id: int) -> None:
        if machine_id in self.active:
            self.active.remove(machine_id)

    def on_machine_recovered(self, machine_id: int) -> None:
        """A crashed host came back (fault-plan recovery): host on it again."""
        if machine_id not in self.active:
            self.active.append(machine_id)

    def on_machine_joined(self, machine: Machine, graph: ClusterGraph) -> int:
        """A provisioned machine joined the fleet (autoscale): host on it."""
        self.graph = graph
        new_id = graph.n - 1
        self.active.append(new_id)
        return new_id


class HulkPlacement:
    """GNN-scored replica hosts via Algorithm 1, elastic under joins and
    failures through ``runtime.elastic.ElasticRuntime``."""

    name = "hulk"

    def __init__(self, graph: ClusterGraph, model: ServeModel,
                 n_replicas: int, params, cfg, external_load=None):
        self.graph = graph
        self.model = model
        self.params = params
        self.cfg = cfg
        # per-machine fraction of capacity claimed by a colocated tenant
        # (0..1, e.g. a training group pinned on the machine) — the router's
        # side of the multi-tenant negotiation: scores rank machines by the
        # decode throughput *left over* after the other tenant's claim, so
        # replicas land off the contended hosts when the fleet has room
        self.external_load = (None if external_load is None
                              else np.clip(np.asarray(external_load, float),
                                           0.0, 1.0))
        self.task = serve_task_for(model, n_replicas)
        self.n_replicas = n_replicas
        self.runtime = ElasticRuntime(graph, [self.task], params, cfg)
        # runtime node index -> fleet node index (they diverge once the
        # runtime compacts ids after a failure)
        self.rt2fleet: list[int] = list(range(graph.n))
        self.scores = self._gnn_scores(graph)
        self.active: list[int] = self._rank(self._group_fleet_ids())

    def _gnn_scores(self, graph: ClusterGraph) -> np.ndarray:
        """Per-machine serving score in (0, 1]: the GNN's serve-class
        probability (how strongly Algorithm 1 wants the machine in the serve
        group — connectivity + capability as learned from the oracle)
        weighted by the machine's decode throughput, so a well-connected but
        weak host never outranks a well-connected fast one."""
        logits = gnn_train.predict_logits(self.params, self.cfg, graph,
                                          device=_device.of(self.params))
        z = logits - logits.max(axis=1, keepdims=True)
        p = np.exp(z)
        prob = (p / p.sum(axis=1, keepdims=True))[:, 0]  # serve class = 0
        cap = np.array([self.model.decode_tokens_per_s(m.tflops)
                        for m in graph.machines])
        if self.external_load is not None:
            # machines that joined after construction carry no claim
            headroom = np.ones(len(cap))
            k = min(len(cap), len(self.external_load))
            headroom[:k] = 1.0 - 0.95 * self.external_load[:k]
            cap = cap * headroom
        # floor the probability so capacity stays the primary term when the
        # GNN is indifferent; the GNN then up-weights machines Algorithm 1
        # wants in the serve group and down-weights poorly connected ones
        score = (0.25 + prob) * cap
        top = float(score.max())
        return score / top if top > 0 else prob

    def _group_fleet_ids(self) -> list[int]:
        ids = self.runtime.assignment.groups.get(self.task.name, [])
        return [self.rt2fleet[i] for i in ids]

    def _rank(self, candidates: Sequence[int]) -> list[int]:
        """Replica hosts: every eligible machine ranked by the blended
        GNN x capacity score. Algorithm 1's group influences the ranking
        through the serve-class probability (group members score higher)
        rather than as a hard filter, so a conservative or noisy group never
        under-provisions vs the static baseline."""
        del candidates  # folded into the score via the class probability
        elig = _eligible(self.graph, self.model)
        elig.sort(key=lambda i: (-float(self.scores[i]), i))
        return elig[:self.n_replicas]

    def desired(self) -> list[int]:
        return list(self.active)

    def acquire(self) -> Optional[int]:
        """Scale up within the current fleet: the highest-scored eligible
        machine not yet hosting."""
        self.n_replicas += 1
        pool = [i for i in _eligible(self.graph, self.model)
                if i not in self.active]
        if not pool:
            return None
        pick = min(pool, key=lambda i: (-float(self.scores[i]), i))
        self.active.append(pick)
        return pick

    def release(self) -> Optional[int]:
        if len(self.active) <= 1:
            return None
        self.n_replicas = max(1, self.n_replicas - 1)
        worst = min(self.active, key=lambda i: (float(self.scores[i]), -i))
        self.active.remove(worst)
        return worst

    def on_machine_failed(self, machine_id: int) -> None:
        if machine_id in self.active:
            self.active.remove(machine_id)
        if machine_id in self.rt2fleet:
            rt_id = self.rt2fleet.index(machine_id)
            try:
                self.runtime.on_failure(FailureEvent([rt_id], at_step=0))
                self.rt2fleet.pop(rt_id)
            except assign_mod.PlacementError:
                # survivors can't meet the serve threshold: the runtime keeps
                # its old graph (and the mapping stays aligned with it);
                # routing still skips the dead replica via ``alive``
                pass

    def on_machine_recovered(self, machine_id: int) -> None:
        """A crashed host came back (fault-plan recovery): host on it again.
        The runtime's view is NOT rewound — Algorithm 1 already re-planned
        around the failure; the revived machine rejoins as serving capacity
        only, exactly like a spare."""
        if machine_id not in self.active:
            self.active.append(machine_id)

    def on_machine_joined(self, machine: Machine, graph: ClusterGraph) -> int:
        """Autoscale provisioned a machine: run it through
        ``ElasticRuntime.on_join`` (deferred-task / >10%-win re-assignment
        thresholds apply), refresh GNN scores, host on the new machine."""
        new_id = graph.n - 1
        lat = {j: float(graph.latency[new_id, fleet_j])
               for j, fleet_j in enumerate(self.rt2fleet)}
        self.runtime.on_join(machine, lat)
        self.rt2fleet.append(new_id)
        self.graph = graph
        self.scores = self._gnn_scores(graph)
        self.active.append(new_id)
        return new_id
