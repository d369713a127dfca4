"""Multi-tenant colocation: a training fleet and a serving fleet on ONE
contended set of machines and links.

``run_colocated`` starts a ``FleetSimulation`` and a ``ServeExecutor`` on a
single shared ``Simulator`` / ``NetworkModel`` / ``ComputeModel``:

* **Links** contend natively — both tenants' transfers go through the one
  fair-share ``NetworkModel``, so a gradient sync saturating a WAN link
  slows a concurrent weight transfer and vice versa.
* **Machines** contend through ``TenantCompute``: each tenant sees the
  shared ``ComputeModel`` through a view that stretches its op durations by
  the *other* tenant's utilization claim on that machine — the same
  capacity-share model ``NodeTelemetry.with_load`` feeds the labeler
  (``1 / (1 - min(load, 0.95))``).

The two placements negotiate in three passes:

1. a *draft* serve placement (load-blind) estimates the serve tenant's
   per-machine utilization from the trace's analytic service demand;
2. the training tenant places — under ``label_mode="sim"`` its GNN sees the
   draft serve claim folded into v2 telemetry via ``with_load``;
3. the serve tenant places for real — under ``policy="hulk"`` its router
   discounts machine scores by the training claim (``external_load``),
   while the baseline routers stay load-blind (the thing the mix benchmark
   measures).

Fault plans are restricted to *environmental* injectors (``GrayFailure``,
``LinkDegradation``): they flow through the serving executor (which owns
routing-cache invalidation) into the shared planes, degrading both tenants.
Crash-style injectors rebuild the training data plane and are rejected —
the fabric cannot be yanked out from under the other tenant.

Accounting note: ``net.bytes_moved`` (and the other network counters) are
fleet-wide — the planes are shared, so per-tenant byte attribution is not
defined here.

Port of ``repro/sim/colocate.py``: numpy copies; both tenants' GNNs run
where their params lie.
"""
from __future__ import annotations

import json
from typing import Optional

import numpy as np

from repro_torch import obs as obs_mod
from repro_torch.sim import faults as faults_mod
from repro_torch.sim import scenarios as sc
from repro_torch.sim.compute import ComputeModel
from repro_torch.sim.engine import Simulator
from repro_torch.sim.evaluate import (FleetSimulation, HulkPlacer,
                                      Placement, StaticPlacer,
                                      observed_telemetry, trained_gnn)
from repro_torch.sim.network import NetworkModel
from repro_torch.sim.workload import ServeExecutor

# A training group keeps its machines roughly this busy (the gaps are comm
# phases and pipeline bubbles); the serve tenant contends for the rest.
TRAIN_UTIL = 0.85

# Capacity claims are clipped here, mirroring NodeTelemetry.with_load — no
# tenant can claim a machine entirely, so the other always makes progress.
_LOAD_CAP = 0.95

_ENV_INJECTORS = (faults_mod.GrayFailure, faults_mod.LinkDegradation)


class TenantCompute:
    """One tenant's view of a shared ``ComputeModel``.

    ``duration`` stretches this tenant's op times by ``1 / (1 - other)``
    where ``other`` is the colocated tenant's utilization claim on the
    machine (clipped at ``_LOAD_CAP``) — processor sharing against a
    background load. Everything else (liveness, telemetry, gray state,
    busy accounting) delegates to the one shared model, so environmental
    faults and autoscale joins stay visible to both tenants."""

    def __init__(self, base: ComputeModel, other_load: np.ndarray):
        self._base = base
        load = np.clip(np.asarray(other_load, float), 0.0, _LOAD_CAP)
        self.stretch = 1.0 / (1.0 - load)

    def duration(self, machine: int, work_flops: float, step: int = 0,
                 microbatch: int = 0, tag: int = 0) -> float:
        d = self._base.duration(machine, work_flops, step, microbatch, tag)
        if machine < len(self.stretch):
            s = float(self.stretch[machine])
            if s != 1.0:
                # the base already booked d; book only the contention tail
                self._base.busy_s[machine] += d * (s - 1.0)
                d *= s
        return d

    def __getattr__(self, name):
        return getattr(self._base, name)


def _validate_fault_plan(plan) -> None:
    if plan is None:
        return
    for inj in plan.injectors:
        if not isinstance(inj, _ENV_INJECTORS):
            raise ValueError(
                f"colocated fault plans allow only environmental injectors "
                f"(GrayFailure, LinkDegradation), got "
                f"{type(inj).__name__}: crash-style faults rebuild the "
                f"training data plane under the serving tenant")


def _serve_claim(graph, model, hosts, trace, horizon_s: float) -> np.ndarray:
    """Per-machine serve utilization estimate: the trace's analytic service
    demand spread evenly over the replica hosts."""
    load = np.zeros(graph.n)
    hosts = list(hosts)
    if not hosts or horizon_s <= 0 or not trace:
        return load
    per_host = {h: 0.0 for h in hosts}
    for req in trace:
        for h in hosts:
            tf = graph.machines[h].tflops
            per_host[h] += (model.service_s(req.prompt_tokens,
                                            req.gen_tokens, tf)
                            / len(hosts))
    for h, busy in per_host.items():
        load[h] = min(_LOAD_CAP, busy / horizon_s)
    return load


def _greedy_train_placements(graph, tasks,
                             comm_model: str = "alphabeta") -> dict:
    """GNN-free training placement: per task, grab machines in descending
    TFLOPs (id tie-break) until ~1.3x the memory floor fits, pipeline them
    in greedy chain order. Deterministic and cheap — the placement the
    generator's fuzz loop uses so invariant checks never wait on GNN
    training."""
    from repro_torch.core import cost_model as cm

    comm = cm.make_comm(graph, comm_model)
    by_speed = sorted(range(graph.n),
                      key=lambda i: (-graph.machines[i].tflops, i))
    used: set[int] = set()
    out: dict[str, Placement] = {}
    for task in tasks:
        ids: list[int] = []
        mem = 0.0
        for i in by_speed:
            if i in used:
                continue
            ids.append(i)
            mem += graph.machines[i].memory_gb
            if mem >= 1.3 * task.min_memory_gb and len(ids) >= 1:
                order = cm.greedy_chain_order(graph, ids)
                c, p = cm.gpipe_time(graph, ids, task, comm, order)
                if np.isfinite(c + p):
                    break
        else:
            raise ValueError(f"fleet cannot fit task {task.name!r} "
                             f"({task.min_memory_gb:.0f} GB floor)")
        used.update(ids)
        out[task.name] = Placement(list(ids), "gpipe",
                                   cm.greedy_chain_order(graph, ids))
    return out


def _serve_placement(graph, scenario, policy: str, params, cfg,
                     external_load=None):
    from repro_torch.serve.router import HulkPlacement, StaticPlacement

    if policy == "hulk":
        return HulkPlacement(graph, scenario.model, scenario.n_replicas,
                             params, cfg, external_load=external_load)
    return StaticPlacement(graph, scenario.model, scenario.n_replicas)


def run_colocated(scenario: sc.ColocatedScenario, policy: str, seed: int = 0,
                  *, data_plane: str = "fast", obs=None,
                  train_placer: str = "hulk") -> dict:
    """Run one colocated scenario under a serve routing ``policy``
    (``nearest`` / ``least_loaded`` / ``hulk``). Returns a dict with the
    serving tenant's ``ServeResult`` + raw records, the training tenant's
    ``SimResult``, and the negotiated host sets.

    ``train_placer="hulk"`` places the training tenant with the trained GNN
    (folding the serve claim into telemetry under ``label_mode="sim"``);
    ``"greedy"`` uses the cheap deterministic first-fit placement — the
    generator's fuzz loop, where no GNN should be trained."""
    from repro_torch.serve import traffic as straffic
    from repro_torch.serve.evaluate import serve_gnn, summarize

    _validate_fault_plan(scenario.fault_plan)
    if not scenario.tasks:
        raise ValueError(f"colocated scenario {scenario.name!r} has no "
                         f"training tasks; use a ServeScenario instead")

    rec = obs if obs is not None else obs_mod.NULL
    graph = scenario.fleet(seed)
    trace = straffic.generate(scenario.traffic(graph), seed=seed)
    horizon_s = max((r.t_arrival for r in trace), default=1.0)

    sparams = scfg = None
    if policy == "hulk":
        sparams, scfg = serve_gnn(scenario.model, scenario.n_replicas, seed=0)

    # pass 1: draft serve placement -> the serve tenant's capacity claim
    draft = _serve_placement(graph, scenario, policy, sparams, scfg)
    serve_claim = _serve_claim(graph, scenario.model, draft.desired(), trace,
                               horizon_s)

    # pass 2: training placement; sim-label GNNs see the serve claim
    tasks = list(scenario.tasks)
    if train_placer == "greedy":
        placements = _greedy_train_placements(graph, tasks,
                                              scenario.comm_model)
    elif train_placer == "hulk":
        tparams, tcfg = trained_gnn(tasks, seed=0,
                                    label_mode=scenario.label_mode,
                                    jitter=scenario.jitter,
                                    comm_model=scenario.comm_model)
        train_graph = graph
        if scenario.label_mode == "sim":
            telem = observed_telemetry(graph, scenario.jitter, seed=seed,
                                       comm_model=scenario.comm_model)
            train_graph = graph.with_telemetry(telem.with_load(serve_claim))
        placer = HulkPlacer(tasks, tparams, tcfg,
                            comm_model=scenario.comm_model,
                            jitter=scenario.jitter, seed=seed)
        placements = placer.place(train_graph)
    else:
        raise ValueError(f"unknown train_placer {train_placer!r} "
                         f"(known: hulk, greedy)")
    train_ids = sorted({i for pl in placements.values() for i in pl.ids})
    train_claim = np.zeros(graph.n)
    train_claim[train_ids] = TRAIN_UTIL

    # pass 3: final serve placement; the hulk router discounts machine
    # scores by the training claim, baselines stay load-blind
    final = _serve_placement(graph, scenario, policy, sparams, scfg,
                             external_load=train_claim)
    serve_ids = sorted(final.desired())
    serve_claim = _serve_claim(graph, scenario.model, serve_ids, trace,
                               horizon_s)

    # one shared fabric; each tenant compute view carries the other's claim
    sim = Simulator(obs=rec)
    net = NetworkModel(graph, scenario.comm_model, solver=data_plane, obs=rec)
    base_compute = ComputeModel(graph, scenario.jitter, seed=seed)
    train_compute = TenantCompute(base_compute, serve_claim)
    serve_compute = TenantCompute(base_compute, train_claim)

    fs = FleetSimulation(graph, tasks, StaticPlacer(placements),
                         comm_model=scenario.comm_model,
                         jitter=scenario.jitter, steps=scenario.steps,
                         seed=seed, net_solver=data_plane, obs=rec,
                         sim=sim, net=net, compute=train_compute)
    se = ServeExecutor(graph, scenario.model, trace, policy, params=sparams,
                       cfg=scfg, comm_model=scenario.comm_model,
                       jitter=scenario.jitter,
                       n_replicas=scenario.n_replicas,
                       max_batch=scenario.max_batch,
                       prefill_chunk=scenario.prefill_chunk,
                       fault_plan=scenario.fault_plan,
                       resilience=scenario.resilience,
                       max_routes=scenario.max_routes, seed=seed,
                       data_plane=data_plane, obs=rec,
                       sim=sim, net=net, compute=serve_compute,
                       external_load=train_claim if policy == "hulk"
                       else None)

    fs.start()
    se.start()
    # bound the drain: stretched training (<= 1/(1-0.95) = 20x analytic)
    # plus the serve tail both finish well inside this window
    until = max(se.run_until, 50.0 * fs._estimate_horizon() + 600.0)
    sim.run(until=until)
    raw = se.collect()
    train = fs.finalize()

    return {
        "scenario": scenario.name,
        "policy": policy,
        "seed": seed,
        "serve": summarize(raw, slo_s=scenario.slo_s),
        "raw": raw,
        "train": train,
        "train_hosts": train_ids,
        "serve_hosts": serve_ids,
        "overlap": sorted(set(train_ids) & set(serve_ids)),
        "until_s": until,
    }


def canonical_colocated(result: dict) -> str:
    """A stable byte-exact projection of one colocated run — the serving
    tenant's per-request outcomes (``chaos.canonical_records``) plus the
    training tenant's step trajectory — for determinism assertions."""
    from repro_torch.sim.chaos import canonical_records

    train = result["train"]
    train_part = {
        "per_task": {name: {"failed": bool(d["failed"]),
                            "step_times": [f"{t:.9e}" for t
                                           in d["step_times"]]}
                     for name, d in sorted(train.per_task.items())},
        "makespan": f"{train.makespan:.9e}",
        "bytes_moved": f"{train.bytes_moved:.6e}",
        "train_hosts": result["train_hosts"],
        "serve_hosts": result["serve_hosts"],
    }
    return json.dumps({"serve": canonical_records(result["raw"]),
                       "train": train_part}, sort_keys=True)


def check_colocated_invariants(result: dict, scenario=None) -> None:
    """Exactly-once + liveness for a colocated run: every request resolved
    at most one way (``chaos.check_invariants``) and every training task
    completed its configured steps — neither tenant lost or double-counted
    work to the other."""
    from repro_torch.sim.chaos import check_invariants

    check_invariants(result["raw"])
    train = result["train"]
    want = scenario.steps if scenario is not None else None
    for name, d in train.per_task.items():
        done = len(d["step_times"])
        if d["failed"]:
            raise AssertionError(f"training task {name!r} failed in the "
                                 f"colocated run")
        if done <= 0:
            raise AssertionError(f"training task {name!r} made no progress "
                                 f"in the colocated run")
        if want is not None and done != want:
            raise AssertionError(f"training task {name!r} did {done} steps, "
                                 f"wanted {want}")
