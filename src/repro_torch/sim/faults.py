"""Declarative, seed-deterministic fault injection for the fleet simulator.

A ``FaultPlan`` is a tuple of typed *injectors* — each one a frozen
dataclass describing a failure mode in fleet-level terms (which region,
what fraction, how long) with every time expressed as a **fraction of the
run horizon**, the same convention the legacy ``fault_fracs`` fields used.
``compile_plan`` resolves a plan against a concrete ``ClusterGraph`` and
horizon into a flat, time-ordered list of ``FaultAction`` engine payloads;
the hosts (``sim.workload.ServeExecutor`` and
``sim.evaluate.FleetSimulation``) schedule one engine event per action
(``pin_epoch=False``, so fault events survive re-plan epoch bumps) and
dispatch on ``FaultAction.kind``:

* ``crash``      — machines die. Victims are either explicit (original
  graph ids, resolved at compile time) or drawn at *fire* time from the
  host's alive pool with ``rng((seed, 0xFA17, injector))`` — exactly the
  draw the legacy ``fault_fracs`` path used, which is what keeps the shim
  (``plan_from_fracs``) bit-identical to the old mechanism. An optional
  ``recover_after`` makes the host revive/rejoin the victims later via the
  existing tombstone/revive (serving) or ``on_join`` (training) paths.
* ``link`` / ``link_clear`` — a named bandwidth/latency overlay on a set of
  machine pairs (``NetworkModel.apply_link_fault``); ``cut=True`` severs
  the pairs entirely (region partition). Overlays compose multiplicatively
  and heal when cleared.
* ``gray`` / ``gray_clear``  — a silent slowdown multiplier on a machine
  (``ComputeModel.set_gray``); ramps compile to a staircase of ``gray``
  actions so a gray failure can creep in instead of arriving step-shaped.

Every random choice is keyed on ``(seed, stream, injector_index)`` —
counter-based, never order-dependent — so a plan replays bit-identically
and two hosts given the same plan + seed inject the same faults.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np

from repro_torch.core.graph import ClusterGraph

# RNG stream constants (crash fire-time draws reuse the legacy 0xFA17 key)
CRASH_STREAM = 0xFA17
_PREEMPT_STREAM = 0x9E61
_GRAY_STREAM = 0x6EA1
_FLAP_STREAM = 0xF1A9


# ---------------------------------------------------------------------------
# Injectors
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MachineCrash:
    """Kill machines at ``at`` (fraction of the horizon).

    With explicit ``machines`` (original graph ids) the crash is
    *machine-level*: the nodes tombstone out of the network/compute models
    and stop relaying traffic. With ``machines=()`` the host draws
    ``kills`` victims from its alive pool at fire time — the legacy
    ``fault_fracs`` semantics (serving: replica processes die, their
    machines keep routing). ``recover_after`` (fraction of the horizon,
    measured from the crash) revives the victims and rejoins them.
    """
    at: float
    kills: int = 1
    machines: tuple[int, ...] = ()
    recover_after: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class RegionPreemption:
    """Correlated preemption wave: a ``frac`` of ``region``'s machines
    (chosen with ``rng((seed, 0x9E61, injector))`` at compile time) die
    together — the spot-market event that kills a whole zone at once."""
    at: float
    region: str
    frac: float = 1.0
    recover_after: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class LinkDegradation:
    """Between ``at`` and ``at + duration``: the links between the two
    ``regions`` (or the explicit machine-id ``pairs``) run at
    ``bw_factor`` x bandwidth and ``lat_factor`` x latency."""
    at: float
    duration: float
    regions: Optional[tuple[str, str]] = None
    pairs: tuple[tuple[int, int], ...] = ()
    bw_factor: float = 1.0
    lat_factor: float = 1.0


@dataclasses.dataclass(frozen=True)
class RegionPartition:
    """Between ``at`` and ``at + duration``: every link between
    ``regions`` and the rest of the fleet is severed, then heals."""
    at: float
    duration: float
    regions: tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class GrayFailure:
    """Machines silently slow down by ``slowdown``x — alive, routable, just
    degraded (the failure mode health checks miss). ``ramp`` spreads the
    onset over that fraction of the horizon in ``ramp_steps`` increments;
    ``duration=None`` means the machine never recovers within the run."""
    at: float
    machines: tuple[int, ...] = ()
    picks: int = 1
    slowdown: float = 3.0
    ramp: float = 0.0
    ramp_steps: int = 4
    duration: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class MachineFlap:
    """A machine repeatedly crashes and recovers: ``cycles`` x
    (``down`` fraction dead, ``up`` fraction alive). ``machine=None``
    draws one with ``rng((seed, 0xF1A9, injector))`` at compile time."""
    at: float
    machine: Optional[int] = None
    down: float = 0.02
    up: float = 0.05
    cycles: int = 2


Injector = Union[MachineCrash, RegionPreemption, LinkDegradation,
                 RegionPartition, GrayFailure, MachineFlap]


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    injectors: tuple = ()

    def __bool__(self) -> bool:
        return bool(self.injectors)


@dataclasses.dataclass(frozen=True)
class FaultAction:
    """One resolved engine event: ``t`` is absolute sim seconds."""
    t: float
    kind: str            # crash | link | link_clear | gray | gray_clear
    payload: dict
    injector: int        # index into plan.injectors (rng key + trace label)


def plan_from_fracs(fault_fracs: Sequence[float],
                    kills_per_fault: int = 1) -> FaultPlan:
    """The legacy ``fault_fracs``/``kills_per_fault`` fields as a plan:
    one drawn-at-fire-time crash per fraction, no recovery — compiles to
    the exact event schedule (and rng keys) the old mechanism produced."""
    return FaultPlan(tuple(MachineCrash(at=float(f), kills=kills_per_fault)
                           for f in fault_fracs))


def has_link_faults(plan: Optional[FaultPlan]) -> bool:
    return plan is not None and any(
        isinstance(inj, (LinkDegradation, RegionPartition))
        for inj in plan.injectors)


# ---------------------------------------------------------------------------
# Compilation
# ---------------------------------------------------------------------------
def _region_ids(graph: ClusterGraph, region: str) -> list[int]:
    return [i for i, m in enumerate(graph.machines) if m.region == region]


def _cross_pairs(graph: ClusterGraph, a: str, b: str) -> list[tuple[int, int]]:
    ia, ib = _region_ids(graph, a), _region_ids(graph, b)
    return [(i, j) for i in ia for j in ib]


def _partition_pairs(graph: ClusterGraph,
                     regions: Sequence[str]) -> list[tuple[int, int]]:
    group = {i for r in regions for i in _region_ids(graph, r)}
    rest = [i for i in range(graph.n) if i not in group]
    return [(i, j) for i in sorted(group) for j in rest]


def compile_plan(plan: FaultPlan, graph: ClusterGraph, horizon: float,
                 seed: int = 0) -> list[FaultAction]:
    """Resolve a plan against a concrete fleet + horizon. Actions come out
    in injector order (ties in time resolve by emission order, matching how
    the legacy loop scheduled its events); all machine ids in payloads are
    *original* ids of ``graph`` — hosts whose ids drift (compaction after a
    failure) translate at apply time."""
    actions: list[FaultAction] = []
    for idx, inj in enumerate(plan.injectors):
        t0 = float(inj.at) * horizon
        if isinstance(inj, MachineCrash):
            rec = (None if inj.recover_after is None
                   else float(inj.recover_after) * horizon)
            actions.append(FaultAction(t0, "crash", {
                "kills": int(inj.kills),
                "machines": tuple(int(m) for m in inj.machines),
                "recover_after_s": rec}, idx))
        elif isinstance(inj, RegionPreemption):
            ids = _region_ids(graph, inj.region)
            if not ids:
                continue
            k = max(1, int(round(inj.frac * len(ids))))
            if k < len(ids):
                rng = np.random.default_rng((seed, _PREEMPT_STREAM, idx))
                ids = sorted(int(i) for i in
                             rng.choice(ids, size=k, replace=False))
            rec = (None if inj.recover_after is None
                   else float(inj.recover_after) * horizon)
            actions.append(FaultAction(t0, "crash", {
                "kills": len(ids), "machines": tuple(ids),
                "recover_after_s": rec}, idx))
        elif isinstance(inj, LinkDegradation):
            pairs = (tuple(_cross_pairs(graph, *inj.regions))
                     if inj.regions is not None
                     else tuple((int(a), int(b)) for a, b in inj.pairs))
            if not pairs:
                continue
            actions.append(FaultAction(t0, "link", {
                "pairs": pairs, "bw_factor": float(inj.bw_factor),
                "lat_factor": float(inj.lat_factor), "cut": False}, idx))
            actions.append(FaultAction(t0 + float(inj.duration) * horizon,
                                       "link_clear", {"fault_id": idx}, idx))
        elif isinstance(inj, RegionPartition):
            pairs = tuple(_partition_pairs(graph, inj.regions))
            if not pairs:
                continue
            actions.append(FaultAction(t0, "link", {
                "pairs": pairs, "bw_factor": 1.0, "lat_factor": 1.0,
                "cut": True}, idx))
            actions.append(FaultAction(t0 + float(inj.duration) * horizon,
                                       "link_clear", {"fault_id": idx}, idx))
        elif isinstance(inj, GrayFailure):
            machines = [int(m) for m in inj.machines if m < graph.n]
            if not machines and graph.n > 0:
                rng = np.random.default_rng((seed, _GRAY_STREAM, idx))
                k = min(max(1, int(inj.picks)), graph.n)
                machines = sorted(int(i) for i in
                                  rng.choice(graph.n, size=k, replace=False))
            steps = max(1, int(inj.ramp_steps)) if inj.ramp > 0 else 1
            for s in range(1, steps + 1):
                t = t0 + float(inj.ramp) * horizon * s / steps
                # linear creep from 1 -> slowdown across the ramp
                f = 1.0 + (float(inj.slowdown) - 1.0) * s / steps
                for m in machines:
                    actions.append(FaultAction(t, "gray",
                                               {"machine": m, "factor": f},
                                               idx))
            if inj.duration is not None:
                t_end = t0 + float(inj.duration) * horizon
                for m in machines:
                    actions.append(FaultAction(t_end, "gray_clear",
                                               {"machine": m}, idx))
        elif isinstance(inj, MachineFlap):
            if inj.machine is None:
                if graph.n == 0:
                    continue
                rng = np.random.default_rng((seed, _FLAP_STREAM, idx))
                m = int(rng.integers(0, graph.n))
            else:
                m = int(inj.machine)
            t = t0
            for _ in range(max(1, int(inj.cycles))):
                actions.append(FaultAction(t, "crash", {
                    "kills": 1, "machines": (m,),
                    "recover_after_s": float(inj.down) * horizon}, idx))
                t += (float(inj.down) + float(inj.up)) * horizon
        else:
            raise TypeError(f"unknown fault injector {type(inj).__name__}")
    return actions
