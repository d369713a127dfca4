"""Named stress scenarios for the geo-fleet simulator.

A scenario bundles a fleet builder, the task set, the comm model, jitter /
straggler settings, a fault schedule (fractions of the estimated run length)
and an optional time-varying traffic profile. Four scenario kinds live in
four registries:

* ``Scenario``          — training runs (``sim.evaluate``), ``SCENARIOS``;
* ``ServeScenario``     — request serving (``serve.evaluate``),
  ``SERVE_SCENARIOS``;
* ``DriftScenario``     — training under drift with an online controller
  (``sim.evaluate.run_drift_scenario``), ``DRIFT_SCENARIOS``;
* ``ColocatedScenario`` — a training tenant AND a serving tenant contending
  on one shared fleet (``sim.colocate``), ``COLOCATED_SCENARIOS``.

``register_scenario`` / ``unregister_scenario`` dispatch on the scenario's
type — one code path for every kind, including generated ones
(``sim.generate``) — and raise ``TypeError`` on anything that is not a
scenario. The per-kind helpers (``register``, ``register_serve``, ...) are
thin wrappers kept for call-site readability. See README "Adding a
scenario":

    from repro_torch.sim import scenarios as sc
    sc.register(sc.Scenario(name="my_case", description="...",
                            fleet=my_fleet_builder, tasks=sc.SIM_TASKS))

All randomness is derived from the run seed, so every scenario replays
bit-identically.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional

import numpy as np

from repro_torch.core import cost_model as cm
from repro_torch.core.graph import (GPU_CATALOG, ClusterGraph, Machine, _COORDS,
                              _latency_matrix, paper_fig1_graph, random_fleet)
from repro_torch.obs.monitors import DriftConfig
from repro_torch.runtime.controller import ControllerConfig
from repro_torch.sim.compute import JitterConfig
from repro_torch.sim.faults import FaultPlan, GrayFailure, LinkDegradation

# Scenario task set: one model big enough that its group must span several
# machines (30B params => ~480 GB of optimizer state, more than any single
# machine except an 8xA100 node) riding with a small task, at a reduced
# global batch so a simulated step is seconds-to-minutes. Multi-machine
# groups are what make contention, stragglers and faults bite.
SIM_TASKS: tuple[cm.ModelTask, ...] = (
    cm.ModelTask("GPT-30B", 30e9, 48, 7168, batch_tokens=65_536,
                 microbatches=4),
    dataclasses.replace(cm.GPT2_1_5B, batch_tokens=65_536, microbatches=4),
)

# traffic profile: (graph, horizon_s) -> scale(node_id, t) in (0, 1]
TrafficBuilder = Callable[[ClusterGraph, float], Callable[[int, float], float]]


# ---------------------------------------------------------------------------
# Scenario kinds (all four defined up front so the registry dispatch below
# can cover them with one table)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    description: str
    fleet: Callable[[int], ClusterGraph]
    tasks: tuple[cm.ModelTask, ...] = SIM_TASKS
    comm_model: str = "alphabeta"
    jitter: JitterConfig = JitterConfig()
    fault_fracs: tuple[float, ...] = ()   # fault times / estimated run length
    kills_per_fault: int = 1
    # declarative fault injection (sim.faults.FaultPlan); supersedes the
    # fault_fracs shim above when set
    fault_plan: Optional[object] = None
    traffic: Optional[TrafficBuilder] = None
    steps: int = 3


@dataclasses.dataclass(frozen=True)
class ServeScenario:
    name: str
    description: str
    fleet: Callable[[int], "ClusterGraph"]
    traffic: Callable[["ClusterGraph"], "object"]   # graph -> TrafficConfig
    model: "object"                                 # serve.costs.ServeModel
    n_replicas: int = 3
    max_batch: int = 8
    prefill_chunk: int = 256
    slo_s: float = 20.0
    comm_model: str = "alphabeta"
    jitter: JitterConfig = JitterConfig()
    autoscale: Optional[object] = None              # AutoscaleConfig
    spares: tuple = ()                              # Machines to provision
    fault_fracs: tuple[float, ...] = ()
    kills_per_fault: int = 1
    # declarative fault injection (sim.faults.FaultPlan); supersedes the
    # fault_fracs shim above when set
    fault_plan: Optional[object] = None
    # serving resilience (serve.resilience.ResilienceConfig); None = the
    # legacy blind-reroute path
    resilience: Optional[object] = None
    max_routes: Optional[int] = None                # None = executor default


@dataclasses.dataclass(frozen=True)
class DriftScenario:
    name: str
    description: str
    fleet: Callable[[int], ClusterGraph]
    controller: ControllerConfig
    tasks: tuple[cm.ModelTask, ...] = SIM_TASKS
    comm_model: str = "alphabeta"
    jitter: JitterConfig = JitterConfig()
    fault_plan: Optional[object] = None      # sim.faults.FaultPlan
    traffic: Optional[TrafficBuilder] = None
    steps: int = 8
    # which GNN scores candidate plans online: "sim" = telemetry-aware v2
    # labels (sees live slowdowns), "analytic" = v1 (cheap; the controller's
    # greedy polish supplies the drift-awareness)
    label_mode: str = "analytic"


@dataclasses.dataclass(frozen=True)
class ColocatedScenario:
    """A training tenant and a serving tenant on ONE contended fleet.

    ``sim.colocate.run_colocated`` runs a ``FleetSimulation`` and a
    ``ServeExecutor`` on the same ``Simulator``/``NetworkModel``/
    ``ComputeModel``: training activation/sync transfers and serve
    request/response transfers fair-share the same links, and the two
    placements see each other's load — the serve router through a
    per-machine ``external_load`` claim, the training labeler through
    ``NodeTelemetry.with_load`` (v2 features, ``label_mode="sim"``).

    Fault plans here are limited to environmental injectors (gray
    slowdowns, link degradation): crash-style faults rebuild the training
    data plane, which cannot be yanked out from under the serving tenant.
    """
    name: str
    description: str
    fleet: Callable[[int], ClusterGraph]
    traffic: Callable[["ClusterGraph"], "object"]    # graph -> TrafficConfig
    model: "object"                                  # serve.costs.ServeModel
    tasks: tuple[cm.ModelTask, ...] = ()             # training tenant
    n_replicas: int = 3
    max_batch: int = 8
    prefill_chunk: int = 256
    slo_s: float = 20.0
    comm_model: str = "alphabeta"
    jitter: JitterConfig = JitterConfig()
    steps: int = 2                                   # training steps per task
    # GNN flavour for the training placement: "analytic" (v1 features,
    # load-blind) or "sim" (v2 telemetry features — sees the serve claim)
    label_mode: str = "analytic"
    # environmental-only fault plan, injected through the serving executor
    # (the routing owner); validated by sim.colocate
    fault_plan: Optional[object] = None
    resilience: Optional[object] = None
    max_routes: Optional[int] = None


SCENARIOS: dict[str, Scenario] = {}
SERVE_SCENARIOS: dict[str, ServeScenario] = {}
DRIFT_SCENARIOS: dict[str, DriftScenario] = {}
COLOCATED_SCENARIOS: dict[str, ColocatedScenario] = {}

# type -> (registry, human label): the ONE dispatch table every
# registration helper goes through
_REGISTRIES: tuple[tuple[type, dict, str], ...] = (
    (Scenario, SCENARIOS, "scenario"),
    (ServeScenario, SERVE_SCENARIOS, "serve scenario"),
    (DriftScenario, DRIFT_SCENARIOS, "drift scenario"),
    (ColocatedScenario, COLOCATED_SCENARIOS, "colocated scenario"),
)


def _registry_of(scenario) -> tuple[dict, str]:
    for cls, registry, label in _REGISTRIES:
        if isinstance(scenario, cls):
            return registry, label
    raise TypeError(
        f"not a scenario: {type(scenario).__name__} (registrable kinds: "
        + ", ".join(cls.__name__ for cls, _, _ in _REGISTRIES) + ")")


def register_scenario(scenario):
    """Register any scenario kind in its registry (dispatch on type);
    raises ``TypeError`` for non-scenarios and ``ValueError`` on a name
    collision within the kind's registry."""
    registry, label = _registry_of(scenario)
    if scenario.name in registry:
        raise ValueError(f"{label} {scenario.name!r} already registered")
    registry[scenario.name] = scenario
    return scenario


def unregister_scenario(scenario) -> None:
    """Remove any scenario kind (instance or, for back-compat, a plain name
    — names are only searched in the training registry). Unknown names are
    a no-op so test teardown never fails; non-scenario objects raise
    ``TypeError`` just like ``register_scenario``."""
    if isinstance(scenario, str):
        SCENARIOS.pop(scenario, None)
        return
    registry, _ = _registry_of(scenario)
    registry.pop(scenario.name, None)


def _get_from(registry: dict, label: str, name: str):
    try:
        return registry[name]
    except KeyError:
        raise KeyError(f"unknown {label} {name!r}; "
                       f"known: {sorted(registry)}") from None


# per-kind wrappers (call-site readability + the historical API)
def register(scenario: Scenario) -> Scenario:
    return register_scenario(scenario)


def register_serve(scenario: ServeScenario) -> ServeScenario:
    return register_scenario(scenario)


def register_drift(scenario: DriftScenario) -> DriftScenario:
    return register_scenario(scenario)


def register_colocated(scenario: ColocatedScenario) -> ColocatedScenario:
    return register_scenario(scenario)


def unregister(name: str) -> None:
    """Remove a training scenario (test isolation; unknown names are a
    no-op so teardown never fails)."""
    SCENARIOS.pop(name, None)


def unregister_serve(name: str) -> None:
    """Remove a serve scenario (see ``unregister``)."""
    SERVE_SCENARIOS.pop(name, None)


def unregister_drift(name: str) -> None:
    """Remove a drift scenario (see ``unregister``)."""
    DRIFT_SCENARIOS.pop(name, None)


def unregister_colocated(name: str) -> None:
    """Remove a colocated scenario (see ``unregister``)."""
    COLOCATED_SCENARIOS.pop(name, None)


def get_scenario(name: str) -> Scenario:
    return _get_from(SCENARIOS, "scenario", name)


def get_serve_scenario(name: str) -> ServeScenario:
    return _get_from(SERVE_SCENARIOS, "serve scenario", name)


def get_drift_scenario(name: str) -> DriftScenario:
    return _get_from(DRIFT_SCENARIOS, "drift scenario", name)


def get_colocated_scenario(name: str) -> ColocatedScenario:
    return _get_from(COLOCATED_SCENARIOS, "colocated scenario", name)


@contextlib.contextmanager
def temporary_registration(*scenarios):
    """Register throwaway scenarios for the duration of a ``with`` block —
    accepts any mix of the four scenario kinds (including generated ones)
    through the same ``register_scenario`` dispatch, and always removes
    them on exit, so a failing test can't poison the registries for the
    rest of the session."""
    registered: list = []
    try:
        for scn in scenarios:
            register_scenario(scn)
            registered.append(scn)
        yield scenarios[0] if len(scenarios) == 1 else scenarios
    finally:
        for scn in registered:
            unregister_scenario(scn)


# ---------------------------------------------------------------------------
# Fleet builders
# ---------------------------------------------------------------------------
def lan_fleet(seed: int = 0, n: int = 8) -> ClusterGraph:
    """One region, fast links: contention and heterogeneity without the WAN."""
    rng = np.random.default_rng(seed)
    gpus = list(GPU_CATALOG)
    machines = [Machine("California", gpus[int(rng.integers(0, len(gpus)))], 8)
                for _ in range(n)]
    return ClusterGraph(machines, _latency_matrix(machines, rng))


def blocked_fleet(seed: int = 0) -> ClusterGraph:
    """Fleet containing the paper's policy-blocked Beijing<->Paris pair plus
    extra blocked links, so cross-block traffic must relay through the London
    hub (exercising ``routed_latency`` paths and relay-hub contention)."""
    rng = np.random.default_rng(seed)
    machines = [
        Machine("Beijing", "RTX3090", 8),
        Machine("Nanjing", "A5000", 8),
        Machine("Paris", "A100", 8),
        Machine("Berlin", "A40", 8),
        Machine("London", "V100", 8),
        Machine("California", "A100", 8),
        Machine("Tokyo", "V100", 8),
        Machine("Rome", "RTX3090", 8),
    ]
    lat = _latency_matrix(machines, rng)
    # Beijing/Nanjing may only reach Europe via London (ids: 0/1 -> 2/3/7).
    for cn in (0, 1):
        for eu in (2, 3, 7):
            lat[cn, eu] = lat[eu, cn] = 0.0
    return ClusterGraph(machines, lat)


# ---------------------------------------------------------------------------
# Traffic profiles
# ---------------------------------------------------------------------------
def diurnal_traffic(depth: float = 0.6) -> TrafficBuilder:
    """Sinusoidal background load phased by region longitude (local time of
    day): at a node's peak hour only ``1 - depth`` of link capacity is left
    for training traffic. The period equals the estimated run length so a run
    sweeps a full day."""
    def build(graph: ClusterGraph, horizon_s: float):
        period = max(horizon_s, 1.0)
        phase = np.array([_COORDS[m.region][1] / 360.0
                          for m in graph.machines])

        def scale(node: int, t: float) -> float:
            load = 0.5 + 0.5 * np.sin(2 * np.pi * (t / period + phase[node]))
            return float(1.0 - depth * load)
        return scale
    return build


# ---------------------------------------------------------------------------
# The training registry
# ---------------------------------------------------------------------------
register(Scenario(
    name="single_region_lan",
    description="8 heterogeneous machines on a 1 ms LAN — the contention-free "
                "baseline; placement quality is dominated by compute.",
    fleet=lan_fleet))

register(Scenario(
    name="cross_region_wan",
    description="The paper's Fig. 1 eight-region fleet under the alpha-beta "
                "WAN model.",
    fleet=paper_fig1_graph))

register(Scenario(
    name="diurnal_traffic",
    description="Cross-region fleet where background traffic follows local "
                "time of day, squeezing link capacity by up to 60%.",
    fleet=paper_fig1_graph,
    traffic=diurnal_traffic()))

register(Scenario(
    name="straggler_heavy",
    description="10-machine fleet with 25% persistent 3x stragglers and "
                "heavy per-op jitter (sigma=0.3).",
    fleet=lambda seed: random_fleet(10, seed=seed),
    jitter=JitterConfig(sigma=0.3, straggler_frac=0.25,
                        straggler_slowdown=3.0)))

register(Scenario(
    name="preemption_storm",
    description="12-machine fleet losing two machines at 30%/55%/80% of the "
                "run — every loss triggers an elastic re-plan and a restart "
                "of the in-flight step.",
    fleet=lambda seed: random_fleet(12, seed=seed),
    fault_fracs=(0.30, 0.55, 0.80),
    kills_per_fault=2,
    steps=2))

register(Scenario(
    name="blocked_links",
    description="Policy-blocked links force China<->Europe traffic to relay "
                "through London; the relay hub becomes a contended resource.",
    fleet=blocked_fleet))


# ---------------------------------------------------------------------------
# Serving scenarios (PR 3): request traffic against replica fleets. Kept in
# a separate registry from the training scenarios — ``evaluate_all`` and the
# training-scenario tests iterate ``SCENARIOS``; serving runs go through
# ``serve.evaluate.evaluate_serve_scenario``.
# ---------------------------------------------------------------------------
def _serve_imports():
    from repro_torch.serve.autoscale import AutoscaleConfig
    from repro_torch.serve.costs import serve_model_from_task
    from repro_torch.serve.traffic import ModelMix, TrafficConfig
    return AutoscaleConfig, serve_model_from_task, ModelMix, TrafficConfig


def _regions_of(graph) -> tuple[str, ...]:
    seen: list[str] = []
    for m in graph.machines:
        if m.region not in seen:
            seen.append(m.region)
    return tuple(seen)


def _default_serve_model():
    _, from_task, _, _ = _serve_imports()
    # 34B chat model at interactive decode efficiency (~1% MFU: small-batch
    # decode is weight-streaming-bound): per-replica throughput lands at
    # tens-to-hundreds of tokens/s, so a handful of rps of request traffic
    # genuinely contends for replica capacity — the regime where routing
    # and placement quality decide the latency tail.
    task = cm.ModelTask("Chat-34B", 34e9, 60, 7168)
    return from_task(task, name="chat-34b", decode_efficiency=0.01)


_SERVE_MODEL = _default_serve_model()
_SERVE_HORIZON_S = 300.0


def _serve_mix():
    _, _, ModelMix, _ = _serve_imports()
    return (ModelMix(_SERVE_MODEL.name, prompt_median=128.0,
                     gen_median=48.0),)


def _diurnal_serve_traffic(graph):
    _, _, _, TrafficConfig = _serve_imports()
    return TrafficConfig(
        rate_rps=7.0, horizon_s=_SERVE_HORIZON_S,
        regions=_regions_of(graph), mixes=_serve_mix(),
        diurnal_depth=0.85)


def _burst_serve_traffic(graph):
    _, _, _, TrafficConfig = _serve_imports()
    return TrafficConfig(
        rate_rps=5.0, horizon_s=_SERVE_HORIZON_S,
        regions=_regions_of(graph), mixes=_serve_mix(),
        burst_factor=6.0,
        burst_window=(0.35 * _SERVE_HORIZON_S, 0.55 * _SERVE_HORIZON_S),
        burst_region="Beijing")


def _failure_serve_traffic(graph):
    _, _, _, TrafficConfig = _serve_imports()
    return TrafficConfig(
        rate_rps=5.0, horizon_s=_SERVE_HORIZON_S,
        regions=_regions_of(graph), mixes=_serve_mix())


def _serve_autoscale():
    AutoscaleConfig, _, _, _ = _serve_imports()
    return AutoscaleConfig(check_period_s=15.0, queue_high=3.0,
                           queue_low=0.2, slo_s=None, min_replicas=2,
                           max_replicas=5, cooldown_s=45.0)


register_serve(ServeScenario(
    name="serve_diurnal",
    description="Follow-the-sun: request load peaks region by region with "
                "local daytime while diurnal background traffic squeezes "
                "the same links; nearest-replica routing melts whichever "
                "replica the sun is over.",
    fleet=paper_fig1_graph,
    traffic=_diurnal_serve_traffic,
    model=_SERVE_MODEL,
    n_replicas=3,
    slo_s=20.0,
    autoscale=_serve_autoscale()))

register_serve(ServeScenario(
    name="serve_regional_burst",
    description="Flat global load with a 6x request burst from Beijing for "
                "20% of the run — load-aware policies shed the spike across "
                "the fleet, nearest routing queues it on one replica.",
    fleet=paper_fig1_graph,
    traffic=_burst_serve_traffic,
    model=_SERVE_MODEL,
    n_replicas=3,
    slo_s=20.0,
    autoscale=_serve_autoscale()))

register_serve(ServeScenario(
    name="serve_replica_failure",
    description="Steady load; at 40% of the run one serving replica dies. "
                "Interrupted requests re-route and restart, and the "
                "autoscaler back-fills capacity (cold-start weight "
                "transfer included).",
    fleet=lambda seed: lan_fleet(seed, n=8),
    traffic=_failure_serve_traffic,
    model=_SERVE_MODEL,
    n_replicas=3,
    slo_s=15.0,
    autoscale=_serve_autoscale(),
    fault_fracs=(0.4,)))


# ---------------------------------------------------------------------------
# Drift scenarios (PR 9): training runs whose fault schedule makes the
# *initial* plan stale mid-run, paired with the guarded-controller config
# that is supposed to catch it. Kept in a third registry — drift runs go
# through ``sim.evaluate.run_drift_scenario`` which wires a
# ``runtime.controller.ReplanController`` into the fleet host.
#
# Fleets here are FIXED machine lists, not ``random_fleet``: the monitor
# thresholds below (absolute rolling-p95 seconds, EWMA slowdown ratios)
# were calibrated against these exact step times and would be meaningless
# on a randomly re-drawn fleet.
# ---------------------------------------------------------------------------
def drift_lan_fleet(seed: int = 0, n: int = 8) -> ClusterGraph:
    """n identical 8xV100 boxes (256 GB each) on one LAN: GPT-30B's group
    must span two machines and leaves the rest idle — exactly the spare
    capacity a mid-run re-plan needs to evict a graying member onto."""
    rng = np.random.default_rng(seed)
    machines = [Machine("California", "V100", 8) for _ in range(n)]
    return ClusterGraph(machines, _latency_matrix(machines, rng))


def drift_wan_fleet(seed: int = 0) -> ClusterGraph:
    """Four EU regions x two 8xA5000 boxes (192 GB each): GPT-30B needs
    three machines, so its group is forced across a region boundary and a
    degrading inter-region link genuinely rots the plan; healthy region
    pairs remain as re-plan targets."""
    rng = np.random.default_rng(seed)
    machines = [Machine(region, "A5000", 8)
                for region in ("Paris", "Berlin", "London", "Rome")
                for _ in range(2)]
    return ClusterGraph(machines, _latency_matrix(machines, rng))


# Step observations are sparse in training runs (one sim.step_s per task
# step), so drift monitors run with a short warm-up; windows/cooldowns are
# in sim seconds and sized to the step times of the fixed fleets above.
_GRAY_DRIFT = DriftConfig(window_s=1e9, min_samples=2, cooldown_s=60.0,
                          slowdown_threshold=1.8, slowdown_alpha=0.5,
                          latency_metric="sim.step_s")
_ROT_DRIFT = DriftConfig(window_s=240.0, min_samples=2, cooldown_s=25.0,
                         rolling_p95_threshold_s=14.0,
                         latency_metric="sim.step_s")
_BURST_DRIFT = DriftConfig(window_s=1e9, min_samples=2, cooldown_s=30.0,
                           slowdown_threshold=1.6, slowdown_alpha=0.6,
                           latency_metric="sim.step_s")

register_drift(DriftScenario(
    name="drift_gray_creep",
    description="Two of GPT-30B's V100 hosts gray out mid-run, creeping to "
                "6x over a ramp and never recovering; the guarded "
                "controller evicts them onto idle spares, static rides the "
                "sick boxes to the end.",
    fleet=drift_lan_fleet,
    # machines 1 and 2 are GPT-30B pipeline stages under the seed-0 sim-GNN
    # placement (GPT-2 rides machine 0 and finishes before the gray lands);
    # targeting two live stages makes both emit slowdown EWMA excursions,
    # which is what satisfies hysteresis=2
    fault_plan=FaultPlan((
        GrayFailure(at=0.20, machines=(1, 2), slowdown=6.0,
                    ramp=0.20, ramp_steps=4),)),
    controller=ControllerConfig(drift=_GRAY_DRIFT, hysteresis=2,
                                hysteresis_window_s=1e9, cooldown_s=120.0,
                                margin=0.02, probation_s=None),
    label_mode="sim"))

register_drift(DriftScenario(
    name="drift_link_rot",
    description="The inter-region link under GPT-30B's three-machine group "
                "degrades (6x latency, 15% bandwidth) for most of the run; "
                "re-planning regroups onto a healthy region pair.",
    fleet=drift_wan_fleet,
    # the seed-0 analytic-GNN placement pipelines GPT-30B across Paris
    # (machines 0, 1) + London (machine 4): rot that exact region pair.
    # lat_factor=30 pushes the ~10 ms link past the analytic comm model's
    # 120/250 ms class bounds, so the controller's scorer sees the capacity
    # collapse too (bw overlays themselves are invisible to the effective
    # latency view). Fault times are fractions of the *healthy* horizon
    # estimate, but rotted steps run ~10x long — duration=3.5 keeps the rot
    # up past the stretched end of a static run, so riding it out really
    # means riding it out
    fault_plan=FaultPlan((
        LinkDegradation(at=0.15, duration=3.5, regions=("Paris", "London"),
                        lat_factor=30.0, bw_factor=0.03),)),
    controller=ControllerConfig(drift=_ROT_DRIFT, hysteresis=2,
                                hysteresis_window_s=1e9, cooldown_s=120.0,
                                margin=0.02, probation_s=None),
    steps=16,
    label_mode="analytic"))

register_drift(DriftScenario(
    name="drift_flap_diurnal",
    description="Diurnal background traffic plus two short gray bursts that "
                "recover on their own: the alert storm where replanning on "
                "every alert pays migration cost for drift that is already "
                "gone — the guarded gate suppresses, unguarded thrashes.",
    fleet=drift_wan_fleet,
    traffic=diurnal_traffic(),
    # bursts land on live GPT-30B members (0, 1, 4 at seed 0) so they alert,
    # but recover within about one step — acting on them is pure loss
    fault_plan=FaultPlan((
        GrayFailure(at=0.30, machines=(1, 4), slowdown=4.0, duration=0.10),
        GrayFailure(at=0.60, machines=(0, 4), slowdown=4.0, duration=0.10),)),
    controller=ControllerConfig(drift=_BURST_DRIFT, hysteresis=3,
                                hysteresis_window_s=150.0, cooldown_s=240.0,
                                margin=0.10, probation_s=120.0,
                                probation_regress=0.10),
    label_mode="analytic"))


# ---------------------------------------------------------------------------
# Colocated mixes (PR 10): one training tenant + one serving tenant on the
# same contended fleet — the regime the ROADMAP's multi-tenant item asks
# for. Training activation/sync transfers fair-share links with serve
# request traffic, so serve placement quality now includes *staying off the
# trainer's machines and links*; these three mixes are the BENCH_mix
# comparison set (benchmarks/mix_bench.py).
# ---------------------------------------------------------------------------
# A 13B trainer: two machines' worth of optimizer state (208 GB) on most
# classes, so its group claims real capacity but leaves replica room.
COLO_TASKS: tuple[cm.ModelTask, ...] = (
    cm.ModelTask("GPT-13B", 13e9, 40, 5120, batch_tokens=32_768,
                 microbatches=4),
)

_COLO_HORIZON_S = 240.0


def _colo_steady_traffic(graph):
    _, _, _, TrafficConfig = _serve_imports()
    return TrafficConfig(
        rate_rps=5.0, horizon_s=_COLO_HORIZON_S,
        regions=_regions_of(graph), mixes=_serve_mix())


def _colo_burst_traffic(graph):
    _, _, _, TrafficConfig = _serve_imports()
    return TrafficConfig(
        rate_rps=4.0, horizon_s=_COLO_HORIZON_S,
        regions=_regions_of(graph), mixes=_serve_mix(),
        burst_factor=5.0,
        burst_window=(0.35 * _COLO_HORIZON_S, 0.55 * _COLO_HORIZON_S),
        burst_region="Beijing")


def _colo_diurnal_traffic(graph):
    _, _, _, TrafficConfig = _serve_imports()
    return TrafficConfig(
        rate_rps=6.0, horizon_s=_COLO_HORIZON_S,
        regions=_regions_of(graph), mixes=_serve_mix(),
        diurnal_depth=0.85)


register_colocated(ColocatedScenario(
    name="colo_wan_steady",
    description="The paper's eight-region fleet serving steady chat traffic "
                "while a 13B trainer claims part of the fleet: load-blind "
                "placement colocates replicas with the trainer and queues "
                "behind its activation transfers.",
    fleet=paper_fig1_graph,
    traffic=_colo_steady_traffic,
    model=_SERVE_MODEL,
    tasks=COLO_TASKS,
    n_replicas=3,
    slo_s=20.0))

register_colocated(ColocatedScenario(
    name="colo_burst_contend",
    description="A 5x Beijing request burst lands while the trainer holds "
                "its machines: the burst must be shed across replicas that "
                "are NOT sharing links with the trainer.",
    fleet=paper_fig1_graph,
    traffic=_colo_burst_traffic,
    model=_SERVE_MODEL,
    tasks=COLO_TASKS,
    n_replicas=3,
    slo_s=20.0))

register_colocated(ColocatedScenario(
    name="colo_hetero_lan",
    description="Ten heterogeneous machines on one LAN, diurnal chat load + "
                "the 13B trainer: no WAN latency to hide behind, so the win "
                "is purely machine choice under contention.",
    fleet=lambda seed: lan_fleet(seed, n=10),
    traffic=_colo_diurnal_traffic,
    model=_SERVE_MODEL,
    tasks=COLO_TASKS,
    n_replicas=3,
    slo_s=15.0))
