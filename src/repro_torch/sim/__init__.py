"""repro_torch.sim — deterministic discrete-event geo-fleet simulator (port
of ``repro/sim``).

Replays training schedules produced by ``core.assign`` /
``core.placement.plan_runtime`` over a ``ClusterGraph``, modeling per-link
bandwidth with fair-share contention, per-machine compute with straggler
jitter, pipeline bubbles, DP parameter-server sync, TP all-reduce rings, and
fault events that trigger ``runtime.elastic`` re-planning mid-run; serves
requests through ``workload.ServeExecutor``; scores Hulk against Systems
A/B/C on the scenario registry, runs the drift scenarios under the online
re-planning controller, colocates a training and a serving tenant
(``colocate``), and fuzzes fault plans (``chaos``) and generated scenarios
(``generate``) against the simulator's invariants. Pure numpy/scipy, copied
from the reference, so a run gives the same numbers, events and traces; the
Hulk GNNs run on whatever device their params lie.

Calibration contract: with no contention, no jitter and no faults, the
simulated per-step time of each parallelism strategy equals the analytic
``core.cost_model`` prediction.
"""
from repro_torch.sim.colocate import (TenantCompute, canonical_colocated,
                                      check_colocated_invariants,
                                      run_colocated)
from repro_torch.sim.compute import ComputeModel, JitterConfig
from repro_torch.sim.engine import Simulator
from repro_torch.sim.evaluate import (FleetSimulation, SimResult,
                                      comparison_table, evaluate_all,
                                      evaluate_scenario, observed_telemetry,
                                      observed_telemetry_live,
                                      run_drift_scenario, simulate_single)
from repro_torch.sim.generate import (ENVELOPE, approx_params,
                                      check_scenario, declared_invariants,
                                      generate_scenario, generated_scenarios)
from repro_torch.sim.faults import (FaultPlan, GrayFailure, LinkDegradation,
                                    MachineCrash, MachineFlap, RegionPartition,
                                    RegionPreemption, compile_plan,
                                    plan_from_fracs)
from repro_torch.sim.network import NetworkModel
from repro_torch.sim.scenarios import (COLOCATED_SCENARIOS, DRIFT_SCENARIOS,
                                       SCENARIOS, SERVE_SCENARIOS,
                                       ColocatedScenario, DriftScenario,
                                       Scenario, ServeScenario,
                                       get_colocated_scenario,
                                       get_drift_scenario, get_scenario,
                                       get_serve_scenario, register,
                                       register_colocated, register_drift,
                                       register_scenario, register_serve,
                                       temporary_registration, unregister,
                                       unregister_colocated, unregister_drift,
                                       unregister_scenario, unregister_serve)
from repro_torch.sim.workload import ServeExecutor

__all__ = [
    "Simulator", "NetworkModel", "ComputeModel", "JitterConfig",
    "Scenario", "SCENARIOS", "register", "get_scenario",
    "ServeScenario", "SERVE_SCENARIOS", "register_serve",
    "get_serve_scenario", "ServeExecutor",
    "DriftScenario", "DRIFT_SCENARIOS", "register_drift",
    "get_drift_scenario", "unregister_drift", "run_drift_scenario",
    "ColocatedScenario", "COLOCATED_SCENARIOS", "register_colocated",
    "get_colocated_scenario", "unregister_colocated",
    "register_scenario", "unregister_scenario",
    "run_colocated", "canonical_colocated", "check_colocated_invariants",
    "TenantCompute",
    "generate_scenario", "generated_scenarios", "check_scenario",
    "declared_invariants", "approx_params", "ENVELOPE",
    "unregister", "unregister_serve", "temporary_registration",
    "FaultPlan", "MachineCrash", "RegionPreemption", "LinkDegradation",
    "RegionPartition", "GrayFailure", "MachineFlap",
    "compile_plan", "plan_from_fracs",
    "FleetSimulation", "SimResult", "simulate_single",
    "evaluate_scenario", "evaluate_all", "comparison_table",
    "observed_telemetry", "observed_telemetry_live",
]
