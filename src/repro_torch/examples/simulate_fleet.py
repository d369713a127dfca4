"""Stress-test placements in the discrete-event geo-fleet simulator.

1. Train the Hulk placement GNN, then score Hulk vs Systems A/B/C across the
   whole scenario registry (contention, diurnal traffic, stragglers,
   preemption storms, blocked links).
2. Close the simulator-feedback loop on straggler_heavy: re-score Hulk with
   sim-refined labels + telemetry features (label_mode="sim") and watch the
   analytic-label loss to System B flip.
3. Watch one preemption storm in detail: each machine loss triggers an
   elastic re-plan (runtime.elastic) and the interrupted steps restart on the
   new placement.
4. Bridge to the production mesh: simulate the schedule that
   core.placement.plan_runtime picks for a 4-pod fleet.

    PYTHONPATH=src python -m repro_torch.examples.simulate_fleet [--device cpu]
"""
import argparse

import numpy as np

from repro_torch import _device
from repro_torch.core import cost_model as cm, placement
from repro_torch.core.graph import random_fleet
from repro_torch.sim import (SCENARIOS, comparison_table, evaluate_all,
                             evaluate_scenario, get_scenario,
                             simulate_single)
from repro_torch.sim.evaluate import FleetSimulation, HulkPlacer, trained_gnn
from repro_torch.sim.scenarios import SIM_TASKS


def train_gnns(device) -> None:
    """Train the GNNs the evaluation places with on ``device``:
    ``evaluate_all`` and ``evaluate_scenario`` take theirs from
    ``trained_gnn``'s cache, which trains on the card when it misses."""
    for name in sorted(SCENARIOS):
        trained_gnn(list(get_scenario(name).tasks), seed=0, device=device)
    scn = get_scenario("straggler_heavy")
    trained_gnn(list(scn.tasks), seed=0, label_mode="sim", jitter=scn.jitter,
                traffic=scn.traffic, comm_model=scn.comm_model, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    device = _device.resolve(args.device)
    train_gnns(device)

    # --- 1. the full scenario sweep --------------------------------------
    print("simulating all scenarios (Hulk vs Systems A/B/C)...\n")
    results = evaluate_all(seed=0)
    print(comparison_table(results), "\n")

    # --- 2. simulator-in-the-loop labels on straggler_heavy --------------
    # analytic labels price machines at catalog TFLOP/s, so Hulk loses to
    # System B here; sim-refined labels + telemetry features evict the 3x
    # stragglers from the pipeline groups and flip the scenario.
    scn = get_scenario("straggler_heavy")
    sim_row = evaluate_scenario(scn, seed=0, label_mode="sim")
    print("straggler_heavy with sim-refined labels (label_mode='sim'):")
    print(f"  Hulk analytic: {results['straggler_heavy']['Hulk']['makespan_s']:8.1f}s")
    print(f"  Hulk sim:      {sim_row['Hulk']['makespan_s']:8.1f}s")
    print(f"  System B:      {sim_row['SystemB']['makespan_s']:8.1f}s\n")

    # --- 3. a preemption storm under the microscope ----------------------
    tasks = list(SIM_TASKS)
    params, cfg = trained_gnn(tasks, seed=0, device=device)
    fleet = random_fleet(12, seed=2)
    placer = HulkPlacer(tasks, params, cfg)
    res = FleetSimulation(fleet, tasks, placer, steps=2,
                          fault_fracs=(0.35, 0.7), kills_per_fault=2,
                          seed=0, concurrent=True).run()
    print("preemption storm on a 12-machine fleet:")
    for r in res.replans:
        print(f"  t={r['at_s']:8.1f}s  machines {r['killed']} preempted "
              f"-> elastic re-plan")
    for name, d in res.per_task.items():
        steps = ", ".join(f"{t:.1f}" for t in d["step_times"])
        print(f"  {name:<10} step times [{steps}]s  finished at "
              f"{d['finish_s']:.1f}s" if not d["failed"] else
              f"  {name:<10} FAILED (no feasible placement left)")
    print(f"  makespan: {res.makespan:.1f}s "
          f"({len(res.replans)} re-plans, {res.n_events} events)\n")

    # --- 4. the production pod mesh --------------------------------------
    pods = [placement.PodSpec(f"pod{i}", r) for i, r in
            enumerate(["California", "Tokyo", "London", "California"])]
    lat = np.array([[0.0, 118.8, 132.3, 1.0],
                    [118.8, 0.0, 173.8, 118.8],
                    [132.3, 173.8, 0.0, 132.3],
                    [1.0, 118.8, 132.3, 0.0]], np.float32)
    pg = placement.pods_as_graph(pods, lat)
    groups = {"OPT-175B": [0, 3], "T5-11B": [1, 2]}
    plans = placement.plan_runtime(pg, groups, [cm.OPT_175B, cm.T5_11B])
    print("pod-level schedule from core.placement.plan_runtime:")
    for p in plans:
        task = cm.OPT_175B if p.task == "OPT-175B" else cm.T5_11B
        strategy = "gpipe" if p.pod_axis_strategy == "pipeline" else "dp"
        r = simulate_single(pg, p.pods, task, strategy, steps=1,
                            order=p.stage_order)
        print(f"  {p.task}: pods {p.pods} strategy={p.pod_axis_strategy} "
              f"-> simulated step {r.mean_step_s(p.task):.1f}s "
              f"(comm {r.comm_s:.1f}s, compute {r.compute_s:.1f}s)")


if __name__ == "__main__":
    main()
