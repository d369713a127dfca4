"""Serve a geo-distributed request stream through the simulated fleet.

1. Generate follow-the-sun request traffic against the paper's Fig. 1
   eight-region fleet and compare the three routing policies (nearest /
   weighted-least-loaded / Hulk-GNN-scored placement) on p50/p95/p99
   latency, goodput and SLO violations.
2. Watch a regional burst in detail: where the queue builds per policy.
3. Kill a loaded replica mid-run and watch interrupted requests re-route
   while the autoscaler back-fills capacity (cold-start weight transfer
   included).

    PYTHONPATH=src python -m repro_torch.examples.serve_fleet [--device cpu]
"""
import argparse

from repro_torch import _device
from repro_torch.serve import (evaluate_all_serve, run_serve,
                               serve_comparison_table)
from repro_torch.serve.evaluate import serve_gnn
from repro_torch.sim import SERVE_SCENARIOS, get_serve_scenario


def train_gnns(device) -> None:
    """Train the serving GNNs on ``device``: the Hulk policy takes them
    from ``serve_gnn``'s cache, which trains on the card when it misses."""
    for name in sorted(SERVE_SCENARIOS):
        scn = get_serve_scenario(name)
        serve_gnn(scn.model, scn.n_replicas, seed=0, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    device = _device.resolve(args.device)
    train_gnns(device)

    # --- 1. the policy sweep over every serving scenario ------------------
    print("serving scenario sweep (nearest vs least-loaded vs Hulk)...\n")
    results = evaluate_all_serve(seed=0)
    print(serve_comparison_table(results), "\n")
    for name, row in results.items():
        h = row["hulk_vs_nearest"]
        print(f"  {name:<24} hulk vs nearest: p95 "
              f"{h['p95_improvement']:+.1%}, goodput "
              f"{h['goodput_gain']:+.1%}, beats={h['hulk_beats_nearest']}")

    # --- 2. the regional burst under the microscope -----------------------
    scn = get_serve_scenario("serve_regional_burst")
    print(f"\n{scn.name}: {scn.description}")
    for policy in ("nearest", "hulk"):
        res, raw = run_serve(scn, policy, seed=0)
        hot = max(raw["replicas"], key=lambda r: r["busy_s"])
        print(f"  {policy:>13}: replicas {raw['final_replicas']}  "
              f"p99 {res.p99_s:8.1f}s  hottest replica machine "
              f"{hot['machine']} busy {hot['busy_s']:.0f}s "
              f"(mean batch {hot['mean_batch']:.1f})")

    # --- 3. replica failure under load ------------------------------------
    scn = get_serve_scenario("serve_replica_failure")
    print(f"\n{scn.name}: {scn.description}")
    res, raw = run_serve(scn, "hulk", seed=0)
    for e in raw["scale_log"]:
        print(f"  t={e['t']:7.1f}s  {e['event']:<15} machine {e['machine']}")
    print(f"  completed {res.n_completed}/{res.n_requests} "
          f"(rerouted {res.rerouted}), p95 {res.p95_s:.1f}s, "
          f"SLO violations {res.slo_violation_rate:.1%}")


if __name__ == "__main__":
    main()
