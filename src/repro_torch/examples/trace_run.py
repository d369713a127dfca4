"""Record a flight-recorder trace of one scenario and export it for Perfetto.

Runs a serving or training scenario with the ``repro_torch.obs`` recorder
enabled, writes a Chrome-trace/Perfetto JSON next to the chosen output path,
validates it against ``repro_torch.obs.schema``, and prints the
human-readable lane/metrics report. Load the ``.trace.json`` at
https://ui.perfetto.dev (or ``chrome://tracing``): every machine, replica,
and engine stream renders as its own lane, with request lifecycle spans
(queued -> prefill -> decode) and end-to-end request spans on the
``requests`` lane.

    PYTHONPATH=src python -m repro_torch.examples.trace_run [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.trace_run \
        --scenario serve_diurnal --policy least_loaded --out diurnal.trace.json
    PYTHONPATH=src python -m repro_torch.examples.trace_run \
        --scenario straggler_heavy
    PYTHONPATH=src python -m repro_torch.examples.trace_run \
        --scenario drift_gray_creep --mode guarded   # controller lane

``--check-determinism`` runs the scenario twice and asserts the two trace
files are byte-identical.
"""
import argparse

from repro_torch import _device, obs
from repro_torch.obs import report, schema


def record_serve(name: str, policy: str, seed: int,
                 time_scale: float, max_events):
    from repro_torch.serve.evaluate import run_serve
    from repro_torch.sim import scenarios as sc

    scn = sc.get_serve_scenario(name)
    if time_scale != 1.0:
        import dataclasses
        base = scn.traffic

        def traffic(graph):
            cfg = base(graph)
            h = cfg.horizon_s * time_scale
            w = cfg.burst_window
            if w is not None:
                w = (w[0] * time_scale, w[1] * time_scale)
            return dataclasses.replace(cfg, horizon_s=h, burst_window=w)
        scn = dataclasses.replace(scn, traffic=traffic)
    rec = obs.Recorder(max_events=max_events)
    with obs.recording(rec):
        res, _ = run_serve(scn, policy, seed=seed, obs=rec)
    summary = (f"{res.n_completed}/{res.n_requests} completed, "
               f"p95 {res.p95_s:.1f}s, {res.n_dropped} dropped")
    return rec, summary


def record_train(name: str, seed: int, max_events):
    from repro_torch.sim import scenarios as sc
    from repro_torch.sim.evaluate import FleetSimulation, FullFleetPlacer

    scn = sc.get_scenario(name)
    graph = scn.fleet(seed)
    tasks = list(scn.tasks)
    rec = obs.Recorder(max_events=max_events)
    # System B (full-fleet pipeline) placement: no GNN training in the loop,
    # so the example stays fast; the engine/network/task lanes are identical
    # machinery to what a Hulk run records
    fs = FleetSimulation(graph, tasks, FullFleetPlacer("gpipe", tasks, "B"),
                         comm_model=scn.comm_model, jitter=scn.jitter,
                         traffic=scn.traffic, fault_fracs=scn.fault_fracs,
                         kills_per_fault=scn.kills_per_fault,
                         steps=scn.steps, seed=seed, concurrent=False,
                         obs=rec)
    with obs.recording(rec):
        res = fs.run()
    return rec, f"makespan {res.makespan:.1f}s, {res.n_events} events"


def record_drift(name: str, mode: str, seed: int, max_events):
    from repro_torch.sim import scenarios as sc
    from repro_torch.sim.evaluate import run_drift_scenario

    scn = sc.get_drift_scenario(name)
    rec = obs.Recorder(max_events=max_events)
    with obs.recording(rec):
        res, ctl = run_drift_scenario(scn, mode=mode, seed=seed, obs=rec)
    if ctl is None:
        extra = "controller off"
    else:
        s = ctl.summary()
        extra = (f"{s['alerts']} alerts, {s['replans']} replans, "
                 f"{s['rollbacks']} rollbacks, {s['suppressed']} suppressed, "
                 f"{s['gate_rejects']} gate-rejected")
    return rec, f"{mode}: makespan {res.makespan:.1f}s, {extra}"


def train_gnn_for(args, device) -> None:
    """Train on ``device`` the GNN the chosen run places with, if any: the
    runs take it from ``trained_gnn``'s cache, which trains on the card
    when it misses."""
    from repro_torch.serve.evaluate import serve_gnn
    from repro_torch.sim import scenarios as sc
    from repro_torch.sim.evaluate import trained_gnn

    if args.scenario in sc.SERVE_SCENARIOS and args.policy == "hulk":
        scn = sc.get_serve_scenario(args.scenario)
        serve_gnn(scn.model, scn.n_replicas, seed=0, device=device)
    elif args.scenario in sc.DRIFT_SCENARIOS:
        scn = sc.get_drift_scenario(args.scenario)
        trained_gnn(list(scn.tasks), seed=0, label_mode=scn.label_mode,
                    jitter=scn.jitter, traffic=scn.traffic,
                    comm_model=scn.comm_model, device=device)


def run_once(args):
    from repro_torch.sim import scenarios as sc

    if args.scenario in sc.SERVE_SCENARIOS:
        return record_serve(args.scenario, args.policy, args.seed,
                            args.time_scale, args.max_events)
    if args.scenario in sc.DRIFT_SCENARIOS:
        return record_drift(args.scenario, args.mode, args.seed,
                            args.max_events)
    if args.scenario in sc.SCENARIOS:
        return record_train(args.scenario, args.seed, args.max_events)
    raise SystemExit(f"unknown scenario {args.scenario!r}; serve: "
                     f"{sorted(sc.SERVE_SCENARIOS)}, drift: "
                     f"{sorted(sc.DRIFT_SCENARIOS)}, training: "
                     f"{sorted(sc.SCENARIOS)}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scenario", default="serve_replica_failure",
                    help="a serve_* or training scenario name")
    ap.add_argument("--policy", default="least_loaded",
                    help="routing policy for serve scenarios "
                         "(nearest | least_loaded | hulk)")
    ap.add_argument("--mode", default="guarded",
                    choices=("static", "guarded", "unguarded"),
                    help="re-planning policy for drift_* scenarios")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--time-scale", type=float, default=1.0,
                    help="scale a serve scenario's horizon (0.1 = 10x "
                         "shorter trace, for smoke runs)")
    ap.add_argument("--max-events", type=int, default=None,
                    help="ring-buffer cap on recorded trace events")
    ap.add_argument("--out", default=None,
                    help="output path (default <scenario>.trace.json)")
    ap.add_argument("--check-determinism", action="store_true",
                    help="run twice, assert byte-identical traces")
    ap.add_argument("--report", action="store_true",
                    help="also print the trace analytics (attribution "
                         "buckets + critical path / latency waterfalls)")
    ap.add_argument("--device", default=None,
                    help="torch device of the placement GNN (default: the "
                         "CUDA device)")
    args = ap.parse_args(argv)
    train_gnn_for(args, _device.resolve(args.device))

    out = args.out or f"{args.scenario}.trace.json"
    rec, summary = run_once(args)
    data = rec.trace.json_bytes()
    doc = schema.validate_bytes(data)
    with open(out, "wb") as f:
        f.write(data)

    print(report.render(rec, title=f"{args.scenario} ({summary})"))
    if args.report:
        print()
        print(report.render_trace(doc, title=args.scenario))
    print(f"\nlanes: {', '.join(schema.lanes(doc))}")
    print(f"wrote {out} ({len(data)} bytes, schema OK) — load it at "
          f"https://ui.perfetto.dev")

    if args.check_determinism:
        rec2, _ = run_once(args)
        data2 = rec2.trace.json_bytes()
        if data2 != data:
            raise SystemExit("determinism check FAILED: same-seed runs "
                             "produced different traces")
        print(f"determinism check PASS: two seed={args.seed} runs are "
              f"byte-identical ({len(data)} bytes)")


if __name__ == "__main__":
    main()
