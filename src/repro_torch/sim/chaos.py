"""Chaos fuzzer: random fault plans vs the robustness invariants.

``random_fault_plan`` draws a random ``sim.faults.FaultPlan`` (crashes with
and without recovery, preemption waves, link degradations, partitions that
always heal before the horizon, gray slowdowns, flapping machines) from a
counter-based rng, and ``fuzz`` drives the serving executor under each plan
checking the invariants the chaos layer promises (docs/ROBUSTNESS.md):

1. **determinism** — same seed + plan => byte-identical canonical record
   dump across two independent runs;
2. **exactly-once resolution** — every offered request completes or drops
   exactly once, drops carry a recorded reason, and the obs counters agree
   with the records (``serve.completed``, ``serve.dropped``,
   ``serve.dropped.<reason>``);
3. **plane equivalence** — the fast data plane produces the same records
   as the reference plane, faults and all;
4. **liveness** — ``run()`` returns on every seed: no fault sequence may
   deadlock the engine or strand a request unresolved forever (unresolved
   at horizon is allowed only for requests still making progress, i.e.
   attempts live at cutoff).

Both the naive and the resilient (retry + hedge + breaker) serving paths
are fuzzed. CLI:

    python -m repro_torch.sim.chaos --seeds 25

Port of ``repro/sim/chaos.py``: numpy copies, so every case gives the
reference's records; ``fuzz_controller``'s Hulk placements run the GNN where
``trained_gnn``'s params lie.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import numpy as np

from repro_torch.core.graph import paper_fig1_graph
from repro_torch.sim import faults as faults_mod
from repro_torch.sim.workload import ServeExecutor

CHAOS_STREAM = 0xC4A0

_HORIZON_S = 60.0
_RATE_RPS = 3.0


# ---------------------------------------------------------------------------
# Random plan generation
# ---------------------------------------------------------------------------
def random_fault_plan(seed: int, graph, max_injectors: int = 4
                      ) -> faults_mod.FaultPlan:
    """A random plan against ``graph``: 1..max_injectors injectors, every
    window healing before the horizon so the fleet always gets a chance to
    recover (partitions that persist to the end are a scenario choice, not
    fuzzer noise)."""
    rng = np.random.default_rng((seed, CHAOS_STREAM))
    regions = sorted({m.region for m in graph.machines})
    injectors = []
    for _ in range(int(rng.integers(1, max_injectors + 1))):
        at = float(rng.uniform(0.1, 0.6))
        dur = float(rng.uniform(0.05, min(0.3, 0.9 - at)))
        kind = int(rng.integers(0, 6))
        if kind == 0:
            rec = dur if rng.random() < 0.5 else None
            injectors.append(faults_mod.MachineCrash(
                at=at, kills=int(rng.integers(1, 3)), recover_after=rec))
        elif kind == 1:
            region = regions[int(rng.integers(0, len(regions)))]
            injectors.append(faults_mod.RegionPreemption(
                at=at, region=region, frac=float(rng.uniform(0.5, 1.0)),
                recover_after=dur))
        elif kind == 2:
            a, b = rng.choice(len(regions), size=2, replace=False)
            injectors.append(faults_mod.LinkDegradation(
                at=at, duration=dur, regions=(regions[a], regions[b]),
                bw_factor=float(rng.uniform(0.1, 0.6)),
                lat_factor=float(rng.uniform(1.5, 5.0))))
        elif kind == 3:
            region = regions[int(rng.integers(0, len(regions)))]
            injectors.append(faults_mod.RegionPartition(
                at=at, duration=dur, regions=(region,)))
        elif kind == 4:
            injectors.append(faults_mod.GrayFailure(
                at=at, picks=int(rng.integers(1, 3)),
                slowdown=float(rng.uniform(2.0, 6.0)),
                ramp=float(rng.uniform(0.0, 0.1)), duration=dur))
        else:
            injectors.append(faults_mod.MachineFlap(
                at=at, down=0.02, up=0.04, cycles=int(rng.integers(1, 3))))
    return faults_mod.FaultPlan(tuple(injectors))


# ---------------------------------------------------------------------------
# One fuzz case
# ---------------------------------------------------------------------------
def _chaos_model():
    from repro_torch.core import cost_model as cm
    from repro_torch.serve.costs import serve_model_from_task
    task = cm.ModelTask("Chat-34B", 34e9, 60, 7168)
    return serve_model_from_task(task, name="chat-34b",
                                 decode_efficiency=0.01)


def _chaos_trace(graph, seed: int):
    from repro_torch.serve.traffic import ModelMix, TrafficConfig, generate
    regions = tuple(sorted({m.region for m in graph.machines}))
    cfg = TrafficConfig(
        rate_rps=_RATE_RPS, horizon_s=_HORIZON_S, regions=regions,
        mixes=(ModelMix("chat-34b", prompt_median=96.0, gen_median=32.0),))
    return generate(cfg, seed=seed)


def run_case(seed: int, plan: faults_mod.FaultPlan,
             data_plane: str = "fast", resilient: bool = False,
             obs=None) -> dict:
    """One executor run under ``plan``; returns the raw run dict."""
    from repro_torch.serve.resilience import ResilienceConfig
    graph = paper_fig1_graph(seed)
    trace = _chaos_trace(graph, seed)
    res = ResilienceConfig.default() if resilient else None
    return ServeExecutor(graph, _chaos_model(), trace, "least_loaded",
                         n_replicas=3, fault_plan=plan, resilience=res,
                         data_plane=data_plane, seed=seed, obs=obs).run()


def canonical_records(raw: dict) -> str:
    """The byte-comparable projection of a run: every per-request outcome
    the chaos layer is accountable for, in rid order."""
    rows = []
    for rid in sorted(raw["records"]):
        r = raw["records"][rid]
        rows.append({
            "rid": rid, "t_arrival": r.req.t_arrival,
            "t_complete": r.t_complete, "latency_s": r.latency_s,
            "dropped": r.dropped, "drop_reason": r.drop_reason,
            "n_routes": r.n_routes, "machines": list(r.machines),
            "retries": r.retries, "hedges": r.hedges,
        })
    return json.dumps(rows, sort_keys=True)


def check_invariants(raw: dict, rec=None) -> dict:
    """Exactly-once resolution + counter consistency for one run. Returns
    summary counts; raises AssertionError on any violation."""
    completed = dropped = unresolved = 0
    reasons: dict[str, int] = {}
    for rid, r in raw["records"].items():
        is_done = r.t_complete is not None
        assert not (is_done and r.dropped), \
            f"rid {rid} both completed and dropped"
        if is_done:
            completed += 1
            assert r.latency_s is not None and r.latency_s >= 0.0, rid
            assert r.drop_reason is None, rid
        elif r.dropped:
            dropped += 1
            assert r.drop_reason, f"rid {rid} dropped without a reason"
            reasons[r.drop_reason] = reasons.get(r.drop_reason, 0) + 1
        else:
            unresolved += 1
    assert completed + dropped + unresolved == len(raw["records"])
    if rec is not None and rec.enabled:
        c = rec.metrics.snapshot()["counters"]
        assert c.get("serve.requests", 0) == len(raw["records"])
        assert c.get("serve.completed", 0) == completed
        assert c.get("serve.dropped", 0) == dropped
        for reason, n in reasons.items():
            assert c.get(f"serve.dropped.{reason}", 0) == n, reason
    return {"offered": len(raw["records"]), "completed": completed,
            "dropped": dropped, "unresolved": unresolved,
            "reasons": reasons}


def fuzz_one(seed: int, check_planes: bool = True) -> dict:
    """All invariants for one seed, over both serving paths."""
    from repro_torch import obs as obs_mod
    graph = paper_fig1_graph(seed)
    plan = random_fault_plan(seed, graph)
    out: dict = {"seed": seed,
                 "injectors": [type(i).__name__ for i in plan.injectors]}
    for resilient in (False, True):
        tag = "resilient" if resilient else "naive"
        rec = obs_mod.Recorder()
        raw = run_case(seed, plan, "fast", resilient, obs=rec)
        dump = canonical_records(raw)
        out[tag] = check_invariants(raw, rec)
        # determinism: an independent second run must replay byte-identically
        again = canonical_records(run_case(seed, plan, "fast", resilient))
        assert dump == again, f"seed {seed} {tag}: non-deterministic replay"
        if check_planes:
            ref = canonical_records(run_case(seed, plan, "reference",
                                             resilient))
            assert dump == ref, f"seed {seed} {tag}: fast != reference"
    return out


# ---------------------------------------------------------------------------
# Controller invariants (online re-planning): the guarded live controller
# must never cost correctness, only makespan. Invariants:
#
# 1. **determinism** — a controller-enabled run replays byte-identically
#    (canonical fleet record + the controller's full decision log);
# 2. **no commit over a propagating commit** — every committed replan saw
#    ``migrations_in_flight == 0`` (the "migrating" suppression actually
#    suppresses);
# 3. **rollback exactness** — a forced-rollback drill (probation tuned to
#    always regress) restores the exact last-good assignment, byte for byte;
# 4. **controller-off identity** — ``controller=None`` produces the same
#    canonical record as a host constructed without the argument at all, and
#    emits zero controller metrics (the pre-controller trace is untouched).
# ---------------------------------------------------------------------------
def canonical_fleet(res, controller=None) -> str:
    """Byte-comparable projection of a fleet run (+ controller decisions)."""
    rows = {
        "makespan": float(res.makespan),
        "per_task": {n: {"step_times": [float(t) for t in d["step_times"]],
                         "finish_s": float(d["finish_s"])
                         if d["finish_s"] is not None else None,
                         "failed": bool(d["failed"])}
                     for n, d in sorted(res.per_task.items())},
        # fault_fracs-driven kills/rejoins log no "reason" — carry whichever
        # identifying key the entry has so every replan shape canonicalizes
        "replans": [{"at_s": float(r["at_s"]),
                     "reason": r.get("reason",
                                     "killed" if "killed" in r
                                     else "rejoined")}
                    for r in res.replans],
    }
    if controller is not None:
        rows["log"] = json.loads(json.dumps(controller.summary()["log"],
                                            default=float))
    return json.dumps(rows, sort_keys=True)


def _drift_run(name: str, mode: str, seed: int = 0, controller_cfg=None,
               obs=None):
    """One drift-scenario run; ``controller_cfg`` overrides the scenario's
    guarded config (the rollback drill swaps in a hair-trigger probation)."""
    import dataclasses

    from repro_torch.sim import scenarios as sc
    from repro_torch.sim.evaluate import run_drift_scenario
    scn = sc.get_drift_scenario(name)
    if controller_cfg is not None:
        scn = dataclasses.replace(scn, controller=controller_cfg)
    return run_drift_scenario(scn, mode=mode, seed=seed, obs=obs)


def fuzz_controller(seed: int = 0, log=print) -> dict:
    """Run the controller invariant suite over every registered drift
    scenario; raises AssertionError on any violation."""
    import dataclasses

    from repro_torch import obs as obs_mod
    from repro_torch.sim import scenarios as sc
    from repro_torch.sim.evaluate import FleetSimulation
    cases = []
    for name in sorted(sc.DRIFT_SCENARIOS):
        for mode in ("guarded", "unguarded"):
            res, ctl = _drift_run(name, mode, seed)
            assert not ctl.dead and ctl.summary()["errors"] == 0, (name, mode)
            # 2: a commit must never land while migrations are in flight
            for e in ctl.log:
                if e["action"] == "commit":
                    assert e["migrating_at_commit"] == 0, (name, mode, e)
            # 1: independent second run replays byte-identically
            dump = canonical_fleet(res, ctl)
            res2, ctl2 = _drift_run(name, mode, seed)
            assert dump == canonical_fleet(res2, ctl2), \
                f"{name}/{mode}: non-deterministic controller replay"
            cases.append({"scenario": name, "mode": mode,
                          "replans": ctl.summary()["replans"],
                          "rollbacks": ctl.summary()["rollbacks"]})
            log(f"controller {name}/{mode}: "
                f"{ctl.summary()['replans']} replans, deterministic OK")

        # 4: controller=None is byte-identical to a host built without the
        # argument, and emits no controller/slowdown metrics
        res_off, _ = _drift_run(name, "static", seed)
        scn = sc.get_drift_scenario(name)
        graph = scn.fleet(seed)
        from repro_torch.sim.evaluate import HulkPlacer, trained_gnn
        from repro_torch.sim.evaluate import observed_telemetry
        params, cfg = trained_gnn(list(scn.tasks), seed=0,
                                  label_mode=scn.label_mode,
                                  jitter=scn.jitter, traffic=scn.traffic,
                                  comm_model=scn.comm_model)
        if scn.label_mode == "sim":
            graph = graph.with_telemetry(observed_telemetry(
                graph, jitter=scn.jitter, seed=seed,
                comm_model=scn.comm_model))
        rec = obs_mod.Recorder()
        placer = HulkPlacer(list(scn.tasks), params, cfg,
                            comm_model=scn.comm_model,
                            sim_refine=(scn.label_mode == "sim"),
                            jitter=scn.jitter, traffic=scn.traffic, seed=seed)
        res_legacy = FleetSimulation(
            graph, list(scn.tasks), placer, comm_model=scn.comm_model,
            jitter=scn.jitter, traffic=scn.traffic,
            fault_plan=scn.fault_plan, steps=scn.steps, seed=seed,
            concurrent=True, obs=rec).run()
        assert canonical_fleet(res_off) == canonical_fleet(res_legacy), \
            f"{name}: controller=None differs from the pre-controller host"
        counters = rec.metrics.snapshot()["counters"]
        stray = [k for k in counters
                 if k.startswith("controller.")
                 or k.startswith("replica.slowdown.")]
        assert not stray, f"{name}: controller-off run emitted {stray}"
        log(f"controller {name}/static: identical to pre-controller host OK")

    # 3: forced-rollback drill — probation that always regresses must
    # restore the exact last-good assignment
    base = sc.get_drift_scenario("drift_gray_creep").controller
    drill = dataclasses.replace(base, probation_s=20.0,
                                probation_regress=-0.95)
    res, ctl = _drift_run("drift_gray_creep", "guarded", seed,
                          controller_cfg=drill)
    s = ctl.summary()
    assert s["errors"] == 0, s["log"]
    assert s["rollbacks"] >= 1, \
        f"rollback drill produced no rollback: {s['log']}"
    for e in ctl.log:
        if e["action"] == "rollback":
            assert e["restored"] == e["last_good"], e
    cases.append({"scenario": "drift_gray_creep", "mode": "rollback_drill",
                  "replans": s["replans"], "rollbacks": s["rollbacks"]})
    log(f"controller rollback drill: {s['rollbacks']} rollback(s) restored "
        f"last-good exactly OK")
    return {"seed": seed, "violations": 0, "cases": cases}


def fuzz(n_seeds: int = 25, base_seed: int = 0,
         check_planes: bool = True, log=print) -> dict:
    results = []
    for k in range(n_seeds):
        r = fuzz_one(base_seed + k, check_planes=check_planes)
        log(f"seed {r['seed']:3d}: {'+'.join(r['injectors']):<60} "
            f"naive {r['naive']['completed']}/{r['naive']['offered']} "
            f"resilient {r['resilient']['completed']}"
            f"/{r['resilient']['offered']} OK")
        results.append(r)
    return {"n_seeds": n_seeds, "base_seed": base_seed,
            "violations": 0, "cases": results}


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=25,
                    help="number of random fault plans to fuzz")
    ap.add_argument("--base-seed", type=int, default=0)
    ap.add_argument("--skip-planes", action="store_true",
                    help="skip the fast-vs-reference plane equivalence runs")
    ap.add_argument("--controller", action="store_true",
                    help="also run the online re-planning controller "
                         "invariant suite over the drift scenarios")
    ap.add_argument("--out", default=None,
                    help="write the JSON summary here")
    args = ap.parse_args(argv)
    summary = fuzz(args.seeds, base_seed=args.base_seed,
                   check_planes=not args.skip_planes,
                   log=lambda s: print(s, file=sys.stderr))
    if args.controller:
        summary["controller"] = fuzz_controller(
            seed=args.base_seed, log=lambda s: print(s, file=sys.stderr))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1, default=float)
    extra = (f" + controller suite ({len(summary['controller']['cases'])} "
             f"cases)" if args.controller else "")
    print(f"chaos fuzz PASS: {args.seeds} seeds, 0 invariant "
          f"violations{extra}")


if __name__ == "__main__":
    main()
