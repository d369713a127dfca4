"""Score routing policies on serving scenarios.

``run_serve`` drives one policy through one ``ServeScenario`` with the
discrete-event ``sim.workload.ServeExecutor``; ``summarize`` turns the raw
request records into the latency/goodput/SLO metrics the benchmark emits;
``evaluate_serve_scenario`` compares ``nearest`` / ``least_loaded`` /
``hulk`` on identical traffic (same seed, same trace) and reports the Hulk
improvement over the nearest-healthy baseline.

Port of ``repro/serve/evaluate.py``; the Hulk arm's GNN is trained on CUDA
unless ``serve_gnn`` is asked for another device or its cache is seeded.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np

from repro_torch.serve import traffic as traffic_mod
from repro_torch.serve.costs import serve_task_for
from repro_torch.sim import scenarios as sc
from repro_torch.sim.workload import ServeExecutor


@dataclasses.dataclass
class ServeResult:
    policy: str
    n_requests: int
    n_completed: int
    n_dropped: int
    n_incomplete: int
    p50_s: float
    p95_s: float
    p99_s: float
    mean_latency_s: float
    goodput_rps: float          # completions within SLO per second of trace
    slo_violation_rate: float   # 1 - within-SLO completions / all requests
    throughput_tps: float       # generated tokens per second of trace
    rerouted: int
    n_events: int
    bytes_moved: float
    scale_events: int
    final_replicas: list[int]
    replicas: list[dict]
    # why requests were dropped: reason -> count (max_routes | unreachable |
    # deadline | retry_budget)
    drops_by_reason: dict = dataclasses.field(default_factory=dict)
    retries: int = 0            # timeout-driven re-dispatches (resilient path)
    hedges: int = 0             # speculative extra attempts launched
    metrics: dict = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("replicas")
        return d


def summarize(raw: dict, slo_s: float) -> ServeResult:
    records = list(raw["records"].values())
    horizon = max(raw["horizon_s"], 1e-9)
    lats = np.array([r.latency_s for r in records
                     if r.latency_s is not None], float)
    n_completed = int(lats.size)
    n_dropped = sum(1 for r in records if r.dropped)
    n_incomplete = len(records) - n_completed - n_dropped
    within = int((lats <= slo_s).sum()) if n_completed else 0
    gen_tokens = sum(r.req.gen_tokens for r in records
                     if r.latency_s is not None)
    pct = (lambda q: float(np.percentile(lats, q))) if n_completed \
        else (lambda q: math.inf)
    drops_by_reason: dict = {}
    for r in records:
        if r.dropped:
            reason = r.drop_reason or "unknown"
            drops_by_reason[reason] = drops_by_reason.get(reason, 0) + 1
    return ServeResult(
        policy=raw["policy"],
        n_requests=len(records),
        n_completed=n_completed,
        n_dropped=n_dropped,
        n_incomplete=n_incomplete,
        p50_s=pct(50), p95_s=pct(95), p99_s=pct(99),
        mean_latency_s=float(lats.mean()) if n_completed else math.inf,
        goodput_rps=within / horizon,
        slo_violation_rate=(1.0 - within / max(len(records), 1)),
        throughput_tps=gen_tokens / horizon,
        rerouted=sum(1 for r in records if r.n_routes > 1),
        n_events=raw["n_events"],
        bytes_moved=raw["bytes_moved"],
        scale_events=len(raw["scale_log"]),
        final_replicas=raw["final_replicas"],
        replicas=raw["replicas"],
        drops_by_reason=drops_by_reason,
        retries=sum(r.retries for r in records),
        hedges=sum(r.hedges for r in records),
        metrics=dict(raw.get("metrics", {})))


def serve_gnn(model, n_replicas: int, seed: int = 0, device=None):
    """Train (and cache) the placement GNN for a serve pseudo-task via the
    same harness the training scenarios use, on ``device`` (CUDA by
    default; see ``sim.evaluate.trained_gnn``)."""
    from repro_torch.sim.evaluate import trained_gnn
    return trained_gnn([serve_task_for(model, n_replicas)], seed=seed,
                       device=device)


def run_serve(scenario: sc.ServeScenario, policy: str, seed: int = 0,
              trace: Optional[list] = None, data_plane: str = "fast",
              obs=None) -> tuple[ServeResult, dict]:
    graph = scenario.fleet(seed)
    if trace is None:
        trace = traffic_mod.generate(scenario.traffic(graph), seed=seed)
    params = cfg = None
    if policy == "hulk":
        params, cfg = serve_gnn(scenario.model, scenario.n_replicas, seed=0)
    raw = ServeExecutor(
        graph, scenario.model, trace, policy, params=params, cfg=cfg,
        comm_model=scenario.comm_model, jitter=scenario.jitter,
        n_replicas=scenario.n_replicas, max_batch=scenario.max_batch,
        prefill_chunk=scenario.prefill_chunk,
        autoscale=scenario.autoscale, spares=scenario.spares,
        fault_fracs=scenario.fault_fracs,
        kills_per_fault=scenario.kills_per_fault,
        fault_plan=scenario.fault_plan, resilience=scenario.resilience,
        max_routes=scenario.max_routes, data_plane=data_plane,
        seed=seed, obs=obs).run()
    return summarize(raw, scenario.slo_s), raw


def evaluate_serve_scenario(scenario: sc.ServeScenario, seed: int = 0,
                            policies: Sequence[str] = ("nearest",
                                                       "least_loaded",
                                                       "hulk")) -> dict:
    """All policies against the identical request trace. Returns
    {policy: metrics} plus Hulk's improvement vs nearest-healthy."""
    graph = scenario.fleet(seed)
    trace = traffic_mod.generate(scenario.traffic(graph), seed=seed)
    row: dict = {"scenario": scenario.name, "slo_s": scenario.slo_s,
                 "n_requests": len(trace)}
    for policy in policies:
        res, _ = run_serve(scenario, policy, seed=seed, trace=trace)
        row[policy] = res.as_dict()
    if "hulk" in row and "nearest" in row:
        base, hulk = row["nearest"], row["hulk"]
        row["hulk_vs_nearest"] = {
            "p95_improvement": _rel_gain(base["p95_s"], hulk["p95_s"]),
            "goodput_gain": _rel_gain(hulk["goodput_rps"],
                                      base["goodput_rps"], inverse=True),
            "slo_violation_delta": (base["slo_violation_rate"]
                                    - hulk["slo_violation_rate"]),
            "hulk_beats_nearest": _beats(hulk, base),
        }
    return row


def _rel_gain(base: float, new: float, inverse: bool = False) -> float:
    """(base - new)/base for lower-is-better; for inverse the args are
    (new, base) and the gain is (new - base)/base."""
    if inverse:
        new, base = base, new
        if not math.isfinite(base) or base <= 0:
            return math.nan
        return (new - base) / base
    if not math.isfinite(base) or base <= 0:
        return math.nan
    return (base - new) / base


def _beats(hulk: dict, base: dict) -> bool:
    """Hulk 'beats' the baseline when it violates the SLO no more often and
    strictly improves at least one headline metric (goodput or p95)."""
    no_worse = hulk["slo_violation_rate"] <= base["slo_violation_rate"] + 1e-9
    better = (hulk["goodput_rps"] > base["goodput_rps"] + 1e-9
              or hulk["p95_s"] < base["p95_s"] - 1e-9)
    return bool(no_worse and better)


def evaluate_all_serve(seed: int = 0,
                       names: Optional[Sequence[str]] = None
                       ) -> dict[str, dict]:
    names = list(names) if names is not None else sorted(sc.SERVE_SCENARIOS)
    return {n: evaluate_serve_scenario(sc.get_serve_scenario(n), seed=seed)
            for n in names}


def serve_comparison_table(results: dict[str, dict]) -> str:
    """scenario x policy p95 / goodput / violation-rate table."""
    policies = ["nearest", "least_loaded", "hulk"]
    head = f"{'scenario':<24}" + "".join(f"{p:>26}" for p in policies)
    lines = [head, f"{'':<24}" + "   p95_s  good_rps  viol" * len(policies),
             "-" * len(head)]
    for name, row in results.items():
        cells = ""
        for p in policies:
            m = row.get(p)
            if m is None:
                cells += f"{'-':>26}"
                continue
            p95 = f"{m['p95_s']:8.1f}" if math.isfinite(m["p95_s"]) \
                else f"{'inf':>8}"
            cells += (f"{p95}{m['goodput_rps']:10.3f}"
                      f"{m['slo_violation_rate']:6.1%}  ")
        lines.append(f"{name:<24}{cells}")
    return "\n".join(lines)
