"""repro_torch.serve — geo-distributed inference serving on the simulated
fleet (port of ``repro/serve``).

* ``serve.costs``      — per-token prefill/decode cost cards
  (``serve_model_from_task``, ``serve_model_from_hlo``, ``serve_task_for``;
  ``serve_model_from_config`` raises until the port can price its own
  programs);
* ``serve.traffic``    — deterministic region-weighted diurnal/burst request
  generator with per-model length distributions;
* ``serve.replica``    — continuous-batching replica (admission queue,
  chunked prefill + decode interleave, KV-capacity reservations);
* ``serve.router``     — nearest / weighted-least-loaded / Hulk-GNN-scored
  routing and replica placement via ``core.assign``;
* ``serve.autoscale``  — queue-depth / SLO-driven scale up/down that
  provisions machines through ``runtime.elastic.ElasticRuntime.on_join``;
* ``serve.resilience`` — retry, hedging, circuit breaking and shedding;
* ``serve.evaluate``   — policy comparison on the ``sim.scenarios`` serving
  registry, reporting p50/p95/p99 latency, goodput and SLO-violation rate.

Requests run as events of the discrete-event engine
(``sim.workload.ServeExecutor``). Numpy copies of the reference, so a run
gives the reference's records; the Hulk policy's GNN runs where its params
lie.

This package root is deliberately import-time-free (PEP 562 lazy exports):
``sim.scenarios`` registers the serving scenarios at import and pulls
``serve.costs`` / ``serve.traffic`` / ``serve.autoscale`` while
``repro_torch.sim`` itself is still initializing — an eager
``from repro_torch.serve.replica import ...`` here would re-enter the
half-built ``repro_torch.sim`` package.
"""
import importlib

_EXPORTS = {
    "ServeModel": "costs", "serve_model_from_task": "costs",
    "serve_model_from_hlo": "costs", "serve_model_from_config": "costs",
    "serve_task_for": "costs",
    "ModelMix": "traffic", "TrafficConfig": "traffic", "Request": "traffic",
    "generate": "traffic", "region_rate": "traffic", "trace_stats": "traffic",
    "Replica": "replica", "Seq": "replica",
    "Router": "router", "POLICIES": "router", "StaticPlacement": "router",
    "HulkPlacement": "router", "entry_node": "router",
    "Autoscaler": "autoscale", "AutoscaleConfig": "autoscale",
    "RetryPolicy": "resilience", "HedgePolicy": "resilience",
    "BreakerPolicy": "resilience", "ShedPolicy": "resilience",
    "ResilienceConfig": "resilience", "CircuitBreaker": "resilience",
    "ServeResult": "evaluate", "run_serve": "evaluate",
    "summarize": "evaluate", "evaluate_serve_scenario": "evaluate",
    "evaluate_all_serve": "evaluate", "serve_comparison_table": "evaluate",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    try:
        submodule = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    mod = importlib.import_module(f"{__name__}.{submodule}")
    value = getattr(mod, name)
    globals()[name] = value      # cache: next access skips __getattr__
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
