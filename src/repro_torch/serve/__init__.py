"""repro_torch.serve — geo-distributed inference serving on the simulated
fleet (port of ``repro/serve``, its inputs so far).

Ported:

* ``serve.costs``     — per-token prefill/decode cost cards
  (``serve_model_from_task``, ``serve_model_from_hlo``, ``serve_task_for``;
  ``serve_model_from_config`` raises until the port can price its own
  programs);
* ``serve.traffic``   — deterministic region-weighted diurnal/burst request
  generator with per-model length distributions;
* ``serve.autoscale`` — queue-depth / SLO-driven scale up/down decisions.

These are what ``sim.scenarios`` needs to register the serving and colocated
scenarios. Not ported yet, so not exported: the continuous-batching replica
(``serve.replica``), the router (``serve.router``), the resilience policies
(``serve.resilience``) and the policy comparison (``serve.evaluate``), which
come with ``sim.workload.ServeExecutor``.

This package root is deliberately import-time-free (PEP 562 lazy exports):
``sim.scenarios`` registers the serving scenarios at import and pulls
``serve.costs`` / ``serve.traffic`` / ``serve.autoscale`` while
``repro_torch.sim`` itself is still initializing.
"""
import importlib

_EXPORTS = {
    "ServeModel": "costs", "serve_model_from_task": "costs",
    "serve_model_from_hlo": "costs", "serve_model_from_config": "costs",
    "serve_task_for": "costs",
    "ModelMix": "traffic", "TrafficConfig": "traffic", "Request": "traffic",
    "generate": "traffic", "region_rate": "traffic", "trace_stats": "traffic",
    "Autoscaler": "autoscale", "AutoscaleConfig": "autoscale",
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
