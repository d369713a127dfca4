"""repro_torch.obs — zero-cost-when-disabled tracing + metrics flight recorder.

Port of ``repro/obs``: pure Python, copied verbatim, so that a run gives the
same trace bytes and metric snapshots as the reference. The trace format
keeps its name (``SCHEMA_VERSION = "repro.obs/1"``), so either package
reads and validates the other's traces.

The subsystem has exactly one switch: which ``Recorder`` a component holds.

* ``NULL`` (the default everywhere) has ``enabled = False`` and counted
  no-op trace/metrics sinks. Instrumented hot paths guard every recording
  call with ``if obs.enabled:``, so the disabled path costs one attribute
  read + branch and performs ZERO recorder calls and zero recording
  allocations (asserted in tests/test_obs.py; benchmark-gated by
  ``benchmarks/fleet_bench.py``).
* ``Recorder()`` turns recording on: ``.trace`` is a Chrome-trace/Perfetto
  span recorder on the simulation clock, ``.metrics`` a registry of exact
  integer counters, gauges and fixed-bucket histograms.

Simulation components (``Simulator``, ``NetworkModel``, ``Replica``,
``ServeExecutor``, ``FleetSimulation``) take an ``obs=`` constructor argument.
Planner-side code (``core.train`` / ``core.assign`` / ``core.labels``) has no
simulation context to thread one through, so it reads the *ambient* recorder
via ``current()``; use ``recording(rec)`` (or ``install``) to scope it:

    rec = obs.Recorder(max_events=200_000)
    with obs.recording(rec):
        result = FleetSimulation(graph, tasks, placer, obs=rec).run()
    rec.trace.write("run.trace.json")

See docs/OBSERVABILITY.md for the trace schema, metric names and overhead
guarantees.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Optional

from repro_torch.obs.metrics import (BYTES_BUCKETS, LATENCY_BUCKETS_S,
                                     Histogram, Metrics, NullMetrics,
                                     is_solver_specific, snapshot_diff)
from repro_torch.obs.trace import SCHEMA_VERSION, NullTracer, Span, Tracer

__all__ = [
    "Recorder", "NullRecorder", "NULL", "current", "install", "recording",
    "Tracer", "NullTracer", "Span", "Metrics", "NullMetrics", "Histogram",
    "LATENCY_BUCKETS_S", "BYTES_BUCKETS", "SCHEMA_VERSION",
    "is_solver_specific", "snapshot_diff",
    "Attribution", "attribute", "critical_path", "latency_waterfall",
    "trace_diff", "DriftMonitor", "DriftConfig", "Alert",
]


class Recorder:
    """An enabled trace + metrics sink. One per run."""

    enabled = True

    def __init__(self, max_events: Optional[int] = None):
        self.trace = Tracer(max_events=max_events)
        self.metrics = Metrics()

    def bind_clock(self, clock: Callable[[], float]) -> None:
        """Point the tracer at a simulation clock (the engine calls this)."""
        self.trace.now = clock

    def subscribe(self, fn: Callable) -> None:
        """Stream every metric recording as ``fn(kind, name, value)`` —
        what ``obs.monitors.DriftMonitor.attach`` wires up."""
        self.metrics.subscribe(fn)


class NullRecorder:
    """The disabled sink: ``enabled`` is False and every trace/metrics method
    is a counted no-op — ``calls`` must stay 0 across a guarded hot loop."""

    enabled = False

    def __init__(self) -> None:
        self.trace = NullTracer()
        self.metrics = NullMetrics()

    @property
    def calls(self) -> int:
        return self.trace.calls + self.metrics.calls

    def bind_clock(self, clock: Callable[[], float]) -> None:
        pass


NULL = NullRecorder()

_CURRENT = NULL


def current():
    """The ambient recorder (planner-side code that has no ``obs=`` arg)."""
    return _CURRENT


def install(rec) -> None:
    global _CURRENT
    _CURRENT = rec if rec is not None else NULL


@contextlib.contextmanager
def recording(rec) -> Iterator:
    """Scope ``rec`` as the ambient recorder for the block."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = rec if rec is not None else NULL
    try:
        yield rec
    finally:
        _CURRENT = prev


# Analysis layer (pure functions of exported traces) and streaming monitors.
# Imported last: both depend only on the primitives above, and re-exporting
# them here gives the one-stop ``from repro_torch import obs`` surface the
# examples and benchmarks use.
from repro_torch.obs.analysis import (Attribution, attribute,  # noqa: E402
                                      critical_path, latency_waterfall)
from repro_torch.obs.analysis import diff as trace_diff  # noqa: E402
from repro_torch.obs.monitors import (Alert, DriftConfig,  # noqa: E402
                                      DriftMonitor)
