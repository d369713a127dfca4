"""Streaming drift monitors: windowed aggregates computed online from a run.

The flight recorder's metrics registry is a *final* snapshot; re-planning
mid-run (ROADMAP: "online re-planning under drift") needs the same signals
*while the run is executing*. ``DriftMonitor`` subscribes to an enabled
``Recorder``'s metric stream (``Metrics.subscribe``) and maintains, in sim
time:

* a **rolling p95** over ``serve.latency_s`` observations inside a sliding
  window;
* a per-machine **EWMA slowdown** over ``replica.slowdown.m<id>``
  observations (actual iteration duration / zero-jitter expectation — emitted
  by ``serve.replica`` when recording, so gray failures and stragglers show
  up as a ratio drifting above 1);
* an **SLO burn rate**: the windowed violation fraction (latencies over the
  SLO, plus dropped requests) divided by the error budget, the standard
  burn-rate alerting form.

Crossing a configured threshold produces an ``Alert`` (appended to
``monitor.alerts`` and passed to the ``on_alert`` callback) with a
per-signal cooldown so a sustained excursion alerts once per cooldown
window, not once per request.

Invariants preserved (tests/test_monitors.py):

* **Zero-call-when-disabled** — ``attach`` on a disabled recorder is a no-op
  that subscribes to nothing; the hot paths' ``NullRecorder.calls`` stays 0.
* **Monitoring doesn't perturb** — the monitor only *reads* the metric
  stream; simulation results with and without an attached monitor are
  identical.
* **Determinism** — all state advances on simulation time carried by the
  observations themselves; same-seed runs produce identical alert sequences.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Callable, Optional

LATENCY_METRIC = "serve.latency_s"
SLOWDOWN_PREFIX = "replica.slowdown.m"
DROP_METRIC = "serve.dropped"
# hosts emit one inc per machine that rejoins after a crash/flap; the monitor
# drops that machine's EWMA state so a pre-crash excursion can't mask (or
# fake) post-rejoin drift
REJOIN_PREFIX = "machine.rejoin.m"


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    """Thresholds; a signal with threshold ``None`` is not evaluated."""
    window_s: float = 120.0
    min_samples: int = 5
    cooldown_s: float = 60.0
    # rolling p95 over latency_metric observations in the window
    rolling_p95_threshold_s: Optional[float] = None
    # per-machine EWMA of replica.slowdown.m<id> (1.0 = nominal speed)
    slowdown_threshold: Optional[float] = None
    slowdown_alpha: float = 0.2
    # SLO burn rate: windowed violation fraction / budget (1.0 = burning
    # exactly the budget; alert when sustained above the threshold)
    slo_s: Optional[float] = None
    slo_budget: float = 0.05
    burn_rate_threshold: Optional[float] = None
    # which observe-metric feeds the p95/SLO windows: serve runs emit
    # per-request serve.latency_s, training runs emit per-step sim.step_s
    latency_metric: str = LATENCY_METRIC


@dataclasses.dataclass(frozen=True)
class Alert:
    t: float                  # sim time of the crossing
    kind: str                 # "rolling_p95" | "slowdown" | "slo_burn"
    key: str                  # machine id for slowdown, metric name otherwise
    value: float
    threshold: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class DriftMonitor:
    """Attach with ``monitor.attach(rec)`` *before* the run; read
    ``monitor.alerts`` (or act in ``on_alert``) during/after."""

    def __init__(self, config: Optional[DriftConfig] = None,
                 on_alert: Optional[Callable[[Alert], None]] = None):
        self.config = config or DriftConfig()
        self.on_alert = on_alert
        self.alerts: list[Alert] = []
        self.attached = False
        self._rec = None
        # (t, latency_s) and (t, violated) sliding windows
        self._lat: collections.deque = collections.deque()
        self._slo: collections.deque = collections.deque()
        self._ewma: dict[int, float] = {}
        self._ewma_n: dict[int, int] = {}
        self._last_alert: dict[tuple[str, str], float] = {}

    # -- wiring --------------------------------------------------------------
    def attach(self, recorder) -> "DriftMonitor":
        """Subscribe to the recorder's metric stream. A disabled recorder
        (``obs.NULL``) is left untouched — no subscription, no calls — so
        monitored code keeps the zero-cost-when-disabled guarantee."""
        if not recorder.enabled:
            return self
        self._rec = recorder
        recorder.metrics.subscribe(self._on_metric)
        self.attached = True
        return self

    def _now(self) -> float:
        return self._rec.trace.now()

    # -- stream handling -----------------------------------------------------
    def _on_metric(self, kind: str, name: str, value) -> None:
        cfg = self.config
        if kind == "observe" and name == cfg.latency_metric:
            t = self._now()
            v = float(value)
            self._lat.append((t, v))
            self._check_p95(t)
            if cfg.slo_s is not None:
                self._slo.append((t, 1 if v > cfg.slo_s else 0))
                self._check_burn(t)
        elif kind == "observe" and name.startswith(SLOWDOWN_PREFIX):
            mid = int(name[len(SLOWDOWN_PREFIX):])
            self._bump_ewma(mid, float(value))
        elif kind == "inc" and name.startswith(REJOIN_PREFIX):
            self.reset_machine(int(name[len(REJOIN_PREFIX):]))
        elif kind == "inc" and name == DROP_METRIC and cfg.slo_s is not None:
            t = self._now()
            for _ in range(int(value)):
                self._slo.append((t, 1))   # a dropped request burns budget
            self._check_burn(t)

    def reset_machine(self, machine: int) -> None:
        """Forget a machine's EWMA slowdown state. Hosts announce rejoins
        with an ``inc machine.rejoin.m<id>``; a machine that comes back after
        a crash/flap is a fresh box, so its pre-crash EWMA must not carry
        over — stale state would either mask real post-rejoin drift (until
        the EWMA decays) or fake drift on a now-healthy machine. The
        min_samples warm-up restarts too."""
        mid = int(machine)
        self._ewma.pop(mid, None)
        self._ewma_n.pop(mid, None)
        self._last_alert.pop(("slowdown", str(mid)), None)

    def _prune(self, dq: collections.deque, t: float) -> None:
        horizon = t - self.config.window_s
        while dq and dq[0][0] < horizon:
            dq.popleft()

    def _fire(self, t: float, kind: str, key: str, value: float,
              threshold: float) -> None:
        last = self._last_alert.get((kind, key))
        if last is not None and t - last < self.config.cooldown_s:
            return
        self._last_alert[(kind, key)] = t
        alert = Alert(t=t, kind=kind, key=key, value=value,
                      threshold=threshold)
        self.alerts.append(alert)
        if self.on_alert is not None:
            self.on_alert(alert)

    # -- signals -------------------------------------------------------------
    def rolling_p95_s(self) -> float:
        vals = sorted(v for _, v in self._lat)
        if not vals:
            return 0.0
        rank = max(1, math.ceil(0.95 * len(vals)))
        return vals[rank - 1]

    def p95_since(self, t0: float) -> tuple[float, int]:
        """p95 (and sample count) over windowed latency observations at or
        after ``t0`` — the controller's canary probation compares the
        post-commit tail against the pre-commit baseline with this."""
        vals = sorted(v for t, v in self._lat if t >= t0)
        if not vals:
            return 0.0, 0
        rank = max(1, math.ceil(0.95 * len(vals)))
        return vals[rank - 1], len(vals)

    def slowdown(self, machine: int) -> float:
        return self._ewma.get(int(machine), 1.0)

    def burn_rate(self) -> float:
        if not self._slo:
            return 0.0
        frac = sum(v for _, v in self._slo) / len(self._slo)
        return frac / self.config.slo_budget

    def _check_p95(self, t: float) -> None:
        thr = self.config.rolling_p95_threshold_s
        if thr is None:
            return
        self._prune(self._lat, t)
        if len(self._lat) < self.config.min_samples:
            return
        p95 = self.rolling_p95_s()
        if p95 > thr:
            self._fire(t, "rolling_p95", self.config.latency_metric, p95, thr)

    def _bump_ewma(self, mid: int, ratio: float) -> None:
        a = self.config.slowdown_alpha
        prev = self._ewma.get(mid)
        self._ewma[mid] = ratio if prev is None \
            else a * ratio + (1.0 - a) * prev
        n = self._ewma_n.get(mid, 0) + 1
        self._ewma_n[mid] = n
        thr = self.config.slowdown_threshold
        if thr is None or n < self.config.min_samples:
            return
        if self._ewma[mid] > thr:
            self._fire(self._now(), "slowdown", str(mid), self._ewma[mid],
                       thr)

    def _check_burn(self, t: float) -> None:
        thr = self.config.burn_rate_threshold
        if thr is None:
            return
        self._prune(self._slo, t)
        if len(self._slo) < self.config.min_samples:
            return
        rate = self.burn_rate()
        if rate > thr:
            self._fire(t, "slo_burn", self.config.latency_metric, rate, thr)

    # -- reading -------------------------------------------------------------
    def summary(self) -> dict:
        return {
            "n_alerts": len(self.alerts),
            "alerts": [a.to_dict() for a in self.alerts],
            "rolling_p95_s": self.rolling_p95_s(),
            "burn_rate": self.burn_rate(),
            "slowdown_ewma": {m: self._ewma[m] for m in sorted(self._ewma)},
        }
