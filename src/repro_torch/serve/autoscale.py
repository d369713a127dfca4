"""Queue-depth / SLO-driven autoscaling controller.

A periodic control loop (a ``pin_epoch=False`` tick, so it survives
re-plans) watches two signals:

* **queue pressure** — mean pending requests per live replica;
* **SLO attainment** — the p95 end-to-end latency of the completions inside
  a sliding window vs the scenario's SLO target.

Breaching either high-water mark asks the serving cluster to scale up;
sitting below the low-water mark with more than ``min_replicas`` live asks
it to scale down. Decisions are rate-limited by a cooldown so one burst
cannot provision the whole spare pool. The *mechanism* of scaling (activate
a spare machine, provision a new one through
``runtime.elastic.ElasticRuntime.on_join``, cold-start weight transfer) is
the cluster's business — see ``sim.workload.ServeExecutor``.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import TYPE_CHECKING, Callable, Optional

import numpy as np

if TYPE_CHECKING:   # import-time-free: sim.scenarios imports this module
    from repro_torch.sim.engine import Simulator


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    check_period_s: float = 10.0
    queue_high: float = 3.0        # pending requests / replica to scale up
    queue_low: float = 0.25        # ... to scale down
    slo_s: Optional[float] = None  # p95 latency target (None = queue only)
    window: int = 50               # completions in the p95 window
    min_replicas: int = 1
    max_replicas: int = 8
    cooldown_s: float = 30.0


class Autoscaler:
    """``scale_up``/``scale_down`` callbacks return True when the cluster
    actually changed size (used for cooldown bookkeeping)."""

    def __init__(self, sim: "Simulator", cfg: AutoscaleConfig,
                 n_replicas: Callable[[], int],
                 pending_per_replica: Callable[[], float],
                 scale_up: Callable[[], bool],
                 scale_down: Callable[[], bool]):
        self.sim = sim
        self.cfg = cfg
        self._n = n_replicas
        self._pending = pending_per_replica
        self._up = scale_up
        self._down = scale_down
        self._lat_window: collections.deque[float] = collections.deque(
            maxlen=cfg.window)
        self._last_action = -float("inf")
        self.log: list[dict] = []
        self.stopped = False

    def start(self) -> None:
        self.sim.schedule(self.cfg.check_period_s, self._tick,
                          pin_epoch=False)

    def stop(self) -> None:
        self.stopped = True

    def observe_completion(self, latency_s: float) -> None:
        self._lat_window.append(latency_s)

    def p95(self) -> float:
        if not self._lat_window:
            return 0.0
        return float(np.percentile(np.asarray(self._lat_window), 95))

    def _tick(self) -> None:
        if self.stopped:
            return
        n = self._n()
        pending = self._pending()
        p95 = self.p95()
        cooled = self.sim.now - self._last_action >= self.cfg.cooldown_s
        slo_breach = (self.cfg.slo_s is not None and p95 > self.cfg.slo_s
                      and len(self._lat_window) >= 5)
        if cooled and n < self.cfg.max_replicas \
                and (pending > self.cfg.queue_high or slo_breach):
            if self._up():
                self._last_action = self.sim.now
                self.log.append({"t": self.sim.now, "action": "up",
                                 "pending_per_replica": pending, "p95": p95,
                                 "n_replicas": self._n()})
        elif cooled and n > self.cfg.min_replicas \
                and pending < self.cfg.queue_low and not slo_breach:
            if self._down():
                self._last_action = self.sim.now
                self.log.append({"t": self.sim.now, "action": "down",
                                 "pending_per_replica": pending, "p95": p95,
                                 "n_replicas": self._n()})
        self.sim.schedule(self.cfg.check_period_s, self._tick,
                          pin_epoch=False)
