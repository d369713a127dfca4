"""Per-machine compute model with straggler jitter.

Durations are ``work_flops / (tflops * 1e12)`` scaled by two factors:

* a persistent per-machine straggler multiplier (a seeded fraction of the
  fleet runs ``straggler_slowdown`` x slower — thermal throttling, noisy
  neighbours, degraded HBM), and
* a per-operation lognormal jitter ``exp(sigma * z)`` with ``z`` drawn from
  an RNG keyed on ``(seed, machine, step, microbatch, tag)`` — *counter-based*
  randomness, so a duration never depends on event execution order and the
  whole simulation stays deterministic and replayable.

With ``JitterConfig()`` (all zeros) durations equal the analytic
``core.cost_model`` compute times exactly — the calibration limit.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.graph import ClusterGraph


@dataclasses.dataclass(frozen=True)
class JitterConfig:
    sigma: float = 0.0               # lognormal sigma per compute op
    straggler_frac: float = 0.0      # fraction of machines persistently slow
    straggler_slowdown: float = 1.0  # their multiplicative slowdown (>= 1)


class ComputeModel:
    def __init__(self, graph: ClusterGraph, jitter: JitterConfig | None = None,
                 seed: int = 0):
        self.graph = graph
        self.jitter = jitter or JitterConfig()
        self.seed = seed
        self.tflops = graph.tflops()
        self.slow_factor = np.ones(graph.n)
        if self.jitter.straggler_frac > 0 and self.jitter.straggler_slowdown > 1:
            k = max(1, int(round(self.jitter.straggler_frac * graph.n)))
            rng = np.random.default_rng((seed, 0x57A6))
            slow = rng.choice(graph.n, size=min(k, graph.n), replace=False)
            self.slow_factor[slow] = self.jitter.straggler_slowdown
        self.busy_s = np.zeros(graph.n)  # accounting: total busy time/machine
        self.alive = np.ones(graph.n, bool)   # False = deprovisioned
        # gray-failure multiplier (sim.faults): silent slowdown on top of the
        # persistent straggler factor; 1.0 everywhere = no fault, bit-identical
        self.gray = np.ones(graph.n)

    def stragglers(self) -> list[int]:
        return [int(i) for i in np.nonzero(self.slow_factor > 1.0)[0]]

    def telemetry(self) -> tuple[np.ndarray, np.ndarray]:
        """(slowdown, jitter_sigma) per machine — the compute half of the
        observed signals fed back into v2 ``ClusterGraph`` node features
        (``sim.evaluate.observed_telemetry``). The slowdown is the persistent
        straggler multiplier a production fleet would measure from step-time
        telemetry; sigma is the configured per-op jitter every machine
        shares under this model."""
        sigma = np.full(len(self.slow_factor), float(self.jitter.sigma),
                        np.float32)
        return (self.slow_factor * self.gray).astype(np.float32), sigma

    def add_machine(self, machine) -> int:
        """The fleet grew (autoscale provisioning): track the new machine.
        Joined machines are never retroactive stragglers — the straggler
        draw stays a pure function of the initial fleet and seed."""
        self.tflops = np.append(self.tflops, np.float32(machine.tflops))
        self.slow_factor = np.append(self.slow_factor, 1.0)
        self.busy_s = np.append(self.busy_s, 0.0)
        self.alive = np.append(self.alive, True)
        self.gray = np.append(self.gray, 1.0)
        return len(self.tflops) - 1

    def remove_machine(self, machine: int) -> None:
        """Deprovision (autoscale scale-down): the machine's accounting stays
        (its busy seconds happened) but it is marked dead."""
        self.alive[machine] = False

    def revive_machine(self, machine: int) -> None:
        """Re-provision a previously deprovisioned machine."""
        self.alive[machine] = True

    def set_gray(self, machine: int, factor: float) -> None:
        """Install (or clear, with ``factor=1.0``) a gray-failure slowdown:
        the machine stays alive and schedulable, every compute op just takes
        ``factor`` x longer. Visible to ``telemetry()`` but NOT to
        ``stragglers()`` — gray failures are the degradations the static
        straggler census doesn't know about."""
        self.gray[machine] = float(factor)

    def duration(self, machine: int, work_flops: float, step: int = 0,
                 microbatch: int = 0, tag: int = 0) -> float:
        if not self.alive[machine]:
            raise ValueError(f"machine {machine} is deprovisioned")
        base = work_flops / (float(self.tflops[machine]) * 1e12)
        f = float(self.slow_factor[machine]) * float(self.gray[machine])
        if self.jitter.sigma > 0:
            rng = np.random.default_rng(
                (self.seed, machine, step, microbatch, tag))
            f *= math.exp(self.jitter.sigma * float(rng.standard_normal()))
        d = base * f
        self.busy_s[machine] += d
        return d
