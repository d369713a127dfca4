"""Deterministic, seedable request-traffic generator.

Produces the full arrival trace for a serving run as a pure function of
``(TrafficConfig, seed)``: per-region inhomogeneous Poisson arrivals (thinned
from a homogeneous envelope, so the draw count is independent of the rate
curve), an optional regional or fleet-wide burst window, and per-model
heterogeneous lognormal prompt/generation lengths. Regions follow the sun:
a region's share of traffic swells during its local daytime, phased by
longitude exactly like ``sim.scenarios.diurnal_traffic`` phases link
capacity.

Every random draw comes from ``np.random.default_rng((seed, stream, ...))``
counter-style keys, so traces replay bit-identically and two streams never
alias — the same discipline as ``sim.compute``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from repro_torch.core.graph import _COORDS


@dataclasses.dataclass(frozen=True)
class ModelMix:
    """One served model's share of traffic and its length distributions
    (lognormal with the given median and sigma, clipped to the caps)."""
    model: str
    weight: float = 1.0
    prompt_median: float = 128.0
    prompt_sigma: float = 0.6
    gen_median: float = 64.0
    gen_sigma: float = 0.6
    max_prompt: int = 4096
    max_gen: int = 1024


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    rate_rps: float                      # fleet-wide mean arrivals/second
    horizon_s: float                     # arrivals occur in [0, horizon)
    regions: tuple[str, ...]             # user-origin regions
    region_weights: tuple[float, ...] | None = None   # default: uniform
    mixes: tuple[ModelMix, ...] = (ModelMix("default"),)
    diurnal_depth: float = 0.0           # 0 = flat, 1 = full follow-the-sun
    period_s: float | None = None        # diurnal period (default: horizon)
    burst_factor: float = 1.0            # rate multiplier inside the window
    burst_window: tuple[float, float] | None = None   # (t0, t1) seconds
    burst_region: str | None = None      # None = burst everywhere


@dataclasses.dataclass(frozen=True)
class Request:
    rid: int
    t_arrival: float
    region: str
    model: str
    prompt_tokens: int
    gen_tokens: int

    @property
    def total_tokens(self) -> int:
        return self.prompt_tokens + self.gen_tokens


def region_rate(cfg: TrafficConfig, region_idx: int, t: float) -> float:
    """Instantaneous arrival rate (req/s) of one region at time ``t``."""
    w = (cfg.region_weights[region_idx] if cfg.region_weights
         else 1.0 / len(cfg.regions))
    rate = cfg.rate_rps * w
    if cfg.diurnal_depth > 0:
        period = cfg.period_s or cfg.horizon_s
        lon = _COORDS[cfg.regions[region_idx]][1]
        daylight = 0.5 + 0.5 * math.sin(2 * math.pi * (t / period
                                                       + lon / 360.0))
        # mean-preserving: E[daylight] = 1/2 over a period
        rate *= (1.0 - cfg.diurnal_depth) + 2.0 * cfg.diurnal_depth * daylight
    if (cfg.burst_window is not None
            and cfg.burst_window[0] <= t < cfg.burst_window[1]
            and (cfg.burst_region is None
                 or cfg.regions[region_idx] == cfg.burst_region)):
        rate *= cfg.burst_factor
    return rate


def _peak_rate(cfg: TrafficConfig, region_idx: int) -> float:
    w = (cfg.region_weights[region_idx] if cfg.region_weights
         else 1.0 / len(cfg.regions))
    peak = cfg.rate_rps * w
    if cfg.diurnal_depth > 0:
        peak *= (1.0 - cfg.diurnal_depth) + 2.0 * cfg.diurnal_depth
    if cfg.burst_window is not None and (
            cfg.burst_region is None
            or cfg.regions[region_idx] == cfg.burst_region):
        peak *= max(cfg.burst_factor, 1.0)
    return peak


def _lengths(mix: ModelMix, rng: np.random.Generator) -> tuple[int, int]:
    prompt = int(np.clip(round(mix.prompt_median
                               * math.exp(mix.prompt_sigma
                                          * rng.standard_normal())),
                         1, mix.max_prompt))
    gen = int(np.clip(round(mix.gen_median
                            * math.exp(mix.gen_sigma
                                       * rng.standard_normal())),
                      1, mix.max_gen))
    return prompt, gen


def generate(cfg: TrafficConfig, seed: int = 0) -> list[Request]:
    """The full trace, sorted by arrival time, rids assigned in that order."""
    if cfg.rate_rps <= 0 or cfg.horizon_s <= 0:
        return []
    mix_w = np.array([m.weight for m in cfg.mixes], float)
    mix_w = mix_w / mix_w.sum()
    raw: list[tuple[float, str, str, int, int]] = []
    for r_idx, region in enumerate(cfg.regions):
        peak = _peak_rate(cfg, r_idx)
        if peak <= 0:
            continue
        rng = np.random.default_rng((seed, r_idx, 0x5EF7E))
        # homogeneous Poisson at the peak-rate envelope, thinned to the
        # actual curve: accept an arrival at t with prob rate(t)/peak
        n = rng.poisson(peak * cfg.horizon_s)
        times = np.sort(rng.uniform(0.0, cfg.horizon_s, size=n))
        keep = rng.uniform(size=n) * peak
        for t, u in zip(times, keep):
            if u >= region_rate(cfg, r_idx, float(t)):
                continue
            m_idx = int(rng.choice(len(cfg.mixes), p=mix_w))
            prompt, gen = _lengths(cfg.mixes[m_idx], rng)
            raw.append((float(t), region, cfg.mixes[m_idx].model,
                        prompt, gen))
    raw.sort(key=lambda x: x[0])
    return [Request(rid=i, t_arrival=t, region=region, model=model,
                    prompt_tokens=p, gen_tokens=g)
            for i, (t, region, model, p, g) in enumerate(raw)]


def trace_stats(trace: Sequence[Request]) -> dict:
    """Summary used by benchmarks and tests."""
    if not trace:
        return {"n_requests": 0}
    by_region: dict[str, int] = {}
    for r in trace:
        by_region[r.region] = by_region.get(r.region, 0) + 1
    return {
        "n_requests": len(trace),
        "span_s": trace[-1].t_arrival - trace[0].t_arrival,
        "prompt_tokens_total": sum(r.prompt_tokens for r in trace),
        "gen_tokens_total": sum(r.gen_tokens for r in trace),
        "by_region": dict(sorted(by_region.items())),
    }
