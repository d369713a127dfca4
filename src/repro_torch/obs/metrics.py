"""Metrics registry: exact integer counters, gauges, fixed-bucket histograms.

Carried invariants (ROADMAP): anything that counts discrete things is an
exact Python integer — counters never accumulate float error. Latency-style
distributions go into *fixed-bucket* histograms whose p50/p95/p99 are read as
the upper edge of the bucket the target rank lands in (Prometheus-style):
deterministic, mergeable, O(1) per observation, no sample storage.

``snapshot()`` returns a nested, deterministically-ordered dict (counters /
gauges / histograms); ``flat()`` flattens it to ``name -> number`` for
embedding in result rows and ``BENCH_*.json`` cells.

Naming convention: metrics under the ``engine.`` prefix or containing a
``.solver.`` segment are *solver-specific* — their values may legitimately
differ between ``solver="fast"`` and ``solver="reference"`` runs (the fast
path coalesces solves and schedules fewer events). Everything else is
semantic and must match across solvers (asserted in tests/test_obs.py).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

# Log-spaced seconds buckets: ~100us .. ~10000s, 4 per decade.
LATENCY_BUCKETS_S = tuple(
    round(10.0 ** (e / 4.0), 10) for e in range(-16, 17))
# Log-spaced byte-size buckets: 1KiB .. 1TiB, powers of 4.
BYTES_BUCKETS = tuple(float(4 ** k) for k in range(5, 21))

SOLVER_SPECIFIC_PREFIXES = ("engine.",)
SOLVER_SPECIFIC_MARKER = ".solver."


def is_solver_specific(name: str) -> bool:
    """True when a metric's value is allowed to differ between the fast and
    reference solvers (solve/event accounting, not simulation semantics)."""
    return name.startswith(SOLVER_SPECIFIC_PREFIXES) \
        or SOLVER_SPECIFIC_MARKER in name


def snapshot_diff(a: dict, b: dict) -> dict:
    """Structural diff of two ``Metrics.snapshot()`` dicts (``a`` is the
    baseline). Counters and gauges diff numerically; histograms diff per
    stat (count/sum/p50/p95/p99). Keys present on only one side appear with
    the missing side treated as zero and are listed under ``only_a`` /
    ``only_b`` so a disappeared metric can't hide as a zero delta. Identical
    entries are omitted — an empty diff means identical snapshots."""
    out: dict = {"counters": {}, "gauges": {}, "histograms": {},
                 "only_a": [], "only_b": []}
    for section in ("counters", "gauges"):
        sa, sb = a.get(section, {}), b.get(section, {})
        for k in sorted(set(sa) | set(sb)):
            if k not in sa:
                out["only_b"].append(f"{section}.{k}")
            elif k not in sb:
                out["only_a"].append(f"{section}.{k}")
            d = sb.get(k, 0) - sa.get(k, 0)
            if d != 0:
                out[section][k] = d
    ha, hb = a.get("histograms", {}), b.get("histograms", {})
    for k in sorted(set(ha) | set(hb)):
        if k not in ha:
            out["only_b"].append(f"histograms.{k}")
        elif k not in hb:
            out["only_a"].append(f"histograms.{k}")
        da, db = ha.get(k, {}), hb.get(k, {})
        d = {stat: db.get(stat, 0) - da.get(stat, 0)
             for stat in ("count", "sum", "p50", "p95", "p99")
             if db.get(stat, 0) != da.get(stat, 0)}
        if d:
            out["histograms"][k] = d
    return out


class Histogram:
    __slots__ = ("buckets", "counts", "count", "sum", "min", "max")

    def __init__(self, buckets: Sequence[float]):
        self.buckets = tuple(float(b) for b in buckets)
        self.counts = [0] * (len(self.buckets) + 1)   # +1 overflow bucket
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        lo, hi = 0, len(self.buckets)
        while lo < hi:                                 # bisect: v <= edge
            mid = (lo + hi) // 2
            if v <= self.buckets[mid]:
                hi = mid
            else:
                lo = mid + 1
        self.counts[lo] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def quantile(self, q: float) -> float:
        """Upper edge of the bucket holding rank ceil(q * count); the exact
        max for the overflow bucket. 0.0 when empty."""
        if self.count == 0:
            return 0.0
        target = max(1, math.ceil(q * self.count))
        acc = 0
        for k, c in enumerate(self.counts):
            acc += c
            if acc >= target:
                if k < len(self.buckets):
                    return self.buckets[k]
                return self.max
        return self.max

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other`` into this histogram in place (bench cells and
        windowed monitors aggregate per-shard histograms this way). Bucket
        edges must match — merging snapshots (``as_dict`` output) is
        impossible because they drop the per-bucket counts."""
        if other.buckets != self.buckets:
            raise ValueError("cannot merge histograms with different buckets")
        for k, c in enumerate(other.counts):
            self.counts[k] += c
        self.count += other.count
        self.sum += other.sum
        if other.count:
            self.min = min(self.min, other.min)
            self.max = max(self.max, other.max)
        return self

    def as_dict(self) -> dict:
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }


class Metrics:
    def __init__(self) -> None:
        self._counters: dict[str, int] = {}
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, Histogram] = {}
        # streaming subscribers (obs.monitors); empty on every registry that
        # has no monitor attached, so the common recording path pays one
        # truthiness check
        self._listeners: list = []

    # -- recording -----------------------------------------------------------
    def inc(self, name: str, n: int = 1) -> None:
        self._counters[name] = self._counters.get(name, 0) + int(n)
        if self._listeners:
            for fn in self._listeners:
                fn("inc", name, n)

    def gauge(self, name: str, v: float) -> None:
        self._gauges[name] = float(v)

    def gauge_max(self, name: str, v: float) -> None:
        v = float(v)
        if v > self._gauges.get(name, -math.inf):
            self._gauges[name] = v

    def observe(self, name: str, v: float,
                buckets: Optional[Sequence[float]] = None) -> None:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram(buckets or LATENCY_BUCKETS_S)
        h.observe(v)
        if self._listeners:
            for fn in self._listeners:
                fn("observe", name, v)

    def subscribe(self, fn) -> None:
        """Stream every ``inc``/``observe`` as ``fn(kind, name, value)`` —
        the hook ``obs.monitors.DriftMonitor`` attaches through. Only exists
        on the enabled registry: a ``NullMetrics`` can't forward anything,
        which is how monitors keep the zero-call-when-disabled invariant."""
        self._listeners.append(fn)

    def merge(self, other: "Metrics") -> "Metrics":
        """Fold another registry into this one in place: counters add,
        gauges keep the max (a merged gauge is a high-water mark), histograms
        bucket-merge. Listeners are not forwarded — merge is an offline
        aggregation, not a recording event."""
        for k, v in other._counters.items():
            self._counters[k] = self._counters.get(k, 0) + v
        for k, v in other._gauges.items():
            if v > self._gauges.get(k, -math.inf):
                self._gauges[k] = v
        for k, h in other._hists.items():
            mine = self._hists.get(k)
            if mine is None:
                mine = self._hists[k] = Histogram(h.buckets)
            mine.merge(h)
        return self

    # -- reading -------------------------------------------------------------
    def snapshot(self) -> dict:
        return {
            "counters": {k: self._counters[k] for k in sorted(self._counters)},
            "gauges": {k: self._gauges[k] for k in sorted(self._gauges)},
            "histograms": {k: self._hists[k].as_dict()
                           for k in sorted(self._hists)},
        }

    def flat(self) -> dict:
        """``name -> number``: counters and gauges verbatim, histograms as
        ``name.count`` / ``name.p50`` / ``name.p95`` / ``name.p99``."""
        out: dict = {}
        for k in sorted(self._counters):
            out[k] = self._counters[k]
        for k in sorted(self._gauges):
            out[k] = self._gauges[k]
        for k in sorted(self._hists):
            d = self._hists[k].as_dict()
            for stat in ("count", "p50", "p95", "p99"):
                out[f"{k}.{stat}"] = d[stat]
        return out


class NullMetrics:
    """Disabled registry: counted no-ops (see ``NullTracer``)."""

    def __init__(self) -> None:
        self.calls = 0

    def inc(self, *a, **kw) -> None:
        self.calls += 1

    def gauge(self, *a, **kw) -> None:
        self.calls += 1

    def gauge_max(self, *a, **kw) -> None:
        self.calls += 1

    def observe(self, *a, **kw) -> None:
        self.calls += 1

    def snapshot(self) -> dict:
        self.calls += 1
        return {"counters": {}, "gauges": {}, "histograms": {}}

    def flat(self) -> dict:
        self.calls += 1
        return {}
