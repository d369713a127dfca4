"""Deterministic event-heap engine.

The heap orders events by (time, sequence number); the sequence number makes
simultaneous events fire in scheduling order, so a run is a pure function of
its inputs — no wall clock, no global RNG. Events are cancellable handles
(needed by the network model, which reschedules flow completions whenever
fair-share rates change) and carry an *epoch* guard: bumping the simulator
epoch invalidates every event scheduled under an older epoch, which is how a
fault-triggered re-plan aborts all in-flight work without unwinding the heap.
"""
from __future__ import annotations

import heapq
import math
from typing import Any, Callable, Optional

from repro_torch import obs as obs_mod


class Event:
    """Handle for a scheduled callback; ``cancel()`` is O(1).

    The handle is NOT the heap entry: the heap stores ``(time, seq, event)``
    tuples so ordering is resolved by C-level tuple comparison instead of a
    Python ``__lt__`` call per sift step — at fleet scale the comparison was
    the single hottest function in the simulator."""

    __slots__ = ("fn", "args", "cancelled", "epoch")

    def __init__(self, fn: Callable, args: tuple, epoch: int):
        self.fn = fn
        self.args = args
        self.cancelled = False
        self.epoch = epoch

    def cancel(self) -> None:
        self.cancelled = True


class Simulator:
    def __init__(self, obs=None):
        self.now: float = 0.0
        self.epoch: int = 0
        self.n_fired: int = 0
        self._heap: list[tuple[float, int, Event]] = []
        self._seq: int = 0
        self.obs = obs if obs is not None else obs_mod.NULL
        self.obs.bind_clock(lambda: self.now)

    @property
    def events_dispatched(self) -> int:
        """Events fired so far — the public face of the heap's sequence
        accounting (callers must not poke ``_heap`` / ``_seq`` directly)."""
        return self.n_fired

    @property
    def events_scheduled(self) -> int:
        """Events ever pushed, fired or not: the heap's (time, seq) sequence
        counter. ``events_scheduled - events_dispatched`` bounds the pending
        + cancelled/stale backlog."""
        return self._seq

    def schedule(self, delay: float, fn: Callable, *args: Any,
                 pin_epoch: bool = True) -> Event:
        """Schedule ``fn(*args)`` at ``now + delay``. Events scheduled with
        ``pin_epoch=True`` (the default) are dropped if the simulator epoch
        advances before they fire; pass ``pin_epoch=False`` for control-plane
        events (fault injection, periodic ticks) that must survive re-plans."""
        if not (delay >= 0.0) or math.isinf(delay):
            raise ValueError(f"bad event delay: {delay!r}")
        ev = Event(fn, args, self.epoch if pin_epoch else -1)
        seq = self._seq
        self._seq = seq + 1
        heapq.heappush(self._heap, (self.now + delay, seq, ev))
        return ev

    def bump_epoch(self) -> int:
        """Invalidate every epoch-pinned event currently in the heap."""
        self.epoch += 1
        if self.obs.enabled:
            # re-plan boundary: the causal edge between the aborted schedule
            # and the restarted one (trace analytics anchor waits to it)
            self.obs.metrics.inc("engine.epoch_bumps")
            self.obs.trace.instant("engine/dispatch", "epoch_bump",
                                   cat="engine", args={"epoch": self.epoch})
        return self.epoch

    def run(self, until: float = math.inf, max_events: int = 20_000_000) -> float:
        """Drain the heap (up to ``until``); returns the final sim time.

        The traced variant is a separate loop so the disabled path stays the
        exact historical hot loop — zero per-event observability cost beyond
        this one check per ``run()`` call."""
        if self.obs.enabled:
            return self._run_traced(until, max_events)
        heap = self._heap
        pop = heapq.heappop
        while heap:
            t = heap[0][0]
            if t > until:
                break
            _, _, ev = pop(heap)
            if ev.cancelled or (ev.epoch >= 0 and ev.epoch != self.epoch):
                continue
            self.now = t
            self.n_fired += 1
            if self.n_fired > max_events:
                raise RuntimeError(f"simulation exceeded {max_events} events")
            ev.fn(*ev.args)
        return self.now

    def _run_traced(self, until: float, max_events: int) -> float:
        """The instrumented run loop: a dispatch span per fired event (sim
        time does not advance inside a callback, so spans record *what fired
        when*, ordered by the heap's (time, seq) tuples), dropped-event
        counters, and a periodically sampled heap-depth counter track."""
        heap = self._heap
        pop = heapq.heappop
        trace = self.obs.trace
        metrics = self.obs.metrics
        while heap:
            t = heap[0][0]
            if t > until:
                break
            _, _, ev = pop(heap)
            if ev.cancelled or (ev.epoch >= 0 and ev.epoch != self.epoch):
                metrics.inc("engine.events_dropped")
                continue
            self.now = t
            self.n_fired += 1
            if self.n_fired > max_events:
                raise RuntimeError(f"simulation exceeded {max_events} events")
            metrics.inc("engine.events_dispatched")
            depth = len(heap) + 1
            metrics.gauge_max("engine.heap_depth_max", depth)
            if self.n_fired % 64 == 1:   # sampled on the event count:
                trace.counter("engine/heap", "heap_depth", depth)  # deterministic
            trace.span_at("engine/dispatch", getattr(ev.fn, "__qualname__",
                                                     "callback"),
                          t, t, cat="engine")
            ev.fn(*ev.args)
        return self.now


class Barrier:
    """Fire ``done`` after ``n`` arrivals (parallel-phase join)."""

    __slots__ = ("n", "done")

    def __init__(self, n: int, done: Callable[[], None]):
        if n <= 0:
            done()
            self.n = 0
        else:
            self.n = n
        self.done = done

    def arrive(self) -> None:
        self.n -= 1
        if self.n == 0:
            self.done()
