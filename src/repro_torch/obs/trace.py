"""Structured span/event recorder with Chrome-trace (Perfetto) JSON export.

A ``Tracer`` records a deterministic stream of trace events against named
*tracks* ("machine/3", "replica/7", "engine/dispatch", ...). Tracks map onto
the Chrome Trace Event Format's (pid, tid) plane: every track becomes its own
process lane (with a ``process_name`` metadata event), so a fleet run opened
in Perfetto (https://ui.perfetto.dev) renders as one lane per machine, link,
replica and subsystem.

Clocks are *simulation time*: the engine binds ``tracer.now`` to its own
``sim.now`` (see ``Recorder.bind_clock``), timestamps are emitted as integer
microseconds, and events are appended in execution order — which the engine
already makes deterministic via its ``(time, seq)`` heap ordering. No wall
clock ever enters an event, so two same-seed runs serialize to byte-identical
files (asserted in tests/test_obs.py and the CI trace-smoke job).

Event kinds (Chrome ``ph`` codes):

* ``span_at``    — a complete slice (``"X"``) for strictly sequential work on
  a track (engine dispatch, cold starts);
* ``async_span`` — a nestable async begin/end pair (``"b"``/``"e"``) for
  work that overlaps on one track (concurrent flows on a machine, batched
  request phases on a replica);
* ``instant``    — a point event (``"i"``): failovers, drops, re-plans;
* ``counter``    — a counter sample (``"C"``) Perfetto plots as a graph.

Bounded mode: ``max_events`` turns the event store into a ring buffer (a
``collections.deque(maxlen=...)``), so always-on tracing of a long run keeps
the most recent window at O(max_events) memory. Eviction is deterministic
(FIFO over a deterministic stream), so bounded traces stay byte-identical
across same-seed runs too.
"""
from __future__ import annotations

import collections
import json
from typing import Callable, Optional

SCHEMA_VERSION = "repro.obs/1"


def _us(t: float) -> int:
    """Seconds -> integer microseconds (ints serialize byte-stably)."""
    return int(round(t * 1e6))


class Span:
    """Handle returned by ``Tracer.begin``; ``end()`` emits the slice."""

    __slots__ = ("_tracer", "_track", "_name", "_cat", "_t0")

    def __init__(self, tracer: "Tracer", track: str, name: str, cat: str,
                 t0: float):
        self._tracer = tracer
        self._track = track
        self._name = name
        self._cat = cat
        self._t0 = t0

    def end(self, args: Optional[dict] = None) -> None:
        self._tracer.span_at(self._track, self._name, self._t0,
                             self._tracer.now(), cat=self._cat, args=args)


class Tracer:
    def __init__(self, max_events: Optional[int] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.max_events = max_events
        self._events: collections.deque = collections.deque(maxlen=max_events)
        self.now: Callable[[], float] = clock or (lambda: 0.0)
        self._pids: dict[str, int] = {}      # track -> pid (one lane each)
        self.n_emitted = 0                   # includes ring-evicted events

    # -- track registry ------------------------------------------------------
    def _pid(self, track: str) -> int:
        pid = self._pids.get(track)
        if pid is None:
            pid = len(self._pids) + 1        # first-use order: deterministic
            self._pids[track] = pid
        return pid

    def _emit(self, ev: dict) -> None:
        self.n_emitted += 1
        self._events.append(ev)

    # -- recording API -------------------------------------------------------
    def begin(self, track: str, name: str, cat: str = "span") -> Span:
        """Open a slice at the current sim time; ``Span.end()`` closes it."""
        return Span(self, track, name, cat, self.now())

    def span_at(self, track: str, name: str, t0: float,
                t1: Optional[float] = None, cat: str = "span",
                args: Optional[dict] = None) -> None:
        """A complete slice [t0, t1] (t1 defaults to now). Use only for work
        that never overlaps itself on the track; overlapping work must use
        ``async_span`` so Perfetto can stack it."""
        t1 = self.now() if t1 is None else t1
        ev = {"ph": "X", "name": name, "cat": cat, "ts": _us(t0),
              "dur": max(0, _us(t1) - _us(t0)), "pid": self._pid(track),
              "tid": 0}
        if args:
            ev["args"] = args
        self._emit(ev)

    def async_span(self, track: str, name: str, span_id: str, t0: float,
                   t1: Optional[float] = None, cat: str = "span",
                   args: Optional[dict] = None) -> None:
        """A nestable async slice [t0, t1]: overlap-safe (concurrent flows,
        batched request phases). ``span_id`` groups nested phases."""
        t1 = self.now() if t1 is None else t1
        pid = self._pid(track)
        b = {"ph": "b", "name": name, "cat": cat, "id": span_id,
             "ts": _us(t0), "pid": pid, "tid": 0}
        if args:
            b["args"] = args
        self._emit(b)
        self._emit({"ph": "e", "name": name, "cat": cat, "id": span_id,
                    "ts": _us(t1), "pid": pid, "tid": 0})

    def instant(self, track: str, name: str, cat: str = "event",
                args: Optional[dict] = None) -> None:
        ev = {"ph": "i", "name": name, "cat": cat, "ts": _us(self.now()),
              "pid": self._pid(track), "tid": 0, "s": "p"}
        if args:
            ev["args"] = args
        self._emit(ev)

    def counter(self, track: str, name: str, value: float,
                cat: str = "counter") -> None:
        self._emit({"ph": "C", "name": name, "cat": cat,
                    "ts": _us(self.now()), "pid": self._pid(track), "tid": 0,
                    "args": {name: value}})

    # -- export --------------------------------------------------------------
    def to_chrome(self, metadata: Optional[dict] = None) -> dict:
        """The Chrome Trace Event Format document. ``metadata`` is embedded
        verbatim — callers must keep wall-clock values out of it when they
        rely on byte-identical traces."""
        meta_events = []
        for track, pid in sorted(self._pids.items(), key=lambda kv: kv[1]):
            meta_events.append({"ph": "M", "name": "process_name", "pid": pid,
                                "tid": 0, "args": {"name": track}})
            meta_events.append({"ph": "M", "name": "process_sort_index",
                                "pid": pid, "tid": 0,
                                "args": {"sort_index": pid}})
        doc = {
            "displayTimeUnit": "ms",
            "metadata": dict(metadata or {}, schema=SCHEMA_VERSION,
                             clock="sim_time_us",
                             n_emitted=self.n_emitted,
                             truncated=(self.max_events is not None
                                        and self.n_emitted > self.max_events)),
            "traceEvents": meta_events + list(self._events),
        }
        return doc

    def json_bytes(self, metadata: Optional[dict] = None) -> bytes:
        """Canonical serialization: sorted keys, compact separators — the
        byte-identity contract is over this exact encoding."""
        return json.dumps(self.to_chrome(metadata), sort_keys=True,
                          separators=(",", ":")).encode("utf-8")

    def write(self, path: str, metadata: Optional[dict] = None) -> None:
        with open(path, "wb") as f:
            f.write(self.json_bytes(metadata))


class NullSpan:
    __slots__ = ("_tracer",)

    def __init__(self, tracer: "NullTracer"):
        self._tracer = tracer

    def end(self, args: Optional[dict] = None) -> None:
        self._tracer.calls += 1


class NullTracer:
    """Disabled tracer: every method is a counted no-op. The call counter is
    how tests/test_obs.py proves the hot paths make ZERO recorder calls (and
    hence zero recording allocations) when observability is off."""

    def __init__(self) -> None:
        self.calls = 0
        self._span = NullSpan(self)

    def begin(self, track: str, name: str, cat: str = "span") -> NullSpan:
        self.calls += 1
        return self._span

    def span_at(self, *a, **kw) -> None:
        self.calls += 1

    def async_span(self, *a, **kw) -> None:
        self.calls += 1

    def instant(self, *a, **kw) -> None:
        self.calls += 1

    def counter(self, *a, **kw) -> None:
        self.calls += 1
