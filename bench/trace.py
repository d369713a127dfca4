"""One ``torch.profiler`` session over a stretch of the window, reduced to
what the per-layer readers and the result's ``device`` and ``breakdown``
need: the device's activities (kernels, copies, fills) with their names,
starts and durations, the length of the stretch, the time in which some
activity ran, and the idle gaps labelled by the host operation under way.

The stretch is a ``record_function`` range that starts after the device
has finished earlier work and ends after it has finished the stretch's, so
every device activity in the trace lies inside it. Times are seconds from
the range's start.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.profiler import ProfilerActivity, profile, record_function

RANGE = "bench.traced"


@dataclasses.dataclass
class Activity:
    name: str
    start: float
    dur: float


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    device: list          # [Activity], by start
    gaps: list            # [(label, seconds)], longest first

    def kernels(self, *names) -> list:
        """The device activities whose name holds any of ``names``."""
        return [a for a in self.device if any(n in a.name for n in names)]


def _annotation(ev) -> bool:
    f = getattr(ev, "is_user_annotation", None)
    return bool(f()) if f is not None else False


def _ns(ev, what):
    f = getattr(ev, f"{what}_ns", None)
    return f() if f is not None else getattr(ev, f"{what}_us")() * 1000


class Tracer:
    """``with Tracer(device) as t: ...`` then ``t.result``."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.result = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._range = record_function(RANGE)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._sync()
        self._range.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.result = reduce(self._prof.profiler.kineto_results.events())
        return False


def reduce(events) -> Trace:
    host, dev, span = [], [], None
    for ev in events:
        start = _ns(ev, "start")
        dur = _ns(ev, "duration")
        if ev.device_type() != torch.autograd.DeviceType.CPU and (
                ev.name() == RANGE or _annotation(ev)):
            continue     # the range's device-side span: no work
        if ev.device_type() == torch.autograd.DeviceType.CPU:
            if ev.name() == RANGE:
                span = (start, start + dur)
            else:
                host.append((start, dur, ev.name()))
        else:
            dev.append((start, dur, ev.name()))
    if span is None:
        raise RuntimeError("the profiler recorded no traced range")
    t0 = span[0]
    dev.sort()
    merged = []
    for s, d, _ in dev:
        e = s + d
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    edges = [span[0]] + [x for se in merged for x in se] + [span[1]]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    labelled = [(_host_at(host, (a + b) / 2), (b - a) / 1e9) for a, b in gaps[:10]]
    return Trace(window_s=(span[1] - span[0]) / 1e9, busy_s=busy / 1e9,
                 device=[Activity(n, (s - t0) / 1e9, d / 1e9) for s, d, n in dev],
                 gaps=labelled)


def _host_at(host, t) -> str:
    """The innermost host operation running at ``t``."""
    best = None
    for s, d, name in host:
        if s <= t <= s + d and (best is None or d < best[0]):
            best = (d, name)
    return "host: no operation recorded" if best is None else best[1][:100]


def breakdown(trace: Trace) -> dict:
    """The ten device operations that took most time, summed by name, and
    the ten longest idle gaps."""
    by_name: dict = {}
    for a in trace.device:
        by_name[a.name] = by_name.get(a.name, 0.0) + a.dur
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:100], s] for n, s in top],
            "idle_gaps": [[label, s] for label, s in trace.gaps]}
