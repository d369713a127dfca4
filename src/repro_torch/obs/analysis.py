"""Trace analytics: makespan/latency attribution, critical path, run diffing.

The flight recorder (``repro_torch.obs.trace``) can show *what happened*; this
module answers *why a run took as long as it did*. Everything here is a pure
function of an exported Chrome-trace document (the dict ``Tracer.to_chrome``
returns, or a parsed ``*.trace.json``): no recorder, simulator, or wall clock
is ever consulted, so the results are byte-deterministic for same-seed runs
(asserted in tests/test_analysis.py over the canonical JSON encoding).

Three analyses:

* ``attribute(doc)`` — reconstruct per-lane interval sets and bucket every
  ``machine/``, ``replica/`` and ``task/`` lane's timeline into **comm /
  compute / queue / fault_recovery / idle**. Overlapping async spans (a
  machine's concurrent outbound flows, a replica's batched sequences) are
  merged into interval unions first, so occupied time is never
  double-counted, and the buckets are disjointified in a fixed precedence
  order — per lane, the five buckets sum to the run window *exactly* (integer
  microsecond arithmetic, no float accumulation).
* ``critical_path(doc)`` — the task→link→task chain that determined a
  training run's makespan: walk back from the last-finishing step through
  each step's comm and compute phases (and the waits between them), preferring
  the same task's previous step (the true data dependency) and falling back
  to whichever step released the machines. ``latency_waterfall(doc)`` is the
  serving analogue: per-request dispatch → queued → prefill → decode →
  respond segments that sum to the recorded end-to-end latency exactly.
* ``diff(doc_a, doc_b)`` — align two runs (A/B router policies, fast vs
  reference planes, before/after a change) lane-by-lane and span-group by
  span-group, and report the top deltas.

Bucket taxonomy (also documented in docs/OBSERVABILITY.md):

| bucket | trace evidence |
|---|---|
| ``comm`` | ``machine/<i>`` ``xfer->*`` flow spans; the comm phase of a ``task/<t>`` ``step<k>`` span (from its ``comm_s`` arg) |
| ``compute`` | ``replica/<m>`` ``prefill``/``decode`` spans; the compute phase of a step span |
| ``queue`` | ``replica/<m>`` ``queued`` spans |
| ``fault_recovery`` | ``cold_start`` weight streams; ``machine_down`` → ``recover``/``rejoin`` downtime from the ``faults`` lane |
| ``idle`` | the window minus everything above |

Precedence on (rare, rounding-induced) overlap: compute > comm > queue >
fault_recovery; idle is the exact complement.

Truncated (ring-buffered) traces are handled: async ends whose begins were
evicted are dropped, the window starts at the first surviving event, and the
same exact-sum invariant holds over the surviving window.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

BUCKETS = ("comm", "compute", "queue", "fault_recovery", "idle")

# lanes the attribution covers; everything else (engine/*, net/flows, faults,
# requests) is bookkeeping or fleet-wide rather than a per-resource timeline
_LANE_PREFIXES = ("machine/", "replica/", "task/")


# ---------------------------------------------------------------------------
# Integer-microsecond interval algebra (all lists are [t0, t1) pairs)
# ---------------------------------------------------------------------------
def merge_intervals(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """Union of intervals: sorted, disjoint, zero-length dropped."""
    ivs = sorted((a, b) for a, b in intervals if b > a)
    out: list[tuple[int, int]] = []
    for a, b in ivs:
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def total_us(intervals: list[tuple[int, int]]) -> int:
    return sum(b - a for a, b in intervals)


def subtract_intervals(a: list[tuple[int, int]],
                       b: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """a \\ b for disjoint sorted interval lists."""
    out: list[tuple[int, int]] = []
    k = 0
    for lo, hi in a:
        cur = lo
        while k < len(b) and b[k][1] <= cur:
            k += 1
        j = k
        while j < len(b) and b[j][0] < hi:
            blo, bhi = b[j]
            if blo > cur:
                out.append((cur, blo))
            cur = max(cur, bhi)
            if cur >= hi:
                break
            j += 1
        if cur < hi:
            out.append((cur, hi))
    return out


def clip_intervals(intervals: list[tuple[int, int]], lo: int,
                   hi: int) -> list[tuple[int, int]]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


# ---------------------------------------------------------------------------
# Trace parsing: pids -> lanes, async pairs -> spans
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ParsedSpan:
    lane: str
    name: str
    t0: int
    t1: int
    cat: str
    args: dict


@dataclasses.dataclass
class ParsedTrace:
    lanes: dict[str, list[ParsedSpan]]            # lane -> spans (all kinds)
    instants: dict[str, list[tuple[str, int, dict]]]  # lane -> (name, ts, args)
    window: tuple[int, int]
    truncated: bool
    n_dropped_ends: int                           # async ends with evicted begins


def parse_trace(doc: dict) -> ParsedTrace:
    """Reconstruct spans per lane from a Chrome-trace document. Async b/e
    pairs are matched LIFO per (pid, cat, id, name); ends whose begins were
    ring-evicted are dropped (counted), begins that never ended are closed at
    the window end."""
    names = {ev["pid"]: ev["args"]["name"] for ev in doc["traceEvents"]
             if ev["ph"] == "M" and ev["name"] == "process_name"}
    truncated = bool(doc.get("metadata", {}).get("truncated"))
    lanes: dict[str, list[ParsedSpan]] = {}
    instants: dict[str, list[tuple[str, int, dict]]] = {}
    open_async: dict[tuple, list[tuple[int, dict]]] = {}
    dangling: list[tuple[str, str, str, int, dict]] = []
    n_dropped = 0
    t_min, t_max = None, 0
    for ev in doc["traceEvents"]:
        ph = ev["ph"]
        if ph == "M":
            continue
        ts = int(ev.get("ts", 0))
        t_min = ts if t_min is None else min(t_min, ts)
        lane = names.get(ev["pid"], f"pid{ev['pid']}")
        if ph == "X":
            dur = int(ev.get("dur", 0))
            t_max = max(t_max, ts + dur)
            lanes.setdefault(lane, []).append(ParsedSpan(
                lane, ev["name"], ts, ts + dur, ev.get("cat", ""),
                ev.get("args", {})))
        elif ph == "b":
            key = (ev["pid"], ev.get("cat"), ev["id"], ev["name"])
            open_async.setdefault(key, []).append((ts, ev.get("args", {})))
            t_max = max(t_max, ts)
        elif ph == "e":
            key = (ev["pid"], ev.get("cat"), ev["id"], ev["name"])
            stack = open_async.get(key)
            if stack:
                t0, args = stack.pop()
                lanes.setdefault(lane, []).append(ParsedSpan(
                    lane, ev["name"], t0, ts, ev.get("cat", ""), args))
            else:
                n_dropped += 1            # begin evicted by the ring buffer
            t_max = max(t_max, ts)
        elif ph == "i":
            instants.setdefault(lane, []).append(
                (ev["name"], ts, ev.get("args", {})))
            t_max = max(t_max, ts)
        # counters ("C") carry no duration — skipped
    # close never-ended begins at the window end (crash-interrupted work)
    for (pid, cat, sid, name), stack in open_async.items():
        lane = names.get(pid, f"pid{pid}")
        for t0, args in stack:
            dangling.append((lane, name, cat or "", t0, args))
    for lane, name, cat, t0, args in dangling:
        lanes.setdefault(lane, []).append(ParsedSpan(
            lane, name, t0, t_max, cat, args))
    t_lo = (t_min or 0) if truncated else 0
    return ParsedTrace(lanes=lanes, instants=instants,
                       window=(t_lo, max(t_max, t_lo)), truncated=truncated,
                       n_dropped_ends=n_dropped)


# ---------------------------------------------------------------------------
# Attribution
# ---------------------------------------------------------------------------
def _split_step(span: ParsedSpan) -> tuple[tuple[int, int], tuple[int, int]]:
    """A training step span covers its compute phase then its comm phase;
    the recorded ``compute_s`` arg gives the boundary. Integer µs: the comm
    part is the exact remainder, so the two parts sum to the span."""
    dur = span.t1 - span.t0
    comp_us = int(round(float(span.args.get("compute_s", 0.0)) * 1e6))
    comp_us = max(0, min(dur, comp_us))
    if "compute_s" not in span.args:
        comp_us = dur
    mid = span.t0 + comp_us
    return (span.t0, mid), (mid, span.t1)


def _downtime_intervals(
        parsed: ParsedTrace) -> tuple[dict[int, list[tuple[int, int]]],
                                      dict[int, list[tuple[int, int]]]]:
    """``(replica_down, machine_down)``: machine id -> down intervals, from
    the ``faults`` lane's ``machine_down`` / ``recover`` instants (``rejoin``
    closes every open interval — the training-side recovery is fleet-level).
    A process-level crash (``machine_level=False``: the replica died but the
    machine keeps routing) only downs the replica lane; machine-level crashes
    down both. Unclosed downtime runs to the window end."""
    t_end = parsed.window[1]
    rep_down: dict[int, list[tuple[int, int]]] = {}
    mach_down: dict[int, list[tuple[int, int]]] = {}
    open_at: dict[int, tuple[int, bool]] = {}

    def close(m: int, t1: int) -> None:
        opened = open_at.pop(m, None)
        if opened is None:
            return
        t0, machine_level = opened
        rep_down.setdefault(m, []).append((t0, t1))
        if machine_level:
            mach_down.setdefault(m, []).append((t0, t1))

    events = sorted(parsed.instants.get("faults", []), key=lambda e: e[1])
    for name, ts, args in events:
        if name == "machine_down" and "machine" in args:
            m = int(args["machine"])
            if m not in open_at:
                open_at[m] = (ts, bool(args.get("machine_level", True)))
        elif name == "recover" and "machine" in args:
            close(int(args["machine"]), ts)
        elif name == "rejoin":
            for m in list(open_at):
                close(m, ts)
    for m in list(open_at):
        close(m, t_end)
    return rep_down, mach_down


@dataclasses.dataclass
class Attribution:
    window_us: tuple[int, int]
    lanes: dict[str, dict[str, int]]     # lane -> bucket -> µs
    totals: dict[str, int]               # bucket -> µs (summed over lanes)
    truncated: bool
    n_dropped_ends: int

    @property
    def wall_us(self) -> int:
        return self.window_us[1] - self.window_us[0]

    def to_dict(self) -> dict:
        return {
            "window_us": list(self.window_us),
            "truncated": self.truncated,
            "n_dropped_ends": self.n_dropped_ends,
            "lanes": {lane: dict(b) for lane, b in sorted(self.lanes.items())},
            "totals": dict(self.totals),
        }


def _lane_buckets(lane: str, spans: list[ParsedSpan],
                  rep_down: dict[int, list[tuple[int, int]]],
                  mach_down: dict[int, list[tuple[int, int]]],
                  lo: int, hi: int) -> dict[str, int]:
    raw: dict[str, list[tuple[int, int]]] = {b: [] for b in BUCKETS[:-1]}
    for s in spans:
        if lane.startswith("machine/"):
            if s.name.startswith("xfer->") or s.cat == "net":
                raw["comm"].append((s.t0, s.t1))
        elif lane.startswith("replica/"):
            if s.name == "queued":
                raw["queue"].append((s.t0, s.t1))
            elif s.name in ("prefill", "decode"):
                raw["compute"].append((s.t0, s.t1))
            elif s.name == "cold_start":
                raw["fault_recovery"].append((s.t0, s.t1))
        elif lane.startswith("task/"):
            if s.name.startswith("step"):
                comp, comm = _split_step(s)
                raw["compute"].append(comp)
                raw["comm"].append(comm)
    # downtime applies to this resource's lane (process-level crashes only
    # down the replica; machine-level crashes down both views)
    for prefix, down in (("machine/", mach_down), ("replica/", rep_down)):
        if lane.startswith(prefix):
            tail = lane[len(prefix):]
            if tail.isdigit() and int(tail) in down:
                raw["fault_recovery"].extend(down[int(tail)])

    # disjointify in precedence order, then idle = exact complement
    out: dict[str, int] = {}
    claimed: list[tuple[int, int]] = []
    for bucket in ("compute", "comm", "queue", "fault_recovery"):
        ivs = clip_intervals(merge_intervals(raw[bucket]), lo, hi)
        ivs = subtract_intervals(ivs, claimed)
        out[bucket] = total_us(ivs)
        claimed = merge_intervals(claimed + ivs)
    out["idle"] = (hi - lo) - total_us(claimed)
    return {b: out[b] for b in BUCKETS}


def attribute(doc: dict,
              window: Optional[tuple[int, int]] = None) -> Attribution:
    """Bucket every machine/replica/task lane's timeline. Per lane the five
    buckets sum to the window length exactly (the 1 µs acceptance bound is
    met with zero error — the arithmetic is integral)."""
    parsed = parse_trace(doc)
    lo, hi = window if window is not None else parsed.window
    rep_down, mach_down = _downtime_intervals(parsed)
    lanes: dict[str, dict[str, int]] = {}
    for lane in sorted(parsed.lanes):
        if not lane.startswith(_LANE_PREFIXES):
            continue
        lanes[lane] = _lane_buckets(lane, parsed.lanes[lane], rep_down,
                                    mach_down, lo, hi)
    totals = {b: sum(lb[b] for lb in lanes.values()) for b in BUCKETS}
    return Attribution(window_us=(lo, hi), lanes=lanes, totals=totals,
                       truncated=parsed.truncated,
                       n_dropped_ends=parsed.n_dropped_ends)


# ---------------------------------------------------------------------------
# Critical path (training)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class PathSegment:
    t0: int
    t1: int
    kind: str        # "compute" | "comm" | "wait"
    lane: str
    detail: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class CriticalPath:
    makespan_us: int
    segments: list[PathSegment]          # in time order
    explained_us: int
    explained_fraction: float
    by_kind_us: dict[str, int]

    def to_dict(self) -> dict:
        return {
            "makespan_us": self.makespan_us,
            "explained_us": self.explained_us,
            "explained_fraction": self.explained_fraction,
            "by_kind_us": dict(self.by_kind_us),
            "segments": [s.to_dict() for s in self.segments],
        }


def critical_path(doc: dict) -> Optional[CriticalPath]:
    """The chain of step phases (plus the waits between them) that determined
    a training run's makespan. Walk back from the last-finishing step phase:
    the predecessor is the latest phase ending at or before the current start
    — preferring the same task (its own previous step is the true data
    dependency), else any task (a scheduling/machine dependency). Returns
    None when the trace has no task lanes (serving traces: use
    ``latency_waterfall``)."""
    parsed = parse_trace(doc)
    phases: list[PathSegment] = []
    for lane, spans in parsed.lanes.items():
        if not lane.startswith("task/"):
            continue
        for s in spans:
            if not s.name.startswith("step"):
                continue
            comp, comm = _split_step(s)
            detail = s.name
            if s.args.get("machines") is not None:
                detail += f" on {s.args['machines']}"
            if comp[1] > comp[0]:
                phases.append(PathSegment(comp[0], comp[1], "compute", lane,
                                          detail))
            if comm[1] > comm[0]:
                phases.append(PathSegment(comm[0], comm[1], "comm", lane,
                                          detail))
    if not phases:
        return None
    makespan = max(p.t1 for p in phases)
    # deterministic ordering for the backward walk
    phases.sort(key=lambda p: (p.t1, p.t0, p.lane, p.kind))
    chain: list[PathSegment] = []
    cur = makespan
    cur_lane: Optional[str] = None
    remaining = list(phases)
    while remaining:
        eligible = [p for p in remaining if p.t1 <= cur]
        if not eligible:
            break
        same = [p for p in eligible if p.lane == cur_lane]
        pick = max(same, key=lambda p: (p.t1, p.t0)) if same \
            else max(eligible, key=lambda p: (p.t1, p.t0, p.lane))
        if pick.t1 < cur:
            chain.append(PathSegment(pick.t1, cur, "wait",
                                     cur_lane or pick.lane, "blocked"))
        chain.append(pick)
        cur = pick.t0
        cur_lane = pick.lane
        remaining = [p for p in remaining if p.t1 <= cur or p is not pick]
        if cur <= parsed.window[0]:
            break
    chain.reverse()
    explained = sum(s.t1 - s.t0 for s in chain)
    by_kind: dict[str, int] = {}
    for s in chain:
        by_kind[s.kind] = by_kind.get(s.kind, 0) + (s.t1 - s.t0)
    frac = explained / makespan if makespan > 0 else 0.0
    return CriticalPath(makespan_us=makespan, segments=chain,
                        explained_us=explained, explained_fraction=frac,
                        by_kind_us=by_kind)


# ---------------------------------------------------------------------------
# Latency waterfalls (serving)
# ---------------------------------------------------------------------------
WATERFALL_PHASES = ("dispatch", "queued", "prefill", "decode", "respond")


def latency_waterfall(doc: dict) -> dict:
    """Per-request phase breakdown: dispatch (routing + prompt transfer),
    queued, prefill, decode, respond (response transfer). The five phases sum
    to the recorded end-to-end latency exactly (integer µs). Requests whose
    replica-side spans were ring-evicted (or that never completed) are
    skipped and counted in ``n_unattributed``."""
    parsed = parse_trace(doc)
    # Completing replica attempt per rid, reconstructed from each lane's
    # lifecycle spans. ``Replica._record_done`` emits the three spans per
    # sequence adjacently (and aborted attempts emit none), so consecutive
    # (queued, prefill, decode) triples in lane order belong to one sequence;
    # the ``queued`` span carries the rid. Under retries/hedges a rid can
    # complete on several replicas — keep the attempt whose decode ends last
    # (the one the request span's completion time matches).
    attempts: dict[int, dict] = {}
    for lane, spans in parsed.lanes.items():
        if not lane.startswith("replica/"):
            continue
        seq_spans = [s for s in spans
                     if s.name in ("queued", "prefill", "decode")]
        k = 0
        while k + 2 < len(seq_spans):
            q, p, d = seq_spans[k], seq_spans[k + 1], seq_spans[k + 2]
            if (q.name, p.name, d.name) == ("queued", "prefill", "decode"):
                rid = q.args.get("rid")
                if rid is not None:
                    rid = int(rid)
                    prev = attempts.get(rid)
                    if prev is None or d.t1 >= prev["decode"].t1:
                        attempts[rid] = {"queued": q, "prefill": p,
                                         "decode": d, "lane": lane}
                k += 3
            else:
                k += 1
    requests: dict[int, dict] = {}
    n_unattributed = 0
    for s in parsed.lanes.get("requests", []):
        if s.name != "request":
            continue
        rid = s.args.get("rid")
        rid = int(rid) if rid is not None else None
        att = attempts.get(rid) if rid is not None else None
        if att is None or att["decode"].t1 > s.t1 \
                or att["queued"].t0 < s.t0:
            n_unattributed += 1
            continue
        q, p, d = att["queued"], att["prefill"], att["decode"]
        requests[rid] = {
            "t_arrival_us": s.t0,
            "latency_us": s.t1 - s.t0,
            "machine": att["lane"],
            "phases_us": {
                "dispatch": q.t0 - s.t0,
                "queued": q.t1 - q.t0,
                "prefill": p.t1 - p.t0,
                "decode": d.t1 - d.t0,
                "respond": s.t1 - d.t1,
            },
        }
    agg: dict[str, dict] = {}
    if requests:
        for phase in WATERFALL_PHASES:
            vals = sorted(r["phases_us"][phase] for r in requests.values())
            n = len(vals)
            agg[phase] = {
                "total_us": sum(vals),
                "mean_us": sum(vals) // n,
                "p50_us": vals[(n - 1) // 2],
                "p95_us": vals[min(n - 1, (95 * n) // 100)],
                "max_us": vals[-1],
            }
    return {"n_requests": len(requests), "n_unattributed": n_unattributed,
            "requests": requests, "aggregate": agg}


# ---------------------------------------------------------------------------
# Trace diff
# ---------------------------------------------------------------------------
def diff(doc_a: dict, doc_b: dict, top: int = 20) -> dict:
    """Align two runs and report the top deltas: per-lane bucket attribution
    deltas plus span-group (lane, name) count/duration deltas, sorted by
    absolute duration delta. ``a`` is the baseline; positive deltas mean
    ``b`` spent more."""
    att_a, att_b = attribute(doc_a), attribute(doc_b)

    lane_deltas = []
    for lane in sorted(set(att_a.lanes) | set(att_b.lanes)):
        a = att_a.lanes.get(lane, {b: 0 for b in BUCKETS})
        b = att_b.lanes.get(lane, {k: 0 for k in BUCKETS})
        d = {k: b[k] - a[k] for k in BUCKETS}
        if any(d.values()):
            lane_deltas.append({"lane": lane, "delta_us": d,
                                "a_us": dict(a), "b_us": dict(b)})
    lane_deltas.sort(key=lambda r: -max(abs(v) for v in
                                        r["delta_us"].values()))

    def _groups(doc):
        parsed = parse_trace(doc)
        g: dict[tuple[str, str], dict] = {}
        for lane, spans in parsed.lanes.items():
            for s in spans:
                row = g.setdefault((lane, s.name),
                                   {"count": 0, "total_us": 0})
                row["count"] += 1
                row["total_us"] += s.t1 - s.t0
        return g, parsed.window

    ga, win_a = _groups(doc_a)
    gb, win_b = _groups(doc_b)
    span_deltas = []
    for key in sorted(set(ga) | set(gb)):
        a = ga.get(key, {"count": 0, "total_us": 0})
        b = gb.get(key, {"count": 0, "total_us": 0})
        if a == b:
            continue
        span_deltas.append({
            "lane": key[0], "name": key[1],
            "count_a": a["count"], "count_b": b["count"],
            "total_us_a": a["total_us"], "total_us_b": b["total_us"],
            "delta_us": b["total_us"] - a["total_us"],
        })
    span_deltas.sort(key=lambda r: (-abs(r["delta_us"]), r["lane"],
                                    r["name"]))
    totals_delta = {k: att_b.totals[k] - att_a.totals[k] for k in BUCKETS}
    return {
        "window_a_us": list(win_a), "window_b_us": list(win_b),
        "wall_delta_us": (win_b[1] - win_b[0]) - (win_a[1] - win_a[0]),
        "totals_delta_us": totals_delta,
        "lane_deltas": lane_deltas[:top],
        "span_deltas": span_deltas[:top],
        "n_lane_deltas": len(lane_deltas),
        "n_span_deltas": len(span_deltas),
    }
