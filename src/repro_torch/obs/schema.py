"""JSON-schema check for exported traces (CI trace-smoke + tests).

The container has no ``jsonschema`` package, so the check is a small
hand-rolled validator over ``TRACE_SCHEMA`` — a JSON-Schema-shaped document
kept as the single human-readable description of the trace format
(docs/OBSERVABILITY.md embeds the same contract in prose).
"""
from __future__ import annotations

from typing import Iterable

TRACE_SCHEMA = {
    "$id": "repro.obs/trace",
    "type": "object",
    "required": ["traceEvents", "displayTimeUnit", "metadata"],
    "properties": {
        "displayTimeUnit": {"enum": ["ms", "ns"]},
        "metadata": {
            "type": "object",
            "required": ["schema", "clock"],
            "properties": {
                "schema": {"const": "repro.obs/1"},
                "clock": {"const": "sim_time_us"},
            },
        },
        "traceEvents": {
            "type": "array",
            "items": {
                "type": "object",
                "required": ["ph", "name", "pid", "tid"],
                "properties": {
                    "ph": {"enum": ["X", "B", "E", "b", "e", "i", "C", "M"]},
                    "name": {"type": "string"},
                    "cat": {"type": "string"},
                    "pid": {"type": "integer", "minimum": 0},
                    "tid": {"type": "integer", "minimum": 0},
                    "ts": {"type": "integer", "minimum": 0},
                    "dur": {"type": "integer", "minimum": 0},
                    "id": {"type": "string"},
                    "args": {"type": "object"},
                },
            },
        },
    },
}

_PHASES = frozenset(TRACE_SCHEMA["properties"]["traceEvents"]["items"]
                    ["properties"]["ph"]["enum"])
_META_NAMES = frozenset({"process_name", "process_sort_index", "thread_name",
                         "thread_sort_index"})


class TraceSchemaError(ValueError):
    pass


def _fail(path: str, msg: str) -> None:
    raise TraceSchemaError(f"{path}: {msg}")


def _check_event(ev, k: int) -> None:
    path = f"traceEvents[{k}]"
    if not isinstance(ev, dict):
        _fail(path, "event is not an object")
    for key in ("ph", "name", "pid", "tid"):
        if key not in ev:
            _fail(path, f"missing required key {key!r}")
    ph = ev["ph"]
    if ph not in _PHASES:
        _fail(path, f"unknown phase {ph!r}")
    if not isinstance(ev["name"], str):
        _fail(path, "name must be a string")
    for key in ("pid", "tid"):
        if not isinstance(ev[key], int) or isinstance(ev[key], bool) \
                or ev[key] < 0:
            _fail(path, f"{key} must be a non-negative integer")
    if ph != "M":
        if not isinstance(ev.get("ts"), int) or ev["ts"] < 0:
            _fail(path, "ts must be a non-negative integer (microseconds)")
    if ph == "X":
        if not isinstance(ev.get("dur"), int) or ev["dur"] < 0:
            _fail(path, "complete event needs a non-negative integer dur")
    if ph in ("b", "e"):
        if not isinstance(ev.get("id"), str):
            _fail(path, "async event needs a string id")
        if not isinstance(ev.get("cat"), str):
            _fail(path, "async event needs a cat (Perfetto groups by it)")
    if ph == "M" and ev["name"] not in _META_NAMES:
        _fail(path, f"unknown metadata event {ev['name']!r}")
    if "args" in ev and not isinstance(ev["args"], dict):
        _fail(path, "args must be an object")


def validate(trace: dict, strict: "bool | None" = None) -> None:
    """Raise ``TraceSchemaError`` unless ``trace`` conforms to TRACE_SCHEMA
    plus the cross-event invariants (balanced async pairs, named lanes).

    ``strict`` controls the async-balance check. ``None`` (the default)
    derives it from ``metadata.truncated``: a ring-buffered trace may have
    evicted the ``"b"`` of a pair whose ``"e"`` survived, so unmatched ends
    are tolerated there — but a dangling ``"b"`` (begin without end) is
    still an error in both modes, because FIFO eviction can only drop a
    prefix of the event stream and ``async_span`` emits b/e adjacently.
    Pass ``strict=True`` to reject any imbalance (untruncated traces), or
    ``strict=False`` to force the lenient window check."""
    if not isinstance(trace, dict):
        _fail("$", "trace is not an object")
    for key in TRACE_SCHEMA["required"]:
        if key not in trace:
            _fail("$", f"missing required key {key!r}")
    if trace["displayTimeUnit"] not in ("ms", "ns"):
        _fail("displayTimeUnit", f"bad value {trace['displayTimeUnit']!r}")
    meta = trace["metadata"]
    if not isinstance(meta, dict):
        _fail("metadata", "not an object")
    if meta.get("schema") != "repro.obs/1":
        _fail("metadata.schema", f"unsupported schema {meta.get('schema')!r}")
    if meta.get("clock") != "sim_time_us":
        _fail("metadata.clock", f"unsupported clock {meta.get('clock')!r}")
    events = trace["traceEvents"]
    if not isinstance(events, list):
        _fail("traceEvents", "not an array")
    if strict is None:
        strict = not bool(meta.get("truncated"))

    named_pids: set[int] = set()
    open_async: dict[tuple, int] = {}
    for k, ev in enumerate(events):
        _check_event(ev, k)
        if ev["ph"] == "M" and ev["name"] == "process_name":
            named_pids.add(ev["pid"])
        elif ev["ph"] == "b":
            key = (ev["pid"], ev.get("cat"), ev["id"], ev["name"])
            open_async[key] = open_async.get(key, 0) + 1
        elif ev["ph"] == "e":
            key = (ev["pid"], ev.get("cat"), ev["id"], ev["name"])
            if open_async.get(key, 0) <= 0:
                if strict:
                    _fail(f"traceEvents[{k}]",
                          f"async end without begin: {key}")
                # lenient: the begin was ring-evicted; don't let the orphan
                # end mask a later real imbalance on the same key
                continue
            open_async[key] -= 1
    dangling = [k for k, v in open_async.items() if v != 0]
    if dangling:
        # begins without ends are a recording bug in BOTH modes: eviction
        # drops the oldest events first, so a surviving "b" implies its
        # adjacent "e" survived too
        _fail("traceEvents", f"unbalanced async spans: {dangling[:3]}")
    used = {ev["pid"] for ev in events if ev["ph"] != "M"}
    unnamed = used - named_pids
    if unnamed:
        _fail("traceEvents",
              f"events on unnamed lanes (no process_name): {sorted(unnamed)[:5]}")


def validate_bytes(data: bytes) -> dict:
    """Parse + validate a serialized trace; returns the parsed document."""
    import json
    try:
        doc = json.loads(data)
    except json.JSONDecodeError as e:
        raise TraceSchemaError(f"not valid JSON: {e}") from e
    validate(doc)
    return doc


def lanes(trace: dict) -> Iterable[str]:
    """The named lanes (process_name metadata) of a validated trace."""
    return sorted(ev["args"]["name"] for ev in trace["traceEvents"]
                  if ev["ph"] == "M" and ev["name"] == "process_name")
