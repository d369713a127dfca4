"""Human-readable run summary from a recorded trace + metrics snapshot.

``render(recorder)`` turns one run's flight-recorder state into the text
report ``examples/trace_run.py`` prints: a per-lane table (event/span counts,
recorded busy time) and the metrics registry (counters, gauges, histogram
quantiles). ``render_trace(doc)`` produces the analytics report (attribution
buckets, critical path, latency waterfalls) from a trace document alone, so
any saved ``*.trace.json`` artifact can be analyzed after the fact:

    PYTHONPATH=src python -m repro_torch.obs.report run.trace.json
    PYTHONPATH=src python -m repro_torch.obs.report a.trace.json --diff b.trace.json

Purely derived — rendering never mutates the recorder.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.obs import analysis


def _fmt_s(us: int) -> str:
    return f"{us / 1e6:.3f}s"


def lane_table(trace_doc: dict) -> str:
    """lane | spans | async | instants | busy(sum of recorded span time)."""
    names = {ev["pid"]: ev["args"]["name"] for ev in trace_doc["traceEvents"]
             if ev["ph"] == "M" and ev["name"] == "process_name"}
    rows: dict[int, dict] = {}
    opens: dict[tuple, int] = {}
    for ev in trace_doc["traceEvents"]:
        ph = ev["ph"]
        if ph == "M":
            continue
        r = rows.setdefault(ev["pid"], {"spans": 0, "async": 0, "instants": 0,
                                        "counters": 0, "busy_us": 0})
        if ph == "X":
            r["spans"] += 1
            r["busy_us"] += ev.get("dur", 0)
        elif ph == "b":
            r["async"] += 1
            opens[(ev["pid"], ev.get("cat"), ev["id"], ev["name"])] = ev["ts"]
        elif ph == "e":
            t0 = opens.pop((ev["pid"], ev.get("cat"), ev["id"], ev["name"]),
                           None)
            if t0 is not None:
                r["busy_us"] += max(0, ev["ts"] - t0)
        elif ph == "i":
            r["instants"] += 1
        elif ph == "C":
            r["counters"] += 1
    head = (f"{'lane':<24}{'spans':>8}{'async':>8}{'instants':>10}"
            f"{'busy':>12}")
    lines = [head, "-" * len(head)]
    for pid in sorted(rows):
        r = rows[pid]
        lines.append(f"{names.get(pid, f'pid{pid}'):<24}{r['spans']:>8}"
                     f"{r['async']:>8}{r['instants']:>10}"
                     f"{_fmt_s(r['busy_us']):>12}")
    return "\n".join(lines)


def metrics_table(snapshot: dict, top: Optional[int] = None) -> str:
    lines = []
    counters = snapshot.get("counters", {})
    if counters:
        lines.append(f"{'counter':<44}{'value':>12}")
        lines.append("-" * 56)
        items = sorted(counters.items(), key=lambda kv: (-kv[1], kv[0]))
        if top:
            items = items[:top]
        for k, v in items:
            lines.append(f"{k:<44}{v:>12}")
    gauges = snapshot.get("gauges", {})
    if gauges:
        lines.append("")
        lines.append(f"{'gauge':<44}{'value':>12}")
        lines.append("-" * 56)
        for k in sorted(gauges):
            lines.append(f"{k:<44}{gauges[k]:>12.4g}")
    hists = snapshot.get("histograms", {})
    if hists:
        lines.append("")
        lines.append(f"{'histogram':<36}{'count':>8}{'p50':>10}{'p95':>10}"
                     f"{'p99':>10}")
        lines.append("-" * 74)
        for k in sorted(hists):
            h = hists[k]
            lines.append(f"{k:<36}{h['count']:>8}{h['p50']:>10.4g}"
                         f"{h['p95']:>10.4g}{h['p99']:>10.4g}")
    return "\n".join(lines) if lines else "(no metrics recorded)"


def attribution_table(att: "analysis.Attribution") -> str:
    """Per-lane bucket breakdown; every row sums to the window exactly."""
    head = (f"{'lane':<18}" + "".join(f"{b:>16}" for b in analysis.BUCKETS)
            + f"{'busy%':>8}")
    lines = [head, "-" * len(head)]
    wall = att.wall_us or 1
    for lane in sorted(att.lanes):
        b = att.lanes[lane]
        busy = 100.0 * (wall - b["idle"]) / wall
        lines.append(f"{lane:<18}"
                     + "".join(f"{_fmt_s(b[k]):>16}" for k in analysis.BUCKETS)
                     + f"{busy:>7.1f}%")
    lines.append(f"{'TOTAL':<18}"
                 + "".join(f"{_fmt_s(att.totals[k]):>16}"
                           for k in analysis.BUCKETS))
    return "\n".join(lines)


def critical_path_table(cp: "analysis.CriticalPath", top: int = 30) -> str:
    lines = [
        f"critical path: {_fmt_s(cp.explained_us)} of "
        f"{_fmt_s(cp.makespan_us)} makespan explained "
        f"({100.0 * cp.explained_fraction:.1f}%)",
        "  by kind: " + ", ".join(
            f"{k}={_fmt_s(v)}" for k, v in sorted(cp.by_kind_us.items())),
        f"{'t0':>12}{'t1':>12}{'kind':>9}  {'lane':<18}detail",
        "-" * 72,
    ]
    segs = cp.segments
    shown = segs if len(segs) <= top else segs[-top:]
    if len(segs) > top:
        lines.append(f"  ... {len(segs) - top} earlier segments elided ...")
    for s in shown:
        lines.append(f"{_fmt_s(s.t0):>12}{_fmt_s(s.t1):>12}{s.kind:>9}  "
                     f"{s.lane:<18}{s.detail}")
    return "\n".join(lines)


def waterfall_table(wf: dict) -> str:
    lines = [
        f"latency waterfalls: {wf['n_requests']} requests attributed"
        + (f", {wf['n_unattributed']} unattributed" if wf["n_unattributed"]
           else ""),
        f"{'phase':<12}{'total':>12}{'mean':>12}{'p50':>12}{'p95':>12}"
        f"{'max':>12}",
        "-" * 72,
    ]
    for phase in analysis.WATERFALL_PHASES:
        a = wf["aggregate"].get(phase)
        if a is None:
            continue
        lines.append(f"{phase:<12}{_fmt_s(a['total_us']):>12}"
                     f"{_fmt_s(a['mean_us']):>12}{_fmt_s(a['p50_us']):>12}"
                     f"{_fmt_s(a['p95_us']):>12}{_fmt_s(a['max_us']):>12}")
    return "\n".join(lines)


def diff_table(d: dict, top: int = 15) -> str:
    lines = [
        f"wall delta: {_fmt_s(d['wall_delta_us'])} "
        f"(a={_fmt_s(d['window_a_us'][1] - d['window_a_us'][0])}, "
        f"b={_fmt_s(d['window_b_us'][1] - d['window_b_us'][0])})",
        "bucket totals delta: " + (", ".join(
            f"{k}={_fmt_s(v)}" for k, v in d["totals_delta_us"].items()
            if v != 0) or "none"),
        "",
        f"top span-group deltas ({min(top, len(d['span_deltas']))} of "
        f"{d['n_span_deltas']}):",
        f"{'lane':<18}{'name':<16}{'count a/b':>12}{'total a':>12}"
        f"{'total b':>12}{'delta':>12}",
        "-" * 82,
    ]
    for r in d["span_deltas"][:top]:
        lines.append(f"{r['lane']:<18}{r['name']:<16}"
                     f"{str(r['count_a']) + '/' + str(r['count_b']):>12}"
                     f"{_fmt_s(r['total_us_a']):>12}"
                     f"{_fmt_s(r['total_us_b']):>12}"
                     f"{_fmt_s(r['delta_us']):>12}")
    return "\n".join(lines)


def render_trace(doc: dict, title: str = "trace") -> str:
    """The analytics report for a trace document alone (no recorder needed):
    lane table, attribution buckets, critical path (training traces) or
    latency waterfalls (serving traces)."""
    att = analysis.attribute(doc)
    parts = [
        f"== trace analytics: {title} ==",
        "",
        lane_table(doc),
        "",
        attribution_table(att),
    ]
    if att.truncated:
        parts.insert(1, f"(ring-truncated trace: window starts at "
                        f"{_fmt_s(att.window_us[0])}, "
                        f"{att.n_dropped_ends} orphan async ends dropped)")
    cp = analysis.critical_path(doc)
    if cp is not None:
        parts += ["", critical_path_table(cp)]
    wf = analysis.latency_waterfall(doc)
    if wf["n_requests"] or wf["n_unattributed"]:
        parts += ["", waterfall_table(wf)]
    return "\n".join(parts)


def render(recorder, title: str = "run") -> str:
    """The full report for an enabled ``obs.Recorder``."""
    doc = recorder.trace.to_chrome()
    n_ev = len([e for e in doc["traceEvents"] if e["ph"] != "M"])
    parts = [
        f"== obs report: {title} ==",
        f"trace events: {n_ev} recorded"
        + (f" ({recorder.trace.n_emitted} emitted, ring-buffered)"
           if doc["metadata"]["truncated"] else ""),
        "",
        lane_table(doc),
        "",
        metrics_table(recorder.metrics.snapshot()),
    ]
    return "\n".join(parts)


def main(argv=None) -> int:
    """``python -m repro_torch.obs.report <trace.json> [--diff other.trace.json]``"""
    import argparse
    import json

    from repro_torch.obs import schema

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Print attribution + critical-path/waterfall analytics "
                    "for a saved trace artifact.")
    ap.add_argument("trace", help="path to a *.trace.json artifact")
    ap.add_argument("--diff", default=None, metavar="OTHER",
                    help="second trace: report top deltas (trace is the "
                         "baseline)")
    ap.add_argument("--json", action="store_true",
                    help="emit machine-readable JSON instead of tables")
    args = ap.parse_args(argv)

    with open(args.trace, "rb") as f:
        doc = schema.validate_bytes(f.read())
    if args.diff is not None:
        with open(args.diff, "rb") as f:
            other = schema.validate_bytes(f.read())
        d = analysis.diff(doc, other)
        print(json.dumps(d, sort_keys=True) if args.json
              else f"== trace diff: {args.trace} -> {args.diff} ==\n"
                   + diff_table(d))
        return 0
    if args.json:
        out = {"attribution": analysis.attribute(doc).to_dict()}
        cp = analysis.critical_path(doc)
        if cp is not None:
            out["critical_path"] = cp.to_dict()
        wf = analysis.latency_waterfall(doc)
        if wf["n_requests"] or wf["n_unattributed"]:
            wf = dict(wf)
            wf["requests"] = {str(k): v for k, v in wf["requests"].items()}
            out["waterfall"] = wf
        print(json.dumps(out, sort_keys=True))
    else:
        print(render_trace(doc, title=args.trace))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
