"""Loop-aware HLO cost analysis.

``compiled.cost_analysis()`` counts while-loop bodies ONCE (verified:
scan(10 x matmul) reports the FLOPs of one matmul), which silently
undercounts every scanned segment, chunk scan and their embedded FSDP
all-gathers. This module re-derives per-device cost from the optimized HLO
text, multiplying loop bodies by their trip counts
(``backend_config={"known_trip_count":{"n":...}}``).

Model:
  * flops        — 2·|out|·|contraction| per ``dot`` (+ depthwise conv
                   approximation); dots inside fused computations counted.
  * bytes        — per top-level op: operand + output bytes. Fusion
                   internals are NOT counted (the fusion's operands/outputs
                   are the HBM traffic — closer to truth than XLA's
                   every-op sum).
  * collectives  — output bytes per all-gather / all-reduce /
                   reduce-scatter / all-to-all / collective-permute,
                   multiplied by enclosing trip counts.

A verbatim copy of ``repro/analysis/hlo_cost.py`` (it needs only ``re`` and
``dataclasses``): it prices HLO text that the reference lowers. The port's
own torch programs are priced by ``analysis/program_cost.py``, which gives
the same keys.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s4": 1, "u4": 1, "s16": 2, "u16": 2,
    "s32": 4, "u32": 4, "s64": 8, "u64": 8, "f16": 2, "bf16": 2, "f32": 4,
    "f64": 8, "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1,
}
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
# "  %name = f32[1,2]{1,0} op-name(%a, %b), attr=..."
_OP_RE = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*(.+?)\s+([\w\-]+)\((.*)$")
_COMP_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\((.*?)\)\s*->")
_TRIP_RE = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')
_CALLS_RE = re.compile(r"calls=%?([\w.\-]+)")
_COND_BODY_RE = re.compile(r"condition=%?([\w.\-]+),\s*body=%?([\w.\-]+)")


def _shape_dims(shape_str: str) -> list[tuple[str, list[int]]]:
    out = []
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        if dtype not in _DTYPE_BYTES:
            continue
        out.append((dtype, [int(d) for d in dims.split(",") if d]))
    return out


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for dtype, dims in _shape_dims(shape_str):
        n = 1
        for d in dims:
            n *= d
        total += n * _DTYPE_BYTES[dtype]
    return total


def _first_operands(rest: str) -> list[str]:
    """Operand names from the op's argument list (up to the closing paren of
    the first call — operands are plain %names / constants)."""
    depth = 0
    args = []
    cur = []
    for ch in rest:
        if ch == ")" and depth == 0:
            break
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            args.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if cur:
        args.append("".join(cur).strip())
    # an operand is "%name" on current jax, "f32[256,256]{1,0} %name" on
    # older releases that print typed operands — grab the %name either way
    out = []
    for a in args:
        m = re.search(r"%([\w.\-]+)", a.strip())
        if m:
            out.append(m.group(1))
    return out


@dataclasses.dataclass
class _Op:
    name: str
    shape: str
    kind: str
    operands: list[str]
    line: str


@dataclasses.dataclass
class _Computation:
    name: str
    ops: list[_Op]
    shapes: dict[str, str]


def _parse(text: str) -> dict[str, _Computation]:
    comps: dict[str, _Computation] = {}
    cur: Optional[_Computation] = None
    for raw in text.splitlines():
        line = raw.rstrip()
        if not line:
            continue
        if not line.startswith(" ") and ("->" in line) and line.endswith("{"):
            m = _COMP_RE.match(line.strip())
            if m:
                cur = _Computation(m.group(1), [], {})
                comps[cur.name] = cur
                # parameter shapes from the header
                for pname, pshape in re.findall(r"([\w.\-]+):\s*([\w\[\],]+)",
                                                m.group(2)):
                    cur.shapes[pname] = pshape
            continue
        if line.strip() == "}":
            cur = None
            continue
        if cur is None:
            continue
        m = _OP_RE.match(line)
        if not m:
            continue
        name, shape, kind, rest = m.groups()
        op = _Op(name, shape, kind, _first_operands(rest), line)
        cur.ops.append(op)
        cur.shapes[name] = shape
    return comps


def _dot_flops(op: _Op, shapes: dict[str, str]) -> float:
    out_elems = 1.0
    for _, dims in _shape_dims(op.shape):
        for d in dims:
            out_elems *= d
    m = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", op.line)
    if not m or not op.operands:
        return 2.0 * out_elems  # degenerate
    lhs_shape = shapes.get(op.operands[0], "")
    dims_list = _shape_dims(lhs_shape)
    if not dims_list:
        return 2.0 * out_elems
    lhs_dims = dims_list[0][1]
    k = 1.0
    for idx in (int(i) for i in m.group(1).split(",") if i):
        if idx < len(lhs_dims):
            k *= lhs_dims[idx]
    return 2.0 * out_elems * k


def _conv_flops(op: _Op) -> float:
    out_elems = 1.0
    for _, dims in _shape_dims(op.shape):
        for d in dims:
            out_elems *= d
    m = re.search(r"window=\{size=([\dx]+)", op.line)
    k = 1.0
    if m:
        for d in m.group(1).split("x"):
            k *= int(d)
    return 2.0 * out_elems * k


ZERO = {"flops": 0.0, "bytes": 0.0, "collective_bf16_native": 0.0,
        **{c: 0.0 for c in _COLLECTIVES}}


def _bf16_native_bytes(shape_str: str) -> float:
    """Collective bytes under TPU-native bf16 compute: the CPU backend
    upcasts bf16 operands to f32 before partitioned dots, so the lowered
    HLO's weight/activation collectives are f32 — 2x what a TPU (native
    bf16 MXU) would move. Rule: wide (>=2-dim) f32 arrays count at bf16
    width; scalars/1-d (optimizer stats, loss reductions) stay f32. The
    deliberately-f32 wide tensors (attention scores) never cross
    collectives, so the rule is exact for this codebase."""
    total = 0.0
    for dtype, dims in _shape_dims(shape_str):
        n = 1
        for d in dims:
            n *= d
        width = _DTYPE_BYTES[dtype]
        if dtype == "f32" and len(dims) >= 2:
            width = 2
        total += n * width
    return total


def _fusion_flops(comp: _Computation, comps) -> float:
    """dots/convs inside a fused computation (no bytes, no recursion into
    further calls — fusions don't nest loops)."""
    f = 0.0
    for op in comp.ops:
        if op.kind == "dot":
            f += _dot_flops(op, comp.shapes)
        elif op.kind == "convolution":
            f += _conv_flops(op)
    return f


_SLICE_LIKE = ("dynamic-slice", "slice", "gather")


def _fusion_bytes(called: _Computation, op: _Op,
                  outer_shapes: dict[str, str]) -> float:
    """HBM traffic of a fusion = output write + per-operand reads, where an
    operand consumed ONLY through (dynamic-)slice/gather inside the fused
    computation contributes the slice bytes, not the full array. This is
    what keeps scan-stacked parameter tensors (sliced per loop iteration)
    from being counted at full size every iteration."""
    total = _acct_bytes(op.shape)
    # parameter index -> name inside the fused computation
    params: dict[int, str] = {}
    for o in called.ops:
        if o.kind == "parameter":
            m = re.search(r"parameter\((\d+)\)", o.line)
            if m:
                params[int(m.group(1))] = o.name
    for idx, operand in enumerate(op.operands):
        oshape = outer_shapes.get(operand, "")
        full = _acct_bytes(oshape)
        pname = params.get(idx)
        if pname is None:
            total += full
            continue
        consumers = [o for o in called.ops if pname in o.operands]
        if consumers and all(
                c.kind in _SLICE_LIKE
                or (c.kind == "dynamic-update-slice"
                    and c.operands and c.operands[0] == pname)
                for c in consumers):
            eff = 0.0
            for c in consumers:
                if c.kind == "dynamic-update-slice":
                    upd = c.operands[1] if len(c.operands) > 1 else None
                    eff += _acct_bytes(called.shapes.get(upd, "")) * 2
                else:
                    eff += _acct_bytes(c.shape)
            total += min(eff, full)
        else:
            total += full
    return total


def _comp_cost(comp: _Computation, comps, memo) -> tuple:
    """Returns (totals dict, bytes-by-op-kind dict); memoized per comp."""
    if comp.name in memo:
        return memo[comp.name]
    bykind: dict = {}

    def note(kind, nbytes):
        bykind[kind] = bykind.get(kind, 0.0) + nbytes

    total = dict(ZERO)
    total["unknown_trip_loops"] = 0.0
    for op in comp.ops:
        if op.kind == "dot":
            total["flops"] += _dot_flops(op, comp.shapes)
            b = _op_bytes(op, comp.shapes)
            total["bytes"] += b
            note("dot", b)
        elif op.kind == "convolution":
            total["flops"] += _conv_flops(op)
            b = _op_bytes(op, comp.shapes)
            total["bytes"] += b
            note("convolution", b)
        elif op.kind == "fusion":
            m = _CALLS_RE.search(op.line)
            if m and m.group(1) in comps:
                called = comps[m.group(1)]
                total["flops"] += _fusion_flops(called, comps)
                b = _fusion_bytes(called, op, comp.shapes)
                total["bytes"] += b
                note("fusion", b)
            else:
                b = _op_bytes(op, comp.shapes)
                total["bytes"] += b
                note("fusion", b)
        elif op.kind == "while":
            m = _COND_BODY_RE.search(op.line)
            t = _TRIP_RE.search(op.line)
            trip = float(t.group(1)) if t else 1.0
            if not t:
                total["unknown_trip_loops"] += 1
            if m:
                body, body_k = _comp_cost(comps[m.group(2)], comps, memo)
                cond, _ = _comp_cost(comps[m.group(1)], comps, memo)
                for k in total:
                    total[k] += trip * body.get(k, 0.0) \
                        + (trip + 1) * cond.get(k, 0.0)
                for k, v in body_k.items():
                    note(k, trip * v)
        elif op.kind in ("call", "async-start"):
            m = _CALLS_RE.search(op.line)
            if m and m.group(1) in comps:
                sub, sub_k = _comp_cost(comps[m.group(1)], comps, memo)
                for k in total:
                    total[k] += sub.get(k, 0.0)
                for k, v in sub_k.items():
                    note(k, v)
        elif op.kind == "conditional":
            # conservative: max cost over branches
            branches = re.findall(r"(?:branch_computations=\{([^}]*)\}|"
                                  r"true_computation=%?([\w.\-]+),\s*"
                                  r"false_computation=%?([\w.\-]+))", op.line)
            names = []
            for tup in branches:
                for part in tup:
                    if part:
                        names.extend(n.strip().lstrip("%")
                                     for n in part.split(","))
            best = dict(ZERO)
            for n in names:
                if n in comps:
                    c, _ = _comp_cost(comps[n], comps, memo)
                    if c["flops"] + c["bytes"] > best["flops"] + best["bytes"]:
                        best = c
            for k in total:
                total[k] += best.get(k, 0.0)
        else:
            base = None
            for c in _COLLECTIVES:
                if op.kind == c or op.kind.startswith(c + "-"):
                    base = c
                    break
            if base is not None and not op.kind.endswith("-done"):
                total[base] += _shape_bytes(op.shape)
                total["collective_bf16_native"] += _bf16_native_bytes(op.shape)
                b = _op_bytes(op, comp.shapes)
                total["bytes"] += b
                note(base, b)
            elif op.kind not in ("parameter", "constant", "tuple",
                                 "get-tuple-element", "bitcast"):
                b = _op_bytes(op, comp.shapes)
                total["bytes"] += b
                note(op.kind, b)
    memo[comp.name] = (total, bykind)
    return total, bykind


# Optional global predicate: shapes for which HBM traffic is suppressed
# (used for the "Pallas flash attention on TPU" roofline estimate — score
# tensors stay VMEM-resident inside the kernel). Set via analyze(...,
# exclude_pred=...).
_EXCLUDE_PRED = None
# TPU-native byte widths: wide f32 arrays (CPU-backend upcasts of bf16
# operands around partitioned dots) count at bf16 width. Set via
# analyze(..., tpu_native=True).
_NATIVE = False


def _width(dtype: str, dims) -> int:
    if _NATIVE and dtype == "f32" and len(dims) >= 2:
        return 2
    return _DTYPE_BYTES[dtype]


def _acct_bytes(shape_str: str) -> float:
    """Accounting bytes of a shape: native-width aware, exclusions applied."""
    b = 0.0
    for dtype, dims in _shape_dims(shape_str):
        if _EXCLUDE_PRED is not None and _EXCLUDE_PRED(dtype, dims):
            continue
        n = 1
        for d in dims:
            n *= d
        b += n * _width(dtype, dims)
    return b


def _op_bytes(op: _Op, shapes: dict[str, str]) -> float:
    # slice-like ops touch only the slice, not the operand
    if op.kind in ("dynamic-slice", "slice", "gather"):
        return 2.0 * _acct_bytes(op.shape)
    if op.kind == "dynamic-update-slice":
        upd = op.operands[1] if len(op.operands) > 1 else None
        return 2.0 * _acct_bytes(shapes.get(upd, ""))
    if op.kind == "scatter":
        upd = op.operands[2] if len(op.operands) > 2 else None
        return 2.0 * _acct_bytes(shapes.get(upd, ""))
    b = _acct_bytes(op.shape)
    for o in op.operands:
        b += _acct_bytes(shapes.get(o, ""))
    return max(b, 0.0)


def analyze(hlo_text: str, exclude_pred=None, tpu_native=False) -> dict:
    """Per-device totals with loop trip counts applied. Returns
    {flops, bytes, bytes_by_kind, collectives, unknown_trip_loops}.

    exclude_pred(dtype_str, dims) -> True suppresses that shape's HBM
    traffic everywhere (VMEM-resident kernel estimate). tpu_native=True
    counts wide f32 arrays (CPU-backend bf16->f32 upcasts) at bf16 width."""
    global _EXCLUDE_PRED, _NATIVE
    _EXCLUDE_PRED = exclude_pred
    _NATIVE = tpu_native
    comps = _parse(hlo_text)
    entry = None
    # entry = computation whose name none reference as calls/body/cond;
    # simpler: the one defined on the line starting with ENTRY
    m = re.search(r"^ENTRY\s+%?([\w.\-]+)", hlo_text, re.M)
    if m:
        entry = m.group(1)
    if entry is None or entry not in comps:
        # fall back: last computation
        entry = list(comps)[-1]
    memo: dict = {}
    try:
        total, bykind = _comp_cost(comps[entry], comps, memo)
    finally:
        _EXCLUDE_PRED = None
        _NATIVE = False
    coll = {c: total[c] for c in _COLLECTIVES}
    return {
        "flops": total["flops"],
        "bytes": total["bytes"],
        "bytes_by_kind": dict(sorted(bykind.items(),
                                     key=lambda kv: -kv[1])),
        "collectives": {"per_kind": coll, "total": sum(coll.values()),
                        "bf16_native_total": total["collective_bf16_native"]},
        "unknown_trip_loops": int(total["unknown_trip_loops"]),
    }
