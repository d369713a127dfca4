"""Roofline terms from a priced program (no hardware needed). Port of
``repro/analysis/roofline.py``.

  compute term    = FLOPs  / (chips x peak_FLOP/s)
  memory term     = bytes  / (chips x HBM_bw)
  collective term = collective_bytes / (chips x link_bw)

Sources: the reference reads FLOPs and bytes from ``compiled.cost_analysis()``
and collective bytes from the optimized HLO text (``collective_bytes`` below
is that parser, verbatim); the port prices its torch programs with
``analysis.program_cost``, which gives the same keys.

Hardware constants: the port's card, one NVIDIA H100 SXM (80 GB HBM3,
700 W), from NVIDIA's data sheet: 989 TFLOP/s dense bf16 on the tensor
cores, 3.35 TB/s HBM3, 80 GB. The link figure is NVLink 4's 900 GB/s per
GPU counted both directions together, so 450 GB/s each way. The reference's
TPU v5e figures (197 TFLOP/s, 819 GB/s, ~50 GB/s/link ICI, 16 GB) are not
the port's: a caller that wants them passes them explicitly.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np

from repro_torch._tree import map_with_path


@dataclasses.dataclass(frozen=True)
class HW:
    peak_flops: float = 989e12      # bf16 dense per card (H100 SXM)
    hbm_bw: float = 3.35e12         # bytes/s per card (HBM3)
    ici_bw: float = 450e9           # bytes/s per card each way (NVLink 4)
    hbm_gb: float = 80.0


_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "s32": 4, "u32": 4,
    "s64": 8, "u64": 8, "f16": 2, "bf16": 2, "f32": 4, "f64": 8,
    "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1,
}

# e.g. "bf16[16,4096,128]{2,1,0}" or "f32[]"
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def collective_bytes(hlo_text: str) -> dict:
    """Sum *output* operand bytes of every collective op in the optimized
    HLO (per-device shapes post-SPMD). Returns {op_kind: bytes, 'total': ...,
    'count': {...}}."""
    per_kind: dict[str, float] = {k: 0.0 for k in _COLLECTIVES}
    counts: dict[str, int] = {k: 0 for k in _COLLECTIVES}
    for line in hlo_text.splitlines():
        s = line.strip()
        # "name = TYPE[shape] all-reduce(...)" / "... all-gather-start(...)"
        m = re.match(r"%?[\w.\-]+\s*=\s*(.+?)\s+([\w\-]+)\(", s)
        if not m:
            continue
        shape_str, op = m.group(1), m.group(2)
        base = None
        for c in _COLLECTIVES:
            if op == c or op.startswith(c + "-"):   # -start/-done variants
                base = c
                break
        if base is None:
            continue
        if op.endswith("-done"):
            continue                                 # counted at -start
        nbytes = _shape_bytes(shape_str)
        per_kind[base] += nbytes
        counts[base] += 1
    total = sum(per_kind.values())
    return {"per_kind": per_kind, "count": counts, "total": total}


def model_flops(n_params_active: float, tokens: float,
                kind: str = "train") -> float:
    """6·N·D for train; 2·N per generated token for decode."""
    if kind == "train":
        return 6.0 * n_params_active * tokens
    return 2.0 * n_params_active * tokens


def roofline_report(cost: dict, coll: dict, n_chips: int,
                    model_flops_total: Optional[float] = None,
                    hw: HW = HW()) -> dict:
    """cost = {'flops':, 'bytes':/'bytes accessed':} per-device, coll =
    collective bytes dict. All times in seconds."""
    flops_dev = float(cost.get("flops", 0.0))
    bytes_dev = float(cost.get("bytes", cost.get("bytes accessed", 0.0)))
    # native bf16 collective width when available (the reference's CPU
    # backend upcasts wide bf16 operands to f32 before partitioned
    # collectives)
    coll_raw = float(coll["total"])
    coll_dev = float(coll.get("bf16_native_total", coll_raw))
    t_compute = flops_dev / hw.peak_flops
    t_memory = bytes_dev / hw.hbm_bw
    t_collective = coll_dev / hw.ici_bw
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_collective}
    bottleneck = max(terms, key=terms.get)
    out = {
        "per_device": {"flops": flops_dev, "bytes": bytes_dev,
                       "collective_bytes": coll_dev,
                       "collective_bytes_raw_f32": coll_raw},
        "seconds": terms,
        "collective_raw_s": coll_raw / hw.ici_bw,
        "bottleneck": bottleneck,
        "step_time_lower_bound_s": max(terms.values()),
    }
    if model_flops_total:
        hlo_total = flops_dev * n_chips
        out["model_flops"] = model_flops_total
        out["useful_fraction"] = (model_flops_total / hlo_total
                                  if hlo_total else 0.0)
        # roofline fraction: useful FLOPs over the time the dominant term
        # forces, vs the chip's peak
        t_star = max(terms.values())
        out["roofline_fraction"] = (
            (model_flops_total / n_chips / t_star) / hw.peak_flops
            if t_star > 0 else 0.0)
    return out


def active_params(cfg) -> float:
    """Active parameters per token (MoE counts shared + top_k experts only;
    embeddings included once), from the meta-device param tree, summed in
    the reference's leaf order (dict keys sorted)."""
    from repro_torch.launch.specs import param_struct

    sizes = []
    map_with_path(lambda path, leaf: sizes.append((path, leaf.shape)),
                  param_struct(cfg))
    moe_spec = _find_moe_spec(cfg)
    total = 0.0
    for path, shape in sorted(sizes):
        names = [str(p) for p in path]
        size = float(np.prod(shape))
        if "moe" in "/".join(names) and names[-1] in ("w_up", "w_gate",
                                                      "w_down"):
            # (count?, E, d, f): scale by top_k/E
            if moe_spec is not None:
                size *= moe_spec.top_k / moe_spec.n_experts
        total += size
    return total


def _find_moe_spec(cfg):
    for seg in cfg.segments:
        for l in seg.layers:
            if l.moe is not None:
                return l.moe
    return None
