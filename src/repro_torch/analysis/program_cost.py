"""Cost of one of the port's torch programs, priced on the meta device: the
counterpart of ``analysis.hlo_cost.analyze``, with its keys.

The reference prices the HLO that XLA lowers; the port's programs run
eagerly, op by op, so the pricer runs the program itself on meta tensors
(shapes and dtypes, no data, no device) and prices every aten op it
dispatches:

  * flops        — aten's flop formulas (``torch.utils.flop_counter``'s
                   registry):
                   2·M·N·K per matmul, convolutions, attention. Elementwise
                   work is not counted, as ``hlo_cost`` counts only dots and
                   convolutions.
  * bytes        — per op: input + output bytes, each tensor once. Eager
                   torch fuses nothing, so every op's operands and results
                   cross HBM. A view moves nothing and counts nothing. An op
                   that writes into part of a tensor (``copy_`` into a
                   slice, ``index_copy_`` of a cache slot, ``scatter_``)
                   counts its other operands twice, a read and a write, not
                   the whole destination (``hlo_cost``'s
                   dynamic-update-slice / scatter rule); one that only fills
                   its destination counts the destination once.
  * collectives  — zero: one rank's program has none. The keys are
                   ``hlo_cost``'s.
  * unknown_trip_loops — 0: Python loops run out, every iteration priced.

The hand-written kernels are ctypes calls that no dispatch mode sees; their
``ops.py`` send meta tensors to the plain functions, so the attention and
aggregation work is priced as the plain function's. Nothing here may see a
real tensor: ``measure`` refuses inputs that are not on the meta device, so
a full-width model is priced without being computed.
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch._tree import leaves

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
_DOTS = {"mm", "bmm", "addmm", "baddbmm", "matmul", "dot", "mv",
         "convolution", "_scaled_dot_product_flash_attention",
         "_scaled_dot_product_efficient_attention",
         "_scaled_dot_product_cudnn_attention"}


def _tensors(x) -> list:
    """The tensors among an op's arguments or results, each once."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _nbytes(ts) -> float:
    seen, total = set(), 0.0
    for t in ts:
        if id(t) not in seen:
            seen.add(id(t))
            total += t.numel() * t.element_size()
    return total


def _key(x):
    """A hashable stand-in for an op's arguments: tensors by their metadata,
    containers by their items, everything else as it is."""
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), x.stride(), x.dtype, x.device.type)
    if isinstance(x, (list, tuple)):
        return (type(x).__name__,) + tuple(_key(v) for v in x)
    if isinstance(x, dict):
        return ("D",) + tuple((k, _key(v)) for k, v in sorted(x.items()))
    return x


_WRITTEN: dict = {}


def _mutated(func, args, kwargs) -> list:
    """The tensors the op writes in place (its schema's written args)."""
    if func not in _WRITTEN:
        _WRITTEN[func] = [(i, a.name) for i, a in
                          enumerate(func._schema.arguments)
                          if a.alias_info is not None and a.alias_info.is_write]
    out = []
    for i, name in _WRITTEN[func]:
        out.extend(_tensors(args[i] if i < len(args) else kwargs.get(name)))
    return out


class _CostMode(TorchDispatchMode):
    """Adds every dispatched op's flops (aten's formula where it has one:
    the matmul family, convolutions, attention) and bytes, by kind (``dot``
    for the matmul family, else the aten op's name). Composite ops reach
    the mode already decomposed (an einsum as its ``bmm``), so each op is
    priced once."""

    def __init__(self, memo: bool = True):
        super().__init__()
        self.flops = 0.0
        self.by_kind: dict[str, float] = {}
        self.memo = memo
        self.results: dict = {}

    def _run(self, func, args, kwargs, written):
        """``func``'s meta result. A functional op's result (a fresh tensor,
        or a tuple of them) depends only on its inputs' metadata and its
        other arguments, so it is computed once per distinct call and
        rebuilt from shapes after: torch's meta kernels are Python, and a
        model's loops repeat the same calls many times. Views, in-place
        ops and anything else run as they are."""
        if func.is_view or written or not self.memo:
            return func(*args, **kwargs)
        try:
            key = (func, _key(args), _key(kwargs))
            hash(key)
        except TypeError:
            return func(*args, **kwargs)
        if key not in self.results:
            out = func(*args, **kwargs)
            outs = out if isinstance(out, tuple) else (out,)
            if not all(isinstance(t, torch.Tensor) for t in outs):
                self.results[key] = None
                return out
            self.results[key] = (isinstance(out, tuple), [
                (t.shape, t.stride(), t.dtype) for t in outs])
            return out
        if self.results[key] is None:
            return func(*args, **kwargs)
        is_tuple, metas = self.results[key]
        outs = tuple(torch.empty_strided(shape, stride, dtype=dtype,
                                         device="meta")
                     for shape, stride, dtype in metas)
        return outs if is_tuple else outs[0]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        written = _mutated(func, args, kwargs)
        out = self._run(func, args, kwargs, written)
        if func.is_view:
            return out
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if written:
            ids = {id(t) for t in written}
            others = [t for t in _tensors((args, kwargs)) if id(t) not in ids]
            nbytes = 2.0 * _nbytes(others) if others else _nbytes(written)
        else:
            nbytes = _nbytes(_tensors((args, kwargs))) + _nbytes(_tensors(out))
        name = func.overloadpacket.__name__
        kind = "dot" if name in _DOTS else name
        self.by_kind[kind] = self.by_kind.get(kind, 0.0) + nbytes
        return out


def measure(fn, *args, _memo: bool = True, **kwargs):
    """Run ``fn(*args, **kwargs)`` on meta tensors and price it. Returns
    (cost, fn's result); cost has ``hlo_cost.analyze``'s keys. Every tensor
    among the arguments must lie on the meta device. ``_memo=False`` runs
    every op's meta kernel (the tests hold the memo to it)."""
    off_meta = {str(t.device) for t in leaves((args, kwargs))
                if isinstance(t, torch.Tensor) and t.device.type != "meta"}
    if off_meta:
        raise ValueError(f"program_cost prices meta tensors only, got "
                         f"tensors on {sorted(off_meta)}")
    mode = _CostMode(_memo)
    with mode:
        out = fn(*args, **kwargs)
    coll = {c: 0.0 for c in _COLLECTIVES}
    cost = {
        "flops": float(mode.flops),
        "bytes": sum(mode.by_kind.values()),
        "bytes_by_kind": dict(sorted(mode.by_kind.items(),
                                     key=lambda kv: -kv[1])),
        "collectives": {"per_kind": coll, "total": 0.0,
                        "bf16_native_total": 0.0},
        "unknown_trip_loops": 0,
    }
    return cost, out


def analyze(fn, *args, **kwargs) -> dict:
    """The cost of ``fn(*args, **kwargs)`` on meta tensors (``measure``'s
    first half)."""
    return measure(fn, *args, **kwargs)[0]
