"""ctypes binding of the Hopper GCN aggregation kernel (``csrc/gcn_spmm.cu``).

Port of the Pallas TPU kernels ``scaled_spmm_blocked`` / ``spmm_blocked``
(``repro/kernels/gcn_spmm/kernel.py``). One CUDA body serves both: null scale
pointers give the plain ``A @ H``. The kernel masks its own ragged edges, so
nothing is padded here. Every argument is checked before a pointer is
handed over, and each launch adds one to ``LAUNCHES[<wrapper>]``, graph
replays included (``_graph``'s launch ledger). Where the
output tiles alone leave SMs idle the kernel splits K over a thread-block
cluster and sums the partial tiles in a fixed order, so repeated calls give
the same bits and no scratch buffer is needed.

Inputs: float32, bfloat16 or float16 features (the 2-byte types widened to
fp32 as they are staged; fp32 accumulation, output in the features' type).
``dispatch`` is the rule, a pure function: an adjacency of another type
than the features' is promoted with them (and the scales) to fp32, runs the
fp32 body and the result is cast to the features' type, which is what the
plain version computes (fp32 products, then the cast); a view that is not
dense is copied dense first. Same-typed dense inputs (the planner's calls)
copy nothing.

Forward only, like the reference: training runs the ``use_pallas=False``
path, so an input that requires grad is refused instead of silently
dropping its gradient.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _graph
from repro_torch.kernels import _build, _layout

# wrapper name -> number of kernel launches that ran on the card
LAUNCHES = _graph.register("scaled_spmm", "spmm")

_ENTRY = {torch.float32: "gcn_scaled_spmm_f32",
          torch.bfloat16: "gcn_scaled_spmm_bf16",
          torch.float16: "gcn_scaled_spmm_f16"}
_INT_MAX = 2 ** 31 - 1


def _lib() -> ctypes.CDLL:
    lib = _build.load("gcn_spmm")
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def dispatch(feats_dtype: torch.dtype, tensors) -> dict:
    """The wrapper's choices for one call, from the features' dtype and the
    operands (adj, feats, then the scales): ``body``, the entry's dtype
    (the features' when every operand has it, else float32 with
    ``promote``: every operand cast to fp32 and the result back to the
    features' type), and ``copy``: per operand, whether it is copied dense
    first (each operand needs its element's alignment only)."""
    promote = any(x.dtype != feats_dtype for x in tensors)
    return {"body": torch.float32 if promote else feats_dtype,
            "promote": promote,
            "copy": [not _layout.in_place(x, 1) for x in tensors]}


def _check(adj: torch.Tensor, feats: torch.Tensor, vecs: dict) -> None:
    if feats.dtype not in _ENTRY:
        raise TypeError(f"gcn_spmm kernel takes float32, bfloat16 or float16 "
                        f"features, got {feats.dtype}")
    if adj.dim() != 2 or feats.dim() != 2 or adj.shape[1] != feats.shape[0]:
        raise ValueError(f"need adj (M, N) and feats (N, D); got "
                         f"{tuple(adj.shape)} and {tuple(feats.shape)}")
    if any(s > _INT_MAX for s in (*adj.shape, feats.shape[1], adj.numel(),
                                  feats.numel())):
        raise ValueError("gcn_spmm kernel sizes must fit in int32")
    want_len = {"row_scale": adj.shape[0], "col_scale": adj.shape[1]}
    for name, t in {"adj": adj, "feats": feats, **vecs}.items():
        if t.device.type != "cuda" or t.device != feats.device:
            raise ValueError(f"{name} must lie on feats' CUDA device "
                             f"{feats.device}, got {t.device}")
        if name in vecs and t.dtype != feats.dtype:
            raise TypeError(f"{name} must be {feats.dtype}, got {t.dtype}")
        if t.requires_grad:
            raise RuntimeError(f"{name} requires grad, but the gcn_spmm kernel "
                               "is forward-only; train with use_pallas=False")
        if name in want_len and tuple(t.shape) != (want_len[name],):
            raise ValueError(f"{name} must have shape ({want_len[name]},), "
                             f"got {tuple(t.shape)}")


def _launch(wrapper: str, adj, feats, row_scale, col_scale) -> torch.Tensor:
    vecs = {k: v for k, v in (("row_scale", row_scale),
                              ("col_scale", col_scale)) if v is not None}
    _check(adj, feats, vecs)
    out_dtype = feats.dtype
    ops = [adj, feats, *vecs.values()]
    plan = dispatch(out_dtype, ops)
    ops = [x.clone(memory_format=torch.contiguous_format) if c else x
           for x, c in zip(ops, plan["copy"])]
    if plan["promote"]:
        ops = [x.float() for x in ops]
    adj, feats = ops[0], ops[1]
    scales = dict(zip(vecs, ops[2:]))
    row_scale, col_scale = scales.get("row_scale"), scales.get("col_scale")
    m, n = adj.shape
    d = feats.shape[1]
    out = torch.empty((m, d), dtype=feats.dtype, device=feats.device)
    if m == 0 or d == 0:
        return out.to(out_dtype)
    fn = getattr(_lib(), _ENTRY[feats.dtype])
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        err = fn(adj.data_ptr(), feats.data_ptr(), ptr(row_scale),
                 ptr(col_scale), out.data_ptr(), m, n, d, stream)
    if err != 0:
        raise RuntimeError(f"gcn_spmm kernel launch failed: cudaError {err}")
    _graph.count(wrapper)
    return out.to(out_dtype)


def scaled_spmm(adj: torch.Tensor, feats: torch.Tensor,
                row_scale: torch.Tensor, col_scale: torch.Tensor) -> torch.Tensor:
    """(diag(row_scale) @ adj @ diag(col_scale)) @ feats -> (M, D) in feats'
    dtype. adj (M, N) of any float type, feats (N, D) float32, bfloat16 or
    float16, row_scale (M,) and col_scale (N,) of feats' dtype, any layout,
    on one CUDA device."""
    return _launch("scaled_spmm", adj, feats, row_scale, col_scale)


def spmm(adj: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    """adj (M, N) @ feats (N, D) -> (M, D) in feats' dtype, fp32
    accumulation."""
    return _launch("spmm", adj, feats, None, None)
