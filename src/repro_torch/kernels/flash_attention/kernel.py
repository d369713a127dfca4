"""ctypes bindings of the Hopper flash-attention kernels
(``csrc/flash_attention.cu``): the forward and its backward.

Port of the Pallas TPU kernel ``flash_attention_bhsd``
(``repro/kernels/flash_attention/kernel.py``). The kernel reads the model
layout and masks its own ragged edges, so nothing is transposed or padded
here. Every argument is checked before a pointer is handed over, and each
launch adds one to ``LAUNCHES["flash_attention"]``. The source holds two
bodies: bf16 runs on the tensor cores, fp32 on the FMA pipe (which keeps the
fp32 tolerance); the C entry point picks one by type. The forward can also
return the per-row log-sum-exp (fp32, (B, H, S)) that ``flash_attention_bwd``
reads; each backward call (bf16: a prep pass, dK/dV, dQ and, when H > KV, the
sum of the heads' partials; fp32: delta, dK/dV, dQ) adds one to
``LAUNCHES["flash_attention_bwd"]``.

Head dim 96 (phi3-mini), which the forward and the fp32 backward have no
instantiation for, is padded here with zero columns to 128, and the kernels
get the true D^-0.5: zero q and k columns leave the scores as they are, zero
v and dO columns give output and gradient columns that are sliced off. The
bf16 backward takes the unpadded tensors: its copies fill the columns past
D with zeros in shared memory.

These wrappers are not differentiable: an input that requires grad is
refused instead of silently dropping its gradient. ``ops.flash_attention``
wraps them in an ``autograd.Function`` for training.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# wrapper name -> number of kernel launches made through it
LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0}

_ENTRY = {torch.float32: "flash_attention_fwd_f32",
          torch.bfloat16: "flash_attention_fwd_bf16"}
_BWD_ENTRY = {torch.float32: "flash_attention_bwd_f32",
              torch.bfloat16: "flash_attention_bwd_bf16"}
HEAD_DIMS = (16, 32, 64, 96, 128, 256)
_INT_MAX = 2 ** 31 - 1
_GRID_MAX = 65535   # gridDim.y (heads) and gridDim.z (batch)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    # forward: q, k, v, o, lse; backward: q, k, v, o, do, lse, stats, part,
    # dq, dk, dv; then 8 ints, the scale and the stream
    for entries, n_ptr in ((_ENTRY, 5), (_BWD_ENTRY, 11)):
        for name in entries.values():
            fn = getattr(lib, name)
            if fn.argtypes is None:
                fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 8 \
                    + [ctypes.c_float, ctypes.c_void_p]
                fn.restype = ctypes.c_int
    return lib


def _fwd_width(d: int) -> int:
    """The head dim the kernels run ``d`` at: 96 pads to 128."""
    return 128 if d == 96 else d


def _pad(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x`` with zero columns up to ``width`` on its last axis."""
    if x.shape[-1] == width:
        return x
    return torch.nn.functional.pad(x, (0, width - x.shape[-1])).contiguous()


def _check(q, k, v, causal: bool, window) -> None:
    if q.dtype not in _ENTRY:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"need q (B, S, H, D) and k/v (B, T, KV, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    if kvh == 0 or h % kvh:
        raise ValueError(f"query heads {h} must be a multiple of kv heads {kvh}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if causal and window is not None and s > t:
        raise ValueError(f"causal window attention needs S <= T (got S {s}, "
                         f"T {t}): later rows would see no key")
    if b > _GRID_MAX or h > _GRID_MAX or any(
            n > _INT_MAX for n in (s, t, q.numel(), k.numel())):
        raise ValueError("flash_attention kernel sizes out of range")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device {q.device}, "
                             f"got {x.device}")
        if x.dtype != q.dtype:
            raise TypeError(f"{name} must be {q.dtype}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.requires_grad:
            raise RuntimeError(f"{name} requires grad, but the flash_attention "
                               "kernel is forward-only")
        if x.dtype == torch.bfloat16 and x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary: the "
                             "bf16 kernel moves its tiles by 16-byte cp.async")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None, return_lse: bool = False):
    """q (B, S, H, D); k/v (B, T, KV, D), one dtype (float32 or bfloat16),
    contiguous, on one CUDA device -> o (B, S, H, D) in q's dtype, and with
    ``return_lse`` also the rows' log-sum-exp of the scaled scores, fp32
    (B, H, S)."""
    _check(q, k, v, causal, window)
    out = torch.empty_like(q)
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if out.numel() == 0 or t == 0:
        out.zero_()
        return (out, lse.fill_(-1e30)) if return_lse else out
    fn = getattr(_lib(), _ENTRY[q.dtype])
    dp = _fwd_width(d)
    q, k, v = (_pad(x, dp) for x in (q, k, v))
    res = out if dp == d else torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), res.data_ptr(),
                 None if lse is None else lse.data_ptr(),
                 b, s, t, h, kvh, dp, int(causal),
                 -1 if window is None else int(window), d ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    LAUNCHES["flash_attention"] += 1
    if res is not out:
        out.copy_(res[..., :d])
    return (out, lse) if return_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True, window=None):
    """The gradient of ``flash_attention``: q, o, do (B, S, H, D); k/v
    (B, T, KV, D); lse the forward's fp32 (B, H, S) -> (dq, dk, dv) in the
    inputs' layout and dtype, contiguous. Refuses a shape where some query
    row sees no key (its forward is a uniform average, whose gradient the
    kernel does not rebuild)."""
    _check(q, k, v, causal, window)
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    for name, x in (("o", o), ("do", do)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device \
                or not x.is_contiguous() or x.requires_grad:
            raise ValueError(f"{name} must be a contiguous {q.dtype} tensor of "
                             f"q's shape {tuple(q.shape)} on {q.device} that "
                             "does not require grad")
        if x.dtype == torch.bfloat16 and x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if lse.shape != (b, h, s) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous float32 ({b}, {h}, {s}) "
                         f"tensor on {q.device}, got {tuple(lse.shape)} "
                         f"{lse.dtype} on {lse.device}")
    if window is not None and window >= s:
        window = None   # no row reaches back that far: the same mask
    if not causal and window is not None and s >= t + window:
        raise ValueError(f"with window {window} and no causal mask, rows from "
                         f"{t + window - 1} on see no key (S {s}, T {t})")
    if q.numel() == 0 or t == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dp = d if q.dtype == torch.bfloat16 else _fwd_width(d)
    q, k, v, o, do = (_pad(x, dp) for x in (q, k, v, o, do))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    f32 = dict(dtype=torch.float32, device=q.device)
    if q.dtype == torch.bfloat16:
        # lse * log2(e) and delta, rows padded to whole 64-row tiles; the
        # heads' fp32 partial dK and dV when a kv head serves several
        stats = torch.empty(2 * b * h * -(-s // 64) * 64, **f32)
        part = torch.empty(2 * b * h * t * dp, **f32) if h > kvh else None
    else:
        stats, part = torch.empty((b, h, s), **f32), None
    fn = getattr(_lib(), _BWD_ENTRY[q.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*(x.data_ptr() for x in (q, k, v, o, do, lse, stats)),
                 None if part is None else part.data_ptr(),
                 *(x.data_ptr() for x in (dq, dk, dv)),
                 b, s, t, h, kvh, dp, int(causal),
                 -1 if window is None else int(window), d ** -0.5, stream)
    if err != 0:
        raise RuntimeError("flash_attention_bwd kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES["flash_attention_bwd"] += 1
    if dp != d:
        dq, dk, dv = (x[..., :d].contiguous() for x in (dq, dk, dv))
    return dq, dk, dv
