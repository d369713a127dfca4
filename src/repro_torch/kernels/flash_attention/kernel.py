"""ctypes binding of the Hopper flash-attention kernel (``csrc/flash_attention.cu``).

Port of the Pallas TPU kernel ``flash_attention_bhsd``
(``repro/kernels/flash_attention/kernel.py``). The kernel reads the model
layout and masks its own ragged edges, so nothing is transposed or padded
here. Every argument is checked before a pointer is handed over, and each
launch adds one to ``LAUNCHES["flash_attention"]``.

Forward only, like the reference: an input that requires grad is refused
instead of silently dropping its gradient.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# wrapper name -> number of kernel launches made through it
LAUNCHES = {"flash_attention": 0}

_ENTRY = {torch.float32: "flash_attention_fwd_f32",
          torch.bfloat16: "flash_attention_fwd_bf16"}
HEAD_DIMS = (16, 32, 64, 128, 256)
_INT_MAX = 2 ** 31 - 1
_GRID_MAX = 65535   # gridDim.y (heads) and gridDim.z (batch)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None) -> torch.Tensor:
    """q (B, S, H, D); k/v (B, T, KV, D), one dtype (float32 or bfloat16),
    contiguous, on one CUDA device -> o (B, S, H, D) in q's dtype."""
    _check(q, k, v, causal, window)
    out = torch.empty_like(q)
    if out.numel() == 0 or k.shape[1] == 0:
        return out.zero_()
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    fn = getattr(_lib(), _ENTRY[q.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, s, t, h, kvh, d, int(causal),
                 -1 if window is None else int(window), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    LAUNCHES["flash_attention"] += 1
    return out
