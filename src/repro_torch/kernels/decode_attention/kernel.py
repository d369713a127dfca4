"""ctypes binding of the Hopper decode-attention kernel (``csrc/decode_attention.cu``).

Port of the Pallas TPU kernel ``decode_attention_grouped``
(``repro/kernels/decode_attention/kernel.py``) as split-T flash-decoding:
one CUDA call runs the per-chunk pass and the combine pass, and counts as
one launch in ``LAUNCHES["decode_attention"]``. The wrapper allocates the
fp32 scratch of per-chunk partials; nothing is transposed or padded.
Every argument is checked before a pointer is handed over.

Forward only, like the reference: an input that requires grad is refused.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# wrapper name -> number of kernel launches made through it
LAUNCHES = {"decode_attention": 0}

_ENTRY = {torch.float32: "decode_attention_f32",
          torch.bfloat16: "decode_attention_bf16"}
HEAD_DIMS = (16, 32, 64, 128, 256)
_INT_MAX = 2 ** 31 - 1
_CHUNKS_MAX = 65535   # gridDim.y of the per-chunk pass


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")   # decode_attention_chunk: () -> int
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def _check(q, k, v, valid) -> None:
    if q.dtype not in _ENTRY:
        raise TypeError(f"decode_attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"need q (B, 1, H, D) and k/v (B, T, KV, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    if kvh == 0 or h % kvh:
        raise ValueError(f"query heads {h} must be a multiple of kv heads {kvh}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if tuple(valid.shape) != (t,) or valid.dtype != torch.int32:
        raise ValueError(f"valid must be int32 of shape ({t},), got "
                         f"{valid.dtype} {tuple(valid.shape)}")
    if any(n > _INT_MAX for n in (b * h, k.numel(), q.numel())):
        raise ValueError("decode_attention kernel sizes out of range")
    for name, x in (("q", q), ("k", k), ("v", v), ("valid", valid)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device {q.device}, "
                             f"got {x.device}")
        if name != "valid" and x.dtype != q.dtype:
            raise TypeError(f"{name} must be {q.dtype}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.requires_grad:
            raise RuntimeError(f"{name} requires grad, but the decode_attention "
                               "kernel is forward-only")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """q (B, 1, H, D); k/v (B, T, KV, D) of q's dtype (float32 or bfloat16);
    valid (T,) int32, nonzero = attend; all contiguous on one CUDA device.
    Returns (B, 1, H, D) in q's dtype."""
    _check(q, k, v, valid)
    out = torch.empty_like(q)
    b, _, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    if out.numel() == 0 or t == 0:
        return out.zero_()
    lib = _lib()
    n_chunks = -(-t // lib.decode_attention_chunk())
    if n_chunks > _CHUNKS_MAX:
        raise ValueError(f"cache of {t} slots is past the kernel's "
                         f"{_CHUNKS_MAX} chunks")
    n_parts = b * h * n_chunks
    part_m = torch.empty(n_parts, dtype=torch.float32, device=q.device)
    part_l = torch.empty(n_parts, dtype=torch.float32, device=q.device)
    part_acc = torch.empty(n_parts * d, dtype=torch.float32, device=q.device)
    fn = getattr(lib, _ENTRY[q.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
                 part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
                 out.data_ptr(), b, t, h, kvh, d, stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: cudaError {err}")
    LAUNCHES["decode_attention"] += 1
    return out
