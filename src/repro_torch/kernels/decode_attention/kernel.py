"""ctypes binding of the Hopper decode-attention kernel (``csrc/decode_attention.cu``).

Port of the Pallas TPU kernel ``decode_attention_grouped``
(``repro/kernels/decode_attention/kernel.py``) as one launch of split-T
flash-decoding whose chunks are combined inside a thread-block cluster: no
scratch, no atomics, and nothing kept between calls, so a call can be
captured in a CUDA graph. The wrapper allocates only the output; nothing is
transposed, and the boolean slot mask is read as it is, one byte a slot.
Every argument is checked before a pointer is handed over. Head_dim 96
(phi3-mini), which the kernel has no instantiation for, is padded here with
zero columns to 128, and the kernel gets the true D^-0.5: zero q and k
columns leave the scores as they are, zero v columns give output columns
that are sliced off.

Launch counting: ``LAUNCHES["decode_attention"]`` counts launches that ran
on the card. A call made while the current stream is capturing a CUDA graph
runs nothing: it adds to ``CAPTURED`` instead, and whoever replays the graph
adds the launches it holds with ``count_replays``.

Forward only, like the reference: an input that requires grad is refused.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# wrapper name -> number of kernel launches that ran on the card
LAUNCHES = {"decode_attention": 0}
# wrapper name -> number of launches recorded into CUDA graphs being captured
CAPTURED = {"decode_attention": 0}

_ENTRY = {torch.float32: "decode_attention_f32",
          torch.bfloat16: "decode_attention_bf16"}
HEAD_DIMS = (16, 32, 64, 96, 128, 256)
_INT_MAX = 2 ** 31 - 1
_UNITS_MAX = 65535   # gridDim.y: B * KV * ceil(G / 8)
_READY: set = set()  # CUDA device indices whose kernel attributes are set


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def count_replays(held: dict) -> None:
    """Add the launches that one replay of a captured graph ran (``held``:
    name -> launches, the growth of ``CAPTURED`` over its capture)."""
    for name, n in held.items():
        LAUNCHES[name] += n


def _lib(device: torch.device) -> ctypes.CDLL:
    """The library, with every instantiation's shared-memory and cluster
    attributes set once per device. That first call on a device must be
    eager: attributes are not set while a stream captures."""
    lib = _build.load("decode_attention")
    if device.index not in _READY:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the first decode_attention call on a device "
                               "must run eagerly, before any CUDA graph capture")
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 \
                + [ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.decode_attention_setup.argtypes = []
        lib.decode_attention_setup.restype = ctypes.c_int
        err = lib.decode_attention_setup()
        if err != 0:
            raise RuntimeError(f"decode_attention setup failed: cudaError {err}")
        _READY.add(device.index)
    return lib


def _check(q, k, v, valid) -> None:
    for name, x in (("q", q), ("k", k), ("v", v), ("valid", valid)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device {q.device}, "
                             f"got {x.device}")
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
    if tuple(valid.shape) != (t,) or valid.dtype != torch.bool:
        raise ValueError(f"valid must be bool of shape ({t},), got "
                         f"{valid.dtype} {tuple(valid.shape)}")
    if b * kvh * -(-(h // kvh) // 8) > _UNITS_MAX or any(
            n > _INT_MAX for n in (b * h, k.numel(), q.numel())):
        raise ValueError("decode_attention kernel sizes out of range")
    for name, x in (("q", q), ("k", k), ("v", v), ("valid", valid)):
        if name != "valid" and x.dtype != q.dtype:
            raise TypeError(f"{name} must be {q.dtype}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.requires_grad:
            raise RuntimeError(f"{name} requires grad, but the decode_attention "
                               "kernel is forward-only")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary: the "
                             "kernel reads its rows 16 bytes at a time")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """q (B, 1, H, D); k/v (B, T, KV, D) of q's dtype (float32 or bfloat16);
    valid (T,) bool, True = attend; all contiguous on one CUDA device.
    Returns (B, 1, H, D) in q's dtype."""
    _check(q, k, v, valid)
    out = torch.empty_like(q)
    b, _, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    if out.numel() == 0 or t == 0:
        return out.zero_()
    dp = 128 if d == 96 else d
    if dp != d:
        q, k, v = (torch.nn.functional.pad(x, (0, dp - d)) for x in (q, k, v))
    res = out if dp == d else torch.empty_like(q)
    with torch.cuda.device(q.device):
        fn = getattr(_lib(q.device), _ENTRY[q.dtype])
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
                 res.data_ptr(), b, t, h, kvh, dp, d ** -0.5, stream)
    if res is not out:
        out.copy_(res[..., :d])
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: cudaError {err}")
    if torch.cuda.is_current_stream_capturing():
        CAPTURED["decode_attention"] += 1
    else:
        LAUNCHES["decode_attention"] += 1
    return out
