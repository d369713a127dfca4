"""ctypes binding of the Hopper decode-attention kernel (``csrc/decode_attention.cu``).

Port of the Pallas TPU kernel ``decode_attention_grouped``
(``repro/kernels/decode_attention/kernel.py``) as one launch of split-T
flash-decoding whose chunks are combined inside a thread-block cluster: no
scratch, no atomics, and nothing kept between calls, so a call can be
captured in a CUDA graph. The wrapper allocates only the output; nothing is
transposed, and the boolean slot mask is read as it is, one byte a slot.
Every argument is checked before a pointer is handed over. Inputs:
float32, bfloat16 or float16. Head dims: any D >= 1, as the reference's
Pallas kernel takes any D. Up to 256 the kernel runs at the smallest width
of 16, 32, 64, 128 and 256 that holds D, reads the cache's rows as they are
(at their strides), fills the columns past D with zeros on the card,
writes D columns and scales by the true D^-0.5: nothing is padded here. Past 256 it
runs in column passes of 256 (one launch), each streaming K whole for the
scores and its own 256 columns of V. ``dispatch`` is the rule, a pure
function: the width and the passes (handed to the C entry point, which
runs them and chooses none of its own), and which inputs are copied dense
first. q, k and v are read through their strides, so a view whose last
axis is unit-stride is read in place; a view whose address or strides lie
off the 16-byte grid the kernel's loads need is copied (the model's own
calls copy nothing), and so is a mask that is not dense.

Launch counting: ``LAUNCHES["decode_attention"]`` counts launches that ran
on the card, graph replays included (``_graph``'s launch ledger).

Forward only, like the reference: an input that requires grad is refused.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _graph
from repro_torch.kernels import _build, _layout

# wrapper name -> number of kernel launches that ran on the card
LAUNCHES = _graph.register("decode_attention")

_ENTRY = {torch.float32: "decode_attention_f32",
          torch.bfloat16: "decode_attention_bf16",
          torch.float16: "decode_attention_f16"}
WIDTHS = (16, 32, 64, 128, 256)   # the instantiated widths
PASS_WIDTH = 256   # output columns of one pass past the widest width
ALIGN = 16   # q, k and v rows are read 16 bytes at a time
_INT_MAX = 2 ** 31 - 1
_UNITS_MAX = 65535   # gridDim.y: B * KV * ceil(G / 8) * passes
_READY: set = set()  # CUDA device indices whose kernel attributes are set


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
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.POINTER(ctypes.c_longlong)] \
                + [ctypes.c_int] * 7 \
                + [ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.decode_attention_setup.argtypes = []
        lib.decode_attention_setup.restype = ctypes.c_int
        err = lib.decode_attention_setup()
        if err != 0:
            raise RuntimeError(f"decode_attention setup failed: cudaError {err}")
        _READY.add(device.index)
    return lib


def dispatch(d: int, tensors) -> dict:
    """The wrapper's choices for one call, from the head dim and q, k, v
    and valid (their layout and address only): the kernel's ``width`` (the
    smallest of ``WIDTHS`` that holds d, ``PASS_WIDTH`` past it), the
    output column ``passes``, and ``copy``: per tensor, whether it is
    copied dense first (q, k, v are read through their strides, on the
    16-byte grid; the mask dense, at any address)."""
    return {"width": next((w for w in WIDTHS if w >= d), PASS_WIDTH),
            "passes": -(-d // PASS_WIDTH),
            "copy": [not (_layout.in_place(x, ALIGN, strided=True) if i < 3
                          else _layout.in_place(x, 1))
                     for i, x in enumerate(tensors)]}


def _check(q, k, v, valid) -> None:
    d = q.shape[-1] if q.dim() else 0
    if d < 1:
        raise ValueError(f"head_dim {d} must be at least 1")
    for name, x in (("q", q), ("k", k), ("v", v), ("valid", valid)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device {q.device}, "
                             f"got {x.device}")
    if q.dtype not in _ENTRY:
        raise TypeError(f"decode_attention kernel takes float32, bfloat16 or "
                        f"float16, got {q.dtype}")
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"need q (B, 1, H, D) and k/v (B, T, KV, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    if kvh == 0 or h % kvh:
        raise ValueError(f"query heads {h} must be a multiple of kv heads {kvh}")
    if tuple(valid.shape) != (t,) or valid.dtype != torch.bool:
        raise ValueError(f"valid must be bool of shape ({t},), got "
                         f"{valid.dtype} {tuple(valid.shape)}")
    if b * kvh * -(-(h // kvh) // 8) * -(-d // PASS_WIDTH) > _UNITS_MAX or any(
            n > _INT_MAX for n in (b * h, k.numel(), q.numel())):
        raise ValueError("decode_attention kernel sizes out of range")
    for name, x in (("q", q), ("k", k), ("v", v), ("valid", valid)):
        if name != "valid" and x.dtype != q.dtype:
            raise TypeError(f"{name} must be {q.dtype}, got {x.dtype}")
        if x.requires_grad:
            raise RuntimeError(f"{name} requires grad, but the decode_attention "
                               "kernel is forward-only")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """q (B, 1, H, D); k/v (B, T, KV, D) of q's dtype (float32, bfloat16 or
    float16); valid (T,) bool, True = attend; any layout, on one CUDA
    device. Returns (B, 1, H, D) in q's dtype."""
    _check(q, k, v, valid)
    plan = dispatch(q.shape[-1], (q, k, v, valid))
    q, k, v, valid = (x.clone(memory_format=torch.contiguous_format) if c else x
                      for x, c in zip((q, k, v, valid), plan["copy"]))
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    b, _, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    if out.numel() == 0 or t == 0:
        return out.zero_()
    with torch.cuda.device(q.device):
        fn = getattr(_lib(q.device), _ENTRY[q.dtype])
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
                 out.data_ptr(), _layout.axes(q, k, v), b, t, h, kvh, d,
                 plan["width"], plan["passes"], d ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: cudaError {err}")
    _graph.count("decode_attention")
    return out
