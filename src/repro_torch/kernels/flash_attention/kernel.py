"""ctypes bindings of the Hopper flash-attention kernels
(``csrc/flash_attention.cu``): the forward and its backward.

Port of the Pallas TPU kernel ``flash_attention_bhsd``
(``repro/kernels/flash_attention/kernel.py``). The kernel reads the model
layout and masks its own ragged edges, so nothing is transposed or padded
here. Every argument is checked before a pointer is handed over, and each
launch adds one to ``LAUNCHES["flash_attention"]``. Each input is read
through its strides, so a view whose last axis is unit-stride is read in
place (``_layout.in_place``). The forward has three
bodies: the 2-byte types run on the tensor cores, on ``wgmma`` at the
instantiated (q/k, v) head widths (``FWD_WGMMA_WIDTHS``: 64, 96, 128, and
MLA's 192 with v at 128) and on ``mma.sync`` at every other, and fp32 on
the FMA pipe (which keeps the fp32 tolerance); ``dispatch`` picks one and
the C entry runs it. Each forward launch on the ``wgmma`` body also adds
one to ``LAUNCHES["flash_attention.wgmma"]``, and every forward adds one to
the obs counter ``kernels.flash_fwd.<body>`` (``obs.device.count``: nothing
when recording is off). v may have a head width Dv of its own: o has
Dv columns; the ``mma.sync`` and FMA bodies take one width, so there v
(or q and k) is padded with zero columns to the wider of the two and o
sliced back. The
forward can also return the per-row log-sum-exp (fp32, (B, H, S)) that
``flash_attention_bwd`` reads; each backward call (2-byte: a prep pass,
dK/dV and dQ in one launch and, when H > KV, the sum of the heads'
partials; fp32: delta, dK/dV, dQ) adds one to
``LAUNCHES["flash_attention_bwd"]``. The counts are kept by
``_graph``'s launch ledger, which also counts the launches of a captured
CUDA graph's replays.

Inputs: float32, bfloat16 or float16 (the 2-byte types on the tensor
cores, with fp32 accumulation; fp32 on the FMA pipe). Head dims: any
D >= 1, as the reference's Pallas kernel takes any D. Up to 256 the kernels
run at the smallest width of 16, 32, 64, 128 and 256 that holds D (the
2-byte backward at 128 or 256), read the tensors as they are (rows at
their strides), fill the columns past D with zeros on the card and scale
by the true D^-0.5. Past 256 every body runs in column passes of 256 (one launch):
a pass writes 256 columns of its output and recomputes the scores over all
of D, so the q . k work is done ceil(D / 256) times; the 2-byte backward
runs its tensor-core body there too, streaming 128-column pieces. One
rule pads: the 2-byte backward moves its tiles by TMA, whose rows must lie
on a 16-byte grid, so at D % 8 != 0 its inputs are padded with zero
columns to the next multiple of 8 and its gradients sliced back
(``_bwd_width``; D 257 runs at 264, in 2 passes). ``dispatch`` is the
whole rule, a pure function: which body runs, at which width, in how many
passes, with which padding, and which inputs are copied first (``_layout.in_place``: a view whose last
axis is not unit-stride, or a 2-byte tensor whose address or strides lie
off the 16-byte grid; the model's own calls copy nothing). The C entry
points run the body, width and passes they are handed and choose none of
their own: they only refuse a plan that does not fit the head dim.

These wrappers are not differentiable: an input that requires grad is
refused instead of silently dropping its gradient. ``ops.flash_attention``
wraps them in an ``autograd.Function`` for training.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _graph
from repro_torch.kernels import _build, _layout
from repro_torch.obs.device import count as obs_count

# wrapper name -> number of kernel launches that ran on the card
LAUNCHES = _graph.register("flash_attention", "flash_attention.wgmma",
                           "flash_attention_bwd")

_ENTRY = {torch.float32: "flash_attention_fwd_f32",
          torch.bfloat16: "flash_attention_fwd_bf16",
          torch.float16: "flash_attention_fwd_f16"}
_BWD_ENTRY = {torch.float32: "flash_attention_bwd_f32",
              torch.bfloat16: "flash_attention_bwd_bf16",
              torch.float16: "flash_attention_bwd_f16"}
_BODY = {"wgmma": 0, "fma": 1, "mma": 2}   # the entries' body argument
WIDTHS = (16, 32, 64, 128, 256)   # the instantiated widths
# (q/k, v) head widths the 2-byte forward's wgmma body is instantiated at
FWD_WGMMA_WIDTHS = ((64, 64), (96, 96), (128, 128), (192, 128))
WGMMA_MAX_GROUP = 64   # query heads a kv head serves: one group's 64 rows hold a position
PASS_WIDTH = 256   # output columns of one pass past the widest width
# bytes each input's address must be a multiple of: the 2-byte bodies move
# 16-byte pieces, the fp32 bodies single elements
ALIGN = {torch.float32: 4, torch.bfloat16: 16, torch.float16: 16}
_INT_MAX = 2 ** 31 - 1
_GRID_MAX = 65535   # gridDim.y (heads) and gridDim.z (batch)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    # forward: q, k, v, o, lse, the strides, 9 ints (Dv the ninth), body,
    # width and passes; backward: q, k, v, o, do, lse, stats, part, dq, dk,
    # dv, the strides, 8 ints, body, width and passes; then the scale and
    # the stream
    for entries, n_ptr, n_int in ((_ENTRY, 5, 12), (_BWD_ENTRY, 11, 11)):
        for name in entries.values():
            fn = getattr(lib, name)
            if fn.argtypes is None:
                fn.argtypes = [ctypes.c_void_p] * n_ptr \
                    + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * n_int \
                    + [ctypes.c_float, ctypes.c_void_p]
                fn.restype = ctypes.c_int
    return lib


def head_width(d: int) -> int:
    """The width a head dim runs at: the smallest of ``WIDTHS`` that holds
    it, ``PASS_WIDTH`` (in passes) past the widest."""
    return next((w for w in WIDTHS if w >= d), PASS_WIDTH)


def _bwd_width(d: int, dtype: torch.dtype) -> int:
    """The head dim the backward's tensors are handed over at: ``d``, but
    the 2-byte wgmma body moves TMA rows that need ``d % 8 == 0``, so
    another ``d`` pads to the next multiple of 8."""
    return -(-d // 8) * 8 if dtype != torch.float32 else d


def dispatch(d: int, dtype: torch.dtype, tensors, backward: bool = False,
             dv: int | None = None, group: int = 1) -> dict:
    """The wrapper's choices for one call, from the head dims (``d`` of q
    and k, ``dv`` of v, ``d`` when None), the query heads a kv head serves
    (``group``), the dtype and the input tensors (their layout and address
    only): ``body`` ("fma": fp32 math on the FMA pipe; "wgmma": the 2-byte
    forward at its instantiated widths, and the 2-byte backward at every
    D; "mma": the forward's other 2-byte body), its ``width``, the output
    column ``passes`` (all three handed to the C entry point, which runs
    them), the head dim ``pad_to`` the inputs are padded to (the 2-byte
    backward's TMA rows; the forward's one width when ``dv`` differs from
    ``d`` on a body that takes one), and ``copy``: per tensor, whether it
    is copied dense first."""
    dv = d if dv is None else dv
    wgmma_fwd = not backward and dtype != torch.float32 \
        and (d, dv) in FWD_WGMMA_WIDTHS and group <= WGMMA_MAX_GROUP
    if backward:
        pad_to = _bwd_width(d, dtype)
    else:
        pad_to = d if wgmma_fwd else max(d, dv)
    passes = -(-pad_to // PASS_WIDTH)
    if dtype == torch.float32:
        body, width = "fma", head_width(pad_to)
    elif backward:
        body, width = "wgmma", (128 if d <= 128 else 256)
    elif wgmma_fwd:
        body, width = "wgmma", d
    else:
        body, width = "mma", head_width(pad_to)
    align = ALIGN[dtype]
    return {"body": body, "width": width, "passes": passes, "pad_to": pad_to,
            "copy": [not _layout.in_place(x, align, strided=True) for x in tensors]}


def _pad(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x`` with zero columns up to ``width`` on its last axis."""
    if x.shape[-1] == width:
        return x
    return torch.nn.functional.pad(x, (0, width - x.shape[-1])).contiguous()


def _check(q, k, v, causal: bool, window, own_dv: bool = False) -> None:
    """Refuse what the kernels do not take; ``own_dv``: v may have a head
    width of its own (the forward)."""
    if q.dtype not in _ENTRY:
        raise TypeError(f"flash_attention kernel takes float32, bfloat16 or "
                        f"float16, got {q.dtype}")
    same = k.shape[:3] == v.shape[:3] and v.dim() == 4 and v.shape[3] >= 1 \
        if own_dv else k.shape == v.shape
    if q.dim() != 4 or k.dim() != 4 or not same \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        want = "k (B, T, KV, D), v (B, T, KV, Dv)" if own_dv else "k/v (B, T, KV, D)"
        raise ValueError(f"need q (B, S, H, D) and {want}; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    if kvh == 0 or h % kvh:
        raise ValueError(f"query heads {h} must be a multiple of kv heads {kvh}")
    if d < 1:
        raise ValueError(f"head_dim {d} must be at least 1")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    passes = -(-d // PASS_WIDTH)
    if b > _GRID_MAX or h > _GRID_MAX or any(
            n > _INT_MAX for n in (s, t, q.numel(), k.numel(),
                                   -(-s // 32) * passes, -(-t // 32) * passes)):
        raise ValueError("flash_attention kernel sizes out of range")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device {q.device}, "
                             f"got {x.device}")
        if x.dtype != q.dtype:
            raise TypeError(f"{name} must be {q.dtype}, got {x.dtype}")
        if x.requires_grad:
            raise RuntimeError(f"{name} requires grad, but the flash_attention "
                               "kernel is forward-only")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None, return_lse: bool = False,
                    scale: float | None = None):
    """q (B, S, H, D); k (B, T, KV, D), v (B, T, KV, Dv), one dtype
    (float32, bfloat16 or float16), any layout, on one CUDA device -> o (B,
    S, H, Dv) in q's dtype, and with ``return_lse`` also the rows'
    log-sum-exp of the scaled scores, fp32 (B, H, S). A query row that sees
    no key (a window that ends before T) is the uniform average over the T
    keys, as in the plain version. ``scale``: the scores' factor, D^-0.5
    when None."""
    _check(q, k, v, causal, window, own_dv=True)
    plan = dispatch(q.shape[3], q.dtype, (q, k, v), dv=v.shape[3],
                    group=q.shape[2] // k.shape[2])
    return _forward(q, k, v, plan, causal, window, return_lse, scale)


def _forward(q, k, v, plan: dict, causal: bool, window, return_lse: bool, scale):
    """``flash_attention`` of checked inputs under ``plan`` (``dispatch``'s;
    ``chip_smoke.py`` also hands it the mma.sync body's plan at the wgmma
    body's shapes, to time the two in one run)."""
    b, s, h, d = q.shape
    t, kvh, dv = k.shape[1], k.shape[2], v.shape[3]
    q, k, v = (x.clone(memory_format=torch.contiguous_format) if c else x
               for x, c in zip((q, k, v), plan["copy"]))
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if q.numel() == 0 or t == 0:
        out = torch.zeros((b, s, h, dv), dtype=q.dtype, device=q.device)
        return (out, lse.fill_(-1e30)) if return_lse else out
    if plan["body"] != "wgmma" and dv != d:   # a body of one head dim
        q, k, v = (_pad(x, plan["pad_to"]) for x in (q, k, v))
    out = torch.empty((b, s, h, v.shape[3]), dtype=q.dtype, device=q.device)
    fn = getattr(_lib(), _ENTRY[q.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(), _layout.axes(q, k, v),
                 b, s, t, h, kvh, q.shape[3], v.shape[3], int(causal),
                 -1 if window is None else int(window), _BODY[plan["body"]],
                 plan["width"], plan["passes"],
                 d ** -0.5 if scale is None else float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    _graph.count("flash_attention")
    if plan["body"] == "wgmma":
        _graph.count("flash_attention.wgmma")
    obs_count(f"kernels.flash_fwd.{plan['body']}")
    if out.shape[3] != dv:
        out = out[..., :dv].contiguous()
    return (out, lse) if return_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True, window=None):
    """The gradient of ``flash_attention``: q, o, do (B, S, H, D); k/v
    (B, T, KV, D), any layout; lse the forward's fp32 (B, H, S) -> (dq, dk,
    dv) in the inputs' shapes and dtype, contiguous. A query row that sees no key adds
    dO / T to every key's dV and nothing to dQ and dK (the gradient of the
    plain version's uniform average)."""
    _check(q, k, v, causal, window)
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    for name, x in (("o", o), ("do", do)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device \
                or x.requires_grad:
            raise ValueError(f"{name} must be a {q.dtype} tensor of q's shape "
                             f"{tuple(q.shape)} on {q.device} that does not "
                             "require grad")
    if lse.shape != (b, h, s) or lse.dtype != torch.float32 \
            or lse.device != q.device:
        raise ValueError(f"lse must be a float32 ({b}, {h}, {s}) tensor on "
                         f"{q.device}, got {tuple(lse.shape)} {lse.dtype} on "
                         f"{lse.device}")
    if window is not None and window >= s:
        window = None   # no row reaches back that far: the same mask
    if q.numel() == 0 or t == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    plan = dispatch(d, q.dtype, (q, k, v, o, do), backward=True)
    q, k, v, o, do = (x.clone(memory_format=torch.contiguous_format) if c else x
                      for x, c in zip((q, k, v, o, do), plan["copy"]))
    lse = lse.contiguous()   # fp32: dense is aligned
    dp = plan["pad_to"]
    q, k, v, o, do = (_pad(x, dp) for x in (q, k, v, o, do))
    dq, dk, dv = (torch.empty(x.shape, dtype=x.dtype, device=x.device)
                  for x in (q, k, v))   # dense, whatever the inputs' strides
    f32 = dict(dtype=torch.float32, device=q.device)
    if plan["body"] == "wgmma":
        # lse * log2(e) and delta, rows padded to whole 64-row tiles; the
        # heads' fp32 partial dK and dV when a kv head serves several
        stats = torch.empty(2 * b * h * -(-s // 64) * 64, **f32)
        part = torch.empty(2 * b * h * t * dp, **f32) if h > kvh else None
    else:   # delta
        stats, part = torch.empty((b, h, s), **f32), None
    fn = getattr(_lib(), _BWD_ENTRY[q.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*(x.data_ptr() for x in (q, k, v, o, do, lse, stats)),
                 None if part is None else part.data_ptr(),
                 *(x.data_ptr() for x in (dq, dk, dv)), _layout.axes(q, k, v, o, do),
                 b, s, t, h, kvh, dp, int(causal),
                 -1 if window is None else int(window), _BODY[plan["body"]],
                 plan["width"], plan["passes"], d ** -0.5, stream)
    if err != 0:
        raise RuntimeError("flash_attention_bwd kernel launch failed: "
                           f"cudaError {err}")
    _graph.count("flash_attention_bwd")
    if dp != d:
        dq, dk, dv = (x[..., :d].contiguous() for x in (dq, dk, dv))
    return dq, dk, dv
