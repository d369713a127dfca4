"""ctypes binding of AdamW's two multi-tensor passes (``csrc/adamw.cu``).

Replaces no Pallas kernel: the reference's optimizer is plain jnp, which
XLA fuses. Its plain versions are the eager code of
``training/optimizer.py`` (``_eager_norm``, ``_update_leaf_``), which every
CPU run still takes.

* ``global_norm(grads)``: the norm of every gradient leaf taken together,
  as a 0-d fp32 tensor: one pass over the leaves writes a partial sum per
  tile, a second sums them leaf by leaf in leaf order. The squares are
  taken in fp32 and summed in fp64, so the norm lies within a few fp32
  ulps of the plain fp32 sum but is not its bits. Same bits on every call
  and every graph replay (no atomics). ``squared_sums(grads)``: the
  per-leaf fp64 sums it adds, for a norm over shards.
* ``adamw_update_(...)``: one AdamW step in place over the leaves, each
  element read once and written once; given the same norm, bit for bit
  the numbers of ``optimizer.adamw_update``'s eager update.

Every argument is checked before a pointer is handed over, and each
launch adds one to ``LAUNCHES[<wrapper>]``, graph replays included
(``_graph``'s launch ledger). The kernel writes the
params and moments through their pointers, so the wrapper bumps their
autograd version counters itself.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _graph
from repro_torch.kernels import _build

# wrapper name -> number of kernel launches that ran on the card
LAUNCHES = _graph.register("global_norm", "adamw_update")

_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
PARAM_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
MOMENT_DTYPES = (torch.float32, torch.bfloat16)
# leaves in one launch's table (kMaxLeaves in csrc/adamw.cu): each pass
# launches once per table of up to this many non-empty leaves of one dtype
# (the update: of one param and moment dtype pair), and the norm once more
# to sum the tables' partials
MAX_LEAVES = 64


def _lib() -> ctypes.CDLL:
    lib = _build.load("adamw")
    if lib.adamw_update.argtypes is None:
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        sizes = ctypes.POINTER(ctypes.c_longlong)
        lib.adamw_norm_scratch.argtypes = [sizes, ctypes.c_int]
        lib.adamw_norm_scratch.restype = ctypes.c_longlong
        count = ctypes.POINTER(ctypes.c_int)
        lib.adamw_global_norm.argtypes = [
            ptrs, sizes, count, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, count]
        lib.adamw_global_norm.restype = ctypes.c_int
        lib.adamw_update.argtypes = (
            [ctypes.c_int] * 2 + [ptrs] * 4
            + [sizes, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int]
            + [ctypes.c_void_p] * 4 + [ctypes.c_float] * 6 + [ctypes.c_void_p,
                                                                count])
        lib.adamw_update.restype = ctypes.c_int
    return lib


def takes_leaf(p, g, m, v) -> bool:
    """Whether the update kernel takes the leaf whose local tensors these
    are (p, g, m, v; a ``DTensor``'s shard on this card counts as a
    tensor), its device apart: four tensors of one shape on one device,
    each contiguous, p and g of one dtype of ``PARAM_DTYPES``, m and v of
    one of ``MOMENT_DTYPES``. ``adamw_update_`` refuses any other leaf, and
    any leaf off the card."""
    ts = (p, g, m, v)
    return (all(t.shape == p.shape and t.device == p.device
                and t.is_contiguous() for t in ts)
            and p.dtype == g.dtype and p.dtype in PARAM_DTYPES
            and m.dtype == v.dtype and m.dtype in MOMENT_DTYPES)


def takes_grads(grads) -> bool:
    """Whether the norm kernel takes these gradient leaves, their device
    apart: each contiguous, of ``PARAM_DTYPES``, all on one device.
    ``global_norm`` refuses any others, and any off the card."""
    return bool(grads) and all(
        g.device == grads[0].device and g.dtype in PARAM_DTYPES
        and g.is_contiguous() for g in grads)


def _scalar(name: str, t, device) -> None:
    if t.dtype != torch.float32 or t.dim() != 0 or t.device != device:
        raise ValueError(f"{name} must be a 0-d float32 tensor on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _norm_passes(grads):
    """Both norm passes: (the norm, a 0-d fp32 tensor; the fp64 sums of
    squares of the non-empty leaves, in leaf order, that it adds up)."""
    if not (takes_grads(grads) and grads[0].device.type == "cuda"):
        raise ValueError("global_norm kernel takes contiguous float32, "
                         "bfloat16 or float16 tensors on one CUDA device")
    device = grads[0].device
    n = len(grads)
    ptrs = (ctypes.c_void_p * n)(*(g.data_ptr() for g in grads))
    sizes = (ctypes.c_longlong * n)(*(g.numel() for g in grads))
    codes = (ctypes.c_int * n)(*(_CODE[g.dtype] for g in grads))
    lib = _lib()
    # scratch: a partial per tile, then the leaves' sums, then their bounds
    scratch = torch.empty(lib.adamw_norm_scratch(sizes, n), dtype=torch.float64,
                          device=device)
    out = torch.empty((), dtype=torch.float32, device=device)
    launches = ctypes.c_int(0)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.adamw_global_norm(ptrs, sizes, codes, n, scratch.data_ptr(),
                                    out.data_ptr(), stream, ctypes.byref(launches))
    if err != 0:
        raise RuntimeError(f"global_norm kernel launch failed: cudaError {err}")
    _graph.count("global_norm", launches.value)
    leaves = sum(1 for g in grads if g.numel())
    tiles = scratch.numel() - 2 * leaves
    return out, scratch[tiles:tiles + leaves]


def global_norm(grads) -> torch.Tensor:
    """sqrt(sum of every leaf's squares): a 0-d fp32 tensor on the leaves'
    card. Each element is squared in fp32 (``torch.square(g.float())``) and
    the squares are summed in fp64; the square root of the fp64 total is
    rounded to fp32."""
    return _norm_passes(grads)[0]


def squared_sums(grads) -> list:
    """Each leaf's sum of squares, a 0-d fp64 tensor (zero for an empty
    leaf): the sums ``global_norm`` adds up, so that
    ``torch.sqrt(sum(squared_sums(gs))).float()`` is ``global_norm(gs)``
    bit for bit. A norm over shards (``optimizer._summed_over_shards``)
    reduces these before adding them."""
    sums = iter(_norm_passes(grads)[1].unbind(0))
    return [next(sums) if g.numel() else
            torch.zeros((), dtype=torch.float64, device=g.device) for g in grads]


def adamw_update_(leaves, decay, scale, lr, c1, c2, *, b1: float, b2: float,
                  eps: float, weight_decay: float) -> None:
    """One AdamW step in place: ``leaves`` a list of (p, g, m, v) on one
    card, each taken by ``takes_leaf``; ``decay`` a bool a leaf (weight decay on it).
    ``scale`` (the clip's scale, or None), ``lr``, ``c1`` and ``c2``: 0-d
    fp32 tensors on the leaves' card, read there by the kernel. The Python
    scalars go as fp32, as PyTorch rounds a scalar operand of an fp32
    kernel: b1, 1 - b1, b2, 1 - b2, eps and the decay."""
    if len(decay) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves but {len(decay)} decay flags")
    if not leaves:
        return
    device = leaves[0][0].device
    if device.type != "cuda":
        raise ValueError(f"adamw_update kernel takes leaves on the card, "
                         f"not on {device}")
    for leaf in leaves:
        if not takes_leaf(*leaf) or leaf[0].device != device:
            raise ValueError("adamw_update kernel takes leaves that takes_leaf "
                             f"accepts, all on {device}")
    for name, t in (("lr", lr), ("c1", c1), ("c2", c2), ("scale", scale)):
        if t is not None:
            _scalar(name, t, device)
    lib = _lib()
    groups: dict = {}
    for leaf, d in zip(leaves, decay):
        groups.setdefault((leaf[0].dtype, leaf[2].dtype), []).append((leaf, d))
    launches = ctypes.c_int(0)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for (pdt, mdt), group in groups.items():
            k = len(group)
            ptrs = [(ctypes.c_void_p * k)(*(lf[i].data_ptr() for lf, _ in group))
                    for i in range(4)]
            sizes = (ctypes.c_longlong * k)(*(lf[0].numel() for lf, _ in group))
            flags = (ctypes.c_ubyte * k)(*(bool(d) for _, d in group))
            err = lib.adamw_update(
                _CODE[pdt], _CODE[mdt], *ptrs, sizes, flags, k,
                None if scale is None else scale.data_ptr(), lr.data_ptr(),
                c1.data_ptr(), c2.data_ptr(), b1, 1 - b1, b2, 1 - b2, eps,
                weight_decay, stream, ctypes.byref(launches))
            if err != 0:
                raise RuntimeError(f"adamw_update kernel launch failed: "
                                   f"cudaError {err}")
            _graph.count("adamw_update", launches.value)
    torch.autograd.graph.increment_version(
        [t for lf in leaves for t in (lf[0], lf[2], lf[3])])
