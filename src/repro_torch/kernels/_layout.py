"""The rule by which a kernel wrapper reads a tensor in place or copies it.

A caller may hand over any view the reference's functions take (JAX arrays
have no strides): a transpose, an ``unbind`` of a fused tensor, a column
slice, a view at an odd offset. The attention kernels read each input
through its strides (``strided``): any view whose last axis is unit-stride
is read in place, as long as its address and its other strides keep the
rows on the grid the kernel's loads need (16 bytes where a body moves
16-byte pieces). Other kernels read dense row-major tensors. Any other view
is copied once, by the wrapper, into a fresh dense tensor (fresh
allocations start on the allocator's 512-byte grid: ``clone``, since
``contiguous()`` would return an unaligned dense view as it is); the
model's own calls copy nothing.
"""
from __future__ import annotations

import ctypes

import torch


_INT_MAX = 2 ** 31 - 1   # the kernels hold row and head strides in an int


def in_place(x: torch.Tensor, align: int, strided: bool = False) -> bool:
    """Whether a kernel can read ``x`` as it is: at an address that is a
    multiple of ``align`` bytes, and dense row-major (as
    ``Tensor.is_contiguous`` judges it) or, for a kernel that takes strides
    (``strided``), with a unit-stride last axis and every other stride a
    multiple of ``align`` bytes (all but the first within an int). A dim of
    size 1 may have any stride."""
    if x.data_ptr() % align:
        return False
    if x.is_contiguous():
        return True
    last = x.dim() - 1
    return strided and all(
        st == 1 if i == last else
        st * x.element_size() % align == 0 and (i == 0 or st <= _INT_MAX)
        for i, (n, st) in enumerate(zip(x.shape, x.stride())) if n != 1)


def axes(*xs: torch.Tensor):
    """The batch, row and head strides (in elements; 0 for an axis of size
    1, whose stride is never used) of each (B, rows, heads, D) tensor of
    ``xs`` in turn: the ``strides`` array the attention kernels' C entry
    points read."""
    vals = [st if n != 1 else 0 for x in xs
            for n, st in zip(x.shape[:3], x.stride()[:3])]
    return (ctypes.c_longlong * len(vals))(*vals)
