"""Dispatch for flash attention (port of
``repro/kernels/flash_attention/ops.py``).

A CUDA tensor goes to the hand-written kernel, a CPU tensor to the plain
version in ``ref.py`` (the reference's ``interpret = backend != "tpu"``
switch). A meta tensor goes to the plain version too: it computes nothing,
and a shape-only run (``analysis.program_cost``) prices the plain function's
work there. Any other device raises. The kernel reads the model layout and
masks its own ragged edges, so unlike the TPU wrapper nothing is transposed
or padded; the kernels read each input through its strides, and the kernel
wrapper's ``dispatch`` rule copies only a view they cannot take (a last
axis that is not unit-stride, a 2-byte tensor off the 16-byte grid).

The reference's keywords: ``force_ref=True`` runs the plain version on any
device, CUDA included, and launches nothing. ``block_q`` and ``block_kv``
(the reference's ``DEFAULT_BLOCK_Q`` / ``DEFAULT_BLOCK_KV``, 128) must be
positive ints, as the reference's tiling needs; the Hopper kernel's tiles
are fixed by its design, so they are checked and not used.

Training: on a CUDA tensor that requires grad the call goes through
``FlashAttention``, an ``autograd.Function`` whose forward is the kernel
(keeping the rows' log-sum-exp) and whose backward is the hand-written
backward kernel. On the CPU the plain version's own autograd gives the
gradient, as ``jax.grad`` of the reference's function does.
"""
from __future__ import annotations

import torch

from repro_torch._tree import is_dtensor
from repro_torch.kernels import check_block
from repro_torch.kernels.flash_attention import kernel as _k
from repro_torch.kernels.flash_attention import ref as _ref

DEFAULT_BLOCK_Q = 128    # the reference's kernel.DEFAULT_BLOCK_Q
DEFAULT_BLOCK_KV = 128   # and DEFAULT_BLOCK_KV


class FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v) with the kernels on both passes. The kernels
    see detached tensors (their wrappers refuse inputs that require grad).
    q, k, v, o and the log-sum-exp go through ``save_for_backward``, so
    under ``torch.utils.checkpoint`` the recomputed forward's tensors, its
    log-sum-exp among them, are the ones the backward reads. The backward
    takes one head dim, so v of another width than q and k is refused."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window):
        if v.shape[-1] != q.shape[-1]:
            raise ValueError("flash_attention's backward takes v at q and k's "
                             f"head dim only: got {q.shape[-1]} and {v.shape[-1]}")
        o, lse = _k.flash_attention(q.detach(), k.detach(), v.detach(),
                                    causal=causal, window=window,
                                    return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _k.flash_attention_bwd(
            q.detach(), k.detach(), v.detach(), o.detach(), lse,
            do.detach().contiguous(), causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def _local_heads(q, k, v, fn):
    """``fn(q, k, v)`` on each rank's shard of ``DTensor`` q, k, v: the
    batch (dim 0) as ``q`` splits it, the heads (dim 2) as ``q`` splits
    them, every other dim whole. The result is ``q``'s placements.

    KV heads follow the query heads' split when that split divides them
    too: a rank's query heads then use exactly its KV heads, the group
    ``H / KV`` unchanged. Otherwise the KV heads stay whole on each rank
    and the rank takes the ones its query heads use: query head ``h`` reads
    KV head ``h // (H / KV)``, by a slice where the rank's heads form equal
    groups and an index otherwise (one KV head per query head). The local
    group ``H_local / KV_local`` of unsplit KV heads would pair them
    wrongly. The KV gradient of such a rank covers its heads only, so it
    leaves as a pending sum over the head-splitting mesh dims.

    Every decision here reads shapes and placements alone, which all ranks
    share, so every rank makes the same redistributions."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = q.device_mesh
    sizes, coord = mesh.mesh.shape, mesh.get_coordinate()
    qp = tuple(p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
               for p in q.placements)
    head_dims = [i for i, p in enumerate(qp) if p == Shard(2)]
    n_split = 1
    for i in head_dims:
        n_split *= sizes[i]
    h, kvh = q.shape[2], k.shape[2]
    follow = kvh % n_split == 0
    kp = tuple(p if p == Shard(0) or follow else Replicate() for p in qp)
    grad_kp = tuple(Partial() if p == Shard(2) and not follow else kp[i]
                    for i, p in enumerate(qp))
    q = q.redistribute(mesh, qp)
    k, v = (t.redistribute(mesh, kp) for t in (k, v))
    ql = q.to_local()
    kl, vl = (t.to_local(grad_placements=grad_kp) for t in (k, v))
    if not follow:
        # the rank's block of query heads, major to minor over mesh dims
        block = 0
        for i in head_dims:
            block = block * sizes[i] + coord[i]
        h_loc = h // n_split
        h0, g = block * h_loc, h // kvh
        use = [(h0 + j) // g for j in range(h_loc)]
        n_kv = use[-1] - use[0] + 1
        if h_loc % n_kv == 0 and all(
                u - use[0] == j // (h_loc // n_kv) for j, u in enumerate(use)):
            kl, vl = (t[:, :, use[0]:use[0] + n_kv] for t in (kl, vl))
        else:
            idx = (h0 + torch.arange(h_loc, device=kl.device)) // g
            kl, vl = (t.index_select(2, idx) for t in (kl, vl))
    out = fn(ql, kl.contiguous(), vl.contiguous())
    return DTensor.from_local(out, mesh, qp, run_check=False, shape=q.shape,
                              stride=q.stride())


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_kv: int = DEFAULT_BLOCK_KV,
                    force_ref: bool = False,
                    scale: float | None = None) -> torch.Tensor:
    """Model layout: q (B, S, H, D); k (B, T, KV, D), v (B, T, KV, Dv) ->
    (B, S, H, Dv) (Dv = D on the autograd path, whose backward takes one
    head dim).
    ``DTensor`` inputs (a model trained on a device mesh) run per rank on
    local shards (``_local_heads``): the kernels take plain tensors.
    ``force_ref`` takes the plain version there too. ``scale``: the scores'
    factor (D^-0.5 when None; port-only, forward only: the backward kernel
    takes the default)."""
    if is_dtensor(q):
        return _local_heads(q, k, v, lambda a, b, c: flash_attention(
            a, b, c, causal=causal, window=window, block_q=block_q,
            block_kv=block_kv, force_ref=force_ref, scale=scale))
    if force_ref:
        return _ref.attention_ref(q, k, v, causal=causal, window=window,
                                  scale=scale)
    if q.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors (or "
                         f"meta for pricing), got {q.device}")
    check_block(block_q, "block_q")
    check_block(block_kv, "block_kv")
    if q.device.type == "cuda":
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            if scale is not None:
                raise ValueError("flash_attention's backward takes the "
                                 "default scale D^-0.5 only")
            return FlashAttention.apply(q, k, v, causal, window)
        return _k.flash_attention(q, k, v, causal=causal, window=window,
                                  scale=scale)
    return _ref.attention_ref(q, k, v, causal=causal, window=window,
                              scale=scale)
