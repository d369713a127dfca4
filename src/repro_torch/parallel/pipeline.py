"""GPipe pipeline parallelism over ``torch.distributed`` point-to-point. Port
of ``repro/parallel/pipeline.py``.

Stages live on a mesh axis, one rank per stage; microbatches march through
the stage chain, each tick handing the activations to the next stage
(fwd: i -> i+1). The hop is an ``autograd.Function`` whose backward sends
the gradient back the other way (i+1 -> i), as the transpose of the
reference's ``ppermute`` does, so one definition serves fwd+bwd.

Schedule (classic GPipe): T = n_micro + n_stages - 1 ticks; stage s works on
microbatch t - s at tick t (bubble fraction (S-1)/(M+S-1)). The last
stage's outputs are broadcast, so every rank returns the same result.

Every rank of the stage axis runs the same program: the caller passes the
stacked params (every leaf (n_stages, ...), full or as a ``DTensor`` sharded
over the axis, ``stage_sharding``) and the whole microbatched input.

Used by the Hulk placement layer when the cost model picks pipeline for the
slow axis (placement.RuntimePlacement.pod_axis_strategy == "pipeline").
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch._tree import tree_map

PyTree = Any


def _exchange(send: torch.Tensor | None, send_to: int | None,
              recv_like: torch.Tensor, recv_from: int | None,
              group) -> torch.Tensor:
    """Send ``send`` to rank ``send_to`` and receive a tensor shaped like
    ``recv_like`` from ``recv_from`` (zeros where there is no peer), both
    posted together so that no rank waits on another's send."""
    recv = torch.zeros_like(recv_like)
    ops = []
    if send_to is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(), send_to, group))
    if recv_from is not None:
        ops.append(dist.P2POp(dist.irecv, recv, recv_from, group))
    for req in dist.batch_isend_irecv(ops) if ops else ():
        req.wait()
    return recv


class _Hop(torch.autograd.Function):
    """One tick's stage hop: send this stage's output to the next stage and
    return what the previous stage sent (zeros on the first). Backward:
    send the received tensor's gradient back to the previous stage and
    return the gradient the next stage sent back (zeros on the last)."""

    @staticmethod
    def forward(ctx, out, prev, nxt, group):
        ctx.prev, ctx.nxt, ctx.group = prev, nxt, group
        return _exchange(out, nxt, out, prev, group)

    @staticmethod
    def backward(ctx, grad):
        return (_exchange(grad, ctx.prev, grad, ctx.nxt, ctx.group),
                None, None, None)


class _FromLast(torch.autograd.Function):
    """Every rank gets the last stage's tensor (the reference's psum of a
    one-hot selection). Each rank computes the same loss from it, so the
    gradient of that one loss flows to the last stage alone."""

    @staticmethod
    def forward(ctx, y, last: int, is_last: bool, group):
        ctx.is_last = is_last
        y = y.clone()
        dist.broadcast(y, src=last, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.is_last else torch.zeros_like(grad),
                None, None, None)


def _stage_ranks(mesh, axis: str) -> tuple[list[int], int, object]:
    """(global ranks of this rank's stage axis in stage order, this rank's
    stage, the axis' process group)."""
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    return ranks, ranks.index(dist.get_rank()), group


def gpipe_forward(stage_fn: Callable, mesh, axis: str, n_microbatches: int):
    """Build fn(stacked_params, x_microbatched) -> y_microbatched.

    * ``stage_fn(params_s, x)`` — one stage's computation (same signature on
      every stage; heterogeneous pipelines stack per-stage params).
    * stacked_params: every leaf (n_stages, ...), full on every rank or a
      ``DTensor`` sharded over `axis` (``stage_sharding``).
    * x: (n_microbatches, mb_size, ...) — the same on every rank; stage 0
      consumes it, the last stage's outputs are collected and returned.
    """
    def per_stage(params, x):
        ranks, stage, group = _stage_ranks(mesh, axis)
        n_stages = len(ranks)
        prev = ranks[stage - 1] if stage > 0 else None
        nxt = ranks[stage + 1] if stage < n_stages - 1 else None
        params = tree_map(lambda p: _local(p, stage), params)
        total = n_microbatches + n_stages - 1
        is_first = torch.tensor(stage == 0, device=x.device)

        state = torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
        outs = []
        for t in range(total):
            # stage 0 injects microbatch t (valid while t < M); a where, as
            # in the reference, keeps every stage's hop on the backward path
            inject = x[min(t, n_microbatches - 1)]
            cur = torch.where(is_first, inject, state)
            out = stage_fn(params, cur)
            # pass to next stage
            state = _Hop.apply(out, prev, nxt, group)
            outs.append(out)
        # on the LAST stage, ticks S-1 .. T-1 hold the final outputs of
        # microbatches 0..M-1
        y = torch.stack(outs[n_stages - 1:])
        return _FromLast.apply(y, ranks[-1], stage == n_stages - 1, group)

    return per_stage


def _local(p: torch.Tensor, stage: int) -> torch.Tensor:
    """This stage's slice of a stacked leaf: the local shard of a DTensor
    sharded over the stage axis, or entry ``stage`` of a full tensor."""
    if hasattr(p, "to_local"):
        return p.to_local()[0]
    return p[stage]


def gpipe_loss(stage_fn: Callable, loss_fn: Callable, mesh, axis: str,
               n_microbatches: int):
    """fn(stacked_params, x_mb, target_mb) -> mean loss; differentiable
    end-to-end (grads flow back through the hop chain)."""
    fwd = gpipe_forward(stage_fn, mesh, axis, n_microbatches)

    def fn(params, x, target):
        y = fwd(params, x)
        return loss_fn(y, target)

    return fn


def stack_stage_params(per_stage_params: list) -> PyTree:
    """[stage0_params, stage1_params, ...] -> stacked tree (S, ...)."""
    return tree_map(lambda *ls: torch.stack(ls), *per_stage_params)


def stage_sharding(mesh, axis: str, params_stacked: PyTree) -> PyTree:
    """DTensor placements of every stacked leaf: dim 0 over `axis`,
    replicated over the mesh's other axes."""
    from torch.distributed.tensor import Replicate, Shard
    placements = tuple(Shard(0) if name == axis else Replicate()
                       for name in mesh.mesh_dim_names)
    return tree_map(lambda _: placements, params_stacked)


def microbatch(x: torch.Tensor, n_microbatches: int) -> torch.Tensor:
    """(B, ...) -> (M, B/M, ...)."""
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError(f"batch {b} does not split into {n_microbatches} "
                         "microbatches")
    return x.reshape(n_microbatches, b // n_microbatches, *x.shape[1:])
