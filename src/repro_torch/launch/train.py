"""Training launcher: data -> train step -> checkpoint / resume -> metrics.
Port of ``repro/launch/train.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b --smoke \
      --steps 20 --global-batch 4 --seq-len 64 --ckpt-dir /tmp/ckpt [--device cpu]

Runs on the CUDA device unless ``--device`` says otherwise; with no card
and no ``--device cpu`` it raises. On the card, attention goes through the
hand-written flash kernels forward and backward (``use_flash``, the
reference's accelerator branch), and the loop replays one captured CUDA
graph of the donating step (``TrainGraph``), the counterpart of the
reference's ``jax.jit(step, donate_argnums=(0,))``; on the CPU the step
runs eagerly, and sequences longer than 512 run the chunked plain forms
(q-chunked attention and MLA, the chunkwise Mamba scan and mLSTM, chunks of
256), as the reference does off its accelerator.
Fault tolerance as in the reference: atomic keep-k checkpoints and
auto-resume from the newest committed step; the data is a pure function of
the step, so a resumed run replays the same batches.

On a device mesh (``train_loop(mesh=)``, or ``torchrun`` with more than one
rank) the state is ``DTensor``s placed by ``launch.specs.train_state_specs``
(ZeRO-3 FSDP over ``data``, tensor parallelism over ``model``), as the
reference's ``jax.jit(..., in_shardings=, out_shardings=)``:

  torchrun --nproc-per-node 2 -m repro_torch.launch.train --arch gemma3-1b \
      --smoke --steps 20 --global-batch 4 --seq-len 64

trains on the reference's default mesh ``(world, 1)``, one card per rank
(``LOCAL_RANK``) over NCCL, or with ``--device cpu`` one process per rank
over gloo. Only rank 0 logs.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch
import torch.distributed as dist

from repro_torch import _device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.launch import mesh as lmesh
from repro_torch.models import common as cc
from repro_torch.models.registry import get_api
from repro_torch.obs.device import count, span
from repro_torch.parallel.sharding import ShardingRules, activation_resolver
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import (device_batch, init_train_state,
                                             make_train_step)


class TrainGraph:
    """A donating train step (``make_train_step(..., donate=True)``)
    captured once as a CUDA graph and replayed once per step.

    ``state`` is the static state: the step updates its tensors in place,
    so ``self.state`` always holds the newest params and moments (what a
    checkpoint saves). Each call copies the batch into static buffers
    (``tokens``, ``labels`` and a family's ``frames`` / ``patches``),
    replays, and returns the static metric tensors. The first call is the
    warm-up that autograd and the kernels need before a capture: it runs
    the step eagerly on the side stream, in place on the state, and that
    is this call's step; then the graph is captured, which runs nothing. So
    no step is applied twice. A failed capture raises; nothing falls back to the
    eager step. The graph holds the memory of the step's intermediates until
    ``release``.

    Launch counting: the warm-up's flash launches count as they run; the
    capture records ``held`` (wrapper -> launches in the graph, from
    ``flash_kernel.CAPTURED``) and every replay adds them to ``LAUNCHES``.

    With a recorder installed (``obs.recording``) a call is the span
    ``train.step``, holding ``train.feed`` (the copies into the static
    buffers) and ``train.replay``, or on the first call the eager step and
    ``train.capture``; each replay adds one to the counter
    ``train.graph.replays`` (``obs/device.py``)."""

    def __init__(self, step_fn, state):
        self.step_fn = step_fn
        self.state = state
        self.batch: dict = {}
        self.metrics: dict = {}
        self.graph = None
        self.held: dict = {}

    def __call__(self, batch: dict) -> dict:
        with span("train.step"):
            if self.graph is None:
                return self._first(batch)
            with span("train.feed"):
                for k, v in batch.items():
                    self.batch[k].copy_(v)
            with span("train.replay"):
                self.graph.replay()
            count("train.graph.replays")
        flash_kernel.count_replays(self.held)
        return self.metrics

    def _first(self, batch: dict) -> dict:
        """The eager step on the side stream, then the capture."""
        dev = next(iter(batch.values())).device
        with span("train.feed"):
            self.batch = {k: v.clone() for k, v in batch.items()}
        side = _device.side_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        before = dict(flash_kernel.CAPTURED)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            _, metrics = self.step_fn(self.state, self.batch)   # this step
            # capture_begin, not torch.cuda.graph(): that one empties the
            # allocator's cache first (see launch/serve.py::DecodeGraph)
            with span("train.capture"):
                graph.capture_begin()
                try:
                    _, self.metrics = self.step_fn(self.state, self.batch)
                finally:
                    graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = graph
        self.held = {k: flash_kernel.CAPTURED[k] - n for k, n in before.items()}
        return metrics

    def release(self) -> None:
        """Free the graph and its memory pool."""
        if self.graph is not None:
            self.graph.reset()


def _mesh_for_launch(mesh, device):
    """The mesh the loop trains on: ``mesh`` as given; else, in a process
    group of several ranks (``torchrun`` with ``WORLD_SIZE`` > 1, whose
    group this starts, on the card ``LOCAL_RANK`` names), the reference's
    default ``(world, 1)`` over ``("data", "model")``; else None (the plain
    loop)."""
    if mesh is not None:
        return mesh
    world = dist.get_world_size() if dist.is_initialized() \
        else lmesh.launched_world()
    if world <= 1:
        return None
    return lmesh.make_mesh_for(world, device)


def train_loop(cfg, steps: int, global_batch: int, seq_len: int,
               ckpt_dir: str = "", ckpt_every: int = 50, keep_k: int = 3,
               lr: float = 3e-4, seed: int = 0, log_every: int = 10,
               resume: bool = True, log=print, schedule_steps: int = 0,
               device=None, mesh=None):
    """Train ``cfg`` from a fresh init (or the newest checkpoint in
    ``ckpt_dir``) up to ``steps``. Returns (state, history): one dict per
    logged step with the step's metrics as floats, ``step``, ``elapsed_s``
    (seconds since the loop started, rounded, as the reference logs it)
    and ``step_s``: the wall time from the step's start to its metrics on
    the host. Reading metrics waits for the card, so with ``log_every=1``
    ``step_s`` is the time of that step alone.

    ``schedule_steps`` is the planned total, so that a run stopped at
    ``steps`` and resumed later sees the same LR schedule. Checkpoints are
    saved every ``ckpt_every`` steps and at the end (unless the end step is
    already committed). The RUNTIME knobs the loop sets are restored when it
    returns.

    On the card the steps run through a ``TrainGraph`` built from the state
    the loop starts from (fresh or restored): the first step runs eagerly
    and the rest replay the graph, which is freed when the loop returns.
    The returned state is the graph's static state. With a recorder
    installed (``obs.recording``) each batch's copy to the device is the
    span ``train.feed`` (``obs/device.py``).

    ``mesh``: a ``DeviceMesh`` over ``("data", "model")``
    (``launch.mesh.device_mesh``). With one, or in a process group of
    several ranks (then the mesh is ``make_mesh_for(world)``, ``(world,
    1)``), the state is ``DTensor``s placed by ``train_state_specs`` under
    ``ShardingRules(mesh, fsdp=mesh.size() > 1)``, the step keeps their
    placements, the activation rules are pushed around the loop, and
    every rank reads the whole batch. On the card each rank runs the flash
    kernels on its local shards, and the step is captured as on one card.
    Checkpoints hold the whole state (``CheckpointManager``), so a run
    resumes on any mesh or none. Only rank 0 logs; every rank returns the
    same history. Without a mesh and without such a group, the loop is the
    plain one above."""
    mesh = _mesh_for_launch(mesh, device)
    dev = _device.resolve(device)      # after a launch picked the rank's card
    rules = None
    if mesh is not None:
        rules = ShardingRules(mesh=mesh, fsdp=mesh.size() > 1)
        if dist.get_rank() != 0:
            log = lambda *_: None
    api = get_api(cfg)
    sched = schedule_steps or steps
    opt_cfg = AdamWConfig(learning_rate=lr, warmup_steps=min(20, sched // 10),
                          total_steps=sched)
    if dev.type == "cuda":
        # the hand-written attention kernels, forward and backward
        knobs = {"use_flash": True, "q_chunk": 0}
    else:
        knobs = {"q_chunk": 256, "ssm_chunk": 256, "mlstm_chunk": 256} \
            if seq_len > 512 else {}
    saved_knobs = {k: cc.RUNTIME[k] for k in knobs}
    cc.RUNTIME.update(knobs)
    graph = None
    if rules is not None:
        cc.push_logical_rules(activation_resolver(rules))
    try:
        state = init_train_state(cfg, seed, opt_cfg, dev, rules)
        # a state on a mesh steps in place (the reference donates it)
        step_fn = make_train_step(cfg, opt_cfg, api) if rules is None \
            else make_train_step(cfg, opt_cfg, api, donate=True)
        data = SyntheticLM(cfg, SyntheticConfig(global_batch=global_batch,
                                                seq_len=seq_len, seed=seed))
        start_step = 0
        mgr = None
        if ckpt_dir:
            mgr = CheckpointManager(ckpt_dir, keep_k=keep_k)
            if resume:
                latest = mgr.restore_latest(state)
                if latest is not None:
                    start_step, state, _ = latest
                    log(f"resumed from step {start_step}")

        graph = (TrainGraph(make_train_step(cfg, opt_cfg, api, donate=True),
                            state) if dev.type == "cuda" else None)
        history = []
        t0 = time.perf_counter()
        for step, batch in data.iter(start_step):
            if step >= steps:
                break
            t_step = time.perf_counter()
            with span("train.feed"):
                tb = device_batch(cfg, batch, dev)
            if graph is not None:
                metrics = graph(tb)
            else:
                state, metrics = step_fn(state, tb)
            if step % log_every == 0 or step == steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step
                m["step_s"] = time.perf_counter() - t_step
                m["elapsed_s"] = round(time.perf_counter() - t0, 1)
                history.append(m)
                log(f"step {step:5d} loss {m['loss']:.4f} "
                    f"lr {m['lr']:.2e} gnorm {m['grad_norm']:.2f}")
            if mgr and (step + 1) % ckpt_every == 0:
                mgr.save(step + 1, state, extra={"data_step": step + 1})
        if mgr and steps not in mgr.committed_steps():
            mgr.save(steps, state, extra={"data_step": steps})
    finally:
        cc.RUNTIME.update(saved_knobs)
        if rules is not None:
            cc.pop_logical_rules()
        if graph is not None:
            graph.release()
    return state, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
        cfg = dataclasses.replace(cfg, remat=False)
    started = not dist.is_initialized()    # under torchrun the loop starts it
    try:
        _, history = train_loop(cfg, args.steps, args.global_batch,
                                args.seq_len, ckpt_dir=args.ckpt_dir,
                                ckpt_every=args.ckpt_every, lr=args.lr,
                                seed=args.seed, device=args.device)
        rank = dist.get_rank() if dist.is_initialized() else 0
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    first, last = history[0]["loss"], history[-1]["loss"]
    if rank == 0:
        print(f"loss {first:.4f} -> {last:.4f} "
              f"({'improved' if last < first else 'NOT improved'})")


if __name__ == "__main__":
    main()
