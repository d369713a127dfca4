"""``train_loop(mesh=)`` on the card, over NCCL. Imports no JAX, so that it
runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_train_mesh_gpu.py

* The ``(1, 1)`` mesh of one card: reduced gemma3-1b in bf16 with the flash
  kernels on (remat on, TF32 off), 3 steps of the mesh loop (a captured
  step over ``DTensor``s) against the plain card loop from the same seed.
  On one rank every leaf is whole, so the two run the same kernels in the
  same order: metrics at rtol 1e-5 (and equal bit for bit in the card
  runs so far), params at bf16's own tolerance (``torch.testing``'s
  default, rtol 1.6e-2 / atol 1e-5). The flash launches per step must be
  the plain loop's.
* Two NCCL ranks, one card each, on ``(2, 1)``: reduced gemma3-1b in fp32
  with the flash kernels, 3 steps of the mesh loop against the plain card
  loop at ``tests/test_torch_train_step.py``'s tolerances (metrics 1e-5,
  params atol 5e-5 + rtol 1e-4), as ``tests/test_torch_train_mesh.py``
  holds the CPU meshes. Needs two cards: with fewer it skips and says why.

Without a CUDA card every test skips (the kernels have no CPU mode)."""
import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch import _graph
from repro_torch._tree import leaves
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.kernels.flash_attention import kernel as tflash
from repro_torch.launch import train as launch_train

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
STEPS = 3
LOOP = dict(global_batch=4, seq_len=64, lr=1e-3, log_every=1,
            log=lambda *a: None)


def _need_cuda(n: int = 1):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA cards for {n} NCCL ranks, this machine "
                    f"shows {torch.cuda.device_count()}")


@pytest.fixture
def no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


def _cfg(dtype: str):
    return dataclasses.replace(reduce_for_smoke(get_config("gemma3-1b")),
                               dtype=dtype)


@pytest.mark.gpu
def test_one_card_mesh_step_equals_the_plain_card_step(no_tf32):
    _need_cuda()
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh_for
    cfg = _cfg("bfloat16")
    _graph.reset()
    plain_state, plain = launch_train.train_loop(cfg, STEPS, **LOOP)
    plain_launches = dict(tflash.LAUNCHES)
    _graph.reset()
    mesh = make_mesh_for(1)
    try:
        assert dist.get_backend() == "nccl"
        state, hist = launch_train.train_loop(cfg, STEPS, mesh=mesh, **LOOP)
        mesh_launches = dict(tflash.LAUNCHES)
        params = [t.full_tensor() for t in leaves(state.params)]
        step = state.opt.step.full_tensor()
    finally:
        dist.destroy_process_group()
    assert mesh_launches == plain_launches
    assert mesh_launches["flash_attention_bwd"] == cfg.n_layers * STEPS
    assert int(step) == STEPS
    for got, want in zip(hist, plain):
        for k in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=0,
                                       err_msg=f"{k} at step {got['step']}")
    for got, want in zip(params, leaves(plain_state.params)):
        assert got.dtype == want.dtype
        torch.testing.assert_close(got, want)


_RANK = r"""
import dataclasses, json, os, sys
sys.path.insert(0, sys.argv[3])
import torch
torch.backends.cuda.matmul.allow_tf32 = False
import torch.distributed as dist
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.kernels.flash_attention import kernel as tflash
from repro_torch.launch import mesh as lm
from repro_torch.launch import train as tl
rank, port, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[4]
torch.cuda.set_device(rank)
lm.init_process_group("nccl", world_size=2, rank=rank, port=port)
mesh = lm.device_mesh((2, 1), ("data", "model"))
cfg = reduce_for_smoke(get_config("gemma3-1b"))
loop = json.loads(sys.argv[5])
state, hist = tl.train_loop(cfg, loop.pop("steps"), mesh=mesh,
                            log=lambda *a: None, **loop)
full = [t.full_tensor().cpu() for t in ckpt._flatten_with_names(state.params)[0]]
if rank == 0:
    torch.save({"hist": hist, "params": full,
                "launches": dict(tflash.LAUNCHES)},
               os.path.join(work, "mesh.pt"))
dist.barrier()
dist.destroy_process_group()
print("RANK_OK", rank, flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.gpu
def test_two_nccl_ranks_match_the_plain_card_loop(no_tf32, tmp_path):
    _need_cuda(2)
    from repro_torch.checkpoint import manager as ckpt
    cfg = _cfg("float32")
    plain_state, plain = launch_train.train_loop(cfg, STEPS, **LOOP)
    loop = {k: v for k, v in LOOP.items() if k != "log"}
    loop["steps"] = STEPS
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(port), SRC, str(tmp_path),
         json.dumps(loop)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env) for r in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0 and "RANK_OK" in o, o + e[-6000:]
    got = torch.load(tmp_path / "mesh.pt")
    # each rank runs the kernels on its half of the batch
    assert got["launches"]["flash_attention_bwd"] == cfg.n_layers * STEPS
    for g, w in zip(got["hist"], plain):
        for k in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-5,
                                       err_msg=f"{k} at step {g['step']}")
    want = [t.cpu() for t in ckpt._flatten_with_names(plain_state.params)[0]]
    for g, w in zip(got["params"], want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=5e-5)
