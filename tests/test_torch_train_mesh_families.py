"""``train_loop(mesh=)`` for the families beyond dense and xLSTM, on a
``(data 2, model 1)`` mesh of two CPU gloo ranks: olmoe-1b-7b (MoE),
deepseek-v2 (MLA + MoE), jamba-1.5-large (Mamba + attention + MoE),
whisper-small (encoder-decoder) and internvl2-1b (VLM), each reduced, one
step from its seed. Each is held to the port's plain loop from the same
seed and data (the plain loop is held to the reference by the families'
own tests), at ``tests/test_torch_train_mesh.py``'s tolerances: metrics
1e-5, params atol 5e-5 + rtol 1e-4. A MoE layer routes each group on its
whole tokens on every rank (``mlp._route``), so the capacity drops are the
plain loop's.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch.checkpoint import manager as tckpt
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.launch import train as tlaunch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
FAMILIES = ["olmoe-1b-7b", "deepseek-v2-236b", "jamba-1.5-large-398b",
            "whisper-small", "internvl2-1b"]
LOOP = dict(global_batch=4, seq_len=32, lr=1e-3, log_every=1, device="cpu")
METRIC_TOL = 1e-5
PARAM_ATOL, PARAM_RTOL = 5e-5, 1e-4

_RANK = r"""
import json, os, sys
sys.path.insert(0, sys.argv[3])
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.launch import mesh as lm
from repro_torch.launch import train as tl
rank, port, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[4]
loop = json.loads(sys.argv[5])
lm.init_process_group("gloo", world_size=2, rank=rank, port=port)
mesh = lm.device_mesh((2, 1), ("data", "model"), device="cpu")
for arch in json.loads(sys.argv[6]):
    state, hist = tl.train_loop(reduce_for_smoke(get_config(arch)), 1,
                                mesh=mesh, log=lambda *a: None, **loop)
    full = [t.full_tensor().detach().numpy()
            for t in ckpt._flatten_with_names(state.params)[0]]
    if rank == 0:
        np.savez(os.path.join(work, arch + ".npz"), *full)
        with open(os.path.join(work, arch + ".json"), "w") as f:
            json.dump(hist, f)
dist.barrier()
dist.destroy_process_group()
print("RANK_OK", rank, flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Both ranks train every family one step; rank 0 keeps the results."""
    work = str(tmp_path_factory.mktemp("families"))
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(port), SRC, work,
         json.dumps(LOOP), json.dumps(FAMILIES)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env) for r in range(2)]
    outs = [p.communicate(timeout=400) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0 and "RANK_OK" in o, o + e[-6000:]
    return work


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_steps_on_a_2x1_mesh_as_the_plain_loop(mesh_runs, arch):
    state, plain = tlaunch.train_loop(reduce_for_smoke(get_config(arch)), 1,
                                      log=lambda *a: None, **LOOP)
    with open(os.path.join(mesh_runs, arch + ".json")) as f:
        hist = json.load(f)
    assert len(hist) == len(plain) == 1
    for k in ("loss", "ce", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(hist[0][k], plain[0][k], rtol=METRIC_TOL,
                                   atol=METRIC_TOL, err_msg=k)
    want = [t.detach().float().numpy()
            for t in tckpt._flatten_with_names(state.params)[0]]
    with np.load(os.path.join(mesh_runs, arch + ".npz")) as z:
        got = [z[f"arr_{i}"] for i in range(len(z.files))]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=PARAM_RTOL, atol=PARAM_ATOL)
