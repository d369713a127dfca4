"""The port stands alone: no JAX, no ``repro``, and no silent CPU fallback."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import gnn as tgnn
from repro_torch.core import train as ttrain
from repro_torch.core.graph import paper_fig1_graph
from repro_torch.kernels.decode_attention import kernel as tdec_kernel
from repro_torch.kernels.flash_attention import kernel as tflash_kernel
from repro_torch.kernels.gcn_spmm import kernel as tkernel
from repro_torch.kernels.gcn_spmm import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain_launch
from repro_torch.models import decoder_lm as tdlm

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for m in mods:
    importlib.import_module(m)
bad = [m for m in sys.modules
       if m in ("jax", "repro") or m.startswith(("jax.", "repro."))]
assert not bad, bad
print(" ".join(mods))
"""


def test_every_port_module_imports_without_jax_or_repro():
    # a subprocess: this pytest session has imported jax already (conftest)
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL],
                          env=dict(os.environ, PYTHONPATH=SRC),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    mods = proc.stdout.split()
    assert len(mods) >= 53          # every module of the slices so far
    for m in ("repro_torch.checkpoint", "repro_torch.checkpoint.manager",
              "repro_torch.launch.train", "repro_torch.training.train_step",
              "repro_torch.kernels.flash_attention.kernel",
              "repro_torch.kernels.flash_attention.ops",
              "repro_torch.kernels.decode_attention.kernel"):
        assert m in mods, m


def _tiny_cpu_setup():
    cfg = tgnn.GNNConfig(hidden=8, n_classes=3)
    graph = paper_fig1_graph()
    feats = graph.node_features()
    ex = ttrain.GraphExample(feats, graph.latency.astype(np.float32),
                             np.zeros(graph.n, np.int64),
                             np.ones(graph.n, np.float32))
    return cfg, graph, ex


ENTRY_POINTS = {
    "init": lambda cfg, g, ex: tgnn.init(cfg, ex.feats.shape[1]),
    "train_gnn": lambda cfg, g, ex: ttrain.train_gnn(cfg, [ex], steps=1),
    "predict_logits": lambda cfg, g, ex: ttrain.predict_logits(
        tgnn.init(cfg, ex.feats.shape[1], device="cpu"), cfg, g),
    "predict": lambda cfg, g, ex: ttrain.predict(
        tgnn.init(cfg, ex.feats.shape[1], device="cpu"), cfg, g),
    "params_from_numpy": lambda cfg, g, ex: tgnn.params_from_numpy(
        tgnn.params_to_numpy(tgnn.init(cfg, ex.feats.shape[1], device="cpu"))),
    "lm.init_params": lambda *_: tdlm.init_params(_lm_cfg()),
    "lm.params_from_numpy": lambda *_: tdlm.params_from_numpy(
        tdlm.params_to_numpy(tdlm.init_params(_lm_cfg(), device="cpu"))),
    "lm.init_caches": lambda *_: tdlm.init_caches(_lm_cfg(), 1, 8),
    # a serving session as a user starts one: params at their default device
    "serve_batch": lambda *_: tserve.serve_batch(
        _lm_cfg(), tdlm.init_params(_lm_cfg()),
        {"tokens": np.zeros((1, 4), np.int32)}, 2),
    "serve.main": lambda *_: tserve.main(["--arch", "gemma3-1b", "--smoke"]),
    # a training run as a user starts one
    "train_loop": lambda *_: ttrain_launch.train_loop(_lm_cfg(), 1, 1, 8),
    "train.main": lambda *_: ttrain_launch.main(["--arch", "gemma3-1b", "--smoke"]),
}


def _lm_cfg():
    return reduce_for_smoke(get_config("gemma3-1b"))


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_points_default_to_cuda_and_never_fall_back(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, graph, ex = _tiny_cpu_setup()
    with pytest.raises(RuntimeError, match="CUDA"):
        ENTRY_POINTS[entry](cfg, graph, ex)


def test_entry_points_run_on_cpu_when_asked():
    cfg, graph, ex = _tiny_cpu_setup()
    params, hist = ttrain.train_gnn(cfg, [ex], steps=2, device="cpu")
    assert len(hist) == 2
    logits = ttrain.predict_logits(params, cfg, graph, device="cpu")
    assert logits.shape == (graph.n, cfg.n_classes)
    assert np.isfinite(logits).all()


def test_predict_refuses_params_on_another_device():
    cfg, graph, ex = _tiny_cpu_setup()
    params = tgnn.init(cfg, ex.feats.shape[1], device="cpu")
    with pytest.raises(ValueError, match="params lie on"):
        ttrain.predict_logits(params, cfg, graph, device="meta")


def test_kernel_wrapper_refuses_cpu_tensors_instead_of_falling_back():
    a, h = torch.ones(4, 4), torch.ones(4, 3)
    before = dict(tkernel.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA device"):
        tkernel.scaled_spmm(a, h, torch.ones(4), torch.ones(4))
    with pytest.raises(ValueError, match="CUDA device"):
        tkernel.spmm(a, h)
    assert tkernel.LAUNCHES == before


def test_attention_kernel_wrappers_refuse_cpu_tensors_without_a_launch():
    q, k = torch.ones(1, 8, 2, 16), torch.ones(1, 8, 1, 16)
    before = (dict(tflash_kernel.LAUNCHES), dict(tdec_kernel.LAUNCHES))
    with pytest.raises(ValueError, match="CUDA device"):
        tflash_kernel.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="CUDA device"):
        tflash_kernel.flash_attention_bwd(q, k, k, q, torch.zeros(1, 2, 8), q)
    with pytest.raises(ValueError, match="CUDA device"):
        tdec_kernel.decode_attention(q[:, :1], k, k,
                                     torch.ones(8, dtype=torch.int32))
    assert (tflash_kernel.LAUNCHES, tdec_kernel.LAUNCHES) == before


def test_serve_runs_on_cpu_when_asked(capsys):
    tserve.main(["--arch", "gemma3-1b", "--smoke", "--device", "cpu",
                 "--batch", "2", "--prompt-len", "12", "--gen", "3"])
    out = capsys.readouterr().out
    assert "generated shape (2, 3)" in out and "backend=cpu" in out


def test_train_runs_on_cpu_when_asked(capsys):
    ttrain_launch.main(["--arch", "gemma3-1b", "--smoke", "--device", "cpu",
                        "--steps", "3", "--global-batch", "2", "--seq-len", "16"])
    assert "loss " in capsys.readouterr().out


def test_ops_refuse_devices_other_than_cuda_and_cpu():
    a = torch.empty(4, 4, device="meta")
    h = torch.empty(4, 3, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tops.spmm(a, h)


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run for real")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
