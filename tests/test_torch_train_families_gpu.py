"""Training the reduced model families on the card against the CPU. Imports
no JAX, so that it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_train_families_gpu.py

``reduce_for_smoke`` of olmoe-1b-7b (MoE), deepseek-v2-236b (MLA and MoE),
jamba-1.5-large-398b (Mamba, attention and MoE), xlstm-125m (mLSTM and
sLSTM), whisper-small (encoder-decoder) and internvl2-1b (VLM), fp32 with
remat on as configured, the same seeded params on both devices: three
``make_train_step`` steps on ``SyntheticLM`` batches, on the card with the
knobs ``launch/train.py::train_loop`` sets there (``use_flash`` on: the
flash forward and backward on every causal attention layer; ``q_chunk``
0), on the CPU with the plain path. TF32 off.

Held per step: the metrics at 1e-5 and the params at atol 5e-5 + rtol
1e-4 (``tests/test_torch_train_step.py``'s tolerances), and the gradient
of the loss at each step's params, leaf by leaf, at rtol ``GRAD_TOL`` and
atol ``GRAD_TOL`` x the leaf's largest CPU gradient (Mamba's ``dt_proj``
gradients are ~2e-6 in all). The params are compared on every element
whose CPU gradient never fell in (0, ``NEAR_EPS``] (an exact zero, as an
unused embedding row's, is held). There AdamW's first moves divide float
noise by its eps (1e-8): on reduced jamba a Mamba ``out_proj`` element
with gradient -6.4e-10 on the CPU and 4.2e-9 on the card (5e-9 apart,
against the leaf's largest gradient of 2.6e-3) moves 7e-5 apart after one
step, as ``test_torch_train_step.py``'s docstring foresees. Such elements
are held through their gradients only, and must stay under 5% of the
params (jamba's Mamba leaves, whose gradients are small throughout, put
4.2% there; the other families at most 1.4%). Without a CUDA card every
test skips (the kernels have no CPU mode)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch import _graph
from repro_torch._tree import leaves, tree_map
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.data.synthetic import SyntheticConfig, make_batch
from repro_torch.kernels.flash_attention import kernel as tflash
from repro_torch.models import common as tcommon
from repro_torch.models.registry import get_api
from repro_torch.training import optimizer as topt
from repro_torch.training import train_step as ttrain_step

from _torch_flash_launches import wgmma_share

FAMILIES = ["olmoe-1b-7b", "deepseek-v2-236b", "jamba-1.5-large-398b",
            "xlstm-125m", "whisper-small", "internvl2-1b"]
TOL = 1e-5                            # tests/test_torch_train_step.py
PARAM_ATOL, PARAM_RTOL = 5e-5, 1e-4   # tests/test_torch_train_step.py
GRAD_TOL = 1e-4                       # tests/test_torch_lm_families.py
NEAR_EPS = 1e-7                       # 10 x AdamW's eps
OPT = dict(learning_rate=1e-3, warmup_steps=1, total_steps=3)
STEPS = 3


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _run(cfg, params, device, knobs):
    """Three steps from ``params`` on ``device`` under ``knobs``: per step
    (metrics as floats, the gradient at the step's params and the new
    params, as CPU tensors)."""
    api = get_api(cfg)
    state = ttrain_step.TrainState(params, topt.adamw_init(params))
    step = ttrain_step.make_train_step(cfg, topt.AdamWConfig(**OPT), api)
    old = {k: tcommon.RUNTIME[k] for k in knobs}
    tcommon.RUNTIME.update(knobs)
    out = []
    try:
        for i in range(STEPS):
            b = ttrain_step.device_batch(
                cfg, make_batch(cfg, SyntheticConfig(2, 32, seed=0), i), device)
            p = tree_map(lambda t: t.detach().requires_grad_(True), state.params)
            grads = torch.autograd.grad(api.loss_and_metrics(p, cfg, b)[0],
                                        leaves(p))
            state, m = step(state, b)
            out.append(({k: float(v) for k, v in m.items()},
                        [g.cpu() for g in grads],
                        [t.detach().cpu() for t in leaves(state.params)]))
    finally:
        tcommon.RUNTIME.update(old)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("arch", FAMILIES)
def test_reduced_family_trains_on_cuda_as_on_cpu(arch):
    _need_cuda()
    old_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = reduce_for_smoke(get_config(arch))
        assert cfg.remat
        params = get_api(cfg).init_params(cfg, seed=0, device="cpu")
        want = _run(cfg, params, "cpu", {"use_flash": False})
        _graph.reset()
        got = _run(cfg, tree_map(lambda t: t.cuda(), params), "cuda",
                   {"use_flash": True, "q_chunk": 0})
        launches = dict(tflash.LAUNCHES)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old_tf32
    causal = sum(seg.count * sum(l.kind == "attn" and l.attn.causal
                                 for l in seg.layers) for seg in cfg.segments)
    # per causal attention layer, step and backward pass (the gradient's and
    # the train step's): the forward, its recompute under remat, the backward
    assert launches == {"flash_attention": 4 * causal * STEPS,
                        "flash_attention.wgmma": wgmma_share(cfg, 4 * causal * STEPS),
                        "flash_attention_bwd": 2 * causal * STEPS}
    # elements whose CPU gradient never fell in (0, NEAR_EPS]: an exact zero
    # (an unused embedding row, an expert no token reached) is held too
    held = [~((g > 0) & (g <= NEAR_EPS)).any(0) for g in (
        torch.stack([step[1][j].abs() for step in want])
        for j in range(len(want[0][1])))]
    n_held = sum(int(h.sum()) for h in held)
    n_all = sum(h.numel() for h in held)
    assert n_all - n_held <= 0.05 * n_all, (n_all - n_held, n_all)
    for i, ((gm, gg, gp), (wm, wg, wp)) in enumerate(zip(got, want)):
        assert sorted(gm) == sorted(wm) == ["aux", "ce", "grad_norm", "loss", "lr"]
        for k in wm:
            np.testing.assert_allclose(gm[k], wm[k], rtol=TOL, atol=TOL,
                                       err_msg=f"{arch}: {k} after step {i}")
        for j, (g, w) in enumerate(zip(gg, wg)):
            torch.testing.assert_close(g, w, rtol=GRAD_TOL,
                                       atol=GRAD_TOL * w.abs().max().item(),
                                       msg=lambda m: f"{arch}: gradient {j} "
                                                     f"at step {i}: {m}")
        for j, (g, w, h) in enumerate(zip(gp, wp, held)):
            torch.testing.assert_close(g[h], w[h], rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL,
                                       msg=lambda m: f"{arch}: params {j} "
                                                     f"after step {i}: {m}")
    assert max((a - b).abs().max().item()
               for a, b in zip(want[-1][2], leaves(params))) > 1e-4
