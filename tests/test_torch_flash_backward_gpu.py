"""The hand-written flash-attention backward on the card, against the plain
version's autograd. Imports no JAX, so that it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_flash_backward_gpu.py

Covers every head dim, causal and sliding-window masks, GQA groups 1, 4 and
8, ragged S and T off the tiles, S 1, a window wider than S, T != S, the
training shapes of gemma3-1b; the bf16 body's edges (S and T off its 64-row
tiles, the cross-head sum at G 1, 2, 4 and 8, a grid with fewer items than
SMs and one with several items a block, head dims below its width) and
phi3-mini's attention (head_dim 96); repeat calls (same bits); the autograd
Function under ``torch.utils.checkpoint``; and one full training step of a
full-width, two-layer gemma3-1b with the kernels against the same step on
the plain path. Tolerances: fp32 1e-4 (atol and rtol), bf16 2e-2
(``tests/test_kernels.py::_tol``). Without a CUDA card every test skips (the
kernels have no CPU mode)."""
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch.configs import get_config
from repro_torch.configs.base import Segment
from repro_torch.data.synthetic import SyntheticConfig, make_batch
from repro_torch.kernels.flash_attention import kernel as tflash
from repro_torch.kernels.flash_attention import ops as tflash_ops
from repro_torch.kernels.flash_attention import ref as tflash_ref
from repro_torch.models import common as tcommon
from repro_torch.models import decoder_lm as tdlm
from repro_torch.training import optimizer as topt
from repro_torch.training import train_step as ttrain_step

BWD_CASES = [
    # (B, S, T, H, KV, D, causal, window, dtype)
    (1, 128, 128, 4, 4, 64, True, None, "float32"),      # G 1
    (2, 100, 100, 8, 2, 32, True, 16, "float32"),        # G 4, ragged S
    (1, 77, 77, 8, 1, 128, True, None, "float32"),       # G 8
    (1, 40, 40, 4, 1, 256, True, 16, "float32"),
    (2, 67, 67, 4, 1, 16, True, 5, "float32"),
    (1, 1, 1, 4, 1, 64, True, None, "float32"),          # S 1
    (1, 50, 50, 4, 4, 64, True, 100, "float32"),         # window wider than S
    (1, 45, 72, 8, 2, 64, True, None, "float32"),        # T > S: keys no row sees
    (1, 45, 72, 8, 2, 64, False, None, "float32"),       # no causal mask
    (2, 512, 512, 4, 1, 256, True, 128, "float32"),
    (1, 128, 128, 4, 4, 64, True, None, "bfloat16"),
    (2, 100, 100, 8, 2, 32, True, 16, "bfloat16"),
    (1, 77, 77, 8, 1, 128, True, None, "bfloat16"),
    (1, 40, 40, 4, 1, 256, True, 16, "bfloat16"),
    (2, 67, 67, 4, 1, 16, True, 5, "bfloat16"),
    (1, 1, 1, 4, 1, 64, True, None, "bfloat16"),
    (1, 50, 50, 4, 4, 64, True, 100, "bfloat16"),
    (1, 45, 72, 8, 2, 64, True, None, "bfloat16"),
    (1, 45, 72, 8, 2, 64, False, None, "bfloat16"),
    (2, 300, 300, 16, 2, 128, True, 64, "bfloat16"),     # G 8, both accumulators
    (4, 1024, 1024, 4, 1, 256, True, 512, "bfloat16"),   # gemma3-1b training:
    (4, 1024, 1024, 4, 1, 256, True, None, "bfloat16"),  # local and global
]
# the bf16 body's edges: 64-row tiles of keys and queries, per-head items
# summed over the G heads of a kv head, a persistent grid of one block per SM
BWD_EDGE_CASES = [
    (1, 100, 100, 8, 2, 128, True, None, "bfloat16"),     # S, T off the tile
    (2, 200, 200, 4, 1, 256, True, 48, "bfloat16"),
    (1, 192, 192, 4, 4, 128, True, None, "bfloat16"),     # G 1: no partials
    (1, 130, 130, 4, 2, 256, True, None, "bfloat16"),     # G 2
    (1, 128, 128, 8, 1, 256, True, None, "bfloat16"),     # G 8
    (1, 256, 256, 2, 1, 128, True, None, "bfloat16"),     # 8 items: B KV 1
    (8, 512, 512, 8, 2, 128, True, None, "bfloat16"),     # 512 items a pass
    (1, 1, 1, 4, 1, 256, True, None, "bfloat16"),         # S 1
    (1, 100, 100, 4, 2, 256, True, 300, "bfloat16"),      # window wider than S
    (1, 70, 200, 4, 2, 128, True, None, "bfloat16"),      # T > S
    (1, 70, 200, 4, 2, 128, False, None, "bfloat16"),
    (1, 100, 150, 4, 1, 256, False, 64, "bfloat16"),      # window, no causal
    (1, 90, 90, 4, 2, 32, True, 20, "bfloat16"),          # D 32 at width 128
    (1, 96, 96, 4, 4, 96, True, None, "float32"),         # head_dim 96, fp32
]
# phi3-mini's attention: 32 heads, 32 kv heads, head_dim 96 (run at width 128)
PHI3_CASE = (1, 1024, 1024, 32, 32, 96, True, None, "bfloat16")
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def bwd_inputs(case, seed=0):
    """q, k, v, dO on the card in the case's dtype, from a seeded numpy
    generator."""
    b, s, t, h, kv, d, _, _, dtype = case
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        "cuda", dt) for shape in ((b, s, h, d), (b, t, kv, d), (b, t, kv, d),
                                  (b, s, h, d))]


def plain_grads(q, k, v, do, causal, window):
    """The plain version's autograd (fp32 math), grads in the inputs' dtype."""
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o = tflash_ref.attention_ref(*leaves, causal=causal, window=window)
    return torch.autograd.grad(o, leaves, do)


def kernel_grads(q, k, v, do, causal, window):
    o, lse = tflash.flash_attention(q, k, v, causal=causal, window=window,
                                    return_lse=True)
    return tflash.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                      window=window), lse


@pytest.mark.gpu
@pytest.mark.parametrize("case", BWD_CASES + BWD_EDGE_CASES + [PHI3_CASE])
def test_backward_kernel_matches_plain_autograd(case):
    _need_cuda()
    causal, window, dtype = case[6], case[7], case[8]
    q, k, v, do = bwd_inputs(case)
    before = tflash.LAUNCHES["flash_attention_bwd"]
    (dq, dk, dv), lse = kernel_grads(q, k, v, do, causal, window)
    torch.cuda.synchronize()
    assert tflash.LAUNCHES["flash_attention_bwd"] == before + 1
    want = plain_grads(q, k, v, do, causal, window)
    for name, got, w, x in zip("qkv", (dq, dk, dv), want, (q, k, v)):
        assert got.dtype == x.dtype and got.shape == x.shape and got.is_contiguous()
        assert bool(torch.isfinite(got.float()).all()), f"d{name}"
        torch.testing.assert_close(got.float(), w.float(), rtol=TOL[dtype],
                                   atol=TOL[dtype], msg=f"d{name} at {case}")
    lse_want = tflash_ref.attention_lse_ref(q, k, causal=causal, window=window)
    torch.testing.assert_close(lse, lse_want, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [BWD_CASES[9], BWD_CASES[-1], BWD_CASES[-2],
                                  BWD_CASES[-3], BWD_EDGE_CASES[4]])
def test_backward_repeat_calls_give_the_same_bits(case):
    _need_cuda()
    causal, window = case[6], case[7]
    q, k, v, do = bwd_inputs(case, seed=1)
    first, _ = kernel_grads(q, k, v, do, causal, window)
    second, _ = kernel_grads(q, k, v, do, causal, window)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_serving_forward_is_unchanged_by_the_lse_output():
    _need_cuda()
    q, k, v, _ = bwd_inputs(BWD_CASES[-2], seed=2)
    plain = tflash.flash_attention(q, k, v, window=512)
    with_lse, _ = tflash.flash_attention(q, k, v, window=512, return_lse=True)
    assert torch.equal(plain, with_lse)


@pytest.mark.gpu
def test_kernel_wrappers_refuse_inputs_that_require_grad():
    _need_cuda()
    q, k, v, _ = bwd_inputs(BWD_CASES[0])
    with pytest.raises(RuntimeError, match="requires grad"):
        tflash.flash_attention(q.requires_grad_(), k, v)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_function_under_checkpoint_matches_plain_autograd(dtype):
    """``ops.flash_attention`` on inputs that require grad, inside
    ``torch.utils.checkpoint`` as the remat'd blocks call it: two forward
    launches (the recompute's log-sum-exp is the one the backward reads)
    and one backward launch, and the plain autograd's gradient."""
    _need_cuda()
    case = (2, 200, 200, 8, 2, 64, True, 48, dtype)
    q, k, v, do = bwd_inputs(case, seed=3)
    want = plain_grads(q, k, v, do, True, 48)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    tflash.reset_launches()
    o = torch.utils.checkpoint.checkpoint(
        lambda q, k, v: tflash_ops.flash_attention(q, k, v, window=48),
        *leaves, use_reentrant=False)
    got = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    assert tflash.LAUNCHES == {"flash_attention": 2, "flash_attention_bwd": 1}
    for name, g, w in zip("qkv", got, want):
        torch.testing.assert_close(g.float(), w.float(), rtol=TOL[dtype],
                                   atol=TOL[dtype], msg=f"d{name}")


def _two_layer_gemma():
    """gemma3-1b at full width with one local and one global layer."""
    cfg = get_config("gemma3-1b")
    local, glob = cfg.segments[0].layers[0], cfg.segments[0].layers[5]
    assert local.attn.window == 512 and glob.attn.window is None
    return dataclasses.replace(cfg, segments=(Segment(count=1,
                                                      layers=(local, glob)),))


@pytest.mark.gpu
def test_train_step_with_kernels_matches_plain_path():
    """One full training step (B 2, S 1024: the chunked CE and the window
    act) with the kernels and with the plain path, from the same bf16
    params. Loss within 2e-2 (bf16); grad norm within 5e-2 relative: the
    plain path rounds scores and softmax weights to bf16 where the kernels
    keep fp32, and the difference passes through every gradient."""
    _need_cuda()
    cfg = _two_layer_gemma()
    params = tdlm.init_params(cfg, seed=0, device="cuda")
    opt_cfg = topt.AdamWConfig(learning_rate=3e-4)
    batch = make_batch(cfg, SyntheticConfig(global_batch=2, seq_len=1024), 0)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    step = ttrain_step.make_train_step(cfg, opt_cfg)
    metrics = {}
    old = tcommon.RUNTIME["use_flash"]
    try:
        for flash in (True, False):
            tcommon.RUNTIME["use_flash"] = flash
            state = ttrain_step.TrainState(params, topt.adamw_init(params))
            tflash.reset_launches()
            new_state, m = step(state, batch)
            torch.cuda.synchronize()
            metrics[flash] = {k: float(x) for k, x in m.items()}
            launches = dict(tflash.LAUNCHES)
            # per layer: forward, remat recompute, backward
            want = {"flash_attention": 4, "flash_attention_bwd": 2} if flash \
                else {"flash_attention": 0, "flash_attention_bwd": 0}
            assert launches == want
            del state, new_state
    finally:
        tcommon.RUNTIME["use_flash"] = old
    on, off = metrics[True], metrics[False]
    assert np.isfinite(list(on.values())).all()
    np.testing.assert_allclose(on["loss"], off["loss"], rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(on["grad_norm"], off["grad_norm"], rtol=5e-2)
    assert on["lr"] == off["lr"]
