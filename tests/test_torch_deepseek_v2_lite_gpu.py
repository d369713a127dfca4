"""DeepSeek-V2-Lite's new paths on the card. Imports no JAX, so that it
runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_deepseek_v2_lite_gpu.py

MLA's prefill through the flash forward kernel at the published widths (16
heads, q and k at 128 + 64 = 192, v 128 widened to 192, the YaRN softmax
scale) against the plain einsum path, in fp32 and bf16; the device routing
record of ``serve_batch``'s graphed decode against an eager prefill and
eager decode steps fed the same tokens; ``moe.dropped`` 0 at the cell's
shapes (B 16 x 8064 prefill tokens, a B 16 decode step) with the published
MoE layer; the grouped expert GEMMs against the per-expert loop. Without a
CUDA card every test skips (the kernels have no CPU mode)."""
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch import obs
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel as tflash
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import decoder_lm as tdlm
from repro_torch.models import mlp as tmlp

ARCH = "deepseek-v2-lite"


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


@pytest.fixture
def knobs():
    """No TF32; the kernels' knob restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, tcommon.RUNTIME["use_flash"])
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, tcommon.RUNTIME["use_flash"] = old


def _mla_params(spec, d, dtype, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tattn.init_mla(gen, spec, d, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 3e-2)])
def test_mla_prefill_through_flash_at_d192(knobs, dtype, tol):
    _need_cuda()
    _build.load_all(("flash_attention",))
    cfg = get_config(ARCH)
    spec = cfg.segments[0].layers[0].mla
    p = _mla_params(spec, cfg.d_model, dtype)
    x = torch.randn(2, 300, cfg.d_model, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1)
                    ).to(dtype)
    pos = torch.arange(300, dtype=torch.int32, device="cuda")[None].expand(2, 300)
    with torch.no_grad():
        tcommon.RUNTIME["use_flash"] = False
        plain = tattn.mla_full(p, spec, x, pos)
        tcommon.RUNTIME["use_flash"] = True
        before = tflash.LAUNCHES["flash_attention"]
        flash = tattn.mla_full(p, spec, x, pos)
        assert tflash.LAUNCHES["flash_attention"] == before + 1
    torch.testing.assert_close(flash.float(), plain.float(), rtol=tol, atol=tol)


def _small_cfg():
    return dataclasses.replace(reduce_for_smoke(get_config(ARCH)), remat=False)


@pytest.mark.gpu
def test_routing_record_graphed_equals_eager(knobs):
    _need_cuda()
    _build.load_all(("flash_attention",))
    cfg = _small_cfg()
    params = tdlm.init_params(cfg, seed=0, device="cuda")
    b, s, g = 2, 24, 8
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (b, s),
                                               dtype=np.int32)
    n_moe = sum(l.mlp == "moe" for l in cfg.layer_list())
    moe = cfg.segments[-1].layers[-1].moe

    def record():
        return tmlp.RoutingRecord(n_moe, b, s + g, moe.top_k, moe.n_experts,
                                  "cuda")
    graphed = record()
    with tmlp.record_routing_on_device(graphed):
        gen, _ = tserve.serve_batch(cfg, params, {"tokens": tokens}, g,
                                    log=lambda *_: None)
    eager = record()
    fed = torch.as_tensor(gen, device="cuda").long()
    with tmlp.record_routing_on_device(eager), torch.no_grad():
        _, caches = tdlm.prefill(params, cfg,
                                 tokens=torch.as_tensor(tokens, device="cuda"),
                                 max_len=s + g)
        for i in range(g - 1):
            pos = torch.full((), s + i, dtype=torch.int32, device="cuda")
            tdlm.decode_step(params, cfg, fed[:, i:i + 1], pos, caches)
    t = s + g - 1
    assert torch.equal(graphed.experts[:, :, :t], eager.experts[:, :, :t])
    assert int(graphed.experts[:, :, s:t].max()) > 0


@pytest.mark.gpu
def test_no_choice_dropped_at_the_cells_shapes(knobs):
    _need_cuda()
    cfg = get_config(ARCH)
    spec = cfg.segments[1].layers[0].moe
    gen = torch.Generator(device="cuda").manual_seed(2)
    p = tmlp.init_moe(gen, spec, cfg.d_model, "silu", torch.bfloat16)
    b, s, k = 16, 8064, spec.top_k
    with obs.recording(obs.Recorder()) as rec, torch.no_grad():
        x = torch.randn(b, s, cfg.d_model, device="cuda", generator=gen,
                        dtype=torch.bfloat16)
        y, _ = tmlp.moe(p, spec, x, "silu")
        del x, y
        x = torch.randn(b, 1, cfg.d_model, device="cuda", generator=gen,
                        dtype=torch.bfloat16)
        tmlp.moe(p, spec, x, "silu", decode=True, pos=s)
    counters = rec.metrics.snapshot()["counters"]
    assert counters["moe.choices"] == (b * s + b) * k
    assert counters["moe.dropped"] == 0


@pytest.mark.gpu
def test_grouped_expert_gemms_match_the_per_expert_loop(knobs):
    _need_cuda()
    if not hasattr(torch, "_grouped_mm"):
        pytest.skip("this torch has no torch._grouped_mm")
    cfg = get_config(ARCH)
    spec = cfg.segments[1].layers[0].moe
    gen = torch.Generator(device="cuda").manual_seed(3)
    p = tmlp.init_moe(gen, spec, cfg.d_model, "silu", torch.bfloat16)
    # skewed counts, zeros among them
    counts = torch.zeros(spec.n_experts, dtype=torch.long, device="cuda")
    counts[0], counts[5], counts[6], counts[63] = 3000, 17, 1, 640
    xs = torch.randn(int(counts.sum()), cfg.d_model, device="cuda",
                     generator=gen, dtype=torch.bfloat16)
    with torch.no_grad():
        grouped = tmlp.expert_rows(p, xs, counts, "silu", grouped=True)
        loop = tmlp.expert_rows(p, xs, counts, "silu", grouped=False)
    torch.testing.assert_close(grouped.float(), loop.float(), rtol=2e-2,
                               atol=2e-2)
    assert (grouped.float() - loop.float()).abs().mean() < 1e-3
