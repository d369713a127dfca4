"""The MoE routing and the four decoder families of ``test_torch_lm_families``
on the card against the CPU plain path. Imports no JAX, so that it runs
where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_families_gpu.py

fp32 throughout. The routing: ``_route`` on CUDA gives the CPU's expert
choices, drops, dispatch and combine, and ties order by expert index on
both. The families (``reduce_for_smoke`` of olmoe-1b-7b, deepseek-v2-236b,
jamba-1.5-large-398b and xlstm-125m, the same seeded params on both
devices): ``serve_batch`` on the card (the attention kernels on, the decode
step replayed from a CUDA graph) generates the CPU's eager tokens, the
routing of a teacher-forced prefill and decode agrees call by call, and the
prefill logits agree at the model-level fp32 tolerance. Without a CUDA card
every test skips (the kernels have no CPU mode)."""
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch import _graph
from repro_torch._tree import tree_map
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.configs.base import MoESpec
from repro_torch.data.synthetic import SyntheticConfig, make_batch
from repro_torch.kernels.decode_attention import kernel as tdec
from repro_torch.kernels.flash_attention import kernel as tflash
from repro_torch.launch import serve as tserve
from repro_torch.models import common as tcommon
from repro_torch.models import decoder_lm as tdlm
from repro_torch.models import mlp as tmlp

FAMILIES = ["olmoe-1b-7b", "deepseek-v2-236b", "jamba-1.5-large-398b",
            "xlstm-125m"]
TOL = 2e-4   # the model-level fp32 tolerance (tests/test_kernels.py)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


@pytest.fixture
def fp32_matmuls():
    """No TF32 on the card: the CPU's fp32 is the yardstick."""
    old = (torch.backends.cuda.matmul.allow_tf32, tcommon.RUNTIME["use_flash"])
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, tcommon.RUNTIME["use_flash"] = old


@pytest.mark.gpu
def test_stable_top_k_orders_ties_by_index_on_cuda():
    _need_cuda()
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.1, 0.2],
                          [0.25, 0.25, 0.25, 0.25, 0.0]]).repeat(64, 1)
    for dev in ("cpu", "cuda"):
        vals, idx = tmlp._sorted(probs.to(dev))
        assert idx[:, :4].cpu().tolist() == [[1, 2, 4, 0], [0, 1, 2, 3]] * 64


@pytest.mark.gpu
@pytest.mark.parametrize("capacity", [6, 24, 64])
def test_route_on_cuda_matches_cpu(capacity, fp32_matmuls):
    """2 groups of 64 tokens, 4 experts, top-2: capacity 6 and 24 drop."""
    _need_cuda()
    spec = MoESpec(n_experts=4, top_k=2, d_ff_expert=32)
    gen = torch.Generator().manual_seed(0)
    p = tmlp.init_moe(gen, spec, 32, "silu", torch.float32)
    x = torch.randn(2, 64, 32, generator=gen)
    out = {}
    for dev in ("cpu", "cuda"):
        dec = []
        d, c, aux = tmlp._route(p["router"].to(dev), x.to(dev), spec, capacity,
                                dec)
        out[dev] = [t.cpu() for t in (d, c, aux, *dec[0])]
    (d0, c0, a0, i0, k0, m0), (d1, c1, a1, i1, k1, m1) = out["cpu"], out["cuda"]
    assert torch.equal(i1, i0) and torch.equal(k1, k0) and torch.equal(d1, d0)
    assert bool(k0.all()) == (capacity == 64)
    torch.testing.assert_close(c1, c0, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(a1, a0, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(m1, m0, rtol=1e-6, atol=1e-6)


def _teacher_forced(params, cfg, tokens, fed, max_len):
    """Prefill logits and the routing of the prefill and len(fed) - 1
    teacher-forced decode steps."""
    s = tokens.shape[1]
    with torch.no_grad(), tmlp.record_routing() as rec:
        last, caches = tdlm.prefill(params, cfg, tokens=tokens, max_len=max_len)
        for i in range(fed.shape[1] - 1):
            tdlm.decode_step(params, cfg, fed[:, i:i + 1], s + i, caches)
    return last, rec


@pytest.mark.gpu
@pytest.mark.parametrize("arch", FAMILIES)
def test_reduced_family_serves_on_cuda_as_on_cpu(arch, fp32_matmuls):
    _need_cuda()
    cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)), remat=False)
    params = tdlm.init_params(cfg, seed=0, device="cpu")
    params_cuda = tree_map(lambda t: t.cuda(), params)
    batch = make_batch(cfg, SyntheticConfig(global_batch=2, seq_len=16,
                                            seed=0), 0)
    gen_n = 10
    n_attn = sum(seg.count * sum(l.kind == "attn" for l in seg.layers)
                 for seg in cfg.segments)
    # MLA's prefill runs through the flash forward too; its decode has no
    # kernel
    n_flash = n_attn + sum(seg.count * sum(l.kind == "mla" for l in seg.layers)
                           for seg in cfg.segments)
    tcommon.RUNTIME["use_flash"] = False
    cpu_gen, _ = tserve.serve_batch(cfg, params, batch, gen_n,
                                    log=lambda *_: None)
    _graph.reset()
    cuda_gen, stats = tserve.serve_batch(cfg, params_cuda, batch, gen_n,
                                         log=lambda *_: None)
    assert stats["backend"] == "cuda" and tcommon.RUNTIME["use_flash"]
    assert (tflash.LAUNCHES["flash_attention"],
            tdec.LAUNCHES["decode_attention"]) == (n_flash, n_attn * gen_n)
    np.testing.assert_array_equal(cuda_gen, cpu_gen)

    tokens = torch.as_tensor(batch["tokens"])
    fed = torch.as_tensor(cpu_gen)
    max_len = tokens.shape[1] + gen_n
    runs = {}
    for dev, p, flash in (("cpu", params, False), ("cuda", params_cuda, True)):
        tcommon.RUNTIME["use_flash"] = flash
        runs[dev] = _teacher_forced(p, cfg, tokens.to(dev), fed.to(dev),
                                    max_len)
    (l0, r0), (l1, r1) = runs["cpu"], runs["cuda"]
    torch.testing.assert_close(l1.cpu(), l0, rtol=TOL, atol=TOL)
    assert len(r1) == len(r0)
    for (i0, k0, _), (i1, k1, _) in zip(r0, r1):
        assert torch.equal(i1.cpu(), i0) and torch.equal(k1.cpu(), k0)
