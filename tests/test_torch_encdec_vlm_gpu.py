"""The encoder-decoder (whisper-small) and VLM (internvl2-1b) families on the
card against the CPU plain path. Imports no JAX, so that it runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_encdec_vlm_gpu.py

fp32 throughout, TF32 off. ``reduce_for_smoke`` of both (the same seeded
params on both devices): ``serve_batch`` on the card (the attention kernels
on, the decode step replayed from a CUDA graph over the ``{"self",
"cross"}`` caches or past the patches) generates the CPU's eager tokens;
the flash kernel runs on every causal self-attention layer of a prefill
(whisper's encoder is non-causal and stays plain, as in the reference) and
the decode kernel on every decoder layer of a step; the prefill and 4
teacher-forced decode steps agree at the model-level fp32 tolerance. Then
internvl2-1b's attention at its full width (14 heads over 2 kv heads, G 7,
head_dim 64) with the reduced model's other widths, the first path through
the kernels at G 7. Without a CUDA card every test skips (the kernels have
no CPU mode)."""
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch import _graph
from repro_torch._tree import tree_map
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.data.synthetic import SyntheticConfig, make_batch
from repro_torch.kernels.decode_attention import kernel as tdec
from repro_torch.kernels.flash_attention import kernel as tflash
from repro_torch.launch import serve as tserve
from repro_torch.models import common as tcommon
from repro_torch.models.registry import get_api
from repro_torch.training.train_step import device_batch, make_prefill

TOL = 2e-4   # the model-level fp32 tolerance (tests/test_kernels.py)
N_DECODE = 4


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


def _g7(cfg):
    """internvl2-1b's attention at full width (14 heads over 2, head_dim
    64) in the reduced model."""
    full = get_config("internvl2-1b").segments[0].layers[0].attn
    seg = cfg.segments[0]
    layer = dataclasses.replace(seg.layers[0], attn=full)
    return dataclasses.replace(cfg, segments=(dataclasses.replace(
        seg, layers=(layer,)),))


CASES = {
    "whisper-small": lambda: reduce_for_smoke(get_config("whisper-small")),
    "internvl2-1b": lambda: reduce_for_smoke(get_config("internvl2-1b")),
    "internvl2-1b G 7": lambda: _g7(reduce_for_smoke(get_config("internvl2-1b"))),
}


def _teacher_forced(api, cfg, params, inputs, fed, max_len, offset):
    """Prefill logits, then len(fed) - 1 decode steps fed ``fed``."""
    s = inputs["tokens"].shape[1]
    with torch.no_grad():
        last, caches = make_prefill(cfg, api)(params, inputs, max_len)
        out = [last]
        for i in range(fed.shape[1] - 1):
            step, caches = api.decode_step(params, cfg, fed[:, i:i + 1],
                                           offset + s + i, caches)
            out.append(step)
    return torch.cat(out, dim=1)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_reduced_family_serves_on_cuda_as_on_cpu(case, fp32_matmuls):
    _need_cuda()
    cfg = dataclasses.replace(CASES[case](), remat=False)
    api = get_api(cfg)
    params = api.init_params(cfg, seed=0, device="cpu")
    params_cuda = tree_map(lambda t: t.cuda(), params)
    batch = make_batch(cfg, SyntheticConfig(global_batch=2, seq_len=16,
                                            seed=0), 0)
    gen_n = 10
    n_dec = cfg.n_layers
    tcommon.RUNTIME["use_flash"] = False
    cpu_gen, _ = tserve.serve_batch(cfg, params, batch, gen_n,
                                    log=lambda *_: None)
    _graph.reset()
    cuda_gen, stats = tserve.serve_batch(cfg, params_cuda, batch, gen_n,
                                         log=lambda *_: None)
    assert stats["backend"] == "cuda" and tcommon.RUNTIME["use_flash"]
    # one prefill over the decoder's layers; the warm-up step and 9 replays
    assert (tflash.LAUNCHES["flash_attention"],
            tdec.LAUNCHES["decode_attention"]) == (n_dec, n_dec * gen_n)
    np.testing.assert_array_equal(cuda_gen, cpu_gen)

    offset = cfg.n_patches if cfg.family == "vlm" else 0
    max_len = offset + 16 + N_DECODE
    fed = torch.as_tensor(cpu_gen[:, :N_DECODE])
    runs = {}
    for dev, p, flash in (("cpu", params, False), ("cuda", params_cuda, True)):
        tcommon.RUNTIME["use_flash"] = flash
        runs[dev] = _teacher_forced(api, cfg, p, device_batch(cfg, batch, dev),
                                    fed.to(dev), max_len, offset)
    assert runs["cpu"].shape == (2, N_DECODE, cfg.vocab_size)
    torch.testing.assert_close(runs["cuda"].cpu(), runs["cpu"], rtol=TOL,
                               atol=TOL)
