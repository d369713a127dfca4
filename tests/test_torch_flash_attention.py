"""The port's flash attention against the reference's Pallas kernel.

On the CPU the port's ``ops.flash_attention`` runs its plain version
(``ref.py``); the reference's ``flash_ops.flash_attention`` runs the Pallas
kernel in interpret mode, as ``tests/test_kernels.py`` runs it. Both get the
same numpy inputs. The CUDA kernel itself is checked on the card by
``tests/test_torch_attention_gpu.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.kernels.flash_attention import ops as jflash
from repro_torch.kernels.flash_attention import kernel as tkernel
from repro_torch.kernels.flash_attention import ops as tflash
from repro_torch.kernels.flash_attention import ref as tref

# tests/test_kernels.py::FLASH_CASES, plus gemma3-1b's head width with a window
FLASH_CASES = [
    # (B, S, H, KV, D, window, dtype)
    (1, 128, 4, 4, 64, None, "float32"),
    (2, 256, 8, 2, 64, None, "float32"),      # GQA 4:1
    (1, 128, 4, 1, 128, None, "float32"),     # MQA
    (2, 192, 4, 4, 64, None, "float32"),      # non-pow2 seq (padding)
    (1, 256, 4, 2, 64, 64, "float32"),        # sliding window
    (1, 128, 8, 8, 64, None, "bfloat16"),
    (1, 64, 2, 2, 32, 16, "bfloat16"),        # small dims + window
    (1, 40, 4, 1, 256, 16, "float32"),        # gemma3-1b: D 256, KV 1, window
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels.py::_tol


def _inputs(b, s, h, kv, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d))]


@pytest.mark.parametrize("b,s,h,kv,d,window,dtype", FLASH_CASES)
def test_flash_attention_matches_reference_kernel(b, s, h, kv, d, window,
                                                  dtype):
    q, k, v = _inputs(b, s, h, kv, d)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jflash.flash_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                                  window=window, block_q=64, block_kv=64)
    got = tflash.flash_attention(*(torch.from_numpy(x).to(tdt)
                                   for x in (q, k, v)), window=window)
    assert got.dtype == tdt and tuple(got.shape) == (b, s, h, d)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_non_causal_matches_reference_kernel():
    q, k, v = _inputs(2, 64, 4, 2, 32, seed=1)
    want = jflash.flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                  causal=False, block_q=64, block_kv=64)
    got = tflash.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                 causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_ops_route_cpu_tensors_to_the_plain_version_without_a_launch():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 16, 2, 1, 16))
    before = dict(tkernel.LAUNCHES)
    got = tflash.flash_attention(q, k, v, window=4)
    assert torch.equal(got, tref.attention_ref(q, k, v, window=4))
    assert tkernel.LAUNCHES == before


def test_ops_refuse_devices_other_than_cuda_and_cpu():
    q = torch.empty(1, 8, 2, 16, device="meta")
    k = torch.empty(1, 8, 1, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tflash.flash_attention(q, k, k)
