"""The port's gcn_spmm against the reference's: on the CPU the port runs its
plain version, the reference its Pallas kernel in interpret mode (as
tests/test_kernels.py runs it). The hand-written CUDA kernel is held to the
plain version in tests/test_torch_gcn_spmm_gpu.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.kernels.gcn_spmm import ops as jops
from repro_torch.kernels.gcn_spmm import kernel as tkernel
from repro_torch.kernels.gcn_spmm import ops as tops
from repro_torch.kernels.gcn_spmm import ref as tref

# tests/test_kernels.py::SPMM_CASES plus the GNN hidden width at bucket 64
SPMM_CASES = [
    (8, 22, "float32"),
    (46, 15, "float32"),
    (64, 213, "float32"),
    (128, 213, "float32"),
    (200, 64, "float32"),
    (46, 12, "bfloat16"),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels.py::_tol


def _inputs(n, d, seed=4):
    rng = np.random.default_rng(seed)
    adj = ((rng.uniform(size=(n, n)) < 0.4) * rng.uniform(size=(n, n)))
    feats = rng.standard_normal((n, d))
    deg = (adj > 0).sum(1) + 1.0
    r = 1.0 / np.sqrt(deg)
    c = rng.uniform(0.2, 1.0, size=n)
    return [x.astype(np.float32) for x in (adj, feats, r, c)]


def _both(arrays, dtype):
    """The same values as JAX arrays and torch CPU tensors of ``dtype``
    (both round float32 to bfloat16 to nearest even)."""
    j = [jnp.asarray(x, getattr(jnp, dtype)) for x in arrays]
    t = [torch.from_numpy(x).to(getattr(torch, dtype)) for x in arrays]
    return j, t


def _close(got: torch.Tensor, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("n,d,dtype", SPMM_CASES)
def test_spmm_matches_reference(n, d, dtype):
    adj, feats, _, _ = _inputs(n, d)
    (ja, jh), (ta, th) = _both([adj, feats], dtype)
    before = dict(tkernel.LAUNCHES)
    got = tops.spmm(ta, th)
    assert got.dtype == th.dtype and got.shape == (n, d)
    _close(got, jops.spmm(ja, jh), dtype)
    assert tkernel.LAUNCHES == before   # the CPU path never reaches the kernel


@pytest.mark.parametrize("n,d,dtype", SPMM_CASES)
def test_scaled_spmm_matches_reference(n, d, dtype):
    adj, feats, r, c = _inputs(n, d)
    (ja, jh, jr, jc), (ta, th, tr, tc) = _both([adj, feats, r, c], dtype)
    got = tops.scaled_spmm(ta, th, tr, tc)
    assert got.dtype == th.dtype and got.shape == (n, d)
    _close(got, jops.scaled_spmm(ja, jh, jr, jc), dtype)


def test_scaled_spmm_rectangular_and_fp32_scales_on_bf16():
    """M != N, and float32 scales on bfloat16 features are cast first, as
    the reference wrapper casts them."""
    rng = np.random.default_rng(7)
    adj = (rng.uniform(size=(24, 40)) < 0.5).astype(np.float32)
    feats = rng.standard_normal((40, 9)).astype(np.float32)
    r = rng.uniform(0.1, 1, 24).astype(np.float32)
    c = rng.uniform(0.1, 1, 40).astype(np.float32)
    (ja, jh), (ta, th) = _both([adj, feats], "bfloat16")
    want = jops.scaled_spmm(ja, jh, jnp.asarray(r), jnp.asarray(c))
    got = tops.scaled_spmm(ta, th, torch.from_numpy(r), torch.from_numpy(c))
    _close(got, want, "bfloat16")


def test_plain_version_keeps_the_kernel_operation_order():
    """Column scale, fp32 matmul, row scale on the accumulator, then cast."""
    adj, feats, r, c = _inputs(32, 16)
    ta, th, tr, tc = (torch.from_numpy(x) for x in (adj, feats, r, c))
    want = ((ta * tc[None, :]) @ th) * tr[:, None]
    assert torch.equal(tref.scaled_spmm_ref(ta, th, tr, tc), want)
