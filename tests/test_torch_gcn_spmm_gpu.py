"""The hand-written CUDA kernel of gcn_spmm against its plain version, on
the card. Imports no JAX, so that it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_gcn_spmm_gpu.py

Without a CUDA card every test skips (the kernel has no CPU mode)."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch.kernels.gcn_spmm import kernel as tkernel
from repro_torch.kernels.gcn_spmm import ops as tops
from repro_torch.kernels.gcn_spmm import ref as tref

# tests/test_kernels.py::SPMM_CASES, the GNN width at buckets 64 and 1024,
# then the edges of the split-K cluster and of the 16-byte A path: n 1023
# and 1025 (ragged K ranges, rows of A not 16-byte aligned), n 512 at d 64
# (8 ranks, the most), n 2048 (enough tiles to need no split), d 1 / 15 /
# 300 (column tiles of one, part of one and ten)
SPMM_CASES = [
    (8, 22, "float32"),
    (46, 15, "float32"),
    (64, 213, "float32"),
    (128, 213, "float32"),
    (200, 64, "float32"),
    (1024, 213, "float32"),
    (46, 12, "bfloat16"),
    (1023, 213, "float32"),
    (1025, 15, "float32"),
    (512, 64, "float32"),
    (2048, 300, "float32"),
    (1024, 1, "float32"),
    (1025, 213, "bfloat16"),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels.py::_tol


def _inputs(n, d, seed=4):
    rng = np.random.default_rng(seed)
    adj = ((rng.uniform(size=(n, n)) < 0.4) * rng.uniform(size=(n, n)))
    feats = rng.standard_normal((n, d))
    r = 1.0 / np.sqrt((adj > 0).sum(1) + 1.0)
    c = rng.uniform(0.2, 1.0, size=n)
    return [x.astype(np.float32) for x in (adj, feats, r, c)]


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,dtype", SPMM_CASES)
def test_cuda_kernel_matches_plain_version(n, d, dtype):
    _need_cuda()
    adj, feats, r, c = _inputs(n, d)
    dt = getattr(torch, dtype)
    ta, th, tr, tc = (torch.from_numpy(x).to("cuda", dt)
                      for x in (adj, feats, r, c))
    before = dict(tkernel.LAUNCHES)
    got = tops.scaled_spmm(ta, th, tr, tc)
    got_plain = tops.spmm(ta, th)
    torch.cuda.synchronize()
    assert tkernel.LAUNCHES["scaled_spmm"] == before["scaled_spmm"] + 1
    assert tkernel.LAUNCHES["spmm"] == before["spmm"] + 1
    want = tref.scaled_spmm_ref(ta, th, tr, tc)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    # the raw mask at n = 1024 sums to ~90: compare relative to its scale
    want_plain = tref.spmm_ref(ta, th).float()
    scale = max(1.0, want_plain.abs().max().item())
    torch.testing.assert_close(got_plain.float(), want_plain, rtol=TOL[dtype],
                               atol=TOL[dtype] * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("n,d", [(1024, 213), (512, 64), (200, 64)])
def test_cuda_kernel_repeats_bit_for_bit(n, d):
    """Split-K sums its cluster's partial tiles in rank order, with no
    atomics: two calls on the same inputs give the same bits."""
    _need_cuda()
    ta, th, tr, tc = (torch.from_numpy(x).cuda() for x in _inputs(n, d))
    for fn, args in ((tops.scaled_spmm, (ta, th, tr, tc)), (tops.spmm, (ta, th))):
        first = fn(*args)
        second = fn(*args)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


@pytest.mark.gpu
def test_cuda_kernel_refuses_inputs_that_require_grad():
    _need_cuda()
    a = torch.ones(8, 8, device="cuda")
    h = torch.ones(8, 4, device="cuda", requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        tops.spmm(a, h)
