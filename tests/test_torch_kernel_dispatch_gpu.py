"""The kernels' dispatch by device: a meta tensor goes to the plain function
(a shape-only run prices it there), a CUDA tensor still reaches the
hand-written kernel. Imports no JAX, so that it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernel_dispatch_gpu.py

The meta tests run anywhere; the CUDA test skips without a card (the
kernels have no CPU mode)."""
import pytest
import torch

torch.set_num_threads(1)

from repro_torch import _graph
from repro_torch.kernels.decode_attention import kernel as tdec_kernel
from repro_torch.kernels.decode_attention import ops as tdec
from repro_torch.kernels.flash_attention import kernel as tflash_kernel
from repro_torch.kernels.flash_attention import ops as tflash
from repro_torch.kernels.gcn_spmm import kernel as tgcn_kernel
from repro_torch.kernels.gcn_spmm import ops as tgcn

KERNELS = (tflash_kernel, tdec_kernel, tgcn_kernel)


def _inputs(device, dtype):
    q = torch.randn(2, 64, 4, 64, device=device).to(dtype)
    k = torch.randn(2, 64, 2, 64, device=device).to(dtype)
    qd = q[:, :1].contiguous()
    valid = torch.ones(64, dtype=torch.bool, device=device)
    a = (torch.rand(46, 46, device=device) < 0.2).float()
    h = torch.randn(46, 213, device=device)
    r = torch.rand(46, device=device)
    return q, k, qd, valid, a, h, r


def _run(q, k, qd, valid, a, h, r):
    return (tflash.flash_attention(q, k, k, window=16),
            tdec.decode_attention(qd, k, k, valid),
            tgcn.spmm(a, h), tgcn.scaled_spmm(a, h, r, r))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_meta_calls_give_the_plain_functions_shapes_without_a_launch(dtype):
    meta = [torch.empty(t.shape, dtype=t.dtype, device="meta")
            for t in _inputs("cpu", dtype)]
    cpu = _inputs("cpu", dtype)
    before = [dict(m.LAUNCHES) for m in KERNELS]
    for got, want in zip(_run(*meta), _run(*cpu)):
        assert got.is_meta
        assert (got.shape, got.dtype) == (want.shape, want.dtype)
    assert [m.LAUNCHES for m in KERNELS] == before


@pytest.mark.gpu
def test_cuda_calls_still_reach_the_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    _graph.reset()
    out = _run(*_inputs("cuda", torch.float32))
    torch.cuda.synchronize()
    assert all(t.is_cuda for t in out)
    assert tflash_kernel.LAUNCHES["flash_attention"] == 1
    assert tdec_kernel.LAUNCHES["decode_attention"] == 1
    assert tgcn_kernel.LAUNCHES["spmm"] == 1
    assert tgcn_kernel.LAUNCHES["scaled_spmm"] == 1
