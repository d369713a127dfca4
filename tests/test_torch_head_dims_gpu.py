"""The attention kernels at head dims off the powers of two, on the card,
against their plain versions. Imports no JAX, so that it runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_head_dims_gpu.py

Every D of ``HEAD_DIMS`` runs at the smallest kernel width that holds it,
read unpadded: the flash forward (causal, and with window 64), its backward
through ``ops.FlashAttention`` and decode against a ring-stale cache, fp32
and bf16, at B 2, S = T = 256, GQA group 2, at the tolerances of
``tests/test_kernels.py`` (2e-5 fp32, 2e-2 bf16); then ``force_ref=True``
on CUDA tensors, which launches nothing and gives the plain version's bits.
``chip_smoke.py``'s ``head_dims`` phase runs the same sweep and also
profiles one call per D. Without a CUDA card every test skips (the kernels
have no CPU mode)."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch.kernels.decode_attention import kernel as tdec
from repro_torch.kernels.decode_attention import ops as tdec_ops
from repro_torch.kernels.decode_attention import ref as tdec_ref
from repro_torch.kernels.flash_attention import kernel as tflash
from repro_torch.kernels.flash_attention import ops as tflash_ops
from repro_torch.kernels.flash_attention import ref as tflash_ref
from repro_torch.kernels.gcn_spmm import kernel as tspmm
from repro_torch.kernels.gcn_spmm import ops as tspmm_ops
from repro_torch.kernels.gcn_spmm import ref as tspmm_ref

HEAD_DIMS = (8, 36, 40, 80, 96, 112, 192, 200, 256)
DTYPES = ("float32", "bfloat16")
WINDOWS = (None, 64)
B, S, H, KV = 2, 256, 4, 2     # S = T; GQA group 2
TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels.py::_tol


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def inputs(d, dtype, seed=0, s=S):
    """q (B, S, H, D), k, v (B, S, KV, D), dO like q, on the card in
    ``dtype``, from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        "cuda", getattr(torch, dtype))
        for shape in ((B, s, H, d), (B, s, KV, d), (B, s, KV, d), (B, s, H, d))]


def ring_valid(t, device="cuda"):
    """A ring cache mid-wrap: the slots of positions 0..3t+6 written, the
    query at 3t - 100, so slots holding later positions are stale and the
    valid ones are not a prefix (``models/attention.py::attn_decode``)."""
    newest, pos = 3 * t + 7, 3 * t - 100
    slot_pos = np.full((t,), -1, np.int64)
    for p in range(newest + 1):
        slot_pos[p % t] = p
    valid = (slot_pos >= 0) & (slot_pos <= pos) & (slot_pos > pos - t)
    return torch.from_numpy(valid).to(device)


def forward_case(d, dtype, window):
    """(kernel output, plain output) of one forward call."""
    q, k, v, _ = inputs(d, dtype)
    got = tflash.flash_attention(q, k, v, window=window)
    return got, tflash_ref.attention_ref(q, k, v, window=window)


def backward_case(d, dtype, window):
    """(kernel grads, plain grads) of dO through ``ops.flash_attention``
    on inputs that require grad (``FlashAttention``: the forward kernel
    keeping the log-sum-exp, then the backward kernel)."""
    q, k, v, do = inputs(d, dtype, seed=1)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o = tflash_ops.flash_attention(*leaves, window=window)
    got = torch.autograd.grad(o, leaves, do)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o = tflash_ref.attention_ref(*leaves, window=window)
    return got, torch.autograd.grad(o, leaves, do)


def decode_case(d, dtype):
    """(kernel output, plain output) of one decode step against a
    ring-stale cache of T = S slots."""
    q, k, v, _ = inputs(d, dtype, seed=2)
    q, valid = q[:, :1].contiguous(), ring_valid(S)
    return tdec.decode_attention(q, k, v, valid), \
        tdec_ref.decode_attention_ref(q, k, v, valid)


def _close(got, want, dtype):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool(torch.isfinite(got.float()).all())
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_forward_kernel_at_head_dim(d, dtype, window):
    _need_cuda()
    before = tflash.LAUNCHES["flash_attention"]
    got, want = forward_case(d, dtype, window)
    torch.cuda.synchronize()
    assert tflash.LAUNCHES["flash_attention"] == before + 1
    _close(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_backward_kernel_at_head_dim(d, dtype, window):
    _need_cuda()
    before = dict(tflash.LAUNCHES)
    got, want = backward_case(d, dtype, window)
    torch.cuda.synchronize()
    # the forward's body by the dispatch rule: wgmma at its widths
    wgmma = tflash.dispatch(d, getattr(torch, dtype), [], group=H // KV)["body"] == "wgmma"
    assert tflash.LAUNCHES == {"flash_attention": before["flash_attention"] + 1,
                               "flash_attention.wgmma":
                                   before["flash_attention.wgmma"] + wgmma,
                               "flash_attention_bwd":
                                   before["flash_attention_bwd"] + 1}
    for g, w in zip(got, want):
        _close(g, w, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_decode_kernel_at_head_dim(d, dtype):
    _need_cuda()
    before = tdec.LAUNCHES["decode_attention"]
    got, want = decode_case(d, dtype)
    torch.cuda.synchronize()
    assert tdec.LAUNCHES["decode_attention"] == before + 1
    _close(got, want, dtype)


@pytest.mark.gpu
def test_head_dims_past_256_are_refused_on_the_card():
    """No longer refused: D 320 runs in column passes of 256, and the
    forward and decode agree with their plain versions in bf16."""
    _need_cuda()
    q, k, v, _ = inputs(320, "bfloat16", s=16)
    before = (tflash.LAUNCHES["flash_attention"], tdec.LAUNCHES["decode_attention"])
    _close(tflash.flash_attention(q, k, v), tflash_ref.attention_ref(q, k, v),
           "bfloat16")
    q1, valid = q[:, :1].contiguous(), ring_valid(16)
    _close(tdec.decode_attention(q1, k, v, valid),
           tdec_ref.decode_attention_ref(q1, k, v, valid), "bfloat16")
    assert (tflash.LAUNCHES["flash_attention"], tdec.LAUNCHES["decode_attention"]) \
        == (before[0] + 1, before[1] + 1)


def force_ref_calls(dtype):
    """(name, the ops call with force_ref=True, its plain version) on CUDA
    tensors: flash (with and without grad), decode, spmm and scaled_spmm."""
    q, k, v, _ = inputs(80, dtype, seed=3)
    valid = ring_valid(S)
    rng = np.random.default_rng(4)
    adj = torch.from_numpy((rng.random((70, 70)) < 0.2).astype(np.float32)).cuda()
    feats = torch.from_numpy(rng.standard_normal((70, 33)).astype(np.float32)).to(
        "cuda", getattr(torch, dtype))
    r, c = (torch.from_numpy(rng.random(70).astype(np.float32)).cuda()
            for _ in range(2))
    qg = q.clone().requires_grad_()
    return [
        ("flash_attention",
         lambda: tflash_ops.flash_attention(q, k, v, window=64, force_ref=True),
         lambda: tflash_ref.attention_ref(q, k, v, window=64)),
        ("flash_attention_grad",
         lambda: tflash_ops.flash_attention(qg, k, v, force_ref=True),
         lambda: tflash_ref.attention_ref(qg, k, v)),
        ("decode_attention",
         lambda: tdec_ops.decode_attention(q[:, :1], k, v, valid, force_ref=True),
         lambda: tdec_ref.decode_attention_ref(q[:, :1], k, v, valid)),
        ("spmm", lambda: tspmm_ops.spmm(adj.to(feats.dtype), feats, force_ref=True),
         lambda: tspmm_ref.spmm_ref(adj.to(feats.dtype), feats)),
        ("scaled_spmm",
         lambda: tspmm_ops.scaled_spmm(adj, feats, r, c, force_ref=True),
         lambda: tspmm_ref.scaled_spmm_ref(adj, feats, r, c)),
    ]


def launch_counts() -> dict:
    return {**tflash.LAUNCHES, **tdec.LAUNCHES, **tspmm.LAUNCHES}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_force_ref_on_cuda_launches_nothing(dtype):
    _need_cuda()
    for name, call, plain in force_ref_calls(dtype):
        before = launch_counts()
        got = call()
        torch.cuda.synchronize()
        assert launch_counts() == before, name
        assert got.is_cuda and torch.equal(got, plain()), name
