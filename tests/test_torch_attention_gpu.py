"""The hand-written CUDA attention kernels against their plain versions, on
the card. Imports no JAX, so that it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_attention_gpu.py

Without a CUDA card every test skips (the kernels have no CPU mode)."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch.kernels.decode_attention import kernel as tdec
from repro_torch.kernels.decode_attention import ref as tdec_ref
from repro_torch.kernels.flash_attention import kernel as tflash
from repro_torch.kernels.flash_attention import ref as tflash_ref

# tests/test_kernels.py::FLASH_CASES, then gemma3-1b's prefill shapes
FLASH_CASES = [
    # (B, S, H, KV, D, window, dtype)
    (1, 128, 4, 4, 64, None, "float32"),
    (2, 256, 8, 2, 64, None, "float32"),
    (1, 128, 4, 1, 128, None, "float32"),
    (2, 192, 4, 4, 64, None, "float32"),
    (1, 256, 4, 2, 64, 64, "float32"),
    (1, 128, 8, 8, 64, None, "bfloat16"),
    (1, 64, 2, 2, 32, 16, "bfloat16"),
    (1, 40, 4, 1, 256, 16, "float32"),
    (4, 1024, 4, 1, 256, 512, "float32"),
    (4, 1024, 4, 1, 256, None, "float32"),
    (4, 1024, 4, 1, 256, 512, "bfloat16"),
    (4, 1024, 4, 1, 256, None, "bfloat16"),
    # the tensor-core body: ragged S (40, 72, 100, 192), GQA groups 1, 2, 4
    # and 8, every head dim, windows smaller than a kv tile
    (1, 40, 4, 1, 256, 16, "bfloat16"),
    (2, 192, 4, 4, 64, None, "bfloat16"),
    (2, 192, 8, 4, 128, 48, "bfloat16"),
    (1, 100, 8, 1, 16, None, "bfloat16"),
    (2, 72, 16, 2, 32, 5, "bfloat16"),
    (1, 256, 8, 1, 128, None, "bfloat16"),
]
# tests/test_kernels.py::DEC_CASES, then gemma3-1b's decode shapes: the
# window-512 ring (a non-prefix mask) and the global cache at max_len 1088
DEC_CASES = [
    # (B, T, H, KV, D, mask, dtype); mask: n_valid prefix or "ring"
    (1, 256, 4, 4, 64, 200, "float32"),
    (2, 512, 8, 2, 64, 512, "float32"),
    (1, 384, 4, 1, 128, 100, "float32"),
    (2, 256, 8, 8, 64, 17, "bfloat16"),
    (4, 512, 4, 1, 256, "ring", "float32"),
    (4, 1088, 4, 1, 256, 1050, "float32"),
    (4, 512, 4, 1, 256, "ring", "bfloat16"),
    (4, 1088, 4, 1, 256, 1050, "bfloat16"),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels.py::_tol


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def normal(rng, shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        "cuda", getattr(torch, dtype))


def ring_mask(t: int, newest: int, pos: int) -> np.ndarray:
    """The slot mask ``models/attention.py::attn_decode`` builds for a query
    at ``pos`` on a ring of ``t`` slots (window t) after positions
    0..newest were written; pos < newest leaves holes mid-ring."""
    slot_pos = np.full((t,), -1, np.int64)
    for p in range(newest + 1):
        slot_pos[p % t] = p
    valid = (slot_pos >= 0) & (slot_pos <= pos) & (slot_pos > pos - t)
    return valid.astype(np.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,kv,d,window,dtype", FLASH_CASES)
def test_flash_kernel_matches_plain_version(b, s, h, kv, d, window, dtype):
    _need_cuda()
    rng = np.random.default_rng(0)
    q = normal(rng, (b, s, h, d), dtype)
    k, v = (normal(rng, (b, s, kv, d), dtype) for _ in range(2))
    before = tflash.LAUNCHES["flash_attention"]
    got = tflash.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert tflash.LAUNCHES["flash_attention"] == before + 1
    want = tflash_ref.attention_ref(q, k, v, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_with_more_keys_than_queries(causal, dtype):
    """T != S (keys past the last query, ragged against the kv tile) and the
    non-causal mask, which the serve path does not reach."""
    _need_cuda()
    rng = np.random.default_rng(2)
    q = normal(rng, (2, 50, 8, 64), dtype)
    k, v = (normal(rng, (2, 97, 2, 64), dtype) for _ in range(2))
    got = tflash.flash_attention(q, k, v, causal=causal)
    want = tflash_ref.attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,h,kv,d,mask,dtype", DEC_CASES)
def test_decode_kernel_matches_plain_version(b, t, h, kv, d, mask, dtype):
    _need_cuda()
    rng = np.random.default_rng(1)
    q = normal(rng, (b, 1, h, d), dtype)
    k, v = (normal(rng, (b, t, kv, d), dtype) for _ in range(2))
    valid = ring_mask(t, newest=3 * t + 7, pos=3 * t - 100) if mask == "ring" \
        else (np.arange(t) < mask).astype(np.int32)
    if mask == "ring":
        first_hole = int(np.argmin(valid))
        assert valid[first_hole:].any(), "the ring mask should not be a prefix"
    valid = torch.from_numpy(valid).cuda()
    before = tdec.LAUNCHES["decode_attention"]
    got = tdec.decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert tdec.LAUNCHES["decode_attention"] == before + 1
    want = tdec_ref.decode_attention_ref(q, k, v, valid)
    assert got.dtype == q.dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.gpu
def test_kernels_refuse_cpu_tensors_grad_and_bad_shapes():
    _need_cuda()
    q = torch.ones(1, 8, 4, 64, device="cuda")
    k = torch.ones(1, 8, 2, 64, device="cuda")
    valid = torch.ones(8, dtype=torch.int32, device="cuda")
    counts = (dict(tflash.LAUNCHES), dict(tdec.LAUNCHES))
    with pytest.raises(ValueError, match="CUDA device"):
        tflash.flash_attention(q.cpu(), k, k)
    with pytest.raises(ValueError, match="CUDA device"):
        tdec.decode_attention(q[:, :1], k, k, valid.cpu())
    with pytest.raises(RuntimeError, match="forward-only"):
        tflash.flash_attention(q.clone().requires_grad_(), k, k)
    with pytest.raises(RuntimeError, match="forward-only"):
        tdec.decode_attention(q[:, :1], k, k.clone().requires_grad_(), valid)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        tflash.flash_attention(q, torch.ones(1, 8, 3, 64, device="cuda"),
                               torch.ones(1, 8, 3, 64, device="cuda"))
    with pytest.raises(ValueError, match="head_dim"):
        tflash.flash_attention(q[..., :48].contiguous(),
                               k[..., :48].contiguous(),
                               k[..., :48].contiguous())
    with pytest.raises(ValueError, match=r"need q \(B, 1, H, D\)"):
        tdec.decode_attention(q, k, k, valid)
    with pytest.raises(ValueError, match="valid must be int32"):
        tdec.decode_attention(q[:, :1], k, k, valid[:5])
    with pytest.raises(ValueError, match="contiguous"):
        tflash.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                               k, k)
    qb = torch.ones(8 * 4 * 64 + 1, dtype=torch.bfloat16, device="cuda")[1:]
    kb = k.to(torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte boundary"):
        tflash.flash_attention(qb.view(1, 8, 4, 64), kb, kb)
    assert (tflash.LAUNCHES, tdec.LAUNCHES) == counts
