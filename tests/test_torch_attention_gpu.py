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
    # phi3-mini's prefill: 32 heads, 32 kv heads, head_dim 96 (padded to 128)
    (1, 1024, 32, 32, 96, None, "bfloat16"),
    (1, 200, 4, 2, 96, 64, "float32"),
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
    # phi3-mini's decode: B 4, T 1088, 32 heads, 32 kv heads, head_dim 96
    (4, 1088, 32, 32, 96, 1050, "bfloat16"),
    (4, 1088, 32, 32, 96, 1050, "float32"),
]
# the redesigned kernel's edges: T = 1, T off the 8-row chunk, a whole
# chunk invalid ("hole"), one valid slot at the end ("last"), no valid slot
# ("none": the plain version's uniform weights), G 1, 7 (padded to 8), 8
# and 12 (two head groups), B * KV = 64 and T = 32,768
DEC_EDGE_CASES = [
    # (B, T, H, KV, D, mask, dtype)
    (2, 1, 4, 1, 64, 1, "bfloat16"),
    (1, 1, 8, 8, 128, 1, "float32"),
    (3, 1000, 4, 1, 256, 999, "bfloat16"),
    (2, 77, 8, 2, 32, 77, "float32"),
    (4, 1088, 4, 1, 256, "hole", "bfloat16"),
    (2, 300, 4, 2, 64, "hole", "float32"),
    (4, 1088, 4, 1, 256, "last", "bfloat16"),
    (1, 513, 2, 1, 16, "last", "float32"),
    (4, 512, 4, 1, 256, "none", "bfloat16"),
    (2, 100, 8, 4, 64, "none", "float32"),
    (2, 700, 8, 8, 128, 650, "bfloat16"),
    (1, 96, 14, 2, 64, 90, "float32"),
    (2, 1088, 16, 2, 128, 1000, "bfloat16"),
    (1, 300, 8, 1, 256, 256, "float32"),
    (1, 200, 24, 2, 128, 180, "bfloat16"),
    (16, 1088, 16, 4, 128, 1056, "bfloat16"),
    (1, 32768, 4, 1, 256, 32000, "bfloat16"),
    (1, 32768, 4, 1, 128, "ring", "float32"),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels.py::_tol


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def normal(rng, shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        "cuda", getattr(torch, dtype))


def dec_mask(t: int, mask) -> np.ndarray:
    """A (T,) bool slot mask: an int n is the prefix of n slots; "ring" a
    ring mask with holes mid-ring; "hole" all but 40 slots from T // 3;
    "last" only slot T - 1; "none" no slot."""
    if mask == "ring":
        return ring_mask(t, 3 * t + 7, 3 * t - 100).astype(bool)
    idx = np.arange(t)
    if mask == "hole":
        return (idx < t // 3) | (idx >= t // 3 + 40)
    if mask == "last":
        return idx == t - 1
    if mask == "none":
        return np.zeros(t, bool)
    return idx < mask


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


def _decode_inputs(b, t, h, kv, d, mask, dtype, seed=1):
    rng = np.random.default_rng(seed)
    q = normal(rng, (b, 1, h, d), dtype)
    k, v = (normal(rng, (b, t, kv, d), dtype) for _ in range(2))
    return q, k, v, torch.from_numpy(dec_mask(t, mask)).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,h,kv,d,mask,dtype", DEC_CASES)
def test_decode_kernel_matches_plain_version(b, t, h, kv, d, mask, dtype):
    _need_cuda()
    q, k, v, valid = _decode_inputs(b, t, h, kv, d, mask, dtype)
    if mask == "ring":
        first_hole = int(np.argmin(valid.cpu().numpy()))
        assert valid[first_hole:].any(), "the ring mask should not be a prefix"
    before = tdec.LAUNCHES["decode_attention"]
    got = tdec.decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert tdec.LAUNCHES["decode_attention"] == before + 1
    want = tdec_ref.decode_attention_ref(q, k, v, valid)
    assert got.dtype == q.dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,h,kv,d,mask,dtype", DEC_EDGE_CASES)
def test_decode_kernel_edges_match_plain_version(b, t, h, kv, d, mask, dtype):
    _need_cuda()
    q, k, v, valid = _decode_inputs(b, t, h, kv, d, mask, dtype, seed=3)
    got = tdec.decode_attention(q, k, v, valid)
    want = tdec_ref.decode_attention_ref(q, k, v, valid)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got.float()).all())
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", tdec.HEAD_DIMS)
def test_decode_kernel_every_head_dim(d, dtype):
    _need_cuda()
    q, k, v, valid = _decode_inputs(2, 333, 4, 1, d, "hole", dtype, seed=4)
    got = tdec.decode_attention(q, k, v, valid)
    want = tdec_ref.decode_attention_ref(q, k, v, valid)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_repeats_bit_for_bit(dtype):
    """The chunks are combined in a fixed order: no atomics."""
    _need_cuda()
    q, k, v, valid = _decode_inputs(4, 1088, 4, 1, 256, 1056, dtype)
    first, second = (tdec.decode_attention(q, k, v, valid) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
def test_decode_kernel_replays_in_a_cuda_graph():
    """Captured once and replayed on new cache contents, the kernel gives
    the eager call's bits; the capture counts as captured, each replay as
    the launches the graph holds."""
    _need_cuda()
    q, k, v, valid = _decode_inputs(4, 512, 4, 1, 256, "ring", "bfloat16")
    tdec.decode_attention(q, k, v, valid)   # eager first call: attributes
    torch.cuda.synchronize()
    launches, captured = tdec.LAUNCHES["decode_attention"], \
        tdec.CAPTURED["decode_attention"]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tdec.decode_attention(q, k, v, valid)
    assert tdec.LAUNCHES["decode_attention"] == launches
    assert tdec.CAPTURED["decode_attention"] == captured + 1
    rng = np.random.default_rng(9)
    for _ in range(2):
        k.copy_(normal(rng, tuple(k.shape), "bfloat16"))
        v.copy_(normal(rng, tuple(v.shape), "bfloat16"))
        graph.replay()
        tdec.count_replays({"decode_attention": 1})
        eager = tdec.decode_attention(q, k, v, valid)
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    assert tdec.LAUNCHES["decode_attention"] == launches + 4
    graph.reset()


@pytest.mark.gpu
def test_kernels_refuse_cpu_tensors_grad_and_bad_shapes():
    _need_cuda()
    q = torch.ones(1, 8, 4, 64, device="cuda")
    k = torch.ones(1, 8, 2, 64, device="cuda")
    valid = torch.ones(8, dtype=torch.bool, device="cuda")
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
    with pytest.raises(ValueError, match="valid must be bool"):
        tdec.decode_attention(q[:, :1], k, k, valid[:5])
    with pytest.raises(ValueError, match="valid must be bool"):
        tdec.decode_attention(q[:, :1], k, k, valid.int())
    with pytest.raises(ValueError, match="16-byte boundary"):
        kb = torch.ones(8 * 2 * 64 + 1, dtype=torch.bfloat16, device="cuda")[1:]
        tdec.decode_attention(q[:, :1].to(torch.bfloat16), kb.view(1, 8, 2, 64),
                              k.to(torch.bfloat16), valid)
    with pytest.raises(ValueError, match="contiguous"):
        tflash.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                               k, k)
    qb = torch.ones(8 * 4 * 64 + 1, dtype=torch.bfloat16, device="cuda")[1:]
    kb = k.to(torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte boundary"):
        tflash.flash_attention(qb.view(1, 8, 4, 64), kb, kb)
    assert (tflash.LAUNCHES, tdec.LAUNCHES) == counts
