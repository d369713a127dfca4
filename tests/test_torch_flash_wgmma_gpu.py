"""The 2-byte flash forward's wgmma body (``flash_tc_kernel_wgmma``) on the
card, against the plain version: o and the rows' log-sum-exp. Imports no
JAX, so that it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_flash_wgmma_gpu.py

* the cells' shapes: phi3-mini's training call (B 2 x S 4096, H 32, D 96,
  window 2047, with the log-sum-exp) and deepseek-v2-lite's MLA prefill
  (B 1 x S 8064, H 16, q and k at 192, v at 128, YaRN's scale);
* a ragged T, S off the 128-row tile grid, GQA groups 4 and 7 (a group of
  7 takes 63 packed rows), at both instantiated widths and in fp16;
* query rows that see no key (S 12, T 6, window 2, causal and not);
* views read in place (a head-transposed q, k and v column slices of one
  fused tensor), bit for bit the dense call;
* ``attention._mla_flash``: one forward launch, on this body, with v a
  column slice of the up-projection at 128, copied and widened nowhere.

Every call must launch the body (``LAUNCHES["flash_attention.wgmma"]``).
Tolerances: 2e-2 bf16, 1e-2 fp16 (``tests/test_torch_kernel_domain_gpu.py``);
the log-sum-exp (fp32 from fp32 sums) to 1e-2, on rows that see a key (a
row that sees none holds the sentinel's scale, which the backward does
not read). Without a CUDA card every test skips."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch import _graph, obs
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import kernel as tflash
from repro_torch.kernels.flash_attention import ref as tflash_ref
from repro_torch.models import attention

TOL = {"bfloat16": 2e-2, "float16": 1e-2}
LSE_TOL = 1e-2


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _yarn_scale():
    return attention.mla_softmax_scale(
        get_config("deepseek-v2-lite").segments[0].layers[0].mla)


def _normal(rng, shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        "cuda", getattr(torch, dtype))


# name -> (B, S, T, H, KV, D, Dv, causal, window, YaRN's scale)
SHAPES = {
    "phi3_train": (2, 4096, 4096, 32, 32, 96, 96, True, 2047, False),
    "mla_prefill": (1, 8064, 8064, 16, 16, 192, 128, True, None, True),
    "ragged_t": (2, 200, 333, 4, 4, 96, 96, False, None, False),
    "ragged_t_mla": (1, 150, 333, 4, 4, 192, 128, False, None, True),
    "s_off_grid": (1, 1000, 1000, 2, 2, 96, 96, True, None, False),
    "s_off_grid_mla": (1, 777, 777, 4, 4, 192, 128, True, None, True),
    "gqa4": (1, 513, 513, 8, 2, 96, 96, True, None, False),
    "gqa7": (1, 300, 300, 14, 2, 96, 96, True, 64, False),
    "gqa4_mla": (1, 300, 300, 8, 2, 192, 128, True, None, True),
    "gqa7_mla": (2, 259, 259, 14, 2, 192, 128, True, None, True),
    "nokey_causal": (1, 12, 6, 4, 2, 96, 96, True, 2, False),
    "nokey": (1, 12, 6, 4, 2, 96, 96, False, 2, False),
    "nokey_mla": (1, 12, 6, 4, 2, 192, 128, True, 2, True),
}
# the cells' shapes in bf16; the rest in both 2-byte types
CASES = [(n, "bfloat16") for n in ("phi3_train", "mla_prefill")] + [
    (n, dt) for n in SHAPES if n not in ("phi3_train", "mla_prefill")
    for dt in ("bfloat16", "float16")]


def _run(q, k, v, causal, window, scale):
    """The kernel's (o, lse), checked to have launched the wgmma body."""
    before = tflash.LAUNCHES["flash_attention.wgmma"]
    o, lse = tflash.flash_attention(q, k, v, causal=causal, window=window,
                                    scale=scale, return_lse=True)
    torch.cuda.synchronize()
    assert tflash.LAUNCHES["flash_attention.wgmma"] == before + 1
    return o, lse


def _check(o, lse, q, k, v, causal, window, scale, dtype):
    want = tflash_ref.attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    assert o.shape == want.shape and o.dtype == want.dtype
    torch.testing.assert_close(o.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])
    want_lse = tflash_ref.attention_lse_ref(q, k, causal=causal, window=window,
                                            scale=scale)
    seen = want_lse.abs() < 1e20
    torch.testing.assert_close(lse[seen], want_lse[seen], rtol=LSE_TOL, atol=LSE_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("name, dtype", CASES)
def test_wgmma_forward_matches_plain(name, dtype):
    _need_cuda()
    b, s, t, h, kv, d, dv, causal, window, yarn = SHAPES[name]
    rng = np.random.default_rng(len(name))
    q, k, v = (_normal(rng, shape, dtype)
               for shape in ((b, s, h, d), (b, t, kv, d), (b, t, kv, dv)))
    assert tflash.dispatch(d, q.dtype, (q, k, v), dv=dv, group=h // kv)["body"] == "wgmma"
    scale = _yarn_scale() if yarn else None
    o, lse = _run(q, k, v, causal, window, scale)
    _check(o, lse, q, k, v, causal, window, scale, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ("bfloat16", "float16"))
@pytest.mark.parametrize("d, dv", [(96, 96), (192, 128)])
def test_wgmma_forward_reads_views_in_place(d, dv, dtype):
    """q head-transposed, k and v column slices of one fused tensor: read
    through their strides (no copy), bit for bit the dense call."""
    _need_cuda()
    rng = np.random.default_rng(11)
    b, s, h = 2, 300, 8
    q = _normal(rng, (b, h, s, d), dtype).transpose(1, 2)
    fused = _normal(rng, (b, s, h, d + 32 + dv), dtype)
    k, v = fused[..., :d], fused[..., d + 32:]
    assert tflash.dispatch(d, q.dtype, (q, k, v), dv=dv)["copy"] == [False] * 3
    got, lse = _run(q, k, v, True, 100, None)
    dense, dense_lse = _run(*(x.contiguous() for x in (q, k, v)), True, 100, None)
    assert torch.equal(got, dense) and torch.equal(lse, dense_lse)
    _check(got, lse, q, k, v, True, 100, None, dtype)


@pytest.mark.gpu
def test_mla_flash_launches_one_wgmma_forward_with_v_in_place():
    """``_mla_flash`` as the MLA prefill calls it: v a column slice of the
    up-projection at its own width 128, one forward launch on the wgmma
    body, nothing copied, counted by the obs counter too; o against the
    plain version with v widened by zero columns (the call before v took a
    width of its own)."""
    _need_cuda()
    spec = get_config("deepseek-v2-lite").segments[0].layers[0].mla
    rng = np.random.default_rng(5)
    b, s, h = 1, 1000, spec.n_heads
    dn, dr, dv = spec.qk_nope_dim, spec.qk_rope_dim, spec.v_head_dim
    kv = _normal(rng, (b, s, h, dn + dv), "bfloat16")
    k_nope, v = kv.split([dn, dv], dim=-1)
    q_nope, q_rope = _normal(rng, (b, s, h, dn), "bfloat16"), _normal(rng, (b, s, h, dr), "bfloat16")
    k_rope = _normal(rng, (b, s, dr), "bfloat16")
    scale = attention.mla_softmax_scale(spec)
    assert not v.is_contiguous()
    assert tflash.dispatch(dn + dr, v.dtype, [v], dv=dv)["copy"] == [False]
    _graph.reset()
    with obs.recording(obs.Recorder()) as rec, torch.no_grad():
        out = attention._mla_flash(q_nope, q_rope, k_nope, k_rope, v, scale)
    torch.cuda.synchronize()
    assert tflash.LAUNCHES == {"flash_attention": 1, "flash_attention.wgmma": 1,
                               "flash_attention_bwd": 0}
    counters = rec.metrics.snapshot()["counters"]
    assert counters.get("kernels.flash_fwd.wgmma") == 1
    assert "kernels.flash_fwd.mma" not in counters
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, dr)], dim=-1)
    wide = torch.nn.functional.pad(v, (0, dn + dr - dv))
    want = tflash_ref.attention_ref(q, k, wide, scale=scale)[..., :dv]
    assert out.shape == (b, s, h * dv)
    torch.testing.assert_close(out.float(), want.reshape(b, s, h * dv).float(),
                               rtol=TOL["bfloat16"], atol=TOL["bfloat16"])
