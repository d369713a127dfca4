"""Every input the reference's kernel functions take, the port against the
reference, on the CPU.

The reference's ``ops`` compute head dims past 256, float16, any layout
(JAX arrays have no strides), an fp32 adjacency with bf16 features and
query rows that see no key. The port's kernels take all of these on the
card (``tests/test_torch_kernel_domain_gpu.py``); here its ops run their
plain versions, and the reference's ``ops`` run the Pallas kernels in
interpret mode, as ``tests/test_kernels.py`` runs them. Both get the same
numpy inputs from a seed. Tolerances: 2e-5 fp32, 2e-2 bf16
(``tests/test_kernels.py``), 1e-2 fp16 (3 more mantissa bits than bf16).

* D 257, 320 and 512 on ``flash_attention`` (causal, and a window) and
  ``decode_attention``, and the gradient at those head dims;
* float16 on all four entry points;
* transposed, sliced, offset, head-transposed and unbound views, which the
  port's ops take as they are; its attention kernels read a view with a
  unit-stride last axis on the 16-byte grid through its strides, and the
  wrappers copy any other view dense first (``dispatch``);
* ``spmm`` / ``scaled_spmm`` with an fp32 adjacency and bf16 features;
* query rows that see no key (S 12, T 6, window 2): the forward against
  the reference's ``ref.attention_ref``, not its Pallas kernel, which at
  those rows divides by its padded block of 8 keys instead of T (a quirk
  of the TPU tiling, recorded in ROADMAP.md); the gradient against
  ``jax.grad`` of ``ref.attention_ref`` (``jax.grad`` through the Pallas
  kernel fails on the installed jax), on the port's autograd and on
  ``attention_bwd_ref``, the formula the backward kernel computes;
* the wrappers' dispatch rules, case by case: body, width, passes, padding
  and which inputs are copied."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.kernels.decode_attention import ops as jdec
from repro.kernels.flash_attention import ops as jflash
from repro.kernels.flash_attention import ref as jflash_ref
from repro.kernels.gcn_spmm import ops as jspmm
from repro_torch.kernels import _layout
from repro_torch.kernels.decode_attention import kernel as tdec_kernel
from repro_torch.kernels.decode_attention import ops as tdec
from repro_torch.kernels.flash_attention import kernel as tflash_kernel
from repro_torch.kernels.flash_attention import ops as tflash
from repro_torch.kernels.flash_attention import ref as tflash_ref
from repro_torch.kernels.gcn_spmm import kernel as tspmm_kernel
from repro_torch.kernels.gcn_spmm import ops as tspmm

WIDE_DIMS = (257, 320, 512)
TOL = {"float32": 2e-5, "bfloat16": 2e-2, "float16": 1e-2}
B, S, H, KV = 1, 24, 4, 2       # GQA group 2, S off the reference's blocks
T_DEC = 40
NOKEY = dict(s=12, t=6, window=2, d=16)


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _qkv(d, seed=0, s=S, t=S):
    return (_normal((B, s, H, d), seed), _normal((B, t, KV, d), seed + 1),
            _normal((B, t, KV, d), seed + 2))


def _close(got, want, dtype):
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def _ring_valid(t):
    valid = np.ones(t, bool)
    valid[t // 3:t // 2] = False
    valid[3] = False
    return valid


def _spmm_inputs(n=40, d=33, seed=7):
    rng = np.random.default_rng(seed)
    adj = (rng.random((n, n)) < 0.2).astype(np.float32)
    np.fill_diagonal(adj, 1.0)
    feats = rng.standard_normal((n, d)).astype(np.float32)
    r = rng.random(n).astype(np.float32) + 0.5
    c = rng.random(n).astype(np.float32) + 0.5
    return adj, feats, r, c


# -- head dims past 256 ---------------------------------------------------------

@pytest.mark.parametrize("window", (None, 8))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_wide_forward_matches_reference_kernel(d, dtype, window):
    q, k, v = _qkv(d)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jflash.flash_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                                  window=window)
    got = tflash.flash_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                                 window=window)
    assert tuple(got.shape) == (B, S, H, d)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_wide_decode_matches_reference_kernel(d, dtype):
    q = _normal((B, 1, H, d), 20)
    k, v = _normal((B, T_DEC, KV, d), 21), _normal((B, T_DEC, KV, d), 22)
    valid = _ring_valid(T_DEC)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jdec.decode_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                                 jnp.asarray(valid))
    got = tdec.decode_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                                torch.from_numpy(valid))
    _close(got, want, dtype)


def _grads_against_reference(q, k, v, do, dtype, causal, window):
    """The port's CPU autograd and ``attention_bwd_ref`` (from the forward's
    output and log-sum-exp) against ``jax.grad`` of the reference's
    ``ref.attention_ref``."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def loss(q, k, v):
        o = jflash_ref.attention_ref(q, k, v, causal=causal, window=window)
        return (o.astype(jnp.float32) * jnp.asarray(do)).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x, jdt) for x in (q, k, v)))
    qt, kt, vt = (torch.from_numpy(x).to(tdt).requires_grad_() for x in (q, k, v))
    o = tflash.flash_attention(qt, kt, vt, causal=causal, window=window)
    (o.float() * torch.from_numpy(do)).sum().backward()
    for got, w in zip((qt.grad, kt.grad, vt.grad), want):
        _close(got, w, dtype)
    with torch.no_grad():
        x = [t.detach() for t in (qt, kt, vt)]
        o = tflash_ref.attention_ref(*x, causal=causal, window=window)
        lse = tflash_ref.attention_lse_ref(x[0], x[1], causal=causal, window=window)
        grads = tflash_ref.attention_bwd_ref(*x, o, lse, torch.from_numpy(do).to(tdt),
                                             causal=causal, window=window)
    for got, w in zip(grads, want):
        _close(got, w, dtype)


@pytest.mark.parametrize("d", WIDE_DIMS)
def test_wide_gradient_matches_reference(d):
    q, k, v = _qkv(d, seed=10)
    do = _normal((B, S, H, d), 13)
    _grads_against_reference(q, k, v, do, "float32", True, 8)


# -- float16 ----------------------------------------------------------------------

@pytest.mark.parametrize("d", (36, 96, 320))
def test_float16_flash_attention_matches_reference_kernel(d):
    q, k, v = _qkv(d, seed=30)
    want = jflash.flash_attention(*(jnp.asarray(x, jnp.float16) for x in (q, k, v)),
                                  window=8)
    got = tflash.flash_attention(*(torch.from_numpy(x).half() for x in (q, k, v)),
                                 window=8)
    _close(got, want, "float16")


@pytest.mark.parametrize("d", (36, 96, 320))
def test_float16_decode_attention_matches_reference_kernel(d):
    q = _normal((B, 1, H, d), 31)
    k, v = _normal((B, T_DEC, KV, d), 32), _normal((B, T_DEC, KV, d), 33)
    valid = _ring_valid(T_DEC)
    want = jdec.decode_attention(*(jnp.asarray(x, jnp.float16) for x in (q, k, v)),
                                 jnp.asarray(valid))
    got = tdec.decode_attention(*(torch.from_numpy(x).half() for x in (q, k, v)),
                                torch.from_numpy(valid))
    _close(got, want, "float16")


@pytest.mark.parametrize("scaled", (False, True))
def test_float16_gcn_spmm_matches_reference_kernel(scaled):
    adj, feats, r, c = _spmm_inputs()
    ja, jh = jnp.asarray(adj, jnp.float16), jnp.asarray(feats, jnp.float16)
    ta, th = torch.from_numpy(adj).half(), torch.from_numpy(feats).half()
    if scaled:
        want = jspmm.scaled_spmm(ja, jh, jnp.asarray(r), jnp.asarray(c))
        got = tspmm.scaled_spmm(ta, th, torch.from_numpy(r), torch.from_numpy(c))
    else:
        want, got = jspmm.spmm(ja, jh), tspmm.spmm(ta, th)
    _close(got, want, "float16")


# -- views ----------------------------------------------------------------------

def _view(x: torch.Tensor, kind: str) -> torch.Tensor:
    """``x``'s values as a transposed (last two axes), column-sliced,
    offset, head-transposed (rows and heads of a (B, S, H, D) tensor) or
    unbound (one of two tensors fused on a new axis before the last) view."""
    if kind == "transposed":
        return x.transpose(-1, -2).contiguous().transpose(-1, -2)
    if kind == "heads":
        return x.transpose(-2, -3).contiguous().transpose(-2, -3)
    if kind == "unbind":
        return torch.stack([torch.zeros_like(x), x], dim=-2).unbind(-2)[1]
    if kind == "sliced":
        wide = torch.zeros((*x.shape[:-1], x.shape[-1] + 8), dtype=x.dtype)
        wide[..., :x.shape[-1]] = x
        return wide[..., :x.shape[-1]]
    flat = torch.empty(x.numel() + 1, dtype=x.dtype)
    flat[1:] = x.reshape(-1)
    return flat[1:].view(x.shape)


VIEWS = ("transposed", "sliced", "offset")
# the views the attention kernels read in place: a unit-stride last axis,
# the address and the other strides on the 16-byte grid
STRIDED = ("sliced", "heads", "unbind")
ATTN_VIEWS = VIEWS + ("heads", "unbind")


@pytest.mark.parametrize("kind", ATTN_VIEWS)
def test_flash_attention_views_match_reference_kernel(kind):
    q, k, v = _qkv(40, seed=40)
    want = jflash.flash_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                                  window=8)
    dense = [torch.from_numpy(x).bfloat16() for x in (q, k, v)]
    views = [_view(x, kind) for x in dense]
    plan = tflash_kernel.dispatch(40, torch.bfloat16, views)
    assert plan["copy"] == [kind not in STRIDED] * 3
    _close(tflash.flash_attention(*views, window=8), want, "bfloat16")


@pytest.mark.parametrize("kind", ATTN_VIEWS)
def test_decode_attention_views_match_reference_kernel(kind):
    q = _normal((B, 1, H, 40), 41)
    k, v = _normal((B, T_DEC, KV, 40), 42), _normal((B, T_DEC, KV, 40), 43)
    valid = _ring_valid(T_DEC)
    want = jdec.decode_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                                 jnp.asarray(valid))
    views = [_view(torch.from_numpy(x).bfloat16(), kind) for x in (q, k, v)]
    plan = tdec_kernel.dispatch(40, (*views, torch.ones(T_DEC, dtype=torch.bool)))
    assert plan["copy"] == [kind not in STRIDED] * 3 + [False]
    _close(tdec.decode_attention(*views, torch.from_numpy(valid)), want, "bfloat16")


@pytest.mark.parametrize("kind", VIEWS)
@pytest.mark.parametrize("scaled", (False, True))
def test_gcn_spmm_views_match_reference_kernel(scaled, kind):
    adj, feats, r, c = _spmm_inputs(seed=44)
    ja, jh = jnp.asarray(adj), jnp.asarray(feats)
    ta, th = (_view(torch.from_numpy(x), kind) for x in (adj, feats))
    plan = tspmm_kernel.dispatch(torch.float32, (ta, th))
    assert plan["copy"] == [kind != "offset"] * 2   # fp32 needs 4-byte addresses only
    if scaled:
        want = jspmm.scaled_spmm(ja, jh, jnp.asarray(r), jnp.asarray(c))
        got = tspmm.scaled_spmm(ta, th, torch.from_numpy(r), torch.from_numpy(c))
    else:
        want, got = jspmm.spmm(ja, jh), tspmm.spmm(ta, th)
    _close(got, want, "float32")


# -- mixed adjacency and feature dtypes ---------------------------------------

@pytest.mark.parametrize("scaled", (False, True))
def test_fp32_adjacency_with_bf16_features_matches_reference_kernel(scaled):
    adj, feats, r, c = _spmm_inputs(seed=50)
    ja, jh = jnp.asarray(adj, jnp.float32), jnp.asarray(feats, jnp.bfloat16)
    ta, th = torch.from_numpy(adj), torch.from_numpy(feats).bfloat16()
    if scaled:
        want = jspmm.scaled_spmm(ja, jh, jnp.asarray(r), jnp.asarray(c))
        got = tspmm.scaled_spmm(ta, th, torch.from_numpy(r), torch.from_numpy(c))
    else:
        want, got = jspmm.spmm(ja, jh), tspmm.spmm(ta, th)
    assert want.dtype == jnp.bfloat16
    _close(got, want, "bfloat16")


# -- query rows that see no key ------------------------------------------------

@pytest.mark.parametrize("dtype", ("float32", "bfloat16", "float16"))
@pytest.mark.parametrize("causal", (True, False))
def test_rows_that_see_no_key_match_the_reference_oracle(causal, dtype):
    c = NOKEY
    q, k, v = _qkv(c["d"], seed=60, s=c["s"], t=c["t"])
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jflash_ref.attention_ref(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                                    causal=causal, window=c["window"])
    got = tflash.flash_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                                 causal=causal, window=c["window"])
    _close(got, want, dtype)
    # rows from T + window - 1 on: the uniform average over the T keys
    first = c["t"] + c["window"] - 1
    mean_v = torch.from_numpy(v).to(tdt).float().mean(1).repeat_interleave(H // KV, 1)
    for row in range(first, c["s"]):
        torch.testing.assert_close(got[:, row].float(), mean_v, rtol=TOL[dtype],
                                   atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ("float32", "bfloat16", "float16"))
@pytest.mark.parametrize("causal", (True, False))
def test_rows_that_see_no_key_gradient_matches_reference(causal, dtype):
    c = NOKEY
    q, k, v = _qkv(c["d"], seed=61, s=c["s"], t=c["t"])
    do = _normal((B, c["s"], H, c["d"]), 64)
    _grads_against_reference(q, k, v, do, dtype, causal, c["window"])


# -- the dispatch rules ---------------------------------------------------------

@pytest.mark.parametrize("d, dv, dtype, group, body, width, passes, pad_to", [
    (8, None, torch.float32, 1, "fma", 16, 1, 8), (96, None, torch.float32, 1, "fma", 128, 1, 96),
    (256, None, torch.float32, 1, "fma", 256, 1, 256),
    (257, None, torch.float32, 1, "fma", 256, 2, 257),
    (1024, None, torch.float32, 1, "fma", 256, 4, 1024),
    (36, None, torch.bfloat16, 1, "mma", 64, 1, 36),
    (320, None, torch.bfloat16, 1, "mma", 256, 2, 320),
    (512, None, torch.float16, 1, "mma", 256, 2, 512),
    (576, None, torch.float16, 1, "mma", 256, 3, 576),
    # the wgmma body at its widths: phi3-mini's 96, MLA's 192 with v at 128
    (96, 96, torch.bfloat16, 1, "wgmma", 96, 1, 96),
    (96, 96, torch.float16, 1, "wgmma", 96, 1, 96),
    (96, 96, torch.bfloat16, 7, "wgmma", 96, 1, 96),
    (192, 128, torch.bfloat16, 1, "wgmma", 192, 1, 192),
    (192, 128, torch.float16, 4, "wgmma", 192, 1, 192),
    (64, 64, torch.bfloat16, 7, "wgmma", 64, 1, 64),
    (128, 128, torch.bfloat16, 1, "wgmma", 128, 1, 128),
    (256, 256, torch.bfloat16, 4, "mma", 256, 1, 256),
    # the old bodies elsewhere: D 80 and 512, fp32, widths not instantiated,
    # a group past one warp group's 64 rows
    (80, 80, torch.bfloat16, 1, "mma", 128, 1, 80),
    (512, 512, torch.bfloat16, 1, "mma", 256, 2, 512),
    (96, 96, torch.float32, 1, "fma", 128, 1, 96),
    (192, 128, torch.float32, 1, "fma", 256, 1, 192),
    (192, 192, torch.bfloat16, 1, "mma", 256, 1, 192),
    (128, 64, torch.bfloat16, 1, "mma", 128, 1, 128),
    (64, 96, torch.float16, 1, "mma", 128, 1, 96),
    (96, 96, torch.bfloat16, 65, "mma", 128, 1, 96)])
def test_flash_forward_dispatch(d, dv, dtype, group, body, width, passes, pad_to):
    x = torch.zeros(1, 2, 2, d, dtype=dtype)
    plan = tflash_kernel.dispatch(d, dtype, [x], dv=dv, group=group)
    assert (plan["body"], plan["width"], plan["passes"], plan["pad_to"],
            plan["copy"]) == (body, width, passes, pad_to, [False])


@pytest.mark.parametrize("window", (None, 5))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("d, dv", [(192, 128), (96, 64)])
def test_forward_takes_v_of_its_own_width(d, dv, dtype, window):
    """v at Dv < D: o at Dv, equal to the reference's function with v
    widened by zero columns to D and the output's first Dv columns kept."""
    q, k, v = _qkv(d, seed=70)
    v = v[..., :dv].copy()
    wide = np.concatenate([v, np.zeros(v.shape[:3] + (d - dv,), np.float32)], -1)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jflash_ref.attention_ref(*(jnp.asarray(x, jdt) for x in (q, k, wide)),
                                    causal=True, window=window)
    got = tflash.flash_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                                 window=window)
    assert got.shape == (B, S, H, dv)
    _close(got, np.asarray(want, np.float32)[..., :dv], dtype)


def test_autograd_path_refuses_v_of_another_width():
    """The backward takes one head dim: the autograd Function refuses v of
    another width than q and k, as the CUDA path's ``scale``."""
    q, k, v = (torch.zeros(1, 4, 2, dd, requires_grad=True) for dd in (96, 96, 64))
    with pytest.raises(ValueError, match="head dim"):
        tflash.FlashAttention.apply(q, k, v, True, None)


@pytest.mark.parametrize("d, dtype, body, width, passes, pad_to", [
    (36, torch.float32, "fma", 64, 1, 36), (36, torch.bfloat16, "wgmma", 128, 1, 40),
    (96, torch.float16, "wgmma", 128, 1, 96), (200, torch.bfloat16, "wgmma", 256, 1, 200),
    (257, torch.bfloat16, "wgmma", 256, 2, 264), (320, torch.float16, "wgmma", 256, 2, 320),
    (512, torch.bfloat16, "wgmma", 256, 2, 512), (512, torch.float16, "wgmma", 256, 2, 512),
    (576, torch.bfloat16, "wgmma", 256, 3, 576), (576, torch.float16, "wgmma", 256, 3, 576),
    (1024, torch.bfloat16, "wgmma", 256, 4, 1024), (1024, torch.float16, "wgmma", 256, 4, 1024),
    (1024, torch.float32, "fma", 256, 4, 1024)])
def test_flash_backward_dispatch(d, dtype, body, width, passes, pad_to):
    x = torch.zeros(1, 2, 2, d, dtype=dtype)
    plan = tflash_kernel.dispatch(d, dtype, [x], backward=True)
    assert (plan["body"], plan["width"], plan["passes"], plan["pad_to"]) == \
        (body, width, passes, pad_to)


@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float16))
def test_two_byte_backward_runs_wgmma_at_every_head_dim(dtype):
    """No 2-byte backward plan runs the FMA bodies: every D from 1 to 1024
    plans the tensor-core body, padded to the 16-byte grid, at a width and
    pass count that hold the padded D."""
    for d in range(1, 1025):
        plan = tflash_kernel.dispatch(d, dtype, [], backward=True)
        pad_to = -(-d // 8) * 8
        assert plan["body"] == "wgmma" and plan["pad_to"] == pad_to, (d, plan)
        if d <= 256:
            assert (plan["width"], plan["passes"]) == (128 if d <= 128 else 256, 1), d
        else:
            assert (plan["width"], plan["passes"]) == (256, -(-pad_to // 256)), d


def test_fp32_backward_keeps_fma_at_every_head_dim():
    """fp32 keeps the FMA bodies (IEEE math for its 2e-5 tolerance) at
    every D, unpadded: one pass up to 256, passes of 256 past it."""
    for d in range(1, 1025):
        plan = tflash_kernel.dispatch(d, torch.float32, [], backward=True)
        assert (plan["body"], plan["pad_to"], plan["passes"]) == ("fma", d, -(-d // 256)), d


@pytest.mark.parametrize("d, width, passes", [
    (1, 16, 1), (80, 128, 1), (256, 256, 1), (257, 256, 2), (1024, 256, 4)])
def test_decode_dispatch(d, width, passes):
    plan = tdec_kernel.dispatch(d, [])
    assert (plan["width"], plan["passes"]) == (width, passes)


@pytest.mark.parametrize("feats, others, body, promote", [
    (torch.float32, [torch.float32] * 2, torch.float32, False),
    (torch.bfloat16, [torch.bfloat16] * 4, torch.bfloat16, False),
    (torch.float16, [torch.float16] * 2, torch.float16, False),
    (torch.bfloat16, [torch.float32, torch.bfloat16], torch.float32, True),
    (torch.float32, [torch.float16, torch.float32], torch.float32, True)])
def test_gcn_spmm_dispatch(feats, others, body, promote):
    plan = tspmm_kernel.dispatch(feats, [torch.zeros(2, dtype=dt) for dt in others])
    assert (plan["body"], plan["promote"]) == (body, promote)


def _views_for_rule():
    """name -> (tensor, alignment, read in place by a dense kernel, by a
    kernel that takes strides)."""
    bf = dict(dtype=torch.bfloat16)
    base = torch.zeros(2, 6, 4, 8, **bf)
    flat = torch.zeros(2 * 6 * 4 * 8 + 8, **bf)
    return {
        "dense": (base, 16, True, True),
        "transposed": (base.transpose(1, 2), 16, False, True),
        "last axis transposed": (base.transpose(2, 3), 16, False, False),
        "sliced": (torch.zeros(2, 6, 4, 16, **bf)[..., :8], 16, False, True),
        "sliced, rows off the grid": (torch.zeros(2, 6, 4, 12, **bf)[..., :8], 16, False,
                                      False),
        "sliced fp32, element alignment": (torch.zeros(2, 6, 4, 9)[..., :8], 4, False, True),
        "unbind": (torch.zeros(2, 6, 3, 4, 8, **bf).unbind(2)[1], 16, False, True),
        "offset by 2 bytes": (flat[1:1 + base.numel()].view(base.shape), 16, False, False),
        "offset by 16 bytes": (flat[8:8 + base.numel()].view(base.shape), 16, True, True),
        "offset by 2 bytes, element alignment": (
            flat[1:1 + base.numel()].view(base.shape), 2, True, True),
        "size-1 dim with any stride": (
            torch.zeros(2, 1, 32, **bf).transpose(0, 1), 16, True, True),
        "empty": (base[:, :0], 16, True, True),
        "row stride past an int": (   # a meta tensor: 8 GB of storage it need not hold
            torch.empty_strided((2, 2, 1, 8), (0, 2 ** 31, 0, 1), device="meta", **bf),
            16, False, False)}


@pytest.mark.parametrize("name", list(_views_for_rule()))
def test_in_place_rule(name):
    """The copy rule: on the kernel's address grid, and dense row-major (as
    ``is_contiguous`` judges it) or, for a kernel that takes strides, a
    unit-stride last axis with the other strides on the grid; else a copy.
    The wrappers' copy is dense and aligned and holds the same values."""
    x, align, dense, strided = _views_for_rule()[name]
    assert _layout.in_place(x, align) is dense
    assert _layout.in_place(x, align, strided=True) is strided
    if x.is_meta:
        return
    y = x if dense else x.clone(memory_format=torch.contiguous_format)   # the wrappers' copy
    assert _layout.in_place(y, align) and torch.equal(y, x)


def test_axes_are_each_tensors_batch_row_and_head_strides():
    """The strides the attention entry points read: (batch, row, head) of
    each tensor in turn, in elements."""
    q = torch.zeros(2, 5, 3, 8).transpose(1, 2)
    k = torch.zeros(2, 7, 4, 2, 8).unbind(2)[3]
    q1 = torch.zeros(2, 4, 3, 8)[:, :1]   # a size-1 axis: its stride unused
    got = list(_layout.axes(q, k, q1))
    assert got == [*q.stride()[:3], *k.stride()[:3], 96, 0, 8] \
        == [120, 8, 24, 448, 64, 8, 96, 0, 8]
