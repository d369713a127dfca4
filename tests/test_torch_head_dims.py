"""Head dims off the powers of two, the port against the reference, on CPU.

The reference's Pallas kernels take any head dim: their blocks span the
whole of D. The port's kernels run every D from 1 to 256 at the smallest of
their widths 16, 32, 64, 128 and 256 that holds it, reading the rows
unpadded. Here, on the CPU, the port's ops run their plain versions; the
reference's ``ops`` run the Pallas kernels in interpret mode, as
``tests/test_kernels.py`` runs them. Both get the same numpy inputs from a
seed, at the reference's tolerances (2e-5 fp32, 2e-2 bf16):

* the forward, causal and with a window;
* its gradient: ``jax.grad`` through the reference's Pallas flash fails on
  the installed jax (``_pallas_call_jvp_rule``), so the reference side is
  ``jax.grad`` of its plain oracle ``ref.attention_ref``, which is how the
  reference differentiates attention. The port side is both its CPU path's
  autograd and ``ref.attention_bwd_ref``, the formula the backward kernel
  computes from the forward's log-sum-exp;
* decode against a cache whose valid slots are a stale ring (holes in the
  middle, not a prefix).

D 36 is the case whose rows lie off the 16-byte grid in bf16 (D % 8 != 0).
The kernels themselves are held to these plain versions at the same head
dims on the card (``tests/test_torch_head_dims_gpu.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.kernels.decode_attention import ops as jdec
from repro.kernels.flash_attention import ops as jflash
from repro.kernels.flash_attention import ref as jflash_ref
from repro_torch.kernels.decode_attention import kernel as tdec_kernel
from repro_torch.kernels.decode_attention import ops as tdec
from repro_torch.kernels.flash_attention import kernel as tflash_kernel
from repro_torch.kernels.flash_attention import ops as tflash
from repro_torch.kernels.flash_attention import ref as tflash_ref

HEAD_DIMS = (8, 36, 40, 80, 112, 200)
DTYPES = ("float32", "bfloat16")
WINDOWS = (None, 16)            # causal, and causal with a window
TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels.py::_tol
B, S, H, KV = 2, 48, 4, 2       # GQA group 2, S off the reference's blocks
T_DEC = 72


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _qkv(d, seed=0):
    return (_normal((B, S, H, d), seed), _normal((B, S, KV, d), seed + 1),
            _normal((B, S, KV, d), seed + 2))


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def _ring_valid(t):
    """A ring cache mid-wrap: a stale run in the middle and a hole near the
    start, so the valid slots are not a prefix."""
    valid = np.ones(t, bool)
    valid[t // 3:t // 2] = False
    valid[3] = False
    return valid


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_forward_matches_reference_kernel(d, dtype, window):
    q, k, v = _qkv(d)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jflash.flash_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                                  window=window)
    got = tflash.flash_attention(*(torch.from_numpy(x).to(tdt)
                                   for x in (q, k, v)), window=window)
    assert got.dtype == tdt and tuple(got.shape) == (B, S, H, d)
    _close(got, want, dtype)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_gradient_matches_reference(d, dtype, window):
    q, k, v = _qkv(d, seed=10)
    do = _normal((B, S, H, d), 13)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def loss(q, k, v):
        o = jflash_ref.attention_ref(q, k, v, window=window)
        return (o.astype(jnp.float32) * jnp.asarray(do)).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x, jdt) for x in (q, k, v)))
    qt, kt, vt = (torch.from_numpy(x).to(tdt).requires_grad_() for x in (q, k, v))
    o = tflash.flash_attention(qt, kt, vt, window=window)
    (o.float() * torch.from_numpy(do)).sum().backward()
    for name, got, w in zip("qkv", (qt.grad, kt.grad, vt.grad), want):
        assert got.dtype == tdt, name
        _close(got, w, dtype)
    # the backward kernel's formula, from the forward's log-sum-exp
    with torch.no_grad():
        x = [t.detach() for t in (qt, kt, vt)]
        o = tflash_ref.attention_ref(*x, window=window)
        lse = tflash_ref.attention_lse_ref(x[0], x[1], window=window)
        grads = tflash_ref.attention_bwd_ref(*x, o, lse,
                                             torch.from_numpy(do).to(tdt),
                                             window=window)
    for name, got, w in zip("qkv", grads, want):
        _close(got, w, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_decode_matches_reference_kernel(d, dtype):
    q = _normal((B, 1, H, d), 20)
    k, v = _normal((B, T_DEC, KV, d), 21), _normal((B, T_DEC, KV, d), 22)
    valid = _ring_valid(T_DEC)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jdec.decode_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                                 jnp.asarray(valid))
    got = tdec.decode_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                                torch.from_numpy(valid))
    assert got.dtype == tdt and tuple(got.shape) == (B, 1, H, d)
    _close(got, want, dtype)


@pytest.mark.parametrize("d", (1, 8, 36, 80, 96, 112, 200, 256))
def test_every_head_dim_up_to_256_passes_the_kernels_checks(d):
    """The wrappers' head-dim rule is a range, 1..256: every such D passes
    it (the checks stop at the device, since no card is here), and the
    bf16 backward pads only a D off the 16-byte grid."""
    for check in (lambda x: tflash_kernel._check(x, x[:, :, :2], x[:, :, :2],
                                                 True, None),
                  lambda x: tdec_kernel._check(x[:, :1], x[:, :, :2],
                                               x[:, :, :2],
                                               torch.ones(4, dtype=torch.bool))):
        with pytest.raises(ValueError, match="CUDA device"):
            check(torch.zeros(1, 4, 4, d))
    assert tflash_kernel._bwd_width(d, torch.float32) == d
    assert tflash_kernel._bwd_width(d, torch.bfloat16) == -(-d // 8) * 8


@pytest.mark.parametrize("d", (0, 257, 320))
def test_head_dims_outside_1_to_256_are_refused(d):
    """D 0 has no rows to read and is refused. D 257 and 320 (past the
    widest instantiation: run in column passes of 256, as the reference
    takes any D) pass the head-dim check and stop only at the CUDA-device
    check, since no card is here."""
    x = torch.zeros(1, 4, 4, d)
    match = "head_dim 0 must be at least 1" if d == 0 else "CUDA device"
    with pytest.raises(ValueError, match=match):
        tflash_kernel._check(x, x[:, :, :2], x[:, :, :2], True, None)
    with pytest.raises(ValueError, match=match):
        tdec_kernel._check(x[:, :1], x[:, :, :2], x[:, :, :2],
                           torch.ones(4, dtype=torch.bool))
