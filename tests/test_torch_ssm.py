"""The port's Mamba block against the reference, on CPU, fp32.

``reduce_for_smoke(jamba-1.5-large-398b)``'s Mamba (d_state 4, d_conv 4,
expand 2; d 32), the reference's ``init_mamba`` params carried across
through numpy: the full forward with and without ``ssm_chunk``, the
prefill's recurrent state and conv tail, and decode steps that update the
cache in place.

Tolerance: the port scans with log2(S) doubling steps (Hillis-Steele), the
reference with ``jax.lax.associative_scan``'s tree, and the chunked forms
add the carried state once per chunk; these orders of summation agree to
``SCAN_TOL``, the tolerance ``test_chunked_exec.py:72-88`` holds the
reference's own chunked and full scans to."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro import configs as jconfigs
from repro.models import ssm as jssm
from repro_torch import configs as tconfigs
from repro_torch._tree import tensor_from_numpy
from repro_torch.configs.base import MambaSpec
from repro_torch.models import ssm as tssm

from _torch_parity import runtime

SCAN_TOL = 5e-5


@pytest.fixture(scope="module")
def mamba():
    arch = "jamba-1.5-large-398b"
    jcfg = jconfigs.reduce_for_smoke(jconfigs.get_config(arch))
    jspec = jcfg.segments[0].layers[0].mamba
    tspec = tconfigs.reduce_for_smoke(tconfigs.get_config(arch)) \
        .segments[0].layers[0].mamba
    assert dataclasses.asdict(jspec) == dataclasses.asdict(tspec)
    jp = jssm.init_mamba(jax.random.PRNGKey(0), jspec, jcfg.d_model, jnp.float32)
    tp = jax.tree.map(lambda a: tensor_from_numpy(np.asarray(a), "cpu"), jp)
    return jspec, tspec, jp, tp, jcfg.d_model


def _close(got, want, tol=SCAN_TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_linear_scan_matches_a_sequential_loop():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 13, 3, 2)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 13, 3, 2)).astype(np.float32))
    cum_a, hs = tssm._linear_scan(a, b)
    h, prod = torch.zeros_like(b[:, 0]), torch.ones_like(a[:, 0])
    for t in range(13):
        h, prod = a[:, t] * h + b[:, t], prod * a[:, t]
        _close(hs[:, t], h.numpy(), 1e-6)
        _close(cum_a[:, t], prod.numpy(), 1e-6)


@pytest.mark.parametrize("chunk", [0, 4])
def test_mamba_full_matches_reference(mamba, chunk):
    jspec, tspec, jp, tp, d = mamba
    x = np.random.default_rng(1).standard_normal((2, 16, d)).astype(np.float32)
    with runtime(ssm_chunk=chunk):
        _close(tssm.mamba_full(tp, tspec, torch.from_numpy(x)),
               jssm.mamba_full(jp, jspec, jnp.asarray(x)))


def test_chunkwise_mamba_matches_full():
    """test_chunked_exec.py::test_chunkwise_mamba_matches_full on the port,
    at its shapes and tolerance."""
    b, s, d = 2, 128, 32
    spec = MambaSpec(d_state=8)
    p = tssm.init_mamba(torch.Generator().manual_seed(6), spec, d, torch.float32)
    x = torch.randn(b, s, d, generator=torch.Generator().manual_seed(7))
    with runtime(ssm_chunk=0):
        y_full = tssm.mamba_full(p, spec, x)
        _, cache_full = tssm.mamba_prefill(p, spec, x)
    with runtime(ssm_chunk=16):
        y_chunk = tssm.mamba_full(p, spec, x)
        _, cache_chunk = tssm.mamba_prefill(p, spec, x)
    _close(y_chunk, y_full.numpy())
    _close(cache_chunk["h"], cache_full["h"].numpy())


@pytest.mark.parametrize("s,chunk", [(12, 0), (12, 4), (2, 0)])
def test_mamba_prefill_and_decode_match_reference(mamba, s, chunk):
    """Prefill, then 5 decode steps: outputs and the cache ({"h", "conv"})
    after each. A 2-token prompt pads the conv tail (d_conv - 1 = 3)."""
    jspec, tspec, jp, tp, d = mamba
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, s, d)).astype(np.float32)
    with runtime(ssm_chunk=chunk):
        yj, cj = jssm.mamba_prefill(jp, jspec, jnp.asarray(x))
        yt, ct = tssm.mamba_prefill(tp, tspec, torch.from_numpy(x))
    _close(yt, yj)
    assert sorted(ct) == sorted(cj) == ["conv", "h"]
    for key in cj:
        assert ct[key].shape == cj[key].shape and ct[key].dtype == torch.float32
        _close(ct[key], cj[key])
    for _ in range(5):
        xt = rng.standard_normal((2, 1, d)).astype(np.float32)
        yj, cj = jssm.mamba_decode(jp, jspec, jnp.asarray(xt), cj)
        yt, ct2 = tssm.mamba_decode(tp, tspec, torch.from_numpy(xt), ct)
        assert ct2 is ct, "the decode step updates the cache in place"
        _close(yt, yj)
        for key in cj:
            _close(ct[key], cj[key])


def test_mamba_prefill_then_decode_equals_the_full_forward(mamba):
    """The state carried by prefill and decode continues the sequence."""
    _, tspec, _, tp, d = mamba
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 10, d)).astype(np.float32))
    y_full = tssm.mamba_full(tp, tspec, x)
    _, cache = tssm.mamba_prefill(tp, tspec, x[:, :7])
    for t in range(7, 10):
        y_t, cache = tssm.mamba_decode(tp, tspec, x[:, t:t + 1], cache)
        _close(y_t[:, 0], y_full[:, t].numpy())
