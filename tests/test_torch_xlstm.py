"""The port's xLSTM blocks against the reference, on CPU, fp32.

``reduce_for_smoke(xlstm-125m)``'s spec (2 heads, projection factor 2, conv
width 4; d 32), the reference's ``init_mlstm`` / ``init_slstm`` params
carried across through numpy. mLSTM: the quadratic and the chunkwise form
(``mlstm_chunk``), the prefill state of each, decode steps that update the
cache in place, and the chunkwise form at S 1024, where the running maxima
of the log gates keep the exponentials finite. sLSTM: the full pass, the
prefill state and decode steps.

Tolerance ``TOL``: the stabilized forms divide by sums of exponentials, and
the chunked forms sum in another order (``test_chunked_exec.py`` holds the
reference's own chunked and full forms to the same 5e-5)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro import configs as jconfigs
from repro.models import xlstm as jxl
from repro_torch import configs as tconfigs
from repro_torch._tree import tensor_from_numpy
from repro_torch.configs.base import XLSTMSpec
from repro_torch.models import xlstm as txl

from _torch_parity import runtime

TOL = 5e-5


@pytest.fixture(scope="module")
def xl():
    arch = "xlstm-125m"
    jcfg = jconfigs.reduce_for_smoke(jconfigs.get_config(arch))
    jspec = jcfg.segments[0].layers[0].xlstm
    tspec = tconfigs.reduce_for_smoke(tconfigs.get_config(arch)) \
        .segments[0].layers[0].xlstm
    assert dataclasses.asdict(jspec) == dataclasses.asdict(tspec)
    d = jcfg.d_model
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    jm = jxl.init_mlstm(keys[0], jspec, d, jnp.float32)
    js = jxl.init_slstm(keys[1], jspec, d, jnp.float32)
    to_t = lambda tree: jax.tree.map(
        lambda a: tensor_from_numpy(np.asarray(a), "cpu"), tree)
    return jspec, tspec, d, (jm, to_t(jm)), (js, to_t(js))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("chunk", [0, 4])
def test_mlstm_full_matches_reference(xl, chunk):
    jspec, tspec, d, (jp, tp), _ = xl
    x = _x((2, 16, d), 1)
    with runtime(mlstm_chunk=chunk):
        _close(txl.mlstm_full(tp, tspec, torch.from_numpy(x)),
               jxl.mlstm_full(jp, jspec, jnp.asarray(x)))


@pytest.mark.parametrize("s,chunk", [(12, 0), (12, 4), (2, 0)])
def test_mlstm_prefill_and_decode_match_reference(xl, s, chunk):
    """The prefill state (closed form, or the chunkwise carry) and 5 decode
    steps from it: outputs and the cache ({"c", "n", "m", "conv"}) after
    each. A 2-token prompt pads the conv tail."""
    jspec, tspec, d, (jp, tp), _ = xl
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, s, d)).astype(np.float32)
    with runtime(mlstm_chunk=chunk):
        yj, cj = jxl.mlstm_prefill(jp, jspec, jnp.asarray(x))
        yt, ct = txl.mlstm_prefill(tp, tspec, torch.from_numpy(x))
    _close(yt, yj)
    assert sorted(ct) == sorted(cj) == ["c", "conv", "m", "n"]
    for key in cj:
        assert ct[key].shape == cj[key].shape
        _close(ct[key], cj[key])
    for _ in range(5):
        xt = rng.standard_normal((2, 1, d)).astype(np.float32)
        yj, cj = jxl.mlstm_decode(jp, jspec, jnp.asarray(xt), cj)
        yt, ct2 = txl.mlstm_decode(tp, tspec, torch.from_numpy(xt), ct)
        assert ct2 is ct, "the decode step updates the cache in place"
        _close(yt, yj)
        for key in cj:
            _close(ct[key], cj[key])


def test_chunkwise_mlstm_matches_full_and_feeds_decode():
    """test_chunked_exec.py's chunkwise mLSTM tests on the port, at their
    shapes: chunked == quadratic (output and state), and a chunkwise prefill
    state continues through decode as the full forward does."""
    b, s, d = 2, 128, 32
    spec = XLSTMSpec(n_heads=2, proj_factor=2.0, conv_width=4)
    p = txl.init_mlstm(torch.Generator().manual_seed(8), spec, d, torch.float32)
    x = torch.randn(b, s + 1, d, generator=torch.Generator().manual_seed(9))
    with runtime(mlstm_chunk=0):
        y_full = txl.mlstm_full(p, spec, x)
        _, cache_full = txl.mlstm_prefill(p, spec, x[:, :s])
    with runtime(mlstm_chunk=16):
        y_chunk = txl.mlstm_full(p, spec, x[:, :s])
        _, cache_chunk = txl.mlstm_prefill(p, spec, x[:, :s])
        _close(y_chunk, y_full[:, :s].numpy())
        for key in ("c", "n", "m"):
            _close(cache_chunk[key], cache_full[key].numpy())
        y_dec, _ = txl.mlstm_decode(p, spec, x[:, s:], cache_chunk)
    _close(y_dec[:, 0], y_full[:, -1].numpy(), 1e-4)


def test_mlstm_chunkwise_stays_finite_at_s1024(xl):
    """S 1024 in chunks of 64 with head 0's input-gate bias at 100: e^100 is
    past fp32's range (e^88.7), so only the running maxima of the log gates
    keep the state finite. The port's carried state (C, n, m) is the
    reference's to ``TOL``. The outputs divide by |q·n|, which cancellation
    makes small on a few rows (up to |y| ~ 300 here), so they are held to
    2e-4 of their largest magnitude (measured: 9e-5)."""
    jspec, tspec, d, (jp, tp), _ = xl
    bias = np.array([100.0, 0.0], np.float32)
    jp = dict(jp, b_i=jnp.asarray(bias))
    tp = dict(tp, b_i=torch.from_numpy(bias))
    x = _x((1, 1024, d), 3)
    with runtime(mlstm_chunk=64):
        yj, cj = jxl.mlstm_prefill(jp, jspec, jnp.asarray(x))
        yt, ct = txl.mlstm_prefill(tp, tspec, torch.from_numpy(x))
    assert float(cj["m"].max()) > 88.7
    for key in ("c", "n", "m"):
        assert torch.isfinite(ct[key]).all()
        _close(ct[key], cj[key])
    assert torch.isfinite(yt).all()
    scale = float(np.abs(np.asarray(yj)).max())
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                               atol=2e-4 * scale)


def test_slstm_matches_reference(xl):
    """The full pass, the prefill state and 5 decode steps that update the
    state ({"c", "n", "h", "m"}) in place."""
    jspec, tspec, d, _, (jp, tp) = xl
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 12, d)).astype(np.float32)
    _close(txl.slstm_full(tp, tspec, torch.from_numpy(x)),
           jxl.slstm_full(jp, jspec, jnp.asarray(x)))
    yj, cj = jxl.slstm_prefill(jp, jspec, jnp.asarray(x))
    yt, ct = txl.slstm_prefill(tp, tspec, torch.from_numpy(x))
    _close(yt, yj)
    assert sorted(ct) == sorted(cj) == ["c", "h", "m", "n"]
    for key in cj:
        _close(ct[key], cj[key])
    for _ in range(5):
        xt = rng.standard_normal((2, 1, d)).astype(np.float32)
        yj, cj = jxl.slstm_decode(jp, jspec, jnp.asarray(xt), cj)
        yt, ct2 = txl.slstm_decode(tp, tspec, torch.from_numpy(xt), ct)
        assert ct2 is ct
        _close(yt, yj)
        for key in cj:
            _close(ct[key], cj[key])


def test_slstm_state_tensors_are_distinct():
    """Decode writes each state tensor in place, so none may alias another
    (the reference's init shares one zeros array between c and h)."""
    st = txl.init_slstm_state(XLSTMSpec(n_heads=2), 32, 2, "cpu")
    ptrs = [t.data_ptr() for t in st.values()]
    assert len(set(ptrs)) == 4
