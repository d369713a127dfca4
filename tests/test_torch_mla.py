"""The port's MLA (DeepSeek-V2 attention) against the reference, on CPU, fp32.

``reduce_for_smoke(deepseek-v2-236b)``'s MLA (2 heads, q and kv LoRA rank 16,
nope 8, rope 8, v 8; d 32), the reference's ``init_mla`` params carried
across through numpy: the full forward, its q-chunked form, the prefill
that fills the compressed cache, and decode steps in the plain and the
absorbed matmul order, with ``pos`` as an int and as the 0-d int32 tensor a
captured decode step reads."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro_torch import configs as tconfigs
from repro_torch._tree import tensor_from_numpy
from repro_torch.configs.base import MLASpec
from repro_torch.models import attention as tattn

from _torch_parity import runtime

# plain fp32 einsums in both packages: tests/test_kernels.py's fp32 tolerance
TOL = 2e-5


@pytest.fixture(scope="module")
def mla():
    arch = "deepseek-v2-236b"
    jcfg = jconfigs.reduce_for_smoke(jconfigs.get_config(arch))
    jspec = jcfg.segments[0].layers[0].mla
    tspec = tconfigs.reduce_for_smoke(tconfigs.get_config(arch)) \
        .segments[0].layers[0].mla
    assert dataclasses.asdict(jspec) == dataclasses.asdict(tspec)
    jp = jattn.init_mla(jax.random.PRNGKey(0), jspec, jcfg.d_model, jnp.float32)
    tp = jax.tree.map(lambda a: tensor_from_numpy(np.asarray(a), "cpu"), jp)
    return jspec, tspec, jp, tp, jcfg.d_model


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _pos(b, s):
    return np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s)).copy()


@pytest.mark.parametrize("q_chunk", [0, 4])
def test_mla_full_matches_reference(mla, q_chunk):
    jspec, tspec, jp, tp, d = mla
    x = np.random.default_rng(1).standard_normal((2, 16, d)).astype(np.float32)
    with runtime(q_chunk=q_chunk):
        want = jattn.mla_full(jp, jspec, jnp.asarray(x), jnp.asarray(_pos(2, 16)))
        got = tattn.mla_full(tp, tspec, torch.from_numpy(x),
                             torch.from_numpy(_pos(2, 16)))
    _close(got, want)


def test_chunked_mla_matches_full():
    """test_chunked_exec.py::test_chunked_mla_matches_full on the port, at
    its shapes and tolerance."""
    b, s, d = 2, 96, 64
    spec = MLASpec(n_heads=4, q_lora_rank=16, kv_lora_rank=16, qk_nope_dim=8,
                   qk_rope_dim=8, v_head_dim=8)
    p = tattn.init_mla(torch.Generator().manual_seed(4), spec, d, torch.float32)
    x = torch.randn(b, s, d, generator=torch.Generator().manual_seed(5))
    pos = torch.from_numpy(_pos(b, s))
    with runtime(q_chunk=0):
        y_full = tattn.mla_full(p, spec, x, pos)
    with runtime(q_chunk=32):
        y_chunk = tattn.mla_full(p, spec, x, pos)
    _close(y_chunk, y_full.numpy())


@pytest.mark.parametrize("tensor_pos", [False, True])
@pytest.mark.parametrize("absorb", [False, True])
def test_mla_prefill_and_decode_match_reference(mla, absorb, tensor_pos):
    """Prefill 10 tokens into a cache of 16, then 6 decode steps: outputs
    and the compressed cache ({"ckv", "k_rope"}) after every step, which the
    port writes in place."""
    jspec, tspec, jp, tp, d = mla
    rng = np.random.default_rng(2)
    s, max_len = 10, 16
    x = rng.standard_normal((2, s, d)).astype(np.float32)
    yj, cj = jattn.mla_prefill(jp, jspec, jnp.asarray(x), jnp.asarray(_pos(2, s)),
                               max_len)
    yt, ct = tattn.mla_prefill(tp, tspec, torch.from_numpy(x),
                               torch.from_numpy(_pos(2, s)), max_len)
    _close(yt, yj)
    assert sorted(ct) == sorted(cj) == ["ckv", "k_rope"]
    for key in cj:
        assert ct[key].shape == cj[key].shape
        _close(ct[key], cj[key])
    for step in range(max_len - s):
        xt = rng.standard_normal((2, 1, d)).astype(np.float32)
        pos = s + step
        yj, cj = jattn.mla_decode(jp, jspec, jnp.asarray(xt), jnp.int32(pos), cj,
                                  absorb=absorb)
        tpos = torch.tensor(pos, dtype=torch.int32) if tensor_pos else pos
        yt, ct2 = tattn.mla_decode(tp, tspec, torch.from_numpy(xt), tpos, ct,
                                   absorb=absorb)
        assert ct2 is ct, "the decode step updates the cache in place"
        _close(yt, yj)
        for key in cj:
            _close(ct[key], cj[key])


def test_mla_decode_orders_agree(mla):
    """The absorbed order is a regrouping of the plain one's products."""
    _, tspec, _, tp, d = mla
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 8, d)).astype(np.float32))
    _, cache = tattn.mla_prefill(tp, tspec, x, torch.from_numpy(_pos(2, 8)), 12)
    caches = [{k: v.clone() for k, v in cache.items()} for _ in range(2)]
    for step in range(4):
        xt = torch.from_numpy(rng.standard_normal((2, 1, d)).astype(np.float32))
        ys = [tattn.mla_decode(tp, tspec, xt, 8 + step, c, absorb=a)[0]
              for c, a in zip(caches, (False, True))]
        _close(ys[1], ys[0].numpy())
