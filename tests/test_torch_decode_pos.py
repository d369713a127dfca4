"""The decode step with ``pos`` as a 0-d int32 tensor, on CPU.

The port's decode path takes ``pos`` as an int or as a 0-d int32 tensor on
the step's device, as the reference's jitted ``serve_step`` takes a traced
scalar; with a tensor nothing syncs with the host, so the step can be
captured in a CUDA graph. Here, on ``reduce_for_smoke(gemma3-1b)`` (14
layers, window-8 rings and full caches): the tensor path gives the int
path's outputs and caches bit for bit, and the int path gives the bits of
the plain int form of the step (slice writes at an int slot), across the
ring's wrap, with ``use_flash`` on and off; both match the reference's
``decode_step`` fed ``jnp.int32(pos)`` at the tolerances of
``tests/test_torch_lm.py``."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import decoder_lm as jdlm
from repro.training import train_step as jtrain_step
from repro_torch import configs as tconfigs
from repro_torch.kernels.decode_attention import ops as tdec_ops
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import decoder_lm as tdlm
from repro_torch.training import train_step as ttrain_step

ARCH = "gemma3-1b"
ATTN_TOL = 2e-4     # tests/test_torch_lm.py
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
WINDOW_LAYER = {"window8": 0, "global": 5}


@contextlib.contextmanager
def _use_flash(on: bool):
    old = (jcommon.RUNTIME["use_flash"], tcommon.RUNTIME["use_flash"])
    jcommon.RUNTIME["use_flash"] = tcommon.RUNTIME["use_flash"] = on
    try:
        yield
    finally:
        jcommon.RUNTIME["use_flash"], tcommon.RUNTIME["use_flash"] = old


def _tpos(pos: int) -> torch.Tensor:
    return torch.tensor(pos, dtype=torch.int32)


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return [_clone(v) for v in tree]


def _assert_same_bits(a, b):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_same_bits(a[k], b[k])
    else:
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same_bits(x, y)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def models():
    out = {}
    for dtype in ("float32", "bfloat16"):
        j = dataclasses.replace(
            jconfigs.reduce_for_smoke(jconfigs.get_config(ARCH)), remat=False,
            dtype=dtype)
        t = dataclasses.replace(
            tconfigs.reduce_for_smoke(tconfigs.get_config(ARCH)), remat=False,
            dtype=dtype)
        jp = jax.jit(lambda key: jdlm.init_params(j, key))(jax.random.PRNGKey(0))
        tp = tdlm.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        out[dtype] = (j, t, jp, tp)
    return out


def _attn_decode_int(p, spec, x, pos: int, cache):
    """attn_decode for an int pos alone: slice writes at a Python-int slot.
    The port's int path must give its bits."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = tattn._project_qkv(p, spec, x, positions)
    t = cache["k"].shape[1]
    slot = pos if spec.window is None else pos % t
    cache["k"][:, slot] = k_new[:, 0]
    cache["v"][:, slot] = v_new[:, 0]
    if spec.window is None:
        valid = torch.arange(t, device=x.device) <= pos
    else:
        cache["slot_pos"][slot] = pos
        slot_pos = cache["slot_pos"]
        valid = (slot_pos >= 0) & (slot_pos <= pos) & (slot_pos > pos - spec.window)
    if tcommon.RUNTIME["use_flash"]:
        out = tdec_ops.decode_attention(q, cache["k"], cache["v"], valid)
    else:
        out = tattn._gqa_attend(q, cache["k"], cache["v"], valid[None, None, :])
    return out.reshape(b, 1, -1) @ p["wo"], cache


def _layer(models, which):
    jcfg, tcfg, jp, tp = models["float32"]
    i = WINDOW_LAYER[which]
    pj = jax.tree.map(lambda a: a[0], jp["segments"][0][i]["attn"])
    pt = {k: (v[0] if isinstance(v, torch.Tensor) else
              {kk: vv[0] for kk, vv in v.items()})
          for k, v in tp["segments"][0][i]["attn"].items()}
    return (jcfg.segments[0].layers[i].attn, tcfg.segments[0].layers[i].attn,
            pj, pt)


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("which", sorted(WINDOW_LAYER))
def test_attn_decode_tensor_pos_is_bit_identical_to_int_pos(models, which, flash):
    """Prefill 12 tokens into max_len 20, then 8 steps: the window-8 ring
    has wrapped at prefill and wraps again while decoding."""
    spec_j, spec_t, pj, pt = _layer(models, which)
    rng = np.random.default_rng(2)
    s, max_len = 12, 20
    x = torch.from_numpy(rng.standard_normal((2, s, 32)).astype(np.float32))
    pos = torch.arange(s, dtype=torch.int32)[None].expand(2, s)
    with _use_flash(flash):
        _, cache_int = tattn.attn_prefill(pt, spec_t, x, pos, max_len)
        cache_t, cache_before = _clone(cache_int), _clone(cache_int)
        cache_j = {k: jnp.asarray(v.numpy()) for k, v in cache_int.items()}
        for step in range(max_len - s):
            xt = rng.standard_normal((2, 1, 32)).astype(np.float32)
            y_before, _ = _attn_decode_int(pt, spec_t, torch.from_numpy(xt),
                                           s + step, cache_before)
            y_int, _ = tattn.attn_decode(pt, spec_t, torch.from_numpy(xt), s + step,
                                         cache_int)
            y_t, c2 = tattn.attn_decode(pt, spec_t, torch.from_numpy(xt),
                                        _tpos(s + step), cache_t)
            assert c2 is cache_t, "the decode step updates the cache in place"
            _assert_same_bits(y_int, y_before)
            _assert_same_bits(cache_int, cache_before)
            _assert_same_bits(y_t, y_int)
            _assert_same_bits(cache_t, cache_int)
            y_j, cache_j = jattn.attn_decode(pj, spec_j, jnp.asarray(xt),
                                             jnp.int32(s + step), cache_j)
            _close(y_t, y_j, ATTN_TOL)
            for key in cache_j:
                _close(cache_t[key], cache_j[key], ATTN_TOL)
    if spec_t.window is not None:
        assert sorted(cache_t["slot_pos"].tolist()) == list(range(12, 20))


N_DECODE = 12


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_tensor_pos_matches_int_pos_and_reference(models, dtype, flash):
    """Teacher-forced: prefill 10 tokens, then 12 steps (the rings wrap)
    with the same tokens on the int path, the tensor path and the
    reference's jitted decode_step fed jnp.int32(pos)."""
    jcfg, tcfg, jp, tp = models[dtype]
    rng = np.random.default_rng(3)
    b, s = 2, 10
    tokens = rng.integers(0, tcfg.vocab_size, (b, s + N_DECODE), dtype=np.int32)
    max_len = s + N_DECODE
    with _use_flash(flash):
        j_prefill = jax.jit(lambda p, t: jdlm.prefill(p, jcfg, tokens=t,
                                                      max_len=max_len))
        j_decode = jax.jit(lambda p, t, pos, c: jdlm.decode_step(p, jcfg, t, pos, c))
        _, cj = j_prefill(jp, jnp.asarray(tokens[:, :s]))
        _, c_int = tdlm.prefill(tp, tcfg, tokens=torch.from_numpy(tokens[:, :s]),
                                max_len=max_len)
        c_t = _clone(c_int)
        for i in range(N_DECODE):
            tok = tokens[:, s + i:s + i + 1]
            l_int, c_int = tdlm.decode_step(tp, tcfg, torch.from_numpy(tok), s + i,
                                            c_int)
            l_t, c_t = tdlm.decode_step(tp, tcfg, torch.from_numpy(tok),
                                        _tpos(s + i), c_t)
            _assert_same_bits(l_t, l_int)
            _assert_same_bits(c_t, c_int)
            l_j, cj = j_decode(jp, jnp.asarray(tok), jnp.int32(s + i), cj)
            _close(l_t, l_j, LOGIT_TOL[dtype])


@pytest.mark.parametrize("flash", [False, True])
def test_serve_step_with_tensor_pos_generates_the_reference_tokens(models, flash):
    """Greedy: make_decode_step's serve_step fed a tensor pos gives the int
    path's tokens and caches bit for bit and the reference serve_step's
    tokens."""
    jcfg, tcfg, jp, tp = models["float32"]
    rng = np.random.default_rng(4)
    b, s, steps = 2, 9, 11
    prompt = rng.integers(0, tcfg.vocab_size, (b, s), dtype=np.int32)
    max_len = s + steps + 1
    with _use_flash(flash):
        j_step = jax.jit(jtrain_step.make_decode_step(jcfg))
        t_step = ttrain_step.make_decode_step(tcfg)
        lj, cj = jax.jit(lambda p, t: jdlm.prefill(p, jcfg, tokens=t,
                                                   max_len=max_len))(
            jp, jnp.asarray(prompt))
        lt, c_int = tdlm.prefill(tp, tcfg, tokens=torch.from_numpy(prompt),
                                 max_len=max_len)
        tok_j = jnp.argmax(lj[:, -1], axis=-1).astype(jnp.int32)[:, None]
        tok_int = torch.argmax(lt[:, -1], dim=-1).to(torch.int32)[:, None]
        np.testing.assert_array_equal(tok_int.numpy(), np.asarray(tok_j))
        c_t, tok_t = _clone(c_int), tok_int.clone()
        for i in range(steps):
            tok_int, c_int = t_step(tp, tok_int, s + i, c_int)
            tok_t, c_t = t_step(tp, tok_t, _tpos(s + i), c_t)
            tok_j, cj = j_step(jp, tok_j, jnp.int32(s + i), cj)
            assert tok_t.dtype == torch.int32 and tok_t.shape == (b, 1)
            _assert_same_bits(tok_t, tok_int)
            _assert_same_bits(c_t, c_int)
            np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
