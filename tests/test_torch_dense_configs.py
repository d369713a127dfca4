"""The port's dense decoders other than gemma3-1b against the reference, on
CPU: phi3-mini (MHA, head_dim 96 at full width), qwen3-32b (GQA, qk_norm)
and starcoder2-3b (GQA, LayerNorm, GeLU, tied embeddings).

Each runs ``reduce_for_smoke`` (2 layers, d 32, heads 2/2, head_dim 16,
vocab 256) in fp32 with ``remat=False``. The reference's params are carried
across with ``params_from_numpy``, so both packages run the same weights on
the same numpy tokens: the full forward, then a prefill and 4 teacher-forced
decode steps, at ``test_torch_lm.py``'s fp32 logit tolerance."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro import configs as jconfigs
from repro.models import decoder_lm as jdlm
from repro_torch import configs as tconfigs
from repro_torch.models import decoder_lm as tdlm

ARCHS = ["phi3-mini-3.8b", "qwen3-32b", "starcoder2-3b"]
LOGIT_TOL = 1e-4   # tests/test_torch_lm.py::LOGIT_TOL["float32"]
N_DECODE = 4


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    reduce = lambda pkg: dataclasses.replace(
        pkg.reduce_for_smoke(pkg.get_config(request.param)), remat=False,
        dtype="float32")
    jcfg, tcfg = reduce(jconfigs), reduce(tconfigs)
    assert tcfg.family == "dense"
    jp = jax.jit(lambda key: jdlm.init_params(jcfg, key))(jax.random.PRNGKey(0))
    tp = tdlm.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def test_forward_logits_match_reference(model):
    jcfg, tcfg, jp, tp = model
    tokens = np.random.default_rng(5).integers(0, tcfg.vocab_size, (2, 9),
                                                dtype=np.int32)
    lj, _, _ = jdlm.forward(jp, jcfg, tokens=jnp.asarray(tokens))
    lt, _, _ = tdlm.forward(tp, tcfg, tokens=torch.from_numpy(tokens))
    _close(lt, lj)


def test_prefill_and_decode_logits_match_reference(model):
    jcfg, tcfg, jp, tp = model
    b, s = 2, 10
    tokens = np.random.default_rng(6).integers(
        0, tcfg.vocab_size, (b, s + N_DECODE), dtype=np.int32)
    max_len = s + N_DECODE
    lj, cj = jdlm.prefill(jp, jcfg, tokens=jnp.asarray(tokens[:, :s]),
                          max_len=max_len)
    lt, ct = tdlm.prefill(tp, tcfg, tokens=torch.from_numpy(tokens[:, :s]),
                          max_len=max_len)
    assert lt.shape == (b, 1, tcfg.vocab_size)
    _close(lt, lj)
    j_decode = jax.jit(lambda p, t, pos, c: jdlm.decode_step(p, jcfg, t, pos, c))
    for i in range(N_DECODE):   # teacher-forced: the same tokens on both
        tok = tokens[:, s + i:s + i + 1]
        lj, cj = j_decode(jp, jnp.asarray(tok), jnp.int32(s + i), cj)
        lt, ct = tdlm.decode_step(tp, tcfg, torch.from_numpy(tok), s + i, ct)
        _close(lt, lj)
