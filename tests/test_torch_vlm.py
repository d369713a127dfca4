"""The port's VLM (internvl2-1b) against the reference, on CPU.

``reduce_for_smoke(internvl2-1b)`` with ``remat=False``: 2 layers, d 32, 2
heads of 16 over 2 kv heads, vocab 256, 8 patches of width 48 through the
gelu projector, rmsnorm and silu, fp32 (and a bf16 prefill and decode). The
reference's params come over through ``params_from_numpy``, so both
packages run the same weights on the same numpy patches and tokens. The
patches take positions 0 .. 7, so the text starts at position 8 and every
decode step sits ``n_patches`` past its token's index. Where ``use_flash``
is set, the reference runs its Pallas kernels in interpret mode and the
port its kernels' plain versions. Compared at ``LOGIT_TOL`` (fp32 1e-4,
bf16 2e-2: ``tests/test_torch_lm.py``); ``serve_batch``'s tokens exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro import configs as jconfigs
from repro.data import synthetic as jsynth
from repro.launch import serve as jserve
from repro.models import vlm as jvlm
from repro_torch import configs as tconfigs
from repro_torch.data import synthetic as tsynth
from repro_torch.launch import serve as tserve
from repro_torch.models import decoder_lm as tdlm
from repro_torch.models import registry as tregistry
from repro_torch.models import vlm as tvlm
from repro_torch.training import train_step as ttrain_step

from _torch_parity import runtime

ARCH = "internvl2-1b"
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
GRAD_TOL = 1e-4
N_DECODE = 4


def _cfgs(dtype="float32"):
    reduce = lambda pkg: dataclasses.replace(
        pkg.reduce_for_smoke(pkg.get_config(ARCH)), remat=False, dtype=dtype)
    return reduce(jconfigs), reduce(tconfigs)


@pytest.fixture(scope="module")
def models():
    out = {}
    for dtype in ("float32", "bfloat16"):
        jcfg, tcfg = _cfgs(dtype)
        jp = jax.jit(lambda key: jvlm.init_params(jcfg, key))(
            jax.random.PRNGKey(0))
        tp = tdlm.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        out[dtype] = (jcfg, tcfg, jp, tp)
    return out


def _close(got, want, tol=LOGIT_TOL["float32"]):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _inputs(cfg, seed, s=16, dtype=np.float32):
    """make_batch's patches (in ``dtype``) and tokens, identical in both
    packages (tests/test_torch_lm.py holds the batches bit for bit)."""
    batch = tsynth.make_batch(cfg, tsynth.SyntheticConfig(2, s, seed=seed), 0)
    return batch["patches"].astype(dtype), batch["tokens"], batch


def test_get_api_serves_the_vlm_family(models):
    _, tcfg, _, _ = models["float32"]
    api = tregistry.get_api(tcfg)
    assert (api.init_params, api.prefill, api.decode_step, api.init_caches) == (
        tvlm.init_params, tvlm.prefill, tdlm.decode_step, tdlm.init_caches)
    assert (tcfg.family, tcfg.n_patches, tcfg.vit_dim) == ("vlm", 8, 48)


def test_init_keeps_the_reference_tree():
    """bf16 (the config's dtype): the same leaves, shapes and dtypes, and
    the same parameter count."""
    jcfg, tcfg = _cfgs("bfloat16")
    jshapes = jax.eval_shape(lambda key: jvlm.init_params(jcfg, key),
                             jax.random.PRNGKey(0))
    tp = tvlm.init_params(tcfg, seed=0, device="cpu")
    assert sorted(tp) == sorted(jshapes) == [
        "embed", "final_norm", "projector", "segments"]
    want = [(tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(jshapes)]
    got = [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for x in jax.tree.leaves(tp)]
    assert got == want
    assert tdlm.param_count(tp) == sum(int(np.prod(s)) for s, _ in want)
    assert tuple(tp["projector"]["w1"].shape) == (48, 32)


def test_embed_multimodal_matches_reference(models):
    """The projector (tanh gelu between the two matmuls) ahead of the text
    embeddings: (B, P + S, d)."""
    jcfg, tcfg, jp, tp = models["float32"]
    patches, tokens, _ = _inputs(tcfg, 1)
    want = jvlm._embed_multimodal(jp, jcfg, jnp.asarray(patches),
                                  jnp.asarray(tokens))
    got = tvlm._embed_multimodal(tp, tcfg, torch.from_numpy(patches),
                                 torch.from_numpy(tokens))
    assert got.shape == (2, 8 + 16, 32)
    _close(got, want, 1e-6)
    assert torch.equal(got[:, 8:], tp["embed"][torch.from_numpy(tokens).long()])


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_logits_match_reference(models, dtype, flash):
    """8 patches and a 10-token prefill into caches of max_len 8 + 14, then
    4 teacher-forced decode steps at positions 8 + 10 + i, pos alternately
    an int and the 0-d int32 tensor a captured step reads."""
    jcfg, tcfg, jp, tp = models[dtype]
    tol = LOGIT_TOL[dtype]
    b, s, p = 2, 10, tcfg.n_patches
    patches, tokens, _ = _inputs(tcfg, 3, s + N_DECODE)
    jpatches = jnp.asarray(patches).astype(jnp.dtype(dtype))
    tpatches = torch.from_numpy(patches).to(getattr(torch, dtype))
    max_len = p + s + N_DECODE
    with runtime(use_flash=flash):
        # fresh closures: jit traces under this test's use_flash
        j_prefill = jax.jit(lambda pr, x, t: jvlm.prefill(pr, jcfg, x, t,
                                                          max_len=max_len))
        j_decode = jax.jit(lambda pr, t, pos, c: jvlm.decode_step(
            pr, jcfg, t, pos, c))
        lj, cj = j_prefill(jp, jpatches, jnp.asarray(tokens[:, :s]))
        lt, ct = tvlm.prefill(tp, tcfg, tpatches, torch.from_numpy(tokens[:, :s]),
                              max_len=max_len)
        assert lt.shape == (b, 1, tcfg.vocab_size) and lt.dtype == torch.float32
        _close(lt, lj, tol)
        assert [tuple(x.shape) for x in jax.tree.leaves(ct)] == \
            [tuple(x.shape) for x in jax.tree.leaves(cj)]
        for i in range(N_DECODE):
            tok = tokens[:, s + i:s + i + 1]
            at = p + s + i
            pos = at if i % 2 else torch.tensor(at, dtype=torch.int32)
            lj, cj = j_decode(jp, jnp.asarray(tok), jnp.int32(at), cj)
            lt, ct2 = tvlm.decode_step(tp, tcfg, torch.from_numpy(tok), pos, ct)
            assert ct2 is ct
            _close(lt, lj, tol)
        if dtype == "float32":
            # in bf16 an entry one rounding apart upstream lands an ulp or
            # two of bf16 away (0.016 each at magnitude 2): the logits are
            # the comparison there, as in tests/test_torch_lm.py
            for got, want in zip(jax.tree.leaves(ct), jax.tree.leaves(cj)):
                _close(got, want, tol)


def test_loss_and_metrics_match_reference(models):
    """The loss on text positions only: the patches' logits are dropped."""
    jcfg, tcfg, jp, tp = models["float32"]
    _, _, batch = _inputs(tcfg, 4)
    _, mj = jax.jit(lambda pr, bt: jvlm.loss_and_metrics(pr, jcfg, bt))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    _, mt = tvlm.loss_and_metrics(
        tp, tcfg, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert sorted(mt) == sorted(mj) == ["aux", "ce", "loss"]
    for key in ("ce", "aux", "loss"):
        _close(mt[key], mj[key])


@pytest.mark.parametrize("policy", ["", "nothing", "outputs"])
def test_loss_gradients_match_reference(models, policy):
    """The gradient of the loss with respect to every param, the projector
    included; the port with remat off or on under each policy, against the
    reference without remat (remat changes memory, not values)."""
    jcfg, tcfg, jp, tp = models["float32"]
    _, _, batch = _inputs(tcfg, 5)
    gj = jax.jit(jax.grad(lambda pr: jvlm.loss_and_metrics(
        pr, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})[0]))(jp)
    cfg = dataclasses.replace(tcfg, remat=bool(policy))
    with runtime(remat_policy=policy):
        params = jax.tree.map(lambda t: t.detach().requires_grad_(True), tp)
        loss, _ = tvlm.loss_and_metrics(
            params, cfg, {k: torch.as_tensor(v) for k, v in batch.items()})
        gt = torch.autograd.grad(loss, jax.tree.leaves(params))
    assert len(gt) == len(jax.tree.leaves(gj))
    for got, want in zip(gt, jax.tree.leaves(gj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


@pytest.mark.parametrize("flash", [False, True])
def test_serve_batch_generates_the_reference_tokens(models, flash):
    """2 x 16 prompt tokens after 8 patches, 8 generated, greedy: the
    patches' offset in the cache length and in every decode position."""
    jcfg, tcfg, jp, tp = models["float32"]
    jbatch = jsynth.make_batch(jcfg, jsynth.SyntheticConfig(2, 16, seed=6), 0)
    tbatch = tsynth.make_batch(tcfg, tsynth.SyntheticConfig(2, 16, seed=6), 0)
    with runtime(use_flash=flash):
        jgen, jstats = jserve.serve_batch(
            jcfg, jp, {k: jnp.asarray(v) for k, v in jbatch.items()}, 8,
            log=lambda *_: None)
        tgen, tstats = tserve.serve_batch(tcfg, tp, tbatch, 8,
                                          log=lambda *_: None)
    assert tgen.shape == (2, 8) and tstats["backend"] == "cpu"
    assert sorted(tstats) == sorted([*jstats, "decode_capture_s"])
    assert tstats["prompt_tokens"] == jstats["prompt_tokens"] == 16
    np.testing.assert_array_equal(tgen, np.asarray(jgen))


def test_serve_batch_decodes_past_the_patches(models, monkeypatch):
    """The cache holds n_patches + S + gen positions and the decode steps
    run at n_patches + S + i."""
    _, tcfg, _, tp = models["float32"]
    batch = tsynth.make_batch(tcfg, tsynth.SyntheticConfig(2, 16, seed=7), 0)
    seen = []
    real = tdlm.decode_step

    def spy(params, cfg, token, pos, caches):
        seen.append((int(pos), caches[0][0]["k"].shape[2]))
        return real(params, cfg, token, pos, caches)

    monkeypatch.setattr(tvlm, "decode_step", spy)
    tserve.serve_batch(tcfg, tp, batch, 5, log=lambda *_: None)
    assert seen == [(8 + 16 + i, 8 + 16 + 5) for i in range(4)]


def test_device_batch_casts_the_patches_to_the_activation_dtype(models):
    """make_batch gives float32 patches; the model functions take them in
    the config's dtype, as the reference's input specs declare them."""
    _, tcfg, _, tp = models["bfloat16"]
    _, _, batch = _inputs(tcfg, 8)
    inputs = ttrain_step.device_batch(tcfg, batch, "cpu")
    assert inputs["patches"].dtype == torch.bfloat16
    assert inputs["tokens"].dtype == torch.int32
    with torch.no_grad():
        last, _ = ttrain_step.make_prefill(tcfg)(tp, inputs, 30)
    assert last.shape == (2, 1, 256) and bool(torch.isfinite(last).all())
