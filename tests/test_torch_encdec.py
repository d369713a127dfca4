"""The port's encoder-decoder (whisper-small) against the reference, on CPU.

``reduce_for_smoke(whisper-small)`` with ``remat=False``: 2 encoder and 2
decoder layers, d 32, 2 heads of 16 (MHA), vocab 256, 8 encoder frames,
layernorm and gelu, fp32 (and a bf16 prefill and decode). The reference's
params come over through ``params_from_numpy``, so both packages run the
same weights on the same numpy frames and tokens. Where ``use_flash`` is
set, the reference runs its Pallas kernels in interpret mode and the port
its kernels' plain versions: the decoder's causal self-attention and its
decode steps; the non-causal encoder and the cross-attention stay plain in
both. Compared at ``LOGIT_TOL`` (fp32 1e-4, bf16 2e-2:
``tests/test_torch_lm.py``); ``serve_batch``'s tokens exactly."""
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
from repro.models import encdec as jencdec
from repro_torch import configs as tconfigs
from repro_torch.data import synthetic as tsynth
from repro_torch.launch import serve as tserve
from repro_torch.models import decoder_lm as tdlm
from repro_torch.models import encdec as tencdec
from repro_torch.models import registry as tregistry
from repro_torch.training import train_step as ttrain_step

from _torch_parity import runtime

ARCH = "whisper-small"
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
        jp = jax.jit(lambda key: jencdec.init_params(jcfg, key))(
            jax.random.PRNGKey(0))
        tp = tdlm.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        out[dtype] = (jcfg, tcfg, jp, tp)
    return out


def _close(got, want, tol=LOGIT_TOL["float32"]):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _inputs(cfg, seed, s=16, dtype=np.float32):
    """make_batch's frames (in ``dtype``) and tokens, identical in both
    packages (tests/test_torch_lm.py holds the batches bit for bit)."""
    batch = tsynth.make_batch(cfg, tsynth.SyntheticConfig(2, s, seed=seed), 0)
    return batch["frames"].astype(dtype), batch["tokens"], batch


def test_get_api_serves_the_audio_family(models):
    _, tcfg, _, _ = models["float32"]
    api = tregistry.get_api(tcfg)
    assert (api.init_params, api.prefill, api.decode_step, api.init_caches) == (
        tencdec.init_params, tencdec.prefill, tencdec.decode_step, None)
    assert tcfg.family == "audio" and not tcfg.encoder_segments[0].layers[0].attn.causal


def test_init_keeps_the_reference_tree():
    """bf16 (the config's dtype): the same leaves, shapes and dtypes, and
    the same parameter count; the three parts are drawn apart."""
    jcfg, tcfg = _cfgs("bfloat16")
    jshapes = jax.eval_shape(lambda key: jencdec.init_params(jcfg, key),
                             jax.random.PRNGKey(0))
    tp = tencdec.init_params(tcfg, seed=0, device="cpu")
    assert sorted(tp) == sorted(jshapes) == [
        "cross", "embed", "enc_norm", "enc_segments", "final_norm", "segments"]
    want = [(tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(jshapes)]
    got = [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for x in jax.tree.leaves(tp)]
    assert got == want
    assert tdlm.param_count(tp) == sum(int(np.prod(s)) for s, _ in want)
    enc_q = tp["enc_segments"][0][0]["attn"]["wq"]
    dec_q = tp["segments"][0][0]["attn"]["wq"]
    cross_q = tp["cross"][0][0]["attn"]["wq"]
    assert not torch.equal(enc_q, dec_q) and not torch.equal(dec_q, cross_q)


def test_encode_matches_reference(models):
    jcfg, tcfg, jp, tp = models["float32"]
    frames, _, _ = _inputs(tcfg, 1)
    want = jax.jit(lambda p, f: jencdec.encode(p, jcfg, f))(jp, jnp.asarray(frames))
    got = tencdec.encode(tp, tcfg, torch.from_numpy(frames))
    assert got.shape == (2, tcfg.encoder_max_len, tcfg.d_model)
    _close(got, want)


def test_cross_kv_matches_reference(models):
    """Per decoder layer (stacked over the segment's 2 blocks): K and V of
    the encoder's output, (count, B, T, KV, D)."""
    jcfg, tcfg, jp, tp = models["float32"]
    frames, _, _ = _inputs(tcfg, 2)
    enc = jencdec.encode(jp, jcfg, jnp.asarray(frames))
    want = jencdec._cross_kv(jp, jcfg, enc)
    got = tencdec._cross_kv(tp, tcfg, torch.from_numpy(np.array(enc)))
    jl, tl = jax.tree.leaves(want), jax.tree.leaves(got)
    assert len(tl) == len(jl) == 2 * tcfg.n_layers // tcfg.segments[0].count
    for g, w in zip(tl, jl):
        assert tuple(g.shape) == tuple(w.shape) == (2, 2, 8, 2, 16)
        _close(g, w)


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_logits_match_reference(models, dtype, flash):
    """A 10-token prefill over the encoder's frames (in the config's
    dtype), then 4 teacher-forced decode steps, pos alternately an int and
    the 0-d int32 tensor a captured step reads. The cross K/V are the
    prefill's, read and never written; the self caches update in place."""
    jcfg, tcfg, jp, tp = models[dtype]
    tol = LOGIT_TOL[dtype]
    b, s = 2, 10
    frames, tokens, _ = _inputs(tcfg, 3, s + N_DECODE)
    jframes = jnp.asarray(frames).astype(jnp.dtype(dtype))
    tframes = torch.from_numpy(frames).to(getattr(torch, dtype))
    max_len = s + N_DECODE
    with runtime(use_flash=flash):
        # fresh closures: jit traces under this test's use_flash
        j_prefill = jax.jit(lambda p, f, t: jencdec.prefill(p, jcfg, f, t,
                                                            max_len=max_len))
        j_decode = jax.jit(lambda p, t, pos, c: jencdec.decode_step(
            p, jcfg, t, pos, c))
        lj, cj = j_prefill(jp, jframes, jnp.asarray(tokens[:, :s]))
        lt, ct = tencdec.prefill(tp, tcfg, tframes,
                                 torch.from_numpy(tokens[:, :s]), max_len=max_len)
        assert lt.shape == (b, 1, tcfg.vocab_size) and lt.dtype == torch.float32
        _close(lt, lj, tol)
        assert sorted(ct) == ["cross", "self"]
        assert [tuple(x.shape) for x in jax.tree.leaves(ct)] == \
            [tuple(x.shape) for x in jax.tree.leaves(cj)]
        cross = [x.clone() for x in jax.tree.leaves(ct["cross"])]
        for i in range(N_DECODE):
            tok = tokens[:, s + i:s + i + 1]
            pos = s + i if i % 2 else torch.tensor(s + i, dtype=torch.int32)
            lj, cj = j_decode(jp, jnp.asarray(tok), jnp.int32(s + i), cj)
            lt, ct2 = tencdec.decode_step(tp, tcfg, torch.from_numpy(tok), pos, ct)
            assert ct2 is ct
            _close(lt, lj, tol)
        if dtype == "float32":
            # in bf16 an entry one rounding apart upstream lands an ulp or
            # two of bf16 away (0.016 each at magnitude 2): the logits are
            # the comparison there, as in tests/test_torch_lm.py
            for got, want in zip(jax.tree.leaves(ct), jax.tree.leaves(cj)):
                _close(got, want, tol)
    assert all(torch.equal(a, b) for a, b in
               zip(cross, jax.tree.leaves(ct["cross"])))


def test_loss_and_metrics_match_reference(models):
    jcfg, tcfg, jp, tp = models["float32"]
    _, _, batch = _inputs(tcfg, 4)
    _, mj = jax.jit(lambda p, bt: jencdec.loss_and_metrics(p, jcfg, bt))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    _, mt = tencdec.loss_and_metrics(
        tp, tcfg, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert sorted(mt) == sorted(mj) == ["aux", "ce", "loss"]
    for key in ("ce", "aux", "loss"):
        _close(mt[key], mj[key])
    assert float(mt["aux"]) == 0.0


@pytest.mark.parametrize("policy", ["", "nothing", "outputs"])
def test_loss_gradients_match_reference(models, policy):
    """The gradient of the loss with respect to every param; the port with
    remat off, or on under each policy (the encoder's and decoder's stacked
    blocks under ``torch.utils.checkpoint``), against the reference without
    remat: remat changes memory, not values. ``use_flash`` off, as in
    tests/test_torch_train_step.py."""
    jcfg, tcfg, jp, tp = models["float32"]
    _, _, batch = _inputs(tcfg, 5)
    gj = jax.jit(jax.grad(lambda p: jencdec.loss_and_metrics(
        p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})[0]))(jp)
    cfg = dataclasses.replace(tcfg, remat=bool(policy))
    with runtime(remat_policy=policy):
        params = jax.tree.map(lambda t: t.detach().requires_grad_(True), tp)
        loss, _ = tencdec.loss_and_metrics(
            params, cfg, {k: torch.as_tensor(v) for k, v in batch.items()})
        gt = torch.autograd.grad(loss, jax.tree.leaves(params))
    assert len(gt) == len(jax.tree.leaves(gj))
    for got, want in zip(gt, jax.tree.leaves(gj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


@pytest.mark.parametrize("flash", [False, True])
def test_serve_batch_generates_the_reference_tokens(models, flash):
    """2 x 16 prompt tokens over 8 frames, 8 generated, greedy: make_prefill's
    frames branch and the {"self", "cross"} caches through the decode loop."""
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
    np.testing.assert_array_equal(tgen, np.asarray(jgen))


def test_make_prefill_passes_the_frames(models):
    _, tcfg, _, tp = models["float32"]
    frames, tokens, batch = _inputs(tcfg, 7)
    inputs = ttrain_step.device_batch(tcfg, batch, "cpu")
    assert inputs["frames"].dtype == torch.float32
    last, caches = ttrain_step.make_prefill(tcfg)(tp, inputs, 20)
    want, _ = tencdec.prefill(tp, tcfg, torch.from_numpy(frames),
                              torch.from_numpy(tokens), max_len=20)
    assert torch.equal(last, want)
    assert caches["self"][0][0]["k"].shape[2] == 20


def test_decode_graph_warmup_copies_only_the_written_caches(models):
    """The warm-up step before a capture runs on copies of the self caches
    and on the prefill's own cross K/V, which no step writes."""
    _, tcfg, _, tp = models["float32"]
    frames, tokens, _ = _inputs(tcfg, 8)
    _, caches = tencdec.prefill(tp, tcfg, torch.from_numpy(frames),
                                torch.from_numpy(tokens), max_len=20)
    scratch = tserve._warmup_caches(caches)
    assert scratch["cross"] is caches["cross"]
    for a, b in zip(jax.tree.leaves(scratch["self"]),
                    jax.tree.leaves(caches["self"])):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
