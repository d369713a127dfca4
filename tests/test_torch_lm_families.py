"""The four decoder families this slice adds against the reference, on CPU:
olmoe-1b-7b (attention + MoE on every layer), deepseek-v2-236b (MLA, a
dense layer 0, then MoE with a shared expert), jamba-1.5-large-398b (7
Mamba + 1 attention a block, MoE on every other layer) and xlstm-125m
(mLSTM + sLSTM).

Each runs ``reduce_for_smoke`` (d 32, vocab 256, 4 experts top-2, at most 2
blocks a segment) in fp32 with ``remat=False``; the reference's params are
carried across with ``params_from_numpy``, so both packages run the same
weights on the same numpy tokens. MoE routing is compared first and
exactly: every MoE call's ``gate_idx`` (the reference's, read inside its
jitted scan by an ordered ``jax.debug.callback``), then the values at
``LOGIT_TOL``. jamba's attention layer runs through the kernels (the
reference's Pallas kernels in interpret mode, the port's plain versions),
as ``test_torch_lm.py`` does; its Mamba scans sum in another order than the
reference's, which ``LOGIT_TOL`` covers (``test_torch_ssm.py``)."""
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
from repro.models import decoder_lm as jdlm
from repro.models import mlp as jmlp
from repro_torch import configs as tconfigs
from repro_torch.data import synthetic as tsynth
from repro_torch.launch import serve as tserve
from repro_torch.models import common as tcommon
from repro_torch.models import decoder_lm as tdlm
from repro_torch.models import mlp as tmlp

from _torch_parity import runtime

FAMILIES = ["olmoe-1b-7b", "deepseek-v2-236b", "jamba-1.5-large-398b",
            "xlstm-125m"]
LOGIT_TOL = 1e-4   # tests/test_torch_lm.py::LOGIT_TOL["float32"]
GRAD_TOL = 1e-4
N_DECODE = 4


@pytest.fixture(scope="module", params=FAMILIES)
def model(request):
    reduce = lambda pkg: dataclasses.replace(
        pkg.reduce_for_smoke(pkg.get_config(request.param)), remat=False,
        dtype="float32")
    jcfg, tcfg = reduce(jconfigs), reduce(tconfigs)
    jp = jax.jit(lambda key: jdlm.init_params(jcfg, key))(jax.random.PRNGKey(0))
    tp = tdlm.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _flash(cfg):
    """jamba's attention through the kernels in both packages."""
    return runtime(use_flash=cfg.family == "hybrid")


@pytest.fixture
def ref_routing(monkeypatch):
    """Every reference ``moe`` call's gate_idx (B, S, k), in call order."""
    rec = []
    orig = jmlp.moe

    def spy(p, spec, x, act, seq_chunk=0, decode=False):
        probs = jax.nn.softmax(x.astype(jnp.float32) @ p["router"], axis=-1)
        jax.debug.callback(lambda g: rec.append(np.asarray(g)),
                           jax.lax.top_k(probs, spec.top_k)[1], ordered=True)
        return orig(p, spec, x, act, seq_chunk=seq_chunk, decode=decode)

    monkeypatch.setattr(jmlp, "moe", spy)
    return rec


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


def _same_routing(port_rec, ref_rec):
    jax.effects_barrier()
    assert len(port_rec) == len(ref_rec)
    for i, ((gate_idx, keep, _), want) in enumerate(zip(port_rec, ref_rec)):
        np.testing.assert_array_equal(gate_idx.numpy(), want,
                                      err_msg=f"moe call {i}")
        assert bool(keep.all())   # n <= 256 tokens: no dropping


def _n_moe_layers(cfg):
    return sum(seg.count * sum(l.mlp == "moe" for l in seg.layers)
               for seg in cfg.segments)


def test_init_keeps_the_reference_tree(model):
    """bf16 (the configs' dtype): the same leaves, shapes and dtypes, and
    the same parameter count."""
    jcfg, tcfg, _, _ = model
    jcfg, tcfg = (dataclasses.replace(c, dtype="bfloat16") for c in (jcfg, tcfg))
    jshapes = jax.eval_shape(lambda key: jdlm.init_params(jcfg, key),
                             jax.random.PRNGKey(0))
    tp = tdlm.init_params(tcfg, seed=0, device="cpu")
    want = [(tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(jshapes)]
    got = [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for x in jax.tree.leaves(tp)]
    assert got == want
    assert tdlm.param_count(tp) == sum(int(np.prod(s)) for s, _ in want)


def test_forward_logits_and_aux_match_reference(model, ref_routing):
    jcfg, tcfg, jp, tp = model
    tokens = np.random.default_rng(4).integers(0, 256, (2, 16), dtype=np.int32)
    with _flash(tcfg):
        lj, auxj, _ = jax.jit(lambda p, t: jdlm.forward(p, jcfg, tokens=t))(
            jp, jnp.asarray(tokens))
        with tmlp.record_routing() as rec:
            lt, auxt, _ = tdlm.forward(tp, tcfg, tokens=torch.from_numpy(tokens))
    assert len(rec) == _n_moe_layers(tcfg)
    _same_routing(rec, ref_routing)
    _close(lt, lj)
    _close(auxt, auxj)
    assert (float(auxt) > 0) == (_n_moe_layers(tcfg) > 0)


def test_prefill_and_decode_logits_match_reference(model, ref_routing):
    """A 10-token prefill and 4 teacher-forced decode steps, pos alternately
    an int and the 0-d int32 tensor a captured step reads; each step updates
    the caches in place."""
    jcfg, tcfg, jp, tp = model
    b, s = 2, 10
    tokens = np.random.default_rng(6).integers(0, 256, (b, s + N_DECODE),
                                               dtype=np.int32)
    max_len = s + N_DECODE
    with _flash(tcfg), tmlp.record_routing() as rec:
        j_prefill = jax.jit(lambda p, t: jdlm.prefill(p, jcfg, tokens=t,
                                                      max_len=max_len))
        j_decode = jax.jit(lambda p, t, pos, c: jdlm.decode_step(p, jcfg, t,
                                                                 pos, c))
        lj, cj = j_prefill(jp, jnp.asarray(tokens[:, :s]))
        lt, ct = tdlm.prefill(tp, tcfg, tokens=torch.from_numpy(tokens[:, :s]),
                              max_len=max_len)
        assert lt.shape == (b, 1, tcfg.vocab_size)
        _close(lt, lj)
        assert [tuple(x.shape) for x in jax.tree.leaves(ct)] == \
            [tuple(x.shape) for x in jax.tree.leaves(cj)]
        for i in range(N_DECODE):
            tok = tokens[:, s + i:s + i + 1]
            pos = s + i if i % 2 else torch.tensor(s + i, dtype=torch.int32)
            lj, cj = j_decode(jp, jnp.asarray(tok), jnp.int32(s + i), cj)
            lt, ct2 = tdlm.decode_step(tp, tcfg, torch.from_numpy(tok), pos, ct)
            assert ct2 is ct
            _close(lt, lj)
        for got, want in zip(jax.tree.leaves(ct), jax.tree.leaves(cj)):
            _close(got, want)
    assert len(rec) == _n_moe_layers(tcfg) * (1 + N_DECODE)
    _same_routing(rec, ref_routing)


def test_loss_and_metrics_match_reference(model):
    """The training objective: ce and the MoE aux term separately, and
    loss = ce + aux."""
    jcfg, tcfg, jp, tp = model
    batch = tsynth.make_batch(tcfg, tsynth.SyntheticConfig(2, 16, seed=1), 0)
    _, mj = jax.jit(lambda p, bt: jdlm.loss_and_metrics(p, jcfg, bt))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    _, mt = tdlm.loss_and_metrics(
        tp, tcfg, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert sorted(mt) == sorted(mj) == ["aux", "ce", "loss"]
    for key in ("ce", "aux", "loss"):
        _close(mt[key], mj[key])
    assert float(mt["loss"]) == pytest.approx(float(mt["ce"] + mt["aux"]))
    assert (float(mt["aux"]) > 0) == (_n_moe_layers(tcfg) > 0)


def test_loss_gradients_match_reference(model):
    """The gradient of the training loss (ce + aux) with respect to every
    param, remat on in both packages (the reference's ``jax.checkpoint`` of
    each block, the port's ``torch.utils.checkpoint``; the MoE's chunks and
    the Mamba and mLSTM chunk loops run under their own checkpoints inside
    it when their knobs are set, here at the CPU training knobs' chunk of
    8). ``use_flash`` stays off: ``jax.grad`` through the reference's Pallas
    kernel fails on the installed jax (see test_torch_train_step.py). At
    ``GRAD_TOL``: gradients are sums over every position and layer."""
    jcfg, tcfg, jp, tp = model
    jcfg, tcfg = (dataclasses.replace(c, remat=True, moe_seq_chunk=8)
                  for c in (jcfg, tcfg))
    batch = tsynth.make_batch(tcfg, tsynth.SyntheticConfig(2, 16, seed=2), 0)
    with runtime(ssm_chunk=8, mlstm_chunk=8):
        # a fresh closure, traced here under the knobs
        gj = jax.jit(jax.grad(lambda p: jdlm.loss_and_metrics(
            p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})[0]))(jp)
        params = jax.tree.map(lambda t: t.detach().requires_grad_(True), tp)
        loss, _ = tdlm.loss_and_metrics(
            params, tcfg, {k: torch.as_tensor(v) for k, v in batch.items()})
        gt = torch.autograd.grad(loss, jax.tree.leaves(params))
    assert len(gt) == len(jax.tree.leaves(gj))
    for got, want in zip(gt, jax.tree.leaves(gj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


def test_serve_batch_generates_the_reference_tokens(model):
    """2 x 16 prompt tokens, 8 generated, greedy."""
    jcfg, tcfg, jp, tp = model
    jbatch = jsynth.make_batch(jcfg, jsynth.SyntheticConfig(2, 16, seed=3), 0)
    tbatch = tsynth.make_batch(tcfg, tsynth.SyntheticConfig(2, 16, seed=3), 0)
    with _flash(tcfg):
        jgen, _ = jserve.serve_batch(
            jcfg, jp, {k: jnp.asarray(v) for k, v in jbatch.items()}, 8,
            log=lambda *_: None)
        tgen, tstats = tserve.serve_batch(tcfg, tp, tbatch, 8,
                                          log=lambda *_: None)
    assert tgen.shape == (2, 8) and tstats["backend"] == "cpu"
    np.testing.assert_array_equal(tgen, np.asarray(jgen))


@pytest.mark.parametrize("seq_len,want", [
    (1024, {"q_chunk": 256, "ssm_chunk": 256, "mlstm_chunk": 256}),
    (512, {"q_chunk": 0, "ssm_chunk": 0, "mlstm_chunk": 0})])
def test_train_loop_sets_the_reference_cpu_knobs(monkeypatch, seq_len, want):
    """Off the card, sequences longer than 512 train with the chunked forms
    (the reference's ``launch/train.py:54-56``); the loop restores the
    knobs when it returns."""
    from repro_torch.launch import train as ttrain
    seen = {}

    def make_step(cfg, opt_cfg, api):
        def step(state, batch):
            seen.update({k: tcommon.RUNTIME[k] for k in want})
            return state, {"loss": torch.zeros(()), "lr": torch.zeros(()),
                           "grad_norm": torch.zeros(())}
        return step

    monkeypatch.setattr(ttrain, "make_train_step", make_step)
    before = dict(tcommon.RUNTIME)
    cfg = tconfigs.reduce_for_smoke(tconfigs.get_config("xlstm-125m"))
    ttrain.train_loop(cfg, 1, 1, seq_len, device="cpu", log=lambda *_: None)
    assert seen == want
    assert tcommon.RUNTIME == before
