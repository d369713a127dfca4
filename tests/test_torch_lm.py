"""The port's serving path of gemma3-1b against the reference, on CPU.

``reduce_for_smoke(gemma3-1b)`` with ``remat=False``: 14 layers (2 x (5
local + 1 global) + 2 local), d 32, heads 2/1, head_dim 16, window 8, vocab
256, fp32 (and a bf16 case). The reference's params are carried across with
``params_from_numpy``, so both packages run the same weights on the same
numpy inputs. Where ``use_flash`` is set, the reference runs its Pallas
kernels in interpret mode and the port its kernels' plain versions; each
test restores the flag in ``try/finally``."""
import contextlib
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
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import decoder_lm as jdlm
from repro.training import train_step as jtrain_step
from repro_torch import configs as tconfigs
from repro_torch.data import synthetic as tsynth
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import decoder_lm as tdlm
from repro_torch.models import registry as tregistry
from repro_torch.training import train_step as ttrain_step

ARCH = "gemma3-1b"
ATTN_TOL = 2e-4     # tests/test_kernels.py::test_flash_matches_model_attention
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _cfgs(dtype="float32"):
    j = dataclasses.replace(jconfigs.reduce_for_smoke(jconfigs.get_config(ARCH)),
                            remat=False, dtype=dtype)
    t = dataclasses.replace(tconfigs.reduce_for_smoke(tconfigs.get_config(ARCH)),
                            remat=False, dtype=dtype)
    return j, t


@contextlib.contextmanager
def _runtime(**flags):
    """Set RUNTIME knobs on both packages for the block, then restore."""
    old = ({k: jcommon.RUNTIME[k] for k in flags},
           {k: tcommon.RUNTIME[k] for k in flags})
    jcommon.RUNTIME.update(flags)
    tcommon.RUNTIME.update(flags)
    try:
        yield
    finally:
        jcommon.RUNTIME.update(old[0])
        tcommon.RUNTIME.update(old[1])


def _use_flash(on: bool):
    return _runtime(use_flash=on)


def _close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.fixture(scope="module")
def models():
    out = {}
    for dtype in ("float32", "bfloat16"):
        jcfg, tcfg = _cfgs(dtype)
        jp = jax.jit(lambda key: jdlm.init_params(jcfg, key))(
            jax.random.PRNGKey(0))
        tp = tdlm.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        out[dtype] = (jcfg, tcfg, jp, tp)
    return out


# -- configs, data, registry ---------------------------------------------------
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_configs_match_reference(arch):
    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(tconfigs.reduce_for_smoke(t)) == \
        dataclasses.asdict(jconfigs.reduce_for_smoke(j))
    assert t.n_layers == j.n_layers


@pytest.mark.parametrize("arch", ["gemma3-1b", "whisper-small", "internvl2-1b"])
def test_synthetic_batches_are_bit_identical(arch):
    j = jconfigs.reduce_for_smoke(jconfigs.get_config(arch))
    t = tconfigs.reduce_for_smoke(tconfigs.get_config(arch))
    for step in (0, 3):
        jb = jsynth.make_batch(j, jsynth.SyntheticConfig(4, 16, seed=7), step)
        tb = tsynth.make_batch(t, tsynth.SyntheticConfig(4, 16, seed=7), step)
        assert sorted(jb) == sorted(tb)
        for key in jb:
            assert jb[key].dtype == tb[key].dtype
            np.testing.assert_array_equal(tb[key], jb[key])


def test_unported_families_and_layers_raise():
    """No family is left unported: every config of ``configs.ARCHS`` builds
    through ``get_api`` (whisper-small through ``encdec``, internvl2-1b
    through ``vlm``; both held to the reference in test_torch_encdec.py and
    test_torch_vlm.py) and covers every layer kind. What still raises is a
    layer kind no config has."""
    kinds = set()
    families = {}
    for arch in tconfigs.ARCHS:
        cfg = tconfigs.reduce_for_smoke(tconfigs.get_config(arch))
        api = tregistry.get_api(cfg)
        params = api.init_params(cfg, device="cpu")
        assert tdlm.param_count(params) > 0, arch
        families[cfg.family] = api.init_params.__module__
        kinds |= {(l.kind, l.mlp) for l in cfg.layer_list()}
    assert families["audio"] == "repro_torch.models.encdec"
    assert families["vlm"] == "repro_torch.models.vlm"
    assert {k for k, _ in kinds} == {"attn", "mla", "mamba", "mlstm", "slstm"}
    assert {m for _, m in kinds} == {"dense", "moe", "none"}
    cfg = tconfigs.reduce_for_smoke(tconfigs.get_config(ARCH))
    layer = dataclasses.replace(cfg.segments[0].layers[0], kind="rwkv")
    with pytest.raises(ValueError, match="rwkv"):
        tdlm.init_layer(torch.Generator().manual_seed(0), layer, cfg)


def test_init_keeps_the_reference_tree(models):
    jcfg, tcfg, jp, _ = models["bfloat16"]
    tp = tdlm.init_params(tcfg, seed=0, device="cpu")
    shapes = lambda tree: [(tuple(x.shape), str(x.dtype)) for x in
                           jax.tree.leaves(tree)]
    assert shapes(tdlm.params_to_numpy(tp)) == [
        (s, "float32") for s, _ in shapes(jax.tree.map(np.asarray, jp))]
    assert [str(x.dtype) for x in jax.tree.leaves(tp)] == [
        str(x.dtype).replace("bfloat16", "torch.bfloat16").replace(
            "float32", "torch.float32") for x in jax.tree.leaves(jp)]
    assert tdlm.param_count(tp) == jdlm.param_count(jp)
    embed = tp["embed"].float()
    assert abs(embed.std().item() - 0.02 * 0.88) < 2e-3   # truncated at 2 sd
    assert embed.abs().max().item() <= 0.04 + 1e-3


def test_serve_caches_keep_the_reference_layout(models):
    """Stacked (count, ...) caches for the 2 x 6 segment, plain ones for the
    remainder; zeros, and slot_pos -1 on the window-8 rings."""
    jcfg, tcfg, _, _ = models["bfloat16"]
    jc = jtrain_step.init_serve_caches(jcfg, 2, 20)
    tc = ttrain_step.init_serve_caches(tcfg, 2, 20, device="cpu")
    jl, tl = jax.tree.leaves(jc), jax.tree.leaves(tc)
    assert [tuple(x.shape) for x in tl] == [tuple(x.shape) for x in jl]
    for j, t in zip(jl, tl):
        assert str(t.dtype).endswith(str(j.dtype))
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(j, np.float32))


def test_params_from_numpy_is_exact_for_bf16(models):
    _, _, jp, tp = models["bfloat16"]
    for jl, tl in zip(jax.tree.leaves(jp), jax.tree.leaves(tp)):
        assert str(tl.dtype).endswith(str(jl.dtype))
        np.testing.assert_array_equal(tl.float().numpy(),
                                      np.asarray(jl, np.float32))


# -- primitives ----------------------------------------------------------------
def test_norm_rope_and_mask_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    for kind in ("rmsnorm", "layernorm"):
        jp = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
        tp = {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}
        _close(tcommon.apply_norm(tp, torch.from_numpy(x), kind),
               jcommon.apply_norm(jp, jnp.asarray(x), kind), 1e-6)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32)[None] + 100, (2, 7))
    for theta in (1e4, 1e6):
        _close(tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                                  theta),
               jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta), 1e-6)
    for window in (None, 3):
        got = tcommon.causal_mask(torch.from_numpy(pos.copy()),
                                  torch.from_numpy(pos.copy()), window)
        want = jcommon.causal_mask(jnp.asarray(pos), jnp.asarray(pos), window)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for kind in ("gelu", "silu"):
        _close(tcommon.activate(torch.from_numpy(x), kind),
               jcommon.activate(jnp.asarray(x), kind), 1e-6)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.uniform(size=(2, 5)) < 0.7).astype(np.float32)
    for m in (None, mask):
        got = tcommon.cross_entropy(torch.from_numpy(logits),
                                    torch.from_numpy(labels),
                                    None if m is None else torch.from_numpy(m))
        want = jcommon.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                     None if m is None else jnp.asarray(m))
        _close(got, want, 1e-6)


# -- attention -----------------------------------------------------------------
def _attn_case(models, layer_idx):
    """Layer 0 (local, window 8) or 5 (global) of the first segment."""
    jcfg, tcfg, jp, tp = models["float32"]
    spec_j = jcfg.segments[0].layers[layer_idx].attn
    spec_t = tcfg.segments[0].layers[layer_idx].attn
    pj = jax.tree.map(lambda a: a[0], jp["segments"][0][layer_idx]["attn"])
    pt = {k: (v[0] if isinstance(v, torch.Tensor) else
              {kk: vv[0] for kk, vv in v.items()})
          for k, v in tp["segments"][0][layer_idx]["attn"].items()}
    return spec_j, spec_t, pj, pt


WINDOW_LAYER = {"window8": 0, "global": 5}


ATTN_PATHS = {"einsum": {}, "flash": {"use_flash": True},
              "q_chunk": {"q_chunk": 4}}


@pytest.mark.parametrize("path", sorted(ATTN_PATHS))
@pytest.mark.parametrize("which", sorted(WINDOW_LAYER))
def test_attn_full_matches_reference(models, which, path):
    spec_j, spec_t, pj, pt = _attn_case(models, WINDOW_LAYER[which])
    assert spec_t.window == (8 if which == "window8" else None)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 20, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(20, dtype=np.int32)[None], (2, 20)).copy()
    with _runtime(**ATTN_PATHS[path]):
        want = jattn.attn_full(pj, spec_j, jnp.asarray(x), jnp.asarray(pos))
        got = tattn.attn_full(pt, spec_t, torch.from_numpy(x),
                              torch.from_numpy(pos))
    _close(got, want, ATTN_TOL)


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("which", sorted(WINDOW_LAYER))
def test_attn_prefill_and_decode_match_reference(models, which, flash):
    """Prefill 12 tokens into a cache of max_len 20, then decode 8 more: the
    ring (window 8) wraps at prefill already and again while decoding."""
    spec_j, spec_t, pj, pt = _attn_case(models, WINDOW_LAYER[which])
    rng = np.random.default_rng(2)
    s, max_len = 12, 20
    x = rng.standard_normal((2, s, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (2, s)).copy()
    with _use_flash(flash):
        yj, cj = jattn.attn_prefill(pj, spec_j, jnp.asarray(x),
                                    jnp.asarray(pos), max_len)
        yt, ct = tattn.attn_prefill(pt, spec_t, torch.from_numpy(x),
                                    torch.from_numpy(pos), max_len)
        _close(yt, yj, ATTN_TOL)
        assert sorted(ct) == sorted(cj)
        for key in cj:
            _close(ct[key], cj[key], ATTN_TOL)
        for step in range(max_len - s):
            xt = rng.standard_normal((2, 1, 32)).astype(np.float32)
            yj, cj = jattn.attn_decode(pj, spec_j, jnp.asarray(xt),
                                       jnp.int32(s + step), cj)
            yt, ct2 = tattn.attn_decode(pt, spec_t, torch.from_numpy(xt),
                                        s + step, ct)
            assert ct2 is ct, "the decode step updates the cache in place"
            _close(yt, yj, ATTN_TOL)
            for key in cj:
                _close(ct[key], cj[key], ATTN_TOL)
    if spec_t.window is not None:
        assert sorted(ct["slot_pos"].tolist()) == list(range(12, 20))


# -- the whole model -----------------------------------------------------------
N_DECODE = 12


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_logits_match_reference(models, dtype, flash):
    jcfg, tcfg, jp, tp = models[dtype]
    rng = np.random.default_rng(3)
    b, s = 2, 10
    tokens = rng.integers(0, tcfg.vocab_size, (b, s + N_DECODE), dtype=np.int32)
    max_len = s + N_DECODE
    tol = LOGIT_TOL[dtype]
    with _use_flash(flash):
        # fresh closures: jit traces under this test's use_flash
        j_prefill = jax.jit(lambda p, t: jdlm.prefill(p, jcfg, tokens=t,
                                                      max_len=max_len))
        j_decode = jax.jit(lambda p, t, pos, c: jdlm.decode_step(p, jcfg, t,
                                                                 pos, c))
        lj, cj = j_prefill(jp, jnp.asarray(tokens[:, :s]))
        lt, ct = tdlm.prefill(tp, tcfg, tokens=torch.from_numpy(tokens[:, :s]),
                              max_len=max_len)
        assert lt.shape == (b, 1, tcfg.vocab_size) and lt.dtype == torch.float32
        _close(lt, lj, tol)
        for i in range(N_DECODE):   # teacher-forced: the same tokens on both
            tok = tokens[:, s + i:s + i + 1]
            lj, cj = j_decode(jp, jnp.asarray(tok), jnp.int32(s + i), cj)
            lt, ct = tdlm.decode_step(tp, tcfg, torch.from_numpy(tok), s + i, ct)
            _close(lt, lj, tol)


def test_forward_logits_match_reference(models):
    jcfg, tcfg, jp, tp = models["float32"]
    tokens = np.random.default_rng(4).integers(0, 256, (2, 9), dtype=np.int32)
    lj, _, _ = jdlm.forward(jp, jcfg, tokens=jnp.asarray(tokens))
    lt, _, _ = tdlm.forward(tp, tcfg, tokens=torch.from_numpy(tokens))
    _close(lt, lj, LOGIT_TOL["float32"])


@pytest.mark.parametrize("flash", [False, True])
def test_serve_batch_generates_the_reference_tokens(models, flash):
    """2 x 16 prompt tokens, 12 generated: the window-8 rings wrap. An argmax
    flip at a near-tie would be a tolerance artifact; the assertion reports
    the two top logits where the tokens differ."""
    jcfg, tcfg, jp, tp = models["float32"]
    jbatch = jsynth.make_batch(jcfg, jsynth.SyntheticConfig(2, 16, seed=3), 0)
    tbatch = tsynth.make_batch(tcfg, tsynth.SyntheticConfig(2, 16, seed=3), 0)
    with _use_flash(flash):
        jgen, jstats = jserve.serve_batch(
            jcfg, jp, {k: jnp.asarray(v) for k, v in jbatch.items()}, 12,
            log=lambda *_: None)
        tgen, tstats = tserve.serve_batch(tcfg, tp, tbatch, 12,
                                          log=lambda *_: None)
    assert tgen.shape == (2, 12) and tgen.dtype == np.int32
    # the reference's keys plus the capture time of the graphed decode step,
    # 0 on the CPU, where the steps run eagerly
    assert sorted(tstats) == sorted([*jstats, "decode_capture_s"])
    assert tstats["backend"] == "cpu" and tstats["decode_capture_s"] == 0.0
    np.testing.assert_array_equal(tgen, np.asarray(jgen))
