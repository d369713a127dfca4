"""The port's training step of gemma3-1b against the reference, on CPU.

``reduce_for_smoke(gemma3-1b)`` in fp32 with remat on (14 layers, d 32,
heads 2/1, head_dim 16, window 8, vocab 256, ``ce_chunk`` 512). The
reference's initial params come over through numpy, and both packages take
three AdamW steps on the same ``SyntheticLM`` batches: the reference under
``jax.jit(make_train_step(...))``, the port eagerly. The reference runs with
``use_flash`` off: ``jax.grad`` through its Pallas kernel fails on the
installed jax (``_pallas_call_jvp_rule``), and the gradient of the kernel's
function is that of its plain oracle ``attention_ref``. The port runs with
``use_flash`` on (its flash function on CPU tensors: the plain version and
its autograd) and off.

Tolerances: metrics (loss, ce, aux, grad_norm, lr) at 1e-5, the fp32 model
tolerance of ``tests/test_kernels.py``. Params at atol 5e-5 + rtol 1e-4:
AdamW moves each param by about lr x m / (sqrt(v) + eps), which is O(lr) =
1e-3 whatever the gradient's size, so where a gradient is near eps (1e-8)
a float-noise difference between two sum orders moves the param by far
more than the gradient's own relative error (the largest difference over
these cases is 2.6e-5, in a few elements of thousands). 5e-5 is 5% of one
step's move; a wrong gradient moves params by up to 2 lr.
"""
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
from repro.kernels.flash_attention import ref as jflash_ref
from repro.models import common as jcommon
from repro.models import decoder_lm as jdlm
from repro.training import optimizer as jopt
from repro.training import train_step as jtrain_step
from repro_torch import configs as tconfigs
from repro_torch.data import synthetic as tsynth
from repro_torch.kernels.flash_attention import kernel as tflash_kernel
from repro_torch.kernels.flash_attention import ops as tflash_ops
from repro_torch.kernels.flash_attention import ref as tflash_ref
from repro_torch.models import common as tcommon
from repro_torch.models import decoder_lm as tdlm
from repro_torch.training import optimizer as topt
from repro_torch.training import train_step as ttrain_step

ARCH = "gemma3-1b"
TOL = 1e-5                    # tests/test_kernels.py: fp32 model tolerance
PARAM_ATOL, PARAM_RTOL = 5e-5, 1e-4   # see the module docstring
OPT = dict(learning_rate=1e-3, warmup_steps=1, total_steps=3)
STEPS = 3
BATCH = {1024: 1, 64: 2}      # S 1024 takes the chunked CE, S 64 the full one


def _cfgs():
    j = jconfigs.reduce_for_smoke(jconfigs.get_config(ARCH))
    t = tconfigs.reduce_for_smoke(tconfigs.get_config(ARCH))
    assert j.remat and t.remat and j.ce_chunk == t.ce_chunk == 512
    return j, t


@contextlib.contextmanager
def _runtime(module, **flags):
    old = {k: module.RUNTIME[k] for k in flags}
    module.RUNTIME.update(flags)
    try:
        yield
    finally:
        module.RUNTIME.update(old)


@pytest.fixture(scope="module")
def init():
    jcfg, tcfg = _cfgs()
    jp = jax.jit(lambda key: jdlm.init_params(jcfg, key))(jax.random.PRNGKey(0))
    return jcfg, tcfg, jax.tree.map(np.asarray, jp)


def _batch(cfg, synth, seq, step):
    return synth.make_batch(cfg, synth.SyntheticConfig(BATCH[seq], seq, seed=0),
                            step)


_REFERENCE: dict = {}


def _reference_run(jcfg, jp, seq, policy):
    """The reference's jitted trajectory: per step (metrics, params)."""
    if (seq, policy) not in _REFERENCE:
        opt = jopt.AdamWConfig(**OPT)
        params = jax.tree.map(jnp.asarray, jp)
        state = jtrain_step.TrainState(params=params, opt=jopt.adamw_init(params))
        out = []
        with _runtime(jcommon, remat_policy=policy, use_flash=False):
            step = jax.jit(jtrain_step.make_train_step(jcfg, opt))
            for i in range(STEPS):
                b = _batch(jcfg, jsynth, seq, i)
                state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
                out.append(({k: float(v) for k, v in m.items()},
                            jax.tree.map(np.asarray, state.params)))
        _REFERENCE[(seq, policy)] = out
    return _REFERENCE[(seq, policy)]


def _port_run(tcfg, jp, seq, policy, flash):
    opt = topt.AdamWConfig(**OPT)
    params = tdlm.params_from_numpy(jp, device="cpu")
    state = ttrain_step.TrainState(params=params, opt=topt.adamw_init(params))
    step = ttrain_step.make_train_step(tcfg, opt)
    out = []
    with _runtime(tcommon, remat_policy=policy, use_flash=flash):
        for i in range(STEPS):
            b = _batch(tcfg, tsynth, seq, i)
            state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
            out.append(({k: float(v) for k, v in m.items()},
                        tdlm.params_to_numpy(state.params)))
    return out


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "plain"])
@pytest.mark.parametrize("policy", ["nothing", "outputs"])
@pytest.mark.parametrize("seq", [1024, 64], ids=["chunked_ce", "full_ce"])
def test_train_step_matches_reference(init, seq, policy, flash):
    jcfg, tcfg, jp = init
    want = _reference_run(jcfg, jp, seq, policy)
    got = _port_run(tcfg, jp, seq, policy, flash)
    for i, ((gm, gp), (wm, wp)) in enumerate(zip(got, want)):
        assert sorted(gm) == sorted(wm) == ["aux", "ce", "grad_norm", "loss", "lr"]
        for k in wm:
            np.testing.assert_allclose(gm[k], wm[k], rtol=TOL, atol=TOL,
                                       err_msg=f"{k} after step {i}")
        for g, w in zip(jax.tree.leaves(gp), jax.tree.leaves(wp)):
            np.testing.assert_allclose(g, np.asarray(w, np.float32),
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=f"params after step {i}")
    # the steps moved the params
    assert np.abs(got[-1][1]["embed"] - jp["embed"]).max() > 1e-4


def test_eval_step_matches_reference(init):
    jcfg, tcfg, jp = init
    params = tdlm.params_from_numpy(jp, device="cpu")
    for seq in (64, 1024):
        b = _batch(jcfg, jsynth, seq, 5)
        want = jax.jit(jtrain_step.make_eval_step(jcfg))(
            jax.tree.map(jnp.asarray, jp), {k: jnp.asarray(v) for k, v in b.items()})
        got = ttrain_step.make_eval_step(tcfg)(
            params, {k: torch.from_numpy(v) for k, v in b.items()})
        assert sorted(got) == sorted(want) == ["aux", "ce", "loss"]
        for k in want:
            assert not got[k].requires_grad
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=TOL,
                                       atol=TOL, err_msg=f"{k} at S {seq}")


@pytest.mark.parametrize("policy,seq,want", [
    # "nothing": one checkpoint per block (2 stacked blocks + the 2-layer
    # segment); "outputs": one per attention and per MLP branch (14 x 2);
    # the chunked CE adds one per chunk (1024 / 512)
    ("nothing", 64, 3), ("outputs", 64, 28), ("nothing", 1024, 5),
    ("outputs", 1024, 30)])
def test_remat_wraps_what_the_reference_rematerializes(init, monkeypatch,
                                                       policy, seq, want):
    _, tcfg, jp = init
    calls = []
    real = tdlm.checkpoint
    monkeypatch.setattr(tdlm, "checkpoint",
                        lambda fn, *a, **kw: calls.append(fn) or real(fn, *a, **kw))
    params = tdlm.params_from_numpy(jp, device="cpu")
    b = _batch(tcfg, tsynth, seq, 0)
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    with _runtime(tcommon, remat_policy=policy):
        loss, _ = tdlm.loss_and_metrics(params, tcfg, batch)
        assert len(calls) == want
        with torch.no_grad():     # no backward follows: nothing to remat
            tdlm.loss_and_metrics(params, tcfg, batch)
        assert len(calls) == want
        no_remat = dataclasses.replace(tcfg, remat=False)
        loss_plain, _ = tdlm.loss_and_metrics(params, no_remat, batch)
    # without remat only the CE chunks keep their checkpoints, as in the
    # reference's _chunked_ce
    assert len(calls) == want + (seq // 512 if seq > 512 else 0)
    assert torch.equal(loss, loss_plain)


# -- the flash gradient ---------------------------------------------------------
GRAD_CASES = [
    # (B, S, H, KV, D, causal, window)
    (2, 24, 4, 2, 16, True, 5),
    (1, 33, 8, 1, 32, True, None),
    (2, 20, 4, 4, 16, True, 64),
    (1, 17, 2, 1, 16, False, None),
    (1, 1, 4, 1, 16, True, None),
]


def _grad_inputs(case, seed=0):
    b, s, h, kv, d, _, _ = case
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d), (b, s, h, d))]


@pytest.mark.parametrize("case", GRAD_CASES)
def test_flash_gradient_on_cpu_matches_reference_grad(case):
    """The port's flash function on CPU tensors (plain version + autograd)
    against ``jax.grad`` of the reference's ``attention_ref``."""
    causal, window = case[5], case[6]
    q, k, v, do = _grad_inputs(case)

    def jloss(q, k, v):
        o = jflash_ref.attention_ref(q, k, v, causal=causal, window=window)
        return jnp.sum(o * do)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = tflash_ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("case", GRAD_CASES)
def test_backward_kernel_math_matches_autograd(case):
    """``attention_bwd_ref`` (the backward kernel's arithmetic: P rebuilt
    from the forward's log-sum-exp, delta = rowsum(dO o O)) against the
    plain version's autograd."""
    causal, window = case[5], case[6]
    q, k, v, do = (torch.from_numpy(x) for x in _grad_inputs(case, seed=1))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o = tflash_ref.attention_ref(*leaves, causal=causal, window=window)
    want = torch.autograd.grad(o, leaves, do)
    lse = tflash_ref.attention_lse_ref(q, k, causal=causal, window=window)
    got = tflash_ref.attention_bwd_ref(q, k, v, o.detach(), lse, do,
                                       causal=causal, window=window)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=TOL, atol=TOL,
                                   err_msg=f"d{name}")


def test_flash_function_wiring_under_checkpoint(monkeypatch):
    """``FlashAttention`` with its two kernels swapped for their plain
    versions (the kernels run only on the card): the gradient equals the
    plain autograd's, and under ``torch.utils.checkpoint`` the backward
    reads the recomputed forward's log-sum-exp."""
    case = (2, 24, 4, 2, 16, True, 5)
    window = case[6]
    lses = []

    def fwd(q, k, v, *, causal, window, return_lse):
        assert return_lse and not (q.requires_grad or k.requires_grad)
        lse = tflash_ref.attention_lse_ref(q, k, causal=causal, window=window)
        lses.append(lse)
        return tflash_ref.attention_ref(q, k, v, causal=causal, window=window), lse

    def bwd(q, k, v, o, lse, do, *, causal, window):
        assert lse is lses[-1] and not do.requires_grad
        return tflash_ref.attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                            window=window)

    monkeypatch.setattr(tflash_kernel, "flash_attention", fwd)
    monkeypatch.setattr(tflash_kernel, "flash_attention_bwd", bwd)
    q, k, v, do = (torch.from_numpy(x) for x in _grad_inputs(case, seed=2))
    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(
        tflash_ref.attention_ref(*plain, window=window), plain, do)

    leaves = [x.clone().requires_grad_() for x in (q, k, v)]

    def layer(q, k, v):
        return tflash_ops.FlashAttention.apply(q, k, v, True, window) * 2.0

    o = torch.utils.checkpoint.checkpoint(layer, *leaves, use_reentrant=False)
    assert len(lses) == 1
    got = torch.autograd.grad(o, leaves, do / 2.0)
    assert len(lses) == 2          # the recompute ran the forward again
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=TOL, atol=TOL,
                                   err_msg=f"d{name}")
