"""The port's donated train step on the CPU: ``adamw_update_`` and
``make_train_step(..., donate=True)``, the counterparts of the reference's
``jax.jit(step, donate_argnums=(0,))`` (``launch/train.py``).

* ``adamw_update_`` writes the step into the given tensors and computes
  ``adamw_update``'s numbers bit for bit, over several steps, with fp32 and
  bf16 moments, clipping on and off, with and without decay-masked leaves.
* The donating step equals the pure step bit for bit over 3 steps of reduced
  gemma3-1b, updates the state's own tensors (the pure step leaves its
  input as it was), and both are held to the reference's jitted, donating
  step at ``tests/test_torch_train_step.py``'s tolerances. The reference's
  inputs and outputs are copied in and out, as its donated buffers are
  reused for the next step's state.

The captured step (``launch/train.py::TrainGraph``) runs on the card only:
``tests/test_torch_graphs_gpu.py`` holds a graphed loop to an eager one.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro import configs as jconfigs
from repro.data import synthetic as jsynth
from repro.models import common as jcommon
from repro.models import decoder_lm as jdlm
from repro.training import optimizer as jopt
from repro.training import train_step as jtrain_step
from repro_torch import configs as tconfigs
from repro_torch._tree import leaves, tree_map
from repro_torch.data import synthetic as tsynth
from repro_torch.models import common as tcommon
from repro_torch.models import decoder_lm as tdlm
from repro_torch.training import optimizer as topt
from repro_torch.training import train_step as ttrain_step

ARCH = "gemma3-1b"
TOL = 1e-5                            # test_torch_train_step.py's metrics
PARAM_ATOL, PARAM_RTOL = 5e-5, 1e-4   # and params (its docstring says why)
OPT = dict(learning_rate=1e-3, warmup_steps=1, total_steps=3)
STEPS = 3


def _tree(gen, dtype):
    """A param tree with decayed (``w``) and decay-masked (``bias``,
    ``norm``, ``scale``) leaves, in ``dtype``."""
    r = lambda *s: torch.randn(*s, generator=gen).to(dtype)
    return {"embed": r(40, 8),
            "blocks": [{"w": r(8, 8), "bias": r(8), "norm": {"scale": r(8)}},
                       {"w": r(8, 16), "bias": r(16)}],
            "head": r(16, 4)}


def _same(a, b) -> bool:
    return all(torch.equal(x, y) and x.dtype == y.dtype
               for x, y in zip(leaves(a), leaves(b)))


@pytest.mark.parametrize("decay", [0.1, 0.0], ids=["decay", "no_decay"])
@pytest.mark.parametrize("clip", [1.0, 0.0], ids=["clip", "no_clip"])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_adamw_update_in_place_equals_functional(param_dtype, moment_dtype,
                                                 clip, decay):
    cfg = topt.AdamWConfig(learning_rate=3e-3, weight_decay=decay,
                           grad_clip_norm=clip, warmup_steps=2, total_steps=6,
                           moment_dtype=moment_dtype)
    gen = torch.Generator().manual_seed(0)
    params = _tree(gen, param_dtype)
    state = topt.adamw_init(params, moment_dtype)
    donated = tree_map(torch.clone, params)
    dstate = topt.AdamState(*(tree_map(torch.clone, x) for x in state))
    ptrs = [t.data_ptr() for t in leaves(donated) + leaves(dstate)]
    for i in range(5):
        # gradients of mixed sizes: clipping bites on some steps only
        grads = tree_map(lambda g: g * 3.0 ** (i - 2), _tree(gen, param_dtype))
        params, state, want = topt.adamw_update(cfg, grads, state, params)
        got = topt.adamw_update_(cfg, grads, dstate, donated)
        assert sorted(got) == sorted(want) == ["grad_norm", "lr"]
        for k in want:
            assert torch.equal(got[k], want[k]), (k, i)
        assert _same(donated, params), f"params after step {i}"
        assert _same(dstate.mu, state.mu) and _same(dstate.nu, state.nu), i
        assert torch.equal(dstate.step, state.step)
        assert dstate.step.dtype == torch.int32
    assert [t.data_ptr() for t in leaves(donated) + leaves(dstate)] == ptrs
    assert int(dstate.step) == 5


# -- the donating train step ------------------------------------------------------
@pytest.fixture(scope="module")
def lm():
    jcfg = jconfigs.reduce_for_smoke(jconfigs.get_config(ARCH))
    tcfg = tconfigs.reduce_for_smoke(tconfigs.get_config(ARCH))
    jp = jax.jit(lambda key: jdlm.init_params(jcfg, key))(jax.random.PRNGKey(0))
    return jcfg, tcfg, jax.tree.map(np.asarray, jp)


def _batch(cfg, synth, seq, step):
    return synth.make_batch(cfg, synth.SyntheticConfig(1, seq, seed=0), step)


def _reference(jcfg, jp, seq):
    """The reference's ``jax.jit(step, donate_argnums=(0,))`` trajectory, as
    ``repro/launch/train.py`` builds it (``use_flash`` off: see
    ``tests/test_torch_train_step.py``)."""
    opt = jopt.AdamWConfig(**OPT)
    params = jax.tree.map(jnp.array, jp)
    state = jtrain_step.TrainState(params=params, opt=jopt.adamw_init(params))
    step = jax.jit(jtrain_step.make_train_step(jcfg, opt), donate_argnums=(0,))
    old = jcommon.RUNTIME["use_flash"]
    jcommon.RUNTIME["use_flash"] = False
    out = []
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", "Some donated buffers")
            for i in range(STEPS):
                b = _batch(jcfg, jsynth, seq, i)
                state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
                out.append(({k: float(v) for k, v in m.items()},
                            jax.tree.map(np.array, state.params)))
    finally:
        jcommon.RUNTIME["use_flash"] = old
    return out


def _port(tcfg, jp, seq, donate):
    opt = topt.AdamWConfig(**OPT)
    params = tdlm.params_from_numpy(jp, device="cpu")
    state = ttrain_step.TrainState(params=params, opt=topt.adamw_init(params))
    step = ttrain_step.make_train_step(tcfg, opt, donate=donate)
    out = []
    for i in range(STEPS):
        b = {k: torch.from_numpy(v)
             for k, v in _batch(tcfg, tsynth, seq, i).items()}
        before = [t.clone() for t in leaves(state.params)]
        ptrs = [t.data_ptr() for t in leaves(state)]
        new, m = step(state, b)
        if donate:   # the state's own tensors took the step
            assert new is state
            assert [t.data_ptr() for t in leaves(new)] == ptrs
        else:        # the given state is not modified
            assert all(torch.equal(x, y)
                       for x, y in zip(before, leaves(state.params)))
        state = new
        out.append(({k: v.clone() for k, v in m.items()},
                    [t.clone() for t in leaves(state)],
                    tdlm.params_to_numpy(tree_map(torch.clone, state.params))))
    return out


@pytest.mark.parametrize("seq", [1024, 64], ids=["chunked_ce", "full_ce"])
def test_donating_step_equals_pure_step_and_reference(lm, seq):
    jcfg, tcfg, jp = lm
    pure = _port(tcfg, jp, seq, donate=False)
    donated = _port(tcfg, jp, seq, donate=True)
    for i, ((pm, ps, _), (dm, ds, _)) in enumerate(zip(pure, donated)):
        assert sorted(dm) == sorted(pm) == ["aux", "ce", "grad_norm", "loss", "lr"]
        for k in pm:
            assert torch.equal(dm[k], pm[k]), (k, i)
        assert all(torch.equal(x, y) for x, y in zip(ds, ps)), f"state {i}"
    want = _reference(jcfg, jp, seq)
    for i, ((gm, _, gp), (wm, wp)) in enumerate(zip(donated, want)):
        for k in wm:
            np.testing.assert_allclose(float(gm[k]), wm[k], rtol=TOL, atol=TOL,
                                       err_msg=f"{k} after step {i}")
        for g, w in zip(jax.tree.leaves(gp), jax.tree.leaves(wp)):
            np.testing.assert_allclose(g, np.asarray(w, np.float32),
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=f"params after step {i}")
    # the steps moved the params
    assert np.abs(donated[-1][2]["embed"] - jp["embed"]).max() > 1e-4
