"""The port's checkpoints against the reference's, and its training loop's
resume, on CPU.

Both packages write ``step_<N>/shard_0.npz`` (leaves as uint8 byte views),
``manifest.json``, ``meta.json`` and ``COMMIT``; each restores the other's
save bit for bit, bf16 leaves included. The resume contract is the one of
``tests/test_train_resume.py`` (14 straight steps equal 7 steps and an
auto-resume to 14, rtol 1e-5 / atol 1e-6), on reduced gemma3-1b: the
reference's own test runs xlstm-125m, whose layers wait for the xLSTM
slice."""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro import configs as jconfigs
from repro.checkpoint import manager as jckpt
from repro.models import decoder_lm as jdlm
from repro.training import optimizer as jopt
from repro.training import train_step as jtrain_step
from repro_torch import configs as tconfigs
from repro_torch._tree import tensor_from_numpy, tree_map
from repro_torch.checkpoint import manager as tckpt
from repro_torch.launch import train as tlaunch
from repro_torch.models import common as tcommon
from repro_torch.models import decoder_lm as tdlm
from repro_torch.training import optimizer as topt
from repro_torch.training import train_step as ttrain_step

ARCH = "gemma3-1b"


def _random_like(tree, seed):
    """``tree`` (of JAX arrays) with random values of each leaf's dtype,
    the step counter included."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: jax.numpy.asarray(
            rng.integers(0, 1000, x.shape) if x.dtype == np.int32
            else rng.standard_normal(x.shape), x.dtype), tree)


def _states(dtype: str):
    """A reference TrainState with random values (bf16 params and moments
    when ``dtype`` is bfloat16; norm scales stay fp32) and a port TrainState
    of the same structure, from the port's own init (its dicts in
    insertion order, not sorted), filled with zeros."""
    jcfg = dataclasses.replace(jconfigs.reduce_for_smoke(jconfigs.get_config(ARCH)),
                               dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.reduce_for_smoke(tconfigs.get_config(ARCH)),
                               dtype=dtype)
    jp = jdlm.init_params(jcfg, jax.random.PRNGKey(0))
    jstate = _random_like(jtrain_step.TrainState(
        params=jp, opt=jopt.adamw_init(jp, moment_dtype=dtype)), seed=1)
    tp = tree_map(torch.zeros_like, tdlm.init_params(tcfg, device="cpu"))
    tstate = ttrain_step.TrainState(params=tp,
                                    opt=topt.adamw_init(tp, moment_dtype=dtype))
    return jstate, tstate


def _bits(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous()
        t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return np.atleast_1d(t.numpy()).view(np.uint8)
    return np.atleast_1d(np.ascontiguousarray(np.asarray(leaf))).view(np.uint8)


def _assert_same_bits(port_state, ref_state):
    t_leaves, t_names = tckpt._flatten_with_names(port_state)
    j_leaves, j_names, _ = jckpt._flatten_with_names(ref_state)
    assert t_names == j_names
    assert len(t_leaves) == len(j_leaves) > 50
    for name, t, j in zip(t_names, t_leaves, j_leaves):
        assert tuple(t.shape) == tuple(j.shape), name
        np.testing.assert_array_equal(_bits(t), _bits(j), err_msg=name)


def _read(path, name):
    with open(os.path.join(path, name)) as f:
        return json.load(f)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_leaf_names_follow_the_reference_order(dtype):
    jstate, tstate = _states(dtype)
    _, j_names, _ = jckpt._flatten_with_names(jstate)
    t_leaves, t_names = tckpt._flatten_with_names(tstate)
    assert t_names == j_names
    assert t_names[0] == "params/embed" and "opt/step" in t_names
    assert any(n.startswith("params/segments/0/0/attn/") for n in t_names)
    # a permuted tree would restore silently: the port's dict order
    # (insertion) differs from the sorted order of the names
    assert list(tstate.params["segments"][0][0]) == ["norm1", "attn", "norm2",
                                                     "mlp"]
    assert [tuple(t.shape) for t in t_leaves] == [
        tuple(x.shape) for x in jax.tree.leaves(jstate)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_save_restores_in_the_port(tmp_path, dtype):
    jstate, tstate = _states(dtype)
    jckpt.CheckpointManager(str(tmp_path), keep_k=2).save(
        3, jstate, extra={"data_step": 3})
    step, restored, meta = tckpt.CheckpointManager(str(tmp_path)).restore_latest(
        tstate)
    assert step == 3 and meta == {"step": 3, "extra": {"data_step": 3}}
    assert isinstance(restored, ttrain_step.TrainState)
    assert isinstance(restored.opt, topt.AdamState)
    assert list(restored.params) == list(tstate.params)   # key order kept
    _assert_same_bits(restored, jstate)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_save_restores_in_the_reference(tmp_path, dtype):
    jstate, tstate = _states(dtype)
    # the port's state takes the reference's random values (by bit pattern)
    tstate = tckpt._unflatten(tstate, iter(
        tensor_from_numpy(np.asarray(x), "cpu") for x in jax.tree.leaves(jstate)))
    _assert_same_bits(tstate, jstate)
    tckpt.CheckpointManager(str(tmp_path / "port"), keep_k=2).save(
        5, tstate, extra={"data_step": 5})
    jckpt.CheckpointManager(str(tmp_path / "ref"), keep_k=2).save(
        5, jstate, extra={"data_step": 5})
    like = _random_like(jstate, seed=2)
    step, restored, meta = jckpt.CheckpointManager(
        str(tmp_path / "port")).restore_latest(like)
    assert step == 5 and meta == {"step": 5, "extra": {"data_step": 5}}
    _assert_same_bits(tstate, restored)
    port_dir, ref_dir = (str(tmp_path / d / "step_00000005") for d in ("port", "ref"))
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(ref_dir)) == [
        "COMMIT", "manifest.json", "meta.json", "shard_0.npz"]
    assert _read(port_dir, "manifest.json") == _read(ref_dir, "manifest.json")
    assert _read(port_dir, "meta.json") == _read(ref_dir, "meta.json")


def test_uncommitted_saves_are_ignored(tmp_path):
    _, tstate = _states("float32")
    mgr = tckpt.CheckpointManager(str(tmp_path), keep_k=3)
    mgr.save(2, tstate)
    # a save that died before its rename, and one that died before COMMIT
    tckpt.save_pytree(str(tmp_path / "step_00000009.tmp-12345"), tstate)
    tckpt.save_pytree(str(tmp_path / "step_00000010"), tstate)
    assert mgr.committed_steps() == [2]
    assert mgr.restore_latest(tstate)[0] == 2


def test_keep_k_prunes_old_steps(tmp_path):
    _, tstate = _states("float32")
    mgr = tckpt.CheckpointManager(str(tmp_path), keep_k=2)
    for step in range(1, 6):
        mgr.save(step, tstate, extra={"data_step": step})
    assert mgr.committed_steps() == [4, 5]
    assert sorted(os.listdir(tmp_path)) == ["step_00000004", "step_00000005"]
    assert tckpt.CheckpointManager(str(tmp_path / "none")).restore_latest(
        tstate) is None


def test_resume_matches_uninterrupted(tmp_path):
    """tests/test_train_resume.py's contract on the port's train_loop."""
    cfg = dataclasses.replace(tconfigs.reduce_for_smoke(tconfigs.get_config(ARCH)),
                              remat=False)
    kw = dict(global_batch=4, seq_len=32, lr=1e-3, log_every=1,
              ckpt_every=5, keep_k=2, log=lambda *a: None,
              schedule_steps=14, device="cpu")
    runtime = dict(tcommon.RUNTIME)

    # uninterrupted 14 steps
    _, straight = tlaunch.train_loop(cfg, 14, ckpt_dir=str(tmp_path / "a"), **kw)

    # 7 steps, then a fresh loop that must auto-resume from the 7-step save
    _, first = tlaunch.train_loop(cfg, 7, ckpt_dir=str(tmp_path / "b"), **kw)
    logs = []
    _, resumed = tlaunch.train_loop(cfg, 14, ckpt_dir=str(tmp_path / "b"),
                                    **{**kw, "log": logs.append})
    assert "resumed from step 7" in logs
    assert [h["step"] for h in first] == list(range(7))
    assert [h["step"] for h in resumed] == list(range(7, 14))

    by_step_straight = {h["step"]: h["loss"] for h in straight}
    by_step_resumed = {h["step"]: h["loss"] for h in first + resumed}
    assert sorted(by_step_straight) == sorted(by_step_resumed) == list(range(14))
    for s in by_step_straight:
        np.testing.assert_allclose(by_step_resumed[s], by_step_straight[s],
                                   rtol=1e-5, atol=1e-6,
                                   err_msg=f"divergence at step {s}")
    assert tcommon.RUNTIME == runtime        # the loop restores its knobs
    committed = tckpt.CheckpointManager(str(tmp_path / "a")).committed_steps()
    assert committed == [10, 14]             # keep_k 2 of 5, 10, 14
