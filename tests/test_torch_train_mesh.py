"""``train_loop(mesh=)``: the port's training loop over ``DTensor`` device
meshes, on CPU gloo ranks, against the reference and the plain loop.

The reference's own sharded loop cannot run on the installed jax (its
embedding gather raises ``ShardingTypeError``, ``tests/test_train_resume.py``),
so the sharded port is held to the function that loop's jitted step
computes: the reference's ``make_train_step`` on one CPU device (``jit``
with shardings does not change the math). The reference's initial state is
saved as a step-0 checkpoint with the reference's own ``CheckpointManager``,
and every loop here resumes from it: the plain loop in this process, and
the mesh loops in subprocess ranks (gloo), which restore it onto their
meshes. Two spawns: two ranks run the ``(2, 1)`` and ``(1, 2)`` meshes, the
xlstm-125m resume recipe and the ``torchrun``-style CLI (``RANK`` /
``WORLD_SIZE`` / ``MASTER_*`` in the environment); four ranks run ``(2, 2)``
and the attention boundary on ``(1, 4)`` and ``(2, 2)``.

Tolerances: ``tests/test_torch_train_step.py``'s, metrics 1e-5 and params
atol 5e-5 + rtol 1e-4 (see its docstring: AdamW moves a param by O(lr)
whatever its gradient's size, so float noise in a near-zero gradient moves
it by up to a few 1e-5), against the reference and against the port's
plain loop alike: on a mesh the losses and gradients are summed across
ranks in another order. The xlstm resume keeps the reference's resume
tolerance, rtol 1e-5 / atol 1e-6.
"""
import dataclasses
import json
import os
import shutil
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro import configs as jconfigs
from repro.checkpoint import manager as jckpt
from repro.data import synthetic as jsynth
from repro.models import common as jcommon
from repro.models import decoder_lm as jdlm
from repro.training import optimizer as jopt
from repro.training import train_step as jtrain_step
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import manager as tckpt
from repro_torch.launch import train as tlaunch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")

ARCH = "gemma3-1b"
STEPS, BATCH, SEQ, LR = 3, 4, 32, 1e-3
METRIC_TOL = 1e-5
PARAM_ATOL, PARAM_RTOL = 5e-5, 1e-4
MESHES = [(2, 1), (1, 2), (2, 2)]
LOOP = dict(global_batch=BATCH, seq_len=SEQ, lr=LR, log_every=1,
            log=lambda *a: None, device="cpu")
XLSTM_LOOP = dict(global_batch=4, seq_len=32, lr=1e-3, log_every=1,
                  ckpt_every=5, keep_k=2, log=lambda *a: None,
                  schedule_steps=14, device="cpu")
ATTENTION_CASES = [
    # (mesh, B, S, H, KV, D, window, q placements by mesh dim)
    ((1, 4), 2, 16, 8, 2, 16, None, "R,S2"),   # 2 query heads a rank, G 4
    ((1, 4), 2, 16, 12, 3, 16, 5, "R,S2"),     # 3 a rank straddle KV heads
    ((1, 4), 1, 12, 8, 4, 16, None, "R,S2"),   # KV heads split as well
    ((2, 2), 2, 16, 8, 2, 16, 6, "S0,S2"),     # batch on data, heads on model
]

_RANK = r"""
import json, os, shutil, sys
sys.path.insert(0, sys.argv[3])
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch._tree import leaves
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import mesh as lm
from repro_torch.launch import specs
from repro_torch.launch import train as tl
from repro_torch.parallel import sharding as sh

rank, job, work = int(sys.argv[1]), sys.argv[2], sys.argv[4]
LOOP = json.loads(sys.argv[5])
LOOP.update(log=lambda *a: None)
XLSTM = json.loads(sys.argv[6])
XLSTM.update(log=lambda *a: None)
ATTN = json.loads(sys.argv[7])
if job == "two":      # torchrun's contract: the group from the environment
    lm.init_process_group("gloo")
else:
    lm.init_process_group("gloo", world_size=4, rank=rank, port=int(sys.argv[8]))
facts = {}


def out(name, history, state):
    # the reference's leaf order (sorted keys), gathered on every rank
    full = [t.full_tensor() for t in ckpt._flatten_with_names(state.params)[0]]
    if rank == 0:
        np.savez(os.path.join(work, name + ".npz"),
                 *[t.detach().numpy() for t in full])
        with open(os.path.join(work, name + ".json"), "w") as f:
            json.dump(history, f)


def placed(name, state, rules):
    # every leaf keeps train_state_specs' placements; local bytes as the
    # specs predict: a leaf's bytes over the ranks its spec splits it on
    want = specs.train_state_specs(rules, state)
    sizes = sh.mesh_sizes(rules.mesh)
    same, local, predicted, halved = True, 0, 0, []
    for t, spec in zip(leaves(state), _flat(want)):
        same &= tuple(t.placements) == sh.compute_placements(spec,
                                                             rules.mesh)
        n = t.numel() * t.element_size()
        split = 1
        for e in spec:
            for a in ((e,) if isinstance(e, str) else (e or ())):
                split *= sizes[a]
        lb = t.to_local().numel() * t.element_size()
        local += lb
        predicted += n // split
        if any("data" in ((e,) if isinstance(e, str) else (e or ()))
               for e in spec):
            halved.append(lb * sizes["data"] == n)
    facts[name] = dict(same=bool(same), local=local, predicted=predicted,
                       n_fsdp=len(halved), all_halved=all(halved))


def _flat(tree):
    if isinstance(tree, sh.P):
        return [tree]
    if isinstance(tree, dict):
        return [s for v in tree.values() for s in _flat(v)]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, sh.P):
        return [s for v in tree for s in _flat(v)]
    return [tree]


def gemma(shape):
    name = "gemma_%dx%d" % shape
    mesh = lm.device_mesh(shape, ("data", "model"), device="cpu")
    d = os.path.join(work, name)
    if rank == 0:
        shutil.copytree(os.path.join(work, "ref0"), d)
    dist.barrier()
    cfg = reduce_for_smoke(get_config("gemma3-1b"))
    state, hist = tl.train_loop(cfg, 3, ckpt_dir=d, mesh=mesh, **LOOP)
    placed(name, state, sh.ShardingRules(mesh=mesh, fsdp=mesh.size() > 1))
    out(name, hist, state)


def xlstm():
    import dataclasses
    mesh = lm.device_mesh((2, 1), ("data", "model"), device="cpu")
    cfg = dataclasses.replace(reduce_for_smoke(get_config("xlstm-125m")),
                              remat=False)
    a, b = os.path.join(work, "x_a"), os.path.join(work, "x_b")
    _, straight = tl.train_loop(cfg, 14, ckpt_dir=a, mesh=mesh, **XLSTM)
    tl.train_loop(cfg, 7, ckpt_dir=b, mesh=mesh, **XLSTM)
    if rank == 0:        # the 2-rank checkpoint, for the plain loop
        shutil.copytree(b, os.path.join(work, "x_c"))
    dist.barrier()
    _, resumed = tl.train_loop(cfg, 14, ckpt_dir=b, mesh=mesh, **XLSTM)
    if rank == 0:
        with open(os.path.join(work, "xlstm.json"), "w") as f:
            json.dump({"straight": straight, "resumed": resumed}, f)


def attention(case):
    shape, b, s, h, kv, d, window, qpl = case
    mesh = lm.device_mesh(tuple(shape), ("data", "model"), device="cpu")
    rng = np.random.default_rng(0)
    q, k, v, w = (torch.from_numpy(rng.standard_normal(x).astype(np.float32))
                  for x in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d),
                            (b, s, h, d)))
    pl = tuple(Replicate() if p == "R" else Shard(int(p[1]))
               for p in qpl.split(","))
    kpl = tuple(p if p == Shard(0) else Replicate() for p in pl)
    leaves_ = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = flash_ops.flash_attention(*leaves_, window=window)
    gw = torch.autograd.grad((want * w).sum(), leaves_)
    dq, dk, dv = (distribute_tensor(x, mesh, p).requires_grad_(True)
                  for x, p in ((q, pl), (k, kpl), (v, kpl)))
    got = flash_ops.flash_attention(dq, dk, dv, window=window)
    dw = distribute_tensor(w, mesh, pl)
    gg = torch.autograd.grad((got * dw).sum(), (dq, dk, dv))
    err = [float((got.full_tensor() - want).abs().max())]
    err += [float((a.full_tensor() - c).abs().max()) for a, c in zip(gg, gw)]
    facts.setdefault("attention", []).append(
        dict(err=err, placements=str(tuple(got.placements)),
             grad_placements=[str(tuple(a.placements)) for a in gg]))


if job == "two":
    gemma((2, 1))
    gemma((1, 2))
    xlstm()
    import contextlib, io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tl.main(["--arch", "gemma3-1b", "--smoke", "--steps", "1",
                 "--global-batch", "4", "--seq-len", "32", "--device", "cpu"])
    facts["cli"] = buf.getvalue()
else:
    gemma((2, 2))
    for case in ATTN:
        attention(case)
with open(os.path.join(work, "facts_%s_%d.json" % (job, rank)), "w") as f:
    json.dump(facts, f)
dist.barrier()
dist.destroy_process_group()
print("RANK_OK", rank, flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(job: str, world: int, work: str) -> list:
    """Start ``world`` ranks of ``job``; returns their processes."""
    port = _free_port()
    loop = {k: v for k, v in LOOP.items() if k != "log"}
    xl = {k: v for k, v in XLSTM_LOOP.items() if k != "log"}
    procs = []
    for r in range(world):
        env = dict(os.environ, OMP_NUM_THREADS="1")
        if job == "two":
            env.update(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                       MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _RANK, str(r), job, SRC, work,
             json.dumps(loop), json.dumps(xl), json.dumps(ATTENTION_CASES),
             str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env))
    return procs


def _wait(procs: list) -> None:
    outs = [p.communicate(timeout=400) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0 and "RANK_OK" in o, o + e[-6000:]


def _jcfg():
    return jconfigs.reduce_for_smoke(jconfigs.get_config(ARCH))


def _tcfg():
    return tconfigs.reduce_for_smoke(tconfigs.get_config(ARCH))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The reference's step-0 checkpoint and trajectory, the port's plain
    loop from that checkpoint, and both spawns' results."""
    work = str(tmp_path_factory.mktemp("mesh"))
    jcfg = _jcfg()
    jp = jax.jit(lambda key: jdlm.init_params(jcfg, key))(jax.random.PRNGKey(0))
    state = jtrain_step.TrainState(params=jp, opt=jopt.adamw_init(jp))
    jckpt.CheckpointManager(os.path.join(work, "ref0")).save(0, state)
    # both spawns at once, six single-threaded ranks, while this process
    # runs the reference and the plain loop
    procs = _spawn("two", 2, work) + _spawn("four", 4, work)
    # train_loop's optimizer at steps 3: warmup min(20, 3 // 10) = 0
    opt = jopt.AdamWConfig(learning_rate=LR, warmup_steps=0, total_steps=STEPS)
    old = jcommon.RUNTIME["use_flash"]
    jcommon.RUNTIME["use_flash"] = False
    try:
        step = jax.jit(jtrain_step.make_train_step(jcfg, opt))
        ref = []
        for i in range(STEPS):
            b = jsynth.make_batch(jcfg, jsynth.SyntheticConfig(BATCH, SEQ,
                                                               seed=0), i)
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            ref.append({k: float(v) for k, v in m.items()})
    finally:
        jcommon.RUNTIME["use_flash"] = old
    ref_params = [np.asarray(x, np.float32) for x in jax.tree.leaves(state.params)]

    plain_dir = os.path.join(work, "plain")
    shutil.copytree(os.path.join(work, "ref0"), plain_dir)
    pstate, phist = tlaunch.train_loop(_tcfg(), STEPS, ckpt_dir=plain_dir,
                                       **LOOP)
    plain_params = [p.detach().numpy()
                    for p in tckpt._flatten_with_names(pstate.params)[0]]

    _wait(procs)
    facts = {}
    for job, world in (("two", 2), ("four", 4)):
        for r in range(world):
            with open(os.path.join(work, f"facts_{job}_{r}.json")) as f:
                facts[(job, r)] = json.load(f)
    return dict(work=work, ref=ref, ref_params=ref_params, plain=phist,
                plain_params=plain_params, facts=facts)


def _mesh_result(run, shape):
    name = "gemma_%dx%d" % shape
    with open(os.path.join(run["work"], name + ".json")) as f:
        hist = json.load(f)
    with np.load(os.path.join(run["work"], name + ".npz")) as z:
        params = [z[f"arr_{i}"] for i in range(len(z.files))]
    return name, hist, params


@pytest.mark.parametrize("shape", MESHES, ids=["2x1", "1x2", "2x2"])
def test_mesh_steps_match_reference_and_plain_loop(run, shape):
    """Three steps of gemma3-1b (reduced, fp32, remat) on the mesh: metrics
    and params against the reference's ``make_train_step`` and against the
    port's plain ``train_loop``, all from the reference's initial state."""
    _, hist, params = _mesh_result(run, shape)
    assert [h["step"] for h in hist] == list(range(STEPS))
    for i, (got, want, plain) in enumerate(zip(hist, run["ref"], run["plain"])):
        for k in ("loss", "ce", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(got[k], want[k], rtol=METRIC_TOL,
                                       atol=METRIC_TOL,
                                       err_msg=f"{k} after step {i}")
            np.testing.assert_allclose(got[k], plain[k], rtol=METRIC_TOL,
                                       atol=METRIC_TOL,
                                       err_msg=f"{k} after step {i} (plain)")
    assert len(params) == len(run["ref_params"]) == len(run["plain_params"])
    for g, w, p in zip(params, run["ref_params"], run["plain_params"]):
        np.testing.assert_allclose(g, w, rtol=PARAM_RTOL, atol=PARAM_ATOL)
        np.testing.assert_allclose(g, p, rtol=PARAM_RTOL, atol=PARAM_ATOL)
    # the steps moved the params
    with np.load(os.path.join(run["work"], "ref0", "step_00000000",
                              "shard_0.npz")) as z:
        embed0 = z["leaf_0"].view(np.float32).reshape(params[0].shape)
    assert np.abs(params[0] - embed0).max() > 1e-4


@pytest.mark.parametrize("shape", MESHES, ids=["2x1", "1x2", "2x2"])
def test_mesh_state_keeps_its_placements_and_local_bytes(run, shape):
    """After the steps every leaf of the state has the placements
    ``train_state_specs`` gives it, and each rank holds exactly the bytes
    the specs predict (a leaf's bytes over the ranks its spec splits it
    on). On ``(2, 1)`` FSDP halves every leaf it shards."""
    name = "gemma_%dx%d" % shape
    job, world = ("four", 4) if shape == (2, 2) else ("two", 2)
    for r in range(world):
        f = run["facts"][(job, r)][name]
        assert f["same"], (name, r)
        assert f["local"] == f["predicted"], (name, r, f)
        if shape == (2, 1):
            assert f["n_fsdp"] > 0 and f["all_halved"], (name, r, f)


def test_xlstm_resumes_on_a_2x1_mesh(run):
    """xlstm-125m (reduced, no remat) on ``(2, 1)`` by the reference's
    resume recipe: 14 straight steps equal 7 steps and an auto-resume from
    the newest checkpoint, step 7's (the loop saves at its end), to 14
    (rtol 1e-5 / atol 1e-6), which replays a checkpoint taken between
    ``ckpt_every`` saves. The checkpoint the
    two ranks saved at step 7 resumes in the plain one-process loop, whose
    steps agree with the mesh's at the train-step tolerance."""
    with open(os.path.join(run["work"], "xlstm.json")) as f:
        res = json.load(f)
    straight = {h["step"]: h for h in res["straight"]}
    resumed = {h["step"]: h for h in res["resumed"]}
    assert sorted(straight) == list(range(14))
    assert sorted(resumed) == list(range(7, 14))   # the end save, step 7
    for s in resumed:
        np.testing.assert_allclose(resumed[s]["loss"], straight[s]["loss"],
                                   rtol=1e-5, atol=1e-6,
                                   err_msg=f"divergence at step {s}")
    cfg = dataclasses.replace(
        tconfigs.reduce_for_smoke(tconfigs.get_config("xlstm-125m")),
        remat=False)
    logs = []
    _, plain = tlaunch.train_loop(cfg, 14, ckpt_dir=os.path.join(run["work"],
                                                                 "x_c"),
                                  **dict(XLSTM_LOOP, log=logs.append))
    assert logs[0] == "resumed from step 7"
    assert [h["step"] for h in plain] == list(range(7, 14))
    for h in plain:
        for k in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(h[k], straight[h["step"]][k],
                                       rtol=METRIC_TOL, atol=METRIC_TOL,
                                       err_msg=f"{k} at step {h['step']}")


@pytest.mark.parametrize("i", range(len(ATTENTION_CASES)),
                         ids=["1x4_h8kv2", "1x4_h12kv3_straddle",
                              "1x4_h8kv4_split", "2x2_h8kv2_batch"])
def test_attention_on_local_shards(run, i):
    """The kernel boundary: ``flash_attention`` on ``DTensor``s runs on
    each rank's shard (its CPU version here) and equals the unsharded
    function, forward and gradient, at 2e-5. With H 8 and KV 2 on
    ``model`` 4 the KV heads cannot split: each rank takes KV head
    ``h // 4`` for its query heads ``h``; with H 12, KV 3 a rank's three
    heads straddle two KV heads. The output keeps q's placements and the
    gradients their inputs'."""
    for r in range(4):
        f = run["facts"][("four", r)]["attention"][i]
        assert max(f["err"]) < 2e-5, (r, f)
        assert f["grad_placements"][0] == f["placements"]


def test_cli_under_torchrun_environment_logs_on_rank_0(run):
    """``main`` under ``torchrun``'s environment (``WORLD_SIZE`` 2) trains
    on the ``(2, 1)`` mesh; only rank 0 prints."""
    assert "loss" in run["facts"][("two", 0)]["cli"]
    assert run["facts"][("two", 1)]["cli"] == ""
