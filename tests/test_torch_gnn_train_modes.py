"""The port's GNN trainer per mode on the CPU, from the reference's params.

* ``test_fast_path.py``'s training tests on the port: ``scan`` against
  ``sequential``, ``joint`` against a hand loop of per-graph gradients
  summed then divided, ``bucketed`` on a ragged dataset.
* Every mode against the reference's ``train_gnn`` from the same init, at
  the tolerance those tests state for two orders of summation (the joint
  mode against the hand loop): XLA's and torch's matmuls sum in other
  orders too, and over 18 Adam steps of a 213-wide model a few of 45,369
  weights drift past ``scan``'s 1e-4 / 1e-5 (by at most 7e-5), which holds
  only for one package's two trajectories. The histories are held at
  ``scan``'s 1e-4 (loss) and 1e-6 (accuracy).
* The in-place steps (``adamw_update_`` on the run's own params and state,
  the reference's donated buffers) equal a functional loop of the same
  losses and ``adamw_update`` bit for bit, and ``opt_state.step`` counts the
  reference's updates: one per graph per epoch, or one per epoch (joint).
* The trainer cache: a second call of the same key reuses the static
  tensors, gives that call's answer and leaves the first call's result and
  the caller's params and examples alone.

The captured programs run on the card only:
``tests/test_torch_gnn_train_graphs_gpu.py`` holds them to the eager steps.
"""
import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.core import cost_model as jcm
from repro.core import gnn as jgnn
from repro.core import train as jtrain
from repro_torch._tree import leaves, tree_map
from repro_torch.core import gnn as tgnn
from repro_torch.core import train as ttrain
from repro_torch.training import optimizer as topt

SMALL_TASKS = [jcm.GPT2_1_5B, jcm.BERT_LARGE]
MODES = ("joint", "scan", "bucketed", "sequential")
# test_fast_path.py's tolerances: scan vs sequential, and joint vs the hand
# loop (sum-then-divide against the vmapped mean; Adam's rsqrt amplifies
# the last-ulp drift)
SCAN_TOL = dict(rtol=1e-4, atol=1e-5)
JOINT_TOL = dict(rtol=1e-3, atol=2e-4)
HIST_LOSS, HIST_ACC = 1e-4, 1e-6


def _dataset(seed, ragged=False):
    ds = jtrain.make_dataset(3, SMALL_TASKS, n_nodes=12, seed=seed,
                             label_frac=0.8)
    if ragged:
        ds = (jtrain.make_dataset(2, SMALL_TASKS, n_nodes=10, seed=2,
                                  label_frac=0.8)
              + jtrain.make_dataset(2, SMALL_TASKS, n_nodes=20, seed=4,
                                    label_frac=0.8))
    return ds


def _port(ds):
    return [ttrain.GraphExample(e.feats, e.lat, e.labels, e.mask) for e in ds]


def _init(cfg, d_in, seed=0):
    """The reference's init and the same numbers as the port's tree."""
    p = jgnn.init(jax.random.PRNGKey(seed), cfg, d_in)
    return p, tgnn.params_from_numpy(jax.tree.map(np.asarray, p),
                                     device="cpu")


def _cfgs():
    cfg = jtrain.gnn_config_for(SMALL_TASKS)
    return cfg, ttrain.gnn_config_for(SMALL_TASKS)


def _assert_params_close(want, got, tol):
    want = jax.tree.leaves(jax.tree.map(np.asarray, want))
    got = jax.tree.leaves(tgnn.params_to_numpy(got))
    assert len(want) == len(got)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b, a, **tol)


def _assert_history_close(want, got):
    assert [h["step"] for h in got] == [h["step"] for h in want]
    for a, b in zip(want, got):
        assert abs(a["loss"] - b["loss"]) < HIST_LOSS
        assert abs(a["accuracy"] - b["accuracy"]) < HIST_ACC


def _trainer(cfg, ds, mode, lr=0.01):
    """The cached trainer of a CPU run (its static params and state)."""
    mode, stacks = ttrain._resolve_mode(ds, mode)
    return ttrain._TRAINERS[ttrain._key(cfg, ttrain._opt_config(lr), mode,
                                        ds, stacks, torch.device("cpu"))]


# ---------------------------------------------------------------------------
# test_fast_path.py's training tests, on the port
# ---------------------------------------------------------------------------
def test_scan_training_matches_sequential_loop():
    cfg, tcfg = _cfgs()
    ds = _port(_dataset(0))
    _, tp = _init(cfg, ds[0].feats.shape[1])
    p_seq, h_seq = ttrain.train_gnn(tcfg, ds, steps=6, lr=0.01, params=tp,
                                    mode="sequential", device="cpu")
    p_scan, h_scan = ttrain.train_gnn(tcfg, ds, steps=6, lr=0.01, params=tp,
                                      mode="scan", device="cpu")
    for a, b in zip(leaves(tgnn.params_to_numpy(p_seq)),
                    leaves(tgnn.params_to_numpy(p_scan))):
        np.testing.assert_allclose(b, a, **SCAN_TOL)
    _assert_history_close(h_seq, h_scan)


def test_joint_training_matches_sequential_loop():
    """Mean masked loss over graphs, one Adam step per epoch: the joint
    mode's vmapped mean against per-graph gradients summed then divided."""
    cfg, tcfg = _cfgs()
    ds = _port(_dataset(1))
    steps, lr = 5, 0.01
    _, params = _init(cfg, ds[0].feats.shape[1])
    opt_cfg = ttrain._opt_config(lr)
    state = topt.adamw_init(params)
    t = torch.from_numpy
    for _ in range(steps):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        grads = None
        for ex in ds:
            loss, _ = tgnn.loss_fn(live, tcfg, t(ex.feats), t(ex.lat),
                                   t(ex.labels), t(ex.mask))
            g = ttrain._grads(loss, live)
            grads = g if grads is None else tree_map(torch.add, grads, g)
        grads = tree_map(lambda x: x / len(ds), grads)
        params, state, _ = topt.adamw_update(opt_cfg, grads, state, params)
    _, tp = _init(cfg, ds[0].feats.shape[1])
    p_joint, _ = ttrain.train_gnn(tcfg, ds, steps=steps, lr=lr, params=tp,
                                  mode="joint", device="cpu")
    for a, b in zip(leaves(tgnn.params_to_numpy(params)),
                    leaves(tgnn.params_to_numpy(p_joint))):
        np.testing.assert_allclose(b, a, **JOINT_TOL)


def test_bucketed_mode_handles_ragged_datasets():
    cfg, tcfg = _cfgs()
    ds = _port(_dataset(0, ragged=True))
    assert ttrain._resolve_mode(ds, "auto")[0] == "bucketed"
    params, hist = ttrain.train_gnn(tcfg, ds, steps=8, lr=0.01,
                                    device="cpu")   # auto
    assert len(hist) == 8
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert np.isfinite(hist[-1]["accuracy"])


# ---------------------------------------------------------------------------
# every mode against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", MODES)
def test_mode_matches_reference_train_gnn(mode):
    cfg, tcfg = _cfgs()
    ds = _dataset(0, ragged=mode == "bucketed")
    jp, tp = _init(cfg, ds[0].feats.shape[1], seed=3)
    want, want_hist = jtrain.train_gnn(cfg, ds, steps=6, lr=0.01, params=jp,
                                       mode=mode)
    got, got_hist = ttrain.train_gnn(tcfg, _port(ds), steps=6, lr=0.01,
                                     params=tp, mode=mode, device="cpu")
    _assert_params_close(want, got, JOINT_TOL)
    _assert_history_close(want_hist, got_hist)
    updates = 6 * (1 if mode == "joint" else len(ds))
    assert int(_trainer(tcfg, _port(ds), mode).opt_state.step) == updates


# ---------------------------------------------------------------------------
# the in-place steps against a functional loop, bit for bit
# ---------------------------------------------------------------------------
def _functional_run(cfg, ds, steps, lr, params, mode):
    """``train_gnn``'s trajectory with new tensors every step: the port's
    losses (``_joint_loss``, ``loss_fn``) and the functional
    ``adamw_update``. Returns (params, history, updates)."""
    opt_cfg = ttrain._opt_config(lr)
    state = topt.adamw_init(params)
    t = torch.from_numpy
    mode, stacks = ttrain._resolve_mode(ds, mode)
    if mode == "sequential":
        groups = [[{"feats": t(e.feats), "lat": t(e.lat), "labels": t(e.labels),
                    "label_mask": t(e.mask)} for e in ds]]
    else:
        groups = [{k: t(v) for k, v in s.items()} for s in stacks]
    history = []
    for step in range(steps):
        losses, accs = [], []
        for group in groups:
            if mode == "joint":
                live = tree_map(lambda p: p.detach().requires_grad_(True),
                                params)
                l, a = ttrain._joint_loss(live, cfg, group)
                params, state, _ = topt.adamw_update(
                    opt_cfg, ttrain._grads(l.mean(), live), state, params)
                losses += l.tolist()
                accs += a.tolist()
                continue
            exs = group if mode == "sequential" else [
                {k: v[g] for k, v in group.items()}
                for g in range(group["feats"].shape[0])]
            for ex in exs:
                live = tree_map(lambda p: p.detach().requires_grad_(True),
                                params)
                l, m = tgnn.loss_fn(live, cfg, ex["feats"], ex["lat"],
                                    ex["labels"], ex["label_mask"],
                                    node_mask=ex.get("node_mask"))
                params, state, _ = topt.adamw_update(
                    opt_cfg, ttrain._grads(l, live), state, params)
                losses.append(l.item())
                accs.append(m["accuracy"].item())
        agg = ((lambda v: float(np.mean(v))) if mode == "sequential" else
               (lambda v: float(np.asarray(v, np.float32).mean())))
        history.append({"step": step, "loss": agg(losses),
                        "accuracy": agg(accs)})
    return params, history, int(state.step)


@pytest.mark.parametrize("mode", MODES)
def test_in_place_steps_equal_functional_steps_bit_for_bit(mode):
    cfg, tcfg = _cfgs()
    ds = _port(_dataset(5, ragged=mode == "bucketed"))
    _, tp = _init(cfg, ds[0].feats.shape[1], seed=4)
    want, want_hist, updates = _functional_run(tcfg, ds, 4, 0.02, tp, mode)
    got, got_hist = ttrain.train_gnn(tcfg, ds, steps=4, lr=0.02, params=tp,
                                     mode=mode, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        ttrain._keyed_leaves(want), ttrain._keyed_leaves(got)))
    assert got_hist == want_hist
    assert updates == 4 * (1 if mode == "joint" else len(ds))
    assert int(_trainer(tcfg, ds, mode, lr=0.02).opt_state.step) == updates


# ---------------------------------------------------------------------------
# the trainer cache
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", MODES)
def test_cached_trainer_gives_each_call_its_own_answer(mode):
    cfg, tcfg = _cfgs()
    ds = _port(_dataset(6, ragged=mode == "bucketed"))
    d_in = ds[0].feats.shape[1]
    (_, p1), (_, p2) = _init(cfg, d_in, seed=1), _init(cfg, d_in, seed=2)
    keep = [x.clone() for x in leaves(p2)]
    arrays = [a.copy() for e in ds for a in (e.feats, e.lat, e.labels, e.mask)]
    ttrain._TRAINERS.clear()
    fresh2, hist2 = ttrain.train_gnn(tcfg, ds, steps=3, params=p2, mode=mode,
                                     device="cpu")
    ttrain._TRAINERS.clear()
    got1, hist1 = ttrain.train_gnn(tcfg, ds, steps=3, params=p1, mode=mode,
                                   device="cpu")
    kept1 = [x.clone() for x in leaves(got1)]
    trainer = _trainer(tcfg, ds, mode)
    got2, again2 = ttrain.train_gnn(tcfg, ds, steps=3, params=p2, mode=mode,
                                    device="cpu")
    assert len(ttrain._TRAINERS) == 1 and _trainer(tcfg, ds, mode) is trainer
    assert again2 == hist2 and hist1 != hist2
    assert all(torch.equal(a, b) for a, b in zip(leaves(got2), leaves(fresh2)))
    # the first result, the caller's params and examples are left alone
    assert all(torch.equal(a, b) for a, b in zip(leaves(got1), kept1))
    assert all(torch.equal(a, b) for a, b in zip(leaves(p2), keep))
    assert all(np.array_equal(a, b) for a, b in zip(arrays, (
        a for e in ds for a in (e.feats, e.lat, e.labels, e.mask))))
    assert not any(x.requires_grad for x in leaves(got2))
    assert int(trainer.opt_state.step) == 3 * (1 if mode == "joint"
                                               else len(ds))
