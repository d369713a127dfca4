"""The port's GNN, AdamW and trainer against the reference, from the same
(injected) reference params: ``jax.random`` and ``torch.Generator`` draw
different numbers, so two independent inits are never compared."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.core import gnn as jgnn
from repro.core import train as jtrain
from repro.core.graph import random_fleet as j_random_fleet
from repro.training import optimizer as jopt
from repro_torch._tree import leaves
from repro_torch.core import gnn as tgnn
from repro_torch.core import train as ttrain
from repro_torch.training import optimizer as topt

LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)   # tests/test_kernels.py:144
HIST_TOL = 1e-4

# one compile per shape instead of one per eager op
j_apply = jax.jit(jgnn.apply, static_argnums=1)
j_loss = jax.jit(jgnn.loss_fn, static_argnums=1)
j_adamw = jax.jit(jopt.adamw_update, static_argnums=0)


def _ref_params(cfg, d_in, seed=0):
    p = jgnn.init(jax.random.PRNGKey(seed), cfg, d_in)
    return p, tgnn.params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")


def _graph_inputs(n, padded):
    g = j_random_fleet(n, seed=3)
    if padded:
        feats, lat, node_mask = jtrain._pad_graph(g)
        return feats, lat, node_mask
    return g.node_features(), g.latency.astype(np.float32), None


def _tt(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _jj(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("hidden", [213, 16])
def test_apply_matches_reference(hidden, use_pallas, padded):
    cfg = jgnn.GNNConfig(hidden=hidden, n_classes=5, use_pallas=use_pallas)
    tcfg = tgnn.GNNConfig(hidden=hidden, n_classes=5, use_pallas=use_pallas)
    feats, lat, node_mask = _graph_inputs(27, padded)
    jp, tp = _ref_params(cfg, feats.shape[1])
    want = j_apply(jp, cfg, _jj(feats), _jj(lat), node_mask=_jj(node_mask))
    got = tgnn.apply(tp, tcfg, _tt(feats), _tt(lat), node_mask=_tt(node_mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def test_padding_is_inert():
    """Bucket-padded logits equal the unpadded graph's on the real rows."""
    tcfg = tgnn.GNNConfig(hidden=32, n_classes=5, use_pallas=True)
    feats, lat, _ = _graph_inputs(27, False)
    pf, pl, nm = _graph_inputs(27, True)
    tp = tgnn.init(tcfg, feats.shape[1], device="cpu")
    plain = tgnn.apply(tp, tcfg, _tt(feats), _tt(lat))
    padded = tgnn.apply(tp, tcfg, _tt(pf), _tt(pl), node_mask=_tt(nm))
    torch.testing.assert_close(padded[:27], plain, **LOGIT_TOL)


@pytest.mark.parametrize("padded", [False, True])
def test_loss_fn_matches_reference(padded):
    cfg = jgnn.GNNConfig(hidden=24, n_classes=5)
    tcfg = tgnn.GNNConfig(hidden=24, n_classes=5)
    feats, lat, node_mask = _graph_inputs(19, padded)
    n = feats.shape[0]
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 5, n)
    lmask = (rng.uniform(size=n) < 0.6).astype(np.float32)
    if node_mask is not None:
        lmask = lmask * node_mask
    jp, tp = _ref_params(cfg, feats.shape[1])
    jl, jm = j_loss(jp, cfg, _jj(feats), _jj(lat), _jj(labels),
                          _jj(lmask), node_mask=_jj(node_mask))
    tl, tm = tgnn.loss_fn(tp, tcfg, _tt(feats), _tt(lat), _tt(labels),
                          _tt(lmask), node_mask=_tt(node_mask))
    assert abs(float(jl) - tl.item()) <= 1e-5 * max(1.0, abs(float(jl)))
    assert float(jm["accuracy"]) == tm["accuracy"].item()


def test_init_keeps_the_reference_tree_and_distributions():
    cfg = jgnn.GNNConfig()
    jp, _ = _ref_params(cfg, 12)
    tp = tgnn.init(tgnn.GNNConfig(), 12, seed=0, device="cpu")
    shapes = lambda tree: jax.tree.map(lambda x: tuple(x.shape), tree)
    assert shapes(jax.tree.map(np.asarray, jp)) == shapes(tgnn.params_to_numpy(tp))
    assert tgnn.n_params(tp) == jgnn.n_params(jp)
    assert tgnn.d_in_of(tp) == jgnn.d_in_of(jp) == 12
    bound = 1.0 / np.sqrt(12)
    w = tp["edge_pool"]["w_self"]
    assert w.abs().max().item() <= bound and w.std().item() > bound / 3
    assert tp["gcn"][1]["w"].abs().max().item() <= 1.0 / np.sqrt(cfg.hidden)
    assert 0.05 < tp["edge_pool"]["w_edge"].std().item() < 0.2
    assert all(not t.any() for t in (tp["edge_pool"]["bias"], tp["head"]["bias"],
                                     tp["gcn"][0]["bias"]))
    again = tgnn.init(tgnn.GNNConfig(), 12, seed=0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(leaves(tp), leaves(again)))


def test_params_from_numpy_takes_bf16_leaves_exactly():
    """A bf16 JAX tree (``np.asarray`` gives ``ml_dtypes.bfloat16`` leaves)
    comes over by bit pattern and goes back exactly."""
    jp, _ = _ref_params(jgnn.GNNConfig(hidden=16, n_classes=3), 12)
    jp16 = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp)
    tp = tgnn.params_from_numpy(jax.tree.map(np.asarray, jp16), device="cpu")
    assert all(t.dtype == torch.bfloat16 for t in leaves(tp))
    back = tgnn.params_to_numpy(tp)
    for want, got in zip(jax.tree.leaves(jp16), jax.tree.leaves(back)):
        np.testing.assert_array_equal(got, np.asarray(want, np.float32))
        assert (jnp.asarray(got).astype(jnp.bfloat16) == want).all()


ADAM_CASES = {
    "paper": dict(learning_rate=0.01, weight_decay=0.0, b2=0.999,
                  grad_clip_norm=0.0),
    "decay_clip": dict(learning_rate=3e-3, weight_decay=0.1, grad_clip_norm=1.0),
    "warmup_cosine": dict(learning_rate=1e-2, warmup_steps=3, total_steps=8),
    "bf16_moments": dict(learning_rate=1e-3, moment_dtype="bfloat16"),
}


@pytest.mark.parametrize("case", sorted(ADAM_CASES))
def test_adamw_matches_reference(case):
    kw = ADAM_CASES[case]
    jcfg, tcfg = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    gcfg = jgnn.GNNConfig(hidden=8, n_classes=3)
    jp, tp = _ref_params(gcfg, 12)
    js = jopt.adamw_init(jp, jcfg.moment_dtype)
    ts = topt.adamw_init(tp, tcfg.moment_dtype)
    rng = np.random.default_rng(1)
    for _ in range(10):
        g = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32),
                         jax.tree.map(np.asarray, jp))
        jp, js, jm = j_adamw(jcfg, jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts, tm = topt.adamw_update(
            tcfg, tgnn.params_from_numpy(g, device="cpu"), ts, tp)
        for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, jp)),
                        jax.tree.leaves(tgnn.params_to_numpy(tp))):
            np.testing.assert_allclose(b, a, rtol=HIST_TOL, atol=HIST_TOL)
        assert abs(float(jm["lr"]) - tm["lr"].item()) <= 1e-9
        assert abs(float(jm["grad_norm"]) - tm["grad_norm"].item()) <= 1e-4
    assert int(js.step) == int(ts.step) == 10
    mdt = torch.bfloat16 if kw.get("moment_dtype") == "bfloat16" else torch.float32
    assert ts.mu["head"]["w"].dtype == mdt


def test_decay_mask_and_sgd_match_reference():
    for path in [("edge_pool", "w_self"), ("edge_pool", "bias"),
                 ("gcn", 0, "w"), ("gcn", 1, "bias"), ("ln_1", "scale")]:
        jpath = [jax.tree_util.SequenceKey(k) if isinstance(k, int)
                 else jax.tree_util.DictKey(k) for k in path]
        assert topt._decay_mask(path) == jopt._decay_mask(jpath)
    gcfg = jgnn.GNNConfig(hidden=8, n_classes=3)
    jp, tp = _ref_params(gcfg, 12)
    g = jax.tree.map(lambda x: np.full(x.shape, 0.5, np.float32),
                     jax.tree.map(np.asarray, jp))
    want = jopt.sgd_update(0.1, jax.tree.map(jnp.asarray, g), jp)
    got = topt.sgd_update(0.1, tgnn.params_from_numpy(g, device="cpu"), tp)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, want)),
                    jax.tree.leaves(tgnn.params_to_numpy(got))):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def small_dataset():
    from repro.core import cost_model as jcm
    tasks = jcm.FOUR_TASKS
    ds = jtrain.make_dataset(3, tasks, n_nodes=14, seed=5, label_frac=0.7)
    ragged = ds[:2] + jtrain.make_dataset(1, tasks, n_nodes=20, seed=9,
                                          label_frac=0.7)
    return tasks, ds, ragged


def _port_examples(ds):
    return [ttrain.GraphExample(e.feats, e.lat, e.labels, e.mask) for e in ds]


@pytest.mark.parametrize("mode", ["joint", "sequential", "scan", "bucketed"])
def test_train_gnn_history_matches_reference(mode, small_dataset):
    tasks, ds, ragged = small_dataset
    data = ragged if mode == "bucketed" else ds
    cfg = jtrain.gnn_config_for(tasks, hidden=32)
    tcfg = ttrain.gnn_config_for(tasks, hidden=32)
    jp, tp = _ref_params(cfg, data[0].feats.shape[1], seed=2)
    jparams, jhist = jtrain.train_gnn(cfg, data, steps=20, lr=0.01, params=jp,
                                      mode=mode)
    tparams, thist = ttrain.train_gnn(tcfg, _port_examples(data), steps=20,
                                      lr=0.01, params=tp, mode=mode,
                                      device="cpu")
    assert len(thist) == len(jhist) == 20
    for a, b in zip(jhist, thist):
        assert a["step"] == b["step"]
        assert abs(a["loss"] - b["loss"]) <= HIST_TOL
        assert abs(a["accuracy"] - b["accuracy"]) <= HIST_TOL
    assert thist[-1]["loss"] < thist[0]["loss"]
    # the caller's params are copied, never trained in place
    assert np.array_equal(tp["head"]["w"].numpy(), np.asarray(jp["head"]["w"]))
    assert all(not t.requires_grad for t in leaves(tparams))


def test_train_gnn_modes_and_labels_refuse_what_is_not_ported(small_dataset):
    tasks, ds, ragged = small_dataset
    tcfg = ttrain.gnn_config_for(tasks, hidden=8)
    with pytest.raises(ValueError, match="one node bucket"):
        ttrain.train_gnn(tcfg, _port_examples(ragged), steps=1, mode="joint",
                         device="cpu")
    with pytest.raises(ValueError, match="unknown mode"):
        ttrain.train_gnn(tcfg, _port_examples(ds), steps=1, mode="nope",
                         device="cpu")
    from repro_torch.core import cost_model as tcm
    from repro_torch.core.graph import random_fleet
    with pytest.raises(ValueError, match="label_mode"):
        ttrain.make_example(random_fleet(8), tcm.FOUR_TASKS, label_mode="psychic")


def test_make_dataset_and_buckets_match_reference():
    from repro.core import cost_model as jcm
    from repro_torch.core import cost_model as tcm
    jds = jtrain.make_dataset(2, jcm.FOUR_TASKS, n_nodes=12, seed=3)
    tds = ttrain.make_dataset(2, tcm.FOUR_TASKS, n_nodes=12, seed=3)
    for a, b in zip(jds, tds):
        for f in ("feats", "lat", "labels", "mask"):
            assert np.array_equal(getattr(a, f), getattr(b, f))
    for n in (1, 7, 8, 9, 46, 64, 65, 1000, 1024):
        assert ttrain.bucket_for(n) == jtrain.bucket_for(n)
    g = j_random_fleet(13, seed=1)
    from repro_torch.core.graph import random_fleet
    for a, b in zip(jtrain._pad_graph(g, 2), ttrain._pad_graph(random_fleet(13, seed=1), 2)):
        assert np.array_equal(a, b)


def test_predict_feature_version_shim_matches_reference():
    """A v2-width model sees v2 features without the caller asking."""
    from repro_torch.core.graph import random_fleet
    cfg = jgnn.GNNConfig(hidden=16, n_classes=5)
    tcfg = tgnn.GNNConfig(hidden=16, n_classes=5)
    jp, tp = _ref_params(cfg, 15)
    want = jtrain.predict_logits(jp, cfg, j_random_fleet(21, seed=4))
    got = ttrain.predict_logits(tp, tcfg, random_fleet(21, seed=4), device="cpu")
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    assert np.array_equal(
        ttrain.predict(tp, tcfg, random_fleet(21, seed=4), device="cpu"),
        np.argmax(want, -1))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
