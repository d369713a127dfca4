"""The port's per-bucket cached GNN forward (``core/train.py``) against the
reference's per-bucket ``jax.jit``.

* ``predict_logits`` with ``bucketed=True`` (the padded, cached forward) and
  ``bucketed=False`` (the legacy eager forward on the unpadded graph) give
  the reference's logits at every bucket boundary (n = bucket, bucket ± 1),
  and ``FLAGS["bucketed_predict"]`` picks between them as the reference's
  does.
* ``trace_counts()`` counts one trace per ``(cfg, bucket)`` call for call as
  the reference does, on the reference's own
  ``test_task_assignments_compiles_once_per_bucket`` workload.
* The cache is keyed on shapes, so two param sets under one cfg share a
  forward and each still gets its own logits; a param tree of other dtypes
  gets a forward of its own, as a jax retrace does.
* The recorder's ``plan.jit.bucket{b}.calls`` / ``.compiles`` /
  ``.cache_hits`` equal the reference's, name for name and in order.

Each test starts both packages from an empty forward cache
(``_torch_parity.cold_forwards``). On the CPU the cached forward is the
eager padded forward; the CUDA graph behind it on the card is held to that
forward in ``tests/test_torch_graphs_gpu.py``.
"""
import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from _torch_parity import cold_forwards, to_port
from repro import obs as jobs
from repro.core import assign as jassign
from repro.core import cost_model as jcm
from repro.core import gnn as jgnn
from repro.core import train as jtrain
from repro.core.graph import paper_fleet46 as j_fleet46
from repro.core.graph import random_fleet as j_random_fleet
from repro_torch import obs as tobs
from repro_torch.core import assign as tassign
from repro_torch.core import cost_model as tcm
from repro_torch.core import gnn as tgnn
from repro_torch.core import train as ttrain
from repro_torch.core.graph import paper_fleet46 as t_fleet46
from repro_torch.core.graph import random_fleet as t_random_fleet

LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)   # tests/test_kernels.py's GNN logits


@pytest.fixture(autouse=True)
def _cold():
    cold_forwards()
    jtrain.reset_trace_counts()
    ttrain.reset_trace_counts()
    yield


def _small(hidden: int, seed: int, d_in: int = 12, use_pallas: bool = False):
    """A reference GNN of ``hidden`` units and the same params in the port."""
    cfg = jtrain.gnn_config_for([jcm.GPT2_1_5B, jcm.BERT_LARGE], hidden=hidden,
                                use_pallas=use_pallas)
    params = jgnn.init(jax.random.PRNGKey(seed), cfg, d_in)
    return (params, cfg), to_port(params, cfg)


def _counts(counts: dict, cfg) -> dict:
    return {b: n for (c, b), n in counts.items() if c == cfg}


@pytest.mark.parametrize("bucketed", [True, False])
@pytest.mark.parametrize("n", [7, 8, 9, 15, 16, 17, 31, 32, 33])
def test_predict_logits_match_reference(n, bucketed):
    """``test_fast_path.py::test_bucketed_predict_matches_unpadded`` on both
    packages: each path against the reference's same path, and the padded
    forward against the unpadded one."""
    (jparams, jcfg), (tparams, tcfg) = _small(48, 2)
    jfleet, tfleet = j_random_fleet(n, seed=n), t_random_fleet(n, seed=n)
    want = jtrain.predict_logits(jparams, jcfg, jfleet, bucketed=bucketed)
    got = ttrain.predict_logits(tparams, tcfg, tfleet, bucketed=bucketed,
                                device="cpu")
    assert got.shape == (n, tcfg.n_classes)
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    unpadded = ttrain.predict_logits(tparams, tcfg, tfleet, bucketed=False,
                                     device="cpu")
    np.testing.assert_allclose(got, unpadded, **LOGIT_TOL)
    np.testing.assert_array_equal(
        ttrain.predict(tparams, tcfg, tfleet, bucketed=bucketed, device="cpu"),
        jtrain.predict(jparams, jcfg, jfleet, bucketed=bucketed))
    # only the cached path traces, once, at the graph's bucket
    want_counts = {ttrain.bucket_for(n): 1} if bucketed else {}
    assert _counts(ttrain.trace_counts(), tcfg) == want_counts
    assert _counts(jtrain.trace_counts(), jcfg) == want_counts


@pytest.mark.parametrize("flag", [True, False])
def test_flags_pick_the_path_as_the_reference_does(flag):
    """``bucketed=None`` reads ``FLAGS["bucketed_predict"]``: off, nothing is
    cached, traced or counted."""
    (jparams, jcfg), (tparams, tcfg) = _small(40, 3)
    jfleet, tfleet = j_random_fleet(13, seed=4), t_random_fleet(13, seed=4)
    saved = (jtrain.FLAGS["bucketed_predict"], ttrain.FLAGS["bucketed_predict"])
    jrec, trec = jobs.Recorder(), tobs.Recorder()
    try:
        jtrain.FLAGS["bucketed_predict"] = ttrain.FLAGS["bucketed_predict"] = flag
        with jobs.recording(jrec):
            want = jtrain.predict_logits(jparams, jcfg, jfleet)
        with tobs.recording(trec):
            got = ttrain.predict_logits(tparams, tcfg, tfleet, device="cpu")
    finally:
        jtrain.FLAGS["bucketed_predict"], ttrain.FLAGS["bucketed_predict"] = saved
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    assert trec.metrics.snapshot() == jrec.metrics.snapshot()
    assert _counts(ttrain.trace_counts(), tcfg) \
        == _counts(jtrain.trace_counts(), jcfg) == ({16: 1} if flag else {})
    assert bool(ttrain._FORWARDS) == flag


def test_task_assignments_trace_counts_match_reference():
    """``test_fast_path.py::test_task_assignments_compiles_once_per_bucket``:
    the same fleet, tasks and cfg, the reference's trained params in both;
    the port traces what the reference traces, per bucket."""
    tasks = jcm.FOUR_TASKS[1:]
    cfg = jtrain.gnn_config_for(tasks, hidden=37)
    ds = jtrain.make_dataset(2, tasks, n_nodes=24, seed=11, label_frac=0.8)
    params, _ = jtrain.train_gnn(cfg, ds, steps=3, lr=0.01)
    tparams, tcfg = to_port(params, cfg)
    ja = jassign.task_assignments(j_random_fleet(24, seed=6), tasks, params, cfg)
    ta = tassign.task_assignments(t_random_fleet(24, seed=6), tcm.FOUR_TASKS[1:],
                                  tparams, tcfg)
    assert ta.groups == ja.groups
    want = _counts(jtrain.trace_counts(), cfg)
    got = _counts(ttrain.trace_counts(), tcfg)
    assert got == want and want
    assert all(c <= 1 for c in got.values()), got
    assert set(got) <= {8, 16, 32}, got


def test_two_param_sets_under_one_cfg_get_their_own_logits():
    """One cached forward serves every param set of its shapes: the second
    set is a cache hit and still gets its own logits, and so does the first
    one again."""
    (jp1, jcfg), (p1, tcfg) = _small(32, 5)
    (jp2, _), (p2, _) = _small(32, 6)
    jfleet, tfleet = j_random_fleet(20, seed=8), t_random_fleet(20, seed=8)
    for jp, tp in ((jp1, p1), (jp2, p2), (jp1, p1)):
        want = jtrain.predict_logits(jp, jcfg, jfleet)
        got = ttrain.predict_logits(tp, tcfg, tfleet, device="cpu")
        np.testing.assert_allclose(got, want, **LOGIT_TOL)
        np.testing.assert_allclose(
            got, ttrain.predict_logits(tp, tcfg, tfleet, bucketed=False,
                                       device="cpu"), **LOGIT_TOL)
    l1 = ttrain.predict_logits(p1, tcfg, tfleet, device="cpu")
    l2 = ttrain.predict_logits(p2, tcfg, tfleet, device="cpu")
    assert np.abs(l1 - l2).max() > 1e-3
    assert _counts(ttrain.trace_counts(), tcfg) \
        == _counts(jtrain.trace_counts(), jcfg) == {32: 1}


def test_param_key_order_does_not_retrace():
    """A tree from ``gnn.init`` (the reference's key order) and one from
    ``params_from_numpy`` (keys sorted, as jax flattens a dict) of the same
    shapes share one forward, as they share one jax trace."""
    (_, jcfg), (sorted_tree, tcfg) = _small(24, 7)
    fresh = tgnn.init(tcfg, 12, seed=1, device="cpu")
    assert list(fresh["edge_pool"]) != list(sorted_tree["edge_pool"])
    fleet = t_random_fleet(10, seed=1)
    for tree in (sorted_tree, fresh):
        np.testing.assert_allclose(
            ttrain.predict_logits(tree, tcfg, fleet, device="cpu"),
            ttrain.predict_logits(tree, tcfg, fleet, bucketed=False,
                                  device="cpu"), **LOGIT_TOL)
    assert _counts(ttrain.trace_counts(), tcfg) == {16: 1}


def test_other_param_dtypes_trace_anew():
    """A param tree of other dtypes is a new signature: a forward of its
    own, counted as a trace under the same ``(cfg, bucket)``."""
    (_, _), (tparams, tcfg) = _small(24, 9)
    f32, traced = ttrain._bucketed_forward(tcfg, 16, tparams, 12)
    assert traced
    assert ttrain._bucketed_forward(tcfg, 16, tparams, 12) == (f32, False)
    bf16 = dict(tparams)
    bf16["head"] = {k: v.to(torch.bfloat16) for k, v in tparams["head"].items()}
    other, traced = ttrain._bucketed_forward(tcfg, 16, bf16, 12)
    assert traced and other is not f32
    assert ttrain.trace_counts() == {(tcfg, 16): 2}


@pytest.mark.parametrize("use_pallas", [False, True])
def test_jit_metrics_match_reference(use_pallas):
    """Two fleet46 plans and a recovery under one recorder in each package:
    ``plan.jit.bucket{b}.calls`` on every call, ``.compiles`` on a trace,
    ``.cache_hits`` otherwise, the same names in the same order. The second
    plan is all cache hits. ``use_pallas`` runs the reference's Pallas
    kernel in interpret mode and the port's plain ``scaled_spmm``."""
    (jparams, jcfg), (tparams, tcfg) = _small(64, 11, d_in=12,
                                              use_pallas=use_pallas)
    tasks_j, tasks_t = jcm.FOUR_TASKS, tcm.FOUR_TASKS

    def run(obs, assign, fleet, tasks, params, cfg):
        rec = obs.Recorder()
        stream = []
        rec.subscribe(lambda kind, name, v: stream.append((kind, name, v)))
        with obs.recording(rec):
            for _ in range(2):
                a = assign.task_assignments(fleet, tasks, params, cfg)
            assign.recover(fleet, a, max(a.groups.values(), key=len)[1:],
                           tasks, params, cfg)
        jit = [x for x in stream if x[1].startswith("plan.jit.")]
        return a.groups, jit

    jgroups, jstream = run(jobs, jassign, j_fleet46(), tasks_j, jparams, jcfg)
    tgroups, tstream = run(tobs, tassign, t_fleet46(), tasks_t, tparams, tcfg)
    assert tgroups == jgroups
    assert tstream == jstream
    names = {x[1].rsplit(".", 1)[1] for x in jstream}
    assert names == {"calls", "compiles", "cache_hits"}
    assert _counts(ttrain.trace_counts(), tcfg) \
        == _counts(jtrain.trace_counts(), jcfg)
