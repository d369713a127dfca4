"""The port's numpy modules against the reference, bit for bit: graphs and
features, the cost model, the analytic labelers and the pod-level plan."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.core import cost_model as jcm
from repro.core import graph as jgraph
from repro.core import labels as jlabels
from repro.core import placement as jplacement
from repro_torch.core import cost_model as tcm
from repro_torch.core import graph as tgraph
from repro_torch.core import labels as tlabels
from repro_torch.core import placement as tplacement

SEEDS = [0, 1, 2]


def _pair(kind, seed):
    """The same graph built by both packages."""
    if kind == "fig1":
        return jgraph.paper_fig1_graph(seed), tgraph.paper_fig1_graph(seed)
    if kind == "fleet46":
        return jgraph.paper_fleet46(seed), tgraph.paper_fleet46(seed)
    return jgraph.random_fleet(20, seed), tgraph.random_fleet(20, seed)


def _tasks(kind):
    # the fig1 fleet (~1.6 TB) cannot hold OPT-175B
    if kind == "fig1":
        return jcm.FOUR_TASKS[1:], tcm.FOUR_TASKS[1:]
    return jcm.FOUR_TASKS, tcm.FOUR_TASKS


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", ["fig1", "fleet46", "random"])
def test_graphs_and_features_identical(kind, seed):
    jg, tg = _pair(kind, seed)
    assert np.array_equal(jg.latency, tg.latency)
    assert jg.latency.dtype == tg.latency.dtype
    for version in (1, 2):
        assert np.array_equal(jg.node_features(version),
                              tg.node_features(version))
    assert np.array_equal(jg.memory_gb(), tg.memory_gb())
    assert np.array_equal(jg.tflops(), tg.tflops())
    assert np.array_equal(jg.adjacency_mask(), tg.adjacency_mask())


@pytest.mark.parametrize("seed", SEEDS)
def test_v2_features_with_telemetry_identical(seed):
    jg, tg = _pair("random", seed)
    rng = np.random.default_rng(seed)
    slow = (1.0 + 3.0 * rng.uniform(size=jg.n)).astype(np.float32)
    sigma = rng.uniform(0, 0.3, size=jg.n).astype(np.float32)
    hub = (rng.uniform(size=jg.n) < 0.2).astype(np.float32)
    jt = jg.with_telemetry(jgraph.NodeTelemetry(slow, sigma, hub))
    tt = tg.with_telemetry(tgraph.NodeTelemetry(slow, sigma, hub))
    assert np.array_equal(jt.node_features(2), tt.node_features(2))
    ids = [0, 3, 5, 7]
    assert np.array_equal(jt.subgraph(ids).node_features(2),
                          tt.subgraph(ids).node_features(2))
    assert np.array_equal(jt.remove_machines([1, 2]).latency,
                          tt.remove_machines([1, 2]).latency)


def test_feature_versions_identical():
    for v in (1, 2):
        assert jgraph.feature_dim(v) == tgraph.feature_dim(v)
        assert tgraph.version_for_dim(tgraph.feature_dim(v)) == v
    with pytest.raises(ValueError):
        tgraph.version_for_dim(5)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("comm_model", ["paper", "alphabeta"])
def test_cost_model_step_times_identical(seed, comm_model):
    jg, tg = _pair("fleet46", seed)
    jc, tc = jcm.make_comm(jg, comm_model), tcm.make_comm(tg, comm_model)
    rng = np.random.default_rng(seed)
    groups = [sorted(rng.choice(jg.n, size=k, replace=False).tolist())
              for k in (3, 9, 17, 46)]
    for jt, tt in zip(jcm.SIX_TASKS, tcm.SIX_TASKS):
        assert jt.__dict__ == tt.__dict__
        for ids in groups:
            for strategy in ("dp", "tp", "gpipe"):
                assert (jcm.group_step_time(jg, ids, jt, jc, strategy)
                        == tcm.group_step_time(tg, ids, tt, tc, strategy))
            assert (jcm.greedy_chain_order(jg, ids)
                    == tcm.greedy_chain_order(tg, ids)
                    == tcm.greedy_chain_order_reference(tg, ids))
    split = {t.name: groups[i] for i, t in enumerate(tcm.FOUR_TASKS)}
    jm = jcm.placement_makespan(jg, split, jcm.FOUR_TASKS, jc)
    tm = tcm.placement_makespan(tg, split, tcm.FOUR_TASKS, tc)
    assert jm == tm
    assert np.array_equal(jcm.link_bandwidth_array(jg.latency, comm_model),
                          tcm.link_bandwidth_array(tg.latency, comm_model))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", ["fig1", "fleet46", "random"])
def test_analytic_labels_identical(kind, seed):
    jg, tg = _pair(kind, seed)
    jtasks, ttasks = _tasks(kind)
    j_oracle = jlabels.oracle_labels(jg, jtasks, seed=seed)
    t_oracle = tlabels.oracle_labels(tg, ttasks, seed=seed)
    assert np.array_equal(j_oracle, t_oracle)
    greedy = tlabels.greedy_partition(tg, ttasks, seed=seed)
    assert np.array_equal(jlabels.greedy_partition(jg, jtasks, seed=seed), greedy)
    assert np.array_equal(
        greedy, tlabels.greedy_partition_reference(tg, ttasks, seed=seed))
    refined = tlabels.local_search(tg, greedy, ttasks, iters=60, seed=seed)
    assert np.array_equal(
        jlabels.local_search(jg, greedy, jtasks, iters=60, seed=seed), refined)
    assert np.array_equal(
        refined, tlabels.local_search_reference(tg, greedy, ttasks, iters=60,
                                                seed=seed))
    assert np.array_equal(jlabels.sparse_mask(jg.n, 0.7, seed),
                          tlabels.sparse_mask(tg.n, 0.7, seed))
    assert tlabels.idle_class(ttasks) == jlabels.idle_class(jtasks)


def test_pod_plan_identical():
    lat = np.array([[0, 30, 80], [30, 0, 45], [80, 45, 0]], np.float32)
    jp = [jplacement.PodSpec(f"p{i}", r) for i, r in
          enumerate(["Tokyo", "Berlin", "Rome"])]
    tp = [tplacement.PodSpec(f"p{i}", r) for i, r in
          enumerate(["Tokyo", "Berlin", "Rome"])]
    jg, tg = jplacement.pods_as_graph(jp, lat), tplacement.pods_as_graph(tp, lat)
    assert np.array_equal(jg.node_features(), tg.node_features())
    groups = {"OPT-175B": [0, 1, 2], "T5-11B": [1], "GPT-2": [0, 2]}
    assert ([p.__dict__ for p in jplacement.plan_runtime(jg, groups, jcm.FOUR_TASKS)]
            == [p.__dict__ for p in tplacement.plan_runtime(tg, groups, tcm.FOUR_TASKS)])
