"""The port's simulator-in-the-loop labels (``repro_torch.core.labels``, the
sim half, and ``core.train.make_example`` / ``make_dataset`` with
``label_mode="sim"``) against the reference's, bit for bit.

These are numpy end to end (the simulator scores each candidate partition),
so labels, masks, v2 features, simulated makespans and the
``plan.sim_search.*`` counters must all be equal, with no params seeded.
"""
import math

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro import obs as jobs
from repro.core import graph as jgraph
from repro.core import labels as jlabels
from repro.core import train as jtrain
from repro.sim import scenarios as jsc
from repro.sim.compute import JitterConfig as JJitter
from repro_torch import obs as tobs
from repro_torch.core import graph as tgraph
from repro_torch.core import labels as tlabels
from repro_torch.core import train as ttrain
from repro_torch.core.graph import feature_dim
from repro_torch.sim import scenarios as tsc
from repro_torch.sim.compute import JitterConfig as TJitter

JIT = dict(sigma=0.3, straggler_frac=0.25, straggler_slowdown=3.0)

# (graph module, labels, train, scenarios, jitter config class, obs)
REF = (jgraph, jlabels, jtrain, jsc, JJitter(**JIT), jobs)
PORT = (tgraph, tlabels, ttrain, tsc, TJitter(**JIT), tobs)


def _both(fn):
    return fn(*REF), fn(*PORT)


@pytest.mark.parametrize("seed", [0, 1])
def test_simulated_makespan_matches_reference(seed):
    def run(g, labels, train, sc, jit, obs):
        fleet = g.random_fleet(10, seed=seed)
        tasks = list(sc.SIM_TASKS)
        analytic = labels.oracle_labels(fleet, tasks, seed=seed)
        return [labels.simulated_makespan(fleet, analytic, tasks, seed=seed,
                                          jitter=j, steps=steps)
                for j in (None, jit) for steps in (1, 2)]
    ref, port = _both(run)
    assert port == ref and all(math.isfinite(x) for x in port)


def test_simulated_makespan_of_an_infeasible_partition_is_inf():
    def run(g, labels, train, sc, jit, obs):
        fleet = g.random_fleet(6, seed=0)
        tasks = list(sc.SIM_TASKS)
        empty = np.full(fleet.n, labels.idle_class(tasks), np.int64)
        return labels.simulated_makespan(fleet, empty, tasks)
    ref, port = _both(run)
    assert port == ref == np.inf


def _search(fn_name, **kw):
    def run(g, labels, train, sc, jit, obs):
        fleet = g.random_fleet(8, seed=1)
        tasks = list(sc.SIM_TASKS)
        start = labels.oracle_labels(fleet, tasks, seed=1)
        rec = obs.Recorder()
        with obs.recording(rec):
            out = getattr(labels, fn_name)(fleet, start, tasks, iters=12,
                                           seed=1, jitter=jit, **kw)
        return out, rec.metrics.snapshot()
    return run


@pytest.mark.parametrize("sweep", [True, False])
def test_sim_local_search_matches_reference(sweep):
    (jlab, jmetrics), (tlab, tmetrics) = _both(_search("sim_local_search",
                                                       sweep=sweep))
    assert tlab.dtype == jlab.dtype and np.array_equal(tlab, jlab)
    assert tmetrics == jmetrics
    assert tmetrics["counters"]["plan.sim_search.sims"] > 0
    # the port's own readable reference gives the same labels, uncounted
    tref, tref_metrics = _search("sim_local_search_reference",
                                 sweep=sweep)(*PORT)
    assert np.array_equal(tref, tlab)
    assert not any(k.startswith("plan.sim_search")
                   for k in tref_metrics["counters"])


def test_sim_local_search_reference_matches_reference():
    (jlab, _), (tlab, _) = _both(_search("sim_local_search_reference"))
    assert np.array_equal(tlab, jlab)


def test_sim_refined_labels_match_reference():
    def run(g, labels, train, sc, jit, obs):
        fleet = g.random_fleet(10, seed=0)
        tasks = list(sc.SIM_TASKS)
        return labels.sim_refined_labels(fleet, tasks, seed=0, jitter=jit)
    ref, port = _both(run)
    assert np.array_equal(port, ref)


def _example_fields(ex) -> list:
    return [ex.feats, ex.lat, ex.labels, ex.mask]


def test_make_example_sim_matches_reference():
    def run(g, labels, train, sc, jit, obs):
        fleet = g.random_fleet(10, seed=3)
        return train.make_example(fleet, list(sc.SIM_TASKS), seed=3,
                                  label_frac=0.8, label_mode="sim",
                                  jitter=jit)
    ref, port = _both(run)
    assert port.feats.shape[1] == feature_dim(2)      # v2 by default
    for t, j in zip(_example_fields(port), _example_fields(ref)):
        assert t.dtype == j.dtype and np.array_equal(t, j)


def test_make_example_sim_with_traffic_and_v1_features_matches_reference():
    def run(g, labels, train, sc, jit, obs):
        fleet = g.random_fleet(8, seed=2)
        return train.make_example(fleet, list(sc.SIM_TASKS), seed=2,
                                  label_mode="sim", jitter=jit,
                                  traffic=sc.diurnal_traffic(depth=0.6),
                                  feature_version=1)
    ref, port = _both(run)
    assert port.feats.shape[1] == feature_dim(1)
    for t, j in zip(_example_fields(port), _example_fields(ref)):
        assert np.array_equal(t, j)


def test_make_dataset_sim_matches_reference():
    """``trained_gnn(label_mode="sim")``'s dataset for drift_gray_creep."""
    def run(g, labels, train, sc, jit, obs):
        scn = sc.get_drift_scenario("drift_gray_creep")
        return train.make_dataset(6, list(scn.tasks), n_nodes=12, seed=11,
                                  label_frac=0.9, label_mode="sim",
                                  jitter=scn.jitter, traffic=scn.traffic,
                                  comm_model=scn.comm_model)
    ref, port = _both(run)
    assert len(port) == len(ref) == 6
    for tex, jex in zip(port, ref):
        for t, j in zip(_example_fields(tex), _example_fields(jex)):
            assert t.dtype == j.dtype and np.array_equal(t, j)


def test_make_dataset_analytic_is_unchanged_by_the_sim_arguments():
    tasks = list(tsc.SIM_TASKS)
    plain = ttrain.make_dataset(2, tasks, n_nodes=10, seed=4)
    knobs = ttrain.make_dataset(2, tasks, n_nodes=10, seed=4,
                                jitter=TJitter(**JIT), comm_model="paper")
    ref = jtrain.make_dataset(2, list(jsc.SIM_TASKS), n_nodes=10, seed=4)
    for a, b, r in zip(plain, knobs, ref):
        for x, y, z in zip(_example_fields(a), _example_fields(b),
                           _example_fields(r)):
            assert np.array_equal(x, y) and np.array_equal(x, z)
    assert plain[0].feats.shape[1] == feature_dim(1)


def test_make_example_rejects_unknown_mode():
    with pytest.raises(ValueError, match="label_mode"):
        ttrain.make_example(tgraph.random_fleet(8, seed=0),
                            list(tsc.SIM_TASKS), label_mode="psychic")
