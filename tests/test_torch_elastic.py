"""The port's elastic runtime (``repro_torch.runtime``) against the
reference, event by event, on the same fleets with the reference's trained
GNN injected into the port.

The scenarios are those of ``tests/test_elastic_edges.py`` (failures that
span groups, a whole group lost, cascading failures, a failure while a task
waits for capacity, then joins), plus a plain join, a leave, an externally
committed assignment and a fused-aggregation (``use_pallas``) runtime. After
every event the groups, deferrals, stage orders, log, epoch, report and
graph must equal the reference's exactly: the GNN's argmax decides the
groups, and the parity of its logits (1e-5) is held in ``test_torch_plan.py``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.core import assign as jassign
from repro.core import cost_model as jcm
from repro.core import graph as jgraph
from repro.core import train as jtrain
from repro.runtime import ElasticRuntime as JRuntime
from repro.runtime import FailureEvent as JFailure
from repro_torch.core import assign as tassign
from repro_torch.core import cost_model as tcm
from repro_torch.core import gnn as tgnn
from repro_torch.core import graph as tgraph
from repro_torch.runtime import ElasticRuntime as TRuntime
from repro_torch.runtime import FailureEvent as TFailure

TWO = ("GPT-2", "BERT-large")          # the test_elastic_edges task sets
STARVED = ("OPT-175B", "BERT-large")


def _tasks(cm, names):
    by_name = {t.name: t for t in cm.FOUR_TASKS}
    return [by_name[n] for n in names]


def _train(names):
    """test_elastic_edges._gnn: the reference trained on two 12-node fleets."""
    tasks = _tasks(jcm, names)
    cfg = jtrain.gnn_config_for(tasks)
    ds = jtrain.make_dataset(2, tasks, n_nodes=12, seed=7, label_frac=0.8)
    params, _ = jtrain.train_gnn(cfg, ds, steps=60, lr=0.01)
    tparams = tgnn.params_from_numpy(jax.tree.map(np.asarray, params),
                                     device="cpu")
    return params, cfg, tparams, tgnn.GNNConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def both():
    return {names: _train(names) for names in (TWO, STARVED)}


class Pair:
    """One runtime per package, driven by the same events."""

    def __init__(self, both, names, n_machines=8, use_pallas=False):
        params, cfg, tparams, tcfg = both[names]
        cfg = dataclasses.replace(cfg, use_pallas=use_pallas)
        tcfg = dataclasses.replace(tcfg, use_pallas=use_pallas)
        fleet = lambda g: self._lan_fleet(g, n_machines)
        self.ref = JRuntime(fleet(jgraph), _tasks(jcm, names), params, cfg)
        self.port = TRuntime(fleet(tgraph), _tasks(tcm, names), tparams, tcfg)
        self.check()

    @staticmethod
    def _lan_fleet(g, n):
        machines = [g.Machine("California", "A100", 8) for _ in range(n)]
        return g.ClusterGraph(machines,
                              g._latency_matrix(machines,
                                                np.random.default_rng(0)))

    def check(self):
        r, p = self.ref, self.port
        assert p.assignment.groups == r.assignment.groups
        assert p.assignment.deferred == r.assignment.deferred
        assert p.assignment.stage_order == r.assignment.stage_order
        assert p.log == r.log
        assert p.state.epoch == r.state.epoch
        assert np.array_equal(p.graph.latency, r.graph.latency)
        assert ([dataclasses.astuple(m) for m in p.graph.machines]
                == [dataclasses.astuple(m) for m in r.graph.machines])
        if not r.assignment.deferred:
            for comm in ("paper", "alphabeta"):
                assert p.makespan(comm) == r.makespan(comm)

    def fail(self, ids, at_step=0):
        got = self.port.on_failure(TFailure(failed_ids=list(ids),
                                            at_step=at_step))
        want = self.ref.on_failure(JFailure(failed_ids=list(ids),
                                            at_step=at_step))
        assert got == want
        self.check()
        return want

    def join(self, region="California", gpu="A100", latencies=None):
        got = self.port.on_join(tgraph.Machine(region, gpu, 8), latencies)
        want = self.ref.on_join(jgraph.Machine(region, gpu, 8), latencies)
        assert got == want
        self.check()
        return want

    def leave(self, ids, at_step=0):
        got = self.port.on_leave(ids, at_step)
        want = self.ref.on_leave(ids, at_step)
        assert got == want
        self.check()
        return want


def _across_groups(pair):
    victims = [ids[0] for ids in pair.ref.assignment.groups.values()]
    rep = pair.fail(victims, at_step=50)
    assert set(rep["affected_tasks"]) == set(TWO) and rep["epoch"] == 1


def _whole_group(pair):
    groups = pair.ref.assignment.groups
    victim = min(groups, key=lambda k: len(groups[k]))
    rep = pair.fail(groups[victim], at_step=10)
    assert victim in rep["affected_tasks"] and pair.ref.group_of(victim)


def _cascade(pair):
    for step in range(3):
        pair.fail([0], at_step=step)
    assert pair.ref.graph.n == 5 and pair.ref.state.epoch == 3


def _join(pair):
    pair.join()
    pair.join("Tokyo", "V100")
    pair.join("London", "A40", latencies={0: 40.0, 3: 55.0})


def _leave(pair):
    spare = sorted(set(range(pair.ref.graph.n))
                   - {i for ids in pair.ref.assignment.groups.values()
                      for i in ids})
    busy = max(pair.ref.assignment.groups.values(), key=len)
    rep = pair.leave((spare + busy)[:2], at_step=7)
    assert rep["event"] == "leave" and rep["restore_from_checkpoint"] == []


def _commit(pair):
    ref, port = pair.ref, pair.port
    smaller = ref.graph.subgraph(range(6))
    want = jassign.replan_with_deferral(smaller, ref.tasks, ref.params,
                                        ref.cfg)
    got = tassign.replan_with_deferral(port.graph.subgraph(range(6)),
                                       port.tasks, port.params, port.cfg)
    assert (got.groups, got.deferred) == (want.groups, want.deferred)
    port.commit_assignment(got, graph=port.graph.subgraph(range(6)),
                           reason="sim_refine")
    ref.commit_assignment(want, graph=smaller, reason="sim_refine")
    pair.check()
    port.commit_assignment(port.assignment)
    ref.commit_assignment(ref.assignment)
    pair.check()
    assert ref.state.epoch == 2 and ref.log[-1]["event"] == "refine"


SCENARIOS = {
    "failure_across_groups": (TWO, _across_groups),
    "whole_group_loss": (TWO, _whole_group),
    "cascading_failures": (TWO, _cascade),
    "join": (TWO, _join),
    "leave": (TWO, _leave),
    "commit_assignment": (TWO, _commit),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_runtime_matches_reference(scenario, both):
    names, drive = SCENARIOS[scenario]
    drive(Pair(both, names))


def test_failure_while_deferred_then_joins_match_reference(both):
    """OPT-175B waits on five machines; a failure keeps it waiting, and the
    two joins that follow re-plan until everything is placed."""
    pair = Pair(both, STARVED, n_machines=5)
    assert pair.ref.assignment.deferred
    rep = pair.fail([0], at_step=5)
    assert len(rep["deferred"]) == 1
    assert pair.join()["rebalanced"] is True
    assert pair.join()["rebalanced"] is True
    assert pair.ref.assignment.deferred == []


def test_fused_aggregation_runtime_matches_reference(both):
    """``use_pallas``: the reference's Pallas kernel (interpret mode here)
    against the port's ``gcn_spmm`` wrapper, which runs its plain version
    on CPU tensors."""
    pair = Pair(both, TWO, use_pallas=True)
    _across_groups(pair)
    pair.join()
