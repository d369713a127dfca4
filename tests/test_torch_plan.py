"""The port's planner against the reference on the JAX-trained full-width
GNN (the ``trained_gnn`` fixture), its weights injected into the port:
logits, Algorithm 1 groups, recovery and the Systems A/B/C comparison.

Groups are compared exactly. An argmax that flips near a tie would show as
a group difference; ``_ties`` reports how close the nearest call was, so such
a failure names itself instead of being absorbed by a looser check."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.core import assign as jassign
from repro.core import baselines as jbaselines
from repro.core import train as jtrain
from repro.core.graph import paper_fig1_graph as j_fig1
from repro_torch.core import assign as tassign
from repro_torch.core import baselines as tbaselines
from repro_torch.core import cost_model as tcm
from repro_torch.core import gnn as tgnn
from repro_torch.core import placement as tplacement
from repro_torch.core import train as ttrain
from repro_torch.core.graph import paper_fig1_graph as t_fig1
from repro_torch.core.graph import paper_fleet46 as t_fleet46

LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def both(trained_gnn):
    params, cfg, _ = trained_gnn
    tparams = tgnn.params_from_numpy(jax.tree.map(np.asarray, params),
                                     device="cpu")
    tcfg = tgnn.GNNConfig(**dataclasses.asdict(cfg))
    return params, cfg, tparams, tcfg


def _cases(fleet46):
    from repro.core import cost_model as jcm
    # the fig1 fleet (~1.6 TB) cannot hold OPT-175B
    return {"fleet46": (fleet46, t_fleet46(), jcm.FOUR_TASKS, tcm.FOUR_TASKS),
            "fig1": (j_fig1(), t_fig1(), jcm.FOUR_TASKS[1:], tcm.FOUR_TASKS[1:])}


def _ties(logits: np.ndarray) -> float:
    """Smallest gap between a node's top two logits."""
    top2 = np.sort(logits, axis=-1)[:, -2:]
    return float((top2[:, 1] - top2[:, 0]).min())


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("case", ["fleet46", "fig1"])
def test_predict_logits_match_reference(case, use_pallas, both, fleet46):
    params, cfg, tparams, tcfg = both
    jg, tg, _, _ = _cases(fleet46)[case]
    cfg = dataclasses.replace(cfg, use_pallas=use_pallas)
    tcfg = dataclasses.replace(tcfg, use_pallas=use_pallas)
    want = jtrain.predict_logits(params, cfg, jg)
    got = ttrain.predict_logits(tparams, tcfg, tg, device="cpu")
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    same = np.array_equal(got.argmax(-1), want.argmax(-1))
    assert same, f"argmax flipped; nearest top-2 gap {_ties(want):.2e}"


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("case", ["fleet46", "fig1"])
def test_task_assignments_and_baselines_match_reference(case, use_pallas, both,
                                                        fleet46):
    params, cfg, tparams, tcfg = both
    jg, tg, jtasks, ttasks = _cases(fleet46)[case]
    cfg = dataclasses.replace(cfg, use_pallas=use_pallas)
    tcfg = dataclasses.replace(tcfg, use_pallas=use_pallas)
    want = jassign.task_assignments(jg, jtasks, params, cfg)
    got = tassign.task_assignments(tg, ttasks, tparams, tcfg)
    gap = _ties(jtrain.predict_logits(params, cfg, jg))
    assert got.groups == want.groups, f"nearest top-2 logit gap {gap:.2e}"
    assert got.deferred == want.deferred
    assert got.stage_order == want.stage_order

    jrows = jbaselines.compare_all(jg, jtasks, params, cfg)
    trows = tbaselines.compare_all(tg, ttasks, tparams, tcfg)
    for name in ("Hulk", "SystemA", "SystemB", "SystemC"):
        for key in ("total", "comm", "compute"):
            np.testing.assert_allclose(float(trows[name][key]),
                                       float(jrows[name][key]), rtol=1e-6)
    np.testing.assert_allclose(float(trows["improvement_vs_best_baseline"]),
                               float(jrows["improvement_vs_best_baseline"]),
                               rtol=1e-6)
    plan = tplacement.plan_runtime(tg, got.groups, ttasks)
    assert [p.task for p in plan] == list(got.groups)


def test_recover_matches_reference(both, fleet46, four_tasks):
    params, cfg, tparams, tcfg = both
    tfleet = t_fleet46()
    ja = jassign.task_assignments(fleet46, four_tasks, params, cfg)
    ta = tassign.task_assignments(tfleet, tcm.FOUR_TASKS, tparams, tcfg)
    failed = max(ja.groups.values(), key=len)[:2]
    jsurv, jnew = jassign.recover(fleet46, ja, failed, four_tasks, params, cfg)
    tsurv, tnew = tassign.recover(tfleet, ta, failed, tcm.FOUR_TASKS, tparams,
                                  tcfg)
    assert np.array_equal(jsurv.latency, tsurv.latency)
    assert tnew.groups == jnew.groups
    assert tnew.deferred == jnew.deferred
    assert tnew.stage_order == jnew.stage_order


def test_replan_helpers_match_reference(both, fleet46, four_tasks):
    params, cfg, tparams, tcfg = both
    ja = jassign.task_assignments(fleet46, four_tasks, params, cfg)
    moved = {k: v[1:] for k, v in ja.groups.items()}
    moved["GPT-2"] = moved.get("GPT-2", []) + [45]
    assert tassign.plan_delta(ja.groups, moved) == jassign.plan_delta(ja.groups, moved)
    for strategies in (None, {"GPT-2": "dp", "OPT-175B": "gpipe"}):
        assert (tassign.migration_moves(ja.groups, moved, tcm.FOUR_TASKS, strategies)
                == jassign.migration_moves(ja.groups, moved, four_tasks, strategies))
    # a fleet short of capacity defers the largest tasks instead of raising
    jsmall, tsmall = fleet46.subgraph(range(10)), t_fleet46().subgraph(range(10))
    jr = jassign.replan_with_deferral(jsmall, four_tasks, params, cfg)
    tr = tassign.replan_with_deferral(tsmall, tcm.FOUR_TASKS, tparams, tcfg)
    assert (tr.groups, tr.deferred) == (jr.groups, jr.deferred)
    with pytest.raises(tassign.PlacementError):
        tassign.task_assignments(t_fig1(), tcm.FOUR_TASKS, tparams, tcfg)
