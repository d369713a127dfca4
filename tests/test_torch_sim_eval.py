"""The port's fleet evaluation (``repro_torch.sim.evaluate``) against the
reference's, on the scenario registry.

Systems A/B/C are numpy all the way down, so their rows must be equal byte
for byte. The Hulk arm places through the GNN: both packages' caches hold
the reference's trained params (``trained_gnn`` initialises from
``jax.random`` in one package and from a torch generator in the other), and
then its row must be equal too, every metric included (the per-bucket
forward's ``plan.jit.bucket{b}.compiles`` / ``.cache_hits`` count from an
empty forward cache in each package). Every ``FleetSimulation`` run is also compared
through ``repro.sim.chaos.canonical_fleet`` and field by field.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from _torch_parity import as_json, cold, seed_scenario_gnn
from repro.core import graph as jgraph
from repro.core import train as jtrain
from repro.sim import evaluate as jev
from repro.sim import scenarios as jsc
from repro.sim.chaos import canonical_fleet
from repro.sim.compute import ComputeModel as JCompute
from repro.sim.compute import JitterConfig as JJitter
from repro.sim.network import NetworkModel as JNet
from repro_torch.core import gnn as tgnn
from repro_torch.core import graph as tgraph
from repro_torch.core import train as ttrain
from repro_torch.sim import evaluate as tev
from repro_torch.sim import scenarios as tsc
from repro_torch.sim.compute import ComputeModel as TCompute
from repro_torch.sim.compute import JitterConfig as TJitter
from repro_torch.sim.network import NetworkModel as TNet

SYSTEMS = ("Hulk", "SystemA", "SystemB", "SystemC")
def result_fields(res) -> dict:
    return {f.name: getattr(res, f.name) for f in dataclasses.fields(res)}


def _captured_runs(ev, fn):
    """``fn()`` with every ``FleetSimulation.run`` result of ``ev`` kept, in
    order."""
    runs = []
    orig = ev.FleetSimulation.run

    def run(self):
        res = orig(self)
        runs.append(res)
        return res

    ev.FleetSimulation.run = run
    try:
        return fn(), runs
    finally:
        ev.FleetSimulation.run = orig


def _logit_note(ref_params, ref_cfg, name: str) -> str:
    """Both packages' logits on the scenario's fleet: where they differ and
    the smallest top-2 margin, for a message on a flipped argmax."""
    jl = jtrain.predict_logits(ref_params, ref_cfg,
                               jsc.get_scenario(name).fleet(0))
    names = tuple(t.name for t in tsc.get_scenario(name).tasks)
    params, cfg = tev._GNN_CACHE[names, 0, "analytic"]
    tl = ttrain.predict_logits(params, cfg, tsc.get_scenario(name).fleet(0),
                               device="cpu")
    top2 = np.sort(jl, axis=-1)[:, -2:]
    return (f"logits max |ref - port| {np.abs(jl - tl).max():.3g}, smallest "
            f"top-2 margin {float((top2[:, 1] - top2[:, 0]).min()):.3g}")


@pytest.fixture(scope="module")
def evaluated():
    """``evaluate_all(seed=0)`` in both packages, each arm's run kept."""
    ref_params, ref_cfg = seed_scenario_gnn(jsc.get_scenario("cross_region_wan"),
                                        tsc.get_scenario("cross_region_wan"),
                                        "analytic")
    ref, ref_runs = _captured_runs(jev, lambda: cold(
        lambda: jev.evaluate_all(seed=0)))
    port, port_runs = _captured_runs(tev, lambda: cold(
        lambda: tev.evaluate_all(seed=0)))
    names = sorted(jsc.SCENARIOS)
    assert list(ref) == list(port) == names
    assert len(ref_runs) == len(port_runs) == 4 * len(names)
    runs = {(n, s): (ref_runs[4 * i + k], port_runs[4 * i + k])
            for i, n in enumerate(names) for k, s in enumerate(SYSTEMS)}
    return ref, port, runs, (ref_params, ref_cfg)


@pytest.mark.parametrize("system", SYSTEMS)
@pytest.mark.parametrize("name", sorted(jsc.SCENARIOS))
def test_evaluate_scenario_rows_match_reference(evaluated, name, system):
    ref, port, runs, (params, cfg) = evaluated
    jrow, trow = ref[name][system], port[name][system]
    note = _logit_note(params, cfg, name) if system == "Hulk" else ""
    jres, tres = runs[name, system]
    assert tres.system == jres.system
    assert canonical_fleet(tres) == canonical_fleet(jres), note
    assert as_json(result_fields(tres)) == as_json(result_fields(jres)), note
    assert as_json(trow) == as_json(jrow), note


@pytest.mark.parametrize("name", sorted(jsc.SCENARIOS))
def test_improvement_vs_best_baseline_matches_reference(evaluated, name):
    ref, port, _, _ = evaluated
    j = ref[name]["improvement_vs_best_baseline"]
    t = port[name]["improvement_vs_best_baseline"]
    assert (math.isnan(j) and math.isnan(t)) or t == j
    assert port[name]["scenario"] == ref[name]["scenario"] == name


def test_comparison_table_text_matches_reference(evaluated):
    ref, port, _, _ = evaluated
    text = tev.comparison_table(port)
    assert text == jev.comparison_table(ref)
    assert len(text.splitlines()) == 2 + len(jsc.SCENARIOS)


def test_sim_labeled_hulk_matches_reference_on_straggler_heavy():
    """``label_mode="sim"``: v2 features with observed telemetry and the
    sim-refined placement polish (``HulkPlacer(sim_refine=True)``)."""
    seed_scenario_gnn(jsc.get_scenario("straggler_heavy"),
                  tsc.get_scenario("straggler_heavy"), "sim")
    jrow = jev.evaluate_scenario(jsc.get_scenario("straggler_heavy"), seed=0,
                                 label_mode="sim")
    trow = tev.evaluate_scenario(tsc.get_scenario("straggler_heavy"), seed=0,
                                 label_mode="sim")
    assert as_json(trow) == as_json(jrow)
    assert trow["Hulk"]["makespan_s"] <= trow["SystemB"]["makespan_s"]


@pytest.mark.parametrize("strategy", ["gpipe", "dp", "tp"])
@pytest.mark.parametrize("comm_model", ["alphabeta", "paper"])
def test_simulate_single_matches_reference(comm_model, strategy):
    runs = []
    for g, ev, sc in ((jgraph, jev, jsc), (tgraph, tev, tsc)):
        fleet = g.paper_fig1_graph()
        runs.append(ev.simulate_single(fleet, list(range(fleet.n)),
                                       sc.SIM_TASKS[1], strategy,
                                       comm_model=comm_model, steps=2))
    jres, tres = runs
    assert as_json(result_fields(tres)) == as_json(result_fields(jres))
    assert tres.per_task[tsc.SIM_TASKS[1].name]["failed"] is False


def test_simulate_single_with_stragglers_matches_reference():
    runs = [ev.simulate_single(g.random_fleet(8, seed=1), list(range(8)),
                               sc.SIM_TASKS[1], "gpipe", steps=2, seed=3,
                               jitter=J(sigma=0.2, straggler_frac=0.25,
                                        straggler_slowdown=3.0))
            for g, ev, sc, J in ((jgraph, jev, jsc, JJitter),
                                 (tgraph, tev, tsc, TJitter))]
    assert as_json(result_fields(runs[1])) == as_json(result_fields(runs[0]))
    assert runs[1].stragglers


def _telemetry(tel) -> dict:
    return {k: np.asarray(getattr(tel, k)).tolist()
            for k in ("slowdown", "jitter_sigma", "relay_hub")}


def test_observed_telemetry_matches_reference():
    jit = dict(sigma=0.3, straggler_frac=0.25, straggler_slowdown=3.0)
    jtel = jev.observed_telemetry(jgraph.random_fleet(9, seed=2),
                                  jitter=JJitter(**jit), seed=2)
    ttel = tev.observed_telemetry(tgraph.random_fleet(9, seed=2),
                                  jitter=TJitter(**jit), seed=2)
    assert _telemetry(ttel) == _telemetry(jtel)
    assert ttel.slowdown.dtype == jtel.slowdown.dtype
    blocked = [tev.observed_telemetry(sc.blocked_fleet(seed=0))
               for sc in (jsc, tsc)]
    assert _telemetry(blocked[1]) == _telemetry(blocked[0])
    assert blocked[1].relay_hub[4] == 1.0


def _live(g, ev, J, Compute, Net, change):
    jit = J(sigma=0.3, straggler_frac=0.25, straggler_slowdown=3.0)
    fleet = g.random_fleet(8, seed=2)
    compute = Compute(fleet, jit, seed=2)
    net = Net(fleet)
    change(fleet, compute, net)
    return ev.observed_telemetry_live(net, compute)


def _join(fleet, compute, net):
    grown = fleet.add_machine(fleet.machines[0])
    compute.add_machine(grown.machines[-1])
    net.add_machine(grown)


def _tombstone(fleet, compute, net):
    victim = compute.stragglers()[0]
    net.remove_machine(victim)
    compute.remove_machine((victim + 1) % fleet.n)


@pytest.mark.parametrize("change", [_join, _tombstone])
def test_observed_telemetry_live_matches_reference(change):
    jtel = _live(jgraph, jev, JJitter, JCompute, JNet, change)
    ttel = _live(tgraph, tev, TJitter, TCompute, TNet, change)
    assert _telemetry(ttel) == _telemetry(jtel)
    if change is _join:
        assert ttel.slowdown.shape == (9,) and ttel.slowdown[-1] == 1.0
    else:    # the two gone machines report nothing
        assert (ttel.jitter_sigma == 0.0).sum() == 2


def test_trained_gnn_cache_hit_keeps_to_the_requested_device():
    """A cached GNN is returned for ``device=None`` wherever it lies and for
    the device it lies on; asked for another device, the hit raises rather
    than hand back params that would run the GNN elsewhere."""
    tasks = tev.cm.FOUR_TASKS[1:3]
    key = (tuple(t.name for t in tasks), 1013, "analytic")
    cfg = ttrain.gnn_config_for(tasks)
    entry = (tgnn.init(cfg, 8, device="cpu"), cfg)
    tev._GNN_CACHE[key] = entry
    try:
        assert tev.trained_gnn(tasks, seed=1013) is entry
        assert tev.trained_gnn(tasks, seed=1013, device="cpu") is entry
        with pytest.raises(ValueError, match="lie on cpu"):
            tev.trained_gnn(tasks, seed=1013, device="cuda:0")
    finally:
        del tev._GNN_CACHE[key]
