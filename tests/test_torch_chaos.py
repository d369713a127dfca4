"""repro_torch.sim.chaos against the reference: random fault plans and the
fuzzer's cases for seeds 0-9, the controller invariant suite with the
reference's GNNs seeded, the CLI, and the tests of ``test_conservation.py``
on the port, both data planes.

Chaos is numpy all the way down but for ``fuzz_controller``'s Hulk
placements, so plans, records and reports must be equal byte for byte.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

from _torch_parity import assert_same_serve_run, cold, seed_scenario_gnn
from repro.sim import chaos as jchaos
from repro.sim import scenarios as jsc
from repro_torch import obs as obs_mod
from repro_torch.serve.evaluate import run_serve, summarize
from repro_torch.sim import (COLOCATED_SCENARIOS, SERVE_SCENARIOS,
                             get_colocated_scenario, get_serve_scenario,
                             run_colocated)
from repro_torch.sim import chaos as tchaos
from repro_torch.sim import scenarios as tsc
from repro_torch.sim.chaos import check_invariants
from repro_torch.sim.colocate import check_colocated_invariants

SEEDS = range(10)
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


def _plan_json(plan) -> str:
    return json.dumps([[type(i).__name__, dataclasses.asdict(i)]
                       for i in plan.injectors], sort_keys=True,
                      default=repr)


@pytest.mark.parametrize("seed", SEEDS)
def test_random_fault_plan_matches_reference(seed):
    plan = tchaos.random_fault_plan(seed, tchaos.paper_fig1_graph(seed))
    ref = jchaos.random_fault_plan(seed, jchaos.paper_fig1_graph(seed))
    assert _plan_json(plan) == _plan_json(ref)
    assert len(plan.injectors) >= 1


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_one_matches_reference(seed):
    """The port's fuzzer holds every invariant (it raises otherwise) and
    reports the reference's counts; each case's records are the
    reference's, on both serving paths."""
    out = cold(lambda: tchaos.fuzz_one(seed))
    assert out == cold(lambda: jchaos.fuzz_one(seed))
    plan = tchaos.random_fault_plan(seed, tchaos.paper_fig1_graph(seed))
    ref_plan = jchaos.random_fault_plan(seed, jchaos.paper_fig1_graph(seed))
    for resilient in (False, True):
        assert_same_serve_run(
            cold(lambda: jchaos.run_case(seed, ref_plan, resilient=resilient)),
            cold(lambda: tchaos.run_case(seed, plan, resilient=resilient)),
            f"seed {seed} resilient={resilient}")


@pytest.fixture(scope="module")
def seeded_drift():
    """The reference's GNN of every drift scenario under the port's key, as
    ``fuzz_controller`` asks for it."""
    for name in sorted(jsc.DRIFT_SCENARIOS):
        ref, port = jsc.get_drift_scenario(name), tsc.get_drift_scenario(name)
        seed_scenario_gnn(ref, port, ref.label_mode)


def test_fuzz_controller_matches_reference(seeded_drift):
    logs = []
    out = tchaos.fuzz_controller(seed=0, log=logs.append)
    assert out["violations"] == 0
    assert out == jchaos.fuzz_controller(seed=0, log=lambda s: None)
    assert any("rollback drill" in line for line in logs)


def test_cli_runs_without_jax():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.sim.chaos", "--seeds", "2",
         "--skip-planes"],
        env=dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "chaos fuzz PASS: 2 seeds, 0 invariant violations" in proc.stdout


# ---------------------------------------------------------------------------
# test_conservation.py on the port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("plane", ["fast", "reference"])
@pytest.mark.parametrize("name", sorted(jsc.SERVE_SCENARIOS))
def test_requests_are_conserved(name, plane):
    scn = get_serve_scenario(name)
    rec = obs_mod.Recorder()
    res, raw = run_serve(scn, "least_loaded", seed=0, data_plane=plane,
                         obs=rec)
    counts = check_invariants(raw, rec)
    assert counts["offered"] == len(raw["records"]) > 0
    assert res.n_requests == counts["offered"]
    assert res.n_completed == counts["completed"]
    assert res.n_dropped == counts["dropped"]
    assert res.n_incomplete == counts["unresolved"]
    assert res.n_requests == res.n_completed + res.n_dropped \
        + res.n_incomplete
    assert sum(res.drops_by_reason.values()) == res.n_dropped
    assert "unknown" not in res.drops_by_reason
    for r in raw["records"].values():
        if r.t_complete is not None:
            assert r.n_routes >= 1 and r.machines
    assert summarize(raw, scn.slo_s).as_dict() == res.as_dict()


def test_conservation_holds_under_resilience():
    from repro_torch.serve.resilience import ResilienceConfig
    scn = dataclasses.replace(get_serve_scenario("serve_replica_failure"),
                              resilience=ResilienceConfig.default())
    rec = obs_mod.Recorder()
    res, raw = run_serve(scn, "least_loaded", seed=0, obs=rec)
    counts = check_invariants(raw, rec)
    assert res.n_requests == counts["offered"]
    assert res.n_completed + res.n_dropped + res.n_incomplete \
        == res.n_requests


@pytest.mark.parametrize("name", sorted(jsc.COLOCATED_SCENARIOS))
def test_conservation_holds_under_colocation(name):
    scn = get_colocated_scenario(name)
    result = run_colocated(scn, "least_loaded", seed=0,
                           train_placer="greedy")
    check_colocated_invariants(result, scn)
    counts = check_invariants(result["raw"])
    res = result["serve"]
    assert counts["offered"] == len(result["raw"]["records"]) > 0
    assert res.n_requests == counts["offered"]
    assert res.n_completed == counts["completed"]
    assert res.n_dropped == counts["dropped"]
    assert res.n_incomplete == counts["unresolved"]
    assert res.n_requests == res.n_completed + res.n_dropped \
        + res.n_incomplete
    assert sum(res.drops_by_reason.values()) == res.n_dropped
    assert "unknown" not in res.drops_by_reason
    for task_name, d in result["train"].per_task.items():
        assert not d["failed"], task_name
        assert len(d["step_times"]) == scn.steps, task_name


def test_registries_match_reference():
    assert sorted(SERVE_SCENARIOS) == sorted(jsc.SERVE_SCENARIOS)
    assert sorted(COLOCATED_SCENARIOS) == sorted(jsc.COLOCATED_SCENARIOS)
