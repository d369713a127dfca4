"""repro_torch.sim.colocate against the reference: every colocated scenario
under every serve policy, with both tenants placed through the GNN (the
reference's serve and training params seeded into the port's cache), and the
colocation invariants.

Colocation is numpy but for the two GNN placements, so with the same params
each run must equal the reference's byte for byte
(``repro.sim.colocate.canonical_colocated``) and field by field.
"""
import dataclasses

import pytest
import torch

torch.set_num_threads(1)

from _torch_parity import (as_json, assert_same_serve_run, cold, result_json,
                           seed_serve_gnn, seed_scenario_gnn)
from repro.sim import colocate as jco
from repro.sim import scenarios as jsc
from repro_torch.sim import colocate as tco
from repro_torch.sim import scenarios as tsc

POLICIES = ("nearest", "least_loaded", "hulk")
NAMES = sorted(jsc.COLOCATED_SCENARIOS)


@pytest.fixture(scope="module", autouse=True)
def seeded():
    """Both tenants' GNNs, keyed as ``run_colocated`` asks for them."""
    for name in NAMES:
        ref, port = (jsc.get_colocated_scenario(name),
                     tsc.get_colocated_scenario(name))
        seed_serve_gnn(ref.model, port.model, ref.n_replicas)
        seed_scenario_gnn(ref, port, ref.label_mode, with_traffic=False)


def _train_fields(res) -> str:
    return as_json({f.name: getattr(res, f.name)
                    for f in dataclasses.fields(res)})


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", NAMES)
def test_colocated_run_matches_reference(name, policy):
    scn = tsc.get_colocated_scenario(name)
    port = cold(lambda: tco.run_colocated(scn, policy, seed=0))
    ref = cold(lambda: jco.run_colocated(jsc.get_colocated_scenario(name),
                                         policy, seed=0))
    assert port["train_hosts"] == ref["train_hosts"], "training hosts"
    assert port["serve_hosts"] == ref["serve_hosts"], "serve hosts"
    assert tco.canonical_colocated(port) == jco.canonical_colocated(ref)
    assert_same_serve_run(ref["raw"], port["raw"], f"{name}/{policy}")
    assert result_json(port["serve"]) == result_json(ref["serve"])
    assert _train_fields(port["train"]) == _train_fields(ref["train"])
    for key in ("scenario", "policy", "seed", "overlap", "until_s"):
        assert port[key] == ref[key], key
    tco.check_colocated_invariants(port, scn)


@pytest.mark.parametrize("name", NAMES)
def test_greedy_tenant_replays_byte_identically(name):
    scn = tsc.get_colocated_scenario(name)
    a = tco.run_colocated(scn, "least_loaded", seed=0, train_placer="greedy")
    b = tco.run_colocated(scn, "least_loaded", seed=0, train_placer="greedy")
    assert tco.canonical_colocated(a) == tco.canonical_colocated(b)
    ref = jco.run_colocated(jsc.get_colocated_scenario(name), "least_loaded",
                            seed=0, train_placer="greedy")
    assert tco.canonical_colocated(a) == jco.canonical_colocated(ref)


def test_crash_injectors_and_empty_tenants_are_rejected():
    from repro_torch.sim import faults as fm
    scn = tsc.get_colocated_scenario(NAMES[0])
    crash = dataclasses.replace(
        scn, fault_plan=fm.FaultPlan((fm.MachineCrash(at=0.5, kills=1),)))
    with pytest.raises(ValueError):
        tco.run_colocated(crash, "least_loaded", train_placer="greedy")
    with pytest.raises(ValueError, match="no training tasks"):
        tco.run_colocated(dataclasses.replace(scn, tasks=()), "nearest")
    with pytest.raises(ValueError, match="unknown train_placer"):
        tco.run_colocated(scn, "least_loaded", train_placer="nope")


def test_invariants_catch_a_lost_step():
    scn = tsc.get_colocated_scenario(NAMES[0])
    res = tco.run_colocated(scn, "least_loaded", seed=0,
                            train_placer="greedy")
    tco.check_colocated_invariants(res, scn)
    name = next(iter(res["train"].per_task))
    res["train"].per_task[name]["step_times"].pop()
    with pytest.raises(AssertionError, match="wanted"):
        tco.check_colocated_invariants(res, scn)
