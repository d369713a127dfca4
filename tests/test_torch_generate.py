"""repro_torch.sim.generate against the reference: ``approx_params`` for every
arch, ten generated scenarios field by field, the invariant suite on seeds
0-2, the tests of ``test_scenario_registry.py`` on the port, and the CLI.

The generator is numpy and draws from counter-based rngs, so a seed must
give the reference's scenario and the reference's runs, byte for byte.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.sim import generate as jgen
from repro.sim import scenarios as jsc
from repro_torch.configs import ARCHS, get_config
from repro_torch.sim import generate as gen
from repro_torch.sim import scenarios as sc

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


def _plain(x):
    """A scenario's field as plain data: dataclasses, arrays and fault
    injectors by value, with their type names."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return [type(x).__name__, {f.name: _plain(getattr(x, f.name))
                                   for f in dataclasses.fields(x)}]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    return x


def _scenario_fields(scn) -> dict:
    """Every field of a generated scenario; the fleet is built at run seeds
    0 and 1 and the traffic builder is called on the seed-0 fleet."""
    out = {"kind": type(scn).__name__}
    graph = scn.fleet(0)
    for f in dataclasses.fields(scn):
        v = getattr(scn, f.name)
        if f.name == "fleet":
            out[f.name] = [json.dumps(_plain({
                "machines": scn.fleet(s).machines,
                "latency": scn.fleet(s).latency}), sort_keys=True)
                for s in (0, 1)]
        elif f.name == "traffic" and callable(v):
            out[f.name] = _plain(v(graph))
        else:
            out[f.name] = _plain(v)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_approx_params_matches_reference(arch):
    from repro.configs import get_config as jget_config
    p = gen.approx_params(get_config(arch))
    assert p == jgen.approx_params(jget_config(arch))
    assert p > 0
    task = gen.task_from_arch(arch, gen._rng(0, 0x7A58))
    ref = jgen.task_from_arch(arch, jgen._rng(0, 0x7A58))
    assert dataclasses.asdict(task) == dataclasses.asdict(ref)


def test_generated_scenarios_match_reference_field_by_field():
    port, ref = gen.generated_scenarios(10), jgen.generated_scenarios(10)
    assert [s.name for s in port] == [s.name for s in ref]
    kinds = set()
    for a, b in zip(port, ref):
        fa, fb = _scenario_fields(a), _scenario_fields(b)
        assert fa.keys() == fb.keys()
        for k in fa:
            assert fa[k] == fb[k], (a.name, k)
        assert gen.declared_invariants(a) == jgen.declared_invariants(b)
        kinds.add(fa["kind"])
    assert kinds == {"Scenario", "ServeScenario", "ColocatedScenario"}
    # a pure function of the seed: a second draw is the same scenario
    again = gen.generate_scenario(3)
    assert _scenario_fields(again) == _scenario_fields(port[3])


def test_envelope_matches_reference():
    assert gen.ENVELOPE == jgen.ENVELOPE
    assert gen.CAL_RTOL == jgen.CAL_RTOL


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_check_scenario_matches_reference(seed):
    """Every declared invariant holds on the port (``check_scenario`` raises
    otherwise) and the report equals the reference's."""
    out = gen.fuzz_one(seed)
    ref = jgen.fuzz_one(seed)
    assert json.dumps(out, sort_keys=True, default=str) \
        == json.dumps(ref, sort_keys=True, default=str)
    assert out["invariants"] == list(gen.declared_invariants(
        gen.generate_scenario(seed)))


def test_declared_invariants_reject_other_types():
    with pytest.raises(TypeError, match="not a generatable scenario"):
        gen.declared_invariants(object())
    with pytest.raises(TypeError, match="not a generatable scenario"):
        gen.check_scenario(object())


def test_cli_shows_and_fuzzes_without_jax(capsys):
    assert gen.main(["--show", "--seeds", "3"]) == 0
    assert [ln.split(":")[0] for ln in capsys.readouterr().out.splitlines()] \
        == [s.name for s in jgen.generated_scenarios(3)]
    fuzz = subprocess.run([sys.executable, "-m", "repro_torch.sim.generate",
                           "--fuzz", "--seeds", "1", "--base-seed", "1",
                           "--no-planes"],
                          env=dict(os.environ, PYTHONPATH=SRC,
                                   OMP_NUM_THREADS="1"),
                          capture_output=True, text=True, timeout=120)
    assert fuzz.returncode == 0, fuzz.stdout + fuzz.stderr
    assert "1/1 generated scenarios clean" in fuzz.stdout


# ---------------------------------------------------------------------------
# test_scenario_registry.py on the port
# ---------------------------------------------------------------------------
KINDS = [
    (sc.Scenario, sc.SCENARIOS, sc.get_scenario,
     sorted(sc.SCENARIOS)[0]),
    (sc.ServeScenario, sc.SERVE_SCENARIOS, sc.get_serve_scenario,
     sorted(sc.SERVE_SCENARIOS)[0]),
    (sc.DriftScenario, sc.DRIFT_SCENARIOS, sc.get_drift_scenario,
     sorted(sc.DRIFT_SCENARIOS)[0]),
    (sc.ColocatedScenario, sc.COLOCATED_SCENARIOS, sc.get_colocated_scenario,
     sorted(sc.COLOCATED_SCENARIOS)[0]),
]


def _fresh(kind_idx: int, name: str):
    _, registry, _, template = KINDS[kind_idx]
    return dataclasses.replace(registry[template], name=name)


@pytest.mark.parametrize("kind_idx", range(len(KINDS)))
def test_register_unregister_roundtrip_every_kind(kind_idx):
    cls, registry, get, _ = KINDS[kind_idx]
    scn = _fresh(kind_idx, f"tmp_registry_{cls.__name__}")
    before = dict(registry)
    got = sc.register_scenario(scn)
    try:
        assert got is scn
        assert isinstance(scn, cls)
        assert get(scn.name) is scn
        for other_cls, other_registry, _, _ in KINDS:
            if other_registry is not registry:
                assert scn.name not in other_registry, other_cls.__name__
        with pytest.raises(ValueError, match="already registered"):
            sc.register_scenario(dataclasses.replace(scn))
    finally:
        sc.unregister_scenario(scn)
    assert dict(registry) == before
    with pytest.raises(KeyError, match="unknown"):
        get(scn.name)
    sc.unregister_scenario(scn)


@pytest.mark.parametrize("kind_idx", range(len(KINDS)))
def test_per_kind_wrappers_share_the_code_path(kind_idx):
    register_fns = [sc.register, sc.register_serve, sc.register_drift,
                    sc.register_colocated]
    unregister_fns = [sc.unregister, sc.unregister_serve, sc.unregister_drift,
                      sc.unregister_colocated]
    _, registry, get, _ = KINDS[kind_idx]
    scn = _fresh(kind_idx, f"tmp_wrapper_{kind_idx}")
    register_fns[kind_idx](scn)
    try:
        assert get(scn.name) is scn
    finally:
        unregister_fns[kind_idx](scn.name)
    assert scn.name not in registry


@pytest.mark.parametrize("bogus", [object(), 42, None, {"name": "x"},
                                   "just_a_string"])
def test_register_rejects_non_scenarios(bogus):
    with pytest.raises(TypeError, match="not a scenario"):
        sc.register_scenario(bogus)


def test_unregister_rejects_non_scenarios():
    with pytest.raises(TypeError, match="not a scenario"):
        sc.unregister_scenario(42)
    sc.unregister_scenario("never_registered_name")


def test_temporary_registration_mixes_all_kinds():
    scns = tuple(_fresh(i, f"tmp_mix_{i}") for i in range(len(KINDS)))
    with sc.temporary_registration(*scns) as got:
        assert got == scns
        assert scns[0].name in sc.SCENARIOS
        assert scns[1].name in sc.SERVE_SCENARIOS
        assert scns[2].name in sc.DRIFT_SCENARIOS
        assert scns[3].name in sc.COLOCATED_SCENARIOS
    for scn, (_, registry, _, _) in zip(scns, KINDS):
        assert scn.name not in registry


def test_temporary_registration_cleans_up_on_error():
    scns = tuple(_fresh(i, f"tmp_err_{i}") for i in range(len(KINDS)))
    with pytest.raises(RuntimeError, match="boom"):
        with sc.temporary_registration(*scns):
            raise RuntimeError("boom")
    for scn, (_, registry, _, _) in zip(scns, KINDS):
        assert scn.name not in registry
    dup = dataclasses.replace(KINDS[0][1][KINDS[0][3]])
    with pytest.raises(ValueError, match="already registered"):
        with sc.temporary_registration(scns[1], dup, scns[2]):
            pass
    assert scns[1].name not in sc.SERVE_SCENARIOS
    assert scns[2].name not in sc.DRIFT_SCENARIOS


def test_generated_scenarios_register_through_the_same_path():
    batch = gen.generated_scenarios(6, base_seed=123)
    assert len(batch) == 6
    with sc.temporary_registration(*batch):
        for scn in batch:
            registry, _ = sc._registry_of(scn)
            assert registry[scn.name] is scn
    for scn in batch:
        registry, _ = sc._registry_of(scn)
        assert scn.name not in registry
    assert [s.name for s in batch] \
        == [s.name for s in jgen.generated_scenarios(6, base_seed=123)]
    assert sorted(jsc.SCENARIOS) == sorted(sc.SCENARIOS)
