"""The serving and tracing twins (``repro_torch.examples.serve_fleet`` and
``trace_run``) against the reference's examples, on the CPU.

The port's GNN caches hold the reference's params for every serving
scenario (``_torch_parity.seed_serve_gnn``) and for the traced drift
scenario (``seed_scenario_gnn``); the serving runs are numpy
copies, so ``serve_fleet`` must print the reference's lines. ``trace_run``
must also write the reference's trace byte for byte, as
``tests/test_torch_obs.py`` requires of both packages' recorders; its
"wrote <path>" line names each side's own file."""
import pytest
import torch

torch.set_num_threads(1)

from _torch_examples import assert_same_output, output_of, reference_example
from _torch_parity import cold, seed_scenario_gnn, seed_serve_gnn
from repro.sim import scenarios as jsc
from repro_torch.examples import serve_fleet, trace_run
from repro_torch.sim import scenarios as tsc


@pytest.fixture(scope="module", autouse=True)
def seeded():
    for name in sorted(jsc.SERVE_SCENARIOS):
        ref, port = jsc.get_serve_scenario(name), tsc.get_serve_scenario(name)
        seed_serve_gnn(ref.model, port.model, ref.n_replicas)
    ref = jsc.get_drift_scenario("drift_gray_creep")
    seed_scenario_gnn(ref, tsc.get_drift_scenario("drift_gray_creep"),
                      ref.label_mode)


def test_serve_fleet_twin_prints_the_reference_output():
    ref = reference_example("serve_fleet")
    want = output_of(lambda: cold(ref.main))
    got = output_of(lambda: cold(lambda: serve_fleet.main(
        ["--device", "cpu"])))
    assert_same_output(want, got)


TRACE_RUNS = {
    "default": ["--time-scale", "0.1", "--check-determinism"],
    "hulk": ["--scenario", "serve_replica_failure", "--policy", "hulk",
             "--time-scale", "0.1"],
    "training": ["--scenario", "cross_region_wan", "--report"],
    "drift": ["--scenario", "drift_gray_creep", "--mode", "guarded"],
}


@pytest.mark.parametrize("run", sorted(TRACE_RUNS))
def test_trace_run_twin_writes_the_reference_trace(run, tmp_path):
    argv = TRACE_RUNS[run]
    ref_out, port_out = tmp_path / "ref.trace.json", tmp_path / "port.trace.json"
    ref = reference_example("trace_run")
    want = output_of(lambda: cold(lambda: ref.main(
        argv + ["--out", str(ref_out)])))
    got = output_of(lambda: cold(lambda: trace_run.main(
        argv + ["--out", str(port_out), "--device", "cpu"])))
    assert port_out.read_bytes() == ref_out.read_bytes()
    want = [l.replace(str(ref_out), str(port_out)) for l in want]
    assert_same_output(want, got)
    if run == "default":
        assert got[-1].startswith("determinism check PASS")
