"""The fleet-simulation twin (``repro_torch.examples.simulate_fleet``)
against the reference's example, on the CPU.

Both packages' ``trained_gnn`` caches hold the reference's params (the
analytic GNN of the scenario registry's tasks and the sim-labeled one of
straggler_heavy, ``_torch_parity.seed_scenario_gnn``): the twin fills its
cache on the device it is given, and a hit serves the seeded CPU params.
Everything else is a numpy copy, so the twin must print the reference's
lines: the comparison table, the sim-labeled row, the preemption storm's
re-plans and step times, the pod schedule."""
import torch

torch.set_num_threads(1)

from _torch_examples import assert_same_output, output_of, reference_example
from _torch_parity import cold, seed_scenario_gnn
from repro.sim import scenarios as jsc
from repro_torch.examples import simulate_fleet
from repro_torch.sim import scenarios as tsc


def test_simulate_fleet_twin_prints_the_reference_output():
    seed_scenario_gnn(jsc.get_scenario("cross_region_wan"),
                      tsc.get_scenario("cross_region_wan"))
    seed_scenario_gnn(jsc.get_scenario("straggler_heavy"),
                      tsc.get_scenario("straggler_heavy"), "sim")
    ref = reference_example("simulate_fleet")
    want = output_of(lambda: cold(ref.main))
    got = output_of(lambda: cold(lambda: simulate_fleet.main(
        ["--device", "cpu"])))
    assert_same_output(want, got)
    assert any("preempted -> elastic re-plan" in l for l in got)
