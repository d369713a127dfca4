"""repro_torch.sim — deterministic discrete-event geo-fleet simulator (port
of ``repro/sim``): the event engine, the compute model with straggler
jitter, the fair-share network model with both solvers, and the declarative
fault plans. Pure numpy/scipy, copied verbatim, so a run gives the same
numbers, events and traces as the reference.

Not ported yet, so not exported: the workload executors (``workload.py``),
the scenario registry (``scenarios.py``), the fleet evaluation
(``evaluate.py``), chaos (``chaos.py``), colocation (``colocate.py``) and the
scenario generator (``generate.py``), in the order of ROADMAP.md's queue 1.
"""
from repro_torch.sim.compute import ComputeModel, JitterConfig
from repro_torch.sim.engine import Simulator
from repro_torch.sim.faults import (FaultPlan, GrayFailure, LinkDegradation,
                                    MachineCrash, MachineFlap, RegionPartition,
                                    RegionPreemption, compile_plan,
                                    plan_from_fracs)
from repro_torch.sim.network import NetworkModel

__all__ = [
    "Simulator", "NetworkModel", "ComputeModel", "JitterConfig",
    "FaultPlan", "MachineCrash", "RegionPreemption", "LinkDegradation",
    "RegionPartition", "GrayFailure", "MachineFlap",
    "compile_plan", "plan_from_fracs",
]
