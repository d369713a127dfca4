"""The port's simulator core (``repro_torch.sim``: engine, compute, network,
faults) against the reference on the same inputs.

The modules are numpy/scipy copies of the reference, so every comparison is
exact: topology tables, routes, completion times, fault actions and compute
durations must be the same bits in both packages. Inside the port, the fast
flow solver is also held to its ``_rebalance_reference`` twin at the
reference's own tolerance (rel 1e-9, ``tests/test_fleet_fast_path.py``)."""
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.core import graph as jgraph
from repro.sim import compute as jcompute
from repro.sim import engine as jengine
from repro.sim import faults as jfaults
from repro.sim import network as jnetwork
from repro_torch.core import graph as tgraph
from repro_torch.sim import compute as tcompute
from repro_torch.sim import engine as tengine
from repro_torch.sim import faults as tfaults
from repro_torch.sim import network as tnetwork

PKGS = {
    "ref": SimpleNamespace(graph=jgraph, compute=jcompute, engine=jengine,
                           faults=jfaults, network=jnetwork),
    "port": SimpleNamespace(graph=tgraph, compute=tcompute, engine=tengine,
                            faults=tfaults, network=tnetwork),
}
GRAPHS = {
    "random_fleet12": lambda g: g.random_fleet(12, seed=3),
    "random_fleet30": lambda g: g.random_fleet(30, seed=11),
    "paper_fig1": lambda g: g.paper_fig1_graph(),
}
TABLES = ("routed_ms", "e2e_bw", "link_bw", "_next_hop")


def _same(a, b, where=""):
    """Deep equality of nested dicts, lists, tuples, numpy arrays and
    floats, bit for bit (numpy arrays also by dtype)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and np.array_equal(a, b), where
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for k, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{k}]")
    else:
        assert a == b or (a != a and b != b), f"{where}: {a!r} != {b!r}"


def _tables(net) -> dict:
    return {k: getattr(net, k).copy() for k in TABLES}


def _flows(graph, net, seed, n_flows=40):
    """Deterministic contended flow set: (t_start, src, dst, nbytes) over
    routed pairs, drawn from the seed (the reference's _random_transfers)."""
    rng = np.random.default_rng((seed, 0xF10))
    flows = []
    while len(flows) < n_flows:
        i, j = (int(x) for x in rng.integers(0, graph.n, size=2))
        if i == j or not net.reachable(i, j):
            continue
        flows.append((float(rng.uniform(0.0, 5.0)), i, j,
                      float(rng.uniform(1e6, 2e9))))
    return flows


def _sine(node, t):
    return 0.3 + 0.7 * abs(math.sin(0.01 * t + node))


def _run_flows(pkg, graph, flows, comm, solver, capacity_scale=None):
    net = pkg.network.NetworkModel(graph, comm, capacity_scale=capacity_scale,
                                   solver=solver)
    sim = pkg.engine.Simulator()
    finishes = {}
    for k, (t0, i, j, nbytes) in enumerate(flows):
        sim.schedule(t0, net.transfer, sim, i, j, nbytes,
                     (lambda kk: lambda: finishes.__setitem__(kk, sim.now))(k))
    end = sim.run()
    return finishes, {"end": end, "n_solves": net.n_solves,
                      "bytes_moved": net.bytes_moved, "fired": sim.n_fired,
                      "scheduled": sim.events_scheduled}


@pytest.mark.parametrize("comm", ["alphabeta", "paper"])
@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_topology_and_routes_match_reference(gname, comm):
    nets = {}
    for name, pkg in PKGS.items():
        nets[name] = pkg.network.NetworkModel(GRAPHS[gname](pkg.graph), comm)
    ref, port = nets["ref"], nets["port"]
    _same(_tables(port), _tables(ref))
    _same(port.relay_hubs(), ref.relay_hubs())
    _same(port.effective_latency(), ref.effective_latency())
    n = ref.graph.n
    for i in range(n):
        for j in range(n):
            assert port.reachable(i, j) == ref.reachable(i, j)
            assert port.latency_s(i, j) == ref.latency_s(i, j)
            assert (port.estimate_transfer_s(i, j, 3.7e8)
                    == ref.estimate_transfer_s(i, j, 3.7e8))
            _same(port._route(i, j), ref._route(i, j), f"route {i}->{j}")


@pytest.mark.parametrize("solver", ["fast", "reference"])
@pytest.mark.parametrize("comm", ["alphabeta", "paper"])
@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_contended_transfers_match_reference(gname, comm, solver):
    graph = GRAPHS[gname](jgraph)
    flows = _flows(graph, jnetwork.NetworkModel(graph, comm), seed=len(gname))
    got = _run_flows(PKGS["port"], GRAPHS[gname](tgraph), flows, comm, solver)
    want = _run_flows(PKGS["ref"], graph, flows, comm, solver)
    assert set(want[0]) == set(range(len(flows)))
    _same(got, want)


@pytest.mark.parametrize("scale", [None, "sine"])
@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_port_fast_solver_matches_its_reference_solver(gname, scale):
    graph = GRAPHS[gname](tgraph)
    flows = _flows(graph, tnetwork.NetworkModel(graph), seed=7)
    cap = _sine if scale else None
    if scale:   # stretch flows so several capacity ticks pass mid-transfer
        flows = [(t0, i, j, nbytes * 50.0) for t0, i, j, nbytes in flows]
    fast, _ = _run_flows(PKGS["port"], graph, flows, "alphabeta", "fast", cap)
    ref, _ = _run_flows(PKGS["port"], graph, flows, "alphabeta", "reference",
                        cap)
    assert set(fast) == set(ref) == set(range(len(flows)))
    for k in ref:
        assert fast[k] == pytest.approx(ref[k], rel=1e-9, abs=1e-9)


def _elastic_log(pkg, solver):
    """Grow, shrink, revive and degrade a fleet under live flows; a
    snapshot of the topology tables after every step and the completion
    times at the end."""
    graph = pkg.graph.random_fleet(10, seed=5)
    net = pkg.network.NetworkModel(graph, "alphabeta", solver=solver)
    sim = pkg.engine.Simulator()
    done = {}
    for k, (t0, i, j, nbytes) in enumerate(_flows(graph, net, seed=3,
                                                  n_flows=16)):
        sim.schedule(t0, net.transfer, sim, i, j, nbytes,
                     (lambda kk: lambda: done.__setitem__(kk, sim.now))(k))
    log = []
    sim.run(until=1.0)
    grown = graph.add_machine(pkg.graph.Machine("Tokyo", "A100", 8))
    grown = grown.add_machine(pkg.graph.Machine("Rome", "V100", 4),
                              latencies={0: 35.0, 3: 80.0})
    net.add_machine(grown)
    log.append(("add", _tables(net)))
    net.remove_machine(4)
    log.append(("remove", _tables(net)))
    net.revive_machine(4)
    log.append(("revive", _tables(net)))
    regions = sorted({m.region for m in graph.machines})
    cross = [(i, j) for i in range(grown.n) for j in range(grown.n)
             if grown.machines[i].region == regions[0]
             and grown.machines[j].region != regions[0]]
    net.apply_link_fault("slow", cross, bw_factor=0.25, lat_factor=3.0,
                         sim=sim)
    log.append(("degrade", _tables(net), net.effective_latency()))
    net.apply_link_fault("cut", [(0, 1), (2, 3)], cut=True, sim=sim)
    log.append(("cut", _tables(net)))
    sim.run(until=2.0)
    net.clear_link_fault("cut", sim=sim)
    net.clear_link_fault("slow", sim=sim)
    log.append(("heal", _tables(net)))
    for k, (i, j) in enumerate([(10, 0), (11, 3), (0, 11)]):
        sim.schedule(0.0, net.transfer, sim, i, j, 4e8,
                     (lambda kk: lambda: done.__setitem__(kk, sim.now))(100 + k))
    sim.run()
    log.append(("done", dict(sorted(done.items())), net.n_solves))
    return log


@pytest.mark.parametrize("solver", ["fast", "reference"])
def test_add_remove_revive_and_link_faults_match_reference(solver):
    _same(_elastic_log(PKGS["port"], solver), _elastic_log(PKGS["ref"], solver))


def _plans(pkg, regions):
    f = pkg.faults
    return {
        "crash_drawn": (f.MachineCrash(at=0.2, kills=2),),
        "crash_explicit": (f.MachineCrash(at=0.3, machines=(1, 4),
                                          recover_after=0.2),),
        "preemption": (f.RegionPreemption(at=0.4, region=regions[0], frac=0.5,
                                          recover_after=0.1),),
        "link_regions": (f.LinkDegradation(at=0.1, duration=0.3,
                                           regions=(regions[0], regions[1]),
                                           bw_factor=0.25, lat_factor=3.0),),
        "link_pairs": (f.LinkDegradation(at=0.1, duration=0.2,
                                         pairs=((0, 1), (2, 3)),
                                         bw_factor=0.5),),
        "partition": (f.RegionPartition(at=0.5, duration=0.2,
                                        regions=(regions[1],)),),
        "gray_ramp": (f.GrayFailure(at=0.2, picks=2, slowdown=4.0, ramp=0.1,
                                    ramp_steps=3, duration=0.3),),
        "gray_explicit": (f.GrayFailure(at=0.2, machines=(2, 99),
                                        slowdown=2.0),),
        "flap_drawn": (f.MachineFlap(at=0.1, cycles=3),),
        "flap_explicit": (f.MachineFlap(at=0.1, machine=5, down=0.05, up=0.1),),
    }


@pytest.mark.parametrize("kind", sorted(_plans(PKGS["port"], ("a", "b"))) + ["all"])
def test_compile_plan_matches_reference(kind):
    out = {}
    for name, pkg in PKGS.items():
        graph = pkg.graph.random_fleet(16, seed=2)
        regions = sorted({m.region for m in graph.machines})
        plans = _plans(pkg, regions)
        injectors = (sum(plans.values(), ()) if kind == "all"
                     else plans[kind])
        actions = pkg.faults.compile_plan(pkg.faults.FaultPlan(injectors),
                                          graph, horizon=120.0, seed=9)
        out[name] = [(a.t, a.kind, a.payload, a.injector) for a in actions]
        out[name + ".link"] = pkg.faults.has_link_faults(
            pkg.faults.FaultPlan(injectors))
    assert out["ref"], "the plan compiled to no action"
    _same(out["port"], out["ref"])
    assert out["port.link"] == out["ref.link"]


def test_plan_from_fracs_matches_reference():
    for fracs, kills in (((0.25, 0.5), 1), ((0.1,), 3), ((), 1)):
        got = tfaults.plan_from_fracs(fracs, kills)
        want = jfaults.plan_from_fracs(fracs, kills)
        assert bool(got) == bool(want)
        assert ([(i.at, i.kills, i.machines, i.recover_after)
                 for i in got.injectors]
                == [(i.at, i.kills, i.machines, i.recover_after)
                    for i in want.injectors])


JITTERS = {
    "none": {},
    "sigma": dict(sigma=0.3),
    "stragglers": dict(sigma=0.15, straggler_frac=0.25,
                       straggler_slowdown=2.5),
}


def _compute_log(pkg, jitter):
    graph = pkg.graph.random_fleet(12, seed=4)
    cm = pkg.compute.ComputeModel(graph, pkg.compute.JitterConfig(**jitter),
                                  seed=6)
    log = [cm.stragglers(), cm.telemetry()]
    cm.set_gray(3, 2.5)
    new = cm.add_machine(pkg.graph.Machine("Berlin", "A100", 8))
    durations = [cm.duration(m, 3.1e14 * (1 + m), step=s, microbatch=mb,
                             tag=tag)
                 for m in range(new + 1) for s in range(3) for mb in range(2)
                 for tag in range(2)]
    cm.remove_machine(5)
    with pytest.raises(ValueError, match="deprovisioned"):
        cm.duration(5, 1e12)
    cm.revive_machine(5)
    cm.set_gray(3, 1.0)
    log += [durations, cm.duration(5, 2e13, step=9), cm.busy_s.copy(),
            cm.telemetry(), cm.alive.copy()]
    return log


@pytest.mark.parametrize("jitter", sorted(JITTERS))
def test_compute_durations_match_reference(jitter):
    _same(_compute_log(PKGS["port"], JITTERS[jitter]),
          _compute_log(PKGS["ref"], JITTERS[jitter]))


def _engine_log(pkg):
    """Ties in time, cancellation, epoch pinning, ``until`` and a barrier."""
    sim = pkg.engine.Simulator()
    fired = []
    note = lambda tag: fired.append((sim.now, sim.epoch, tag))
    for k in range(5):
        sim.schedule(1.0, note, f"tie{k}")
    gone = sim.schedule(0.5, note, "cancelled")
    gone.cancel()
    sim.schedule(2.0, note, "pinned")
    sim.schedule(2.0, note, "unpinned", pin_epoch=False)
    sim.schedule(1.5, sim.bump_epoch)
    barrier = pkg.engine.Barrier(3, lambda: note("barrier"))
    for t in (0.2, 0.7, 3.0):
        sim.schedule(t, barrier.arrive, pin_epoch=False)
    end1 = sim.run(until=1.0)
    end2 = sim.run()
    with pytest.raises(ValueError, match="bad event delay"):
        sim.schedule(-1.0, note, "x")
    return [fired, end1, end2, sim.events_dispatched, sim.events_scheduled]


def test_engine_matches_reference():
    _same(_engine_log(PKGS["port"]), _engine_log(PKGS["ref"]))
