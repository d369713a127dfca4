"""Property-based scenario generator + invariant fuzzer.

Hand-authored scenarios overfit the scheduler: the twelve registered cases
exercise the regimes their authors thought of. This module draws *random*
scenarios — geo-topology, machine classes, relay hubs, model choice, traffic
mix, fault plan — from declared envelopes, and checks every draw against the
invariant suite the hand-authored cases are tested for, in the style of
``sim.chaos``:

* **determinism**  — two in-process runs replay byte-identically;
* **exactly_once** — every request resolves exactly one way (serve kinds);
* **conservation** — every training task runs exactly its configured steps,
  none lost, none doubled (training kinds);
* **planes**       — the fast data plane reproduces the reference solver
  byte-for-byte;
* **calibration**  — with zero jitter and no faults, the simulated step time
  matches the analytic cost model within ``CAL_RTOL`` (training kinds);
* **liveness**     — the run drains: no unresolved request, every task
  finishes with a finite makespan.

All draws come from ``default_rng((seed, GEN_STREAM, ...))`` — counter-based
like the rest of the stack — so ``generate_scenario(seed)`` is a pure
function of the seed and generated scenarios replay byte-identically across
processes (asserted by ``tests/test_seed_sweep.py``).

Scenario *kinds* are the registered dataclasses themselves (``Scenario``,
``ServeScenario``, ``ColocatedScenario``) so generated scenarios flow
through ``register_scenario`` / ``temporary_registration`` like any other.

Model choices come from the full ``repro_torch.configs`` registry — MoE
(olmoe, deepseek), hybrid (jamba), encoder-decoder (whisper), VLM
(internvl2), dense — priced analytically by ``approx_params`` (the configs
are pure data; no jax lowering happens here) and served through
``serve.costs.serve_model_from_task`` cost cards.

CLI::

    python -m repro_torch.sim.generate --fuzz --seeds 15

Port of ``repro/sim/generate.py``: numpy copies, so a seed draws the
reference's scenario and its checks see the reference's runs.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Optional, Sequence

import numpy as np

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.core import cost_model as cm
from repro_torch.core.graph import (GPU_CATALOG, REGIONS, ClusterGraph,
                                   Machine, region_latency_ms)
from repro_torch.sim import scenarios as sc
from repro_torch.sim.colocate import (canonical_colocated,
                                      check_colocated_invariants,
                                      run_colocated)
from repro_torch.sim.compute import JitterConfig
from repro_torch.sim.evaluate import (FleetSimulation, FullFleetPlacer,
                                      simulate_single)
from repro_torch.sim.faults import FaultPlan, GrayFailure, LinkDegradation
from repro_torch.sim.workload import analytic_step_time

GEN_STREAM = 0x6E4E      # rng stream tag for every generator draw

# ---------------------------------------------------------------------------
# Envelopes: every random draw stays inside these declared bounds
# (documented in docs/SCENARIOS.md — change them there too).
# ---------------------------------------------------------------------------
ENVELOPE = {
    "n_regions": (2, 5),              # regions per fleet
    "machines_per_region": (1, 4),
    "n_gpus": (4, 8),                 # GPUs per machine
    "block_prob": 0.25,               # chance a non-hub region pair is
                                      # policy-blocked (relay via the hub)
    # inter-region latency is drawn INSIDE a _BW_CLASSES envelope: a pair is
    # assigned a class, then a latency uniform in that class's band, so the
    # derived bandwidth (core.cost_model.link_bandwidth) hits every tier
    "wan_latency_bands": ((20.0, 110.0),     # good WAN      -> 1 GB/s
                          (130.0, 240.0),    # poor WAN      -> 0.3 GB/s
                          (260.0, 420.0)),   # intercont.    -> 0.05 GB/s
    "batch_tokens": (8_192, 65_536),
    "microbatches": (2, 8),
    "steps": (2, 4),
    "mem_margin": 1.35,               # fleet memory >= margin * task floor
    "jitter_sigma": (0.0, 0.08),
    "straggler_frac": (0.0, 0.3),
    "straggler_slowdown": (1.5, 3.0),
    "fault_prob": 0.5,                # chance a draw carries a fault plan
    "serve_horizon_s": (45.0, 90.0),
    "serve_util": (0.15, 0.5),        # target replica utilization
    "n_replicas": (2, 4),
    "decode_efficiency": (0.01, 0.05),
    "colo_horizon_s": (60.0, 120.0),
}

# calibration tolerance: zero-jitter sim step vs analytic cost model
CAL_RTOL = 5e-3

_INVARIANTS_BY_KIND = {
    sc.Scenario: ("determinism", "conservation", "planes", "calibration",
                  "liveness"),
    sc.ServeScenario: ("determinism", "exactly_once", "planes", "liveness"),
    sc.ColocatedScenario: ("determinism", "exactly_once", "conservation",
                           "planes", "liveness"),
}

KINDS = ("train", "serve", "colocated")


def declared_invariants(scenario) -> tuple[str, ...]:
    """The invariant suite a scenario of this kind is checked against."""
    for kind, names in _INVARIANTS_BY_KIND.items():
        if isinstance(scenario, kind):
            return names
    raise TypeError(f"not a generatable scenario: "
                    f"{type(scenario).__name__}")


def _rng(seed: int, *extra: int) -> np.random.Generator:
    return np.random.default_rng((seed, GEN_STREAM, *extra))


# ---------------------------------------------------------------------------
# Analytic parameter count for registry configs (the configs are pure data;
# this prices them without touching jax)
# ---------------------------------------------------------------------------
def _layer_params(l: LayerSpec, d: int) -> float:
    p = 2.0 * d                                    # the two norms
    if l.kind == "attn" and l.attn is not None:
        a = l.attn
        p += d * a.head_dim * (2 * a.n_heads + 2 * a.n_kv_heads)
    elif l.kind == "mla" and l.mla is not None:
        m = l.mla
        qk = m.qk_nope_dim + m.qk_rope_dim
        p += (d * m.q_lora_rank + m.q_lora_rank * m.n_heads * qk
              + d * m.kv_lora_rank + d * m.qk_rope_dim
              + m.kv_lora_rank * m.n_heads * (m.qk_nope_dim + m.v_head_dim)
              + m.n_heads * m.v_head_dim * d)
    elif l.kind == "mamba" and l.mamba is not None:
        mb = l.mamba
        di = mb.expand * d
        dt = mb.dt_rank or math.ceil(d / 16)
        p += (2 * d * di + di * mb.d_conv
              + di * (dt + 2 * mb.d_state) + dt * di
              + di * mb.d_state + di + di * d)
    elif l.kind == "mlstm" and l.xlstm is not None:
        di = int(l.xlstm.proj_factor * d)
        p += 2 * d * di + 3 * di * di // max(l.xlstm.n_heads, 1) + di * d
    elif l.kind == "slstm":
        p += 8.0 * d * d
    if l.mlp == "dense" and l.d_ff:
        p += 3.0 * d * l.d_ff
    elif l.mlp == "moe" and l.moe is not None:
        e = l.moe
        p += ((e.n_experts + e.n_shared) * 3.0 * d * e.d_ff_expert
              + d * e.n_experts)
    return p


def approx_params(cfg: ModelConfig) -> float:
    """Analytic parameter estimate over the config's segment structure —
    embeddings + every decoder/encoder layer. Used to size ``ModelTask``
    cost cards and fleet memory; ~exact for dense, within a few percent for
    the exotic kinds (close enough for envelope sizing)."""
    p = float(cfg.vocab_size * cfg.d_model)
    if not cfg.tie_embeddings:
        p += cfg.vocab_size * cfg.d_model
    for seg in cfg.segments:
        p += seg.count * sum(_layer_params(l, cfg.d_model)
                             for l in seg.layers)
    for seg in cfg.encoder_segments:
        p += seg.count * sum(_layer_params(l, cfg.d_model)
                             for l in seg.layers)
    if cfg.vit_dim:
        p += cfg.vit_dim * cfg.d_model
    return p


def task_from_arch(arch: str, rng: np.random.Generator) -> cm.ModelTask:
    """A training ``ModelTask`` cost card for one registry architecture."""
    cfg = get_config(arch)
    lo, hi = ENVELOPE["batch_tokens"]
    mb_lo, mb_hi = ENVELOPE["microbatches"]
    return cm.ModelTask(
        name=f"{cfg.name}",
        params=approx_params(cfg),
        n_layers=max(cfg.n_layers, 1),
        d_model=cfg.d_model,
        batch_tokens=int(rng.integers(lo // 4_096, hi // 4_096 + 1) * 4_096),
        microbatches=int(2 ** rng.integers(int(math.log2(mb_lo)),
                                           int(math.log2(mb_hi)) + 1)))


# ---------------------------------------------------------------------------
# Topology draw
# ---------------------------------------------------------------------------
def _draw_topology(seed: int) -> tuple[list[Machine], np.ndarray]:
    """Machines + a latency matrix drawn inside the declared envelopes.

    Region-pair latency is drawn inside one of the ``wan_latency_bands``
    (each band maps to one ``_BW_CLASSES`` bandwidth tier); a random subset
    of non-hub pairs is policy-blocked (latency 0), so routed paths must
    relay through the hub region — generated fleets exercise the same
    relay-hub machinery as ``blocked_fleet``."""
    rng = _rng(seed, 0x70B0)
    r_lo, r_hi = ENVELOPE["n_regions"]
    n_regions = int(rng.integers(r_lo, r_hi + 1))
    region_ids = rng.choice(len(REGIONS), size=n_regions, replace=False)
    regions = [REGIONS[int(i)] for i in region_ids]
    hub = regions[int(rng.integers(0, n_regions))]

    gpus = list(GPU_CATALOG)
    m_lo, m_hi = ENVELOPE["machines_per_region"]
    g_lo, g_hi = ENVELOPE["n_gpus"]
    machines = [Machine(region, gpus[int(rng.integers(0, len(gpus)))],
                        int(rng.integers(g_lo, g_hi + 1)))
                for region in regions
                for _ in range(int(rng.integers(m_lo, m_hi + 1)))]

    # region-pair latency: drawn inside a band; blocked with block_prob for
    # non-hub pairs (the hub stays fully connected so routing always works)
    bands = ENVELOPE["wan_latency_bands"]
    pair_lat: dict[tuple[str, str], float] = {}
    for i, a in enumerate(regions):
        for b in regions[i + 1:]:
            if hub not in (a, b) and rng.random() < ENVELOPE["block_prob"]:
                pair_lat[(a, b)] = 0.0          # policy-blocked
                continue
            # keep a geographic flavour: seed the band choice from the
            # region-distance estimate, then draw inside the band
            est = region_latency_ms(a, b)
            if not np.isfinite(est):
                est = 300.0
            band = bands[min(len(bands) - 1,
                             int(est // 150) if rng.random() < 0.7
                             else int(rng.integers(0, len(bands))))]
            pair_lat[(a, b)] = float(rng.uniform(*band))

    n = len(machines)
    lat = np.zeros((n, n), np.float32)
    for i in range(n):
        for j in range(i + 1, n):
            ri, rj = machines[i].region, machines[j].region
            if ri == rj:
                base = 1.0                      # LAN tier (<= 2 ms)
            else:
                base = pair_lat.get((ri, rj), pair_lat.get((rj, ri), 0.0))
            if base > 0:
                base *= float(rng.uniform(0.97, 1.03))
            lat[i, j] = lat[j, i] = base
    return machines, lat


def _grow_to_fit(machines: list[Machine], lat: np.ndarray, seed: int,
                 need_gb: float) -> tuple[list[Machine], np.ndarray]:
    """Append drawn machines (round-robin over the existing regions) until
    the fleet's aggregate memory covers ``need_gb``."""
    rng = _rng(seed, 0x9F00)
    gpus = list(GPU_CATALOG)
    regions = sorted({m.region for m in machines})
    total = sum(m.memory_gb for m in machines)
    k = 0
    while total < need_gb:
        m = Machine(regions[k % len(regions)],
                    gpus[int(rng.integers(0, len(gpus)))], 8)
        machines, lat = _add_machine(machines, lat, m)
        total += m.memory_gb
        k += 1
    return machines, lat.astype(np.float32)


def _add_machine(machines: list[Machine], lat: np.ndarray, m: Machine,
                 ) -> tuple[list[Machine], np.ndarray]:
    """Append ``m``, copying a same-region peer's latency row (LAN to it)."""
    peer = next(i for i, x in enumerate(machines) if x.region == m.region)
    row = lat[peer].copy()
    n = len(machines)
    lat = np.pad(lat, ((0, 1), (0, 1)))
    lat[n, :n] = row
    lat[:n, n] = row
    lat[n, peer] = lat[peer, n] = 1.0
    lat[n, n] = 0.0
    return machines + [m], lat


def generated_fleet(seed: int, need_gb: float = 0.0, serve_gb: float = 0.0,
                    serve_count: int = 0):
    """Fleet builder for generated scenarios: structure is a pure function
    of the *generator* seed (+ the declared capacity floors); the run seed
    plays the same role as in the hand-authored builders.

    ``need_gb`` grows aggregate memory (training fit); ``serve_gb`` /
    ``serve_count`` guarantee at least ``serve_count`` individual machines
    with ``serve_gb`` of memory, so a drawn serve tenant always has hosts
    whose KV capacity is nonzero (8xA100 boxes are appended round-robin
    over the drawn regions if the topology draw came up short)."""
    def build(run_seed: int) -> ClusterGraph:
        machines, lat = _draw_topology(seed)
        if need_gb > 0:
            machines, lat = _grow_to_fit(machines, lat, seed, need_gb)
        if serve_count > 0 and serve_gb > 0:
            regions = sorted({m.region for m in machines})
            k = 0
            while sum(m.memory_gb >= serve_gb for m in machines) \
                    < serve_count:
                machines, lat = _add_machine(
                    machines, lat,
                    Machine(regions[k % len(regions)], "A100", 8))
                k += 1
        return ClusterGraph(machines, lat.astype(np.float32))
    build.__name__ = f"generated_fleet_{seed}"
    return build


# ---------------------------------------------------------------------------
# Fault-plan draw (environmental only: generated training/colocated runs use
# placers without crash re-planning, and colocation forbids crashes anyway)
# ---------------------------------------------------------------------------
def _draw_fault_plan(seed: int, regions: Sequence[str],
                     n_machines: int) -> Optional[FaultPlan]:
    rng = _rng(seed, 0xFA01)
    if rng.random() >= ENVELOPE["fault_prob"]:
        return None
    injectors: list = []
    for _ in range(int(rng.integers(1, 3))):
        at = float(rng.uniform(0.1, 0.5))
        dur = float(rng.uniform(0.1, min(0.35, 0.9 - at)))
        if rng.random() < 0.5:
            injectors.append(GrayFailure(
                at=at, picks=int(rng.integers(1, 3)),
                slowdown=float(rng.uniform(1.5, 4.0)),
                duration=dur))
        elif len(regions) >= 2:
            a, b = rng.choice(len(regions), size=2, replace=False)
            injectors.append(LinkDegradation(
                at=at, duration=dur,
                regions=(regions[int(a)], regions[int(b)]),
                bw_factor=float(rng.uniform(0.2, 0.7)),
                lat_factor=float(rng.uniform(1.5, 4.0))))
    return FaultPlan(tuple(injectors)) if injectors else None


# ---------------------------------------------------------------------------
# Scenario draws
# ---------------------------------------------------------------------------
def _draw_jitter(seed: int) -> JitterConfig:
    rng = _rng(seed, 0x7177)
    s_lo, s_hi = ENVELOPE["jitter_sigma"]
    f_lo, f_hi = ENVELOPE["straggler_frac"]
    w_lo, w_hi = ENVELOPE["straggler_slowdown"]
    if rng.random() < 0.4:                      # calibration-friendly draw
        return JitterConfig()
    return JitterConfig(
        sigma=float(rng.uniform(s_lo, s_hi)),
        straggler_frac=float(rng.uniform(f_lo, f_hi)),
        straggler_slowdown=float(rng.uniform(w_lo, w_hi)))


# a serve host must fit the weights plus this many KV tokens (the default
# mix's max_prompt + max_gen) inside the 0.9 memory headroom
_SERVE_TOKEN_FLOOR = 5_120
_BIGGEST_BOX_GB = 8 * GPU_CATALOG["A100"][1]     # the appendable host class


def _serve_floor_gb(task: cm.ModelTask) -> float:
    """Memory a machine needs to host ``task``'s serve card at all."""
    kv_bytes = 2.0 * task.n_layers * task.d_model * task.dtype_bytes
    return (task.param_bytes + _SERVE_TOKEN_FLOOR * kv_bytes) / 0.9 / 1e9


def _servable(task: cm.ModelTask) -> bool:
    return _serve_floor_gb(task) <= _BIGGEST_BOX_GB


def _serve_model_for(task: cm.ModelTask, seed: int):
    from repro_torch.serve.costs import serve_model_from_task

    rng = _rng(seed, 0x5E12)
    e_lo, e_hi = ENVELOPE["decode_efficiency"]
    return serve_model_from_task(
        task, name=task.name,
        decode_efficiency=float(rng.uniform(e_lo, e_hi)))


def _serve_traffic_for(model, horizon_s: float, seed: int):
    """Capacity-aware rate draw: target a utilization inside the envelope
    given the fleet's mean machine, so generated serve runs are loaded but
    drainable (the liveness invariant is meaningful, not vacuous)."""
    from repro_torch.serve.traffic import ModelMix, TrafficConfig

    rng = _rng(seed, 0x7AFF)
    u_lo, u_hi = ENVELOPE["serve_util"]
    util = float(rng.uniform(u_lo, u_hi))
    prompt_med = float(rng.uniform(64.0, 384.0))
    gen_med = float(rng.uniform(24.0, 128.0))
    n_rep_lo, n_rep_hi = ENVELOPE["n_replicas"]
    n_replicas = int(rng.integers(n_rep_lo, n_rep_hi + 1))
    # every shape knob is drawn HERE, never inside the closure: traffic() is
    # called once per run and twice per determinism check — a draw inside
    # would advance the generator between calls and break replay
    kw: dict = {}
    if rng.random() < 0.3:
        kw.update(burst_factor=float(rng.uniform(2.0, 5.0)),
                  burst_window=(0.3 * horizon_s, 0.5 * horizon_s))
    elif rng.random() < 0.3:
        kw.update(diurnal_depth=float(rng.uniform(0.5, 0.9)))

    def traffic(graph: ClusterGraph):
        regions = tuple(sorted({m.region for m in graph.machines}))
        mean_tf = float(np.mean([m.tflops for m in graph.machines]))
        per_req = model.service_s(prompt_med, gen_med, mean_tf)
        rate = min(8.0, max(0.5, util * n_replicas / max(per_req, 1e-6)))
        return TrafficConfig(
            rate_rps=rate, horizon_s=horizon_s, regions=regions,
            mixes=(ModelMix(model.name, prompt_median=prompt_med,
                            gen_median=gen_med),), **kw)

    return traffic, n_replicas


def generate_scenario(seed: int):
    """Draw one scenario (pure function of ``seed``): a training
    ``Scenario``, a ``ServeScenario`` or a ``ColocatedScenario``, named
    ``gen_<kind>_<seed>``."""
    rng = _rng(seed, 0x00)
    kind = KINDS[int(rng.integers(0, len(KINDS)))]
    arch = ARCHS[int(rng.integers(0, len(ARCHS)))]
    task = task_from_arch(arch, _rng(seed, 0x7A58))
    jitter = _draw_jitter(seed)

    machines, _ = _draw_topology(seed)
    regions = sorted({m.region for m in machines})
    fleet_gb = sum(m.memory_gb for m in machines)
    margin = ENVELOPE["mem_margin"]

    if kind == "train":
        need = margin * task.min_memory_gb
        fleet = generated_fleet(seed, need_gb=need)
        s_lo, s_hi = ENVELOPE["steps"]
        steps = int(rng.integers(s_lo, s_hi + 1))
        return sc.Scenario(
            name=f"gen_train_{seed}",
            description=f"generated: {task.name} on a "
                        f"{len(regions)}-region fleet (seed {seed})",
            fleet=fleet, tasks=(task,), jitter=jitter,
            fault_plan=_draw_fault_plan(seed, regions, len(machines)),
            steps=steps)

    # serve kinds: the drawn arch must actually be hostable (a 398B card
    # fits no single machine and every request would drop unreachable) —
    # rotate deterministically from the draw to the next servable arch
    start = ARCHS.index(arch)
    for off in range(len(ARCHS)):
        cand = ARCHS[(start + off) % len(ARCHS)]
        cand_task = task_from_arch(cand, _rng(seed, 0x7A58))
        if _servable(cand_task):
            task = cand_task
            break
    serve_gb = _serve_floor_gb(task)
    model = _serve_model_for(task, seed)

    if kind == "serve":
        h_lo, h_hi = ENVELOPE["serve_horizon_s"]
        horizon = float(rng.uniform(h_lo, h_hi))
        traffic, n_replicas = _serve_traffic_for(model, horizon, seed)
        return sc.ServeScenario(
            name=f"gen_serve_{seed}",
            description=f"generated: serving {model.name} over "
                        f"{len(regions)} regions (seed {seed})",
            fleet=generated_fleet(seed, serve_gb=serve_gb,
                                  serve_count=n_replicas),
            traffic=traffic, model=model,
            n_replicas=n_replicas, jitter=jitter,
            slo_s=float(rng.uniform(10.0, 30.0)),
            fault_plan=_draw_fault_plan(seed, regions, len(machines)))

    # colocated: the training tenant must leave room for replicas, so the
    # fleet is grown to a double margin over the task's memory floor AND
    # enough serve-capable hosts
    h_lo, h_hi = ENVELOPE["colo_horizon_s"]
    horizon = float(rng.uniform(h_lo, h_hi))
    traffic, n_replicas = _serve_traffic_for(model, horizon, seed)
    need = 2.0 * margin * task.min_memory_gb
    return sc.ColocatedScenario(
        name=f"gen_colocated_{seed}",
        description=f"generated: {task.name} training beside its own "
                    f"serving tenant (seed {seed})",
        fleet=generated_fleet(seed, need_gb=need, serve_gb=serve_gb,
                              serve_count=n_replicas),
        traffic=traffic, model=model, tasks=(task,),
        n_replicas=n_replicas, jitter=jitter,
        slo_s=float(rng.uniform(10.0, 30.0)),
        steps=int(rng.integers(ENVELOPE["steps"][0],
                               ENVELOPE["steps"][1] + 1)),
        fault_plan=_draw_fault_plan(seed, regions, len(machines)))


def generated_scenarios(n: int, base_seed: int = 0) -> list:
    """``n`` scenarios drawn from consecutive seeds."""
    return [generate_scenario(base_seed + i) for i in range(n)]


# ---------------------------------------------------------------------------
# Invariant suite
# ---------------------------------------------------------------------------
def _run_train(scn: sc.Scenario, seed: int, solver: str):
    graph = scn.fleet(seed)
    placer = FullFleetPlacer("gpipe", scn.tasks, "fuzz")
    fs = FleetSimulation(graph, scn.tasks, placer,
                         comm_model=scn.comm_model, jitter=scn.jitter,
                         fault_plan=scn.fault_plan, traffic=scn.traffic,
                         steps=scn.steps, seed=seed, net_solver=solver)
    return fs.run()


def _check_train(scn: sc.Scenario, seed: int, planes: bool) -> dict:
    from repro_torch.sim.chaos import canonical_fleet

    res = _run_train(scn, seed, "fast")
    dump = canonical_fleet(res)
    assert dump == canonical_fleet(_run_train(scn, seed, "fast")), \
        f"{scn.name}: non-deterministic replay"
    if planes:
        assert dump == canonical_fleet(_run_train(scn, seed, "reference")), \
            f"{scn.name}: fast != reference data plane"
    # conservation + liveness: exactly `steps` steps each, all finished
    for name, d in res.per_task.items():
        assert not d["failed"], f"{scn.name}: task {name} failed"
        assert len(d["step_times"]) == scn.steps, \
            f"{scn.name}: task {name} ran {len(d['step_times'])} steps, " \
            f"declared {scn.steps}"
    assert math.isfinite(res.makespan), f"{scn.name}: infinite makespan"

    # calibration: the zero-jitter, fault-free twin must match the analytic
    # cost model within CAL_RTOL (the sim's founding contract)
    graph = scn.fleet(seed)
    task = scn.tasks[0]
    ids = list(range(graph.n))
    order = cm.greedy_chain_order(graph, ids)
    comm = cm.make_comm(graph, scn.comm_model)
    c, p = analytic_step_time(graph, ids, task, comm, "gpipe", order)
    want = c + p
    got = simulate_single(graph, ids, task, "gpipe",
                          comm_model=scn.comm_model, steps=1,
                          seed=seed).mean_step_s(task.name)
    assert math.isfinite(want) and math.isfinite(got), \
        f"{scn.name}: calibration run infeasible"
    rel = abs(got - want) / max(want, 1e-12)
    assert rel <= CAL_RTOL, \
        f"{scn.name}: calibration off by {rel:.2%} " \
        f"(sim {got:.3f}s vs analytic {want:.3f}s)"
    return {"makespan": res.makespan, "calibration_rel_err": rel}


def _check_serve(scn: sc.ServeScenario, seed: int, planes: bool) -> dict:
    from repro_torch.sim.chaos import canonical_records, check_invariants
    from repro_torch.serve.evaluate import run_serve

    _, raw = run_serve(scn, "least_loaded", seed=seed)
    dump = canonical_records(raw)
    counts = check_invariants(raw)
    assert counts["unresolved"] == 0, \
        f"{scn.name}: {counts['unresolved']} requests never resolved"
    _, again = run_serve(scn, "least_loaded", seed=seed)
    assert dump == canonical_records(again), \
        f"{scn.name}: non-deterministic replay"
    if planes:
        _, ref = run_serve(scn, "least_loaded", seed=seed,
                           data_plane="reference")
        assert dump == canonical_records(ref), \
            f"{scn.name}: fast != reference data plane"
    return counts


def _check_colocated(scn: sc.ColocatedScenario, seed: int,
                     planes: bool) -> dict:
    res = run_colocated(scn, "least_loaded", seed=seed,
                        train_placer="greedy")
    dump = canonical_colocated(res)
    check_colocated_invariants(res, scn)
    again = run_colocated(scn, "least_loaded", seed=seed,
                          train_placer="greedy")
    assert dump == canonical_colocated(again), \
        f"{scn.name}: non-deterministic replay"
    if planes:
        ref = run_colocated(scn, "least_loaded", seed=seed,
                            train_placer="greedy", data_plane="reference")
        assert dump == canonical_colocated(ref), \
            f"{scn.name}: fast != reference data plane"
    s = res["serve"]
    return {"completed": s.n_completed, "dropped": s.n_dropped,
            "train_makespan": res["train"].makespan,
            "overlap": len(res["overlap"])}


def check_scenario(scn, seed: int = 0, planes: bool = True) -> dict:
    """Run ``scn``'s declared invariant suite; raises ``AssertionError`` on
    the first violation, else returns a small report dict."""
    if isinstance(scn, sc.Scenario):
        return _check_train(scn, seed, planes)
    if isinstance(scn, sc.ServeScenario):
        return _check_serve(scn, seed, planes)
    if isinstance(scn, sc.ColocatedScenario):
        return _check_colocated(scn, seed, planes)
    raise TypeError(f"not a generatable scenario: {type(scn).__name__}")


def fuzz_one(seed: int, planes: bool = True) -> dict:
    """Generate the seed's scenario and run its invariant suite."""
    scn = generate_scenario(seed)
    report = check_scenario(scn, seed=seed, planes=planes)
    return {"seed": seed, "name": scn.name,
            "kind": type(scn).__name__,
            "invariants": list(declared_invariants(scn)),
            "fault_plan": bool(scn.fault_plan),
            "report": report}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Property-based scenario generator / invariant fuzzer")
    ap.add_argument("--fuzz", action="store_true",
                    help="check generated scenarios against the invariant "
                         "suite")
    ap.add_argument("--seeds", type=int, default=5,
                    help="number of consecutive seeds to draw")
    ap.add_argument("--base-seed", type=int, default=0)
    ap.add_argument("--no-planes", action="store_true",
                    help="skip the reference-data-plane cross-check")
    ap.add_argument("--show", action="store_true",
                    help="print the drawn scenarios without running them")
    args = ap.parse_args(argv)

    if args.show:
        for i in range(args.seeds):
            scn = generate_scenario(args.base_seed + i)
            print(f"{scn.name}: {scn.description}")
        return 0
    if not args.fuzz:
        ap.print_help()
        return 2

    failures = 0
    for i in range(args.seeds):
        seed = args.base_seed + i
        try:
            out = fuzz_one(seed, planes=not args.no_planes)
            print(f"seed {seed}: OK {out['name']} "
                  f"[{', '.join(out['invariants'])}] "
                  f"{json.dumps(out['report'], default=str)}")
        except AssertionError as e:
            failures += 1
            print(f"seed {seed}: FAIL {e}")
    print(f"{args.seeds - failures}/{args.seeds} generated scenarios clean")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
