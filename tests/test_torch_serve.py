"""repro_torch.serve against the reference: the tests of ``test_serve.py``
on the port (traffic, replica calibration, routing, failure re-routing,
autoscaling through the elastic runtime, the scenario registry), the HLO
calibration fed by a port cost card, every serving scenario x policy against
the reference's raw records and ``summarize``, the comparison table, and
``HulkPlacement`` at 64 nodes.

Everything but the GNN is a numpy copy, so runs must be equal byte for byte
(``repro.sim.chaos.canonical_records``) and field by field. The Hulk policy
places through the GNN: the port's cache holds the reference's params
(``_torch_parity.seed_serve_gnn``), so its runs must be equal too.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import repro.serve.costs as jcosts
from _torch_parity import (as_json, assert_same_serve_run, cold, result_json,
                           seed_serve_gnn)
from repro.core import cost_model as jcm
from repro.core import graph as jgraph
from repro.core import train as jtrain
from repro.serve import evaluate as jse
from repro.serve import router as jrouter
from repro.sim import scenarios as jsc
from repro.sim import workload as jwl
from repro_torch.core import cost_model as cm
from repro_torch.core import graph as tgraph
from repro_torch.core import train as ttrain
from repro_torch.core.graph import ClusterGraph, Machine, paper_fig1_graph
from repro_torch.serve import (AutoscaleConfig, ModelMix, TrafficConfig,
                               generate, region_rate, serve_model_from_hlo,
                               serve_model_from_task, trace_stats)
from repro_torch.serve import evaluate as tse
from repro_torch.serve.evaluate import (evaluate_serve_scenario, run_serve,
                                        serve_gnn, summarize)
from repro_torch.serve.router import (HulkPlacement, StaticPlacement,
                                      entry_node)
from repro_torch.sim import SERVE_SCENARIOS, ServeExecutor, get_serve_scenario
from repro_torch.sim import scenarios as tsc
from repro_torch.sim import workload as twl

CHAT = serve_model_from_task(cm.ModelTask("Chat-34B", 34e9, 60, 7168),
                             name="chat-34b", decode_efficiency=0.01)
J_CHAT = jcosts.serve_model_from_task(
    jcm.ModelTask("Chat-34B", 34e9, 60, 7168), name="chat-34b",
    decode_efficiency=0.01)
MIX = (ModelMix("chat-34b", prompt_median=64.0, gen_median=24.0),)
POLICIES = ("nearest", "least_loaded", "hulk")
SCORE_TOL = 1e-5            # the GNN logits' parity (tests/test_kernels.py)


@pytest.fixture(scope="module", autouse=True)
def seeded():
    """The reference's serve GNNs in the port's cache: the chat card at the
    replica counts the tests ask for, and every serving scenario's."""
    for n in (2, 3, 8):
        seed_serve_gnn(J_CHAT, CHAT, n)
    for name in sorted(jsc.SERVE_SCENARIOS):
        ref, port = jsc.get_serve_scenario(name), tsc.get_serve_scenario(name)
        seed_serve_gnn(ref.model, port.model, ref.n_replicas)


def _single_machine_graph(tflops=100.0, memory_gb=512.0):
    m = Machine.from_caps("California", capability=8.0, memory_gb=memory_gb,
                          tflops=tflops, label="calib")
    return ClusterGraph([m], np.zeros((1, 1), np.float32))


def _requests(n, prompt=64, gen=24, model="chat-34b", region="California",
              spacing=0.0):
    from repro_torch.serve import Request
    return [Request(rid=i, t_arrival=i * spacing, region=region, model=model,
                    prompt_tokens=prompt, gen_tokens=gen) for i in range(n)]


# ---------------------------------------------------------------------------
# Traffic generator
# ---------------------------------------------------------------------------
def test_traffic_deterministic():
    cfg = TrafficConfig(rate_rps=3.0, horizon_s=200.0,
                        regions=("Beijing", "London", "California"),
                        mixes=MIX, diurnal_depth=0.7)
    a, b = generate(cfg, seed=4), generate(cfg, seed=4)
    assert [dataclasses.astuple(r) for r in a] \
        == [dataclasses.astuple(r) for r in b]
    c = generate(cfg, seed=5)
    assert [r.t_arrival for r in a] != [r.t_arrival for r in c]
    assert all(a[i].t_arrival <= a[i + 1].t_arrival
               for i in range(len(a) - 1))
    assert all(r.rid == i for i, r in enumerate(a))
    assert trace_stats(a)["n_requests"] == len(a)


def test_burst_window_concentrates_arrivals():
    base = TrafficConfig(rate_rps=2.0, horizon_s=300.0,
                         regions=("Beijing", "London"), mixes=MIX)
    burst = dataclasses.replace(base, burst_factor=8.0,
                                burst_window=(100.0, 150.0),
                                burst_region="Beijing")
    bj = base.regions.index("Beijing")
    assert region_rate(burst, bj, 50.0) == region_rate(base, bj, 50.0)
    assert region_rate(burst, bj, 120.0) \
        == pytest.approx(8.0 * region_rate(base, bj, 120.0))
    tr = generate(burst, seed=0)
    in_w = [r for r in tr if 100.0 <= r.t_arrival < 150.0
            and r.region == "Beijing"]
    out_w = [r for r in tr if 200.0 <= r.t_arrival < 250.0
             and r.region == "Beijing"]
    assert len(in_w) > 3 * max(len(out_w), 1)


def test_diurnal_follow_the_sun_phases_regions():
    cfg = TrafficConfig(rate_rps=2.0, horizon_s=400.0,
                        regions=("Beijing", "California"), mixes=MIX,
                        diurnal_depth=1.0)
    t_grid = np.linspace(0, 400.0, 200)
    bj = np.array([region_rate(cfg, 0, t) for t in t_grid])
    ca = np.array([region_rate(cfg, 1, t) for t in t_grid])
    assert abs(t_grid[bj.argmax()] - t_grid[ca.argmax()]) > 100.0
    assert np.mean(bj) == pytest.approx(1.0, rel=0.05)


# ---------------------------------------------------------------------------
# Replica calibration: sim == analytic per-token costs
# ---------------------------------------------------------------------------
def test_single_request_latency_is_analytic_service_time():
    g = _single_machine_graph(tflops=100.0)
    trace = _requests(1)
    raw = ServeExecutor(g, CHAT, trace, "nearest", n_replicas=1,
                        max_batch=4, seed=0).run()
    rec = raw["records"][0]
    req = rec.req
    want = CHAT.service_s(req.prompt_tokens, req.gen_tokens, 100.0)
    assert rec.latency_s == pytest.approx(want, rel=1e-9)


@pytest.fixture(scope="module")
def hlo_cards():
    """The reference's HLO-priced card of reduced gemma3-1b, and the port's
    card built by the port's ``serve_model_from_hlo`` from the very analysis
    dicts the reference priced it from (the port cannot lower a program to
    HLO; ``serve_model_from_config`` is a later slice)."""
    from repro.configs import get_config, reduce_for_smoke
    seen = []
    orig = jcosts.serve_model_from_hlo

    def capture(*args, **kw):
        seen.append((args, kw))
        return orig(*args, **kw)

    cfg = dataclasses.replace(reduce_for_smoke(get_config("gemma3-1b")),
                              remat=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcosts, "serve_model_from_hlo", capture)
        ref = jcosts.serve_model_from_config(cfg, batch=2, prompt_len=16,
                                             gen_tokens=8,
                                             name="gemma3-smoke")
    (args, kw), = seen
    return ref, serve_model_from_hlo(*args, **kw)


def test_hlo_card_equals_the_reference(hlo_cards):
    ref, port = hlo_cards
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_zero_contention_throughput_matches_hlo_costs_within_1pct(hlo_cards):
    """A zero-contention, single-region serving simulation reproduces the
    analytic replica throughput of the HLO-derived per-token costs within
    1%, and the run equals the reference's."""
    ref_sm, sm = hlo_cards
    assert sm.prefill_flops_per_token > 0 and sm.decode_flops_per_token > 0
    tflops = 1e-3
    g = _single_machine_graph(tflops=tflops, memory_gb=1.0)
    trace = _requests(32, prompt=24, gen=16, model=sm.name)
    raw = ServeExecutor(g, sm, trace, "nearest", n_replicas=1, max_batch=4,
                        seed=0).run()
    recs = list(raw["records"].values())
    assert all(r.latency_s is not None for r in recs)
    t_end = max(r.t_complete for r in recs)
    analytic = sum(sm.service_s(r.req.prompt_tokens, r.req.gen_tokens,
                                tflops) for r in recs)
    assert abs(t_end - analytic) / analytic < 0.01
    rep = raw["replicas"][0]
    decode_s = sum(sm.decode_work(1) for _ in range(rep["tokens_decoded"])) \
        / (tflops * 1e12)
    prefill_s = sm.prefill_work(rep["tokens_prefilled"]) / (tflops * 1e12)
    assert rep["busy_s"] == pytest.approx(decode_s + prefill_s, rel=1e-6)

    from repro.serve import Request as JRequest
    jg = jgraph.ClusterGraph([jgraph.Machine.from_caps(
        "California", capability=8.0, memory_gb=1.0, tflops=tflops,
        label="calib")], np.zeros((1, 1), np.float32))
    jtrace = [JRequest(**dataclasses.asdict(r)) for r in trace]
    jraw = jwl.ServeExecutor(jg, ref_sm, jtrace, "nearest", n_replicas=1,
                             max_batch=4, seed=0).run()
    assert_same_serve_run(jraw, raw, "hlo calibration")


def test_kv_capacity_limits_admission():
    kv_per_seq = (64 + 24) * CHAT.kv_bytes_per_token
    mem_gb = (CHAT.weight_bytes + 2.4 * kv_per_seq) / 0.9 / 1e9
    g = _single_machine_graph(tflops=50.0, memory_gb=mem_gb)
    trace = _requests(12)
    raw = ServeExecutor(g, CHAT, trace, "nearest", n_replicas=1,
                        max_batch=8, seed=0).run()
    recs = list(raw["records"].values())
    done = [r for r in recs if r.latency_s is not None]
    assert len(done) >= 8
    assert raw["replicas"][0]["mean_batch"] <= 2.5


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------
def _star_graph():
    """Entry at London (too little memory to host a replica); replicas on
    near (Paris) and far (Tokyo) A100 machines."""
    machines = [Machine.from_caps("London", capability=7.0, memory_gb=32.0,
                                  tflops=500.0, label="edge"),
                Machine("Paris", "A100", 8), Machine("Tokyo", "A100", 8)]
    lat = np.array([[0, 10, 200], [10, 0, 210], [200, 210, 0]], np.float32)
    return ClusterGraph(machines, lat)


def test_nearest_routes_to_lowest_latency():
    g = _star_graph()
    cfgT = TrafficConfig(rate_rps=0.5, horizon_s=20.0, regions=("London",),
                         mixes=MIX)
    trace = generate(cfgT, seed=0)
    raw = ServeExecutor(g, CHAT, trace, "nearest", n_replicas=3,
                        seed=0).run()
    assert entry_node(g, "London") == 0
    for rec in raw["records"].values():
        assert rec.machines[0] == 1


def test_least_loaded_sheds_from_hot_replica():
    g = _star_graph()
    trace = generate(TrafficConfig(rate_rps=8.0, horizon_s=60.0,
                                   regions=("London",), mixes=MIX), seed=2)
    raw = ServeExecutor(g, CHAT, trace, "least_loaded", n_replicas=3,
                        seed=0).run()
    used = {m for rec in raw["records"].values() for m in rec.machines}
    assert len(used) >= 2


def test_replica_failure_scenario_backfills_capacity():
    scn = get_serve_scenario("serve_replica_failure")
    res, raw = run_serve(scn, "least_loaded", seed=0)
    failed = [e for e in raw["scale_log"] if e["event"] == "replica_failed"]
    assert len(failed) == 1
    assert res.n_completed > 0.9 * res.n_requests
    assert any(e["event"] == "replica_up" and e["t"] > failed[0]["t"]
               for e in raw["scale_log"])


def test_replica_failure_under_load_reroutes_interrupted_requests():
    g = _star_graph()
    trace = _requests(60, prompt=128, gen=64, region="London", spacing=0.05)
    raw = ServeExecutor(g, CHAT, trace, "least_loaded", n_replicas=2,
                        fault_fracs=(0.5,), seed=0).run()
    failed = [e for e in raw["scale_log"] if e["event"] == "replica_failed"]
    assert len(failed) == 1
    recs = list(raw["records"].values())
    rerouted = [r for r in recs if r.n_routes > 1]
    assert rerouted, "no interrupted request was re-routed"
    assert all(r.latency_s is not None for r in recs)
    survivor = ({1, 2} - {failed[0]["machine"]}).pop()
    assert all(r.machines[-1] == survivor for r in rerouted)


# ---------------------------------------------------------------------------
# Autoscaling
# ---------------------------------------------------------------------------
def test_autoscaler_scales_up_under_queue_pressure_and_down_when_idle():
    g = paper_fig1_graph()
    regions = tuple(dict.fromkeys(m.region for m in g.machines))
    cfgT = TrafficConfig(rate_rps=12.0, horizon_s=120.0, regions=regions,
                         mixes=MIX)
    trace = [r for r in generate(cfgT, seed=3) if r.t_arrival < 60.0]
    auto = AutoscaleConfig(check_period_s=5.0, queue_high=2.0, queue_low=0.1,
                           min_replicas=1, max_replicas=5, cooldown_s=10.0)
    raw = ServeExecutor(g, CHAT, trace, "least_loaded", n_replicas=1,
                        autoscale=auto, seed=0, run_until_s=1200.0).run()
    actions = [e["action"] for e in raw["autoscale_log"]]
    assert "up" in actions
    assert "down" in actions
    ups = [e for e in raw["scale_log"] if e["event"] == "replica_up"]
    assert ups, "scale-up never started a replica"


def _join_case(pkg_graph, pkg_serve, chat, params, cfg, executor):
    machines = [pkg_graph.Machine("California", "A5000", 8),
                pkg_graph.Machine("California", "RTX3090", 8)]
    lat = np.array([[0.0, 1.0], [1.0, 0.0]], np.float32)
    g = pkg_graph.ClusterGraph(machines, lat)
    mix = (pkg_serve.ModelMix("chat-34b", prompt_median=64.0,
                              gen_median=24.0),)
    trace = pkg_serve.generate(pkg_serve.TrafficConfig(
        rate_rps=20.0, horizon_s=40.0, regions=("California",), mixes=mix),
        seed=1)
    auto = pkg_serve.AutoscaleConfig(check_period_s=4.0, queue_high=1.0,
                                     queue_low=0.0, min_replicas=2,
                                     max_replicas=4, cooldown_s=8.0)
    spares = (pkg_graph.Machine("California", "A100", 8),)
    return executor(g, chat, trace, "hulk", params=params, cfg=cfg,
                    n_replicas=2, autoscale=auto, spares=spares,
                    seed=0, run_until_s=2000.0).run()


def test_hulk_autoscale_drives_elastic_on_join():
    """Scale-up beyond the in-fleet pool provisions a spare machine through
    ElasticRuntime.on_join; the run equals the reference's."""
    import repro.serve as jserve
    import repro_torch.serve as tserve
    params, cfg = serve_gnn(CHAT, 2, seed=0)
    raw = cold(lambda: _join_case(tgraph, tserve, CHAT, params, cfg,
                                  ServeExecutor))
    joins = [e for e in raw["scale_log"] if e["event"] == "join"]
    assert joins, "spare machine was never provisioned"
    assert joins[0]["machine"] == 2
    assert raw["records"] and all(
        r.latency_s is not None or r.dropped
        for r in raw["records"].values())
    jparams, jcfg = jse.serve_gnn(J_CHAT, 2, seed=0)
    jraw = cold(lambda: _join_case(jgraph, jserve, J_CHAT, jparams, jcfg,
                                   jwl.ServeExecutor))
    assert_same_serve_run(jraw, raw, "hulk join")


def test_hulk_placement_prefers_capable_machines():
    g = paper_fig1_graph()
    params, cfg = serve_gnn(CHAT, 3, seed=0)
    pl = HulkPlacement(g, CHAT, 3, params, cfg)
    static = StaticPlacement(g, CHAT, 3)
    tf = g.tflops()
    assert len(pl.desired()) == 3
    assert sum(tf[i] for i in pl.desired()) \
        >= sum(tf[i] for i in static.desired())
    assert pl.runtime.assignment.groups


def test_serve_gnn_without_a_seeded_entry_wants_a_card():
    """An uncached serve GNN trains on CUDA by default, and no card means an
    error, not a quiet CPU run."""
    if torch.cuda.is_available():
        pytest.skip("the machine has a card")
    lonely = dataclasses.replace(CHAT, name="chat-34b-unseeded")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_gnn(lonely, 2, seed=0)


# ---------------------------------------------------------------------------
# Scenarios + evaluation
# ---------------------------------------------------------------------------
def test_serve_registry_has_required_scenarios():
    required = {"serve_diurnal", "serve_regional_burst",
                "serve_replica_failure"}
    assert required <= set(SERVE_SCENARIOS)
    with pytest.raises(KeyError):
        get_serve_scenario("no_such_serve_scenario")


@pytest.mark.parametrize("name", sorted(jsc.SERVE_SCENARIOS))
def test_serve_scenarios_run_deterministically(name):
    scn = get_serve_scenario(name)
    a, _ = run_serve(scn, "least_loaded", seed=0)
    b, _ = run_serve(scn, "least_loaded", seed=0)
    assert a.n_events == b.n_events
    assert a.p95_s == b.p95_s
    assert a.n_completed == b.n_completed > 0
    assert math.isfinite(a.p95_s)


def _captured_serve(wl, fn):
    """``fn()`` with every ``ServeExecutor.run`` result of ``wl`` kept, in
    order."""
    runs = []
    orig = wl.ServeExecutor.run

    def run(self):
        raw = orig(self)
        runs.append(raw)
        return raw

    wl.ServeExecutor.run = run
    try:
        return fn(), runs
    finally:
        wl.ServeExecutor.run = orig


@pytest.fixture(scope="module")
def evaluated():
    """``evaluate_all_serve(seed=0)`` in both packages, each run kept."""
    ref, ref_runs = _captured_serve(jwl, lambda: cold(
        lambda: jse.evaluate_all_serve(0)))
    port, port_runs = _captured_serve(twl, lambda: cold(
        lambda: tse.evaluate_all_serve(0)))
    names = sorted(jsc.SERVE_SCENARIOS)
    assert list(ref) == list(port) == names
    assert len(ref_runs) == len(port_runs) == len(names) * len(POLICIES)
    raws = {}
    for i, (name, policy) in enumerate(
            (n, p) for n in names for p in POLICIES):
        raws[name, policy] = ref_runs[i], port_runs[i]
    return ref, port, raws


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", sorted(jsc.SERVE_SCENARIOS))
def test_scenario_policy_matches_reference(evaluated, name, policy):
    """Raw records byte for byte, every other field of the run, and the
    ``summarize`` row field by field."""
    ref, port, raws = evaluated
    ref_raw, port_raw = raws[name, policy]
    assert ref_raw["policy"] == port_raw["policy"] == policy
    assert_same_serve_run(ref_raw, port_raw, f"{name}/{policy}")
    slo = tsc.get_serve_scenario(name).slo_s
    assert result_json(summarize(port_raw, slo)) \
        == result_json(jse.summarize(ref_raw, slo))
    row_ref, row_port = ref[name][policy], port[name][policy]
    assert as_json(row_port) == as_json(row_ref)


def test_hulk_vs_nearest_and_table_match_reference(evaluated):
    ref, port, _ = evaluated
    for name in ref:
        assert as_json(port[name]["hulk_vs_nearest"]) \
            == as_json(ref[name]["hulk_vs_nearest"]), name
        assert port[name]["n_requests"] == ref[name]["n_requests"]
    assert tse.serve_comparison_table(port) == jse.serve_comparison_table(ref)


def test_hulk_beats_nearest_on_diurnal():
    row = evaluate_serve_scenario(get_serve_scenario("serve_diurnal"),
                                  seed=0)
    assert row["hulk_vs_nearest"]["hulk_beats_nearest"] is True
    assert row["hulk"]["p95_s"] < row["nearest"]["p95_s"]


def test_summarize_metrics_are_consistent():
    scn = get_serve_scenario("serve_regional_burst")
    res, raw = run_serve(scn, "least_loaded", seed=0)
    again = summarize(raw, scn.slo_s)
    assert again.as_dict() == res.as_dict()
    assert res.n_requests == res.n_completed + res.n_dropped \
        + res.n_incomplete
    assert 0.0 <= res.slo_violation_rate <= 1.0
    assert res.p50_s <= res.p95_s <= res.p99_s
    assert res.goodput_rps <= res.n_requests / max(raw["horizon_s"], 1e-9)


# ---------------------------------------------------------------------------
# HulkPlacement at 64 nodes
# ---------------------------------------------------------------------------
def test_hulk_placement_at_64_nodes_matches_reference():
    """Scores within the logits' tolerance, then the same replica hosts, the
    same runtime group, and the same re-plan after a host fails. A host
    swap would come from two scores closer than the logits' gap: the
    message names the smallest gap between ranked scores."""
    jparams, jcfg = jse.serve_gnn(J_CHAT, 8, seed=0)
    params, cfg = serve_gnn(CHAT, 8, seed=0)
    jg, g = jgraph.random_fleet(64, seed=7), tgraph.random_fleet(64, seed=7)
    ref = jrouter.HulkPlacement(jg, J_CHAT, 8, jparams, jcfg)
    port = HulkPlacement(g, CHAT, 8, params, cfg)
    np.testing.assert_allclose(port.scores, ref.scores, rtol=0,
                               atol=SCORE_TOL)
    ranked = np.sort(ref.scores)[::-1]
    gap = float(np.min(np.diff(ranked)[np.diff(ranked) != 0] * -1))
    assert port.desired() == ref.desired(), \
        f"hosts differ; smallest gap between distinct scores {gap:.3g}"
    assert port.runtime.assignment.groups == ref.runtime.assignment.groups
    victim = ref.desired()[0]
    ref.on_machine_failed(victim)
    port.on_machine_failed(victim)
    assert port.rt2fleet == ref.rt2fleet
    assert port.runtime.assignment.groups == ref.runtime.assignment.groups
    assert port.acquire() == ref.acquire()
    np.testing.assert_allclose(
        ttrain.predict_logits(params, cfg, g, device="cpu"),
        jtrain.predict_logits(jparams, jcfg, jg), rtol=0, atol=SCORE_TOL)
