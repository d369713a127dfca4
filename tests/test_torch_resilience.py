"""repro_torch.serve.resilience against the reference: the tests of
``test_resilience.py`` on the port (circuit-breaker semantics, retry / hedge /
breaker / shed through ``ServeExecutor``, router fail-open, the max_routes cap
and drop-reason tagging, off by default), and resilient runs compared with
the reference's byte for byte (numpy copies: no tolerance)."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from _torch_parity import assert_same_serve_run, cold_forwards
from repro import obs as jobs
from repro.core import cost_model as jcm
from repro.core.graph import paper_fig1_graph as j_fig1
from repro.serve import resilience as jres
from repro.serve import traffic as jtraffic
from repro.serve.costs import serve_model_from_task as j_card
from repro.sim import faults as jfm
from repro.sim import workload as jwl

from repro_torch import obs as obs_mod
from repro_torch.core import cost_model as cm
from repro_torch.core.graph import paper_fig1_graph
from repro_torch.serve import Request
from repro_torch.serve.costs import serve_model_from_task
from repro_torch.serve.evaluate import summarize
from repro_torch.serve.resilience import (BreakerPolicy, CircuitBreaker,
                                    HedgePolicy, ResilienceConfig,
                                    RetryPolicy, ShedPolicy)
from repro_torch.serve.traffic import ModelMix, TrafficConfig, generate
from repro_torch.sim import faults as fm
from repro_torch.sim.chaos import check_invariants
from repro_torch.sim.workload import ServeExecutor

CHAT = serve_model_from_task(cm.ModelTask("Chat-34B", 34e9, 60, 7168),
                             name="chat-34b", decode_efficiency=0.01)


# ---------------------------------------------------------------------------
# CircuitBreaker unit semantics
# ---------------------------------------------------------------------------
def test_breaker_opens_at_threshold_and_halfopen_reopens():
    br = CircuitBreaker(BreakerPolicy(failure_threshold=3, probation_s=10.0))
    assert br.allow(0, now=0.0)
    assert br.record_failure(0, 0.0) is False
    assert br.record_failure(0, 0.5) is False
    assert br.record_failure(0, 1.0) is True      # third strike opens
    assert not br.allow(0, 5.0)
    assert br.open_machines(5.0) == [0]
    assert br.allow(0, 11.0)                      # probation elapsed
    # half-open: the count is retained, one more failure re-opens at once
    assert br.record_failure(0, 11.0) is True
    assert br.ejections == 2


def test_breaker_success_and_reset_clear_history():
    br = CircuitBreaker(BreakerPolicy(failure_threshold=2, probation_s=5.0))
    br.record_failure(1, 0.0)
    br.record_success(1)
    assert br.record_failure(1, 1.0) is False     # count restarted
    br.record_failure(2, 0.0)
    br.record_failure(2, 0.0)
    assert not br.allow(2, 1.0)
    br.reset(2)                                   # machine was replaced
    assert br.allow(2, 1.0)
    assert br.open_machines(1.0) == []


def test_resilience_config_default_has_no_shedding():
    cfg = ResilienceConfig.default()
    assert cfg.retry is not None
    assert cfg.hedge is not None
    assert cfg.breaker is not None
    assert cfg.shed is None


# ---------------------------------------------------------------------------
# Executor integration
# ---------------------------------------------------------------------------
def _trace(graph, seed=0, rate=2.0, horizon=40.0):
    regions = tuple(sorted({m.region for m in graph.machines}))
    cfg = TrafficConfig(rate_rps=rate, horizon_s=horizon, regions=regions,
                        mixes=(ModelMix("chat-34b", prompt_median=96.0,
                                        gen_median=32.0),))
    return generate(cfg, seed=seed)


def _serve(plan=None, resilience=None, policy="nearest", seed=0, **kw):
    g = paper_fig1_graph(seed)
    ex = ServeExecutor(g, CHAT, _trace(g, seed), policy, n_replicas=3,
                       fault_plan=plan, resilience=resilience, seed=seed,
                       **kw)
    return ex, ex.run()


def _hosts(policy="nearest", seed=0):
    """Replica hosts of the fault-free twin (same seed => same placement)."""
    ex, _ = _serve(policy=policy, seed=seed)
    return tuple(sorted(ex.replicas))


def _gray_plan(hosts, slowdown=30.0):
    """One replica host silently slows - invisible to the router's load
    estimate, exactly the failure the resilience layer exists for."""
    return fm.FaultPlan((fm.GrayFailure(at=0.1, machines=hosts[:1],
                                        slowdown=slowdown),))


def test_resilience_is_off_by_default():
    _, raw = _serve()
    assert all(r.retries == 0 and r.hedges == 0
               for r in raw["records"].values())
    res = summarize(raw, slo_s=10.0)
    assert res.retries == 0 and res.hedges == 0
    assert res.drops_by_reason.get("retry_budget", 0) == 0


def test_retry_times_out_gray_attempts_and_recovers():
    plan = _gray_plan(_hosts())
    _, naive = _serve(plan)
    rec = obs_mod.Recorder()
    rcfg = ResilienceConfig(retry=RetryPolicy(timeout_s=3.0, max_retries=3,
                                              backoff_base_s=0.2))
    _, resil = _serve(plan, resilience=rcfg, obs=rec)
    check_invariants(resil, rec)
    c = rec.metrics.snapshot()["counters"]
    assert c["serve.retries"] > 0
    assert c["serve.attempt_timeouts"] > 0
    assert sum(r.retries for r in resil["records"].values()) \
        == c["serve.retries"]

    def p95(raw):
        lats = [r.latency_s for r in raw["records"].values()
                if r.latency_s is not None]
        return float(np.percentile(lats, 95))
    assert p95(resil) < p95(naive)


def test_hedging_launches_speculative_attempts():
    plan = _gray_plan(_hosts())
    rec = obs_mod.Recorder()
    rcfg = ResilienceConfig(hedge=HedgePolicy(delay_s=1.5, max_hedges=1))
    _, raw = _serve(plan, resilience=rcfg, obs=rec)
    check_invariants(raw, rec)   # first-completion-wins stays exactly-once
    c = rec.metrics.snapshot()["counters"]
    assert c["serve.hedges"] > 0
    assert c["serve.hedge_wins"] > 0
    assert c["serve.hedge_wins"] <= c["serve.hedges"]
    assert sum(r.hedges for r in raw["records"].values()) \
        == c["serve.hedges"]


def test_breaker_ejects_failing_machine_without_outage():
    plan = _gray_plan(_hosts(), slowdown=60.0)
    rec = obs_mod.Recorder()
    rcfg = ResilienceConfig(
        retry=RetryPolicy(timeout_s=2.0, max_retries=3, backoff_base_s=0.2),
        breaker=BreakerPolicy(failure_threshold=2, probation_s=30.0))
    _, raw = _serve(plan, resilience=rcfg, obs=rec)
    counts = check_invariants(raw, rec)
    c = rec.metrics.snapshot()["counters"]
    assert c["serve.breaker_failures"] > 0
    assert c["serve.breaker_ejections"] >= 1
    assert counts["completed"] > 0   # ejection degrades, never blacks out


def test_shed_drops_doomed_requests_at_arrival():
    rec = obs_mod.Recorder()
    rcfg = ResilienceConfig(shed=ShedPolicy(deadline_s=0.01))
    _, raw = _serve(resilience=rcfg, obs=rec)
    counts = check_invariants(raw, rec)
    assert counts["completed"] == 0
    assert counts["reasons"] == {"deadline": counts["offered"]}
    c = rec.metrics.snapshot()["counters"]
    assert c["serve.shed"] == counts["offered"]
    res = summarize(raw, slo_s=10.0)
    assert res.drops_by_reason == {"deadline": counts["offered"]}


def test_router_fails_open_when_breaker_bans_everyone():
    ex, _ = _serve()
    reps = [r for r in ex.replicas.values() if r.alive]
    br = CircuitBreaker(BreakerPolicy(failure_threshold=1, probation_s=1e9))
    for rep in reps:
        br.record_failure(rep.machine, 0.0)
    assert br.open_machines(1.0) == sorted(r.machine for r in reps)
    req = Request(rid=0, t_arrival=0.0, region="California",
                  model="chat-34b", prompt_tokens=64, gen_tokens=24)
    picked = ex.router.pick(req, reps, breaker=br, now=1.0)
    assert picked is not None        # degraded routing, not an outage


# ---------------------------------------------------------------------------
# max_routes cap + drop-reason tagging (ServeExecutor.MAX_ROUTES satellite)
# ---------------------------------------------------------------------------
def test_max_routes_default_and_override():
    assert ServeExecutor.MAX_ROUTES == 5
    ex, _ = _serve()
    assert ex.max_routes == 5
    ex1, _ = _serve(max_routes=1)
    assert ex1.max_routes == 1


def test_max_routes_exhaustion_is_tagged():
    # gray the host first so a queue is pending when the crash lands -
    # every interrupted request then needs a second route
    host = _hosts()[0]
    plan = fm.FaultPlan((
        fm.GrayFailure(at=0.1, machines=(host,), slowdown=30.0),
        fm.MachineCrash(at=0.5, machines=(host,)),
    ))
    _, capped = _serve(plan, max_routes=1)
    res = summarize(capped, slo_s=10.0)
    assert res.drops_by_reason.get("max_routes", 0) >= 1
    tagged = [r for r in capped["records"].values()
              if r.dropped and r.drop_reason == "max_routes"]
    assert len(tagged) == res.drops_by_reason["max_routes"]
    # with the default budget the same crash just reroutes
    _, roomy = _serve(plan)
    assert summarize(roomy, slo_s=10.0).drops_by_reason.get(
        "max_routes", 0) == 0


# ---------------------------------------------------------------------------
# Across the packages
# ---------------------------------------------------------------------------
J_CHAT = j_card(jcm.ModelTask("Chat-34B", 34e9, 60, 7168), name="chat-34b",
                decode_efficiency=0.01)


def _ref_serve(plan=None, resilience=None, policy="nearest", seed=0, **kw):
    g = j_fig1(seed)
    regions = tuple(sorted({m.region for m in g.machines}))
    cfg = jtraffic.TrafficConfig(
        rate_rps=2.0, horizon_s=40.0, regions=regions,
        mixes=(jtraffic.ModelMix("chat-34b", prompt_median=96.0,
                                 gen_median=32.0),))
    ex = jwl.ServeExecutor(g, J_CHAT, jtraffic.generate(cfg, seed=seed),
                           policy, n_replicas=3, fault_plan=plan,
                           resilience=resilience, seed=seed, **kw)
    return ex, ex.run()


def _both_configs(kind: str):
    """The same resilience config in each package."""
    def make(mod):
        if kind == "default":
            return mod.ResilienceConfig.default()
        return mod.ResilienceConfig(
            retry=mod.RetryPolicy(timeout_s=2.0, max_retries=3,
                                  backoff_base_s=0.2),
            hedge=mod.HedgePolicy(delay_s=1.5, max_hedges=1),
            breaker=mod.BreakerPolicy(failure_threshold=2, probation_s=30.0),
            shed=mod.ShedPolicy(deadline_s=40.0))
    from repro_torch.serve import resilience as tres
    return make(jres), make(tres)


@pytest.mark.parametrize("kind", ["default", "all_four"])
@pytest.mark.parametrize("policy", ["nearest", "least_loaded"])
def test_resilient_run_matches_reference(kind, policy):
    """A gray replica host then a crash of another, under retry + hedge +
    breaker (+ shed): records, obs counters and every field of the run equal
    the reference's."""
    hosts = _hosts(policy)
    jcfg, tcfg = _both_configs(kind)

    def plan(fm):
        return fm.FaultPlan((
            fm.GrayFailure(at=0.1, machines=hosts[:1], slowdown=30.0),
            fm.MachineCrash(at=0.5, machines=hosts[1:2], recover_after=0.2)))
    jrec, trec = jobs.Recorder(), obs_mod.Recorder()
    cold_forwards()
    _, jraw = _ref_serve(plan(jfm), resilience=jcfg, policy=policy, obs=jrec)
    cold_forwards()
    _, traw = _serve(plan(fm), resilience=tcfg, policy=policy, obs=trec)
    assert_same_serve_run(jraw, traw, f"{kind}/{policy}")
    assert check_invariants(traw, trec) == check_invariants(jraw, jrec)
    assert trec.metrics.snapshot() == jrec.metrics.snapshot()
    assert sum(r.retries + r.hedges for r in traw["records"].values()) > 0
