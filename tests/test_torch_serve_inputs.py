"""The serving inputs the port's scenario registry is built from
(``repro_torch.serve.{traffic,costs,autoscale}`` and the four registries of
``repro_torch.sim.scenarios``) against the reference's.

All of it is numpy or plain Python, so request streams, cost cards,
autoscaling decisions and every registered scenario's fields must be equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.core import cost_model as jcm
from repro.serve import autoscale as jautoscale
from repro.serve import costs as jcosts
from repro.serve import traffic as jtraffic
from repro.sim import scenarios as jsc
from repro_torch import serve as tserve
from repro_torch.core import cost_model as tcm
from repro_torch.serve import autoscale as tautoscale
from repro_torch.serve import costs as tcosts
from repro_torch.serve import traffic as ttraffic
from repro_torch.sim import scenarios as tsc

REGISTRIES = ("SCENARIOS", "SERVE_SCENARIOS", "DRIFT_SCENARIOS",
              "COLOCATED_SCENARIOS")
_TRAFFIC = [("SERVE_SCENARIOS", n) for n in sorted(jsc.SERVE_SCENARIOS)] + \
           [("COLOCATED_SCENARIOS", n) for n in sorted(jsc.COLOCATED_SCENARIOS)]


def _plain(x):
    """A package-free projection: dataclasses by class name and fields,
    callables by qualified name, numpy arrays as lists."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {"__class__": type(x).__name__,
                **{f.name: _plain(getattr(x, f.name))
                   for f in dataclasses.fields(x)}}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, np.ndarray):
        return x.tolist()
    if callable(x):
        return getattr(x, "__qualname__", repr(x))
    return x


def _graph(g) -> dict:
    return {"machines": _plain(g.machines), "latency": g.latency.tolist()}


@pytest.mark.parametrize("registry", REGISTRIES)
def test_registries_hold_the_same_scenarios(registry):
    ref, port = getattr(jsc, registry), getattr(tsc, registry)
    assert list(port) == list(ref)
    for name in ref:
        assert _plain(port[name]) == _plain(ref[name]), name
        assert _graph(port[name].fleet(0)) == _graph(ref[name].fleet(0)), name


@pytest.mark.parametrize("registry,name", _TRAFFIC)
def test_registered_traffic_draws_identical_request_streams(registry, name):
    streams = []
    for sc, traffic in ((jsc, jtraffic), (tsc, ttraffic)):
        scn = getattr(sc, registry)[name]
        cfg = scn.traffic(scn.fleet(0))
        reqs = traffic.generate(cfg, seed=3)
        streams.append((_plain(cfg), [dataclasses.astuple(r) for r in reqs],
                        traffic.trace_stats(reqs),
                        [traffic.region_rate(cfg, i, t)
                         for i in range(len(cfg.regions))
                         for t in np.linspace(0.0, cfg.horizon_s, 7)]))
    assert streams[1] == streams[0]
    assert len(streams[1][1]) > 0


def test_bursty_multi_model_traffic_matches_reference():
    def cfg(traffic):
        return traffic.TrafficConfig(
            rate_rps=4.0, horizon_s=200.0,
            regions=("California", "Beijing", "London"),
            region_weights=(0.5, 0.3, 0.2),
            mixes=(traffic.ModelMix("a", weight=2.0),
                   traffic.ModelMix("b", prompt_median=512.0, gen_sigma=1.0,
                                    max_gen=256)),
            diurnal_depth=0.5, period_s=100.0, burst_factor=4.0,
            burst_window=(50.0, 90.0), burst_region="Beijing")
    ref = jtraffic.generate(cfg(jtraffic), seed=11)
    port = ttraffic.generate(cfg(ttraffic), seed=11)
    assert [dataclasses.astuple(r) for r in port] \
        == [dataclasses.astuple(r) for r in ref]
    assert {r.model for r in port} == {"a", "b"}


@pytest.mark.parametrize("tasks", ["FOUR_TASKS", "SIX_TASKS"])
def test_serve_model_from_task_gives_equal_cards(tasks):
    for jtask, ttask in zip(getattr(jcm, tasks), getattr(tcm, tasks)):
        jcard = jcosts.serve_model_from_task(jtask, decode_efficiency=0.02)
        tcard = tcosts.serve_model_from_task(ttask, decode_efficiency=0.02)
        assert dataclasses.asdict(tcard) == dataclasses.asdict(jcard)
        for card, cost in ((jcard, jcosts), (tcard, tcosts)):
            assert cost.serve_task_for(card, 3).min_memory_gb > 0
        assert dataclasses.asdict(tcosts.serve_task_for(tcard, 3)) \
            == dataclasses.asdict(jcosts.serve_task_for(jcard, 3))
        assert tcard.service_s(300, 40, 312.0) == jcard.service_s(300, 40, 312.0)
        assert tcard.kv_capacity_tokens(80.0) == jcard.kv_capacity_tokens(80.0)


def test_serve_model_from_hlo_matches_reference():
    kw = dict(prefill_tokens=64, decode_batch=4, kv_bytes_per_token=1e5,
              weight_bytes=2e9)
    pre, dec = {"flops": 3.2e12}, {"flops": 1.6e10}
    assert dataclasses.asdict(tcosts.serve_model_from_hlo("m", pre, dec, **kw)) \
        == dataclasses.asdict(jcosts.serve_model_from_hlo("m", pre, dec, **kw))


def _smoke(configs, arch):
    return dataclasses.replace(configs.reduce_for_smoke(configs.get_config(arch)),
                               remat=False)


@pytest.mark.parametrize("arch", ["gemma3-1b", "olmoe-1b-7b", "whisper-small",
                                  "internvl2-1b"])
def test_serve_model_from_config_matches_reference(arch):
    """The reference lowers its prefill and decode step and prices the HLO;
    the port runs its own on the meta device through
    ``analysis.program_cost``. Weight and KV bytes come from the same trees
    and are equal. Decode flops per token are equal. Prefill flops differ by
    exactly the head on every position but the last: the reference's
    prefill computes (B, T, V) logits and keeps the last row, the port's
    runs the head on the last position only (``decoder_lm.prefill``), where
    T is the prompt plus a VLM's patches. Those 2 x B x (T - 1) x d x V
    flops are the stated tolerance, and nothing else differs."""
    kw = dict(batch=2, prompt_len=16, gen_tokens=8)
    jcard = jcosts.serve_model_from_config(_smoke(jconfigs, arch), **kw)
    cfg = _smoke(tconfigs, arch)
    tcard = tcosts.serve_model_from_config(cfg, **kw)
    assert tcard.weight_bytes == jcard.weight_bytes
    assert tcard.kv_bytes_per_token == jcard.kv_bytes_per_token
    assert tcard.decode_flops_per_token == jcard.decode_flops_per_token
    t = kw["prompt_len"] + (cfg.n_patches if cfg.family == "vlm" else 0)
    head = 2 * kw["batch"] * (t - 1) * cfg.d_model * cfg.vocab_size
    assert tcard.prefill_flops_per_token \
        + head / (kw["batch"] * kw["prompt_len"]) \
        == jcard.prefill_flops_per_token
    if arch == "gemma3-1b":   # the reference's figures at this call
        assert (jcard.prefill_flops_per_token, jcard.decode_flops_per_token,
                jcard.kv_bytes_per_token, jcard.weight_bytes) \
            == (303104.0, 292864.0, 776.0, 554368.0)


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_serve_model_from_config_prices_every_family(arch):
    """Every config of ``configs.ARCHS``, reduced, prices on the meta
    device: positive flops, the param tree's bytes, KV bytes per token of
    the prefill's caches."""
    from repro_torch._tree import leaves
    from repro_torch.launch.specs import param_struct
    cfg = _smoke(tconfigs, arch)
    card = tcosts.serve_model_from_config(cfg, batch=2, prompt_len=8,
                                          gen_tokens=4)
    assert card.prefill_flops_per_token > 0 and card.decode_flops_per_token > 0
    assert card.kv_bytes_per_token > 0
    assert card.weight_bytes == sum(t.numel() * t.element_size()
                                    for t in leaves(param_struct(cfg)))


def test_serve_package_exports_only_the_ported_modules():
    """Every module of the reference's ``serve`` is ported now: the package
    exports the reference's names, each from the submodule of the same
    name, and nothing else."""
    import importlib

    import repro.serve as jserve
    assert tserve.ServeModel is tcosts.ServeModel
    assert tserve.Autoscaler is tautoscale.Autoscaler
    assert tserve.generate is ttraffic.generate
    assert tserve._EXPORTS == jserve._EXPORTS
    for name, submodule in tserve._EXPORTS.items():
        home = importlib.import_module(f"repro_torch.serve.{submodule}")
        assert getattr(tserve, name) is getattr(home, name), name
    with pytest.raises(AttributeError):
        getattr(tserve, "NotAServeName")


class _Clock:
    def __init__(self):
        self.now = 0.0
        self.scheduled = []

    def schedule(self, delay, fn, *args, pin_epoch=True):
        self.scheduled.append((self.now + delay, fn.__name__, pin_epoch))


def _scripted(autoscale, cfg_kw):
    """An autoscaler on a hand-cranked clock fed a fixed queue and latency
    script; the cluster grows and shrinks when asked (up to a capacity)."""
    clock = _Clock()
    state = {"n": 2, "k": 0}
    pending = [0.1, 5.0, 5.0, 4.0, 0.1, 0.1, 0.0, 6.0, 0.2, 0.1, 3.5, 0.0,
               0.1, 0.1, 9.0, 9.0]

    def up():
        if state["n"] >= 4:
            return False
        state["n"] += 1
        return True

    def down():
        state["n"] -= 1
        return True

    scaler = autoscale.Autoscaler(
        clock, autoscale.AutoscaleConfig(**cfg_kw),
        n_replicas=lambda: state["n"],
        pending_per_replica=lambda: pending[state["k"]],
        scale_up=up, scale_down=down)
    scaler.start()
    rng = np.random.default_rng(5)
    for k in range(len(pending)):
        state["k"] = k
        clock.now = (k + 1) * scaler.cfg.check_period_s
        for lat in rng.lognormal(2.0, 0.8, size=4):
            scaler.observe_completion(float(lat))
        scaler._tick()
    scaler.stop()
    scaler._tick()          # stopped: no decision, no reschedule
    return scaler.log, clock.scheduled, scaler.p95()


@pytest.mark.parametrize("cfg_kw", [
    dict(check_period_s=10.0, cooldown_s=25.0),
    dict(check_period_s=15.0, queue_high=3.0, queue_low=0.2, slo_s=12.0,
         min_replicas=2, max_replicas=5, cooldown_s=45.0, window=8),
])
def test_autoscaler_decisions_match_reference(cfg_kw):
    ref = _scripted(jautoscale, cfg_kw)
    port = _scripted(tautoscale, cfg_kw)
    assert port == ref
    assert {e["action"] for e in port[0]} == {"up", "down"}
