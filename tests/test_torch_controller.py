"""The port's online re-planning controller (``repro_torch.runtime.controller``)
against the reference's.

* The envelope tests of ``tests/test_controller.py`` (a stub host on a
  hand-cranked clock: hysteresis, window expiry, cooldown, probation and
  in-flight-migration suppression, fail-open) run against the port.
* Its closed-loop tests run the port's ``DRIFT_SCENARIOS`` end to end.
* Every drift scenario under every mode gives the reference's run: the
  ``repro.sim.chaos.canonical_fleet`` projection (controller decision log
  included) is equal, and so are the recorded metrics, the per-bucket
  forward's ``plan.jit.bucket{b}.compiles`` / ``.cache_hits`` among them
  (each package's run starts from an empty forward cache).

The port's GNN cache holds the reference's trained params (analytic v1 and,
for ``drift_gray_creep``, the sim-labeled v2 GNN).
"""
import dataclasses
import functools
import json
import math

import pytest
import torch

torch.set_num_threads(1)

from _torch_parity import cold, seed_scenario_gnn
from repro import obs as jobs
from repro.sim import evaluate as jev
from repro.sim import scenarios as jsc
from repro.sim.chaos import canonical_fleet
from repro_torch import obs as tobs
from repro_torch.obs import NULL
from repro_torch.obs.monitors import Alert, DriftConfig
from repro_torch.runtime.controller import ControllerConfig, ReplanController
from repro_torch.sim import evaluate as tev
from repro_torch.sim import scenarios as tsc

DRIFT = DriftConfig(min_samples=2, cooldown_s=0.0, slowdown_threshold=2.0,
                    latency_metric="sim.step_s")
MODES = ("static", "guarded", "unguarded")
@pytest.fixture(scope="module", autouse=True)
def seeded():
    for name in sorted(jsc.DRIFT_SCENARIOS):
        ref = jsc.get_drift_scenario(name)
        seed_scenario_gnn(ref, tsc.get_drift_scenario(name), ref.label_mode)


def _alert(t: float = 0.0) -> Alert:
    return Alert(t=t, kind="slowdown", key="1", value=3.0, threshold=2.0)


class _StubSim:
    def __init__(self):
        self.now = 0.0
        self.scheduled = []

    def schedule(self, delay, fn, *args, pin_epoch=True):
        self.scheduled.append((self.now + delay, fn, args, pin_epoch))


class _StubHost:
    """Just enough host for the decision path up to (but not into)
    ``_replan``: a clock, a scheduler, and the in-flight-migration gauge."""

    def __init__(self):
        self.sim = _StubSim()
        self.obs = NULL
        self.migrations_in_flight = 0

    def unfinished(self):
        return ["gpt"]


def _bound(cfg: ControllerConfig):
    ctl = ReplanController(cfg)
    host = _StubHost()
    ctl.bind(host)          # NULL recorder: monitor attach is a no-op
    return ctl, host


# -- envelope unit tests ------------------------------------------------------

def test_hysteresis_accumulates_before_scheduling():
    ctl, host = _bound(ControllerConfig(drift=DRIFT, hysteresis=3,
                                        hysteresis_window_s=100.0))
    ctl._on_alert(_alert())
    ctl._on_alert(_alert())
    assert host.sim.scheduled == []
    ctl._on_alert(_alert())
    assert len(host.sim.scheduled) == 1
    _, fn, _, pin_epoch = host.sim.scheduled[0]
    assert fn == ctl._consider and pin_epoch is False
    ctl._on_alert(_alert())
    assert len(host.sim.scheduled) == 1


def test_hysteresis_window_expires_old_alerts():
    ctl, host = _bound(ControllerConfig(drift=DRIFT, hysteresis=2,
                                        hysteresis_window_s=10.0))
    ctl._on_alert(_alert())
    host.sim.now = 50.0
    ctl._on_alert(_alert(50.0))
    assert host.sim.scheduled == []
    ctl._on_alert(_alert(50.0))
    assert len(host.sim.scheduled) == 1


def test_cooldown_suppresses_then_releases():
    ctl, host = _bound(ControllerConfig(drift=DRIFT, hysteresis=1,
                                        cooldown_s=100.0))
    calls = []
    ctl._replan = lambda now: calls.append(now)
    ctl._last_action_t = 0.0
    host.sim.now = 10.0
    ctl._on_alert(_alert(10.0))
    ctl._consider()
    assert calls == []
    assert ctl.log[-1] == {"t": 10.0, "action": "suppressed",
                           "why": "cooldown"}
    host.sim.now = 200.0
    ctl._on_alert(_alert(200.0))
    ctl._consider()
    assert calls == [200.0]


def test_inflight_migration_suppresses():
    ctl, host = _bound(ControllerConfig(drift=DRIFT, hysteresis=1,
                                        cooldown_s=0.0))
    ctl._replan = lambda now: pytest.fail("must not replan while migrating")
    host.migrations_in_flight = 2
    ctl._on_alert(_alert())
    ctl._consider()
    assert ctl.log[-1]["why"] == "migrating"


def test_probation_window_suppresses():
    ctl, host = _bound(ControllerConfig(drift=DRIFT, hysteresis=1,
                                        cooldown_s=0.0))
    ctl._replan = lambda now: pytest.fail("must not replan on probation")
    ctl._probation = {"until": math.inf, "t_commit": 0.0, "pre_p95": 1.0,
                      "graph": None, "assignment": None, "seq": 1}
    ctl._on_alert(_alert())
    ctl._consider()
    assert ctl.log[-1]["why"] == "probation"


def test_fail_open_marks_dead_and_ignores_later_alerts():
    ctl, host = _bound(ControllerConfig(drift=DRIFT, hysteresis=1,
                                        cooldown_s=0.0, fail_open=True))

    def boom(now):
        raise RuntimeError("synthetic controller bug")

    ctl._replan = boom
    ctl._on_alert(_alert())
    ctl._consider()
    assert ctl.dead
    assert ctl.summary()["errors"] == 1
    assert "synthetic controller bug" in ctl.log[-1]["error"]
    n = len(host.sim.scheduled)
    ctl._on_alert(_alert())
    assert len(host.sim.scheduled) == n


def test_fail_open_false_propagates():
    ctl, host = _bound(ControllerConfig(drift=DRIFT, hysteresis=1,
                                        cooldown_s=0.0, fail_open=False))

    def boom(now):
        raise RuntimeError("boom")

    ctl._replan = boom
    ctl._on_alert(_alert())
    with pytest.raises(RuntimeError, match="boom"):
        ctl._consider()


def test_external_replan_resets_probation_and_cooldown():
    ctl, host = _bound(ControllerConfig(drift=DRIFT, hysteresis=1,
                                        cooldown_s=50.0))
    ctl._probation = {"until": math.inf, "seq": 1, "t_commit": 0.0,
                      "pre_p95": 1.0, "graph": None, "assignment": None}
    host.sim.now = 30.0
    ctl.on_external_replan()
    assert ctl._probation is None
    assert ctl._last_action_t == 30.0


def test_unguarded_config_disables_every_guard():
    cfg = ControllerConfig.unguarded(DRIFT)
    assert cfg.hysteresis == 1 and cfg.cooldown_s == 0.0
    assert cfg.margin is None and cfg.probation_s is None
    assert cfg.polish == "none" and cfg.drift is DRIFT


# -- closed-loop tests over the port's drift registry ------------------------

@functools.lru_cache(maxsize=None)
def _run(name: str, mode: str):
    return tev.run_drift_scenario(tsc.get_drift_scenario(name), mode=mode,
                                  seed=0)


def _drill(sc, ev, name, **controller):
    """A guarded run of ``name`` with its controller config overridden."""
    scn = sc.get_drift_scenario(name)
    cfg = dataclasses.replace(scn.controller, **controller)
    return ev.run_drift_scenario(dataclasses.replace(scn, controller=cfg),
                                 mode="guarded", seed=0)


def test_gate_rejects_net_negative_replan():
    res, ctl = _drill(tsc, tev, "drift_link_rot", margin=10.0)
    s = ctl.summary()
    assert s["gate_rejects"] >= 1 and s["replans"] == 0, s
    for e in ctl.log:
        if e["action"] == "gate_reject":
            assert not e["gain_s"] > e["floor_s"]
    res_off, _ = _run("drift_link_rot", "static")
    assert canonical_fleet(res) == canonical_fleet(res_off)
    jres, jctl = _drill(jsc, jev, "drift_link_rot", margin=10.0)
    assert canonical_fleet(res, ctl) == canonical_fleet(jres, jctl)


def test_canary_probation_triggers_exact_rollback():
    drill = dict(probation_s=20.0, probation_regress=-0.95)
    res, ctl = _drill(tsc, tev, "drift_gray_creep", **drill)
    s = ctl.summary()
    assert s["errors"] == 0 and s["rollbacks"] >= 1, s
    for e in ctl.log:
        if e["action"] == "rollback":
            assert e["restored"] == e["last_good"]
    assert any(r["reason"] == "controller_rollback" for r in res.replans)
    jres, jctl = _drill(jsc, jev, "drift_gray_creep", **drill)
    assert canonical_fleet(res, ctl) == canonical_fleet(jres, jctl)


def test_injected_exception_degrades_to_static(monkeypatch):
    def boom(self, now):
        raise RuntimeError("injected")

    monkeypatch.setattr(ReplanController, "_replan", boom)
    res, ctl = tev.run_drift_scenario(tsc.get_drift_scenario("drift_gray_creep"),
                                      mode="guarded", seed=0)
    assert ctl.dead and ctl.summary()["errors"] == 1
    res_off, _ = _run("drift_gray_creep", "static")
    assert res.makespan == res_off.makespan
    assert all(not d["failed"] for d in res.per_task.values())


def test_controller_none_is_deterministic_and_commit_free():
    res, ctl = _run("drift_gray_creep", "static")
    assert ctl is None and res.replans == []
    res2, _ = tev.run_drift_scenario(tsc.get_drift_scenario("drift_gray_creep"),
                                     mode="static", seed=0)
    assert canonical_fleet(res) == canonical_fleet(res2)


def test_guarded_replay_is_byte_identical():
    res, ctl = _run("drift_gray_creep", "guarded")
    res2, ctl2 = tev.run_drift_scenario(
        tsc.get_drift_scenario("drift_gray_creep"), mode="guarded", seed=0)
    assert canonical_fleet(res, ctl) == canonical_fleet(res2, ctl2)


def test_guarded_beats_static_under_gray_creep():
    res_g, ctl = _run("drift_gray_creep", "guarded")
    res_s, _ = _run("drift_gray_creep", "static")
    assert ctl.summary()["replans"] >= 1
    assert res_g.makespan < res_s.makespan
    assert all(not d["failed"] for d in res_g.per_task.values())


def test_run_drift_scenario_rejects_unknown_mode():
    with pytest.raises(ValueError, match="mode"):
        tev.run_drift_scenario(tsc.get_drift_scenario("drift_gray_creep"),
                               mode="yolo", seed=0)


# -- every drift scenario x mode against the reference -------------------------

def _recorded(obs, sc, ev, name, mode):
    rec = obs.Recorder()
    with obs.recording(rec):
        res, ctl = ev.run_drift_scenario(sc.get_drift_scenario(name),
                                         mode=mode, seed=0, obs=rec)
    return res, ctl


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(jsc.DRIFT_SCENARIOS))
def test_drift_run_matches_reference(name, mode):
    jres, jctl = cold(lambda: _recorded(jobs, jsc, jev, name, mode))
    tres, tctl = cold(lambda: _recorded(tobs, tsc, tev, name, mode))
    assert canonical_fleet(tres, tctl) == canonical_fleet(jres, jctl)
    assert (tctl is None) == (jctl is None)
    if tctl is not None:
        assert tctl.summary() == jctl.summary()
    assert json.dumps(tres.metrics, sort_keys=True) \
        == json.dumps(jres.metrics, sort_keys=True)
    assert tres.n_events == jres.n_events
    assert tres.bytes_moved == jres.bytes_moved


def test_reference_run_rejects_unknown_mode_as_the_port_does():
    for sc, ev in ((jsc, jev), (tsc, tev)):
        with pytest.raises(ValueError, match="static/guarded/unguarded"):
            ev.run_drift_scenario(sc.get_drift_scenario("drift_link_rot"),
                                  mode="adaptive", seed=0)


# -- registry -----------------------------------------------------------------

def test_drift_registry_contents():
    assert set(tsc.DRIFT_SCENARIOS) == set(jsc.DRIFT_SCENARIOS)
    for name in tsc.DRIFT_SCENARIOS:
        scn = tsc.get_drift_scenario(name)
        assert scn.name == name
        assert isinstance(scn.controller, ControllerConfig)
        assert scn.controller.drift.latency_metric == "sim.step_s"
        assert dataclasses.asdict(scn.controller) == dataclasses.asdict(
            jsc.get_drift_scenario(name).controller)


def test_drift_registry_errors_and_temporary_registration():
    with pytest.raises(KeyError, match="unknown drift scenario"):
        tsc.get_drift_scenario("nope")
    base = tsc.get_drift_scenario("drift_gray_creep")
    clone = dataclasses.replace(base, name="drift_tmp_test")
    with tsc.temporary_registration(clone):
        assert tsc.get_drift_scenario("drift_tmp_test") is clone
        with pytest.raises(ValueError, match="already"):
            tsc.register_drift(clone)
    assert "drift_tmp_test" not in tsc.DRIFT_SCENARIOS
