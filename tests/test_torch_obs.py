"""The port's flight recorder (``repro_torch.obs``) against the reference.

The modules are pure-Python copies, so a run must record the same things
in both packages: identical metric snapshots and histogram quantiles for one
metric stream, byte-identical trace JSON for one simulator run, traces that
each package's schema validator accepts from the other, equal analytics,
reports and drift alerts, and, on a fleet46 plan, the same ``plan.assign.*``
counters and the same ``plan.jit.bucket*`` counters (``.calls``,
``.compiles``, ``.cache_hits``) call for call, each package starting from an
empty per-bucket forward cache."""
import dataclasses
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from _torch_parity import cold
from repro import obs as jobs
from repro.core import assign as jassign
from repro.core import cost_model as jcm
from repro.core import graph as jgraph
from repro.core import train as jtrain
from repro.obs import analysis as janalysis
from repro.obs import report as jreport
from repro.obs import schema as jschema
from repro.sim import engine as jengine
from repro.sim import network as jnetwork
from repro_torch import obs as tobs
from repro_torch.core import assign as tassign
from repro_torch.core import cost_model as tcm
from repro_torch.core import gnn as tgnn
from repro_torch.core import graph as tgraph
from repro_torch.obs import analysis as tanalysis
from repro_torch.obs import report as treport
from repro_torch.obs import schema as tschema
from repro_torch.sim import engine as tengine
from repro_torch.sim import network as tnetwork

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PKGS = {
    "ref": SimpleNamespace(obs=jobs, analysis=janalysis, report=jreport,
                           schema=jschema, graph=jgraph, engine=jengine,
                           network=jnetwork),
    "port": SimpleNamespace(obs=tobs, analysis=tanalysis, report=treport,
                            schema=tschema, graph=tgraph, engine=tengine,
                            network=tnetwork),
}


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------
def _metric_stream(seed, n=1500):
    """(kind, name, value, buckets) drawn from the seed."""
    rng = np.random.default_rng(seed)
    names = ["net.transfers", "engine.events_dropped", "plan.x.solver.n",
             "serve.latency_s", "net.transfer_bytes", "q"]
    kinds = ["inc", "gauge", "gauge_max", "observe", "observe_bytes"]
    out = []
    for _ in range(n):
        kind = kinds[int(rng.integers(0, len(kinds)))]
        name = names[int(rng.integers(0, len(names)))]
        if kind == "inc":
            out.append(("inc", f"c.{name}", int(rng.integers(0, 5)), None))
        elif kind.startswith("gauge"):
            out.append((kind, f"g.{name}", float(rng.normal()), None))
        elif kind == "observe":
            out.append(("observe", f"h.{name}",
                        float(rng.lognormal(-2.0, 2.5)), None))
        else:
            out.append(("observe", f"b.{name}", float(rng.uniform(0, 4e12)),
                        "bytes"))
    return out


def _replay(pkg, stream):
    m = pkg.obs.Metrics()
    seen = []
    m.subscribe(lambda kind, name, v: seen.append((kind, name, v)))
    for kind, name, v, buckets in stream:
        if kind == "observe":
            m.observe(name, v, buckets=(pkg.obs.BYTES_BUCKETS if buckets
                                        else None))
        else:
            getattr(m, kind)(name, v)
    return m, seen


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metric_stream_gives_identical_snapshots(seed):
    stream = _metric_stream(seed)
    (tm, tseen), (jm, jseen) = (_replay(PKGS[k], stream)
                                for k in ("port", "ref"))
    assert tm.snapshot() == jm.snapshot()
    assert tm.flat() == jm.flat()
    assert tseen == jseen
    for name in jm._hists:
        for q in (0.0, 0.25, 0.5, 0.9, 0.95, 0.99, 0.999, 1.0):
            assert tm._hists[name].quantile(q) == jm._hists[name].quantile(q)
    other = _metric_stream(seed + 100, n=300)
    tm.merge(_replay(PKGS["port"], other)[0])
    jm.merge(_replay(PKGS["ref"], other)[0])
    assert tm.snapshot() == jm.snapshot()
    base = _replay(PKGS["ref"], stream[:700])[0].snapshot()
    assert (tobs.snapshot_diff(base, tm.snapshot())
            == jobs.snapshot_diff(base, jm.snapshot()))
    for name, *_ in stream:
        assert tobs.is_solver_specific(name) == jobs.is_solver_specific(name)
    assert (tobs.LATENCY_BUCKETS_S, tobs.BYTES_BUCKETS, tobs.SCHEMA_VERSION) \
        == (jobs.LATENCY_BUCKETS_S, jobs.BYTES_BUCKETS, jobs.SCHEMA_VERSION)


# ---------------------------------------------------------------------------
# Traces of a simulator run
# ---------------------------------------------------------------------------
def _sim_run(pkg, solver, max_events=None, seed=3, bump=True):
    """A Simulator + NetworkModel run under a Recorder: contended flows, an
    epoch bump that drops pinned events (with ``bump``), and spans, instants
    and counters recorded from callbacks."""
    rec = pkg.obs.Recorder(max_events=max_events)
    graph = pkg.graph.random_fleet(12, seed=seed)
    sim = pkg.engine.Simulator(obs=rec)
    net = pkg.network.NetworkModel(graph, "alphabeta", solver=solver, obs=rec)
    rng = np.random.default_rng(seed)
    trace = rec.trace
    done = []

    def finished(k):
        def cb():
            done.append((k, sim.now))
            trace.instant("flows", "done", args={"k": k})
            trace.counter("flows", "n_done", len(done))
            rec.metrics.observe("test.flow_s", sim.now)
        return cb

    k = 0
    while k < 30:
        i, j = (int(x) for x in rng.integers(0, graph.n, size=2))
        if i == j or not net.reachable(i, j):
            continue
        sim.schedule(float(rng.uniform(0, 4)), net.transfer, sim, i, j,
                     float(rng.uniform(1e6, 3e9)), finished(k),
                     pin_epoch=k % 3 != 0)
        k += 1
    span = trace.begin("task/T0", "setup")
    if bump:
        sim.schedule(2.5, sim.bump_epoch, pin_epoch=False)
    sim.schedule(1.0, lambda: span.end(args={"phase": 1}))
    sim.run()
    return rec, done


@pytest.mark.parametrize("max_events", [None, 101])
@pytest.mark.parametrize("solver", ["fast", "reference"])
def test_simulator_trace_is_byte_identical(solver, max_events):
    (trec, tdone), (jrec, jdone) = (_sim_run(PKGS[k], solver, max_events)
                                    for k in ("port", "ref"))
    assert tdone == jdone and tdone
    meta = {"seed": 3, "solver": solver}
    got, want = trec.trace.json_bytes(meta), jrec.trace.json_bytes(meta)
    assert got == want
    assert trec.metrics.snapshot() == jrec.metrics.snapshot()
    assert trec.trace.n_emitted == jrec.trace.n_emitted
    doc = json.loads(got)
    assert doc["metadata"]["truncated"] == (max_events is not None)
    assert treport.render(trec, "r") == jreport.render(jrec, "r")


def test_solvers_agree_outside_solver_specific_metrics():
    """As the reference's test_obs does for its data planes: the flat
    metrics agree outside the solver-specific names, which are present."""
    fast, _ = _sim_run(PKGS["port"], "fast", bump=False)
    ref, _ = _sim_run(PKGS["port"], "reference", bump=False)
    keep = lambda rec: {k: v for k, v in rec.metrics.flat().items()
                        if not tobs.is_solver_specific(k)}
    assert keep(fast) == keep(ref)
    assert any(tobs.is_solver_specific(k) for k in fast.metrics.flat())


def test_schema_validators_accept_each_others_traces():
    docs = {k: _sim_run(PKGS[k], "fast")[0].trace.json_bytes()
            for k in PKGS}
    for reader in PKGS.values():
        for data in docs.values():
            doc = reader.schema.validate_bytes(data)
            reader.schema.validate(doc)
            assert reader.schema.lanes(doc) == jschema.lanes(json.loads(data))
    # a ring that evicted the begin of a pair passes the lenient check and
    # fails the strict one in both packages, with the same message
    cut = {}
    for k, pkg in PKGS.items():
        tr = pkg.obs.Tracer(max_events=11)
        for i in range(20):
            tr.async_span("replica/0", "decode", f"s{i}", float(i), i + 0.5)
        cut[k] = tr.to_chrome()
    assert cut["port"] == cut["ref"]
    msgs = []
    for reader in PKGS.values():
        for doc in cut.values():
            reader.schema.validate(doc)
            with pytest.raises(reader.schema.TraceSchemaError) as err:
                reader.schema.validate(doc, strict=True)
            msgs.append(str(err.value))
    assert len(set(msgs)) == 1
    bad = json.loads(docs["ref"])
    bad["metadata"]["schema"] = "other/1"
    for reader in PKGS.values():
        with pytest.raises(reader.schema.TraceSchemaError, match="schema"):
            reader.schema.validate(bad)


# ---------------------------------------------------------------------------
# Analytics and reports
# ---------------------------------------------------------------------------
def _synthetic_doc(pkg, seed):
    """A trace with every lane kind the analytics read: machine flows,
    replica request lifecycles under a ``requests`` lane, training steps with
    a compute/comm split, and fault down/recover instants; every coordinate
    drawn from the seed."""
    rng = np.random.default_rng(seed + 7_000_000)
    clock = [0.0]
    tr = pkg.obs.Tracer(clock=lambda: clock[0])
    horizon = float(rng.uniform(20.0, 60.0))
    for m in range(3):
        for k in range(int(rng.integers(1, 6))):
            t0 = float(rng.uniform(0.0, horizon))
            tr.async_span(f"machine/{m}", f"xfer->{k % 3}", f"f{m}.{k}",
                          t0, t0 + float(rng.uniform(0.0, 12.0)), cat="net")
    rid = 0
    for m in range(2):
        t = float(rng.uniform(0.0, 5.0))
        for k in range(int(rng.integers(1, 5))):
            q, p, d = (float(rng.uniform(a, b))
                       for a, b in ((0.0, 3.0), (0.1, 2.0), (0.1, 6.0)))
            t_in = t - float(rng.uniform(0.0, 0.5))
            tr.async_span(f"replica/{m}", "queued", f"s{m}.{k}", t, t + q,
                          args={"rid": rid})
            tr.async_span(f"replica/{m}", "prefill", f"s{m}.{k}", t + q,
                          t + q + p)
            tr.async_span(f"replica/{m}", "decode", f"s{m}.{k}", t + q + p,
                          t + q + p + d)
            tr.async_span("requests", "request", f"r{rid}", t_in,
                          t + q + p + d + float(rng.uniform(0.0, 0.3)),
                          args={"rid": rid})
            rid += 1
            t += float(rng.uniform(0.0, 4.0))
    for t_i in range(2):
        t = float(rng.uniform(0.0, 2.0))
        for s_i in range(int(rng.integers(1, 4))):
            dur = float(rng.uniform(1.0, 8.0))
            tr.span_at(f"task/T{t_i}", f"step{s_i}", t, t + dur, cat="step",
                       args={"compute_s": float(rng.uniform(0.0, dur * 1.2)),
                             "machines": [t_i, t_i + 1]})
            t += dur + float(rng.uniform(0.0, 1.0))
    for m in range(2):
        clock[0] = float(rng.uniform(0.0, horizon))
        tr.instant("faults", "machine_down", cat="fault",
                   args={"machine": m, "machine_level": bool(m)})
        clock[0] += float(rng.uniform(0.5, 10.0))
        tr.instant("faults", "recover", cat="fault", args={"machine": m})
    return tr.to_chrome()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_analysis_and_reports_match_reference(seed):
    docs = {k: _synthetic_doc(PKGS[k], seed) for k in PKGS}
    assert json.dumps(docs["port"], sort_keys=True) \
        == json.dumps(docs["ref"], sort_keys=True)
    doc, other = docs["ref"], _synthetic_doc(PKGS["ref"], seed + 50)
    out = {}
    for name, pkg in PKGS.items():
        a = pkg.analysis
        cp = a.critical_path(doc)
        out[name] = [a.attribute(doc).to_dict(), cp.to_dict(),
                     a.latency_waterfall(doc), a.diff(doc, other),
                     pkg.report.render_trace(doc, title="t")]
    assert out["ref"][2]["n_requests"] > 0, "the waterfall saw no request"
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("mode", ["tables", "json", "diff"])
def test_report_cli_matches_reference(mode, tmp_path, capsys):
    paths = []
    for seed in (0, 1):
        p = tmp_path / f"run{seed}.trace.json"
        p.write_text(json.dumps(_synthetic_doc(PKGS["ref"], seed)))
        paths.append(str(p))
    argv = {"tables": [paths[0]], "json": [paths[0], "--json"],
            "diff": [paths[0], "--diff", paths[1]]}[mode]
    outs = []
    for pkg in PKGS.values():
        assert pkg.report.main(argv) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and outs[0]
    # the module runs as a command, importing neither jax nor torch
    proc = subprocess.run(
        [sys.executable, "-c",
         "import runpy, sys; sys.argv = ['report'] + sys.argv[1:]; "
         "runpy.run_module('repro_torch.obs.report', run_name='__main__'); ",
         *argv], env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == outs[0]


# ---------------------------------------------------------------------------
# Drift monitors
# ---------------------------------------------------------------------------
DRIFT = {
    "p95": dict(rolling_p95_threshold_s=0.8, window_s=30.0, cooldown_s=5.0),
    "slowdown": dict(slowdown_threshold=1.5, min_samples=3, cooldown_s=4.0),
    "burn": dict(slo_s=0.7, slo_budget=0.1, burn_rate_threshold=2.0,
                 window_s=20.0, cooldown_s=3.0),
}


def _drift_run(pkg, cfg):
    clock = [0.0]
    rec = pkg.obs.Recorder()
    rec.bind_clock(lambda: clock[0])
    fired = []
    mon = pkg.obs.DriftMonitor(pkg.obs.DriftConfig(**cfg),
                               on_alert=fired.append).attach(rec)
    rng = np.random.default_rng(5)
    for step in range(400):
        clock[0] = step * 0.5
        drift = 1.0 + max(0.0, step - 150) / 100.0
        rec.metrics.observe("serve.latency_s",
                            float(rng.lognormal(-1.0, 0.4)) * drift)
        m = int(rng.integers(0, 4))
        rec.metrics.observe(f"replica.slowdown.m{m}",
                            float(rng.normal(drift if m == 2 else 1.0, 0.1)))
        if step % 37 == 0:
            rec.metrics.inc("serve.dropped", 2)
        if step == 250:
            rec.metrics.inc("machine.rejoin.m2")
    return ([a.to_dict() for a in mon.alerts], [a.to_dict() for a in fired],
            mon.summary(), mon.p95_since(50.0), mon.attached)


@pytest.mark.parametrize("kind", sorted(DRIFT))
def test_drift_monitor_fires_the_same_alerts(kind):
    got = _drift_run(PKGS["port"], DRIFT[kind])
    want = _drift_run(PKGS["ref"], DRIFT[kind])
    assert want[0], f"the {kind} stream fired no alert"
    assert got == want
    null = tobs.NullRecorder()
    quiet = tobs.DriftMonitor(tobs.DriftConfig(**DRIFT[kind])).attach(null)
    assert not quiet.attached and null.calls == 0


# ---------------------------------------------------------------------------
# Ambient recorder and the planner's hooks
# ---------------------------------------------------------------------------
def test_ambient_recording_scopes():
    assert tobs.current() is tobs.NULL
    outer, inner = tobs.Recorder(), tobs.Recorder()
    with tobs.recording(outer) as got:
        assert got is outer and tobs.current() is outer
        with tobs.recording(None):
            assert tobs.current() is tobs.NULL
        with pytest.raises(KeyError):
            with tobs.recording(inner):
                assert tobs.current() is inner
                raise KeyError("restored on the way out")
        assert tobs.current() is outer
    assert tobs.current() is tobs.NULL
    tobs.install(inner)
    try:
        assert tobs.current() is inner
    finally:
        tobs.install(None)
    assert tobs.current() is tobs.NULL
    # the disabled path records nothing from a guarded run (counted as a
    # difference: the process-wide NULL also counts the unguarded
    # ``plan.sim_search.*`` increments of any earlier sim-label run)
    before = tobs.NULL.calls
    _sim_run_unrecorded()
    assert tobs.NULL.calls == before


def _sim_run_unrecorded():
    graph = tgraph.random_fleet(8, seed=1)
    sim, net = tengine.Simulator(), tnetwork.NetworkModel(graph)
    for i in range(1, graph.n):
        if net.reachable(0, i):
            sim.schedule(0.0, net.transfer, sim, 0, i, 1e8, lambda: None)
    sim.run()


@pytest.fixture(scope="module")
def small_gnn():
    """A reference GNN trained briefly on FOUR_TASKS, and its port."""
    cfg = jtrain.gnn_config_for(jcm.FOUR_TASKS)
    ds = jtrain.make_dataset(2, jcm.FOUR_TASKS, n_nodes=16, seed=3,
                             label_frac=0.8)
    params, _ = jtrain.train_gnn(cfg, ds, steps=20, lr=0.01)
    tparams = tgnn.params_from_numpy(jax.tree.map(np.asarray, params),
                                     device="cpu")
    return params, cfg, tparams, tgnn.GNNConfig(**dataclasses.asdict(cfg))


def _planner_metrics(pkg_obs, assign, graph, tasks, params, cfg):
    rec = pkg_obs.Recorder()
    stream = []
    rec.subscribe(lambda kind, name, v: stream.append((kind, name, v)))
    with pkg_obs.recording(rec):
        a = assign.task_assignments(graph, tasks, params, cfg)
        # all of the largest group but one: its task must be re-planned
        failed = max(a.groups.values(), key=len)[1:]
        assign.recover(graph, a, failed, tasks, params, cfg)
    return rec.metrics.snapshot(), stream


def test_planner_hooks_count_as_the_reference_does(small_gnn):
    params, cfg, tparams, tcfg = small_gnn
    got, tstream = cold(lambda: _planner_metrics(
        tobs, tassign, tgraph.paper_fleet46(), tcm.FOUR_TASKS, tparams, tcfg))
    want, jstream = cold(lambda: _planner_metrics(
        jobs, jassign, jgraph.paper_fleet46(), jcm.FOUR_TASKS, params, cfg))
    part = lambda snap, prefix: {sec: {k: v for k, v in d.items()
                                       if k.startswith(prefix)}
                                 for sec, d in snap.items()}
    assert part(got, "plan.assign.") == part(want, "plan.assign.")
    assert part(got, "plan.jit.") == part(want, "plan.jit.")
    assert want["counters"]["plan.assign.calls"] >= 2
    jit = lambda s: [x for x in s if x[1].startswith("plan.jit.")]
    assert jit(tstream) == jit(jstream) and jit(jstream)
    for suffix in (".calls", ".compiles"):
        assert any(x[1].endswith(suffix) for x in jit(jstream)), suffix
