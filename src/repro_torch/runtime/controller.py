"""Online re-planning under drift: the guarded monitor→plan loop.

``ReplanController`` closes the loop the ROADMAP calls the
"production-in-the-loop" gap: PR 8's ``obs.monitors.DriftMonitor`` *detects*
gray-failure ramps, link rot and diurnal shifts mid-run, but nothing acted on
an alert — a plan that was optimal at t=0 quietly rotted for the rest of the
run. The controller subscribes to the monitor's alert stream during a
``sim.evaluate.FleetSimulation`` run, pulls live telemetry
(``observed_telemetry_live``), re-scores candidate placements with the Hulk
GNN (plus an optional polish), and commits mid-run through the existing
epoch-guarded ``ElasticRuntime.commit_assignment`` path.

A live replanner that thrashes is worse than a static plan, so every action
passes a safety envelope:

* **Hysteresis** — a single alert never replans; ``hysteresis`` alerts must
  land inside ``hysteresis_window_s`` first (alert storms are integrated,
  not amplified).
* **Cooldown** — at most one committed action per ``cooldown_s`` of sim
  time, on top of the monitor's own per-signal alert cooldown.
* **Migration-priced improvement gate** — the plan delta's migration traffic
  (``core.assign.migration_moves``: every machine joining a group pulls the
  task's parameters from a retained member) is priced through the
  simulator's own ``NetworkModel`` (``estimate_transfer_s``, which sees the
  live fault overlays); the controller commits only when the predicted
  remaining-time gain exceeds the migration cost by ``margin`` of the
  current predicted remaining time. ``margin=None`` disables the gate — the
  benchmark's "replan on every alert, no guardrails" arm.
* **Canary probation + rollback** — each commit snapshots the last-good
  assignment and opens a ``probation_s`` window; if the measured post-commit
  p95 step time regresses more than ``probation_regress`` over the
  pre-commit p95, the controller rolls the exact last-good assignment back
  through the same commit path.
* **Fail-open degradation** — any exception inside the controller marks it
  dead and the run continues on the current plan (``fail_open=True``); the
  controller can make a run slower, never break it. ``controller=None`` at
  the host stays bit-identical to the historical path — the same discipline
  ``sim.resilience.ResilienceConfig`` established.

Determinism: the controller is driven purely by the sim-time metric stream
(no wall clock, no RNG); decisions are scheduled as ordinary simulator
events (``pin_epoch=False`` control-plane events, like fault injection), so
same-seed runs produce byte-identical traces and decision logs
(``sim.chaos.fuzz_controller`` enforces this).

Host protocol (implemented by ``FleetSimulation``): ``sim``, ``obs``,
``graph``, ``net``, ``compute``, ``placements``, ``runs``, ``steps``,
``tasks``, ``comm_model``, ``placer`` (needs the ``HulkPlacer`` online mode:
``propose``/``refine``/``commit``), ``migrations_in_flight``,
``unfinished()`` and ``commit_plan(assignment, graph, reason=...)``.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Optional

import numpy as np

from repro_torch.core import assign as assign_mod
from repro_torch.core import cost_model as cm
from repro_torch.core.graph import ClusterGraph
from repro_torch.obs.monitors import Alert, DriftConfig, DriftMonitor


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """Safety-envelope knobs; see the module docstring for what each guard
    does. ``drift`` configures the embedded ``DriftMonitor`` (training runs
    want ``latency_metric="sim.step_s"`` — the per-step observations the
    fleet simulation emits)."""
    drift: DriftConfig
    hysteresis: int = 2
    hysteresis_window_s: float = 120.0
    cooldown_s: float = 180.0
    # improvement gate: commit iff gain > migration + margin * remaining;
    # None disables the gate entirely (the no-guardrail arm)
    margin: Optional[float] = 0.05
    # canary: None disables probation/rollback
    probation_s: Optional[float] = 120.0
    probation_regress: float = 0.10
    polish: str = "greedy"            # "none" | "greedy" | "sim"
    polish_iters: int = 12
    fail_open: bool = True

    @staticmethod
    def unguarded(drift: DriftConfig) -> "ControllerConfig":
        """Every guardrail off: replan and commit on every single alert —
        the thrash-prone baseline the guarded controller must beat."""
        return ControllerConfig(drift=drift, hysteresis=1,
                                hysteresis_window_s=math.inf, cooldown_s=0.0,
                                margin=None, probation_s=None, polish="none")


class ReplanController:
    """One controller per run; create, pass as ``controller=`` to the host,
    read ``summary()`` / ``log`` afterwards."""

    def __init__(self, config: ControllerConfig):
        self.config = config
        self.monitor = DriftMonitor(config.drift, on_alert=self._on_alert)
        self.host = None
        self.dead = False
        self.log: list[dict] = []
        self._alert_times: collections.deque = collections.deque()
        self._pending = False
        self._last_action_t = -math.inf
        # {"until", "pre_p95", "t_commit", "graph", "assignment"} while a
        # commit is on probation; None otherwise
        self._probation: Optional[dict] = None
        self._commit_seq = 0

    # -- wiring --------------------------------------------------------------
    def bind(self, host) -> "ReplanController":
        """Attach to a host (called by the host at run start). The host
        guarantees an enabled recorder — the monitor reads its metric
        stream."""
        self.host = host
        self.monitor.attach(host.obs)
        return self

    def on_external_replan(self) -> None:
        """The host re-planned underneath us (crash / rejoin): machine ids
        compacted or grew, so the probation snapshot is stale — drop it, and
        restart the cooldown clock so the controller doesn't pile a replan
        on top of disaster recovery."""
        self._probation = None
        self._alert_times.clear()
        if self.host is not None:
            self._last_action_t = self.host.sim.now

    # -- alert intake --------------------------------------------------------
    def _on_alert(self, alert: Alert) -> None:
        if self.dead or self.host is None:
            return
        host = self.host
        now = host.sim.now
        self._alert_times.append(now)
        horizon = now - self.config.hysteresis_window_s
        while self._alert_times and self._alert_times[0] < horizon:
            self._alert_times.popleft()
        if host.obs.enabled:
            host.obs.metrics.inc("controller.alerts")
        if len(self._alert_times) < max(1, self.config.hysteresis):
            return
        if self._pending:
            return
        # never act inside the metric callback (it fires mid-event, inside a
        # step-completion or transfer callback): schedule a control-plane
        # event, re-validate everything when it fires
        self._pending = True
        host.sim.schedule(0.0, self._consider, pin_epoch=False)

    # -- the guarded decision ------------------------------------------------
    def _consider(self) -> None:
        self._pending = False
        if self.dead or self.host is None:
            return
        host = self.host
        if not host.unfinished():
            return
        now = host.sim.now
        try:
            if self._probation is not None and now < self._probation["until"]:
                return self._suppress(now, "probation")
            if host.migrations_in_flight > 0:
                # the previous commit's plan delta is still propagating —
                # committing on top would re-plan from half-migrated state
                return self._suppress(now, "migrating")
            if now - self._last_action_t < self.config.cooldown_s:
                return self._suppress(now, "cooldown")
            self._alert_times.clear()
            self._replan(now)
        except Exception as e:
            if not self.config.fail_open:
                raise
            # graceful degradation: the run continues on its current plan
            self.dead = True
            self.log.append({"t": now, "action": "error", "error": repr(e)})
            if host.obs.enabled:
                host.obs.metrics.inc("controller.errors")
                host.obs.trace.instant("controller", "controller_error",
                                       cat="controller",
                                       args={"error": repr(e)[:200]})

    def _suppress(self, now: float, why: str) -> None:
        self._alert_times.clear()
        self.log.append({"t": now, "action": "suppressed", "why": why})
        if self.host.obs.enabled:
            self.host.obs.metrics.inc("controller.suppressed")
            self.host.obs.metrics.inc(f"controller.suppressed.{why}")
            self.host.obs.trace.instant("controller", f"suppressed:{why}",
                                        cat="controller")

    def _replan(self, now: float) -> None:
        from repro_torch.sim.evaluate import observed_telemetry_live

        host = self.host
        tel = observed_telemetry_live(host.net, host.compute)
        graph = host.graph.with_telemetry(tel)          # what gets committed
        # scoring/proposals see the *effective* topology: the network's live
        # latency mask folds in link-fault overlays, so link rot is visible
        # to the GNN features and the analytic scorer, while the committed
        # graph keeps the clean base latency (overlays are the NetworkModel's
        # job — baking them into the graph would double-apply them)
        eff = ClusterGraph(graph.machines, host.net.effective_latency(), tel)
        slow = np.maximum(np.asarray(tel.slowdown, np.float64), 1.0)
        eff_comm = cm.make_comm(eff, host.comm_model)

        cur_rem = self._remaining(eff, eff_comm, host.placements, slow)
        candidates = self._candidates(eff, eff_comm, slow)
        scored = []
        for cand in candidates:
            pls = host.placer._placements(graph, cand)
            scored.append((self._remaining(eff, eff_comm, pls, slow), cand,
                           pls))
        if not scored:
            self.log.append({"t": now, "action": "no_candidate"})
            return
        best_rem, best, best_pls = min(scored, key=lambda s: s[0])

        live = set(host.unfinished())
        cur_groups = {n: sorted(pl.ids) for n, pl in host.placements.items()
                      if n in live}
        moves = assign_mod.migration_moves(
            cur_groups, {n: v for n, v in best.groups.items() if n in live},
            host.tasks,
            strategies={n: pl.strategy for n, pl in best_pls.items()})
        migration_s = 0.0
        for _, srcs, dst, nb in moves:
            migration_s = max(migration_s, float(min(
                host.net.estimate_transfer_s(s, dst, nb) for s in srcs)))
        gain = cur_rem - best_rem if math.isfinite(cur_rem) \
            else (math.inf if math.isfinite(best_rem) else 0.0)

        if self.config.margin is not None:
            floor = migration_s + self.config.margin * (
                cur_rem if math.isfinite(cur_rem) else 0.0)
            if not gain > floor:
                self.log.append({"t": now, "action": "gate_reject",
                                 "gain_s": gain, "migration_s": migration_s,
                                 "floor_s": floor})
                if host.obs.enabled:
                    host.obs.metrics.inc("controller.gate_rejects")
                    host.obs.trace.instant(
                        "controller", "gate_reject", cat="controller",
                        args={"gain_s": gain, "migration_s": migration_s})
                return
        self._commit(now, best, graph, gain, migration_s, moves)

    def _commit(self, now: float, assignment, graph, gain: float,
                migration_s: float, moves: list) -> None:
        host = self.host
        # last-good snapshot for rollback, taken before the commit mutates
        # the runtime (groups are copied — the runtime hands out live lists)
        last_good = dataclasses.replace(
            host.placer.rt.assignment,
            groups={n: list(v) for n, v in
                    host.placer.rt.assignment.groups.items()})
        last_good_graph = host.placer.rt.graph
        pre_p95 = self.monitor.rolling_p95_s()
        migrating_before = host.migrations_in_flight

        info = host.commit_plan(assignment, graph, reason="controller_replan")
        self._last_action_t = now
        self._commit_seq += 1
        self.log.append({
            "t": now, "action": "commit", "gain_s": gain,
            "migration_s": migration_s, "moves": len(moves),
            "migrating_at_commit": migrating_before,
            "groups": {n: list(v) for n, v in assignment.groups.items()}})
        if host.obs.enabled:
            host.obs.metrics.inc("controller.replans")
            host.obs.trace.instant(
                "controller", "replan_commit", cat="controller",
                args={"gain_s": gain, "migration_s": migration_s,
                      "moves": len(moves),
                      "bytes": float(info.get("bytes", 0.0))})
        if self.config.probation_s is not None:
            self._probation = {
                "until": now + self.config.probation_s, "t_commit": now,
                "pre_p95": pre_p95, "graph": last_good_graph,
                "assignment": last_good, "seq": self._commit_seq}
            host.sim.schedule(self.config.probation_s, self._check_probation,
                              self._commit_seq, pin_epoch=False)

    # -- canary / rollback ---------------------------------------------------
    def _check_probation(self, seq: int) -> None:
        if self.dead or self.host is None:
            return
        prob = self._probation
        if prob is None or prob["seq"] != seq:
            return          # invalidated (external replan / newer commit)
        self._probation = None
        host = self.host
        if not host.unfinished():
            return
        now = host.sim.now
        try:
            post_p95, n = self.monitor.p95_since(prob["t_commit"])
            regressed = (n > 0 and prob["pre_p95"] > 0.0
                         and post_p95 > prob["pre_p95"]
                         * (1.0 + self.config.probation_regress))
            if not regressed:
                self.log.append({"t": now, "action": "probation_pass",
                                 "pre_p95": prob["pre_p95"],
                                 "post_p95": post_p95})
                if host.obs.enabled:
                    host.obs.trace.instant("controller", "probation_pass",
                                           cat="controller")
                return
            host.commit_plan(prob["assignment"], prob["graph"],
                             reason="controller_rollback")
            self._last_action_t = now
            restored = {n_: sorted(v) for n_, v in
                        host.placer.rt.assignment.groups.items()}
            self.log.append({
                "t": now, "action": "rollback",
                "pre_p95": prob["pre_p95"], "post_p95": post_p95,
                "last_good": {n_: sorted(v) for n_, v in
                              prob["assignment"].groups.items()},
                "restored": restored})
            if host.obs.enabled:
                host.obs.metrics.inc("controller.rollbacks")
                host.obs.trace.instant(
                    "controller", "rollback", cat="controller",
                    args={"pre_p95": prob["pre_p95"], "post_p95": post_p95})
        except Exception as e:
            if not self.config.fail_open:
                raise
            self.dead = True
            self.log.append({"t": now, "action": "error", "error": repr(e)})
            if host.obs.enabled:
                host.obs.metrics.inc("controller.errors")

    # -- candidate generation ------------------------------------------------
    def _candidates(self, eff, eff_comm, slow) -> list:
        """GNN proposal on the effective graph, plus a polished variant of
        the current groups; each optionally polished. Deferred proposals are
        unusable mid-run (a task with no group cannot keep training)."""
        host = self.host
        out = []
        prop = host.placer.propose(eff)
        if not prop.deferred:
            out.append(prop)
        cur = assign_mod.Assignment(
            groups={n: sorted(pl.ids) for n, pl in host.placements.items()},
            deferred=[], stage_order={})
        if self.config.polish == "greedy":
            out = [self._greedy_polish(eff, eff_comm, a, slow)
                   for a in out + [cur]]
        elif self.config.polish == "sim":
            out = [host.placer.refine(eff, a) for a in out + [cur]]
        for a in out:
            a.stage_order = {n: cm.greedy_chain_order(eff, ids)
                             for n, ids in a.groups.items()}
        return out

    def _cheap_step(self, eff, eff_comm, ids, task, slow) -> float:
        """Drift-aware analytic step time of one group: best of pipeline and
        DP under the effective topology, compute scaled by the slowest
        member's live slowdown (a pipeline is paced by its slowest stage, a
        DP sync by its slowest worker)."""
        if not ids:
            return math.inf
        order = cm.greedy_chain_order(eff, ids)
        comm_g, comp_g = cm.gpipe_time(eff, ids, task, eff_comm, order)
        comm_d, comp_d = cm.dp_time(eff, ids, task, eff_comm)
        s = max(float(slow[i]) for i in ids)
        return min(comm_g + comp_g * s, comm_d + comp_d * s)

    def _greedy_polish(self, eff, eff_comm, assignment, slow):
        """Hill-climb member moves on the gate's own drift-aware score:
        swap a member for a spare, drop a member outright (a 6x-gray pipeline
        stage is worth losing even with no spare to replace it), or grow onto
        an idle spare. This is what actually evicts a gray machine or a
        member stranded behind a rotted link: ``sim_local_search`` scores
        with a *seeded* straggler draw and cannot see live gray state, so
        the default polish optimizes the same analytic score the gate
        checks."""
        host = self.host
        mem = eff.memory_gb()
        groups = {n: sorted(v) for n, v in assignment.groups.items()}
        used = {i for ids in groups.values() for i in ids}
        spares = sorted(set(range(eff.n)) - used)
        by_name = {t.name: t for t in host.tasks}
        for _ in range(max(1, self.config.polish_iters)):
            improved = False
            for name in sorted(groups):
                run = host.runs.get(name)
                if run is None or run.finish_time is not None or run.failed:
                    continue
                task = by_name[name]
                ids = groups[name]
                base = self._cheap_step(eff, eff_comm, ids, task, slow)
                # moves: (trial_ids, member_out or None, spare_in or None)
                trials = []
                for i in ids:
                    if len(ids) > 1:
                        trials.append((sorted(set(ids) - {i}), i, None))
                    for sp in spares:
                        trials.append((sorted(set(ids) - {i} | {sp}), i, sp))
                for sp in spares:
                    trials.append((sorted(set(ids) | {sp}), None, sp))
                best = None
                for trial, i, sp in trials:
                    if sum(mem[j] for j in trial) < task.min_memory_gb:
                        continue
                    t = self._cheap_step(eff, eff_comm, trial, task, slow)
                    if t < (best[0] if best else base) - 1e-9:
                        best = (t, trial, i, sp)
                if best is not None:
                    _, trial, i, sp = best
                    groups[name] = trial
                    if i is not None:
                        spares.append(i)
                    if sp is not None:
                        spares.remove(sp)
                    spares.sort()
                    improved = True
            if not improved:
                break
        return assign_mod.Assignment(groups=groups, deferred=[],
                                     stage_order={})

    # -- scoring -------------------------------------------------------------
    def _remaining(self, eff, eff_comm, placements, slow) -> float:
        """Predicted remaining run time under ``placements``: per unfinished
        task, remaining steps x drift-aware analytic step time (compute
        scaled by the group's slowest member); tasks run concurrently, so
        the fleet's remaining time is the max."""
        host = self.host
        worst = 0.0
        for name, run in host.runs.items():
            if run.finish_time is not None or run.failed:
                continue
            pl = placements.get(name)
            if pl is None or not pl.ids:
                return math.inf
            comm_s, comp_s = cm.gpipe_time(eff, pl.ids, run.task, eff_comm,
                                           pl.order) \
                if pl.strategy == "gpipe" else (
                    cm.dp_time(eff, pl.ids, run.task, eff_comm)
                    if pl.strategy == "dp"
                    else cm.tp_time(eff, pl.ids, run.task, eff_comm))
            s = max(float(slow[i]) for i in pl.ids)
            step = float(comm_s + comp_s * s)   # jax/np scalars -> plain
            rem = max(1, host.steps - run.steps_done)
            if not math.isfinite(step):
                return math.inf
            worst = max(worst, step * rem)
        return worst

    # -- reading -------------------------------------------------------------
    def summary(self) -> dict:
        acts = collections.Counter(e["action"] for e in self.log)
        why = collections.Counter(e["why"] for e in self.log
                                  if e["action"] == "suppressed")
        return {
            "alerts": len(self.monitor.alerts),
            "replans": acts.get("commit", 0),
            "rollbacks": acts.get("rollback", 0),
            "suppressed": acts.get("suppressed", 0),
            "suppressed_by": dict(sorted(why.items())),
            "gate_rejects": acts.get("gate_reject", 0),
            "errors": acts.get("error", 0),
            "dead": self.dead,
            "log": [dict(e) for e in self.log],
        }
