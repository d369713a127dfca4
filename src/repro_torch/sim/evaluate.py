"""Run placements through the simulator and score Hulk vs the baselines.

``FleetSimulation`` drives one system (one placer) through a scenario: it
replays ``steps`` training steps of every task over the shared network, fires
the scenario's fault schedule (each fault bumps the sim epoch, aborts all
in-flight work, asks the placer to re-plan — the Hulk placer delegates to
``runtime.elastic.ElasticRuntime`` — and restarts the interrupted steps on
the new placement), and reports per-task step times plus the makespan.

``evaluate_scenario`` / ``evaluate_all`` run Hulk and Systems A/B/C (the
``core.baselines`` strategies) across the scenario registry and emit the
comparison table the benchmark harness prints.

Simulator-in-the-loop placement (``label_mode``)
------------------------------------------------
``observed_telemetry`` exports what the simulator *measures* about a fleet —
persistent per-machine slowdowns and jitter (``sim.compute``), relay-hub
membership (``sim.network``) — as a ``core.graph.NodeTelemetry``, the bridge
that feeds simulator signals back into GNN features.

``evaluate_scenario(..., label_mode="sim")`` closes the training loop the
ROADMAP names: the Hulk GNN is trained on *sim-refined* labels
(``core.labels.sim_refined_labels``, supervision that has watched candidate
partitions run under the scenario's straggler/jitter config) with v2
telemetry features, and at placement time the scenario fleet carries its
observed telemetry so the GNN can see which machines are actually slow.
``label_mode="analytic"`` (default) is the historical, closed-form-labeled
path — bit-identical to before the sim-label work landed.

Port of ``repro/sim/evaluate.py``: numpy copies of the placers and the fleet
simulation, so every arm gives the reference's events and times; the Hulk
arm's GNN runs where its params lie (``trained_gnn`` trains it on CUDA
unless asked otherwise).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np

from repro_torch import _device
from repro_torch import obs as obs_mod
from repro_torch.core import assign as assign_mod
from repro_torch.core import cost_model as cm
from repro_torch.core import placement as placement_mod
from repro_torch.core import train as gnn_train
from repro_torch.core.graph import ClusterGraph, NodeTelemetry
from repro_torch.runtime import (ControllerConfig, ElasticRuntime, FailureEvent,
                           ReplanController)
from repro_torch.sim import faults as faults_mod
from repro_torch.sim import scenarios as sc
from repro_torch.sim.compute import ComputeModel, JitterConfig
from repro_torch.sim.engine import Barrier, Simulator
from repro_torch.sim.network import NetworkModel
from repro_torch.sim.workload import analytic_step_time, run_step


@dataclasses.dataclass
class Placement:
    ids: list[int]
    strategy: str                 # "dp" | "gpipe" | "tp"
    order: list[int]              # stage order (gpipe); ids otherwise


# ---------------------------------------------------------------------------
# Placers: produce placements and handle fault-time re-planning
# ---------------------------------------------------------------------------
class StaticPlacer:
    """Fixed placements; no fault handling (calibration runs)."""

    name = "static"

    def __init__(self, placements: dict[str, Placement]):
        self._placements = placements

    def place(self, graph: ClusterGraph) -> dict[str, Placement]:
        return dict(self._placements)

    def on_failure(self, failed_ids: Sequence[int], at_step: int):
        raise NotImplementedError("StaticPlacer cannot re-plan")


class FullFleetPlacer:
    """Systems A/B/C: every task occupies the whole fleet with one strategy;
    on failure the group is simply the survivors."""

    def __init__(self, strategy: str, tasks: Sequence[cm.ModelTask],
                 name: str):
        self.strategy = strategy
        self.tasks = list(tasks)
        self.name = name
        self.graph: Optional[ClusterGraph] = None

    def _placements(self) -> dict[str, Placement]:
        ids = list(range(self.graph.n))
        order = (cm.greedy_chain_order(self.graph, ids)
                 if self.strategy == "gpipe" else ids)
        return {t.name: Placement(list(ids), self.strategy, list(order))
                for t in self.tasks}

    def place(self, graph: ClusterGraph) -> dict[str, Placement]:
        self.graph = graph
        return self._placements()

    def on_failure(self, failed_ids: Sequence[int], at_step: int):
        self.graph = self.graph.remove_machines(list(failed_ids))
        return self.graph, self._placements()

    def on_join(self, machine):
        """A crashed machine recovered (fault-plan rejoin): the full-fleet
        strategies simply absorb it into every group."""
        self.graph = self.graph.add_machine(machine)
        return self.graph, self._placements()


class HulkPlacer:
    """GNN task assignment via ``core.assign``; per-group parallelism chosen
    by ``core.placement.plan_runtime`` (DP gradient sync vs pipeline
    activations, whichever moves fewer bytes over the slow links); fault
    re-planning delegated to ``runtime.elastic.ElasticRuntime``.

    ``sim_refine=True`` adds the simulator-in-the-loop step: every
    assignment (initial and post-failure) is polished by
    ``core.labels.sim_local_search`` on *simulated* makespan under the
    scenario's ``jitter``/``traffic`` — the same objective the evaluation
    measures — before it is committed. This is how observed stragglers that
    the GNN's proposal missed still get evicted from pipeline groups."""

    name = "Hulk"

    def __init__(self, tasks: Sequence[cm.ModelTask], params, cfg,
                 comm_model: str = "alphabeta", use_runtime_plan: bool = True,
                 sim_refine: bool = False,
                 jitter: Optional[JitterConfig] = None,
                 traffic: Optional[sc.TrafficBuilder] = None,
                 refine_iters: int = 24, seed: int = 0):
        self.tasks = list(tasks)
        self.params = params
        self.cfg = cfg
        self.comm_model = comm_model
        self.use_runtime_plan = use_runtime_plan
        self.sim_refine = sim_refine
        self.jitter = jitter
        self.traffic = traffic
        self.refine_iters = refine_iters
        self.seed = seed
        self.rt: Optional[ElasticRuntime] = None

    def _refined(self, graph: ClusterGraph,
                 assignment: assign_mod.Assignment) -> assign_mod.Assignment:
        """Local-search the assignment on simulated makespan (deferred
        tasks make every labeling infeasible, so the search cannot change
        anything and is skipped)."""
        from repro_torch.core import labels as labels_mod

        if assignment.deferred:
            return assignment
        idle = len(self.tasks)
        lab = np.full(graph.n, idle, np.int64)
        for ti, task in enumerate(self.tasks):
            for i in assignment.groups.get(task.name, []):
                lab[i] = ti
        lab = labels_mod.sim_local_search(
            graph, lab, self.tasks, iters=self.refine_iters, seed=self.seed,
            jitter=self.jitter, traffic=self.traffic,
            comm_model=self.comm_model)
        groups = {task.name: [int(j) for j in np.flatnonzero(lab == ti)]
                  for ti, task in enumerate(self.tasks)}
        stage_order = {name: cm.greedy_chain_order(graph, ids)
                       for name, ids in groups.items()}
        return assign_mod.Assignment(groups=groups, deferred=[],
                                     stage_order=stage_order)

    def _placements(self, graph: ClusterGraph,
                    assignment: assign_mod.Assignment) -> dict[str, Placement]:
        comm = cm.make_comm(graph, self.comm_model)
        by_name = {t.name: t for t in self.tasks}
        out: dict[str, Placement] = {}
        plans = {}
        if self.use_runtime_plan:
            plans = {p.task: p for p in placement_mod.plan_runtime(
                graph, assignment.groups, self.tasks)}
        for name, ids in assignment.groups.items():
            task = by_name[name]
            order = assignment.stage_order.get(name) or list(ids)
            strategy = "gpipe"
            plan = plans.get(name)
            if plan is not None and plan.pod_axis_strategy == "dp":
                # plan_runtime compares traffic only; honour it when DP is
                # actually memory-feasible, else stay on the pipeline.
                dp_c, _ = cm.dp_time(graph, ids, task, comm)
                if math.isfinite(dp_c):
                    strategy = "dp"
            if plan is not None and plan.pod_axis_strategy == "pipeline":
                order = list(plan.stage_order)
            out[name] = Placement(list(ids), strategy, list(order))
        return out

    def _commit_refined(self) -> None:
        """Sim-refine the runtime's current assignment and commit it (with
        refreshed observed telemetry — the straggler draw is a function of
        fleet size, so after machines leave, the pre-failure telemetry
        would describe the wrong machines) through
        ``ElasticRuntime.commit_assignment``. No-op without ``sim_refine``."""
        if not self.sim_refine:
            return
        graph = self.rt.graph
        if graph.telemetry is not None:
            graph = graph.with_telemetry(observed_telemetry(
                graph, jitter=self.jitter, seed=self.seed,
                comm_model=self.comm_model))
        refined = self._refined(graph, self.rt.assignment)
        if (refined.groups != self.rt.assignment.groups
                or graph is not self.rt.graph):
            self.rt.commit_assignment(refined, graph=graph,
                                      reason="sim_refine")

    def place(self, graph: ClusterGraph) -> dict[str, Placement]:
        self.rt = ElasticRuntime(graph, self.tasks, self.params, self.cfg)
        self._commit_refined()
        return self._placements(self.rt.graph, self.rt.assignment)

    def on_failure(self, failed_ids: Sequence[int], at_step: int):
        self.rt.on_failure(FailureEvent(list(failed_ids), at_step))
        self._commit_refined()
        return self.rt.graph, self._placements(self.rt.graph,
                                               self.rt.assignment)

    def on_join(self, machine):
        """A crashed machine recovered (fault-plan rejoin): run it through
        ``ElasticRuntime.on_join`` — the same deferred-task / >10%-win
        re-assignment path autoscale joins use — then sim-refine if
        enabled."""
        self.rt.on_join(machine)
        self._commit_refined()
        return self.rt.graph, self._placements(self.rt.graph,
                                               self.rt.assignment)

    # -- online mode (runtime.controller) ------------------------------------
    def propose(self, graph: ClusterGraph) -> assign_mod.Assignment:
        """A fresh GNN assignment for ``graph`` (normally carrying live
        telemetry and the network's effective latency), *not* committed —
        the re-planning controller scores it against the current plan."""
        return assign_mod.task_assignments(graph, self.tasks, self.params,
                                           self.cfg)

    def refine(self, graph: ClusterGraph,
               assignment: assign_mod.Assignment) -> assign_mod.Assignment:
        """Expose the sim-local-search polish to the online controller."""
        return self._refined(graph, assignment)

    def commit(self, assignment: assign_mod.Assignment, graph: ClusterGraph,
               reason: str = "controller") -> dict[str, Placement]:
        """Adopt a controller-chosen assignment mid-run through the same
        epoch-guarded ``ElasticRuntime.commit_assignment`` path refinement
        and fault recovery use; returns the runnable placements."""
        self.rt.commit_assignment(assignment, graph=graph, reason=reason)
        return self._placements(self.rt.graph, self.rt.assignment)


# ---------------------------------------------------------------------------
# The fleet simulation
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _TaskRun:
    task: cm.ModelTask
    steps_done: int = 0
    step_times: list = dataclasses.field(default_factory=list)
    compute_s: float = 0.0
    comm_s: float = 0.0
    finish_time: Optional[float] = None
    failed: bool = False


@dataclasses.dataclass
class SimResult:
    system: str
    per_task: dict[str, dict]
    makespan: float
    compute_s: float
    comm_s: float
    replans: list[dict]
    n_events: int
    bytes_moved: float
    stragglers: list[int]
    metrics: dict = dataclasses.field(default_factory=dict)

    def mean_step_s(self, task: str) -> float:
        ts = self.per_task[task]["step_times"]
        return float(np.mean(ts)) if ts else math.inf


class FleetSimulation:
    def __init__(self, graph: ClusterGraph, tasks: Sequence[cm.ModelTask],
                 placer, *, comm_model: str = "alphabeta",
                 jitter: Optional[JitterConfig] = None,
                 traffic: Optional[sc.TrafficBuilder] = None,
                 fault_fracs: Sequence[float] = (),
                 kills_per_fault: int = 1, fault_plan=None,
                 steps: int = 3, seed: int = 0, concurrent: bool = True,
                 net_solver: str = "fast", obs=None, controller=None,
                 sim=None, net=None, compute=None):
        # shared-fleet (colocated) mode: an externally owned engine + data /
        # compute planes replace the privately built ones, so a second tenant
        # (a ServeExecutor) can contend on the same links and machines. The
        # paths that tear the models down and rebuild them — crash re-plans,
        # the online controller, traffic capacity scaling — would yank the
        # fabric out from under the other tenant, so they are rejected here.
        self._shared = any(m is not None for m in (sim, net, compute))
        if self._shared:
            if sim is None or net is None or compute is None:
                raise ValueError("shared-fleet mode needs all of "
                                 "sim=, net= and compute=")
            if controller is not None:
                raise ValueError("shared-fleet mode does not support a "
                                 "controller (commits rebuild the data plane)")
            if fault_plan is not None or fault_fracs:
                raise ValueError("shared-fleet mode takes no fault plan: "
                                 "inject faults through the executor that "
                                 "owns routing (see sim.colocate)")
            if traffic is not None:
                raise ValueError("shared-fleet mode takes no traffic "
                                 "builder: bake capacity_scale into the "
                                 "shared NetworkModel instead")
        self.graph = graph
        self.tasks = list(tasks)
        self.placer = placer
        self.comm_model = comm_model
        self.net_solver = net_solver
        self.jitter = jitter or JitterConfig()
        self.traffic = traffic
        self.fault_fracs = tuple(fault_fracs)
        self.kills_per_fault = kills_per_fault
        # legacy fields are a thin shim over the plan (same schedule + rng)
        if fault_plan is None and self.fault_fracs:
            fault_plan = faults_mod.plan_from_fracs(self.fault_fracs,
                                                    kills_per_fault)
        self.fault_plan = fault_plan if fault_plan else None
        self.steps = steps
        self.seed = seed
        self.concurrent = concurrent

        # the online controller is driven by the metric stream, so a run
        # with a controller needs an enabled recorder even when the caller
        # didn't ask for one; controller=None keeps the historical obs
        # behaviour bit-for-bit
        self.controller = controller
        if controller is not None and (obs is None or not obs.enabled):
            obs = obs_mod.Recorder()
        self.obs = obs if obs is not None else obs_mod.NULL
        self.sim = sim if sim is not None else Simulator(obs=self.obs)
        if self._shared:
            self.net = net
            self.compute = compute
        self.migrations_in_flight = 0
        self.placements: dict[str, Placement] = {}
        self.runs = {t.name: _TaskRun(task=t) for t in self.tasks}
        self.replans: list[dict] = []
        self._queue: list[str] = []       # sequential mode
        self._bytes_retired = 0.0
        self._stragglers: list[int] = []
        # fault-plan payloads carry *original* (t=0 graph) machine ids;
        # _orig2cur translates them to post-compaction ids (-1 = gone)
        self._orig2cur: list[int] = list(range(graph.n))
        # environmental fault state, keyed on original ids so it can be
        # re-applied to the freshly built models after every re-plan
        self._active_link_faults: dict[int, dict] = {}
        self._gray_state: dict[int, float] = {}
        # plans with partitions park unreachable transfers until the heal
        # instead of erroring — a severed pipeline stalls, it doesn't crash
        self._stall_net = faults_mod.has_link_faults(self.fault_plan)

    # -- model (re)construction --------------------------------------------
    def _estimate_horizon(self) -> float:
        """Analytic run-length estimate used to anchor fault times and the
        diurnal period (coarse is fine: fractions of roughly-the-run)."""
        comm = cm.make_comm(self.graph, self.comm_model)
        times = []
        for name, pl in self.placements.items():
            c, p = analytic_step_time(self.graph, pl.ids,
                                      self.runs[name].task, comm,
                                      pl.strategy, pl.order)
            if math.isfinite(c + p):
                times.append((c + p) * self.steps)
        if not times:
            return 1000.0
        return max(times) if self.concurrent else sum(times)

    def _build_models(self, horizon: float) -> None:
        if self._shared:
            # the shared planes are owned by the colocated host — only the
            # derived read-side state is (re)built here
            self._comm = cm.make_comm(self.graph, self.comm_model)
            self._stragglers = self.compute.stragglers()
            return
        scale = self.traffic(self.graph, horizon) if self.traffic else None
        self.net = NetworkModel(self.graph, self.comm_model,
                                capacity_scale=scale,
                                solver=self.net_solver, obs=self.obs)
        self.compute = ComputeModel(self.graph, self.jitter, seed=self.seed)
        self._comm = cm.make_comm(self.graph, self.comm_model)
        self._stragglers = self.compute.stragglers()
        self.net.stall_unreachable = self._stall_net
        self._reapply_faults()

    # -- fault-plan id translation + environmental state --------------------
    def _cur_pairs(self, pairs) -> list[tuple[int, int]]:
        out = []
        for a, b in pairs:
            ca = self._orig2cur[a] if a < len(self._orig2cur) else -1
            cb = self._orig2cur[b] if b < len(self._orig2cur) else -1
            if ca >= 0 and cb >= 0:
                out.append((ca, cb))
        return out

    def _reapply_faults(self) -> None:
        """Fresh models know nothing: re-install every still-active link
        overlay and gray slowdown (translated to current ids) after a
        re-plan rebuilt them."""
        for fid, p in self._active_link_faults.items():
            pairs = self._cur_pairs(p["pairs"])
            if pairs:
                self.net.apply_link_fault(fid, pairs,
                                          bw_factor=p["bw_factor"],
                                          lat_factor=p["lat_factor"],
                                          cut=p["cut"])
        for orig, factor in self._gray_state.items():
            cur = self._orig2cur[orig] if orig < len(self._orig2cur) else -1
            if cur >= 0:
                self.compute.set_gray(cur, factor)

    def _remap_after_failure(self, victims: Sequence[int]) -> None:
        """Victims (current ids) left and the graph compacted: ids above
        each victim shift down by one."""
        vs = sorted(victims)
        remapped = []
        for cur in self._orig2cur:
            if cur < 0 or cur in vs:
                remapped.append(-1)
            else:
                shift = sum(1 for v in vs if v < cur)
                remapped.append(cur - shift)
        self._orig2cur = remapped

    # -- task stepping ------------------------------------------------------
    def _feasible(self, run: _TaskRun, pl: Placement) -> bool:
        c, p = analytic_step_time(self.graph, pl.ids, run.task, self._comm,
                                  pl.strategy, pl.order)
        return math.isfinite(c + p)

    def _start_step(self, name: str) -> None:
        run = self.runs[name]
        pl = self.placements.get(name)
        if pl is None or not pl.ids or not self._feasible(run, pl):
            self._task_over(name, failed=True)
            return
        t_start = self.sim.now

        def done(comp_s: float, comm_s: float) -> None:
            run.step_times.append(self.sim.now - t_start)
            run.compute_s += comp_s
            run.comm_s += comm_s
            run.steps_done += 1
            if self.obs.enabled:
                # steps on one task are strictly sequential, so a complete
                # (X) span per step is safe on the task's lane
                # machines + strategy give trace analytics the causal edge
                # from this step to whatever next occupies those machines
                self.obs.trace.span_at(
                    f"task/{name}", f"step{run.steps_done - 1}",
                    t_start, self.sim.now, cat="train",
                    args={"compute_s": comp_s, "comm_s": comm_s,
                          "machines": [int(i) for i in pl.ids],
                          "strategy": str(pl.strategy)})
                self.obs.metrics.inc("sim.steps_done")
                self.obs.metrics.observe("sim.step_s",
                                         self.sim.now - t_start)
                if self.controller is not None:
                    # per-machine observed slowdown for the drift monitor,
                    # keyed by *original* id (stable across compaction) —
                    # only emitted when a controller is listening, so
                    # controller=None traces stay bit-identical
                    slow = self.compute.slow_factor * self.compute.gray
                    cur2orig = {c: o for o, c in enumerate(self._orig2cur)
                                if c >= 0}
                    for i in pl.ids:
                        o = cur2orig.get(int(i))
                        if o is not None:
                            self.obs.metrics.observe(
                                f"replica.slowdown.m{o}", float(slow[i]))
            if run.steps_done >= self.steps:
                self._task_over(name, failed=False)
            else:
                self._start_step(name)

        run_step(self.sim, self.net, self.compute, self.graph, run.task,
                 pl.ids, pl.strategy, pl.order, run.steps_done, done,
                 comm=self._comm)

    def _task_over(self, name: str, failed: bool) -> None:
        run = self.runs[name]
        run.failed = failed
        run.finish_time = None if failed else self.sim.now
        if not self.concurrent and self._queue:
            self._start_step(self._queue.pop(0))

    # -- faults -------------------------------------------------------------
    def _apply_fault(self, act) -> None:
        """Dispatch one compiled ``sim.faults.FaultAction``."""
        if self.obs.enabled:
            self.obs.metrics.inc("faults.injected")
            self.obs.metrics.inc(f"faults.{act.kind}")
            self.obs.trace.instant(
                "faults", act.kind, cat="fault",
                args={"injector": act.injector,
                      **{k: v for k, v in act.payload.items()
                         if isinstance(v, (int, float, str, bool))
                         and v is not None}})
        if act.kind == "crash":
            self._apply_crash(act.payload, act.injector)
        elif act.kind == "link":
            self._active_link_faults[act.injector] = dict(act.payload)
            pairs = self._cur_pairs(act.payload["pairs"])
            if pairs:
                self.net.apply_link_fault(act.injector, pairs,
                                          bw_factor=act.payload["bw_factor"],
                                          lat_factor=act.payload["lat_factor"],
                                          cut=act.payload["cut"],
                                          sim=self.sim)
        elif act.kind == "link_clear":
            self._active_link_faults.pop(act.payload["fault_id"], None)
            self.net.clear_link_fault(act.payload["fault_id"], sim=self.sim)
        elif act.kind == "gray":
            m = act.payload["machine"]
            self._gray_state[m] = act.payload["factor"]
            cur = self._orig2cur[m] if m < len(self._orig2cur) else -1
            if cur >= 0:
                self.compute.set_gray(cur, act.payload["factor"])
        elif act.kind == "gray_clear":
            m = act.payload["machine"]
            self._gray_state.pop(m, None)
            cur = self._orig2cur[m] if m < len(self._orig2cur) else -1
            if cur >= 0:
                self.compute.set_gray(cur, 1.0)
        else:
            raise ValueError(f"unknown fault action {act.kind!r}")

    def _apply_crash(self, payload: dict, k: int) -> None:
        alive = [r for r in self.runs.values()
                 if r.finish_time is None and not r.failed]
        if not alive:
            return  # nothing left to disrupt (run over or capacity exhausted)
        explicit = payload.get("machines", ())
        if explicit:
            victims = sorted({self._orig2cur[v] for v in explicit
                              if v < len(self._orig2cur)
                              and self._orig2cur[v] >= 0})
            # a crash can never take the whole fleet: the last survivor stays
            victims = victims[:max(0, self.graph.n - 1)]
        else:
            # Preemptions strike the fleet uniformly — idle spares included,
            # not just assigned machines (Systems A/B/C occupy the whole
            # fleet, so their draws are unchanged). A kill that lands on a
            # spare still aborts the in-flight steps (the epoch bump and
            # model rebuild are fleet-wide), but it preserves the placement:
            # recover() re-plans no group, no pipeline loses capacity, and
            # the restarted steps run at full speed — so a disaster-recovery
            # spare pool (the paper idles 7/46 nodes for exactly this)
            # softens faults instead of being invisible to them.
            pool = list(range(self.graph.n))
            if len(pool) <= 1:
                return
            rng = np.random.default_rng(
                (self.seed, faults_mod.CRASH_STREAM, k))
            kills = min(int(payload["kills"]), len(pool) - 1)
            victims = sorted(int(i) for i in
                             rng.choice(pool, size=kills, replace=False))
        if not victims:
            return
        if self.obs.enabled:
            # one instant per victim: the bulk crash instant drops its
            # machine list (tuple args are filtered), so downtime intervals
            # need these to pair machine_down -> recover/rejoin per machine
            for v in victims:
                self.obs.trace.instant("faults", "machine_down", cat="fault",
                                       args={"machine": int(v)})
        # capture the Machine objects BEFORE the graph compacts (the rejoin
        # needs them), keyed by original id so the map survives further
        # failures between crash and recovery
        rec_after = payload.get("recover_after_s")
        rejoin: list[tuple[int, object]] = []
        if rec_after is not None and hasattr(self.placer, "on_join"):
            cur2orig = {c: o for o, c in enumerate(self._orig2cur) if c >= 0}
            rejoin = [(cur2orig.get(v, -1), self.graph.machines[v])
                      for v in victims]
        self.sim.bump_epoch()
        self.net.reset()
        # in-flight migration transfers died with the epoch; the controller's
        # probation snapshot is stale (ids compact below)
        self.migrations_in_flight = 0
        if self.controller is not None:
            self.controller.on_external_replan()
        try:
            self.graph, self.placements = self.placer.on_failure(
                victims, at_step=max(r.steps_done for r in self.runs.values()))
        except assign_mod.PlacementError:
            # survivors can't host the tasks at all: everything unfinished dies
            # (self.net stays in place, so its bytes are counted exactly once)
            for run in self.runs.values():
                if run.finish_time is None:
                    run.failed = True
            self._queue.clear()
            return
        self._remap_after_failure(victims)
        self.replans.append({"at_s": self.sim.now, "killed": victims,
                             "fault_index": k})
        self._bytes_retired += self.net.bytes_moved  # old net is replaced next
        self._build_models(self._estimate_horizon())
        self._restart_unfinished()
        if rejoin:
            self.sim.schedule(rec_after, self._apply_rejoin, tuple(rejoin),
                              pin_epoch=False)

    def _apply_rejoin(self, rejoin) -> None:
        """Crashed machines recover: each rejoins through the placer's
        ``on_join`` (full-fleet absorption or ``ElasticRuntime.on_join``),
        the models rebuild around the grown graph, and interrupted steps
        restart — the checkpoint-restore convention faults already use."""
        alive = [r for r in self.runs.values()
                 if r.finish_time is None and not r.failed]
        if not alive:
            return
        self.sim.bump_epoch()
        self.net.reset()
        self.migrations_in_flight = 0
        if self.controller is not None:
            self.controller.on_external_replan()
        joined = []
        for orig, machine in rejoin:
            try:
                self.graph, self.placements = self.placer.on_join(machine)
            except assign_mod.PlacementError:
                continue  # the re-plan rejected the rejoin; stay as-is
            if orig >= 0:
                self._orig2cur[orig] = self.graph.n - 1
            joined.append(orig)
        self.replans.append({"at_s": self.sim.now, "rejoined": joined})
        if self.obs.enabled:
            self.obs.metrics.inc("faults.recoveries", len(joined))
            self.obs.trace.instant("faults", "rejoin", cat="fault",
                                   args={"n": len(joined)})
            for orig in joined:
                if orig >= 0:
                    # rejoin marker: DriftMonitor drops the machine's stale
                    # pre-crash EWMA slowdown state on this signal
                    self.obs.metrics.inc(f"machine.rejoin.m{orig}")
        self._bytes_retired += self.net.bytes_moved
        self._build_models(self._estimate_horizon())
        self._restart_unfinished()

    def _restart_unfinished(self) -> None:
        # interrupted steps restart on the new placement (progress since the
        # last completed step is lost — checkpoint-restore semantics)
        if self.concurrent:
            for name, run in self.runs.items():
                if run.finish_time is None and not run.failed:
                    self._start_step(name)
        else:
            running = [name for name, run in self.runs.items()
                       if run.finish_time is None and not run.failed
                       and name not in self._queue]
            for name in running:
                self._start_step(name)

    # -- online re-planning (runtime.controller) -----------------------------
    def unfinished(self) -> list[str]:
        return [n for n, r in self.runs.items()
                if r.finish_time is None and not r.failed]

    def commit_plan(self, assignment, graph, *,
                    reason: str = "controller_replan") -> dict:
        """Commit a controller-produced assignment mid-run through the exact
        epoch-guarded sequence fault recovery uses (bump epoch -> reset net
        -> commit through the placer's runtime -> rebuild models -> restart
        interrupted steps), plus the one thing a voluntary re-plan adds:
        the plan delta's **migration traffic**. Every machine joining a
        group pulls the task's parameters from the cheapest retained member
        over the *new* network before that task's step restarts (a Barrier
        joins the pulls); tasks whose groups didn't change restart
        immediately. ``migrations_in_flight`` counts outstanding pulls so
        the controller can refuse to re-plan while a previous commit is
        still propagating."""
        live = set(self.unfinished())
        old_groups = {name: sorted(pl.ids)
                      for name, pl in self.placements.items() if name in live}
        self.sim.bump_epoch()
        self.net.reset()
        self.migrations_in_flight = 0   # epoch bump killed any stragglers
        self.placements = self.placer.commit(assignment, graph,
                                             reason=reason)
        self.graph = self.placer.rt.graph
        new_groups = {name: sorted(pl.ids)
                      for name, pl in self.placements.items() if name in live}
        moves = assign_mod.migration_moves(
            old_groups, new_groups, self.tasks,
            strategies={name: pl.strategy
                        for name, pl in self.placements.items()})
        self.replans.append({"at_s": self.sim.now, "reason": reason,
                             "moves": len(moves)})
        self._bytes_retired += self.net.bytes_moved
        self._build_models(self._estimate_horizon())

        by_task: dict[str, list] = {}
        for name, srcs, dst, nb in moves:
            by_task.setdefault(name, []).append((srcs, dst, nb))
        if self.concurrent:
            names = self.unfinished()
        else:
            names = [n for n in self.unfinished() if n not in self._queue]
        total_bytes = 0.0
        for name in names:
            mv = by_task.get(name)
            if not mv:
                self._start_step(name)
                continue
            barrier = Barrier(len(mv), lambda name=name:
                              self._start_step(name))
            self.migrations_in_flight += len(mv)

            def arrived(b=barrier):
                self.migrations_in_flight -= 1
                b.arrive()

            for srcs, dst, nb in mv:
                src = min(srcs, key=lambda s:
                          (self.net.estimate_transfer_s(s, dst, nb), s))
                total_bytes += nb
                self.net.transfer(self.sim, src, dst, nb, arrived)
        if self.obs.enabled:
            self.obs.metrics.inc("sim.controller_commits")
            self.obs.trace.instant(
                "controller", "plan_commit", cat="controller",
                args={"reason": reason, "moves": len(moves),
                      "bytes": float(total_bytes)})
        return {"moves": len(moves), "bytes": float(total_bytes)}

    # -- entry point --------------------------------------------------------
    def start(self) -> None:
        """Place the tasks, build (or adopt) the models and schedule the
        first steps + fault plan — everything ``run()`` does before draining
        the heap. Split out so a colocated host can start several tenants on
        one shared ``Simulator`` before running it."""
        if self.controller is not None:
            self.controller.bind(self)
        self.placements = self.placer.place(self.graph)
        horizon = self._estimate_horizon()
        self._build_models(horizon)
        names = [t.name for t in self.tasks]
        if self.concurrent:
            for name in names:
                self._start_step(name)
        else:
            self._queue = names[1:]
            self._start_step(names[0])
        if self.fault_plan is not None and math.isfinite(horizon) \
                and horizon > 0:
            for act in faults_mod.compile_plan(self.fault_plan, self.graph,
                                               horizon, self.seed):
                self.sim.schedule(act.t, self._apply_fault, act,
                                  pin_epoch=False)

    def run(self) -> SimResult:
        self.start()
        self.sim.run()
        return self.finalize()

    def finalize(self) -> SimResult:
        per_task = {}
        finishes = []
        for name, run in self.runs.items():
            per_task[name] = {
                "step_times": list(run.step_times),
                "mean_step_s": (float(np.mean(run.step_times))
                                if run.step_times else math.inf),
                "compute_s": run.compute_s, "comm_s": run.comm_s,
                "finish_s": run.finish_time, "failed": run.failed,
            }
            finishes.append(math.inf if run.failed or run.finish_time is None
                            else run.finish_time)
        makespan = max(finishes) if finishes else math.inf
        metrics = {
            "engine.events_dispatched": self.sim.events_dispatched,
            "engine.events_scheduled": self.sim.events_scheduled,
            "net.solver.solves": self.net.n_solves,
            "net.bytes_moved": float(self._bytes_retired
                                     + self.net.bytes_moved),
        }
        if self.obs.enabled:
            metrics.update(self.obs.metrics.flat())
        return SimResult(
            system=getattr(self.placer, "name", "?"),
            per_task=per_task, makespan=float(makespan),
            compute_s=float(sum(r.compute_s for r in self.runs.values())),
            comm_s=float(sum(r.comm_s for r in self.runs.values())),
            replans=list(self.replans), n_events=self.sim.events_dispatched,
            bytes_moved=float(self._bytes_retired + self.net.bytes_moved),
            stragglers=list(self._stragglers), metrics=metrics)


# ---------------------------------------------------------------------------
# Telemetry export: what the simulator observed about a fleet, packaged for
# v2 node features (the "feeding back" hook).
# ---------------------------------------------------------------------------
def observed_telemetry(graph: ClusterGraph, jitter: Optional[JitterConfig] = None,
                       seed: int = 0,
                       comm_model: str = "alphabeta") -> NodeTelemetry:
    """Per-machine signals a simulation of ``graph`` under ``jitter`` would
    observe: the persistent straggler slowdown and jitter sigma from
    ``ComputeModel`` (the same seeded draw ``FleetSimulation`` uses) and
    relay-hub membership from ``NetworkModel``'s routed topology. Attach
    with ``graph.with_telemetry(...)`` to expose them as v2 node features."""
    if graph.n == 0:
        # an empty fleet has nothing to observe; constructing the models
        # just to read zero rows would trip their n>=1 assumptions
        return NodeTelemetry.clean(0)
    slowdown, sigma = ComputeModel(graph, jitter, seed=seed).telemetry()
    hubs = NetworkModel(graph, comm_model).relay_hubs()
    return NodeTelemetry(slowdown, sigma, hubs)


def observed_telemetry_live(net: NetworkModel,
                            compute: ComputeModel) -> NodeTelemetry:
    """Telemetry from *live* models mid-run, rather than a fresh seeded
    draw: machines that joined after t=0 (``add_machine``) carry the clean
    rows the models appended for them, and machines that are gone — dead in
    ``compute.alive`` or tombstoned out of the network — are zeroed
    (slowdown forced to the healthy 1.0, sigma/hub to 0), because a
    deprovisioned machine produces no telemetry and must not be fed to the
    GNN as a straggler. Relay hubs come from the network's current routed
    topology, so tombstones also stop conferring hub membership."""
    slowdown, sigma = compute.telemetry()
    n = len(slowdown)
    hubs = np.asarray(net.relay_hubs(), np.float32)
    if len(hubs) < n:      # network built before machines joined
        hubs = np.append(hubs, np.zeros(n - len(hubs), np.float32))
    hubs = hubs[:n].copy()
    gone = ~compute.alive[:n]
    for mid in net.tombstoned:
        if mid < n:
            gone[mid] = True
    slowdown[gone] = 1.0
    sigma[gone] = 0.0
    hubs[gone] = 0.0
    return NodeTelemetry(slowdown, sigma, hubs)


# ---------------------------------------------------------------------------
# Convenience entry points
# ---------------------------------------------------------------------------
def simulate_single(graph: ClusterGraph, ids: Sequence[int],
                    task: cm.ModelTask, strategy: str, *,
                    comm_model: str = "alphabeta", steps: int = 1,
                    seed: int = 0, jitter: Optional[JitterConfig] = None,
                    order: Optional[Sequence[int]] = None) -> SimResult:
    """One task, one placement — the calibration harness."""
    order = list(order) if order is not None \
        else cm.greedy_chain_order(graph, ids)
    placer = StaticPlacer({task.name: Placement(list(ids), strategy, order)})
    fs = FleetSimulation(graph, [task], placer, comm_model=comm_model,
                         jitter=jitter, steps=steps, seed=seed)
    return fs.run()


_GNN_CACHE: dict = {}


def trained_gnn(tasks: Sequence[cm.ModelTask], seed: int = 0,
                label_mode: str = "analytic",
                jitter: Optional[JitterConfig] = None,
                traffic: Optional[sc.TrafficBuilder] = None,
                comm_model: str = "alphabeta", device=None):
    """Train (and cache) the Hulk placement GNN for a task set, on
    ``device`` (CUDA by default); the cached params stay there, and every
    placement made with them runs the GNN there. A cache hit asked for an
    explicit ``device`` other than the one its params lie on raises
    ``ValueError``; ``device=None`` takes a hit wherever it lies.

    ``label_mode="analytic"`` (default) trains on the closed-form oracle
    labels with v1 features — the historical configuration, unchanged.
    ``label_mode="sim"`` trains on sim-refined labels under the scenario's
    ``jitter`` / ``traffic`` / ``comm_model`` with v2 telemetry features
    (``core.train.make_dataset(label_mode="sim")``); sim-label runs use a
    larger dataset + epoch budget because the task — route around observed
    stragglers and contention, not just latency — is harder."""
    # analytic labels ignore the sim-environment knobs: normalize them out
    # of the key so every scenario shares the one analytic GNN (the
    # historical behaviour). Sim-label keys carry all of them — traffic
    # builders hash by identity, which is stable within a process.
    if label_mode == "sim":
        key = (tuple(t.name for t in tasks), seed, label_mode, jitter,
               traffic, comm_model)
    else:
        key = (tuple(t.name for t in tasks), seed, label_mode)
    if key not in _GNN_CACHE:
        cfg = gnn_train.gnn_config_for(tasks)
        if label_mode == "sim":
            ds = gnn_train.make_dataset(6, tasks, n_nodes=12, seed=seed + 11,
                                        label_frac=0.9, label_mode="sim",
                                        jitter=jitter, traffic=traffic,
                                        comm_model=comm_model)
            params, _ = gnn_train.train_gnn(cfg, ds, steps=120, lr=0.01,
                                            seed=seed, device=device)
        else:
            ds = gnn_train.make_dataset(3, tasks, n_nodes=12, seed=seed + 11,
                                        label_frac=0.8)
            # default joint mode: one update/epoch over 3 graphs (~3x the old
            # sequential epoch count)
            params, _ = gnn_train.train_gnn(cfg, ds, steps=50, lr=0.01,
                                            seed=seed, device=device)
        _GNN_CACHE[key] = (params, cfg)
    elif device is not None:
        cached = _device.of(_GNN_CACHE[key][0])
        if cached != _device.resolve(device):
            raise ValueError(
                f"trained_gnn: the cached params for {key!r} lie on {cached}, "
                f"not on the requested {device!r}")
    return _GNN_CACHE[key]


def evaluate_scenario(scenario: sc.Scenario, seed: int = 0,
                      label_mode: str = "analytic") -> dict:
    """Score Hulk and Systems A/B/C on one scenario. Returns
    {system: metrics} plus the Hulk improvement vs the best baseline.

    ``label_mode="sim"`` swaps in the simulator-in-the-loop Hulk: GNN
    trained on sim-refined labels (see ``trained_gnn``) and a scenario
    fleet carrying its observed telemetry, so placement can react to the
    stragglers/hubs the simulation will actually contain. Baselines are
    unaffected (they ignore features)."""
    graph = scenario.fleet(seed)
    tasks = list(scenario.tasks)
    params, cfg = trained_gnn(tasks, seed=0, label_mode=label_mode,
                              jitter=scenario.jitter,
                              traffic=scenario.traffic,
                              comm_model=scenario.comm_model)
    hulk_graph = graph
    if label_mode == "sim":
        hulk_graph = graph.with_telemetry(observed_telemetry(
            graph, jitter=scenario.jitter, seed=seed,
            comm_model=scenario.comm_model))

    systems: list[tuple[str, object, bool]] = [
        ("Hulk", HulkPlacer(tasks, params, cfg,
                            comm_model=scenario.comm_model,
                            sim_refine=(label_mode == "sim"),
                            jitter=scenario.jitter, traffic=scenario.traffic,
                            seed=seed), True),
        ("SystemA", FullFleetPlacer("dp", tasks, "SystemA"), False),
        ("SystemB", FullFleetPlacer("gpipe", tasks, "SystemB"), False),
        ("SystemC", FullFleetPlacer("tp", tasks, "SystemC"), False),
    ]
    rows: dict = {"scenario": scenario.name}
    for name, placer, concurrent in systems:
        try:
            res = FleetSimulation(
                hulk_graph if name == "Hulk" else graph, tasks, placer,
                comm_model=scenario.comm_model,
                jitter=scenario.jitter, traffic=scenario.traffic,
                fault_fracs=scenario.fault_fracs,
                kills_per_fault=scenario.kills_per_fault,
                fault_plan=scenario.fault_plan,
                steps=scenario.steps, seed=seed,
                concurrent=concurrent).run()
            rows[name] = {
                "makespan_s": res.makespan,
                "compute_s": res.compute_s, "comm_s": res.comm_s,
                "replans": len(res.replans), "n_events": res.n_events,
                "failed": sorted(t for t, d in res.per_task.items()
                                 if d["failed"]),
                "mean_step_s": {t: d["mean_step_s"]
                                for t, d in res.per_task.items()},
                "metrics": res.metrics,
            }
        except assign_mod.PlacementError as e:
            rows[name] = {"makespan_s": math.inf, "error": str(e)}
    baselines = [rows[n]["makespan_s"] for n in ("SystemA", "SystemB",
                                                 "SystemC")]
    best = min(baselines)
    hulk = rows["Hulk"]["makespan_s"]
    rows["improvement_vs_best_baseline"] = (
        (best - hulk) / best if math.isfinite(best) and best > 0 else math.nan)
    return rows


def evaluate_all(seed: int = 0,
                 names: Optional[Sequence[str]] = None) -> dict[str, dict]:
    names = list(names) if names is not None else sorted(sc.SCENARIOS)
    return {n: evaluate_scenario(sc.get_scenario(n), seed=seed) for n in names}


def run_drift_scenario(scenario: "sc.DriftScenario", mode: str = "guarded",
                       seed: int = 0, obs=None):
    """Run one drift scenario under a re-planning policy. Returns
    ``(SimResult, controller)`` — controller is ``None`` in static mode.

    Modes:

    * ``"static"``    — no controller; the initial plan rides out the drift
      (bit-identical to a pre-controller ``FleetSimulation`` run).
    * ``"guarded"``   — the scenario's tuned ``ControllerConfig``: hysteresis,
      cooldown, migration-cost gate, canary probation.
    * ``"unguarded"`` — same drift thresholds, every guard disabled
      (``ControllerConfig.unguarded``): re-plan on every alert.
    """
    if mode == "static":
        controller = None
    elif mode == "guarded":
        controller = ReplanController(scenario.controller)
    elif mode == "unguarded":
        controller = ReplanController(
            ControllerConfig.unguarded(scenario.controller.drift))
    else:
        raise ValueError(f"unknown drift mode {mode!r}; "
                         "known: static/guarded/unguarded")
    graph = scenario.fleet(seed)
    tasks = list(scenario.tasks)
    params, cfg = trained_gnn(tasks, seed=0, label_mode=scenario.label_mode,
                              jitter=scenario.jitter,
                              traffic=scenario.traffic,
                              comm_model=scenario.comm_model)
    if scenario.label_mode == "sim":
        graph = graph.with_telemetry(observed_telemetry(
            graph, jitter=scenario.jitter, seed=seed,
            comm_model=scenario.comm_model))
    placer = HulkPlacer(tasks, params, cfg, comm_model=scenario.comm_model,
                        sim_refine=(scenario.label_mode == "sim"),
                        jitter=scenario.jitter, traffic=scenario.traffic,
                        seed=seed)
    res = FleetSimulation(graph, tasks, placer,
                          comm_model=scenario.comm_model,
                          jitter=scenario.jitter, traffic=scenario.traffic,
                          fault_plan=scenario.fault_plan,
                          steps=scenario.steps, seed=seed,
                          concurrent=True, obs=obs,
                          controller=controller).run()
    return res, controller


def comparison_table(results: dict[str, dict]) -> str:
    """Text table: scenario x system makespans + Hulk improvement."""
    systems = ["Hulk", "SystemA", "SystemB", "SystemC"]
    head = f"{'scenario':<20}" + "".join(f"{s:>12}" for s in systems) \
        + f"{'hulk_gain':>11}"
    lines = [head, "-" * len(head)]
    for name, row in results.items():
        def fmt(x: float) -> str:
            return f"{x:>12.1f}" if math.isfinite(x) else f"{'inf':>12}"
        cells = "".join(fmt(row[s]["makespan_s"]) for s in systems)
        gain = row["improvement_vs_best_baseline"]
        gain_s = f"{gain:>10.1%}" if math.isfinite(gain) else f"{'n/a':>10}"
        lines.append(f"{name:<20}{cells} {gain_s}")
    return "\n".join(lines)
