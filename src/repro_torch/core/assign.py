"""Algorithm 1 — Task Assignments (paper §5.1) + disaster recovery (§1.1/§5.2).
Port of ``repro/core/assign.py``; the GNN runs wherever its params lie.

Given graph data G, the trained GNN F, N tasks with minimum memory thresholds
M_n, split the graph into per-task machine groups. Faithful to the paper's
control flow:

  C <- 0
  if G does not meet the requirements of all tasks: error
  for i in 1..N:
      G_i, G_{i+1} <- F(G_i)            # GNN splits off the group for task i
      assign G_i to the task with the appropriate threshold M_n
      if G_i fails the requirements: C <- i and continue
          (when C >= 1: G_i <- G_i + G_C, assign, C <- 0)
      if G_{i+1} fails the remaining requirements: break and wait

F's bipartition is realized with the multi-class GNN: the nodes whose argmax
class is task i form G_i, the rest form G_{i+1}. A repair pass (beyond-paper,
documented in DESIGN.md) steals the cheapest-linked nodes from over-provisioned
groups when a task is left short — this makes the scheduler total instead of
"wait for other tasks" when capacity actually exists.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch import _device
from repro_torch import obs as obs_mod
from repro_torch.core import cost_model as cm
from repro_torch.core import gnn
from repro_torch.core import train as gnn_train
from repro_torch.core.graph import ClusterGraph


class PlacementError(RuntimeError):
    pass


@dataclasses.dataclass
class Assignment:
    groups: dict[str, list[int]]     # task name -> machine ids
    deferred: list[str]              # tasks waiting for capacity
    stage_order: dict[str, list[int]]  # GPipe chain order per task


def _mem(graph: ClusterGraph, ids) -> float:
    m = graph.memory_gb()
    return float(sum(m[i] for i in ids))


def check_capacity(graph: ClusterGraph, tasks: Sequence[cm.ModelTask]) -> bool:
    total = float(graph.memory_gb().sum())
    return total >= sum(t.min_memory_gb for t in tasks)


def task_assignments(graph: ClusterGraph, tasks: Sequence[cm.ModelTask],
                     params, cfg: gnn.GNNConfig, repair: bool = True) -> Assignment:
    """Algorithm 1. Tasks are processed largest-first (paper: classify classes
    'according to this scale')."""
    if not check_capacity(graph, tasks):
        raise PlacementError("G does not meet the requirements of all tasks")

    order = sorted(range(len(tasks)), key=lambda i: -tasks[i].params)
    device = _device.of(params)
    remaining = list(range(graph.n))
    groups: dict[str, list[int]] = {}
    deferred: list[str] = []
    carry: list[int] = []  # the paper's G_C

    for idx, ti in enumerate(order):
        task = tasks[ti]
        if not remaining:
            deferred.append(task.name)
            continue
        sub = graph.subgraph(remaining)
        # class per node of subgraph, computed where the params lie
        pred = gnn_train.predict(params, cfg, sub, device=device)
        g_i = [remaining[k] for k in range(len(remaining)) if pred[k] == ti]
        if not g_i:
            # GNN put nothing in this class: take its highest-logit nodes
            logits = gnn_train.predict_logits(params, cfg, sub,
                                              device=device)[:, ti]
            ranked = np.argsort(-logits)
            g_i = [remaining[int(ranked[0])]]

        if _mem(graph, g_i) < task.min_memory_gb:
            if carry:
                g_i = sorted(set(g_i) | set(carry))  # G_i <- G_i + G_C
                carry = []
            if _mem(graph, g_i) < task.min_memory_gb:
                carry = g_i          # C <- i and continue
                g_set = set(g_i)     # hoisted: `in set(g_i)` per element is O(n^2)
                remaining = [r for r in remaining if r not in g_set]
                deferred.append(task.name)
                continue

        groups[task.name] = sorted(g_i)
        g_set = set(g_i)
        remaining = [r for r in remaining if r not in g_set]

        rest_tasks = [tasks[tj] for tj in order[idx + 1:]]
        if rest_tasks and _mem(graph, remaining + carry) < sum(
                t.min_memory_gb for t in rest_tasks):
            # "Break and provide a prompt and wait for other tasks to complete"
            deferred.extend(t.name for t in rest_tasks)
            break

    if carry:
        remaining = sorted(set(remaining) | set(carry))

    n_deferred_pre_repair = len(deferred)
    if repair:
        groups, deferred, remaining = _repair(graph, tasks, groups, deferred,
                                              remaining)
    # Nodes predicted idle (or left over) stay unassigned: they are the spare
    # pool for disaster recovery (paper Table 2 leaves 7 of 46 nodes idle).
    stage_order = {name: cm.greedy_chain_order(graph, ids)
                   for name, ids in groups.items()}
    rec = obs_mod.current()
    if rec.enabled:
        rec.metrics.inc("plan.assign.calls")
        rec.metrics.inc("plan.assign.deferred_pre_repair",
                        n_deferred_pre_repair)
        rec.metrics.inc("plan.assign.deferred", len(deferred))
        rec.metrics.gauge("plan.assign.spare_pool", float(len(remaining)))
    return Assignment(groups=groups, deferred=deferred, stage_order=stage_order)


def _repair(graph, tasks, groups, deferred, remaining):
    """Give deferred tasks capacity from the free pool first, then steal from
    over-provisioned groups along the cheapest links.

    When the graph carries observed telemetry (simulator feedback — see
    ``sim.evaluate.observed_telemetry``), candidates are ranked by their
    persistent slowdown *before* link cost: a repaired pipeline group should
    absorb healthy machines, not the 3x stragglers the labels just evicted.
    Without telemetry the ranking reduces to the historical latency-only
    key, so analytic-mode assignments are bit-identical to before."""
    lat = graph.latency.copy()
    lat[lat <= 0] = np.inf
    mem = graph.memory_gb()
    slow = (graph.telemetry.slowdown if graph.telemetry is not None
            else np.ones(graph.n, np.float32))
    by_name = {t.name: t for t in tasks}
    still_deferred = []

    def steal_key(got):
        return lambda i: (float(slow[i]),
                          min((lat[i, j] for j in got), default=0.0))

    for name in deferred:
        task = by_name[name]
        got = list(groups.get(name, []))
        need = task.min_memory_gb - _mem(graph, got)
        # free pool first
        while need > 0 and remaining:
            pick = (min(remaining, key=steal_key(got))
                    if got else min(remaining, key=lambda i: float(slow[i])))
            got.append(pick)
            remaining.remove(pick)
            need -= mem[pick]
        # steal from surpluses
        if need > 0:
            for other, ids in sorted(groups.items(),
                                     key=lambda kv: -_mem(graph, kv[1])):
                if other == name:
                    continue
                surplus = _mem(graph, ids) - by_name[other].min_memory_gb
                while need > 0 and surplus > 0 and len(ids) > 1:
                    pick = min(ids, key=steal_key(got))
                    if surplus - mem[pick] < 0:
                        break
                    ids.remove(pick)
                    got.append(pick)
                    surplus -= mem[pick]
                    need -= mem[pick]
                if need <= 0:
                    break
        if need <= 0 and got:
            groups[name] = sorted(got)
        else:
            rem_set = set(remaining)
            remaining.extend(i for i in got if i not in rem_set)
            still_deferred.append(name)
    return groups, still_deferred, remaining


# ---------------------------------------------------------------------------
# Replan-delta costing: what does it take to move from one assignment to
# another? A mid-run re-plan is not free — every machine that *joins* a
# task's group must pull that task's state before it can contribute. The
# delta below is the pure set computation; the live controller prices each
# move through the simulator's NetworkModel (which sees fault overlays).
# ---------------------------------------------------------------------------
def plan_delta(old_groups: dict[str, Sequence[int]],
               new_groups: dict[str, Sequence[int]]) -> dict[str, dict]:
    """Per-task membership delta between two assignments.

    Returns ``{task: {"joined": [...], "left": [...], "kept": [...]}}`` for
    every task whose group changed (tasks with identical membership are
    omitted — a no-op replan has an empty delta)."""
    delta: dict[str, dict] = {}
    for name in sorted(set(old_groups) | set(new_groups)):
        old = set(old_groups.get(name, ()))
        new = set(new_groups.get(name, ()))
        if old == new:
            continue
        delta[name] = {"joined": sorted(new - old), "left": sorted(old - new),
                       "kept": sorted(old & new)}
    return delta


def migration_moves(old_groups: dict[str, Sequence[int]],
                    new_groups: dict[str, Sequence[int]],
                    tasks: Sequence[cm.ModelTask],
                    strategies: Optional[dict[str, str]] = None
                    ) -> list[tuple]:
    """State transfers needed to realize ``new_groups`` from ``old_groups``:
    one ``(task, src, dst, nbytes)`` per joining machine, pulling the task's
    parameters from a retained old member. Sources are candidate lists —
    every old member holds the state, so the caller picks the cheapest under
    its network view.

    ``strategies`` (task name -> parallelism strategy) refines the byte
    count: a ``gpipe``/``tp`` joiner hosts one shard of the model, so it
    pulls ``param_bytes / len(new_group)``; a ``dp`` joiner replicates and
    pulls the full blob. Without it every move is priced at the full
    ``param_bytes`` (the conservative historical costing).

    A task with no surviving old member restarts from the checkpoint store
    instead; that costs a restart (priced by the controller's margin), not a
    peer transfer, so it contributes no move here."""
    by_name = {t.name: t for t in tasks}
    moves: list[tuple] = []
    for name, d in plan_delta(old_groups, new_groups).items():
        task = by_name.get(name)
        if task is None or not d["joined"]:
            continue
        srcs = d["kept"] or d["left"]
        if not srcs:
            continue
        nbytes = float(task.param_bytes)
        strategy = (strategies or {}).get(name)
        if strategy in ("gpipe", "tp"):
            nbytes /= max(1, len(new_groups.get(name, ())))
        for dst in d["joined"]:
            moves.append((name, list(srcs), dst, nbytes))
    return moves


# ---------------------------------------------------------------------------
# Disaster recovery (paper §1.1): machines fail mid-training; because the
# GNN assignment records exactly which tasks each machine serves, only the
# affected groups are re-planned.
# ---------------------------------------------------------------------------
def replan_with_deferral(graph: ClusterGraph,
                         tasks: Sequence[cm.ModelTask],
                         params, cfg: gnn.GNNConfig) -> Assignment:
    """Full re-plan that degrades instead of raising: when the fleet no
    longer meets the aggregate requirement of every task, the largest tasks
    move to ``deferred`` (waiting for capacity — ``on_join`` re-plans the
    moment a machine returns) until the remainder fits. A failure landing
    while the fleet is capacity-starved must shrink the plan, never crash
    the control plane."""
    keep = sorted(tasks, key=lambda t: -t.params)
    dropped: list[str] = []
    while keep and not check_capacity(graph, keep):
        dropped.append(keep.pop(0).name)
    if not keep:
        return Assignment(groups={}, deferred=[t.name for t in tasks],
                          stage_order={})
    sub_tasks = [t for t in tasks if t.name not in dropped]
    a = task_assignments(graph, sub_tasks, params, cfg)
    return Assignment(groups=a.groups, deferred=a.deferred + dropped,
                      stage_order=a.stage_order)


def recover(graph: ClusterGraph, assignment: Assignment,
            failed: Sequence[int], tasks: Sequence[cm.ModelTask],
            params, cfg: gnn.GNNConfig) -> tuple[ClusterGraph, Assignment]:
    failed = set(failed)
    by_name = {t.name: t for t in tasks}
    survivors = graph.remove_machines(sorted(failed))
    # old-id -> new-id map
    keep = [i for i in range(graph.n) if i not in failed]
    remap = {old: new for new, old in enumerate(keep)}

    affected = [name for name, ids in assignment.groups.items()
                if any(i in failed for i in ids)]
    groups = {name: sorted(remap[i] for i in ids if i not in failed)
              for name, ids in assignment.groups.items()}

    ok = {}
    redo_tasks = []
    for name, ids in groups.items():
        if name in affected and _mem(survivors, ids) < by_name[name].min_memory_gb:
            redo_tasks.append(by_name[name])
        else:
            ok[name] = ids
    if redo_tasks:
        used = set(i for ids in ok.values() for i in ids)
        pool = [i for i in range(survivors.n) if i not in used]
        sub = survivors.subgraph(pool) if pool else None
        if sub is None or not check_capacity(sub, redo_tasks):
            # not enough spare capacity: re-plan everything on the
            # survivors, deferring the largest tasks if even that is short
            return survivors, replan_with_deferral(survivors, tasks,
                                                   params, cfg)
        sub_assign = task_assignments(sub, redo_tasks, params, cfg)
        for name, ids in sub_assign.groups.items():
            ok[name] = sorted(pool[k] for k in ids)
    stage_order = {name: cm.greedy_chain_order(survivors, ids)
                   for name, ids in ok.items()}
    deferred = [t.name for t in tasks if t.name not in ok]
    return survivors, Assignment(groups=ok, deferred=deferred,
                                 stage_order=stage_order)
