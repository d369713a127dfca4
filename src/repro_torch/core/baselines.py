"""The paper's comparison systems (§6.4) and the Hulk pipeline end-to-end.
Port of ``repro/core/baselines.py``.

System A — data parallelism over every machine that fits the whole model.
System B — one GPipe chain across all machines.
System C — Megatron-style tensor parallelism across all machines.
Hulk     — GNN task assignment -> disjoint groups -> GPipe inside each group.

Multi-task semantics: A/B/C occupy the whole fleet, so tasks run back-to-back
(sum of times); Hulk runs tasks concurrently on disjoint groups (makespan =
max). Figures 8/10 report per-model communication and computation time.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core import assign as assign_mod
from repro_torch.core import cost_model as cm
from repro_torch.core import gnn
from repro_torch.core.graph import ClusterGraph


def _per_task_full_cluster(graph: ClusterGraph, tasks, comm, strategy):
    ids = list(range(graph.n))
    per_task = {}
    for t in tasks:
        c, p = cm.group_step_time(graph, ids, t, comm, strategy)
        per_task[t.name] = (c, p)
    return per_task


def system_a(graph: ClusterGraph, tasks: Sequence[cm.ModelTask], comm) -> dict:
    per_task = _per_task_full_cluster(graph, tasks, comm, "dp")
    return _totals("SystemA", per_task, concurrent=False)


def system_b(graph: ClusterGraph, tasks: Sequence[cm.ModelTask], comm) -> dict:
    per_task = _per_task_full_cluster(graph, tasks, comm, "gpipe")
    return _totals("SystemB", per_task, concurrent=False)


def system_c(graph: ClusterGraph, tasks: Sequence[cm.ModelTask], comm) -> dict:
    per_task = _per_task_full_cluster(graph, tasks, comm, "tp")
    return _totals("SystemC", per_task, concurrent=False)


def hulk(graph: ClusterGraph, tasks: Sequence[cm.ModelTask], params,
         cfg: gnn.GNNConfig, comm) -> dict:
    assignment = assign_mod.task_assignments(graph, tasks, params, cfg)
    per_task = {}
    for t in tasks:
        ids = assignment.groups.get(t.name)
        if not ids:
            per_task[t.name] = (np.inf, np.inf)
            continue
        order = assignment.stage_order[t.name]
        per_task[t.name] = cm.gpipe_time(graph, ids, t, comm, order)
    out = _totals("Hulk", per_task, concurrent=True)
    out["assignment"] = assignment
    return out


def _totals(name: str, per_task: dict, concurrent: bool) -> dict:
    comm_sum = sum(c for c, _ in per_task.values())
    compute_sum = sum(p for _, p in per_task.values())
    if concurrent:
        total = max((c + p) for c, p in per_task.values()) if per_task else np.inf
    else:
        total = comm_sum + compute_sum
    return {"system": name, "per_task": per_task, "comm": comm_sum,
            "compute": compute_sum, "total": total}


def compare_all(graph: ClusterGraph, tasks: Sequence[cm.ModelTask], params,
                cfg: gnn.GNNConfig, comm_model: str = "paper") -> dict:
    comm = cm.make_comm(graph, comm_model)
    rows = {
        "Hulk": hulk(graph, tasks, params, cfg, comm),
        "SystemA": system_a(graph, tasks, comm),
        "SystemB": system_b(graph, tasks, comm),
        "SystemC": system_c(graph, tasks, comm),
    }
    best_baseline = min(v["total"] for k, v in rows.items() if k != "Hulk")
    hulk_total = rows["Hulk"]["total"]
    rows["improvement_vs_best_baseline"] = (
        (best_baseline - hulk_total) / best_baseline if np.isfinite(best_baseline)
        else np.nan)
    return rows
