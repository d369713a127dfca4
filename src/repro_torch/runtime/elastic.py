"""Elastic runtime: Hulk disaster recovery + elastic scaling as a state
machine over (fleet graph, assignment, checkpoint).

Paper SS1.1: "in the event of a machine failure, the system can quickly
recover the entire computation" because the GNN assignment records exactly
which tasks each machine serves. Paper SS5.2: machines join by adding a node
+ latency edges; leave by dropping edges.

The runtime wraps that loop:
  on_failure(ids)  -> survivors graph, re-run Hulk assignment on the
                      affected groups only (core.assign.recover), remap the
                      surviving machines' roles, restore task state from the
                      last committed checkpoint (training replays
                      deterministically from there — data.synthetic is a
                      pure function of step).
  on_join(machine) -> extend the graph, re-assign only if a task is deferred
                      (capacity-starved) or the cost model predicts >10%
                      makespan win (avoids churn; straggler mitigation).

This is control-plane logic: pure Python over the graph + cost model. The
only device work is the GNN forward inside ``core.assign``, which runs
wherever ``params`` lie (a CUDA device unless the caller made them on the
CPU). Port of ``repro/runtime/elastic.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core import assign as assign_mod
from repro_torch.core import cost_model as cm
from repro_torch.core import gnn
from repro_torch.core.graph import ClusterGraph, Machine


@dataclasses.dataclass
class FailureEvent:
    failed_ids: list[int]
    at_step: int


@dataclasses.dataclass
class _State:
    graph: ClusterGraph
    assignment: assign_mod.Assignment
    epoch: int = 0          # bumps on every re-placement


class ElasticRuntime:
    def __init__(self, graph: ClusterGraph, tasks: Sequence[cm.ModelTask],
                 params, cfg: gnn.GNNConfig,
                 rebalance_threshold: float = 0.10):
        self.tasks = list(tasks)
        self.params = params
        self.cfg = cfg
        self.rebalance_threshold = rebalance_threshold
        assignment = assign_mod.task_assignments(graph, tasks, params, cfg)
        self.state = _State(graph=graph, assignment=assignment)
        self.log: list[dict] = [{"event": "init",
                                 "groups": dict(assignment.groups)}]

    # -- queries --------------------------------------------------------------
    @property
    def graph(self) -> ClusterGraph:
        return self.state.graph

    @property
    def assignment(self) -> assign_mod.Assignment:
        return self.state.assignment

    def makespan(self, comm_model: str = "paper") -> float:
        comm = cm.make_comm(self.graph, comm_model)
        res = cm.placement_makespan(self.graph, self.assignment.groups,
                                    self.tasks, comm)
        return res["makespan"]

    def group_of(self, task_name: str) -> list[int]:
        return self.assignment.groups.get(task_name, [])

    def commit_assignment(self, assignment: assign_mod.Assignment,
                          graph: Optional[ClusterGraph] = None,
                          reason: str = "refine") -> None:
        """Install an externally produced assignment (e.g. the simulator-in-
        the-loop polish of ``sim.evaluate.HulkPlacer``) — and optionally a
        graph with refreshed observed telemetry — through the runtime's own
        state transition: the epoch bumps and the change is logged, so
        consumers of ``log``/``epoch`` never see a placement that was
        silently swapped underneath them."""
        self.state = _State(graph=graph if graph is not None else self.graph,
                            assignment=assignment,
                            epoch=self.state.epoch + 1)
        self.log.append({"event": reason, "groups": dict(assignment.groups),
                         "deferred": list(assignment.deferred),
                         "epoch": self.state.epoch})

    # -- events ---------------------------------------------------------------
    def on_failure(self, event: FailureEvent) -> dict:
        """Drop failed machines, re-plan affected tasks only. Returns a
        recovery report: which tasks moved, which restore from checkpoint."""
        old_groups = {k: list(v) for k, v in self.assignment.groups.items()}
        graph, assignment = assign_mod.recover(
            self.graph, self.assignment, event.failed_ids, self.tasks,
            self.params, self.cfg)
        self.state = _State(graph=graph, assignment=assignment,
                            epoch=self.state.epoch + 1)
        affected = [name for name, ids in old_groups.items()
                    if any(i in set(event.failed_ids) for i in ids)]
        report = {
            "event": "failure",
            "at_step": event.at_step,
            "failed": list(event.failed_ids),
            "affected_tasks": affected,
            "restore_from_checkpoint": affected,   # others keep running
            "deferred": list(assignment.deferred),
            "epoch": self.state.epoch,
        }
        self.log.append(report)
        return report

    def on_join(self, machine: Machine,
                latencies: Optional[dict[int, float]] = None) -> dict:
        """Paper SS5.2 scalability: add the node; re-assign only when it
        helps (a deferred task exists or predicted makespan drops >thresh)."""
        graph = self.graph.add_machine(machine, latencies)
        rebalanced = False
        if self.assignment.deferred:
            assignment = assign_mod.task_assignments(
                graph, self.tasks, self.params, self.cfg)
            rebalanced = True
        else:
            old = self.makespan()
            cand = assign_mod.task_assignments(graph, self.tasks, self.params,
                                               self.cfg)
            comm = cm.make_comm(graph)
            new = cm.placement_makespan(graph, cand.groups, self.tasks,
                                        comm)["makespan"]
            if np.isfinite(old) and new < old * (1 - self.rebalance_threshold):
                assignment = cand
                rebalanced = True
            else:
                assignment = self.assignment  # new node idles in the spare pool
        self.state = _State(graph=graph, assignment=assignment,
                            epoch=self.state.epoch + (1 if rebalanced else 0))
        report = {"event": "join", "rebalanced": rebalanced,
                  "node_id": graph.n - 1, "epoch": self.state.epoch}
        self.log.append(report)
        return report

    def on_leave(self, ids: Sequence[int], at_step: int = 0) -> dict:
        """Planned removal (scalability) — same path as failure but logged
        differently (no checkpoint restore needed: state is drained first)."""
        report = self.on_failure(FailureEvent(list(ids), at_step))
        report["event"] = "leave"
        report["restore_from_checkpoint"] = []
        return report
