"""Bridge from Hulk's graph-level assignment to a pod-level runtime plan
(numpy copy of ``repro.core.placement``).

Hulk's groups/stage orders become mesh-axis decisions for the runtime:

* For a geo fleet of TPU *pods* (region == pod), the group of a task maps to a
  set of pods; the cost model then decides which parallelism rides the slow
  inter-pod axis — pure DP (2 x P bytes/step) vs pipeline activations
  (2 x microbatches x act bytes/step) — the Hulk insight applied to the
  production mesh.
* Inside a pod everything is fast ICI: tensor parallel + FSDP as configured.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core import cost_model as cm
from repro_torch.core.graph import ClusterGraph, Machine


@dataclasses.dataclass(frozen=True)
class PodSpec:
    """One TPU pod (the geo node at production scale)."""
    name: str
    region: str
    chips: int = 256
    tflops_per_chip: float = 197.0   # v5e bf16
    hbm_gb_per_chip: float = 16.0


def pods_as_graph(pods: Sequence[PodSpec],
                  latency_ms: np.ndarray) -> ClusterGraph:
    """Represent pods as Hulk graph nodes. Capability ~ tflops/chip scaled to
    the paper's 0-10ish feature range; memory = total HBM."""
    machines = [
        Machine.from_caps(
            p.region,
            capability=min(10.0, p.tflops_per_chip / 30.0),
            memory_gb=p.hbm_gb_per_chip * p.chips,
            tflops=p.tflops_per_chip * p.chips,
            label=p.name)
        for p in pods
    ]
    return ClusterGraph(machines, latency_ms.astype(np.float32))


@dataclasses.dataclass
class RuntimePlacement:
    task: str
    pods: list[int]                 # pod indices serving this task
    pod_axis_strategy: str          # "dp" | "pipeline"
    stage_order: list[int]          # pipeline order if strategy == "pipeline"
    est_cross_pod_bytes_per_step: float


def choose_pod_strategy(task: cm.ModelTask, n_pods: int) -> tuple[str, float]:
    """Compare cross-pod traffic of DP gradient sync vs pipeline activations.
    Returns (strategy, bytes/step) — the smaller one wins (Hulk's objective:
    minimize traffic on the slowest links)."""
    if n_pods <= 1:
        return "dp", 0.0
    dp_bytes = 2.0 * task.param_bytes * (n_pods - 1) / n_pods  # ring all-reduce
    pp_bytes = 2.0 * task.microbatches * task.act_bytes_per_microbatch \
        * (n_pods - 1)
    return ("dp", dp_bytes) if dp_bytes <= pp_bytes else ("pipeline", pp_bytes)


def plan_runtime(graph: ClusterGraph, groups: dict[str, list[int]],
                 tasks: Sequence[cm.ModelTask]) -> list[RuntimePlacement]:
    by_name = {t.name: t for t in tasks}
    out = []
    for name, pod_ids in groups.items():
        task = by_name[name]
        strat, nbytes = choose_pod_strategy(task, len(pod_ids))
        order = cm.greedy_chain_order(graph, pod_ids) if strat == "pipeline" \
            else list(pod_ids)
        out.append(RuntimePlacement(task=name, pods=list(pod_ids),
                                    pod_axis_strategy=strat, stage_order=order,
                                    est_cross_pod_bytes_per_step=nbytes))
    return out
