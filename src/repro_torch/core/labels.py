"""Oracle labelers: cost-model-guided partitions used as sparse supervision
(port of ``repro.core.labels``, analytic half).

The paper trains its GCN on sparsely labeled subgraphs (§3: "we then sparsely
label this subgraph to enable the neural network to learn the contents of the
graph in a supervised manner"). The labels come from the operators' own
placements; we regenerate them with a greedy + local-search partitioner that
minimizes the closed-form ``core.cost_model`` makespan under Algorithm 1's
memory thresholds.

This is a numpy copy of the reference's analytic labeler and gives
bit-identical labels. The simulator-refined labels (``sim_refined_labels``,
``sim_local_search`` and its reference twin) need the simulator, which is not
ported yet.

The production entry points (``greedy_partition`` / ``local_search``) keep an
incremental min-latency-to-group row and cache per-group step times; both
produce bit-identical labels to the readable ``*_reference``
implementations kept below.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core import cost_model as cm
from repro_torch.core.graph import ClusterGraph

def _group_cost(graph: ClusterGraph, ids: list[int], task: cm.ModelTask,
                comm) -> float:
    if not ids:
        return np.inf
    c, p = cm.group_step_time(graph, ids, task, comm, "gpipe")
    return c + p


def idle_class(tasks: Sequence[cm.ModelTask]) -> int:
    """Nodes the placement leaves unused (paper Table 2 assigns 39 of 46
    machines; the rest idle / serve as the disaster-recovery spare pool)."""
    return len(tasks)


def _blocked_inf_latency(graph: ClusterGraph) -> np.ndarray:
    lat = graph.latency.copy()
    lat[lat <= 0] = np.inf
    np.fill_diagonal(lat, np.inf)
    return lat


def greedy_partition(graph: ClusterGraph, tasks: Sequence[cm.ModelTask],
                     comm=None, seed: int = 0) -> np.ndarray:
    """Label every node with a task id or the idle class. Big tasks claim
    first; a group grows from a well-connected seed along the cheapest links
    until the memory threshold is met, then keeps absorbing nodes only while
    that lowers the group's estimated step time (comm + compute)."""
    comm = comm or cm.make_comm(graph)
    n = graph.n
    mem = graph.memory_gb()
    lat = _blocked_inf_latency(graph)

    order = sorted(range(len(tasks)), key=lambda i: -tasks[i].params)
    labels = np.full(n, idle_class(tasks), np.int64)
    free = np.ones(n, bool)

    for ti in order:
        task = tasks[ti]
        if not free.any():
            break
        pool = np.flatnonzero(free)
        if pool.size > 1:
            sub = lat[np.ix_(pool, pool)]
            seed_node = int(pool[int(np.argmin(sub.min(axis=1)))])
        else:
            seed_node = int(pool[0])
        group = [seed_node]
        free[seed_node] = False
        got_mem = mem[seed_node]
        # d[j] = min latency from the group to node j, updated incrementally.
        # The argmin is restricted to the free pool (never the full row):
        # with disconnected components every free node can sit at inf, and a
        # whole-row argmin would then grab an already-assigned node.
        d = lat[seed_node].copy()
        # phase 1: reach the memory threshold M_n
        while free.any() and got_mem < task.min_memory_gb:
            pool = np.flatnonzero(free)
            nxt = int(pool[int(np.argmin(d[pool]))])
            group.append(nxt)
            free[nxt] = False
            got_mem += mem[nxt]
            np.minimum(d, lat[nxt], out=d)
        # phase 2: absorb more nodes only while step time improves
        cur = _group_cost(graph, group, task, comm)
        while free.any():
            pool = np.flatnonzero(free)
            nxt = int(pool[int(np.argmin(d[pool]))])
            cand = _group_cost(graph, group + [nxt], task, comm)
            if cand >= cur:
                break
            group.append(nxt)
            free[nxt] = False
            np.minimum(d, lat[nxt], out=d)
            cur = cand
        labels[group] = ti
    return labels


def local_search(graph: ClusterGraph, labels: np.ndarray,
                 tasks: Sequence[cm.ModelTask], comm=None, iters: int = 200,
                 seed: int = 0) -> np.ndarray:
    """Single-node moves (including to/from idle) that reduce makespan while
    keeping every task group memory-feasible. A move only changes the donor
    and receiver groups, so only those two step times are recomputed; the
    rest come from the cached per-group costs."""
    comm = comm or cm.make_comm(graph)
    rng = np.random.default_rng(seed)
    labels = labels.copy()
    mem = graph.memory_gb()
    idle = idle_class(tasks)

    def ids_of(ti: int) -> list[int]:
        return [int(j) for j in np.flatnonzero(labels == ti)]

    cost = np.array([_group_cost(graph, ids_of(ti), task, comm)
                     for ti, task in enumerate(tasks)])
    cur = max(float(cost.max()), 0.0)

    for _ in range(iters):
        i = int(rng.integers(0, graph.n))
        old = int(labels[i])
        new = int(rng.integers(0, len(tasks) + 1))  # idle allowed
        if new == old:
            continue
        if old != idle:
            # accumulate exactly like the reference (sequential float32 sum
            # over ascending donor ids, i excluded): Machine overrides allow
            # fractional GB, where a differently-ordered sum could flip the
            # strict comparison and break bit-identity
            donor_ids = np.flatnonzero(labels == old)
            donor_mem = sum(mem[j] for j in donor_ids if j != i)
            if donor_mem < tasks[old].min_memory_gb:
                continue
        labels[i] = new
        trial = cost.copy()
        for ti in (old, new):
            if ti != idle:
                trial[ti] = _group_cost(graph, ids_of(ti), tasks[ti], comm)
        nxt = max(float(trial.max()), 0.0)
        if nxt < cur:
            cost, cur = trial, nxt
        else:
            labels[i] = old
    return labels


def oracle_labels(graph: ClusterGraph, tasks: Sequence[cm.ModelTask],
                  comm=None, seed: int = 0, refine_iters: int = 150) -> np.ndarray:
    comm = comm or cm.make_comm(graph)
    lab = greedy_partition(graph, tasks, comm, seed)
    if refine_iters:
        lab = local_search(graph, lab, tasks, comm, refine_iters, seed)
    return lab


def sparse_mask(n: int, frac: float = 0.6, seed: int = 0) -> np.ndarray:
    """Sparse supervision mask (paper §3)."""
    rng = np.random.default_rng(seed)
    mask = (rng.uniform(size=n) < frac).astype(np.float32)
    if mask.sum() == 0:
        mask[0] = 1.0
    return mask


# ---------------------------------------------------------------------------
# Readable reference implementations (the pre-vectorization Python loops).
# The equivalence tests assert the fast paths reproduce these bit-identically.
# ---------------------------------------------------------------------------
def greedy_partition_reference(graph: ClusterGraph,
                               tasks: Sequence[cm.ModelTask],
                               comm=None, seed: int = 0) -> np.ndarray:
    comm = comm or cm.make_comm(graph)
    n = graph.n
    mem = graph.memory_gb()
    lat = _blocked_inf_latency(graph)

    order = sorted(range(len(tasks)), key=lambda i: -tasks[i].params)
    labels = np.full(n, idle_class(tasks), np.int64)
    unassigned = set(range(n))

    for ti in order:
        task = tasks[ti]
        if not unassigned:
            break
        pool = sorted(unassigned)
        seed_node = min(pool, key=lambda i: np.min(lat[i, pool])
                        if len(pool) > 1 else 0.0)
        group = [seed_node]
        unassigned.remove(seed_node)
        got_mem = mem[seed_node]
        while unassigned and got_mem < task.min_memory_gb:
            pool = sorted(unassigned)
            nxt = min(pool, key=lambda j: min(lat[i, j] for i in group))
            group.append(nxt)
            unassigned.remove(nxt)
            got_mem += mem[nxt]
        cur = _group_cost(graph, group, task, comm)
        while unassigned:
            pool = sorted(unassigned)
            nxt = min(pool, key=lambda j: min(lat[i, j] for i in group))
            cand = _group_cost(graph, group + [nxt], task, comm)
            if cand >= cur:
                break
            group.append(nxt)
            unassigned.remove(nxt)
            cur = cand
        labels[group] = ti
    return labels


def local_search_reference(graph: ClusterGraph, labels: np.ndarray,
                           tasks: Sequence[cm.ModelTask], comm=None,
                           iters: int = 200, seed: int = 0) -> np.ndarray:
    comm = comm or cm.make_comm(graph)
    rng = np.random.default_rng(seed)
    labels = labels.copy()
    mem = graph.memory_gb()
    idle = idle_class(tasks)

    def makespan(lab):
        worst = 0.0
        for ti, task in enumerate(tasks):
            ids = [i for i in range(graph.n) if lab[i] == ti]
            worst = max(worst, _group_cost(graph, ids, task, comm))
        return worst

    cur = makespan(labels)
    for _ in range(iters):
        i = int(rng.integers(0, graph.n))
        old = int(labels[i])
        new = int(rng.integers(0, len(tasks) + 1))
        if new == old:
            continue
        if old != idle:
            donor_ids = [j for j in range(graph.n) if labels[j] == old and j != i]
            if sum(mem[j] for j in donor_ids) < tasks[old].min_memory_gb:
                continue
        labels[i] = new
        nxt = makespan(labels)
        if nxt < cur:
            cur = nxt
        else:
            labels[i] = old
    return labels
