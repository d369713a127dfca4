"""Oracle labelers: cost-model- and simulator-guided partitions used as
sparse supervision.

The paper trains its GCN on sparsely labeled subgraphs (§3: "we then sparsely
label this subgraph to enable the neural network to learn the contents of the
graph in a supervised manner"). The labels come from the operators' own
placements; we regenerate them with a greedy + local-search partitioner that
minimizes the cost-model makespan under Algorithm 1's memory thresholds.

Label provenance — two supervision sources
------------------------------------------
* **Analytic** (``oracle_labels``, the default everywhere): minimize the
  closed-form ``core.cost_model`` makespan. Deterministic, cheap, and
  exactly what the paper describes — but *straggler-blind*: the analytic
  model prices every machine at its catalog TFLOP/s.
* **Sim-refined** (``sim_refined_labels``): start from the analytic
  partition, then local-search on the makespan *simulated* by ``repro.sim``
  (fast data plane) under a scenario's straggler / jitter / contention
  config. The simulator observes persistent slowdowns, per-op jitter, and
  relay-hub contention that the closed form cannot see, so these labels
  learn to route work around measured-slow resources. Selected via
  ``core.train.make_dataset(label_mode="sim")``; datasets built this way
  pair the labels with v2 (telemetry-carrying) node features so the GNN
  can actually observe the signal the labels respond to.

The production entry points (``greedy_partition`` / ``local_search`` /
``sim_local_search``) are optimized so ``core.train.make_dataset`` stops
being the dominant cost at scale: the greedy grower keeps an incremental
min-latency-to-group row (one ``np.minimum`` per accepted node instead of a
Python min over the group x pool product), the analytic local search caches
per-group step times and re-costs only the two groups a move touches, and
the sim-driven local search memoizes simulated makespans per visited
labeling (the simulator is deterministic, so a revisited state never
re-simulates). All produce bit-identical labels to the readable
``*_reference`` implementations kept below (asserted in
tests/test_fast_path.py and tests/test_sim_labels.py).

Port of ``repro/core/labels.py``: a numpy copy that gives the reference's
labels bit for bit, the simulated ones included (the port's ``sim`` package
is itself a copy of the reference's).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch import obs as obs_mod
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


# ---------------------------------------------------------------------------
# Simulator-in-the-loop labels (the ROADMAP "feeding back" loop): candidate
# partitions are scored by the discrete-event simulator instead of the
# closed-form cost model, so the labels see stragglers, jitter, and link
# contention. Imports of repro.sim stay inside the functions — core must not
# depend on sim at import time (sim imports core).
# ---------------------------------------------------------------------------
def simulated_makespan(graph: ClusterGraph, labels: np.ndarray,
                       tasks: Sequence[cm.ModelTask], *, jitter=None,
                       traffic=None, comm_model: str = "alphabeta",
                       seed: int = 0, steps: int = 1) -> float:
    """Makespan of the partition ``labels`` as measured by ``repro.sim``:
    every task runs concurrently as a GPipe chain over its group while the
    scenario's jitter / straggler / traffic config is active. ``np.inf``
    for infeasible partitions (empty or memory-short groups).

    GPipe is the labeling objective by convention, mirroring the analytic
    oracle's ``_group_cost`` (which also scores groups as gpipe chains):
    labels rank *partitions*, while the per-group parallelism strategy is
    chosen later by ``core.placement.plan_runtime``. Deterministic in
    ``seed``."""
    from repro_torch.sim.evaluate import FleetSimulation, Placement, StaticPlacer

    placements = {}
    for ti, task in enumerate(tasks):
        ids = [int(j) for j in np.flatnonzero(labels == ti)]
        if not ids:
            return np.inf
        order = cm.greedy_chain_order(graph, ids)
        placements[task.name] = Placement(ids, "gpipe", order)
    fs = FleetSimulation(graph, list(tasks), StaticPlacer(placements),
                         comm_model=comm_model, jitter=jitter,
                         traffic=traffic, steps=steps, seed=seed,
                         concurrent=True)
    return float(fs.run().makespan)


def _observed_slowdowns(graph: ClusterGraph, jitter, seed: int) -> np.ndarray:
    """Persistent per-machine slowdown multipliers the simulator would
    observe (pure function of (graph, jitter, seed) — the same draw the
    simulation itself uses)."""
    from repro_torch.sim.compute import ComputeModel
    return ComputeModel(graph, jitter, seed=seed).slow_factor


def sim_local_search(graph: ClusterGraph, labels: np.ndarray,
                     tasks: Sequence[cm.ModelTask], *, iters: int = 40,
                     seed: int = 0, jitter=None, traffic=None,
                     comm_model: str = "alphabeta", steps: int = 1,
                     sweep: bool = True) -> np.ndarray:
    """Local search on *simulated* makespan (production path).

    Two phases, both deterministic in ``seed``:

    1. a targeted sweep over machines in descending observed-slowdown order,
       trying each alternative class (idle first) — this is what moves a
       3x straggler out of a pipeline's critical path;
    2. ``iters`` random single-node moves, the same proposal distribution as
       the analytic ``local_search``.

    Simulated makespans are memoized per visited labeling (the simulator is
    deterministic), so revisited states cost a dict lookup instead of a
    simulation. Bit-identical to ``sim_local_search_reference`` (asserted
    in tests/test_sim_labels.py).
    """
    rng = np.random.default_rng(seed)
    labels = labels.copy()
    mem = graph.memory_gb()
    idle = idle_class(tasks)
    cache: dict[bytes, float] = {}
    rec = obs_mod.current()
    metrics = rec.metrics  # counting only — never steers the search

    def cost(lab: np.ndarray) -> float:
        key = lab.tobytes()
        hit = cache.get(key)
        if hit is None:
            metrics.inc("plan.sim_search.sims")
            hit = cache[key] = simulated_makespan(
                graph, lab, tasks, jitter=jitter, traffic=traffic,
                comm_model=comm_model, seed=seed, steps=steps)
        return hit

    def donor_ok(i: int, old: int) -> bool:
        if old == idle:
            return True
        donor_ids = np.flatnonzero(labels == old)
        donor_mem = sum(mem[j] for j in donor_ids if j != i)
        return donor_mem >= tasks[old].min_memory_gb

    cur = cost(labels)
    if sweep:
        slow = _observed_slowdowns(graph, jitter, seed)
        order = sorted(range(graph.n), key=lambda i: (-slow[i], i))
        for i in order:
            old = int(labels[i])
            # idle first: evicting a straggler beats reassigning it
            for new in [idle] + [t for t in range(len(tasks)) if t != old]:
                if new == old or not donor_ok(i, old):
                    continue
                metrics.inc("plan.sim_search.proposals")
                labels[i] = new
                nxt = cost(labels)
                if nxt < cur:
                    cur = nxt
                    old = new
                    metrics.inc("plan.sim_search.accepts")
                else:
                    labels[i] = old
    for _ in range(iters):
        i = int(rng.integers(0, graph.n))
        old = int(labels[i])
        new = int(rng.integers(0, len(tasks) + 1))  # idle allowed
        if new == old or not donor_ok(i, old):
            continue
        metrics.inc("plan.sim_search.proposals")
        labels[i] = new
        nxt = cost(labels)
        if nxt < cur:
            cur = nxt
            metrics.inc("plan.sim_search.accepts")
        else:
            labels[i] = old
    if rec.enabled:
        rec.metrics.gauge("plan.sim_search.makespan_s", cur)
    return labels


def sim_refined_labels(graph: ClusterGraph, tasks: Sequence[cm.ModelTask],
                       comm=None, seed: int = 0, refine_iters: int = 150, *,
                       jitter=None, traffic=None,
                       comm_model: str = "alphabeta", sim_iters: int = 40,
                       sim_steps: int = 1) -> np.ndarray:
    """Sim-refined oracle labels: the analytic ``oracle_labels`` partition,
    then ``sim_local_search`` on simulated makespan under the scenario's
    jitter / traffic config. This is ``make_dataset(label_mode="sim")``'s
    labeler — the analytic labeler stays the default everywhere else."""
    lab = oracle_labels(graph, tasks, comm, seed, refine_iters)
    return sim_local_search(graph, lab, tasks, iters=sim_iters, seed=seed,
                            jitter=jitter, traffic=traffic,
                            comm_model=comm_model, steps=sim_steps)


def sparse_mask(n: int, frac: float = 0.6, seed: int = 0) -> np.ndarray:
    """Sparse supervision mask (paper §3)."""
    rng = np.random.default_rng(seed)
    mask = (rng.uniform(size=n) < frac).astype(np.float32)
    if mask.sum() == 0:
        mask[0] = 1.0
    return mask


# ---------------------------------------------------------------------------
# Readable reference implementations (the pre-vectorization Python loops).
# The equivalence tests assert the fast paths reproduce these bit-identically;
# benchmarks/plan_bench.py times them as the labeler's "before" numbers.
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


def sim_local_search_reference(graph: ClusterGraph, labels: np.ndarray,
                               tasks: Sequence[cm.ModelTask], *,
                               iters: int = 40, seed: int = 0, jitter=None,
                               traffic=None, comm_model: str = "alphabeta",
                               steps: int = 1,
                               sweep: bool = True) -> np.ndarray:
    """The readable sim-driven local search: every candidate labeling is
    re-simulated from scratch, no memoization. Same proposal sequence as
    ``sim_local_search`` (the simulator is deterministic, so caching cannot
    change any accept/reject decision) — bit-identical outputs asserted in
    tests/test_sim_labels.py."""
    rng = np.random.default_rng(seed)
    labels = labels.copy()
    mem = graph.memory_gb()
    idle = idle_class(tasks)

    def cost(lab):
        return simulated_makespan(graph, lab, tasks, jitter=jitter,
                                  traffic=traffic, comm_model=comm_model,
                                  seed=seed, steps=steps)

    def donor_ok(i, old):
        if old == idle:
            return True
        donor_ids = [j for j in range(graph.n) if labels[j] == old and j != i]
        return sum(mem[j] for j in donor_ids) >= tasks[old].min_memory_gb

    cur = cost(labels)
    if sweep:
        slow = _observed_slowdowns(graph, jitter, seed)
        order = sorted(range(graph.n), key=lambda i: (-slow[i], i))
        for i in order:
            old = int(labels[i])
            for new in [idle] + [t for t in range(len(tasks)) if t != old]:
                if new == old or not donor_ok(i, old):
                    continue
                labels[i] = new
                nxt = cost(labels)
                if nxt < cur:
                    cur = nxt
                    old = new
                else:
                    labels[i] = old
    for _ in range(iters):
        i = int(rng.integers(0, graph.n))
        old = int(labels[i])
        new = int(rng.integers(0, len(tasks) + 1))
        if new == old or not donor_ok(i, old):
            continue
        labels[i] = new
        nxt = cost(labels)
        if nxt < cur:
            cur = nxt
        else:
            labels[i] = old
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
