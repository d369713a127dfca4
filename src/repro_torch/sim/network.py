"""Flow-level network model with per-link fair-share contention.

Each physical link (a machine pair with a direct latency edge) is a resource
with a bandwidth capacity; a transfer is a *flow* that occupies every link on
its route. Blocked pairs (latency 0 in the ``ClusterGraph``) relay through the
``core.cost_model.routed_latency`` shortest path, so relay hubs become shared
— and therefore contended — resources.

Rate assignment is the classic bottleneck approximation: a flow's rate is

    min( end-to-end cap,  min over links on its path of  cap_link / n_flows )

recomputed whenever a flow starts or finishes (and on periodic ticks when a
time-varying ``capacity_scale`` is installed, e.g. diurnal traffic).

Two interchangeable solvers compute those rates (``solver=`` ctor arg):

* ``"fast"`` (default) — the fleet-scale path. Per-link flow counts are
  maintained incrementally; a flow event only marks its own links *dirty*
  and defers ONE solve to the end of the current timestamp (a burst of N
  same-time arrivals triggers one solve, not N). The solve re-rates only
  flows sharing a dirty link, computing every fair share in a single
  vectorized pass over a CSR-style link-incidence layout
  (``np.minimum.reduceat`` over per-flow link shares). Since a flow's rate
  depends only on the per-link counts — never on other flows' rates — the
  dirty set is exact, not an approximation.
* ``"reference"`` — the original O(active flows x path length)-per-event
  Python loop, kept verbatim as ``_rebalance_reference``. Equivalence is
  asserted by tests (tests/test_fleet_fast_path.py) and by
  ``benchmarks/fleet_bench.py`` at fleet scale: same rates in exact
  arithmetic, completion times within float tolerance.

Topology work is vectorized too: routed distances and a next-hop matrix come
from one bulk scipy shortest-path call (no O(n^2) Python reconstruction);
concrete paths are reconstructed lazily per (src, dst) pair and cached; and
``add_machine`` does an incremental single-source update (one Dijkstra from
the joining node + a vectorized triangle relaxation) instead of the O(n^3)
all-pairs recompute — it runs on every autoscale join.

Calibration contract (asserted in tests): a *single* flow from i to j takes
exactly ``core.cost_model``'s communication time —

* ``comm_model="alphabeta"``: ``routed_lat_ms * 1e-3 + bytes / bw(routed)``,
  identical to ``AlphaBetaComm.time_s`` (zero-contention limit);
* ``comm_model="paper"``:     ``routed_lat_ms * 1e-3 * bytes / 64``,
  identical to ``PaperLinearComm.time_s``.

This holds because link capacities only decrease with latency, every link on
a route has latency <= the routed end-to-end latency, and a lone flow is
capped by the end-to-end term.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import math
from typing import Callable, Optional

import numpy as np

from repro_torch import obs as obs_mod
from repro_torch.core import cost_model as cm
from repro_torch.core.graph import ClusterGraph
from repro_torch.sim.engine import Event, Simulator

MS = 1e-3
# Rebalance-tick period (in sim seconds) when capacity_scale is time-varying;
# bounds how stale a fair-share rate can get between flow events.
TICK_S = 50.0

_NO_PRED = -9999  # scipy's "no predecessor" sentinel


def _shortest_paths(latency_ms: np.ndarray) -> tuple[np.ndarray, np.ndarray,
                                                     np.ndarray]:
    """(dist_ms, next_hop, pred) for every pair, all bulk ops.

    ``dist_ms`` uses the repo's 0-sentinel for unreachable pairs (and the
    diagonal); ``next_hop[i, j]`` is the first hop out of ``i`` on the
    shortest path to ``j`` (-1 when there is none), from which concrete
    paths are reconstructed lazily; ``pred`` is scipy's predecessor matrix.
    """
    from scipy.sparse.csgraph import shortest_path
    w = latency_ms.astype(np.float64).copy()
    w[w <= 0] = np.inf
    np.fill_diagonal(w, 0.0)
    dist, pred = shortest_path(w, method="D", directed=False,
                               return_predecessors=True)
    n = latency_ms.shape[0]
    nh = _next_hop_from_pred(pred)
    dist[~np.isfinite(dist)] = 0.0
    np.fill_diagonal(dist, 0.0)
    return dist, nh, pred


def _next_hop_from_pred(pred: np.ndarray) -> np.ndarray:
    """Vectorized predecessor-matrix -> next-hop-matrix conversion.

    Walks every (i, j) chain back toward i simultaneously: iterate
    ``nh <- pred[i, nh]`` until ``pred[i, nh] == i`` (so nh is i's first
    hop). Each sweep is one fancy-indexed gather; the number of sweeps is
    the hop diameter, which is tiny for latency-weighted WAN graphs.
    """
    n = pred.shape[0]
    rows = np.arange(n)[:, None]
    valid = pred != _NO_PRED                 # reachable, off-diagonal pairs
    nh = np.where(valid, np.broadcast_to(np.arange(n)[None, :], (n, n)), rows)
    for _ in range(n):
        par = pred[rows, nh]
        step = valid & (par != _NO_PRED) & (par != rows)
        if not step.any():
            break
        nh = np.where(step, par, nh)
    nh = np.where(valid, nh, -1)
    return nh.astype(np.int32)


def _first_hops_from(pred_u: np.ndarray, u: int) -> np.ndarray:
    """First hop out of ``u`` toward every node, from a single-source
    predecessor vector (same back-walk as ``_next_hop_from_pred``, 1-D)."""
    n = pred_u.shape[0]
    valid = pred_u != _NO_PRED
    s = np.where(valid, np.arange(n), u)
    for _ in range(n):
        par = pred_u[s]
        step = valid & (par != _NO_PRED) & (par != u)
        if not step.any():
            break
        s = np.where(step, par, s)
    s = np.where(valid, s, -1)
    s[u] = -1
    return s.astype(np.int32)


class UnreachableError(ValueError):
    """Transfer requested between machines with no route at all."""


@dataclasses.dataclass
class _Flow:
    fid: int
    src: int
    dst: int
    remaining: float                 # bytes left
    cap: float                       # end-to-end rate ceiling (bytes/s)
    links: tuple[tuple[int, int], ...]
    link_a: np.ndarray               # = [a for (a, b) in links], int64
    link_b: np.ndarray
    # Per-link capacities are bound at flow creation (plain floats for the
    # scalar path, an array for the vectorized one): a flow keeps its
    # capacities even if a node on its route is tombstoned mid-transfer.
    # Identical to reading the live table in every non-tombstone state —
    # add_machine never changes an existing pair's capacity.
    link_bw: tuple[float, ...]
    link_bw_arr: np.ndarray
    done_cb: Callable[[], None]
    rate: float = 0.0
    last_update: float = 0.0
    finish_ev: Optional[Event] = None


class NetworkModel:
    def __init__(self, graph: ClusterGraph, comm_model: str = "alphabeta",
                 capacity_scale: Optional[Callable[[int, float], float]] = None,
                 solver: str = "fast", obs=None):
        if comm_model not in ("alphabeta", "paper"):
            raise ValueError(f"unknown comm model {comm_model!r}")
        if solver not in ("fast", "reference"):
            raise ValueError(f"unknown solver {solver!r}")
        self._obs = obs if obs is not None else obs_mod.NULL
        self.graph = graph
        self.comm_model = comm_model
        self.capacity_scale = capacity_scale
        self.solver = solver
        self.tombstoned: set[int] = set()
        # named link-fault overlays (sim.faults): fault_id -> degradation
        self._link_faults: dict = {}
        # fault-plan runs park unreachable transfers for re-dispatch at heal
        # instead of raising; default (False) keeps the hard-error contract
        self.stall_unreachable = False
        self._stalled: list[tuple] = []
        self._route_cache: dict[tuple[int, int], tuple] = {}
        self._rebuild_topology(graph)
        self._active: dict[int, _Flow] = {}      # fid -> flow, insertion order
        self._fid = itertools.count()
        # fast-solver state: per-link membership + dirty tracking
        self._flows_on_link: dict[tuple[int, int], dict[int, _Flow]] = {}
        self._link_nflows = np.zeros(graph.n * graph.n, np.int64)
        self._dirty: set[tuple[int, int]] = set()
        self._dirty_all = False
        self._solve_ev: Optional[Event] = None
        self._tick_ev: Optional[Event] = None
        self.bytes_moved: float = 0.0
        self.n_solves: int = 0        # rebalance solves (both solvers)
        self._span_seq = 0            # trace-span ids (enabled mode only)

    # -- static queries ------------------------------------------------------
    def latency_s(self, i: int, j: int) -> float:
        """One-time propagation delay of a transfer (0 under the paper model,
        whose latency table already is a per-byte cost)."""
        if self.comm_model == "paper":
            return 0.0
        return float(self.routed_ms[i, j]) * MS

    def reachable(self, i: int, j: int) -> bool:
        return i == j or self.routed_ms[i, j] > 0

    def effective_latency(self) -> np.ndarray:
        """The graph's direct-link latency with live fault overlays applied
        (tombstones cut out, link cuts zeroed, inflation multiplied in) —
        what the re-planning controller hands the GNN/scorer so a rotted
        link is visible to placement, without baking overlays into the
        committed graph (re-applying them is ``_reapply_faults``'s job)."""
        return self._masked_latency().copy()

    def estimate_transfer_s(self, i: int, j: int, nbytes: float) -> float:
        """Zero-contention routed transfer-time estimate under the *current*
        topology: propagation latency plus bytes over end-to-end bandwidth —
        the exact time a lone flow realizes (the calibration contract), with
        active link-fault overlays and tombstones already folded into
        ``routed_ms``/``e2e_bw``. The re-planning controller prices a plan
        delta's migration traffic with this; ``inf`` means unreachable."""
        if i == j or nbytes <= 0:
            return 0.0
        if self.routed_ms[i, j] <= 0:
            return math.inf
        return self.latency_s(i, j) + float(nbytes) / float(self.e2e_bw[i, j])

    def relay_hubs(self) -> np.ndarray:
        """(n,) float mask of nodes that forward traffic for other pairs —
        i.e. appear as an intermediate hop on some routed shortest path
        (policy-blocked pairs relay through them, making them contended
        shared resources). This is the network half of the observed
        telemetry fed back into v2 node features.

        A node k is an intermediate hop iff ``next_hop[i, j] == k`` for some
        pair with ``k != j``: every interior node of a path is the first hop
        of its own suffix, so scanning the next-hop matrix finds them all.
        """
        n = self.graph.n
        nh = self._next_hop
        inner = (nh >= 0) & (nh != np.arange(n)[None, :])
        mask = np.zeros(n, np.float32)
        mask[np.unique(nh[inner])] = 1.0
        return mask

    def _route(self, i: int, j: int) -> Optional[tuple]:
        """(links, link_a, link_b, per-link bw) of the routed i->j path; None
        when unreachable. Reconstructed lazily from the next-hop matrix and
        cached — workloads reuse a small set of (src, dst) pairs heavily."""
        key = (i, j)
        hit = self._route_cache.get(key)
        if hit is not None:
            return hit
        if self.routed_ms[i, j] <= 0:
            return None
        path = [i]
        k = i
        nh = self._next_hop
        while k != j:
            k = int(nh[k, j])
            path.append(k)
        links = tuple(zip(path[:-1], path[1:]))
        arr = np.asarray(path, np.int64)
        bw = tuple(float(self.link_bw[a, b]) for a, b in links)
        out = (links, arr[:-1], arr[1:], bw, np.asarray(bw, np.float64))
        self._route_cache[key] = out
        return out

    # -- flow API ------------------------------------------------------------
    def transfer(self, sim: Simulator, i: int, j: int, nbytes: float,
                 done_cb: Callable[[], None]) -> None:
        """Move ``nbytes`` from i to j; ``done_cb`` fires at completion."""
        if i == j or nbytes <= 0:
            sim.schedule(0.0, done_cb)
            return
        route = self._route(i, j)
        if route is None:
            if self.stall_unreachable:
                # partitioned: park the transfer; a topology change (heal,
                # revive) re-dispatches it via _refault/_retry_stalled
                self._stalled.append((i, j, float(nbytes), done_cb))
                if self._obs.enabled:
                    self._obs.metrics.inc("net.transfers_stalled")
                return
            raise UnreachableError(f"no route between machines {i} and {j}")
        if self._obs.enabled:
            done_cb = self._traced_done(sim, i, j, nbytes, done_cb)
        self.bytes_moved += float(nbytes)
        # Links are full-duplex: each direction is its own resource, so the
        # two opposing hops of a 2-node all-reduce ring don't contend — which
        # keeps the zero-contention limit equal to the analytic model.
        links, link_a, link_b, link_bw, link_bw_arr = route
        flow = _Flow(fid=next(self._fid), src=i, dst=j,
                     remaining=float(nbytes), cap=float(self.e2e_bw[i, j]),
                     links=links, link_a=link_a, link_b=link_b,
                     link_bw=link_bw, link_bw_arr=link_bw_arr,
                     done_cb=done_cb)
        # latency phase first; the flow holds no link capacity while in flight
        sim.schedule(self.latency_s(i, j), self._start_flow, sim, flow)

    def _traced_done(self, sim: Simulator, i: int, j: int, nbytes: float,
                     done_cb: Callable[[], None]) -> Callable[[], None]:
        """Observability wrapper around a transfer's completion: an async
        span on the source machine's lane covering request -> completion
        (async, because a machine's outbound flows overlap) plus transfer
        counters. Built only when recording is enabled."""
        trace = self._obs.trace
        metrics = self._obs.metrics
        metrics.inc("net.transfers")
        metrics.observe("net.transfer_bytes", float(nbytes),
                        buckets=obs_mod.BYTES_BUCKETS)
        t0 = sim.now
        sid = self._span_seq
        self._span_seq = sid + 1

        def done() -> None:
            trace.async_span(f"machine/{i}", f"xfer->{j}", f"f{sid}", t0,
                             sim.now, cat="net",
                             args={"bytes": float(nbytes), "dst": j})
            metrics.observe("net.transfer_s", sim.now - t0)
            done_cb()
        return done

    def _start_flow(self, sim: Simulator, flow: _Flow) -> None:
        flow.last_update = sim.now
        self._active[flow.fid] = flow
        if self.solver == "fast":
            self._attach(flow)
            self._dirty.update(flow.links)
            self._request_solve(sim)
        else:
            self._rebalance_reference(sim)
        if self.capacity_scale is not None and self._tick_ev is None:
            self._tick_ev = sim.schedule(TICK_S, self._tick, sim)

    def _tick(self, sim: Simulator) -> None:
        self._tick_ev = None
        if self._active:
            if self.solver == "fast":
                self._dirty_all = True
                self._request_solve(sim)
            else:
                self._rebalance_reference(sim)
            self._tick_ev = sim.schedule(TICK_S, self._tick, sim)

    def _scale(self, node: int, t: float) -> float:
        if self.capacity_scale is None:
            return 1.0
        return max(0.05, float(self.capacity_scale(node, t)))

    def _finish_flow(self, sim: Simulator, flow: _Flow) -> None:
        flow.remaining = 0.0
        if self.solver == "fast":
            # the solve retires `flow` (its links are dirty, so it is in the
            # affected set) and re-rates exactly the flows it contended with
            self._dirty.update(flow.links)
            self._request_solve(sim)
        else:
            self._rebalance_reference(sim)

    # -- fast solver ---------------------------------------------------------
    def _attach(self, flow: _Flow) -> None:
        n = self.graph.n
        for l in flow.links:
            self._flows_on_link.setdefault(l, {})[flow.fid] = flow
            self._link_nflows[l[0] * n + l[1]] += 1

    def _detach(self, flow: _Flow) -> None:
        n = self.graph.n
        for l in flow.links:
            d = self._flows_on_link.get(l)
            if d is not None:
                d.pop(flow.fid, None)
                if not d:
                    del self._flows_on_link[l]
            self._link_nflows[l[0] * n + l[1]] -= 1

    def _request_solve(self, sim: Simulator) -> None:
        """Coalesce: all rebalance requests at one timestamp share ONE solve,
        scheduled zero-delay so it runs after every same-time flow event."""
        if self._obs.enabled:
            # requests vs solves = the coalescing ratio (N same-tick flow
            # events -> 1 solve); a per-call guard, zero-cost when disabled
            self._obs.metrics.inc("net.solver.solve_requests")
        if self._solve_ev is None:
            self._solve_ev = sim.schedule(0.0, self._solve, sim)

    def _solve(self, sim: Simulator) -> None:
        self._solve_ev = None
        self.n_solves += 1
        obs_on = self._obs.enabled
        if obs_on:
            n_dirty = (len(self._flows_on_link) if self._dirty_all
                       else len(self._dirty))
        now = sim.now
        # 1. affected set: flows sharing a dirty link (their fair share may
        #    have changed); everyone else keeps rate AND finish event.
        #    Time-varying capacity makes EVERY rate a function of `now`, so
        #    the dirty-set shortcut is only exact without a capacity_scale
        #    (the reference re-samples the scale at every event; match it).
        if self.capacity_scale is not None:
            self._dirty_all = True
        if self._dirty_all:
            queue = collections.deque(self._active.values())
            self._dirty_all = False
            self._dirty.clear()
        else:
            queue = collections.deque()
            for l in self._dirty:
                d = self._flows_on_link.get(l)
                if d:
                    queue.extend(d.values())
            self._dirty.clear()
        # 2. bank progress at the old rates; retire drained flows BEFORE
        #    computing shares (a retirement frees capacity, so its links'
        #    surviving flows join the affected set transitively)
        banked: set[int] = set()
        survivors: dict[int, _Flow] = {}
        finished: list[_Flow] = []
        while queue:
            f = queue.popleft()
            if f.fid in banked:
                continue
            banked.add(f.fid)
            f.remaining = max(0.0, f.remaining - f.rate * (now - f.last_update))
            f.last_update = now
            if f.remaining <= 1e-9:
                finished.append(f)
                del self._active[f.fid]
                if f.finish_ev is not None:
                    f.finish_ev.cancel()
                    f.finish_ev = None
                self._detach(f)
                for l in f.links:
                    d = self._flows_on_link.get(l)
                    if d:
                        queue.extend(d.values())
            else:
                survivors[f.fid] = f
        # 3. new rates for all affected survivors. Large affected sets go
        #    through one vectorized CSR pass; small ones use a scalar loop of
        #    the identical formula (the numpy set-up cost exceeds the work
        #    below a few dozen flows). Either way a flow whose rate did not
        #    change keeps its pending finish event.
        flows = list(survivors.values())
        if obs_on:
            old_rates = [f.rate for f in flows]
        if len(flows) >= 24:
            self._rate_vectorized(sim, flows, now)
        elif flows:
            self._rate_scalar(sim, flows, now)
        if obs_on:
            m = self._obs.metrics
            m.inc("net.solver.solves")
            m.inc("net.solver.affected_flows", len(flows))
            m.inc("net.solver.finished_flows", len(finished))
            m.inc("net.solver.rate_changes",
                  sum(1 for f, r in zip(flows, old_rates) if f.rate != r))
            # fraction of occupied links whose counts changed this solve —
            # how much re-rating work the dirty-set tracking avoided
            total_links = max(1, len(self._flows_on_link) + len(finished))
            m.observe("net.solver.dirty_link_fraction",
                      min(1.0, n_dirty / total_links))
            self._obs.trace.counter("net/flows", "active_flows",
                                    len(self._active))
        # completion callbacks only schedule new events, never mutate the
        # active set synchronously, so firing them last is safe
        finished.sort(key=lambda f: f.fid)
        for f in finished:
            f.done_cb()

    def _reschedule(self, sim: Simulator, f: _Flow, rate: float) -> None:
        if (rate == f.rate and f.finish_ev is not None
                and not f.finish_ev.cancelled):
            return  # unchanged rate: the pending finish stands
        f.rate = rate
        if f.finish_ev is not None:
            f.finish_ev.cancel()
        f.finish_ev = sim.schedule(f.remaining / rate, self._finish_flow,
                                   sim, f)

    def _rate_scalar(self, sim: Simulator, flows: list, now: float) -> None:
        on_link = self._flows_on_link
        scaled = self.capacity_scale is not None
        for f in flows:
            if scaled:
                rate = f.cap * min(self._scale(f.src, now),
                                   self._scale(f.dst, now))
                for (a, b), bw in zip(f.links, f.link_bw):
                    share = (bw
                             * min(self._scale(a, now), self._scale(b, now))
                             / len(on_link[(a, b)]))
                    rate = min(rate, share)
            else:
                rate = f.cap
                for l, bw in zip(f.links, f.link_bw):
                    rate = min(rate, bw / len(on_link[l]))
            self._reschedule(sim, f, rate if rate > 1.0 else 1.0)

    def _rate_vectorized(self, sim: Simulator, flows: list,
                         now: float) -> None:
        n = self.graph.n
        lens = np.fromiter((f.link_a.size for f in flows), np.int64,
                           len(flows))
        flat_a = np.concatenate([f.link_a for f in flows])
        flat_b = np.concatenate([f.link_b for f in flows])
        lin = flat_a * n + flat_b
        share = np.concatenate([f.link_bw_arr for f in flows])
        caps = np.fromiter((f.cap for f in flows), np.float64, len(flows))
        if self.capacity_scale is not None:
            node_scale = np.fromiter(
                (self._scale(v, now) for v in range(n)), np.float64, n)
            # same op order as the reference: (bw * scale) / count
            share = share * np.minimum(node_scale[flat_a],
                                       node_scale[flat_b])
            srcs = np.fromiter((f.src for f in flows), np.int64, len(flows))
            dsts = np.fromiter((f.dst for f in flows), np.int64, len(flows))
            caps = caps * np.minimum(node_scale[srcs], node_scale[dsts])
        share = share / self._link_nflows[lin]
        starts = np.zeros(len(flows), np.int64)
        np.cumsum(lens[:-1], out=starts[1:])
        rates = np.minimum(caps, np.minimum.reduceat(share, starts))
        np.maximum(rates, 1.0, out=rates)  # floor avoids div-by-zero stalls
        for k, f in enumerate(flows):
            self._reschedule(sim, f, float(rates[k]))

    # -- reference solver (kept for equivalence testing + benchmarking) ------
    def _rebalance_reference(self, sim: Simulator) -> None:
        """Re-derive every active flow's fair-share rate and reschedule its
        completion. O(flows x path length) per call — the original
        implementation the vectorized solver is tested against."""
        self.n_solves += 1
        if self._obs.enabled:
            m = self._obs.metrics
            m.inc("net.solver.solves")
            m.inc("net.solver.affected_flows", len(self._active))
            self._obs.trace.counter("net/flows", "active_flows",
                                    len(self._active))
        now = sim.now
        # 1. bank progress at the old rates; retire flows that just drained
        #    BEFORE computing shares, so they stop occupying their links
        finished: list[_Flow] = []
        for f in self._active.values():
            f.remaining = max(0.0, f.remaining - f.rate * (now - f.last_update))
            f.last_update = now
            if f.remaining <= 1e-9:
                finished.append(f)
        for f in finished:
            if f.finish_ev is not None:
                f.finish_ev.cancel()
                f.finish_ev = None
            del self._active[f.fid]
        # 2. count surviving flows per link
        n_on: dict[tuple[int, int], int] = {}
        for f in self._active.values():
            for l in f.links:
                n_on[l] = n_on.get(l, 0) + 1
        # 3. new rates + completion events
        for f in self._active.values():
            rate = f.cap * min(self._scale(f.src, now), self._scale(f.dst, now))
            # f.link_bw values == self.link_bw[a, b] at flow creation (the
            # only divergence is a mid-transfer tombstone, where the flow
            # legitimately keeps its capacity)
            for (a, b), bw in zip(f.links, f.link_bw):
                share = (bw
                         * min(self._scale(a, now), self._scale(b, now))
                         / n_on[(a, b)])
                rate = min(rate, share)
            f.rate = max(rate, 1.0)  # floor avoids div-by-zero stalls
            if f.finish_ev is not None:
                f.finish_ev.cancel()
            f.finish_ev = sim.schedule(f.remaining / f.rate,
                                       self._finish_flow, sim, f)
        # completion callbacks only schedule new events, never mutate
        # the active set synchronously, so firing them last is safe
        for f in finished:
            self._complete(sim, f)

    def _complete(self, sim: Simulator, flow: _Flow) -> None:
        self._active.pop(flow.fid, None)
        flow.done_cb()

    # -- topology ------------------------------------------------------------
    def _masked_latency(self) -> np.ndarray:
        """Graph latency with tombstoned (deprovisioned) nodes cut out and
        active link-fault overlays applied (cuts sever pairs via the
        0-sentinel; latency inflation multiplies, composing across
        overlapping faults)."""
        lat = self.graph.latency
        if self.tombstoned or self._link_faults:
            lat = lat.copy()
            if self.tombstoned:
                dead = sorted(self.tombstoned)
                lat[dead, :] = 0.0
                lat[:, dead] = 0.0
            n = lat.shape[0]
            for f in self._link_faults.values():
                for a, b in f["pairs"]:
                    if a >= n or b >= n:
                        continue
                    if f["cut"]:
                        lat[a, b] = lat[b, a] = 0.0
                    elif f["lat_factor"] != 1.0:
                        lat[a, b] *= f["lat_factor"]
                        lat[b, a] *= f["lat_factor"]
        return lat

    def _rebuild_topology(self, graph: ClusterGraph) -> None:
        """Routed distances + next hops + bandwidth tables for ``graph``, all
        bulk numpy/scipy ops. Per-link capacity comes from the *direct*
        latency; the end-to-end ceiling from the *routed* latency (see module
        docstring for why this calibrates)."""
        self.graph = graph
        lat = self._masked_latency()
        self.routed_ms, self._next_hop, _ = _shortest_paths(lat)
        self._refresh_bandwidth(lat)
        self._route_cache.clear()

    def _refresh_bandwidth(self, lat: np.ndarray) -> None:
        self.link_bw = cm.link_bandwidth_array(lat, self.comm_model)
        if self._link_faults:
            for f in self._link_faults.values():
                if f["cut"] or f["bw_factor"] == 1.0:
                    continue  # cuts already zeroed the latency mask
                n = self.link_bw.shape[0]
                for a, b in f["pairs"]:
                    if a >= n or b >= n:
                        continue
                    self.link_bw[a, b] *= f["bw_factor"]
                    self.link_bw[b, a] *= f["bw_factor"]
        self.e2e_bw = cm.link_bandwidth_array(self.routed_ms, self.comm_model)

    # -- elasticity ----------------------------------------------------------
    def add_machine(self, graph: ClusterGraph) -> None:
        """The fleet grew (autoscale provisioning): adopt the (n+k)-node
        graph. Active flows keep their routes and caps — their links are
        (old_i, old_j) pairs whose capacities are unchanged — while new
        transfers see the extended topology. Incremental: per joining node,
        ONE single-source Dijkstra plus a vectorized triangle relaxation
        (shortcuts through the new node), instead of the all-pairs
        recompute."""
        if graph.n < self.graph.n:
            raise ValueError("add_machine cannot shrink the fleet")
        from scipy.sparse.csgraph import shortest_path
        old_n = self.routed_ms.shape[0]
        self.graph = graph
        lat = self._masked_latency()
        w = lat.astype(np.float64).copy()
        w[w <= 0] = np.inf
        np.fill_diagonal(w, 0.0)
        # internal inf-sentinel distance matrix for the relaxation
        dist = self.routed_ms.copy()
        dist[dist <= 0] = np.inf
        np.fill_diagonal(dist, 0.0)
        nh = self._next_hop
        for u in range(old_n, graph.n):
            m = u + 1
            du, pu = shortest_path(w[:m, :m], method="D", directed=False,
                                   indices=u, return_predecessors=True)
            grown = np.full((m, m), np.inf)
            grown[:u, :u] = dist[:u, :u]
            grown[u, :] = du
            grown[:, u] = du
            np.fill_diagonal(grown, 0.0)
            dist = grown
            nh_grown = np.full((m, m), -1, np.int32)
            nh_grown[:u, :u] = nh[:u, :u]
            nh_grown[u, :] = _first_hops_from(pu, u)
            # first hop from j toward u = predecessor of j on the u->j path
            nh_grown[:, u] = np.where(pu == _NO_PRED, -1, pu)
            nh = nh_grown
            # triangle relaxation: pairs that improve by relaying through u
            alt = du[:u, None] + du[None, :u]
            imp = alt < dist[:u, :u]
            if imp.any():
                dist[:u, :u][imp] = alt[imp]
                nh[:u, :u][imp] = np.broadcast_to(pu[:u, None], (u, u))[imp]
        dist[~np.isfinite(dist)] = 0.0
        np.fill_diagonal(dist, 0.0)
        self.routed_ms = dist
        self._next_hop = nh
        self._refresh_bandwidth(lat)
        self._route_cache.clear()
        self._rebuild_link_counts()

    def remove_machine(self, mid: int) -> None:
        """Deprovision (autoscale scale-down): tombstone the node. New
        transfers can no longer source, target, or relay through it; active
        flows keep their links (the machine's NIC dies after they drain —
        callers deprovision only once the replica is idle)."""
        if not (0 <= mid < self.graph.n):
            raise ValueError(f"no machine {mid}")
        if mid in self.tombstoned:
            return
        self.tombstoned.add(mid)
        # n is unchanged, so the linearized link-count table stays valid
        self._rebuild_topology(self.graph)

    def revive_machine(self, mid: int) -> None:
        """Re-provision a previously tombstoned machine (scale-up reusing a
        deprovisioned node)."""
        if mid not in self.tombstoned:
            return
        self.tombstoned.discard(mid)
        self._rebuild_topology(self.graph)

    # -- link faults (sim.faults) --------------------------------------------
    def apply_link_fault(self, fault_id, pairs, *, bw_factor: float = 1.0,
                         lat_factor: float = 1.0, cut: bool = False,
                         sim: Optional[Simulator] = None) -> None:
        """Install a named degradation overlay on ``pairs`` (machine-id
        tuples): ``cut=True`` severs them; otherwise bandwidth multiplies by
        ``bw_factor`` and latency by ``lat_factor``. Overlays persist across
        ``reset()`` (they are environmental, not flow state) until
        ``clear_link_fault``. With ``sim`` given, in-flight flows are
        re-capped and rebalanced in place and stalled transfers re-dispatch."""
        self._link_faults[fault_id] = {
            "pairs": tuple((int(a), int(b)) for a, b in pairs),
            "bw_factor": float(bw_factor), "lat_factor": float(lat_factor),
            "cut": bool(cut)}
        self._refault(sim)

    def clear_link_fault(self, fault_id,
                         sim: Optional[Simulator] = None) -> None:
        if self._link_faults.pop(fault_id, None) is None:
            return
        self._refault(sim)

    def _refault(self, sim: Optional[Simulator]) -> None:
        """Recompute topology after an overlay change and propagate to live
        flows: each flow keeps its route but re-reads per-link capacity
        (keeping the old value where the new table reads 0 — the same
        keep-capacity semantics tombstoning uses), then the fleet
        rebalances. Transfers parked by ``stall_unreachable`` get one
        re-dispatch attempt — a heal makes them progress again."""
        self._rebuild_topology(self.graph)
        for f in self._active.values():
            new_bw = tuple(
                float(self.link_bw[a, b]) if self.link_bw[a, b] > 0 else old
                for (a, b), old in zip(f.links, f.link_bw))
            f.link_bw = new_bw
            f.link_bw_arr = np.asarray(new_bw, np.float64)
        if sim is None:
            return
        if self._active:
            if self.solver == "fast":
                self._dirty_all = True
                self._request_solve(sim)
            else:
                self._rebalance_reference(sim)
        if self._stalled:
            stalled, self._stalled = self._stalled, []
            for (i, j, nbytes, cb) in stalled:
                self.transfer(sim, i, j, nbytes, cb)

    def _rebuild_link_counts(self) -> None:
        """Re-derive the flat per-link flow-count table after n (and with it
        the linearized link index a*n+b) changed."""
        n = self.graph.n
        self._link_nflows = np.zeros(n * n, np.int64)
        for (a, b), d in self._flows_on_link.items():
            self._link_nflows[a * n + b] = len(d)

    # -- lifecycle -----------------------------------------------------------
    def reset(self) -> None:
        """Drop all in-flight flows (used when a re-plan bumps the epoch; the
        flows' pending events die with the old epoch). Pending tick/solve
        events are cancelled explicitly so a reset NOT accompanied by an
        epoch bump can't fire a stale rebalance."""
        for f in self._active.values():
            if f.finish_ev is not None:
                f.finish_ev.cancel()
        self._active.clear()
        self._stalled.clear()
        self._flows_on_link.clear()
        self._link_nflows[:] = 0
        self._dirty.clear()
        self._dirty_all = False
        if self._tick_ev is not None:
            self._tick_ev.cancel()
            self._tick_ev = None
        if self._solve_ev is not None:
            self._solve_ev.cancel()
            self._solve_ev = None
