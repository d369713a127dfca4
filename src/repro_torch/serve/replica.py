"""Continuous-batching replica model (vLLM/aphrodite-style mechanics).

A ``Replica`` owns one machine of the ``ClusterGraph`` and runs an iteration
loop over the discrete-event engine:

* an **admission queue** holds routed requests until there is both a batch
  slot and KV room; KV is reserved for the whole sequence (prompt + max
  generation) at admission, so a sequence admitted once can never be
  preempted by memory pressure — the conservative reservation real engines
  use when they disable swapping;
* each **iteration** interleaves prefill and decode: sequences still
  prefilling contribute a chunk of prompt tokens (chunked prefill), every
  decoded sequence contributes exactly one token. The iteration's duration
  is the efficiency-adjusted FLOPs priced by ``serve.costs`` divided through
  the machine's FLOP/s — i.e. ``sim.compute.ComputeModel.duration``, so
  straggler/jitter modeling applies to serving for free;
* completions free their KV reservation and fire the router's callback
  (which moves the response back over the network).

Fleet-scale fast path: iteration starts are deferred by one
zero-delay event so every request routed at the same timestamp is admitted
into the SAME first batch (an idle replica no longer launches a batch-of-one
for the first arrival of a burst), and the router's load signal
(``backlog_work``) is maintained as two integer token counters instead of a
per-query sweep over the queue — ``pick`` cost no longer scales with queue
depth. ``backlog_work_reference`` keeps the original sweep for equivalence
tests.

Calibration contract (asserted in tests/test_serve.py): with zero jitter and
an idle network, a request's time inside the replica is exactly
``ServeModel.service_s(prompt, gen, tflops)`` — chunking only splits the
work across iterations, it never adds any.

Port of ``repro/serve/replica.py``: a numpy copy, so a replica gives the
reference's iterations and times.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Optional

from repro_torch import obs as obs_mod
from repro_torch.serve.costs import ServeModel
from repro_torch.serve.traffic import Request
from repro_torch.sim.compute import ComputeModel
from repro_torch.sim.engine import Event, Simulator

# keeps replica-iteration jitter streams disjoint from the training tags
_TAG_SERVE = 4


@dataclasses.dataclass
class Seq:
    """One admitted request's in-flight decoding state."""
    req: Request
    done_cb: Callable[["Seq"], None]
    t_enqueue: float
    prefill_remaining: int = 0
    decode_remaining: int = 0
    t_admit: Optional[float] = None
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None

    @property
    def kv_tokens(self) -> int:
        return self.req.total_tokens


class Replica:
    def __init__(self, sim: Simulator, compute: ComputeModel, machine_id: int,
                 model: ServeModel, memory_gb: float, *, max_batch: int = 8,
                 prefill_chunk: int = 256, name: str | None = None,
                 reference_backlog: bool = False, obs=None):
        self._obs = obs if obs is not None else obs_mod.NULL
        self.sim = sim
        self.compute = compute
        self.machine = int(machine_id)
        self.model = model
        self.name = name or f"replica@{machine_id}"
        self.max_batch = max_batch
        self.prefill_chunk = prefill_chunk
        self.reference_backlog = reference_backlog
        self.kv_capacity = model.kv_capacity_tokens(memory_gb)
        self.kv_used = 0
        self.queue: collections.deque[Seq] = collections.deque()
        self.running: list[Seq] = []
        self.alive = True
        self.accepting = True           # False while draining
        self.it = 0                     # iteration counter (jitter key)
        self.busy_s = 0.0
        self.tokens_decoded = 0
        self.tokens_prefilled = 0
        self.batch_occupancy: float = 0.0   # time-integral of batch size
        self._iter_ev: Optional[Event] = None
        self._kick_ev: Optional[Event] = None   # deferred iteration start
        self._idle_cb: Optional[Callable[[], None]] = None
        # pending-token counters (queued + in flight); integers, so the
        # incremental backlog is exact, not a float accumulation
        self._pending_prefill = 0
        self._pending_decode = 0

    # -- queries -------------------------------------------------------------
    def fits(self, req: Request) -> bool:
        """Can this replica EVER hold the request? (KV reservation bound)"""
        return req.total_tokens <= self.kv_capacity

    def n_pending(self) -> int:
        return len(self.queue) + len(self.running)

    def backlog_work(self) -> float:
        """Effective FLOPs of everything queued or in flight — the router's
        load signal. O(1): ``service_work`` is linear in tokens, so the sum
        over sequences equals the work of the summed token counts."""
        return self.model.prefill_work(self._pending_prefill) \
            + self.model.decode_work(self._pending_decode)

    def backlog_work_reference(self) -> float:
        """The original O(queue + batch) backlog sweep, kept as the
        equivalence oracle for the counter-based ``backlog_work``."""
        w = 0.0
        for s in self.queue:
            w += self.model.service_work(s.req.prompt_tokens,
                                         s.req.gen_tokens)
        for s in self.running:
            w += self.model.prefill_work(s.prefill_remaining) \
                + self.model.decode_work(s.decode_remaining)
        return w

    def est_wait_s(self) -> float:
        tf = float(self.compute.tflops[self.machine]) * 1e12
        work = self.backlog_work_reference() if self.reference_backlog \
            else self.backlog_work()
        return work / tf

    # -- request flow --------------------------------------------------------
    def submit(self, req: Request, done_cb: Callable[[Seq], None]) -> Seq:
        assert self.alive and self.accepting
        seq = Seq(req=req, done_cb=done_cb, t_enqueue=self.sim.now,
                  prefill_remaining=req.prompt_tokens,
                  decode_remaining=req.gen_tokens)
        self.queue.append(seq)
        self._pending_prefill += req.prompt_tokens
        self._pending_decode += req.gen_tokens
        self._maybe_iterate()
        return seq

    def _admit(self) -> None:
        while (self.queue and len(self.running) < self.max_batch
               and self.kv_used + self.queue[0].kv_tokens
               <= self.kv_capacity):
            seq = self.queue.popleft()
            seq.t_admit = self.sim.now
            self.kv_used += seq.kv_tokens
            self.running.append(seq)

    def _maybe_iterate(self) -> None:
        """Arm the next iteration. The start is deferred by one zero-delay
        event so every submit at the current timestamp joins the batch —
        without it, the first request of a same-tick burst would launch a
        batch of one and the rest would wait a full iteration."""
        if not self.alive or self._iter_ev is not None \
                or self._kick_ev is not None:
            return
        if not (self.queue or self.running):
            return
        self._kick_ev = self.sim.schedule(0.0, self._start_iteration)

    def _start_iteration(self) -> None:
        self._kick_ev = None
        if not self.alive or self._iter_ev is not None:
            return
        self._admit()
        if not self.running:
            return
        # one cost-card call per phase, not per sequence: decode tokens are
        # identical (1 each), so the batch prices as decode_work(n_decoding)
        chunk = self.prefill_chunk
        prefill_tokens = 0
        n_decoding = 0
        for s in self.running:
            if s.prefill_remaining > 0:
                prefill_tokens += chunk if s.prefill_remaining > chunk \
                    else s.prefill_remaining
            else:
                n_decoding += 1
        work = self.model.prefill_work(prefill_tokens) \
            + self.model.decode_work(n_decoding)
        dur = self.compute.duration(self.machine, work, step=self.it,
                                    microbatch=0, tag=_TAG_SERVE)
        self.busy_s += dur
        self.batch_occupancy += dur * len(self.running)
        if self._obs.enabled and work > 0:
            # actual / zero-jitter duration: >1 under straggle, gray failure
            # or jitter — the per-machine drift signal obs.monitors EWMAs
            base = work / (float(self.compute.tflops[self.machine]) * 1e12)
            if base > 0:
                self._obs.metrics.observe(
                    f"replica.slowdown.m{self.machine}", dur / base)
        self._iter_ev = self.sim.schedule(dur, self._finish_iteration)

    def _finish_iteration(self) -> None:
        self._iter_ev = None
        if not self.alive:
            return
        self.it += 1
        done: list[Seq] = []
        for s in self.running:
            if s.prefill_remaining > 0:
                chunk = min(self.prefill_chunk, s.prefill_remaining)
                s.prefill_remaining -= chunk
                self.tokens_prefilled += chunk
                self._pending_prefill -= chunk
            else:
                s.decode_remaining -= 1
                self.tokens_decoded += 1
                self._pending_decode -= 1
                if s.t_first_token is None:
                    s.t_first_token = self.sim.now
                if s.decode_remaining == 0:
                    done.append(s)
        for s in done:
            self.running.remove(s)
            self.kv_used -= s.kv_tokens
            s.t_done = self.sim.now
        if self._obs.enabled:
            self._obs.metrics.inc("replica.iterations")
            if done:
                self._record_done(done)
        # continue the batch inline — the deferred (zero-delay-event) start
        # is only needed on the idle->busy edge, where it lets a same-tick
        # burst of submits share the first batch; a replica mid-stream
        # admits at its own iteration boundary, like a real engine
        self._start_iteration()
        # callbacks last: they may route new work back into this replica
        for s in done:
            s.done_cb(s)
        if self._idle_cb is not None and not self.running and not self.queue:
            cb, self._idle_cb = self._idle_cb, None
            cb()

    def _record_done(self, done: list[Seq]) -> None:
        """Emit the request lifecycle spans (queued -> prefill -> decode ->
        done) for each completed sequence on this replica's lane. All four
        timestamps were recorded on the ``Seq`` as the engine fired them, so
        emitting retroactively at completion keeps the hot iteration loop
        free of tracing branches; async spans, because a batch completes many
        overlapping sequences on one lane."""
        trace = self._obs.trace
        metrics = self._obs.metrics
        track = f"replica/{self.machine}"
        for s in done:
            sid = f"r{s.req.rid}"
            first = s.t_first_token if s.t_first_token is not None else s.t_done
            trace.async_span(track, "queued", sid, s.t_enqueue, s.t_admit,
                             cat="request", args={"rid": s.req.rid})
            trace.async_span(track, "prefill", sid, s.t_admit, first,
                             cat="request",
                             args={"tokens": s.req.prompt_tokens})
            trace.async_span(track, "decode", sid, first, s.t_done,
                             cat="request",
                             args={"tokens": s.req.gen_tokens})
            metrics.inc("replica.seqs_completed")
            metrics.observe("serve.queue_wait_s", s.t_admit - s.t_enqueue)
            metrics.observe("serve.service_s", s.t_done - s.t_admit)

    # -- lifecycle -----------------------------------------------------------
    def drain(self) -> list[Request]:
        """Stop admitting; return the not-yet-admitted requests so the
        router can place them elsewhere. In-flight sequences finish."""
        self.accepting = False
        dropped = [s.req for s in self.queue]
        for s in self.queue:
            self._pending_prefill -= s.req.prompt_tokens
            self._pending_decode -= s.req.gen_tokens
        self.queue.clear()
        return dropped

    def when_idle(self, cb: Callable[[], None]) -> None:
        """Run ``cb`` once nothing is queued or in flight (fires immediately
        if already idle). Used by the executor to deprovision a drained
        replica's machine only after its last response has left."""
        if not self.running and not self.queue:
            cb()
        else:
            self._idle_cb = cb

    def abort(self, seq: Seq) -> bool:
        """Cancel one sequence (attempt timed out / lost a hedge race).
        Returns False if the sequence already completed or left this replica.
        A running sequence frees its KV reservation immediately; the current
        iteration still runs to completion (the abort takes effect at the
        next batch boundary, like a real engine's cancellation)."""
        if seq in self.queue:
            self.queue.remove(seq)
            self._pending_prefill -= seq.prefill_remaining
            self._pending_decode -= seq.decode_remaining
            if self._obs.enabled:
                self._obs.metrics.inc("replica.seqs_aborted")
            return True
        if seq in self.running:
            self.running.remove(seq)
            self.kv_used -= seq.kv_tokens
            self._pending_prefill -= seq.prefill_remaining
            self._pending_decode -= seq.decode_remaining
            if self._obs.enabled:
                self._obs.metrics.inc("replica.seqs_aborted")
            return True
        return False

    def fail(self) -> list[Request]:
        """Machine died: every queued AND in-flight request is interrupted
        and handed back for re-routing (generation restarts from scratch —
        no cross-replica KV migration yet)."""
        self.alive = False
        self.accepting = False
        self._idle_cb = None
        if self._iter_ev is not None:
            self._iter_ev.cancel()
            self._iter_ev = None
        if self._kick_ev is not None:
            self._kick_ev.cancel()
            self._kick_ev = None
        interrupted = [s.req for s in self.queue] \
            + [s.req for s in self.running]
        self.queue.clear()
        self.running.clear()
        self.kv_used = 0
        self._pending_prefill = 0
        self._pending_decode = 0
        return interrupted

    def stats(self) -> dict:
        return {
            "machine": self.machine,
            "busy_s": self.busy_s,
            "iterations": self.it,
            "tokens_decoded": self.tokens_decoded,
            "tokens_prefilled": self.tokens_prefilled,
            "mean_batch": (self.batch_occupancy / self.busy_s
                           if self.busy_s > 0 else 0.0),
            "kv_capacity_tokens": self.kv_capacity,
            "alive": self.alive,
        }
