"""Serving resilience policies: retry, hedging, circuit breaking, shedding.

These are the knobs ``sim.workload.ServeExecutor`` consults when a
``ResilienceConfig`` is installed (``resilience=`` ctor arg / the
``ServeScenario.resilience`` field). With no config — the default — the
executor runs the legacy blind-reroute path untouched, so every existing
scenario replays bit-identically; with one, requests flow through a
per-attempt state machine:

* ``RetryPolicy``  — every dispatched attempt carries a timeout; on expiry
  the attempt is aborted at its replica (``Replica.abort``), the failure is
  recorded with the breaker, and the request re-dispatches after an
  exponential backoff, up to ``max_retries`` times. A request whose budget
  is exhausted drops with reason ``retry_budget``.
* ``HedgePolicy``  — ``delay_s`` after dispatch, if the request is still
  unresolved, a second attempt is launched on a *different* replica;
  whichever attempt completes first wins and the loser is aborted
  (first-completion-wins, standard tail-latency hedging).
* ``BreakerPolicy`` — a replica that fails ``failure_threshold``
  consecutive attempts is ejected from routing for ``probation_s``; after
  probation it is re-admitted and one more failure re-ejects it
  immediately (half-open probing). If every candidate is ejected the
  router fails open rather than serving nothing.
* ``ShedPolicy``   — at arrival, if the best achievable completion
  estimate (routed latency + queue wait + service time) already exceeds
  the deadline, the request is dropped immediately with reason
  ``deadline`` — overload protection that spends no capacity on doomed
  work.

All knobs are independent: any subset may be None.

Port of ``repro/serve/resilience.py``, copied verbatim.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    timeout_s: float = 10.0        # per-attempt deadline
    max_retries: int = 3           # retry budget (attempts beyond the first)
    backoff_base_s: float = 0.5    # delay before retry k is base * mult^(k-1)
    backoff_mult: float = 2.0


@dataclasses.dataclass(frozen=True)
class HedgePolicy:
    delay_s: float = 2.0           # hedge fires if unresolved after this
    max_hedges: int = 1            # extra concurrent attempts per request


@dataclasses.dataclass(frozen=True)
class BreakerPolicy:
    failure_threshold: int = 3     # consecutive failures before ejection
    probation_s: float = 30.0      # ejection duration before half-open


@dataclasses.dataclass(frozen=True)
class ShedPolicy:
    deadline_s: float = 30.0       # drop if est. completion exceeds this
    slack: float = 1.0             # deadline multiplier (>1 sheds later)


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    retry: Optional[RetryPolicy] = None
    hedge: Optional[HedgePolicy] = None
    breaker: Optional[BreakerPolicy] = None
    shed: Optional[ShedPolicy] = None

    @classmethod
    def default(cls) -> "ResilienceConfig":
        """Retry + hedge + breaker at conventional settings (no shedding) —
        the configuration ``benchmarks/chaos_bench.py`` scores against the
        naive reroute baseline."""
        return cls(retry=RetryPolicy(), hedge=HedgePolicy(),
                   breaker=BreakerPolicy())


@dataclasses.dataclass
class _BreakerState:
    consecutive_failures: int = 0
    open_until: float = -math.inf


class CircuitBreaker:
    """Per-machine consecutive-failure ejection with probation re-admission.

    ``record_failure`` past the threshold opens the breaker until
    ``now + probation_s``; ``allow`` readmits once probation has elapsed
    (half-open: the consecutive count is retained, so the very next failure
    re-opens immediately); ``record_success`` closes it fully.
    """

    def __init__(self, policy: BreakerPolicy):
        self.policy = policy
        self._state: dict[int, _BreakerState] = {}
        self.ejections = 0

    def allow(self, machine: int, now: float) -> bool:
        st = self._state.get(machine)
        return st is None or now >= st.open_until

    def record_success(self, machine: int) -> None:
        self._state.pop(machine, None)

    def record_failure(self, machine: int, now: float) -> bool:
        """Returns True when this failure (re)opened the breaker."""
        st = self._state.setdefault(machine, _BreakerState())
        st.consecutive_failures += 1
        if st.consecutive_failures >= self.policy.failure_threshold:
            st.open_until = now + self.policy.probation_s
            self.ejections += 1
            return True
        return False

    def reset(self, machine: int) -> None:
        """Forget a machine's history (it was replaced/recovered)."""
        self._state.pop(machine, None)

    def open_machines(self, now: float) -> list[int]:
        return sorted(m for m, st in self._state.items()
                      if now < st.open_until)
