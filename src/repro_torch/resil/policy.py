"""Serving policy: deadlines, retry, backpressure, graceful degradation.

:class:`ServePolicy` is the engine's request-lifecycle contract under
stress:

  * **Deadlines** — per-request e2e and TTFT deadlines (policy defaults,
    overridable per ``submit``).  A request past its deadline terminates
    with status ``"deadline"`` whether queued or active; it is never
    silently dropped.
  * **Retry** — a guard-tripped request is rewound to a fresh admission
    and requeued (front of queue) behind a capped exponential backoff;
    after ``max_retries`` requeues it terminates with status ``"failed"``.
  * **Backpressure** — queue-length and queue-age caps.  Overflow triggers
    graceful degradation first: when ``brownout`` is on and a QoS
    controller with rungs left is attached, the engine forces the
    controller one rung down its calibrated ladder (cheaper approximate
    arithmetic, faster ticks, the queue drains) and sheds — status
    ``"shed"``, newest first — only once the ladder is exhausted.

Everything here measures time through the engine's injectable clock, so
:class:`VirtualClock` makes deadline, backoff and goodput behaviour
deterministic.  :func:`retry` is a host-side I/O retry helper.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional


@dataclass
class ServePolicy:
    """Engine policy knobs; any field None/0 disables that mechanism."""

    #: default per-request e2e deadline (ms, from enqueue; None = none)
    deadline_ms: Optional[float] = None
    #: default per-request TTFT deadline (ms, enqueue -> first emission)
    ttft_deadline_ms: Optional[float] = None
    #: guard-trip requeues before a request fails
    max_retries: int = 2
    #: retry backoff: base * 2**(retries-1), capped (ms)
    backoff_ms: float = 1.0
    backoff_cap_ms: float = 50.0
    #: queue-length backpressure cap (None = unbounded)
    max_queue: Optional[int] = None
    #: queue-age backpressure: shed requests older than this (ms) that are
    #: still waiting (independent of their own deadline)
    max_queue_age_ms: Optional[float] = None
    #: degrade down the QoS ladder before shedding (needs qos= on engine)
    brownout: bool = True
    #: modeled per-admission-call latency (ms) for the doomed-request
    #: check: a queued request whose remaining TTFT budget cannot cover
    #: ``workload.admit_calls(req) * admit_eta_ms`` is shed early (status
    #: "shed", reason "doomed"; None = check disabled)
    admit_eta_ms: Optional[float] = None

    def backoff_s(self, retries: int) -> float:
        """Capped exponential backoff (seconds) before retry #``retries``."""
        return min(self.backoff_cap_ms,
                   self.backoff_ms * (2 ** max(0, retries - 1))) / 1e3


class VirtualClock:
    """Deterministic manual clock: callable like ``time.time`` (pass as
    ``ServeCore(clock=...)``) plus ``advance``."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += float(dt)
        return self.t


def retry(fn, *, attempts: int = 3, backoff: float = 0.05,
          cap: float = 1.0, exceptions=(OSError,), sleep=time.sleep):
    """Call ``fn()`` with capped-exponential-backoff retries on transient
    host-side failures.  Re-raises the last exception once ``attempts``
    are exhausted; non-matching exceptions propagate immediately."""
    if attempts < 1:
        raise ValueError("retry needs attempts >= 1")
    for i in range(attempts):
        try:
            return fn()
        except exceptions:
            if i == attempts - 1:
                raise
            sleep(min(cap, backoff * (2 ** i)))
