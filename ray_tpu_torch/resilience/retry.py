"""RetryPolicy: one timeout / exponential-backoff / jitter / max-attempts
schedule for the control plane.

Counterpart of ``ray_tpu/resilience/retry.py``, over the port's runtime
(``core``): every main-process remote interaction (the request manager's
submission and harvest bound, the worker set's weight and filter sync
and ``foreach_worker``, the health probe) draws its bound from one
:class:`RetryPolicy` built from the algorithm's config
(``AlgorithmConfig.fault_tolerance(retry_...)``), so a wedged actor costs
a bounded, configured time instead of a hang. ``delay`` and ``schedule``
give the reference's numbers for the same seed (``random.Random(seed +
attempt)``).
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch.core.object_store import GetTimeoutError

# retried by default: timeouts and transport faults. An actor's death is
# not: the recovery layer replaces the actor instead
DEFAULT_RETRYABLE = (GetTimeoutError, TimeoutError, ConnectionError, OSError)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """``max_attempts`` counts every try (1: no retry); ``timeout_s`` is
    the bound of one attempt's ``get``/``wait`` (None: the caller's).
    The pause after attempt *k* is ``backoff_s * backoff_mult**k``
    capped at ``max_backoff_s``, plus up to ``jitter`` of itself;
    ``seed`` makes the jitter repeatable."""

    max_attempts: int = 3
    timeout_s: Optional[float] = 60.0
    backoff_s: float = 0.05
    backoff_mult: float = 2.0
    max_backoff_s: float = 2.0
    jitter: float = 0.1
    seed: Optional[int] = None

    @classmethod
    def from_config(cls, config: Dict) -> "RetryPolicy":
        """From the flat ``retry_*`` keys ``fault_tolerance`` writes."""
        cfg = config or {}
        return cls(
            max_attempts=int(cfg.get("retry_max_attempts", 3)),
            timeout_s=cfg.get("retry_timeout_s", 60.0),
            backoff_s=float(cfg.get("retry_backoff_s", 0.05)),
            backoff_mult=float(cfg.get("retry_backoff_mult", 2.0)),
            max_backoff_s=float(cfg.get("retry_max_backoff_s", 2.0)),
            jitter=float(cfg.get("retry_jitter", 0.1)),
            seed=cfg.get("seed"),
        )

    def delay(self, attempt: int, rng: Optional[random.Random] = None) -> float:
        """The pause before retry number ``attempt`` (0-based)."""
        base = min(self.backoff_s * (self.backoff_mult ** attempt), self.max_backoff_s)
        if self.jitter <= 0.0:
            return base
        rng = rng or (random.Random(self.seed + attempt) if self.seed is not None else random)
        return base * (1.0 + self.jitter * rng.random())

    def schedule(self) -> List[float]:
        """Every pause of the schedule (``max_attempts - 1`` of them)."""
        return [self.delay(a) for a in range(max(0, self.max_attempts - 1))]

    def call(
        self,
        fn: Callable[[], Any],
        *,
        retry_on: Optional[Tuple] = None,
        on_retry: Optional[Callable[[int, BaseException], None]] = None,
        deadline_s: Optional[float] = None,
    ) -> Any:
        """``fn()`` under this schedule: a retryable error sleeps the
        pause and tries again, the last attempt's error propagates, any
        other error propagates at once. ``deadline_s`` bounds the whole
        schedule by one wall clock: no attempt starts after it."""
        retry_on = retry_on or DEFAULT_RETRYABLE
        deadline = time.monotonic() + deadline_s if deadline_s is not None else None
        last: Optional[BaseException] = None
        for attempt in range(max(1, self.max_attempts)):
            try:
                return fn()
            except retry_on as e:  # noqa: PERF203 -- the retry loop
                last = e
                if attempt >= self.max_attempts - 1:
                    raise
                pause = self.delay(attempt)
                if deadline is not None and deadline - time.monotonic() <= pause:
                    raise
                if on_retry is not None:
                    on_retry(attempt, e)
                time.sleep(pause)
        raise last  # pragma: no cover -- the loop returns or raises


def ray_get_retrying(ref, policy: RetryPolicy, *, timeout_s: Optional[float] = None):
    """``core.get`` bounded by the policy: each attempt waits at most
    ``timeout_s`` (default ``policy.timeout_s``); a timeout retries on
    the schedule, an actor's error propagates at once."""
    from ray_tpu_torch.core import api

    t = policy.timeout_s if timeout_s is None else timeout_s
    return policy.call(lambda: api.get(ref, timeout=t), retry_on=(GetTimeoutError,))


def probe_actors(actors: Sequence, *, timeout_s: float = 10.0, ping: Callable = None) -> List[int]:
    """The 0-based indices of the actors that fail a ping. Every ping is
    sent at once and they share one wall-clock budget, so a wedged
    actor delays the sweep by the budget at most. An actor is unhealthy
    when its ping errors (dead) or does not answer in the budget
    (wedged)."""
    from ray_tpu_torch.core import api

    if not actors:
        return []
    ping = ping or (lambda a: a.ping.remote())
    refs, bad = [], []
    for i, a in enumerate(actors):
        try:
            refs.append((i, ping(a)))
        except Exception:
            bad.append(i)  # a submission to a known-dead actor can raise
    pending = [r for _, r in refs]
    if pending:
        api.wait(pending, num_returns=len(pending), timeout=max(0.0, timeout_s))
        ready_now, _ = api.wait(pending, num_returns=len(pending), timeout=0)
        ready_ids = {r.id for r in ready_now}
        for i, r in refs:
            if r.id not in ready_ids:
                bad.append(i)  # wedged
                continue
            try:
                api.get(r, timeout=0.1)
            except Exception:
                bad.append(i)  # dead: the ping came back with an error
    return sorted(bad)
