"""Admission control and backpressure at the front door.

Counterpart of ``ray_tpu/ingress/admission.py``. The ingress sheds
instead of queueing without bound:

- **bounded in-flight budget**: at most ``max_inflight`` admitted
  requests may be unanswered at once; past that the ingress answers
  **429 Too Many Requests** with a ``Retry-After`` hint;
- **per-policy quotas**: a shared controller may cap each policy's
  slice of the budget (``quotas={"policy": n}`` or ``default_quota``); a
  request past its policy's share gets **429** with reason ``quota``;
- **queue-wait shedding**: when the trailing-window p50 queue wait (the
  policy server's ``queue_wait_window()``, surfaced through
  ``CoalescingRouter.queue_wait_signal``) exceeds ``shed_queue_wait_s``,
  new requests get **503 Service Unavailable** with a ``Retry-After``
  sized to the observed wait;
- **dead-on-arrival drops**: a request whose deadline is already
  unmeetable is refused at once (**504**).

The wait signal is sampled at most every ``signal_interval_s``, so a
decision costs one clock read per request.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.util import telemetry


class AdmissionDecision:
    """A refusal: HTTP status, machine-readable reason, Retry-After."""

    __slots__ = ("status", "reason", "retry_after_s")

    def __init__(self, status: int, reason: str, retry_after_s: float):
        self.status = status
        self.reason = reason
        self.retry_after_s = retry_after_s


class AdmissionController:
    """Per-policy (or shared) admission state. ``try_admit`` returns
    None to admit (pair it with ``release()``, or use :meth:`admit`) or
    an :class:`AdmissionDecision` describing the shed. ``quotas`` maps a
    policy name to its in-flight cap inside ``max_inflight``; callers opt
    in by passing ``policy=`` to both ``try_admit`` and ``release``."""

    def __init__(
        self,
        *,
        max_inflight: int = 256,
        shed_queue_wait_s: Optional[float] = None,
        wait_signal: Optional[Callable[[], Optional[float]]] = None,
        signal_interval_s: float = 0.25,
        retry_after_s: float = 1.0,
        quotas: Optional[Dict[str, int]] = None,
        default_quota: Optional[int] = None,
    ):
        self.max_inflight = int(max_inflight)
        self.shed_queue_wait_s = shed_queue_wait_s
        self.wait_signal = wait_signal
        self.signal_interval_s = float(signal_interval_s)
        self.retry_after_s = float(retry_after_s)
        self.quotas: Dict[str, int] = {str(k): int(v) for k, v in (quotas or {}).items()}
        self.default_quota = int(default_quota) if default_quota is not None else None
        self._lock = threading.Lock()
        self._inflight = 0
        self._policy_inflight: Dict[str, int] = {}
        self._signal_value: Optional[float] = None
        self._signal_t = 0.0
        self.admitted_total = 0
        self.shed_total: Dict[str, int] = {"inflight": 0, "quota": 0, "queue_wait": 0, "deadline": 0}

    def _current_wait(self) -> Optional[float]:
        """The wait signal, refreshed at most once per
        ``signal_interval_s``."""
        if self.wait_signal is None:
            return None
        now = time.monotonic()
        with self._lock:
            if now - self._signal_t < self.signal_interval_s:
                return self._signal_value
            self._signal_t = now
        try:
            value = self.wait_signal()
        except Exception:
            value = None
        with self._lock:
            self._signal_value = value
        return value

    def _quota_for(self, policy: Optional[str]) -> Optional[int]:
        if policy is None:
            return None
        q = self.quotas.get(policy)
        return q if q is not None else self.default_quota

    def try_admit(self, deadline_s: Optional[float] = None,
                  policy: Optional[str] = None) -> Optional[AdmissionDecision]:
        """Admit (None) or shed (a decision). ``deadline_s`` is the
        request's relative deadline; non-positive cannot be met."""
        if deadline_s is not None and deadline_s <= 0:
            return self._shed("deadline", 504, self.retry_after_s)
        wait = self._current_wait()
        if self.shed_queue_wait_s is not None and wait is not None and wait > self.shed_queue_wait_s:
            # Retry-After sized to the congestion observed
            return self._shed("queue_wait", 503, max(self.retry_after_s, 2.0 * wait))
        quota = self._quota_for(policy)
        with self._lock:
            if self._inflight >= self.max_inflight:
                reason = "inflight"
            elif quota is not None and self._policy_inflight.get(policy, 0) >= quota:
                reason = "quota"
            else:
                reason = None
                self._inflight += 1
                self.admitted_total += 1
                inflight = self._inflight
                if policy is not None:
                    self._policy_inflight[policy] = self._policy_inflight.get(policy, 0) + 1
                    policy_inflight = self._policy_inflight[policy]
        if reason is not None:
            return self._shed(reason, 429, self.retry_after_s)
        telemetry.set_ingress_inflight(inflight)
        if policy is not None:
            telemetry.set_ingress_policy_inflight(policy, policy_inflight)
        return None

    def _shed(self, reason: str, status: int, retry_after_s: float) -> AdmissionDecision:
        with self._lock:
            self.shed_total[reason] = self.shed_total.get(reason, 0) + 1
        telemetry.inc_ingress_shed(reason)
        return AdmissionDecision(status, reason, retry_after_s)

    def release(self, policy: Optional[str] = None) -> None:
        with self._lock:
            self._inflight = max(0, self._inflight - 1)
            inflight = self._inflight
            if policy is not None:
                self._policy_inflight[policy] = max(0, self._policy_inflight.get(policy, 0) - 1)
                policy_inflight = self._policy_inflight[policy]
        telemetry.set_ingress_inflight(inflight)
        if policy is not None:
            telemetry.set_ingress_policy_inflight(policy, policy_inflight)

    class _Admit:
        __slots__ = ("ctrl", "decision", "policy")

        def __init__(self, ctrl, decision, policy=None):
            self.ctrl = ctrl
            self.decision = decision
            self.policy = policy

        @property
        def admitted(self) -> bool:
            return self.decision is None

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            if self.admitted:
                self.ctrl.release(self.policy)
            return False

    def admit(self, deadline_s: Optional[float] = None,
              policy: Optional[str] = None) -> "AdmissionController._Admit":
        """``with ctrl.admit(...) as a:``: ``a.admitted`` says whether to
        proceed; the release happens on exit."""
        return self._Admit(self, self.try_admit(deadline_s, policy=policy), policy)

    def num_inflight(self, policy: Optional[str] = None) -> int:
        with self._lock:
            if policy is not None:
                return self._policy_inflight.get(policy, 0)
            return self._inflight

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "inflight": self._inflight,
                "max_inflight": self.max_inflight,
                "admitted_total": self.admitted_total,
                "shed_total": dict(self.shed_total),
                "shed_queue_wait_s": self.shed_queue_wait_s,
                "last_wait_signal": self._signal_value,
                "quotas": dict(self.quotas),
                "default_quota": self.default_quota,
                "policy_inflight": dict(self._policy_inflight),
            }
