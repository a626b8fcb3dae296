"""Deterministic fault injection for chaos runs of the training loop.

Counterpart of ``ray_tpu/resilience/faults.py``: an injector built from
the config (or the ``RAY_TPU_FAULTS`` variable) that the hot path
consults at its choke points:

- **a rollout worker's sample** (``RolloutWorker.sample``): exit this
  worker's process on its K-th call (``kill_worker``), announce a
  preemption and exit G seconds later (``preempt_worker``), or sleep
  (``delay_sample``);
- **the main process's learn** (``train_ops.train_one_step``, PPO's prefetch
  ``deliver``): poison the K-th learn batch's first float column with a
  NaN or an Inf (``nan_batch``; before the batch goes to the card), or
  raise :class:`InjectedCrash` (``crash_learner``);
- **the learner thread** (``LearnerThread.step``): raise on its K-th
  step (``crash_learner_thread``).

Spec forms (dict keys or ``RAY_TPU_FAULTS`` tokens) are the
reference's::

    RAY_TPU_FAULTS="kill_worker:2@3,4@1;nan_batch:@2;delay_sample:1@2x0.5"

Every trigger fires once, on per-process call counts, and the workers
the recovery layer makes in place of dead ones get an empty spec, so a
replacement does not die its predecessor's death.

The reference's fleet family (``kv_drop``, ``kv_delay``,
``partition_host``, ``kill_coordinator``) arms its learner fleet's KV
control plane, which the port does not have: :func:`_parse_env_spec`
reads those tokens as the reference does, and an injector asked for
them raises, naming ``ROADMAP.md`` queue 1 item 7.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

FLEET_FAULT_KINDS = ("kv_drop", "kv_delay", "partition_host", "kill_coordinator")
_FLEET_ITEM = "ROADMAP.md queue 1 item 7"


class InjectedCrash(RuntimeError):
    """A deliberately injected, restartable main-process failure."""


def _arm_exit_timer(grace_s: float) -> None:
    """This process exits ``grace_s`` seconds from now, drained or not
    (module-level, so a test in its own process can stub it)."""
    t = threading.Timer(grace_s, os._exit, args=(1,))
    t.daemon = True
    t.start()


def _items(arg: str) -> List[str]:
    return [item for item in arg.split(",") if item]


def _parse_env_spec(text: str) -> Dict[str, Any]:
    """``kill_worker:2@3;nan_batch:@2;delay_sample:1@2x0.5`` → the
    dict form, as the reference parses it."""
    spec: Dict[str, Any] = {}
    for token in filter(None, (t.strip() for t in text.split(";"))):
        kind, _, arg = token.partition(":")
        kind = kind.strip()
        if kind == "kill_worker":
            lst = spec.setdefault(kind, [])
            for item in _items(arg):
                w, _, k = item.partition("@")
                lst.append({"worker_index": int(w), "on_call": int(k or 1)})
        elif kind in ("preempt_worker", "delay_sample"):
            lst = spec.setdefault(kind, [])
            key, default = ("grace_s", 10.0) if kind == "preempt_worker" else ("delay_s", 1.0)
            for item in _items(arg):
                w, _, rest = item.partition("@")
                k, _, x = rest.partition("x")
                lst.append({"worker_index": int(w), "on_call": int(k or 1), key: float(x or default)})
        elif kind in ("nan_batch", "crash_learner"):
            _, _, k = arg.partition("@")
            spec[kind] = {"on_learn_call": int(k or 1)}
        elif kind == "crash_learner_thread":
            _, _, k = arg.partition("@")
            spec[kind] = {"on_step": int(k or 1)}
        elif kind == "kv_drop":
            lst = spec.setdefault(kind, [])
            for item in _items(arg):
                op, _, k = item.partition("@")
                lst.append({"kv_op": op.strip(), "on_call": int(k or 1)})
        elif kind == "kv_delay":
            lst = spec.setdefault(kind, [])
            for item in _items(arg):
                ms, _, k = item.partition("@")
                lst.append({"delay_ms": float(ms or 100.0), "on_call": int(k or 1)})
        elif kind == "partition_host":
            lst = spec.setdefault(kind, [])
            for item in _items(arg):
                h, _, rest = item.partition("@")
                k, _, s = rest.partition("x")
                lst.append({"host": h.strip(), "on_call": int(k or 1), "heal_s": float(s or 2.0)})
        elif kind == "kill_coordinator":
            _, _, k = arg.partition("@")
            spec[kind] = {"on_write": int(k or 1)}
    return spec


class FaultInjector:
    """One parsed spec and the per-process call counts that make every
    trigger deterministic."""

    def __init__(self, spec: Dict[str, Any]):
        self.spec = dict(spec or {})
        fleet = sorted(k for k in self.spec if k in FLEET_FAULT_KINDS)
        if fleet:
            raise NotImplementedError(
                f"fault_injection {fleet}: the learner fleet's KV control plane they arm is "
                f"not ported yet: {_FLEET_ITEM}"
            )
        self._learn_calls = 0
        self._thread_steps = 0
        self._fired: set = set()
        # monotonic deadline of an injected preemption (None: no notice)
        self._preempt_deadline: Optional[float] = None

    @staticmethod
    def _as_list(v) -> List[Dict]:
        if v is None:
            return []
        if isinstance(v, dict):
            return [v]
        return list(v)

    def _match_once(self, key: str, entry: Dict) -> bool:
        """True once per (key, entry)."""
        tag = (key, tuple(sorted(entry.items())))
        if tag in self._fired:
            return False
        self._fired.add(tag)
        return True

    def _entries(self, key: str, worker_index: int, call_n: int):
        for entry in self._as_list(self.spec.get(key)):
            if (int(entry.get("worker_index", -1)) == worker_index
                    and int(entry.get("on_call", 1)) == call_n):
                yield entry

    # -- the rollout worker's side -----------------------------------------

    def on_sample(self, worker_index: int, call_n: int) -> None:
        """Consulted by ``RolloutWorker.sample`` with the worker's own
        1-based call count. May sleep, arm a preemption, or end the
        process at once (``os._exit``: no exception, no cleanup, as an
        OOM kill; the main process sees the actor's death)."""
        for entry in self._entries("delay_sample", worker_index, call_n):
            if self._match_once("delay_sample", entry):
                time.sleep(float(entry.get("delay_s", 1.0)))
        for entry in self._entries("preempt_worker", worker_index, call_n):
            if self._match_once("preempt_worker", entry):
                # the notice: this sample completes, the process ends
                # grace_s from now
                grace = float(entry.get("grace_s", 10.0))
                self._preempt_deadline = time.monotonic() + grace
                _arm_exit_timer(grace)
        for _ in self._entries("kill_worker", worker_index, call_n):
            os._exit(1)

    def preemption_notice(self) -> Optional[float]:
        """Seconds of grace left before the injected preemption ends
        this process, or None when no notice is out."""
        if self._preempt_deadline is None:
            return None
        return max(0.0, self._preempt_deadline - time.monotonic())

    # -- the main process's learn ------------------------------------------------

    def on_learn(self, batch=None) -> None:
        """Consulted once per main-process learn call, before the batch
        reaches the policy: counts the call, then raises
        :class:`InjectedCrash` or poisons the host batch in place."""
        self._learn_calls += 1
        crash = self.spec.get("crash_learner")
        if (crash and int(crash.get("on_learn_call", 1)) == self._learn_calls
                and self._match_once("crash_learner", crash)):
            raise InjectedCrash(f"injected learner crash on learn call {self._learn_calls}")
        nan = self.spec.get("nan_batch")
        if (nan is not None and batch is not None
                and int(nan.get("on_learn_call", 1)) == self._learn_calls
                and self._match_once("nan_batch", nan)):
            self._corrupt(batch, nan.get("value", "nan"))

    @staticmethod
    def _corrupt(batch, value: str = "nan") -> None:
        """Poison the first float column of ``batch`` (a SampleBatch, a
        dict of arrays, every policy batch of a MultiAgentBatch) in a
        copy of the column; a uint8 frame pool stays clean."""
        bad = np.inf if value == "inf" else np.nan
        policy_batches = getattr(batch, "policy_batches", None)
        for b in list(policy_batches.values()) if policy_batches is not None else [batch]:
            for k in list(b.keys()) if hasattr(b, "keys") else []:
                v = b[k]
                if isinstance(v, np.ndarray) and np.issubdtype(v.dtype, np.floating) and v.size:
                    v = v.copy()
                    v.flat[0] = bad
                    b[k] = v
                    break

    # -- the learner thread ------------------------------------------------

    def on_learner_thread_step(self) -> None:
        """Consulted by ``LearnerThread.step``: raises on the matching
        step, so the thread dies as it would of a bug."""
        self._thread_steps += 1
        crash = self.spec.get("crash_learner_thread")
        if (crash and int(crash.get("on_step", 1)) == self._thread_steps
                and self._match_once("crash_learner_thread", crash)):
            raise InjectedCrash(f"injected learner-thread crash on step {self._thread_steps}")


def from_config(config: Optional[Dict]) -> Optional[FaultInjector]:
    """The injector of ``config["fault_injection"]`` (a dict or a spec
    string), else of ``RAY_TPU_FAULTS`` when the config has no spec at
    all; None when no fault is asked for. An empty spec (``{}``)
    disarms the variable too: the replacements' config."""
    spec = (config or {}).get("fault_injection")
    if spec is None:
        text = os.environ.get("RAY_TPU_FAULTS", "").strip()
        if text:
            spec = _parse_env_spec(text)
    if not spec:
        return None
    if isinstance(spec, str):
        spec = _parse_env_spec(spec)
    return FaultInjector(spec)
