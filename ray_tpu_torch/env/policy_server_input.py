"""PolicyServerInput: serves actions to external envs over HTTP and reads
their episodes as sample batches.

Copy of ``ray_tpu/env/policy_server_input.py``, on the standard
library's ``ThreadingHTTPServer`` and JSON, with the reference's wire
format (``env/policy_client.py``). It is a worker's input reader:

    config.offline_data(input_=lambda ioctx: PolicyServerInput(ioctx, "127.0.0.1", 9900))

An env process starts an episode, asks for actions, logs rewards and
ends the episode. Actions are computed on-policy by the worker's default
policy (on its device: the card for a learner's local worker), after the
worker's preprocessor and observation filter, with ``explore`` set to
the episode's ``training_enabled``. Each row waits for the next
observation (its ``new_obs``); ``END_EPISODE`` closes the last row
(``terminateds`` True unless the client says ``truncated``), builds the
episode's batch (``eps_id`` from the episode id's hash, as the
reference's), postprocesses it with the policy (PPO: GAE) and queues
it. ``next()`` blocks until a batch is queued;
``get_metrics()`` hands over the finished episodes' lengths and
rewards; ``shutdown()`` stops the server. An episode with training
disabled is counted and not queued. Recurrent policies are refused, as
in the reference (no per-episode state across calls).

Handler threads filter, act and postprocess under :attr:`lock`, one at
a time (the filter's statistics and the policy's generator are not
thread-safe). The worker makes it its act lock: its ``learn_on_batch``,
``set_weights``, ``set_global_vars`` and ``restore`` hold it too, so no
action and no postprocessing reads parameters that the optimizer is
updating in place. A request that comes during a learn waits for it
(the reference's server answers from its immutable old arrays). Each
row keeps the log-probability and distribution inputs of the forward
that chose its action.
"""

from __future__ import annotations

import json
import queue
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np

from ray_tpu_torch.data.sample_batch import DEFAULT_POLICY_ID, SampleBatch
from ray_tpu_torch.evaluation.metrics import RolloutMetrics
from ray_tpu_torch.evaluation.sampler import postprocess_batch, transform_obs


class _EpisodeState:
    __slots__ = ("rows", "pending", "total_reward", "training")

    def __init__(self, training: bool = True):
        self.rows: List[Dict] = []
        self.pending: Optional[Dict] = None  # the row waiting for its next obs
        self.total_reward = 0.0
        self.training = training


class PolicyServerInput:
    def __init__(self, ioctx, address: str, port: int):
        self.worker = getattr(ioctx, "worker", None)
        policy_map = getattr(self.worker, "policy_map", None) or {}
        self.policy = policy_map.get(DEFAULT_POLICY_ID) or next(iter(policy_map.values()))
        if getattr(self.policy, "is_recurrent", False):
            raise ValueError(
                "PolicyServerInput does not support recurrent policies: per-episode state is "
                "not tracked across GET_ACTION calls (the reference's has the same limit)"
            )
        self.preprocessor = getattr(self.worker, "preprocessor", None)
        self.obs_filter = (getattr(self.worker, "filters", None) or {}).get(DEFAULT_POLICY_ID)
        self._episodes: Dict[str, _EpisodeState] = {}
        self._lock = threading.Lock()  # the episode table and the metrics
        # the worker's act lock: the filter, the policy's generator and
        # its parameters, shared with the worker's learn and weight writes
        self.lock = threading.RLock()
        self._batches: "queue.Queue" = queue.Queue()
        self._metrics: List[RolloutMetrics] = []

        server_self = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # no line per request
                pass

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                try:
                    out = server_self._handle(json.loads(self.rfile.read(length)))
                    blob = json.dumps(out).encode()
                    self.send_response(200)
                except Exception as e:  # the client's answer carries the error
                    blob = json.dumps({"error": repr(e)}).encode()
                    self.send_response(500)
                self.send_header("Content-Length", str(len(blob)))
                self.end_headers()
                self.wfile.write(blob)

        self._server = ThreadingHTTPServer((address, port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    # -- the protocol --------------------------------------------------------


    def _handle(self, req: Dict) -> Dict:
        cmd = req["command"]
        if cmd == "START_EPISODE":
            eid = req.get("episode_id") or uuid.uuid4().hex[:12]
            with self._lock:
                self._episodes[eid] = _EpisodeState(training=req.get("training_enabled", True))
            return {"episode_id": eid}
        ep = self._episodes.get(req["episode_id"])
        if ep is None:
            raise KeyError(f"unknown episode {req['episode_id']}")
        if cmd == "GET_ACTION":
            with self.lock:
                obs = transform_obs(self.preprocessor, self.obs_filter, np.asarray(req["observation"]))
                action, _, extra = self.policy.compute_single_action(obs, explore=ep.training)
            row = {
                SampleBatch.OBS: obs,
                SampleBatch.ACTIONS: np.asarray(action),
                SampleBatch.REWARDS: np.float32(0.0),
                SampleBatch.TERMINATEDS: np.bool_(False),
                SampleBatch.TRUNCATEDS: np.bool_(False),
            }
            for k, v in extra.items():
                row[k] = np.asarray(v)
            with self._lock:
                self._finish_pending(ep, obs)
                ep.pending = row
            return {"action": np.asarray(action).tolist()}
        if cmd == "LOG_RETURNS":
            with self._lock:
                if ep.pending is not None:
                    ep.pending[SampleBatch.REWARDS] = np.float32(
                        float(ep.pending[SampleBatch.REWARDS]) + float(req["reward"]))
                ep.total_reward += float(req["reward"])
            return {}
        if cmd == "END_EPISODE":
            truncated = bool(req.get("truncated", False))
            with self.lock:
                obs = transform_obs(self.preprocessor, self.obs_filter, np.asarray(req["observation"]))
                with self._lock:
                    self._finish_pending(ep, obs, done=True, truncated=truncated)
                    batch = self._build_episode_batch(req["episode_id"], ep)
                if batch is not None:
                    batch = postprocess_batch(self.policy, batch)
            if batch is not None:
                self._batches.put(batch)
            return {}
        raise ValueError(f"unknown command {cmd!r}")

    def _finish_pending(self, ep: _EpisodeState, next_obs, done: bool = False,
                        truncated: bool = False) -> None:
        if ep.pending is None:
            return
        row = ep.pending
        row[SampleBatch.NEXT_OBS] = np.asarray(next_obs, np.float32)
        if done:
            # a truncation keeps terminateds False: GAE bootstraps V(s_T)
            row[SampleBatch.TERMINATEDS] = np.bool_(not truncated)
            row[SampleBatch.TRUNCATEDS] = np.bool_(truncated)
        ep.rows.append(row)
        ep.pending = None

    def _build_episode_batch(self, eid: str, ep: _EpisodeState) -> Optional[SampleBatch]:
        """Under the lock: the episode out of the table, its metrics, and
        its columns (None when it has no rows or does not train)."""
        self._episodes.pop(eid, None)
        self._metrics.append(RolloutMetrics(len(ep.rows), ep.total_reward))
        if not ep.rows or not ep.training:
            return None
        cols = {k: np.stack([r[k] for r in ep.rows]) for k in ep.rows[0]}
        cols[SampleBatch.EPS_ID] = np.full(len(ep.rows), abs(hash(eid)) % (2 ** 31), np.int64)
        return SampleBatch(cols)

    # -- the input reader's surface -------------------------------------------

    def next(self) -> SampleBatch:
        """The next finished episode's batch (blocks until there is one)."""
        return self._batches.get()

    def get_metrics(self) -> List[RolloutMetrics]:
        with self._lock:
            out, self._metrics = self._metrics, []
        return out

    def shutdown(self) -> None:
        self._server.shutdown()
        self._server.server_close()
