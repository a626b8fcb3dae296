"""Algorithm: owns the env, the policy and the training loop.

Counterpart of ``ray_tpu/algorithms/algorithm.py``. On the device lane
(``env_backend: "jax"``) it holds one env and one policy. On the actor
lane (any other ``env_backend``, for an algorithm whose training step
has one: ``_actor_lane``) it builds a ``WorkerSet``: a local worker whose
policy is the learner (``self.policy``, on the algorithm's device) and
``num_workers`` remote rollout workers on the CPU; episode metrics come
from every worker's ``get_metrics`` and ``stop()`` ends the workers'
processes. ``train()`` runs ``training_step`` until the iteration has
lasted ``min_time_s_per_iteration`` seconds and sampled
``min_sample_timesteps_per_iteration`` env steps (by default one step;
IMPALA's asynchronous step returns whatever is ready, and its config
asks for 1 s) and returns a result dict with the reference's keys
(``episode_reward_mean``, ``episodes_this_iter``,
``num_env_steps_sampled``, ``timesteps_total``, ``training_iteration``,
``info/learner/default_policy``, ...).
``__getstate__``/``__setstate__`` carry the policy state and counters
(the off-policy family adds its replay buffer).
"""

from __future__ import annotations

import collections
import time
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch import core as ray_core
from ray_tpu_torch.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.data.sample_batch import DEFAULT_POLICY_ID
from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.env.registry import get_env_creator
from ray_tpu_torch.evaluation.metrics import summarize_episodes
from ray_tpu_torch.evaluation.worker_set import WorkerSet
from ray_tpu_torch.sharding.superstep import resolve_superstep

NUM_ENV_STEPS_SAMPLED = "num_env_steps_sampled"
NUM_AGENT_STEPS_SAMPLED = "num_agent_steps_sampled"
NUM_ENV_STEPS_TRAINED = "num_env_steps_trained"
NUM_AGENT_STEPS_TRAINED = "num_agent_steps_trained"


def _refuse_unported_surface(config: Dict) -> None:
    """The reference acts on these keys (callbacks on every lane, the
    evaluation workers every ``evaluation_interval`` iterations); the
    port refuses them until they are ported, on both lanes."""
    for key, what in (
        ("callbacks_class", "callbacks"),
        ("evaluation_interval", "evaluation (evaluation_interval)"),
    ):
        if config.get(key) is not None:
            raise NotImplementedError(
                f"{what} are not ported yet: ROADMAP.md queue 1 item 3c"
            )


class Algorithm:
    _default_policy_class = None
    # whether training_step has an actor-lane path (PPO); the others
    # keep the device lane's construction and raise in training_step
    _actor_lane = False

    @classmethod
    def get_default_config(cls) -> AlgorithmConfig:
        return AlgorithmConfig(cls)

    def __init__(self, config=None, env=None):
        if isinstance(config, AlgorithmConfig):
            config = config.to_dict()
        config = dict(config or {})
        if env is not None:
            config["env"] = env
        if "lambda_" in config:  # the config object's spelling
            config["lambda"] = config.pop("lambda_")
        self.config = {**self.get_default_config().to_dict(), **config}
        _refuse_unported_surface(self.config)
        self.device = resolve_device(self.config.get("device"))
        self._iteration = 0
        self._counters: Dict[str, int] = collections.defaultdict(int)
        self._episode_history: List = []
        self._episodes_total = 0
        self._extra_metric_sources: List[Callable[[], List]] = []
        self._timers: Dict[str, float] = collections.defaultdict(float)
        self._rollout_engine = None
        self.workers = None
        # id(remote worker) -> its pending get_metrics ref (_remote_episodes)
        self._metrics_refs: Dict[int, Any] = {}

        env_spec = self.config.get("env")
        if env_spec is None:
            raise ValueError("config has no 'env'")
        policy_cls = self._default_policy_class
        if self._actor_lane and self.config.get("env_backend") != "jax":
            self.workers = WorkerSet(
                env_creator=get_env_creator(env_spec), policy_cls=policy_cls,
                config=self.config, num_workers=int(self.config.get("num_workers", 0)),
                device=self.device,
            )
            local = self.workers.local_worker()
            self.env = local.env
            self.policy = local.policy()
            return
        self.env = get_env_creator(env_spec)(dict(self.config.get("env_config") or {}))
        self.policy = policy_cls(
            self.env.observation_space, self.env.action_space,
            self.config, device=self.device,
        )

    def get_policy(self, policy_id: str = DEFAULT_POLICY_ID):
        return self.policy

    def _resolve_superstep_k(self) -> int:
        """K of the superstep for this run (``resolve_superstep``, cached)."""
        k = self.__dict__.get("_superstep_k")
        if k is None:
            k = self._superstep_k = resolve_superstep(self.config, self.device)
        return k

    def training_step(self) -> Dict:
        raise NotImplementedError

    def train(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        min_t = self.config.get("min_time_s_per_iteration")
        min_ts = self.config.get("min_sample_timesteps_per_iteration") or 0
        ts_before = self._counters[NUM_ENV_STEPS_SAMPLED]
        train_info: Dict = {}
        while True:
            info = self.training_step()
            if info:
                train_info = info
            done_t = min_t is None or time.perf_counter() - t0 >= min_t
            if done_t and self._counters[NUM_ENV_STEPS_SAMPLED] - ts_before >= min_ts:
                break
        self._iteration += 1
        results: Dict[str, Any] = {
            "info": {"learner": train_info, **self._counters},
        }
        results.update(self._collect_rollout_metrics())
        learn_timers = getattr(self.policy, "last_learn_timers", None)
        if learn_timers:
            results["info"]["timers"] = {DEFAULT_POLICY_ID: dict(learn_timers)}
        if self._timers:
            results["timers"] = dict(self._timers)
        results[NUM_ENV_STEPS_TRAINED] = self._counters[NUM_ENV_STEPS_TRAINED]
        results[NUM_ENV_STEPS_SAMPLED] = self._counters[NUM_ENV_STEPS_SAMPLED]
        results["timesteps_total"] = self._counters[NUM_ENV_STEPS_SAMPLED]
        results["training_iteration"] = self._iteration
        results["time_this_iter_s"] = time.perf_counter() - t0
        return results

    def _metrics_may_lag(self) -> bool:
        """Whether the workers' episode metrics are taken without waiting
        (the asynchronous paths, whose workers always have sample
        requests queued)."""
        return False

    def _remote_episodes(self) -> List:
        """The remote workers' finished episodes. A worker runs its calls
        in order, so a ``get_metrics`` call waits behind the sample
        requests queued before it: the synchronous round has none left
        and waits for the answers; an asynchronous path
        (:meth:`_metrics_may_lag`) takes the answers that are in and
        leaves the others for the next iteration, instead of stopping
        the main thread behind the workers' queues. On the synchronous
        round a dead worker's metrics raise, as its samples did; an
        asynchronous path skips them, since its sampling drops and
        reports a dead worker (IMPALA's ``_handle_dead_workers``)."""
        pending = self._metrics_refs
        live = {id(w): w for w in self.workers.remote_workers()}
        for wid in [k for k in pending if k not in live]:
            del pending[wid]
        for wid, w in live.items():
            if wid not in pending:
                pending[wid] = w.get_metrics.remote()
        refs = list(pending.values())
        if refs:
            ray_core.wait(refs, num_returns=len(refs), timeout=0 if self._metrics_may_lag() else None)
        episodes = []
        for wid, ref in list(pending.items()):
            done, _ = ray_core.wait([ref], timeout=0)
            if not done:
                continue
            del pending[wid]
            try:
                episodes.extend(ray_core.get(ref))
            except (ray_core.RayActorError, ray_core.WorkerCrashedError):
                if not self._metrics_may_lag():
                    raise
        return episodes

    def _collect_rollout_metrics(self) -> Dict:
        episodes = []
        if self.workers is not None:
            episodes.extend(self._remote_episodes())
            episodes.extend(self.workers.local_worker().get_metrics())
        for src in self._extra_metric_sources:
            episodes.extend(src())
        self._episode_history.extend(episodes)
        window = self.config.get("metrics_num_episodes_for_smoothing", 100)
        self._episode_history = self._episode_history[-window:]
        summary = summarize_episodes(self._episode_history)
        summary["episodes_this_iter"] = len(episodes)
        self._episodes_total += len(episodes)
        summary["episodes_total"] = self._episodes_total
        return summary

    # -- checkpoint state ----------------------------------------------------

    def __getstate__(self) -> Dict:
        """Policy state, counters and episode total (host numpy only)."""
        return {
            "policy": self.get_policy().get_state(),
            "counters": dict(self._counters),
            "episodes_total": self._episodes_total,
            "iteration": self._iteration,
        }

    def __setstate__(self, state: Dict) -> None:
        self.get_policy().set_state(state["policy"])
        self._counters = collections.defaultdict(int, state.get("counters", {}))
        self._episodes_total = state.get("episodes_total", 0)
        self._iteration = state.get("iteration", 0)

    def stop(self) -> None:
        """Stop the workers and end the remote workers' processes."""
        if self.workers is not None:
            self.workers.stop()
