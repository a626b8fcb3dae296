"""Algorithm: owns the env, the policy and the training loop.

Counterpart of ``ray_tpu/algorithms/algorithm.py``, slimmed to one local
policy and no worker fleet: ``train()`` runs one ``training_step`` and
returns a result dict with the reference's keys (``episode_reward_mean``,
``episodes_this_iter``, ``num_env_steps_sampled``, ``timesteps_total``,
``training_iteration``, ``info/learner/default_policy``, ...).
``__getstate__``/``__setstate__`` carry the policy state and counters
(the off-policy family adds its replay buffer).
"""

from __future__ import annotations

import collections
import time
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.data.sample_batch import DEFAULT_POLICY_ID
from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.env.registry import get_env_creator
from ray_tpu_torch.evaluation.metrics import summarize_episodes
from ray_tpu_torch.sharding.superstep import resolve_superstep

NUM_ENV_STEPS_SAMPLED = "num_env_steps_sampled"
NUM_AGENT_STEPS_SAMPLED = "num_agent_steps_sampled"
NUM_ENV_STEPS_TRAINED = "num_env_steps_trained"
NUM_AGENT_STEPS_TRAINED = "num_agent_steps_trained"


class Algorithm:
    _default_policy_class = None

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
        self.device = resolve_device(self.config.get("device"))
        self._iteration = 0
        self._counters: Dict[str, int] = collections.defaultdict(int)
        self._episode_history: List = []
        self._episodes_total = 0
        self._extra_metric_sources: List[Callable[[], List]] = []
        self._rollout_engine = None

        env_spec = self.config.get("env")
        if env_spec is None:
            raise ValueError("config has no 'env'")
        self.env = get_env_creator(env_spec)(dict(self.config.get("env_config") or {}))
        policy_cls = self._default_policy_class
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
        train_info = self.training_step()
        self._iteration += 1
        results: Dict[str, Any] = {
            "info": {"learner": train_info, **self._counters},
        }
        results.update(self._collect_rollout_metrics())
        results[NUM_ENV_STEPS_TRAINED] = self._counters[NUM_ENV_STEPS_TRAINED]
        results[NUM_ENV_STEPS_SAMPLED] = self._counters[NUM_ENV_STEPS_SAMPLED]
        results["timesteps_total"] = self._counters[NUM_ENV_STEPS_SAMPLED]
        results["training_iteration"] = self._iteration
        results["time_this_iter_s"] = time.perf_counter() - t0
        return results

    def _collect_rollout_metrics(self) -> Dict:
        episodes = []
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
        """Nothing to release: no worker processes in this slice."""
