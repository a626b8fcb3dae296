"""RolloutWorker: env + policy + sampler, local or as an actor.

Counterpart of ``ray_tpu/evaluation/rollout_worker.py``, single-agent.
The same class is the main process's local worker, whose policy is the
learner (on the algorithm's device: the card unless the config says
``device: "cpu"``), and each remote rollout actor (``worker_index >
0``), whose policy is built with ``device="cpu"`` in a process that
cannot see the card (``core/worker_proc.py``), as the reference pins its
actors to the CPU. A remote worker bounds its torch threads to
``num_cpus_per_worker`` (the reference's key and default, 1), so
several workers and the learner share the host's cores.

Not ported (``ROADMAP.md`` queue 1 item 3), each raising where a config
asks for it: multi-agent (``policies``), ``input``/``output`` readers
and writers, the fault injector (``fault_injection``), ``sample_async``
and tensor envs on the actor lane (the reference's
``JaxVectorEnvAdapter``; the port's tensor envs run on the device lane,
``env_backend: jax``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ray_tpu_torch.data.sample_batch import DEFAULT_POLICY_ID
from ray_tpu_torch.env.env_context import EnvContext
from ray_tpu_torch.env.tensor_env import TensorVectorEnv
from ray_tpu_torch.env.vector_env import VectorEnv
from ray_tpu_torch.evaluation.sampler import SyncSampler
from ray_tpu_torch.models.catalog import ModelCatalog
from ray_tpu_torch.utils.filter import get_filter

_ITEM = "ROADMAP.md queue 1 item 3"


def _refuse_unported(config: Dict) -> None:
    for key, what, item in (
        ("policies", "multi-agent policies", _ITEM),
        ("input", "input readers", _ITEM),
        ("output", "output writers", _ITEM),
        ("fault_injection", "the fault injector", _ITEM),
        ("sample_async", "AsyncSampler (sample_async)", "ROADMAP.md queue 1 item 5"),
    ):
        if config.get(key):
            raise NotImplementedError(f"{what} on the actor lane are not ported yet: {item}")


class RolloutWorker:
    def __init__(
        self,
        *,
        env_creator: Callable,
        policy_cls,
        config: Optional[Dict] = None,
        worker_index: int = 0,
        num_workers: int = 0,
        device=None,
    ):
        self.config = dict(config or {})
        _refuse_unported(self.config)
        self.worker_index = worker_index
        self.num_workers = num_workers
        self.global_vars: Dict[str, Any] = {"timestep": 0}
        if worker_index > 0:
            import torch

            torch.set_num_threads(int(self.config.get("num_cpus_per_worker", 1)))
            device = "cpu"

        env_config = EnvContext(
            self.config.get("env_config") or {},
            worker_index=worker_index,
            num_workers=num_workers,
        )
        seed = self.config.get("seed")
        if seed is not None:
            seed = seed + worker_index * 1000
            # third-party envs (gymnasium's classics) draw from the global
            # stream; the port's own code threads explicit generators
            np.random.seed(seed)

        # ---- env ----
        num_envs = int(self.config.get("num_envs_per_worker", 1))

        def make_sub_env(vector_index):
            return env_creator(env_config.copy_with_overrides(vector_index=vector_index))

        self.env = make_sub_env(0)
        if isinstance(self.env, TensorVectorEnv):
            raise NotImplementedError(
                f"tensor env {type(self.env).__name__} on the actor lane (the reference's "
                f"JaxVectorEnvAdapter) is not ported yet: {_ITEM}; set env_backend='jax' "
                "to run it on the device lane"
            )
        envs = [self.env] + [make_sub_env(i) for i in range(1, num_envs)]
        self.vector_env = VectorEnv.vectorize_gym_envs(lambda i: envs[i], num_envs, seed=seed)

        # ---- policy ----
        pol_config = {**self.config, "worker_index": worker_index, "num_workers": num_workers}
        self.preprocessor = ModelCatalog.get_preprocessor_for_space(self.env.observation_space)
        eff_obs_space = self.preprocessor.observation_space
        self.policy_map: Dict[str, Any] = {
            DEFAULT_POLICY_ID: policy_cls(eff_obs_space, self.env.action_space, pol_config,
                                          device=device)
        }
        self.filters: Dict[str, Any] = {
            DEFAULT_POLICY_ID: get_filter(
                self.config.get("observation_filter", "NoFilter"), eff_obs_space.shape
            )
        }

        # ---- sampler ----
        self.sampler = SyncSampler(
            vector_env=self.vector_env,
            policy=self.policy_map[DEFAULT_POLICY_ID],
            preprocessor=self.preprocessor,
            obs_filter=self.filters[DEFAULT_POLICY_ID],
            rollout_fragment_length=int(self.config.get("rollout_fragment_length", 200)),
            batch_mode=self.config.get("batch_mode", "truncate_episodes"),
            episode_horizon=self.config.get("horizon"),
            clip_actions=self.config.get("clip_actions", False),
            normalize_actions=self.config.get("normalize_actions", True),
            flush_on_episode_end=not self.config.get("_fixed_unrolls", False),
        )

    # -- sampling --------------------------------------------------------

    def sample(self):
        return self.sampler.sample()

    def sample_with_count(self):
        batch = self.sample()
        return batch, batch.env_steps()

    def get_metrics(self) -> List:
        return self.sampler.get_metrics()

    # -- learning --------------------------------------------------------

    def policy(self, pid: str = DEFAULT_POLICY_ID):
        return self.policy_map[pid]

    def learn_on_batch(self, samples) -> Dict:
        return {DEFAULT_POLICY_ID: self.policy_map[DEFAULT_POLICY_ID].learn_on_batch(samples)}

    # -- weights and filters ---------------------------------------------

    def get_weights(self, inference_only: bool = False) -> Dict:
        """Every policy's weights; ``inference_only``: only what acting
        reads (``get_inference_weights``: SAC's actor)."""
        return {
            pid: p.get_inference_weights() if inference_only else p.get_weights()
            for pid, p in self.policy_map.items()
        }

    def set_weights(self, weights: Dict, global_vars: Optional[Dict] = None) -> None:
        for pid, w in weights.items():
            if pid in self.policy_map:
                self.policy_map[pid].set_weights(w)
        if global_vars:
            self.set_global_vars(global_vars)

    def get_filters(self, flush_after: bool = False) -> Dict:
        out = {pid: f.as_serializable() for pid, f in self.filters.items()}
        if flush_after:
            for f in self.filters.values():
                f.clear_buffer()
        return out

    def sync_filters(self, new_filters: Dict) -> None:
        for pid, f in new_filters.items():
            if pid in self.filters:
                self.filters[pid].sync(f)

    def set_global_vars(self, global_vars: Dict) -> None:
        self.global_vars.update(global_vars)
        for p in self.policy_map.values():
            p.on_global_var_update(global_vars)

    # -- the rest --------------------------------------------------------

    def apply(self, fn: Callable, *args, **kwargs):
        return fn(self, *args, **kwargs)

    def foreach_env(self, fn: Callable) -> List:
        return [fn(e) for e in self.vector_env.get_sub_environments()]

    def foreach_policy(self, fn: Callable) -> List:
        return [fn(p, pid) for pid, p in self.policy_map.items()]

    def stop(self) -> None:
        for e in self.vector_env.get_sub_environments():
            close = getattr(e, "close", None)
            if close is not None:
                close()

    def ping(self) -> str:
        return "pong"
