"""RolloutWorker: env + policies + sampler, local or as an actor.

Counterpart of ``ray_tpu/evaluation/rollout_worker.py``. The same class
is the main process's local worker, whose policies are the learners (on
the algorithm's device: the card unless the config says ``device:
"cpu"``), and each remote rollout actor (``worker_index > 0``), whose
policies are built with ``device="cpu"`` in a process that cannot see
the card (``core/worker_proc.py``), as the reference pins its actors to
the CPU. A remote worker bounds its torch threads to
``num_cpus_per_worker`` (the reference's key and default, 1), so
several workers and the learner share the host's cores.

The worker holds a policy map. Without ``policy_specs`` it is one
policy of ``policy_cls`` under ``DEFAULT_POLICY_ID`` on the env's spaces
(the config's ``observation_space``/``action_space`` win), sampled by a
``SyncSampler`` over a vector env. ``policy_specs`` (``{pid: (cls,
obs_space, act_space, config_overrides)}``, built by ``Algorithm``)
gives one policy, preprocessor and filter per id; with a
``MultiAgentEnv`` the ``MultiAgentSyncSampler`` drives them through
``policy_mapping_fn``. ``learn_on_batch`` of a ``MultiAgentBatch``
learns the policies of ``policies_to_train`` (all, when unset), each on
its own batch.

``callbacks_class`` (the config's) is built once per worker and handed
to the ``SyncSampler``, whose episode hooks run on this worker; the
``MultiAgentSyncSampler`` takes none, as the reference's. ``save()``
returns ``{"policy_states", "filters"}`` (the reference's layout) and
``restore(state)`` loads it back.

``sample_async`` gives a remote worker an ``AsyncSampler``: a thread
samples while the worker answers calls, and ``set_weights`` /
``set_global_vars`` take the sampler's lock, so the thread's act step
never reads a half-copied net. The local worker (index 0) samples
synchronously: beside remote workers it does not sample, and without
them its policy is the learner, which ``Algorithm`` refuses to give a
sampling thread (``refuse_local_async``). ``stop()`` ends the thread
before it closes the envs.

Offline data and external envs, as the reference's worker wires them:
a callable ``config["input"]`` is called with an io context
(``worker``, ``config``, ``worker_index``) and returns a reader whose
``next()`` replaces the sampler (no sampler is built; ``get_metrics``
is the reader's, and ``stop`` calls its ``shutdown``): the external
envs' ``PolicyServerInput``. A reader's ``lock`` (the server's act
lock) is the worker's: ``learn_on_batch``, ``set_weights``,
``set_global_vars`` and ``restore`` hold it, and an algorithm that
learns the local worker's policy another way holds it too, or refuses
the reader (``refuse_local_input_reader``). A path as ``input`` is the offline
algorithms' to read, not the worker's. ``config["output"]`` (a
directory) mirrors every batch ``sample()`` returns into a
``JsonWriter``'s shards of ``output_max_file_size`` bytes.

A tensor env (``TensorVectorEnv``, the device lane's) is driven through
one ``TensorVectorEnvAdapter`` of ``num_envs_per_worker`` slots on the
worker's device, seeded as the worker's envs are, as the reference
wires its ``JaxVectorEnvAdapter``: evaluation workers of a device-lane
run sample this way.

The resilience layer's hooks (``resilience/faults.py``): with a fault
spec (``config["fault_injection"]`` or ``RAY_TPU_FAULTS``) each
``sample`` call is counted and handed to the injector, which may delay
it, announce a preemption or end the process; ``preemption_notice``
reads the injector's notice, else the provider's
(``resilience/provider_notice.py``); ``drain_for_preemption`` hands
over the worker's flushed filter deltas and episodes before the fleet
controller ends it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import contextlib
from types import SimpleNamespace

import numpy as np

from ray_tpu_torch.data.sample_batch import DEFAULT_POLICY_ID, MultiAgentBatch
from ray_tpu_torch.env.env_context import EnvContext
from ray_tpu_torch.env.multi_agent_env import MultiAgentEnv
from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.env.tensor_env import TensorVectorEnv, TensorVectorEnvAdapter
from ray_tpu_torch.env.vector_env import VectorEnv
from ray_tpu_torch.evaluation.multi_agent_sampler import MultiAgentSyncSampler
from ray_tpu_torch.evaluation.sampler import AsyncSampler, SyncSampler
from ray_tpu_torch.models.catalog import ModelCatalog
from ray_tpu_torch.resilience import faults, provider_notice
from ray_tpu_torch.util import tracing
from ray_tpu_torch.utils.filter import get_filter


def refuse_local_async(config: Dict) -> None:
    """``sample_async`` with no remote worker: the sampling thread would
    act on the learner's own policy while its optimizer writes the
    parameters in place (the reference's arrays are immutable, so its
    thread reads whole weights). The port's own refusal."""
    if config.get("sample_async") and not int(config.get("num_workers") or 0):
        raise ValueError(
            "sample_async needs remote rollout workers (num_workers > 0): the port does not "
            "run a sampling thread on the learner's own policy, whose parameters the "
            "optimizer updates in place"
        )


def refuse_local_input_reader(config: Dict, learns_under_act_lock: bool) -> None:
    """A callable ``input`` (an input reader that acts on the worker's
    policy from its own threads, as ``PolicyServerInput`` does) on a
    learner's only worker, for an algorithm whose learn does not hold the
    worker's act lock: the reader would act while the optimizer writes
    the parameters in place. The port's own refusal."""
    if (callable(config.get("input")) and not int(config.get("num_workers") or 0)
            and not learns_under_act_lock):
        raise ValueError(
            "a callable input on the learner's own worker (num_workers=0) needs an algorithm "
            "whose learn holds the worker's act lock (PPO, DQN, SAC, DDPG, TD3); give this "
            "one remote rollout workers to serve from"
        )


def _default_mapping_fn(agent_id, **kwargs):
    return DEFAULT_POLICY_ID


class RolloutWorker:
    def __init__(
        self,
        *,
        env_creator: Optional[Callable] = None,
        policy_cls=None,
        policy_specs: Optional[Dict] = None,
        policy_mapping_fn: Optional[Callable] = None,
        config: Optional[Dict] = None,
        worker_index: int = 0,
        num_workers: int = 0,
        device=None,
    ):
        self.config = dict(config or {})
        # the chaos hooks: None (no cost) unless a fault spec arms them
        self._fault_injector = faults.from_config(self.config)
        self._num_sample_calls = 0
        self.worker_index = worker_index
        self.num_workers = num_workers
        self.global_vars: Dict[str, Any] = {"timestep": 0}
        if worker_index > 0:
            import torch

            torch.set_num_threads(int(self.config.get("num_cpus_per_worker", 1)))
            device = "cpu"
        self.device = device

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
        self.env = None
        self.vector_env = None
        self._multiagent_env = False
        if env_creator is not None:
            num_envs = int(self.config.get("num_envs_per_worker", 1))

            def make_sub_env(vector_index):
                return env_creator(env_config.copy_with_overrides(vector_index=vector_index))

            self.env = make_sub_env(0)
            self._multiagent_env = isinstance(self.env, MultiAgentEnv)
            if isinstance(self.env, TensorVectorEnv):
                self.vector_env = TensorVectorEnvAdapter(
                    self.env, num_envs, seed=seed, device=resolve_device(device)
                )
            elif not self._multiagent_env:
                envs = [self.env] + [make_sub_env(i) for i in range(1, num_envs)]
                self.vector_env = VectorEnv.vectorize_gym_envs(
                    lambda i: envs[i], num_envs, seed=seed
                )

        # ---- policies ----
        self.policy_map: Dict[str, Any] = {}
        self.filters: Dict[str, Any] = {}
        self.preprocessor = None  # the default policy's
        self.policy_mapping_fn = policy_mapping_fn or _default_mapping_fn
        if policy_specs is None and policy_cls is not None:
            obs_space = self.config.get("observation_space") or self.env.observation_space
            act_space = self.config.get("action_space") or self.env.action_space
            policy_specs = {DEFAULT_POLICY_ID: (policy_cls, obs_space, act_space, {})}
        for pid, (cls, obs_space, act_space, overrides) in (policy_specs or {}).items():
            self.add_policy(pid, cls, obs_space, act_space, overrides)

        # ---- input reader (external envs): replaces the sampler ----
        self.input_reader = None
        self._output_writer = None
        inp = self.config.get("input")
        if callable(inp):
            self.input_reader = inp(
                SimpleNamespace(worker=self, config=self.config, worker_index=worker_index)
            )

        # ---- sampler ----
        self.sampler = None
        self.callbacks = None
        if self.input_reader is None and self.vector_env is not None and self.policy_map:
            if DEFAULT_POLICY_ID not in self.policy_map:
                raise ValueError(
                    f"policies {sorted(self.policy_map)} need a MultiAgentEnv; "
                    f"{type(self.env).__name__} is a single-agent env"
                )
            cb_cls = self.config.get("callbacks_class")
            self.callbacks = cb_cls() if cb_cls else None
            sampler_cls = SyncSampler
            if self.config.get("sample_async") and worker_index > 0:
                sampler_cls = AsyncSampler
            self.sampler = sampler_cls(
                vector_env=self.vector_env,
                callbacks=self.callbacks,
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
        elif self.input_reader is None and self._multiagent_env:
            # as the reference's: the preprocessors of the policies'
            # (already preprocessed) spaces, the rest of the actor
            # lane's keys unread
            self.sampler = MultiAgentSyncSampler(
                env=self.env,
                policy_map=self.policy_map,
                policy_mapping_fn=self.policy_mapping_fn,
                preprocessors={
                    pid: ModelCatalog.get_preprocessor_for_space(p.observation_space)
                    for pid, p in self.policy_map.items()
                },
                obs_filters=self.filters,
                rollout_fragment_length=int(self.config.get("rollout_fragment_length", 200)),
                batch_mode=self.config.get("batch_mode", "truncate_episodes"),
            )

    def add_policy(
        self,
        policy_id: str,
        policy_cls,
        observation_space,
        action_space,
        config_overrides: Optional[Dict] = None,
        weights=None,
    ) -> None:
        """A policy into the map (its preprocessor and filter with it),
        built from the worker's config and ``config_overrides``; the
        mapping fn can route agents to it from their next episode."""
        pol_config = {
            **self.config,
            **(config_overrides or {}),
            "worker_index": self.worker_index,
            "num_workers": self.num_workers,
        }
        prep = ModelCatalog.get_preprocessor_for_space(observation_space)
        eff_obs_space = prep.observation_space
        if policy_id == DEFAULT_POLICY_ID:
            self.preprocessor = prep
        self.policy_map[policy_id] = policy_cls(
            eff_obs_space, action_space, pol_config, device=self.device
        )
        self.filters[policy_id] = get_filter(
            self.config.get("observation_filter", "NoFilter"), eff_obs_space.shape
        )
        if weights is not None:
            self.policy_map[policy_id].set_weights(weights)

    def set_policy_mapping_fn(self, fn: Callable) -> None:
        """A new mapping fn; it takes effect at the next episode (the
        sampler asks it once per agent and episode), so no trajectory
        is split between two policies."""
        self.policy_mapping_fn = fn
        if isinstance(self.sampler, MultiAgentSyncSampler):
            self.sampler.policy_mapping_fn = fn

    # -- sampling --------------------------------------------------------

    def sample(self):
        """The sampler's next batch (the input reader's, when there is
        one), written to the ``output`` shards when that is set. The
        call is counted and handed to the fault injector first."""
        self._num_sample_calls += 1
        if self._fault_injector is not None:
            self._fault_injector.on_sample(self.worker_index, self._num_sample_calls)
        with tracing.start_span("rollout:sample", worker_index=self.worker_index) as span:
            if self.input_reader is not None:
                batch = self.input_reader.next()
            else:
                batch = self.sampler.sample()
            span.set_attribute("env_steps", int(batch.env_steps()))
        out = self.config.get("output")
        if out:
            if self._output_writer is None:
                from ray_tpu_torch.offline.json_writer import JsonWriter

                self._output_writer = JsonWriter(
                    out, max_file_size=int(self.config.get("output_max_file_size", 64 * 1024 * 1024))
                )
            self._output_writer.write(batch)
        return batch

    def sample_with_count(self):
        batch = self.sample()
        return batch, batch.env_steps()

    # -- preemption and drain ----------------------------------------------

    def preemption_notice(self) -> Optional[float]:
        """Seconds of grace left before this worker's preemption ends its
        process, or None: the injector's notice, else the provider's
        probe. The fleet controller polls it."""
        if self._fault_injector is not None:
            grace = self._fault_injector.preemption_notice()
            if grace is not None:
                return grace
        return provider_notice.probe()

    def drain_for_preemption(self) -> Dict[str, Any]:
        """A graceful exit: the flushed filter deltas and the episodes not
        yet harvested. A worker runs its calls in order, so every sample
        sent before this one has finished and its result is in."""
        return {
            "filters": self.get_filters(flush_after=True),
            "metrics": self.get_metrics(),
            "num_sample_calls": self._num_sample_calls,
        }

    def get_metrics(self) -> List:
        if self.input_reader is not None:
            get = getattr(self.input_reader, "get_metrics", None)
            return get() if get is not None else []
        return self.sampler.get_metrics() if self.sampler is not None else []

    # -- learning --------------------------------------------------------

    def policy(self, pid: str = DEFAULT_POLICY_ID):
        return self.policy_map[pid]

    def learn_on_batch(self, samples) -> Dict:
        """One learn call per policy batch of a ``MultiAgentBatch``, for
        the policies of ``policies_to_train`` (all when unset); a
        SampleBatch is the default policy's. Under the act lock: the
        optimizer writes the parameters in place."""
        with self.act_lock():
            if isinstance(samples, MultiAgentBatch):
                to_train = self.config.get("policies_to_train")
                return {
                    pid: self.policy_map[pid].learn_on_batch(batch)
                    for pid, batch in samples.policy_batches.items()
                    if pid in self.policy_map and (to_train is None or pid in to_train)
                }
            return {DEFAULT_POLICY_ID: self.policy_map[DEFAULT_POLICY_ID].learn_on_batch(samples)}

    def compute_gradients(self, samples):
        """The default policy's ``(gradients, stats)`` on ``samples`` (a
        ``MultiAgentBatch`` gives its default policy's batch), as the
        reference's."""
        if isinstance(samples, MultiAgentBatch):
            samples = samples.policy_batches[DEFAULT_POLICY_ID]
        with self.act_lock():
            return self.policy_map[DEFAULT_POLICY_ID].compute_gradients(samples)

    def apply_gradients(self, grads) -> None:
        """One optimizer step of the default policy on ``grads``, under
        the act lock: the step writes the parameters in place."""
        with self.act_lock():
            self.policy_map[DEFAULT_POLICY_ID].apply_gradients(grads)

    # -- weights and filters ---------------------------------------------

    def get_weights(self, policies: Optional[List[str]] = None, inference_only: bool = False) -> Dict:
        """The weights of ``policies`` (every policy when None);
        ``inference_only``: only what acting reads
        (``get_inference_weights``: SAC's actor)."""
        return {
            pid: p.get_inference_weights() if inference_only else p.get_weights()
            for pid, p in self.policy_map.items()
            if policies is None or pid in policies
        }

    def act_lock(self):
        """The lock of whatever acts on this worker's policies from
        another thread: the input reader's (a ``PolicyServerInput``'s
        handler threads) or the sampling thread's; none without one."""
        return (getattr(self.input_reader, "lock", None) or getattr(self.sampler, "lock", None)
                or contextlib.nullcontext())

    def set_weights(self, weights: Dict, global_vars: Optional[Dict] = None) -> None:
        with self.act_lock():
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
        with self.act_lock():
            for p in self.policy_map.values():
                p.on_global_var_update(global_vars)

    # -- checkpoint state --------------------------------------------------

    def save(self) -> Dict:
        """Every policy's state and every filter (host objects only)."""
        return {
            "policy_states": {pid: p.get_state() for pid, p in self.policy_map.items()},
            "filters": self.get_filters(),
        }

    def restore(self, state: Dict) -> None:
        with self.act_lock():
            for pid, s in state.get("policy_states", {}).items():
                if pid in self.policy_map:
                    self.policy_map[pid].set_state(s)
        self.sync_filters(state.get("filters", {}))

    # -- the rest --------------------------------------------------------

    def apply(self, fn: Callable, *args, **kwargs):
        return fn(self, *args, **kwargs)

    def foreach_env(self, fn: Callable) -> List:
        return [fn(e) for e in self._sub_envs()]

    def _sub_envs(self) -> List:
        if self.vector_env is not None:
            return self.vector_env.get_sub_environments()
        return [self.env] if self.env is not None else []

    def foreach_policy(self, fn: Callable) -> List:
        return [fn(p, pid) for pid, p in self.policy_map.items()]

    def stop(self) -> None:
        # the sampling thread first: it steps the envs closed below
        stop = getattr(self.sampler, "stop", None)
        if stop is not None:
            stop()
        shutdown = getattr(self.input_reader, "shutdown", None)
        if shutdown is not None:
            shutdown()
        if self._output_writer is not None:
            self._output_writer.close()
        for e in self._sub_envs():
            close = getattr(e, "close", None)
            if close is not None:
                close()

    def ping(self) -> str:
        return "pong"
