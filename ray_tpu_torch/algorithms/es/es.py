"""Evolution Strategies (ES) and Augmented Random Search (ARS).

Counterpart of ``ray_tpu/algorithms/es/es.py``. Perturbation rollouts
run on ES actors of the port's runtime, on the CPU as rollout workers
do: each holds an env (built through the port's env registry, so
``CartPole-v1`` is the port's own and needs no gymnasium), the catalog
model, a ``MeanStdFilter`` and its own :class:`SharedNoiseTable`
re-derived from the table's seed. The driver's update is host numpy,
the reference's code: antithetic returns → centered ranks → the
rank-weighted sum of the noise rows, L2 decay and :class:`_FlatAdam`
(ES), or the top-k directions scaled by the used rewards' std and plain
SGD (ARS). The driver's policy, which evaluation, checkpoints and
serving read, lives on the card.

The flat parameter vector is the reference's ``ravel_pytree`` order
(:class:`FlatParams`): the flax layouts (dense kernels (in, out), conv
kernels HWIO) of every leaf, leaves in the flax tree's sorted key order,
so one theta means the same weights in both packages and the noise
rows, the optimizer's moments and checkpoints index it alike.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch import core
from ray_tpu_torch.algorithms.algorithm import (
    NUM_AGENT_STEPS_SAMPLED,
    NUM_ENV_STEPS_SAMPLED,
    Algorithm,
)
from ray_tpu_torch.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.env.registry import get_env_creator
from ray_tpu_torch.evaluation.metrics import RolloutMetrics
from ray_tpu_torch.models.catalog import ModelCatalog
from ray_tpu_torch.policy.torch_policy import TorchPolicy
from ray_tpu_torch.utils.filter import get_filter


class SharedNoiseTable:
    """A deterministic Gaussian noise table: every process re-derives it
    from the seed instead of shipping it (the reference's code)."""

    def __init__(self, count: int = 25_000_000, seed: int = 42):
        self.noise = np.random.RandomState(seed).randn(count).astype(np.float32)

    def get(self, i: int, dim: int) -> np.ndarray:
        return self.noise[i: i + dim]

    def sample_index(self, rng: np.random.RandomState, dim: int) -> int:
        return int(rng.randint(0, len(self.noise) - dim + 1))


def compute_centered_ranks(x: np.ndarray) -> np.ndarray:
    """Ranks scaled to [-0.5, 0.5] (the reference's code)."""
    flat = x.ravel()
    ranks = np.empty(flat.size, dtype=np.float32)
    ranks[flat.argsort()] = np.arange(flat.size, dtype=np.float32)
    ranks = ranks.reshape(x.shape)
    return ranks / (x.size - 1) - 0.5


class FlatParams:
    """A module's parameters as one float32 vector in the reference's
    ``ravel_pytree`` order: each leaf in its flax layout (a 2-D
    ``weight`` as the (in, out) ``kernel``, a 4-D one as HWIO, a
    ``bias`` as it is), the leaves sorted by their flax path."""

    def __init__(self, module: torch.nn.Module):
        entries = []
        for name, p in module.named_parameters():
            parts = name.split(".")
            leaf = {"weight": "kernel"}.get(parts[-1], parts[-1])
            entries.append((tuple(parts[:-1]) + (leaf,), p))
        entries.sort(key=lambda e: e[0])
        self.params = [p for _, p in entries]
        self.paths = [path for path, _ in entries]
        self.size = sum(p.numel() for p in self.params)

    @staticmethod
    def _to_flax(p: torch.Tensor) -> torch.Tensor:
        if p.ndim == 2:
            return p.t()
        if p.ndim == 4:  # OIHW → HWIO
            return p.permute(2, 3, 1, 0)
        return p

    def get(self) -> np.ndarray:
        return np.concatenate([
            self._to_flax(p.detach()).cpu().numpy().astype(np.float32).ravel()
            for p in self.params
        ]).astype(np.float32)

    @torch.no_grad()
    def set(self, flat: np.ndarray) -> None:
        flat = np.asarray(flat, np.float32)
        if flat.size != self.size:
            raise ValueError(f"flat vector of {flat.size} values for {self.size} parameters")
        off = 0
        for p in self.params:
            shape = tuple(self._to_flax(p).shape)
            n = p.numel()
            v = torch.from_numpy(flat[off: off + n].reshape(shape).copy())
            if p.ndim == 2:
                v = v.t()
            elif p.ndim == 4:  # HWIO → OIHW
                v = v.permute(3, 2, 0, 1)
            p.copy_(v)
            off += n


class ESConfig(AlgorithmConfig):
    """The reference's ESConfig."""

    def __init__(self, algo_class=None):
        super().__init__(algo_class or ES)
        self.num_workers = 2
        self.episodes_per_batch = 40
        self.train_batch_size = 2000  # min timesteps an iteration
        self.noise_stdev = 0.02
        self.stepsize = 0.01
        self.l2_coeff = 0.005
        self.eval_prob = 0.03
        self.noise_size = 25_000_000
        self.report_length = 10
        self.observation_filter = "MeanStdFilter"
        self.model = {"fcnet_hiddens": [64, 64], "fcnet_activation": "tanh"}

    def training(
        self,
        *,
        episodes_per_batch: Optional[int] = None,
        noise_stdev: Optional[float] = None,
        stepsize: Optional[float] = None,
        l2_coeff: Optional[float] = None,
        eval_prob: Optional[float] = None,
        noise_size: Optional[int] = None,
        **kwargs,
    ) -> "ESConfig":
        super().training(**kwargs)
        for name, value in (
            ("episodes_per_batch", episodes_per_batch),
            ("noise_stdev", noise_stdev),
            ("stepsize", stepsize),
            ("l2_coeff", l2_coeff),
            ("eval_prob", eval_prob),
            ("noise_size", noise_size),
        ):
            if value is not None:
                setattr(self, name, value)
        return self


class ARSConfig(ESConfig):
    """The reference's ARSConfig."""

    def __init__(self, algo_class=None):
        super().__init__(algo_class or ARS)
        self.num_rollouts = 32  # directions an iteration
        self.rollouts_used = 32  # top-k directions kept
        self.sgd_stepsize = 0.01
        self.noise_stdev = 0.02
        self.eval_prob = 0.0

    def training(
        self,
        *,
        num_rollouts: Optional[int] = None,
        rollouts_used: Optional[int] = None,
        sgd_stepsize: Optional[float] = None,
        **kwargs,
    ) -> "ARSConfig":
        super().training(**kwargs)
        for name, value in (
            ("num_rollouts", num_rollouts),
            ("rollouts_used", rollouts_used),
            ("sgd_stepsize", sgd_stepsize),
        ):
            if value is not None:
                setattr(self, name, value)
        return self


class ESTorchPolicy(TorchPolicy):
    """The evaluated policy: the catalog model, moved by flat-vector
    updates, never by a loss."""

    def loss(self, batch, coeffs):
        raise NotImplementedError("ES updates parameters via evolution")

    def _flat(self) -> FlatParams:
        flat = self.__dict__.get("_flat_params")
        if flat is None:
            flat = self._flat_params = FlatParams(self.model)
        return flat

    def get_flat_weights(self) -> np.ndarray:
        return self._flat().get()

    def set_flat_weights(self, flat: np.ndarray) -> None:
        self._flat().set(flat)


class _RolloutEngine:
    """Env, model and filter of a perturbation worker, on the CPU: the
    env through the port's registry, the model the catalog's, its
    weights a flat vector (:class:`FlatParams`), greedy actions."""

    def __init__(self, config: Dict, env_spec):
        self.env = get_env_creator(env_spec)(config.get("env_config") or {})
        model_config = dict(config.get("model") or {})
        self.dist_class, num_outputs = ModelCatalog.get_action_dist(
            self.env.action_space, model_config)
        self.model = ModelCatalog.get_model(
            self.env.observation_space, self.env.action_space, num_outputs, model_config,
            generator=torch.Generator().manual_seed(int(config.get("seed") or 0)),
        )
        self.flat = FlatParams(self.model)
        self.num_params = self.flat.size
        self.filter = get_filter(config.get("observation_filter", "MeanStdFilter"),
                                 self.env.observation_space.shape)

    @torch.no_grad()
    def act(self, obs: np.ndarray) -> np.ndarray:
        """The greedy action of one observation (a batch of rows gives a
        batch)."""
        x = torch.as_tensor(np.asarray(obs, np.float32))
        single = x.ndim == len(self.env.observation_space.shape)
        dist_inputs = self.model(x[None] if single else x)[0]
        actions = self.dist_class(dist_inputs).deterministic_sample().numpy()
        return actions[0] if single else actions

    def rollout(self, flat_params: np.ndarray, update_filter: bool = True) -> Tuple[float, int]:
        self.flat.set(flat_params)
        obs, _ = self.env.reset()
        total, steps = 0.0, 0
        done = False
        while not done:
            fobs = self.filter(np.asarray(obs, np.float32), update=update_filter)
            obs, reward, terminated, truncated, _ = self.env.step(self.act(fobs))
            total += float(reward)
            steps += 1
            done = terminated or truncated
        return total, steps


@core.remote
class _ESWorker:
    """A perturbation-rollout actor (the reference's ``Worker``)."""

    def __init__(self, config: Dict, env_spec, worker_seed: int):
        torch.set_num_threads(max(1, int(config.get("num_cpus_per_worker", 1) or 1)))
        self.config = dict(config)
        self.engine = _RolloutEngine(self.config, env_spec)
        self.noise = SharedNoiseTable(int(config.get("noise_size", 25_000_000)))
        self.rng = np.random.RandomState(worker_seed)
        self.stdev = float(config.get("noise_stdev", 0.02))
        self.eval_prob = float(config.get("eval_prob", 0.0))

    def do_rollouts(self, flat_params: np.ndarray, filter_state, num_pairs: int) -> Dict:
        if filter_state is not None:
            self.engine.filter.sync(filter_state)
        self.engine.filter.clear_buffer()
        flat_params = np.asarray(flat_params, np.float32)
        dim = flat_params.size
        indices: List[int] = []
        pos_returns: List[float] = []
        neg_returns: List[float] = []
        eval_returns: List[float] = []
        steps = 0
        lengths: List[int] = []
        for _ in range(num_pairs):
            if self.eval_prob and self.rng.rand() < self.eval_prob:
                ret, n = self.engine.rollout(flat_params, update_filter=False)
                eval_returns.append(ret)
                steps += n
                continue
            idx = self.noise.sample_index(self.rng, dim)
            pert = self.stdev * self.noise.get(idx, dim)
            r_pos, n_pos = self.engine.rollout(flat_params + pert)
            r_neg, n_neg = self.engine.rollout(flat_params - pert)
            indices.append(idx)
            pos_returns.append(r_pos)
            neg_returns.append(r_neg)
            lengths += [n_pos, n_neg]
            steps += n_pos + n_neg
        return {
            "indices": indices,
            "pos_returns": pos_returns,
            "neg_returns": neg_returns,
            "lengths": lengths,
            "eval_returns": eval_returns,
            "steps": steps,
            "filter_buffer": self.engine.filter.as_serializable(),
        }

    def ping(self) -> str:
        return "pong"


class _FlatAdam:
    """Adam on the flat parameter vector (the reference's code)."""

    def __init__(self, dim: int, stepsize: float):
        self.m = np.zeros(dim, np.float32)
        self.v = np.zeros(dim, np.float32)
        self.t = 0
        self.stepsize = stepsize
        self.beta1, self.beta2, self.eps = 0.9, 0.999, 1e-8

    def update(self, theta: np.ndarray, grad: np.ndarray) -> np.ndarray:
        self.t += 1
        self.m = self.beta1 * self.m + (1 - self.beta1) * grad
        self.v = self.beta2 * self.v + (1 - self.beta2) * grad * grad
        a = self.stepsize * np.sqrt(1 - self.beta2 ** self.t) / (1 - self.beta1 ** self.t)
        return theta - a * self.m / (np.sqrt(self.v) + self.eps)


class ES(Algorithm):
    """The driver: theta, the noise table, the filter and the optimizer
    on the host, the ES actors' rollouts, the policy on the card. Its
    worker set is the local worker alone (evaluation and checkpoints);
    ``num_workers`` counts the ES actors. ``last_iteration`` holds the
    last step's gathered indices, returns and steps."""

    _default_policy_class = ESTorchPolicy
    _actor_lane = True

    @classmethod
    def get_default_config(cls) -> ESConfig:
        return ESConfig(cls)

    def __init__(self, config=None, env=None):
        cfg = config.to_dict() if isinstance(config, AlgorithmConfig) else dict(config or {})
        merged = {**self.get_default_config().to_dict(), **cfg}
        self._es_num_workers = max(1, int(merged.get("num_workers", 2)))
        super().__init__({**cfg, "num_workers": 0}, env)
        config = self.config
        policy = self.get_policy()
        self._theta = policy.get_flat_weights()
        self.noise = SharedNoiseTable(int(config.get("noise_size", 25_000_000)))
        self._filter = get_filter(config.get("observation_filter", "MeanStdFilter"),
                                  policy.observation_space.shape)
        self._optimizer = _FlatAdam(self._theta.size, float(config.get("stepsize", 0.01)))
        seed = int(config.get("seed") or 0)
        worker_config = {k: v for k, v in config.items()
                         if not k.startswith("_") and k != "device"}
        if not core.is_initialized():
            core.init()
        self._es_workers = [
            _ESWorker.remote(worker_config, config.get("env"), seed * 1000 + i)
            for i in range(self._es_num_workers)
        ]
        self._eval_returns: List[float] = []
        self._es_episodes: List[RolloutMetrics] = []
        self._extra_metric_sources.append(self._take_es_episodes)

    def _take_es_episodes(self) -> List[RolloutMetrics]:
        out, self._es_episodes = self._es_episodes, []
        return out

    def _pairs_per_iteration(self) -> int:
        return max(1, int(self.config.get("episodes_per_batch", 40)) // 2)

    def _collect(self, num_pairs_total: int) -> List[Dict]:
        per = -(-num_pairs_total // len(self._es_workers))
        filter_state = self._filter.as_serializable()
        refs = [w.do_rollouts.remote(self._theta, filter_state, per) for w in self._es_workers]
        return core.get(refs)

    def _gather_iteration(self) -> Dict:
        """Rollouts until both the episode floor (``episodes_per_batch``)
        and the timestep floor (``train_batch_size``) are met; the
        workers' results merged, their filter deltas added, their
        episodes recorded."""
        pairs_target = self._pairs_per_iteration()
        min_steps = int(self.config.get("train_batch_size", 0) or 0)
        agg = {"indices": [], "pos": [], "neg": [], "steps": 0}
        self._eval_returns = []
        while True:
            remaining = max(1, pairs_target - len(agg["indices"]))
            for r in self._collect(remaining):
                agg["indices"] += list(r["indices"])
                agg["pos"] += list(r["pos_returns"])
                agg["neg"] += list(r["neg_returns"])
                agg["steps"] += r["steps"]
                self._eval_returns += list(r["eval_returns"])
                self._filter.apply_changes(r["filter_buffer"], with_buffer=False)
                lens = list(r.get("lengths", []))
                rets = list(r["pos_returns"]) + list(r["neg_returns"])
                lens = lens[0::2] + lens[1::2]  # pos-then-neg order
                lens += [0] * (len(rets) - len(lens))
                for ret, ln in zip(rets, lens):
                    self._es_episodes.append(RolloutMetrics(ln, ret))
            if len(agg["indices"]) >= pairs_target and agg["steps"] >= min_steps:
                break
        self._counters[NUM_ENV_STEPS_SAMPLED] += agg["steps"]
        self._counters[NUM_AGENT_STEPS_SAMPLED] += agg["steps"]
        # the learned normalization where checkpoints and evaluation read it
        for f in self.workers.local_worker().filters.values():
            f.sync(self._filter.as_serializable())
        return agg

    def _apply_results(self, agg: Dict) -> Dict:
        """The centered-rank weighted noise update with L2 decay, by
        :class:`_FlatAdam` (the reference's code)."""
        cfg = self.config
        stdev = float(cfg.get("noise_stdev", 0.02))
        indices, pos, neg = agg["indices"], agg["pos"], agg["neg"]
        if not indices:
            return {"episodes_this_iter": 0}
        returns = np.stack([np.asarray(pos, np.float32), np.asarray(neg, np.float32)], axis=1)
        ranks = compute_centered_ranks(returns)
        weights = ranks[:, 0] - ranks[:, 1]
        dim = self._theta.size
        rows = np.stack([self.noise.get(i, dim) for i in indices])
        grad = weights @ rows / (len(indices) * stdev)
        update = -grad + float(cfg.get("l2_coeff", 0.005)) * self._theta
        self._theta = self._optimizer.update(self._theta, update)
        self.get_policy().set_flat_weights(self._theta)
        return {
            "episodes_this_iter": 2 * len(indices),
            "weights_norm": float(np.linalg.norm(self._theta)),
            "grad_norm": float(np.linalg.norm(grad)),
            "update_ratio": float(np.linalg.norm(self._optimizer.m)
                                  / (np.linalg.norm(self._theta) + 1e-8)),
            "noise_std": stdev,
            "mean_pos_return": float(np.mean(pos)),
            "mean_neg_return": float(np.mean(neg)),
            "episode_reward_mean_perturbed": float(np.mean(returns)),
        }

    def training_step(self) -> Dict:
        agg = self._gather_iteration()
        self.last_iteration = agg
        info = self._apply_results(agg)
        if self._eval_returns:
            info["eval_reward_mean"] = float(np.mean(self._eval_returns))
        return info

    # -- checkpoint state ----------------------------------------------------

    def __getstate__(self) -> Dict:
        state = super().__getstate__()
        state["es"] = {
            "theta": self._theta,
            "optimizer": dict(self._optimizer.__dict__),
            "filter": self._filter.as_serializable(),
        }
        return state

    def __setstate__(self, state: Dict) -> None:
        super().__setstate__(state)
        es = state.get("es")
        if es:
            self._theta = np.asarray(es["theta"], np.float32)
            self._optimizer.__dict__.update(es["optimizer"])
            self._filter.sync(es["filter"])
            self.get_policy().set_flat_weights(self._theta)

    def stop(self) -> None:
        """End the ES actors' processes, then the worker set's."""
        for w in getattr(self, "_es_workers", []):
            try:
                core.kill(w)
            except Exception:
                pass
        self._es_workers = []
        super().stop()


class ARS(ES):
    """ES with the top-k directions by ``max(pos, neg)``, the update
    scaled by the used rewards' std, and plain SGD (the reference's
    code)."""

    @classmethod
    def get_default_config(cls) -> ARSConfig:
        return ARSConfig(cls)

    def _pairs_per_iteration(self) -> int:
        return max(1, int(self.config.get("num_rollouts", 32)))

    def _apply_results(self, agg: Dict) -> Dict:
        cfg = self.config
        stdev = float(cfg.get("noise_stdev", 0.02))
        indices, pos, neg = agg["indices"], agg["pos"], agg["neg"]
        if not indices:
            return {"episodes_this_iter": 0}
        pos_a = np.asarray(pos, np.float32)
        neg_a = np.asarray(neg, np.float32)
        k = min(int(cfg.get("rollouts_used", len(indices))), len(indices))
        order = np.argsort(-np.maximum(pos_a, neg_a))[:k]
        used_rewards = np.concatenate([pos_a[order], neg_a[order]])
        reward_std = max(float(used_rewards.std()), 1e-6)
        dim = self._theta.size
        rows = np.stack([self.noise.get(indices[i], dim) for i in order])
        grad = (pos_a[order] - neg_a[order]) @ rows / (k * reward_std)
        self._theta = self._theta + float(cfg.get("sgd_stepsize", 0.01)) * grad
        self.get_policy().set_flat_weights(self._theta)
        return {
            "episodes_this_iter": 2 * len(indices),
            "weights_norm": float(np.linalg.norm(self._theta)),
            "grad_norm": float(np.linalg.norm(grad)),
            "reward_std": reward_std,
            "noise_std": stdev,
            "mean_pos_return": float(np.mean(pos_a)),
            "mean_neg_return": float(np.mean(neg_a)),
            "episode_reward_mean_perturbed": float(np.mean(np.stack([pos_a, neg_a]))),
        }
