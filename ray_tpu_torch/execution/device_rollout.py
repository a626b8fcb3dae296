"""Device rollout engine: act → step → auto-reset (→ GAE) on the card.

Counterpart of ``ray_tpu/execution/jax_rollout.py`` (``JaxRolloutEngine``),
following its order: per step, the act forward (actions, logp, logits,
value), the batched env step, a reset of every row and a select for the
rows that finished (the terminal-observation contract of
``env/tensor_env.py``), and a fresh ``V(next_obs)`` forward for the
bootstraps. After T steps: ``next_values`` (the act-path value of the
next row inside an episode, the fresh value at a boundary and at the
tail), :func:`compute_gae_fragment` (the GAE kernel on CUDA),
standardisation of the advantages with the population variance and
``max(1e-4, std)``, and env-major (N·T, ...) rows, the host lane's
concat order. The rollout never leaves the device; only the (T, N)
episode metrics are read back, once per rollout, or once per superstep
of K rollouts (:meth:`DeviceRolloutEngine.superstep_feed`, the feed of
``TorchPolicy.learn_rollout_superstep``). The carry (env state, obs,
episode return and length) is written in place, so a CUDA graph of the
slot advances it on every replay.

``postprocess="none"`` (the replay fill of the off-policy family) emits
the raw transition rows instead: no ``V(next_obs)`` forward and no GAE.

Randomness comes from the policy's action generator and the engine's
env generator; :class:`RolloutDraws` injects both instead (tests).
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.data.sample_batch import SampleBatch
from ray_tpu_torch.env.tensor_env import TensorVectorEnv, tree_where, where_rows
from ray_tpu_torch.evaluation.metrics import RolloutMetrics
from ray_tpu_torch.ops.gae import compute_gae_fragment
from ray_tpu_torch.telemetry import metrics as telemetry_metrics
from ray_tpu_torch.util import tracing

# columns the PPO-family learn call drops (its loss never reads them)
_LEARN_DROP = (SampleBatch.NEXT_OBS, SampleBatch.AGENT_INDEX, SampleBatch.T)


class RolloutSuperstepFeed(NamedTuple):
    """What ``TorchPolicy.learn_rollout_superstep`` runs in each slot:
    ``body(coeffs) -> (learn batch, (T, 3, N) metrics)``, the carry it
    advances in place, a cache key for the slot's graph and the
    engine's generators (which a graph must advance on each replay)."""

    carry: Dict
    body: Callable
    key: Tuple
    generators: Tuple[torch.Generator, ...]


class RolloutDraws(NamedTuple):
    """Injected randomness for one rollout of T steps over N envs."""

    # (T, N) actions taken instead of sampled ones; None samples
    actions: Optional[torch.Tensor]
    # (T, N, num_draws) env draws of each step and of each step's reset
    step: torch.Tensor
    reset: torch.Tensor


class DeviceRolloutEngine:
    """One policy + one TensorVectorEnv with N env slots on the
    policy's device. ``seed`` seeds the env generator (default 0);
    ``initial_draws`` replaces the first reset's draws; ``postprocess``
    is ``"gae"`` (on-policy batches) or ``"none"`` (raw transitions)."""

    def __init__(
        self,
        policy,
        env: TensorVectorEnv,
        num_envs: int,
        rollout_length: int,
        *,
        seed: Optional[int] = None,
        initial_draws: Optional[torch.Tensor] = None,
        postprocess: str = "gae",
    ):
        if policy.model.is_recurrent:
            raise ValueError(
                "config.env_backend='jax' but the device rollout lane is unavailable: policy "
                f"{type(policy).__name__} cannot lower its act path (recurrent model)"
            )
        from ray_tpu_torch.utils.exploration.exploration import postprocesses

        if postprocesses(policy.exploration):
            raise ValueError(
                "config.env_backend='jax' but the device rollout lane is unavailable: "
                f"exploration {type(policy.exploration).__name__} trains its own nets in "
                "postprocess_trajectory, which the device lane never runs (the reference's "
                "lane skips it silently); use the actor lane"
            )
        if postprocess not in ("gae", "none"):
            raise ValueError(f"unknown postprocess {postprocess!r}")
        self.postprocess = postprocess
        self.policy = policy
        self.env = env
        self.device = policy.device
        self.N = int(num_envs)
        self.T = int(rollout_length)
        self.batch_size = self.N * self.T
        self.gamma = float(policy.config.get("gamma", 0.99))
        self.lambda_ = float(policy.config.get("lambda", 1.0))
        self.env_generator = torch.Generator(device=self.device)
        self.env_generator.manual_seed(0 if seed is None else int(seed))
        self._metrics: List[RolloutMetrics] = []

        state = env.init(self.N, self.device)
        if initial_draws is None:
            initial_draws = self._draw()
        state, obs = env.reset(state, initial_draws.to(self.device))
        # the carry owns its memory: rollouts write it in place
        self.carry = {
            "env": {k: v.clone() for k, v in state.items()},
            "obs": obs.clone(),
            "ep_ret": torch.zeros(self.N, device=self.device),
            "ep_len": torch.zeros(self.N, dtype=torch.int32, device=self.device),
        }

    def _draw(self) -> torch.Tensor:
        return self.env.draw(self.env_generator, self.N, self.device)

    @torch.no_grad()
    def rollout(self, draws: Optional[RolloutDraws] = None) -> Tuple[Dict[str, torch.Tensor], int]:
        """T steps on the device: ``(batch of (N·T, ...) columns,
        batch_size)``, with the carry advanced and episode metrics
        absorbed (one readback)."""
        policy = self.policy
        policy.exploration.update_coeffs(policy.coeff_values, policy.global_timestep)
        with tracing.start_span("rollout:device", num_envs=self.N, steps=self.T):
            batch, met = self._rollout_slot(policy.coeff_values, draws)
            met = met.cpu()
        self._record_metrics(met)
        telemetry_metrics.inc_env_steps_on_device(self.batch_size)
        return batch, self.batch_size

    @torch.no_grad()
    def _rollout_slot(
        self, coeffs: Dict, draws: Optional[RolloutDraws] = None
    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """The rollout with no host work: ``(batch, (T, 3, N) metrics of
        (return, length, done))``. The carry's tensors are written in
        place, so a CUDA graph of a superstep slot (``superstep_feed``)
        reads and advances the same memory on every replay."""
        policy, env = self.policy, self.env
        c = self.carry
        state, obs, ep_ret, ep_len = c["env"], c["obs"], c["ep_ret"], c["ep_len"]
        steps: List[Dict[str, torch.Tensor]] = []
        met: List[Tuple[torch.Tensor, ...]] = []
        for t in range(self.T):
            given = None if draws is None or draws.actions is None else draws.actions[t]
            actions, _, extra = policy._action_step_body(
                obs, policy.action_generator, explore=True, actions=given, coeffs=coeffs
            )
            step_draws = self._draw() if draws is None else draws.step[t]
            state2, obs2, rew, term, trunc = env.step(state, actions, step_draws)
            done = term | trunc
            reset_draws = self._draw() if draws is None else draws.reset[t]
            state3, obs3 = env.reset(state2, reset_draws)
            rew = rew.float()
            ep_ret2 = ep_ret + rew
            ep_len2 = ep_len + 1
            steps.append({
                SampleBatch.OBS: obs,
                SampleBatch.NEXT_OBS: obs2,
                SampleBatch.ACTIONS: actions,
                SampleBatch.REWARDS: rew,
                SampleBatch.TERMINATEDS: term,
                SampleBatch.TRUNCATEDS: trunc,
                SampleBatch.T: ep_len,
                **extra,
            })
            if self.postprocess == "gae":
                # fresh V(final obs) for boundary and tail bootstraps
                steps[-1]["_v_next"] = policy.model_forward(obs2)[1]
            met.append((
                torch.where(done, ep_ret2, 0.0),
                torch.where(done, ep_len2, 0).float(),
                done.float(),
            ))
            state = tree_where(done, state3, state2)
            obs = where_rows(done, obs3, obs2)
            ep_ret = torch.where(done, 0.0, ep_ret2)
            ep_len = torch.where(done, 0, ep_len2)

        rows = {k: torch.stack([s[k] for s in steps]) for k in steps[0]}  # (T, N, ...)
        rows[SampleBatch.AGENT_INDEX] = torch.arange(
            self.N, dtype=torch.int32, device=self.device
        ).expand(self.T, self.N)
        if self.postprocess == "gae":
            self._gae(rows)
        batch = {
            k: v.transpose(0, 1).reshape((self.batch_size,) + v.shape[2:])
            for k, v in rows.items()
        }
        # the carry advances in place, after every read of its old rows
        for k, v in state.items():
            c["env"][k].copy_(v)
        for k, v in (("obs", obs), ("ep_ret", ep_ret), ("ep_len", ep_len)):
            c[k].copy_(v)
        return batch, torch.stack([torch.stack(m) for m in met])

    def superstep_feed(self) -> RolloutSuperstepFeed:
        """The feed of ``TorchPolicy.learn_rollout_superstep``: the slot
        body (rollout, then the learn columns) and the carry it advances
        in place. The exploration coefficients advance once here, for
        the whole superstep."""
        policy = self.policy
        policy.exploration.update_coeffs(policy.coeff_values, policy.global_timestep)

        def body(coeffs):
            batch, met = self._rollout_slot(coeffs)
            return self.learn_batch(batch), met

        return RolloutSuperstepFeed(
            carry=self.carry,
            body=body,
            key=("device_rollout", id(self), self.N, self.T, self.postprocess),
            generators=(self.env_generator,),
        )

    def advance(self, carry: Dict, metrics: np.ndarray) -> None:
        """Absorb a superstep's drained (k, T, 3, N) host metrics; the
        carry was advanced in place by the slots and is this engine's."""
        if carry is not self.carry:
            raise ValueError("advance: the carry is not this engine's")
        for met in metrics:
            self._record_metrics(torch.from_numpy(np.ascontiguousarray(met)))
        telemetry_metrics.inc_env_steps_on_device(int(np.asarray(metrics)[:, :, 2].size))

    def _gae(self, rows: Dict[str, torch.Tensor]) -> None:
        """Advantages and value targets of (T, N) rows, in place."""
        values = rows[SampleBatch.VF_PREDS]
        fresh = rows.pop("_v_next")
        term = rows[SampleBatch.TERMINATEDS]
        done = term | rows[SampleBatch.TRUNCATEDS]
        # interior rows reuse the act-path values; boundary and tail
        # rows use the fresh terminal-observation values
        shifted = torch.cat([values[1:], fresh[-1:]], dim=0)
        next_values = torch.where(done, fresh, shifted)
        adv, vt = compute_gae_fragment(
            rows[SampleBatch.REWARDS].T, values.T, next_values.T,
            term.T, done.T, self.gamma, self.lambda_,
        )  # (N, T)
        m = adv.mean()
        var = ((adv - m) ** 2).mean()
        adv = (adv - m) / torch.clamp_min(torch.sqrt(var), 1e-4)
        rows[SampleBatch.ADVANTAGES] = adv.T
        rows[SampleBatch.VALUE_TARGETS] = vt.T

    def learn_batch(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The learn-column subset of a :meth:`rollout` batch."""
        return {k: v for k, v in batch.items() if k not in _LEARN_DROP}

    def _record_metrics(self, met: torch.Tensor) -> None:
        """``met``: (T, 3, N) host tensor of (return, length, done)."""
        ret, length, done = met.permute(1, 0, 2).reshape(3, -1)
        mask = done > 0
        for r, n in zip(ret[mask].tolist(), length[mask].tolist()):
            self._metrics.append(RolloutMetrics(int(n), float(r)))

    def get_metrics(self) -> List[RolloutMetrics]:
        out = self._metrics
        self._metrics = []
        return out
