"""RNNSAC: soft actor-critic with recurrent nets over replayed sequences.

Counterpart of ``ray_tpu/algorithms/sac/rnnsac.py``. The actor and each
of the twin Q functions carry an LSTM of their own (:class:`_RNNActorNet`,
:class:`_RNNTwinQNet`: a dense trunk, flax's ``OptimizedLSTMCell`` under
a reset-masked unroll from a zero carry, a head), with the reference's
parameter names (``fc_i``, ``_cell``, ``_head``; ``_fcs_q1_i``,
``_cells_q1``, ``_heads_q1``, ...).

The update is SAC's (:meth:`SACTorchPolicy._sac_update`, one call a
learn: no stacked learn, no superstep, as in the reference) made
sequence-shaped by its three hooks: the time-t forwards restart at the
sequence's ``resets``, the next-observation forwards also after a done
row; each net's forward takes its resets; every loss and the mean Q
average over the ``mask`` (the burn-in prefix and the padding out). Its
two normal draws are (B, T, action_dim). Acting steps the actor's cell
once with the carried ``(h, c)``, which the sampler keeps as
``state_in_0/1``.

``RNNSAC`` chops fragments into sequences as R2D2 does (with NEXT_OBS)
and learns on ``train_batch_size // replay_sequence_length`` uniformly
drawn sequences a step. It trains from zero initial states only
(``zero_init_states=False`` raises, as in the reference).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ray_tpu_torch.algorithms.algorithm import (
    NUM_ENV_STEPS_SAMPLED,
    NUM_ENV_STEPS_TRAINED,
    refuse_device_lane,
)
from ray_tpu_torch.algorithms.r2d2.r2d2 import SequenceReplayBuffer, chop_fragment_into_sequences
from ray_tpu_torch.algorithms.sac.sac import SAC, SACConfig, SACTorchPolicy
from ray_tpu_torch.data.sample_batch import DEFAULT_POLICY_ID, SampleBatch
from ray_tpu_torch.execution.rollout_ops import synchronous_parallel_sample
from ray_tpu_torch.models.base import Dense, TorchModel, get_activation
from ray_tpu_torch.models.distributions import SquashedGaussian
from ray_tpu_torch.models.rnn import OptimizedLSTMCell, lstm_unroll


def _seq_flat(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).reshape(x.shape[0], x.shape[1], -1)


def _zero_unroll(cell: OptimizedLSTMCell, x: torch.Tensor, resets: torch.Tensor,
                 cell_size: int) -> torch.Tensor:
    """The reset-masked unroll over (B, T, F) from a zero carry."""
    zeros = torch.zeros((x.shape[0], cell_size), dtype=torch.float32, device=x.device)
    return lstm_unroll(cell, x, zeros, zeros, resets)[0]


class _RNNActorNet(nn.Module):
    """Dense trunk → LSTM → ``2 * action_dim`` squashed-Gaussian inputs."""

    def __init__(self, obs_size: int, action_dim: int, hiddens: Sequence[int], cell_size: int,
                 activation: str, generator: Optional[torch.Generator]):
        super().__init__()
        self.act = get_activation(activation)
        self.num_hiddens = len(hiddens)
        self.cell_size = int(cell_size)
        sizes = [obs_size, *hiddens]
        for i in range(len(hiddens)):
            setattr(self, f"fc_{i}", Dense(sizes[i], sizes[i + 1], generator=generator))
        self._cell = OptimizedLSTMCell(sizes[-1], self.cell_size, generator)
        self._head = Dense(self.cell_size, 2 * action_dim, generator=generator)

    def _trunk(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_hiddens):
            x = self.act(getattr(self, f"fc_{i}")(x))
        return x

    def forward(self, obs: torch.Tensor, resets: torch.Tensor) -> torch.Tensor:
        """obs (B, T, ...), resets (B, T) → (B, T, 2A)."""
        y = _zero_unroll(self._cell, self._trunk(_seq_flat(obs)), resets, self.cell_size)
        return self._head(y)

    def step(self, obs: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
        """One acting step from the carried ``(h, c)``: ``(dist inputs
        (B, 2A), h, c)``."""
        x = self._trunk(obs.to(torch.float32).reshape(obs.shape[0], -1))
        y, (h, c) = lstm_unroll(self._cell, x[:, None], h, c)
        return self._head(y[:, 0]), h, c


class _RNNTwinQNet(nn.Module):
    """Two recurrent Q functions over (obs, action) sequences."""

    def __init__(self, in_size: int, hiddens: Sequence[int], cell_size: int, activation: str,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.act = get_activation(activation)
        self.num_hiddens = len(hiddens)
        self.cell_size = int(cell_size)
        sizes = [in_size, *hiddens]
        for name in ("q1", "q2"):
            for i in range(len(hiddens)):
                setattr(self, f"_fcs_{name}_{i}", Dense(sizes[i], sizes[i + 1], generator=generator))
            setattr(self, f"_cells_{name}", OptimizedLSTMCell(sizes[-1], self.cell_size, generator))
            setattr(self, f"_heads_{name}", Dense(self.cell_size, 1, generator=generator))

    def forward(self, obs: torch.Tensor, actions: torch.Tensor, resets: torch.Tensor):
        """→ (q1 (B, T), q2 (B, T))."""
        x0 = torch.cat([_seq_flat(obs), _seq_flat(actions)], dim=-1)
        qs = []
        for name in ("q1", "q2"):
            x = x0
            for i in range(self.num_hiddens):
                x = self.act(getattr(self, f"_fcs_{name}_{i}")(x))
            y = _zero_unroll(getattr(self, f"_cells_{name}"), x, resets, self.cell_size)
            qs.append(getattr(self, f"_heads_{name}")(y)[..., 0])
        return qs[0], qs[1]


class _RNNSACModel(TorchModel):
    """``actor`` (:class:`_RNNActorNet`), ``critic`` (:class:`_RNNTwinQNet`)
    and ``log_alpha``, as SAC's model names them."""

    def __init__(self, obs_size: int, action_dim: int, pm_cfg: Dict, qm_cfg: Dict,
                 initial_alpha: float, generator: Optional[torch.Generator]):
        super().__init__()
        self.actor = _RNNActorNet(
            obs_size, action_dim, tuple(pm_cfg.get("fcnet_hiddens", (256,))),
            int(pm_cfg.get("lstm_cell_size", 64)), pm_cfg.get("fcnet_activation", "relu"),
            generator,
        )
        self.critic = _RNNTwinQNet(
            obs_size + action_dim, tuple(qm_cfg.get("fcnet_hiddens", (256,))),
            int(qm_cfg.get("lstm_cell_size", 64)), qm_cfg.get("fcnet_activation", "relu"),
            generator,
        )
        self.log_alpha = nn.Parameter(torch.tensor(np.log(initial_alpha), dtype=torch.float32))


class RNNSACConfig(SACConfig):
    """The reference's RNNSACConfig."""

    def __init__(self, algo_class=None):
        super().__init__(algo_class or RNNSAC)
        self.replay_sequence_length = 20
        self.replay_burn_in = 0
        self.zero_init_states = True
        # sequences, about 40k transitions
        self.replay_buffer_config = {**(self.replay_buffer_config or {}), "capacity": 2000}
        self.policy_model_config = {**(self.policy_model_config or {}), "lstm_cell_size": 64}
        self.q_model_config = {**(self.q_model_config or {}), "lstm_cell_size": 64}

    def training(
        self,
        *,
        replay_sequence_length: Optional[int] = None,
        replay_burn_in: Optional[int] = None,
        **kwargs,
    ) -> "RNNSACConfig":
        super().training(**kwargs)
        if replay_sequence_length is not None:
            self.replay_sequence_length = replay_sequence_length
        if replay_burn_in is not None:
            self.replay_burn_in = replay_burn_in
        return self


class RNNSACTorchPolicy(SACTorchPolicy):
    """SAC's update over stacked (B, T) sequences; recurrent acting."""

    def _make_model(self, observation_space, action_space, num_outputs, generator):
        cfg = self.config
        return _RNNSACModel(
            int(np.prod(observation_space.shape)), self.action_dim,
            dict(cfg.get("policy_model_config") or {}), dict(cfg.get("q_model_config") or {}),
            float(cfg.get("initial_alpha", 1.0)), generator,
        )

    @property
    def supports_batched_serve(self) -> bool:
        return False

    def get_initial_state(self):
        return [np.zeros(self.actor.cell_size, np.float32),  # h
                np.zeros(self.actor.cell_size, np.float32)]  # c

    @torch.no_grad()
    def act_dist_signature(self):
        n = self.actor.cell_size
        obs = torch.zeros((1,) + tuple(self.observation_space.shape), device=self.device)
        zeros = torch.zeros((1, n), device=self.device)
        dist_inputs = self.actor.step(obs, zeros, zeros)[0]
        return SquashedGaussian, tuple(dist_inputs.shape[1:]), dist_inputs.dtype

    @torch.no_grad()
    def compute_actions(self, obs_batch, state_batches=None, prev_action_batch=None,
                        prev_reward_batch=None, explore: bool = True, **kwargs):
        """One recurrent step of the actor from ``state_batches`` (``[h,
        c]``, zeros when None): ``(actions, [h, c], {ACTION_LOGP})``."""
        self.exploration.update_coeffs(self.coeff_values, self.global_timestep)
        obs = torch.as_tensor(np.asarray(obs_batch), device=self.device)
        n = obs.shape[0]
        if state_batches:
            h, c = (torch.as_tensor(np.asarray(s), dtype=torch.float32, device=self.device)
                    for s in state_batches)
        else:
            h = c = torch.zeros((n, self.actor.cell_size), device=self.device)
        dist_inputs, h, c = self.actor.step(obs, h, c)
        dist = SquashedGaussian(dist_inputs, low=self.low, high=self.high)
        actions, logp, _ = self.exploration.sample_fn(
            dist, self.action_generator, explore, self.coeff_values, (), ())
        return (actions.cpu().numpy(), [h.cpu().numpy(), c.cpu().numpy()],
                {SampleBatch.ACTION_LOGP: logp.cpu().numpy()})

    # -- the update's sequence hooks ------------------------------------------

    def _train_columns(self, samples, keep_state_in: bool = False) -> Dict[str, np.ndarray]:
        out = super()._train_columns(samples)
        out["resets"] = np.asarray(samples["resets"], np.float32)
        out["mask"] = np.asarray(samples["mask"], np.float32)
        return out

    def _seq_resets(self, batch):
        resets = batch["resets"].to(torch.float32)
        done = batch[SampleBatch.TERMINATEDS].to(torch.float32)
        # the next-obs sequence starts a new episode after a done row
        resets_tp1 = torch.cat([resets[:, :1], done[:, :-1]], dim=1)
        return resets, torch.maximum(resets_tp1, resets)

    def _loss_mask(self, batch):
        mask = batch["mask"].to(torch.float32)
        burn_in = int(self.config.get("replay_burn_in", 0))
        if burn_in > 0:
            T = mask.shape[1]
            mask = mask * (torch.arange(T, device=mask.device)[None, :] >= burn_in).float()
        return mask

    def learn_on_device_batch(self, dev_batch, batch_size, normals=None):
        """One update; the two normal draws are (B, T, action_dim)."""
        if normals is None:
            shape = tuple(dev_batch[SampleBatch.OBS].shape[:2]) + (self.action_dim,)
            g = self.action_generator
            normals = (torch.randn(shape, generator=g, device=self.device),
                       torch.randn(shape, generator=g, device=self.device))
        return super().learn_on_device_batch(dev_batch, batch_size, normals=normals)


class RNNSAC(SAC):
    """Sequence-replay SAC: fragments chopped into sequences as R2D2
    does; the Polyak blend inside each update syncs the target."""

    _default_policy_class = RNNSACTorchPolicy
    _multi_agent = False

    @classmethod
    def get_default_config(cls) -> RNNSACConfig:
        return RNNSACConfig(cls)

    def __init__(self, config=None, env=None):
        cfg = config.to_dict() if hasattr(config, "to_dict") else dict(config or {})
        if not cfg.get("zero_init_states", True):
            raise ValueError(
                "RNNSAC supports only zero_init_states=True (the stored-state strategy is "
                "R2D2's corner — r2d2.py _fragments_to_sequences)"
            )
        super().__init__(cfg, env)
        rb = self.config.get("replay_buffer_config") or {}
        self.local_replay_buffer = None  # SAC's row buffer is not used
        self.seq_buffer = SequenceReplayBuffer(rb.get("capacity", 2000), seed=self.config.get("seed"))

    def _fragments_to_sequences(self, batch: SampleBatch) -> None:
        T = int(self.config.get("replay_sequence_length", 20))
        for _, seq in chop_fragment_into_sequences(
            batch, T,
            (SampleBatch.OBS, SampleBatch.NEXT_OBS, SampleBatch.ACTIONS, SampleBatch.REWARDS,
             SampleBatch.TERMINATEDS),
            first_row_is_reset=True,
        ):
            self.seq_buffer.add_sequence(seq)

    def training_step(self) -> Dict:
        """Sample ``rollout_fragment_length`` env steps, chop them into
        the buffer, and once learning has started, one update on
        ``train_batch_size // replay_sequence_length`` sequences (under
        the local worker's act lock)."""
        refuse_device_lane(self)
        config = self.config
        batch = synchronous_parallel_sample(
            worker_set=self.workers, max_env_steps=config.get("rollout_fragment_length", 20)
        )
        self._counters[NUM_ENV_STEPS_SAMPLED] += batch.env_steps()
        if hasattr(batch, "policy_batches"):
            batch = batch.policy_batches[DEFAULT_POLICY_ID]
        self._fragments_to_sequences(batch)
        train_info: Dict = {}
        num_seqs = max(1, int(config["train_batch_size"])
                       // int(config.get("replay_sequence_length", 20)))
        if (self._counters[NUM_ENV_STEPS_SAMPLED]
                >= config.get("num_steps_sampled_before_learning_starts", 0)
                and len(self.seq_buffer) >= num_seqs):
            seqs = self.seq_buffer.sample(num_seqs)
            with self.workers.local_worker().act_lock():
                info = self.get_policy().learn_on_batch(SampleBatch(seqs))
            train_info = {DEFAULT_POLICY_ID: info}
            self._counters[NUM_ENV_STEPS_TRAINED] += int(seqs["mask"].sum())
        self.workers.sync_weights(global_vars={"timestep": self._counters[NUM_ENV_STEPS_SAMPLED]})
        return train_info
