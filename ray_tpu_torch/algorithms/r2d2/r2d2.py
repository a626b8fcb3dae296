"""R2D2: recurrent replay distributed DQN.

Counterpart of ``ray_tpu/algorithms/r2d2/r2d2.py``. Rollout fragments
are chopped into fixed-length sequences (:func:`chop_fragment_into_sequences`)
with their ``resets`` (an episode restart inside the sequence), a
right-zero ``mask`` and the initial LSTM state: zeros
(``zero_init_states``) or the sampler's stored ``state_in_0/1`` at the
sequence's first row. A :class:`SequenceReplayBuffer` samples whole
sequences uniformly; the chopper and the buffer are host numpy, the
reference's code, bitwise.

:class:`R2D2TorchPolicy` learns on whole (B, T) sequences: the base
policy's chopping of flat rows into unrolls does not apply
(``_unroll_T = 1``; one minibatch of all B sequences, one pass). Its
loss runs the online and the target LSTM over every sequence from its
initial state with the ``resets`` restarting the carry, takes double-Q
one-step targets inside the sequence through the value rescaling
(:func:`h_inverse` on the target's Q, :func:`h_function` on the target)
and averages the Huber loss over the valid steps: not the burn-in
prefix, the padding, the last step (no successor in the sequence), nor
a step whose successor starts a new episode. ``R2D2`` copies the target
net every ``target_network_update_freq`` trained steps (the mask's
rows). It runs on the actor lane.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch.algorithms.algorithm import (
    NUM_ENV_STEPS_SAMPLED,
    NUM_ENV_STEPS_TRAINED,
    refuse_device_lane,
)
from ray_tpu_torch.algorithms.dqn.dqn import DQN, DQNConfig, DQNTorchPolicy
from ray_tpu_torch.data.sample_batch import DEFAULT_POLICY_ID, SampleBatch
from ray_tpu_torch.execution.rollout_ops import synchronous_parallel_sample


def h_function(x: torch.Tensor, epsilon: float = 1e-3) -> torch.Tensor:
    """The invertible value rescaling ``sign(x) (sqrt(|x| + 1) - 1) + eps
    x``."""
    return torch.sign(x) * (torch.sqrt(torch.abs(x) + 1.0) - 1.0) + epsilon * x


def h_inverse(x: torch.Tensor, epsilon: float = 1e-3) -> torch.Tensor:
    """The closed-form inverse of :func:`h_function`, the reference's
    form: ``[2 eps x ± (2 eps + 1) ∓ sqrt(±4 eps x + (2 eps + 1)^2)] / (2
    eps^2)``, the signs by the sign of ``x``."""
    two_eps = 2.0 * epsilon
    if_pos = (two_eps * x + (two_eps + 1.0)
              - torch.sqrt(4.0 * epsilon * x + (two_eps + 1.0) ** 2)) / (2.0 * epsilon ** 2)
    if_neg = (two_eps * x - (two_eps + 1.0)
              + torch.sqrt(-4.0 * epsilon * x + (two_eps + 1.0) ** 2)) / (2.0 * epsilon ** 2)
    return torch.where(x < 0.0, if_neg, if_pos)


def chop_fragment_into_sequences(batch, T: int, columns, *, first_row_is_reset: bool = True):
    """A flat rollout fragment as fixed-length sequence dicts, each with
    ``resets`` (1 where EPS_ID changes) and a right-zero ``mask``;
    integer columns keep their dtype, the others become float32. The
    fragment's first row is a reset only when ``first_row_is_reset``
    (the zero-init strategy: with stored states, the sampler's state at
    offset 0 is already right). ``[(start_row, seq), ...]``. Shared by
    R2D2 and RNNSAC; the reference's code."""
    n = batch.count
    eps_ids = np.asarray(batch.get(SampleBatch.EPS_ID, np.zeros(n, np.int64)))
    resets_all = np.zeros(n, np.float32)
    resets_all[0] = 1.0 if first_row_is_reset else 0.0
    resets_all[1:] = (eps_ids[1:] != eps_ids[:-1]).astype(np.float32)
    out = []
    for start in range(0, n, T):
        end = min(start + T, n)
        L = end - start
        seq: Dict[str, np.ndarray] = {}
        for k in columns:
            v = np.asarray(batch[k])[start:end]
            if L < T:
                pad = np.zeros((T - L,) + v.shape[1:], v.dtype)
                v = np.concatenate([v, pad], axis=0)
            seq[k] = v if np.issubdtype(v.dtype, np.integer) else v.astype(np.float32)
        mask = np.zeros(T, np.float32)
        mask[:L] = 1.0
        seq["mask"] = mask
        resets = resets_all[start:end]
        if L < T:
            resets = np.concatenate([resets, np.zeros(T - L, np.float32)])
        seq["resets"] = resets
        out.append((start, seq))
    return out


class SequenceReplayBuffer:
    """Uniform replay over fixed-length sequences (a ring of
    ``capacity_sequences``), drawn by ``np.random.default_rng(seed)``;
    the reference's code."""

    def __init__(self, capacity_sequences: int, seed=None):
        self.capacity = capacity_sequences
        self._storage: List[Dict[str, np.ndarray]] = []
        self._idx = 0
        self._rng = np.random.default_rng(seed)
        self.num_added = 0

    def add_sequence(self, seq: Dict[str, np.ndarray]) -> None:
        if len(self._storage) < self.capacity:
            self._storage.append(seq)
        else:
            self._storage[self._idx] = seq
        self._idx = (self._idx + 1) % self.capacity
        self.num_added += 1

    def __len__(self):
        return len(self._storage)

    def sample(self, num_sequences: int) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, len(self._storage), num_sequences)
        seqs = [self._storage[i] for i in idx]
        return {k: np.stack([s[k] for s in seqs]) for k in seqs[0].keys()}


class R2D2Config(DQNConfig):
    """The reference's R2D2Config."""

    def __init__(self, algo_class=None):
        super().__init__(algo_class or R2D2)
        self.replay_sequence_length = 20
        self.replay_burn_in = 0
        self.zero_init_states = True
        self.use_h_function = True
        self.h_function_epsilon = 1e-3
        self.train_batch_size = 16  # sequences a draw
        self.rollout_fragment_length = 20
        self.num_steps_sampled_before_learning_starts = 500
        self.target_network_update_freq = 1000
        self.model = {"use_lstm": True, "lstm_cell_size": 64}
        self.replay_buffer_config = {"capacity": 2000}  # sequences

    def training(
        self,
        *,
        replay_sequence_length: Optional[int] = None,
        replay_burn_in: Optional[int] = None,
        zero_init_states: Optional[bool] = None,
        use_h_function: Optional[bool] = None,
        **kwargs,
    ) -> "R2D2Config":
        super().training(**kwargs)
        for name, value in (
            ("replay_sequence_length", replay_sequence_length),
            ("replay_burn_in", replay_burn_in),
            ("zero_init_states", zero_init_states),
            ("use_h_function", use_h_function),
        ):
            if value is not None:
                setattr(self, name, value)
        return self


class R2D2TorchPolicy(DQNTorchPolicy):
    """The sequence double-Q loss with burn-in over the catalog's LSTM,
    whose logits are the Q values."""

    _supports_recurrent = True

    def __init__(self, observation_space, action_space, config: Dict, device=None):
        config = dict(config)
        model = dict(config.get("model") or {})
        model.setdefault("use_lstm", True)
        config["model"] = model
        # one SGD pass over the whole sequence batch a learn call
        config.setdefault("num_sgd_iter", 1)
        config["sgd_minibatch_size"] = config.get("train_batch_size", 16)
        super().__init__(observation_space, action_space, config, device=device)
        self.seq_len = int(config.get("replay_sequence_length", 20))
        self.burn_in = int(config.get("replay_burn_in", 0))
        # train rows are whole stored sequences, (B, T, ...) already
        self._unroll_T = 1

    def _batch_to_train_tree(self, samples) -> Dict[str, np.ndarray]:
        """The sequences as the buffer stacked them, (B, T, ...)."""
        drop = {SampleBatch.INFOS, SampleBatch.SEQ_LENS}
        return {k: np.asarray(v) for k, v in samples.items()
                if k not in drop and np.asarray(v).dtype != object}

    def loss_with_aux(self, batch, aux, coeffs):
        cfg = self.config
        gamma = cfg.get("gamma", 0.99)
        use_h = cfg.get("use_h_function", True)
        h_eps = cfg.get("h_function_epsilon", 1e-3)
        obs = batch[SampleBatch.OBS]
        B, T = obs.shape[0], obs.shape[1]
        state0 = (batch["state_in_0"], batch["state_in_1"])
        resets = batch["resets"].float()
        actions = batch[SampleBatch.ACTIONS].long()
        rewards = batch[SampleBatch.REWARDS].float()
        not_done = 1.0 - batch[SampleBatch.TERMINATEDS].float()
        mask = batch["mask"].float()

        # the online and target nets over the whole sequence; the burn-in
        # is folded in by the mask below
        q = self.model(obs, state0, resets=resets)[0].reshape(B, T, -1)
        with torch.no_grad():
            tq = self.functional_forward(aux["target_params"], obs, state0,
                                         resets=resets)[0].reshape(B, T, -1)
        q_sel = q.gather(-1, actions[..., None]).squeeze(-1)
        with torch.no_grad():
            online_next = torch.argmax(q[:, 1:], dim=-1)
            tq_next = tq[:, 1:].gather(-1, online_next[..., None]).squeeze(-1)
            if use_h:
                tq_next = h_inverse(tq_next, h_eps)
            target = rewards[:, :-1] + gamma * not_done[:, :-1] * tq_next
            if use_h:
                target = h_function(target, h_eps)
        td_error = q_sel[:, :-1] - target
        valid = mask[:, :-1] * (1.0 - resets[:, 1:])
        if self.burn_in > 0:
            valid = valid * (torch.arange(T - 1, device=obs.device)[None, :]
                             >= self.burn_in).float()
        n_valid = torch.clamp_min(valid.sum(), 1.0)
        abs_td = torch.abs(td_error)
        huber = torch.where(abs_td < 1.0, 0.5 * torch.square(td_error), abs_td - 0.5)
        loss = (huber * valid).sum() / n_valid
        with torch.no_grad():
            stats = {
                "mean_q": (q_sel[:, :-1] * valid).sum() / n_valid,
                "mean_td_error": (td_error * valid).sum() / n_valid,
            }
        return loss, stats


class R2D2(DQN):
    _default_policy_class = R2D2TorchPolicy
    # one policy, as the reference's step reads the default policy's batch
    _multi_agent = False

    @classmethod
    def get_default_config(cls) -> R2D2Config:
        return R2D2Config(cls)

    def __init__(self, config=None, env=None):
        super().__init__(config, env)
        rb = self.config.get("replay_buffer_config") or {}
        self.local_replay_buffer = None  # DQN's row buffer is not used
        self.seq_buffer = SequenceReplayBuffer(rb.get("capacity", 2000), seed=self.config.get("seed"))
        self._last_target_update = 0

    def _fragments_to_sequences(self, batch: SampleBatch) -> None:
        """A fragment's sequences into the buffer, each with the zero or
        the stored initial state."""
        cfg = self.config
        T = int(cfg.get("replay_sequence_length", 20))
        zero_init = bool(cfg.get("zero_init_states", True))
        init = self.get_policy().get_initial_state()
        for start, seq in chop_fragment_into_sequences(
            batch, T,
            (SampleBatch.OBS, SampleBatch.ACTIONS, SampleBatch.REWARDS, SampleBatch.TERMINATEDS),
            first_row_is_reset=zero_init,
        ):
            if zero_init or "state_in_0" not in batch:
                seq["state_in_0"] = np.zeros_like(np.asarray(init[0]))
                seq["state_in_1"] = np.zeros_like(np.asarray(init[1]))
            else:
                seq["state_in_0"] = np.asarray(batch["state_in_0"])[start]
                seq["state_in_1"] = np.asarray(batch["state_in_1"])[start]
            self.seq_buffer.add_sequence(seq)

    def training_step(self) -> Dict:
        """Sample ``rollout_fragment_length`` env steps, chop them into
        the buffer, and once learning has started and the buffer holds a
        batch, learn on ``train_batch_size`` sequences (under the local
        worker's act lock) and copy the target every
        ``target_network_update_freq`` trained steps."""
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
        if (self._counters[NUM_ENV_STEPS_SAMPLED]
                >= config.get("num_steps_sampled_before_learning_starts", 0)
                and len(self.seq_buffer) >= config["train_batch_size"]):
            seqs = self.seq_buffer.sample(config["train_batch_size"])
            policy = self.get_policy()
            with self.workers.local_worker().act_lock():
                train_info = {DEFAULT_POLICY_ID: policy.learn_on_batch(SampleBatch(seqs))}
            self._counters[NUM_ENV_STEPS_TRAINED] += int(seqs["mask"].sum())
            if (self._counters[NUM_ENV_STEPS_TRAINED] - self._last_target_update
                    >= config.get("target_network_update_freq", 1000)):
                policy.update_target()
                self._last_target_update = self._counters[NUM_ENV_STEPS_TRAINED]
                self._counters["num_target_updates"] += 1
        self.workers.sync_weights(global_vars={"timestep": self._counters[NUM_ENV_STEPS_SAMPLED]})
        return train_info
