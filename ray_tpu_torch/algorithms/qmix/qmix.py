"""QMIX: monotonic value factorization for cooperative multi-agent RL.

Counterpart of ``ray_tpu/algorithms/qmix/qmix.py`` (Rashid et al. 2018):
a parameter-shared per-agent utility net (fc → GRU → Q, flax's
``GRUCell``: ``models/rnn.py``) and a mixer whose weights come from
state-conditioned hypernetworks (``abs()`` keeps dQtot/dQa >= 0),
trained end to end with a joint TD loss over whole episodes.

- **Acting.** One joint collector steps the multi-agent env on the host
  (no worker set). The act step is epsilon-greedy over each agent's Q
  values (``PiecewiseSchedule`` epsilon); its random action and uniform
  come from a torch generator on the algorithm's device (the reference
  draws from ``jax.random``; tests inject its draws). The agents' GRU
  carry stays on the device and is zeroed at every episode start and
  every ``episode_limit`` chunk, as the learn's unroll starts every
  stored chunk from zero.
- **Episode storage.** A finished episode (or chunk) is padded to (T+1,
  n, d) observations, the final ``next_obs`` kept, with (T, n) int32
  actions and (T,) reward, done (termination only) and mask, and stored
  as one row (:meth:`QMIX._push_episode`). By default the rows live on
  the device (``DeviceReplayBuffer``): the host arrays cross once, one
  ``scatter_rows`` a column (the row-scatter kernel), and a learn's
  episodes come back with one ``gather_rows`` a column (the row-gather
  kernel). The index draw stays on the algorithm's ``_np_rng`` (the
  reference's stream), and ``_ep_steps`` keeps each stored row's
  unpadded step count on the host, so the trained-steps counter reads
  nothing back. QMIX's own spill rule: when the first insert spills the
  ring to the host, the ring is abandoned for the episode list.
  ``replay_device_resident=False`` keeps the list from the start.
- **Learn.** The agents fold into the unroll's batch, their carries start
  at zero; the target net's unroll bootstraps step t from t + 1 (double
  Q picks the next action with the online net), the mixer mixes the
  chosen Q values with the joint observation as the state, and the TD
  loss is masked and normalised by ``max(Σ mask, 1)``; one Adam step.
  The target is a copy of the online nets every
  ``target_network_update_freq`` trained env steps.
- ``agent_rnn=False``: feed-forward agents with the same mixer.

A data-parallel ``_mesh`` (more than one shard) raises naming ROADMAP
item 7; the reference splits its episodes over the mesh.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ray_tpu_torch.algorithms.algorithm import (
    NUM_AGENT_STEPS_SAMPLED,
    NUM_ENV_STEPS_SAMPLED,
    NUM_ENV_STEPS_TRAINED,
    Algorithm,
)
from ray_tpu_torch.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.algorithms.maddpg.maddpg import _stacked_obs
from ray_tpu_torch.data.sample_batch import DEFAULT_POLICY_ID
from ray_tpu_torch.env.spaces import agent_space, of_kind
from ray_tpu_torch.evaluation.metrics import RolloutMetrics
from ray_tpu_torch.execution.replay_buffer import DeviceReplayBuffer, resolve_device_resident
from ray_tpu_torch.models.base import Dense, get_activation
from ray_tpu_torch.models.rnn import GRUCell, gru_unroll
from ray_tpu_torch.policy.torch_policy import AdamState, adam_update, host_read
from ray_tpu_torch.utils.schedules import PiecewiseSchedule


class AgentQNet(nn.Module):
    """The reference's ``_AgentQNet``: ``fc_i`` (relu) → ``gru`` → ``q``;
    obs (B, T, d) and carry (B, cell) → Q values (B, T, A) and the carry
    after the last step. ``recurrent=False`` skips the GRU (the carry
    passes through)."""

    def __init__(self, obs_dim: int, num_actions: int, hiddens: Sequence[int] = (64,),
                 cell_size: int = 64, recurrent: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cell_size = int(cell_size)
        self.recurrent = bool(recurrent)
        self.num_hiddens = len(hiddens)
        sizes = [int(obs_dim), *[int(h) for h in hiddens]]
        for i in range(self.num_hiddens):
            setattr(self, f"fc_{i}", Dense(sizes[i], sizes[i + 1], generator=generator))
        width = sizes[-1]
        if self.recurrent:
            self.gru = GRUCell(width, self.cell_size, generator)
            width = self.cell_size
        self.q = Dense(width, int(num_actions), generator=generator)
        self.act = get_activation("relu")

    def initial_state(self, batch_size: int, device=None) -> torch.Tensor:
        return torch.zeros((batch_size, self.cell_size), device=device)

    def forward(self, obs: torch.Tensor, h: torch.Tensor):
        x = obs.float()
        for i in range(self.num_hiddens):
            x = self.act(getattr(self, f"fc_{i}")(x))
        if self.recurrent:
            x, h = gru_unroll(self.gru, x, h)
        return self.q(x), h


class Mixer(nn.Module):
    """The reference's ``_Mixer``: agent Qs (B, n) and state (B, s) →
    Qtot (B,), through ``abs()`` hypernet weights, an ELU hidden layer
    and the ``hyper_b2_h`` → ``hyper_b2_out`` bias head."""

    def __init__(self, n_agents: int, state_dim: int, embed_dim: int = 32,
                 hypernet_hidden: int = 64, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_agents, self.embed_dim = int(n_agents), int(embed_dim)
        self.hyper_w1 = Dense(state_dim, self.n_agents * self.embed_dim, generator=generator)
        self.hyper_b1 = Dense(state_dim, self.embed_dim, generator=generator)
        self.hyper_w2 = Dense(state_dim, self.embed_dim, generator=generator)
        self.hyper_b2_h = Dense(state_dim, int(hypernet_hidden), generator=generator)
        self.hyper_b2_out = Dense(int(hypernet_hidden), 1, generator=generator)

    def forward(self, agent_qs: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
        B = agent_qs.shape[0]
        w1 = torch.abs(self.hyper_w1(state)).reshape(B, self.n_agents, self.embed_dim)
        b1 = self.hyper_b1(state)
        hidden = torch.nn.functional.elu(torch.einsum("bn,bne->be", agent_qs, w1) + b1)
        w2 = torch.abs(self.hyper_w2(state))
        b2 = self.hyper_b2_out(torch.relu(self.hyper_b2_h(state)))
        return (torch.sum(hidden * w2, dim=-1, keepdim=True) + b2).squeeze(-1)


class QMIXModel(nn.Module):
    """The shared agent net (``agent``) and the mixer (``mixer``)."""

    def __init__(self, agent: AgentQNet, mixer: Mixer):
        super().__init__()
        self.agent = agent
        self.mixer = mixer


class QMIXConfig(AlgorithmConfig):
    """The reference's QMixConfig defaults."""

    def __init__(self, algo_class=None):
        super().__init__(algo_class or QMIX)
        self.mixing_embed_dim = 32
        self.hypernet_hidden = 64
        self.agent_hiddens = [64]
        self.agent_rnn = True
        self.agent_cell_size = 64
        self.episode_limit = 64
        self.double_q = True
        self.lr = 5e-4
        self.gamma = 0.99
        self.train_batch_size = 32
        self.rollout_fragment_length = 16
        self.target_network_update_freq = 200
        self.num_steps_sampled_before_learning_starts = 200
        self.buffer_size = 5000
        self.initial_epsilon = 1.0
        self.final_epsilon = 0.05
        self.epsilon_timesteps = 5000


class QMIX(Algorithm):
    """The joint collector, the episode ring and the whole-episode learn."""

    _joint_collector = True

    @classmethod
    def get_default_config(cls) -> QMIXConfig:
        return QMIXConfig(cls)

    def __init__(self, config=None, env=None):
        super().__init__(config, env)
        config = self.config
        mesh = config.get("_mesh")
        if mesh is not None and int(np.prod(list(mesh.shape.values()))) > 1:
            raise NotImplementedError(
                "QMIX over a data-parallel _mesh (episodes split over its shards, the TD "
                "normaliser and gradients summed across them) is not ported yet: ROADMAP.md "
                "queue 1 item 7"
            )
        obs, _ = self.env.reset(seed=config.get("seed"))
        self.agent_ids: List = sorted(obs.keys())
        self.n_agents = len(self.agent_ids)
        a0 = self.agent_ids[0]
        self.obs_dim = int(np.prod(np.asarray(obs[a0]).shape))
        space = agent_space(getattr(self.env, "action_space", None), a0)
        if not of_kind(space, "Discrete"):
            raise ValueError(f"QMIX requires Discrete agent actions, got {space!r}")
        self.num_actions = int(space.n)
        self._cur_obs = obs
        self._episode_reward = 0.0
        self._episode_len = 0

        seed = int(config.get("seed") or 0)
        self._np_rng = np.random.default_rng(seed)
        self.recurrent = bool(config.get("agent_rnn", True))
        self.episode_limit = int(config.get("episode_limit", 64))
        gen = torch.Generator().manual_seed(seed)
        agent = AgentQNet(self.obs_dim, self.num_actions, tuple(config.get("agent_hiddens", (64,))),
                          int(config.get("agent_cell_size", 64)), self.recurrent, gen)
        mixer = Mixer(self.n_agents, self.obs_dim * self.n_agents,
                      int(config.get("mixing_embed_dim", 32)),
                      int(config.get("hypernet_hidden", 64)), gen)
        self.model = QMIXModel(agent, mixer).to(self.device)
        self.param_names = [n for n, _ in self.model.named_parameters()]
        self.params = [p for _, p in self.model.named_parameters()]
        self.target = [p.detach().clone() for p in self.params]
        self.opt_state = AdamState(self.params)
        self._lr = torch.tensor(float(config.get("lr", 5e-4)), device=self.device)
        self._epsilon = PiecewiseSchedule([
            (0, float(config.get("initial_epsilon", 1.0))),
            (int(config.get("epsilon_timesteps", 5000)), float(config.get("final_epsilon", 0.05))),
        ])
        self.action_generator = torch.Generator(device=self.device)
        self.action_generator.manual_seed(seed)
        self._buffer: List[Dict] = []
        self._buffer_idx = 0
        # the device episode ring, and each stored row's unpadded step
        # count on the host (None: the episode list)
        self._dev_buffer: Optional[DeviceReplayBuffer] = None
        self._ep_steps: Optional[np.ndarray] = None
        if resolve_device_resident(config):
            cap = int(config.get("buffer_size", 5000))
            self._dev_buffer = DeviceReplayBuffer(
                capacity=cap, seed=config.get("seed"), device=self.device,
                memory_cap_bytes=config.get("replay_memory_cap_bytes"), label="qmix_episodes",
            )
            self._ep_steps = np.zeros(cap, np.float32)
        self._last_target_update = 0
        # the agents' GRU carry between env steps (zero at episode start)
        self._hidden = agent.initial_state(self.n_agents, self.device)
        self._episode_rows: List[Dict] = []

    # -- acting -----------------------------------------------------------

    @torch.no_grad()
    def _actions(self, obs_stack: np.ndarray, epsilon: float,
                 draws: Optional[Tuple[np.ndarray, np.ndarray]] = None) -> np.ndarray:
        """(n,) epsilon-greedy actions for the (n, d) stacked observations,
        one GRU step from the carry. ``draws``: the (n,) random actions
        and (n,) uniforms, injected; else drawn from
        :attr:`action_generator`."""
        obs = torch.as_tensor(obs_stack, device=self.device)
        q, h_new = self.model.agent(obs[:, None], self._hidden)
        q = q[:, 0]
        greedy = torch.argmax(q, dim=-1)
        n = greedy.shape[0]
        if draws is None:
            rand = torch.randint(0, q.shape[-1], (n,), generator=self.action_generator,
                                 device=self.device)
            u = torch.rand((n,), generator=self.action_generator, device=self.device)
        else:
            rand = torch.as_tensor(np.array(draws[0]), device=self.device).to(greedy.dtype)
            u = torch.as_tensor(np.array(draws[1], np.float32), device=self.device)
        if self.recurrent:
            self._hidden = h_new
        return torch.where(u < epsilon, rand, greedy).cpu().numpy()

    def _collect(self, num_steps: int, draws: Optional[Iterable] = None) -> int:
        """``num_steps`` joint env steps; a finished episode (or chunk) is
        stored. ``draws``: one ``(random actions, uniforms)`` a step,
        injected. Returns the agent steps."""
        cap = int(self.config.get("buffer_size", 5000))
        it = iter(draws) if draws is not None else None
        steps = 0
        for _ in range(num_steps):
            obs_stack = _stacked_obs(self._cur_obs, self.agent_ids)
            eps = float(self._epsilon(self._counters[NUM_ENV_STEPS_SAMPLED]))
            acts = self._actions(obs_stack, eps, None if it is None else next(it))
            action_dict = {a: int(acts[i]) for i, a in enumerate(self.agent_ids)}
            next_obs, rewards, terms, truncs, _ = self.env.step(action_dict)
            terminated = bool(terms.get("__all__", False))
            done = terminated or bool(truncs.get("__all__", False))
            team_reward = float(sum(rewards.get(a, 0.0) for a in self.agent_ids))
            next_stack = (_stacked_obs(next_obs, self.agent_ids, self._cur_obs)
                          if next_obs else obs_stack)
            self._episode_rows.append({
                "obs": obs_stack,
                "actions": acts.astype(np.int32),
                "reward": np.float32(team_reward),
                "next_obs": next_stack,
                # a time-limit truncation still bootstraps Q(s')
                "done": np.float32(terminated),
            })
            self._episode_reward += team_reward
            self._episode_len += 1
            steps += self.n_agents
            self._counters[NUM_ENV_STEPS_SAMPLED] += 1
            self._counters[NUM_AGENT_STEPS_SAMPLED] += self.n_agents
            if done or len(self._episode_rows) >= self.episode_limit:
                self._push_episode(cap)
                if done:
                    self._episode_history.append(RolloutMetrics(self._episode_len,
                                                                self._episode_reward))
                    self._episodes_total += 1
                    self._episode_reward = 0.0
                    self._episode_len = 0
                    next_obs, _ = self.env.reset()
                if self.recurrent:
                    # every stored chunk's unroll starts from zero state
                    self._hidden = torch.zeros_like(self._hidden)
            self._cur_obs = next_obs
        return steps

    def _pad_episode(self, rows: List[Dict]) -> Dict[str, np.ndarray]:
        """The episode's rows at the static (T+1)-step layout: obs has T+1
        rows, the final ``next_obs`` after the last step."""
        T, L = self.episode_limit, len(rows)
        n, d = self.n_agents, self.obs_dim
        obs = np.zeros((T + 1, n, d), np.float32)
        actions = np.zeros((T, n), np.int32)
        reward = np.zeros(T, np.float32)
        done = np.zeros(T, np.float32)
        mask = np.zeros(T, np.float32)
        for t, r in enumerate(rows):
            obs[t] = r["obs"]
            actions[t] = r["actions"]
            reward[t] = r["reward"]
            done[t] = r["done"]
            mask[t] = 1.0
        obs[L] = rows[-1]["next_obs"]
        return {"obs": obs, "actions": actions, "reward": reward, "done": done, "mask": mask}

    def _push_episode(self, cap: int) -> None:
        """Store the finished episode (or chunk) as one replay row."""
        rows, self._episode_rows = self._episode_rows, []
        if not rows:
            return
        ep = self._pad_episode(rows)
        if self._dev_buffer is not None:
            pos = self._dev_buffer._idx
            self._dev_buffer.add_tree({k: v[None] for k, v in ep.items()})
            if not self._dev_buffer.spilled:
                self._ep_steps[pos] = float(ep["mask"].sum())
                return
            # the first insert's memory projection spilled: QMIX keeps its
            # episode list instead of the generic spill ring
            self._dev_buffer = None
            self._ep_steps = None
        if len(self._buffer) < cap:
            self._buffer.append(ep)
        else:
            self._buffer[self._buffer_idx] = ep
        self._buffer_idx = (self._buffer_idx + 1) % cap

    def buffer_len(self) -> int:
        return len(self._dev_buffer) if self._dev_buffer is not None else len(self._buffer)

    def sample_episodes(self, n_eps: int) -> Tuple[Dict[str, torch.Tensor], int]:
        """``n_eps`` stored episodes drawn from ``_np_rng`` (the reference's
        stream) and their unpadded step total: the device ring's rows by
        one row gather a column, or the episode list's stacked and
        copied to the device."""
        idx = self._np_rng.integers(0, self.buffer_len(), n_eps)
        if self._dev_buffer is not None:
            return dict(self._dev_buffer.gather(idx).tree), int(self._ep_steps[idx].sum())
        rows = [self._buffer[i] for i in idx]
        batch = {k: torch.as_tensor(np.stack([r[k] for r in rows]), device=self.device)
                 for k in rows[0]}
        return batch, int(sum(float(r["mask"].sum()) for r in rows))

    # -- learning ---------------------------------------------------------

    def _unroll_q(self, params: Optional[List[torch.Tensor]], obs: torch.Tensor) -> torch.Tensor:
        """obs (B, T1, n, d) → each agent's Q values (B, T1, n, A) from a
        zero carry, the agents folded into the unroll's batch; ``params``
        None: the online net, else the target's list."""
        B, T1, n, d = obs.shape
        seq = obs.permute(0, 2, 1, 3).reshape(B * n, T1, d)
        agent = self.model.agent
        h0 = agent.initial_state(B * n, obs.device)
        if params is None:
            q, _ = agent(seq, h0)
        else:
            names = [k for k in self.param_names if k.startswith("agent.")]
            sub = {k[len("agent."):]: params[self.param_names.index(k)] for k in names}
            q, _ = torch.func.functional_call(agent, sub, (seq, h0))
        return q.reshape(B, n, T1, -1).permute(0, 2, 1, 3)

    def _mix(self, params: Optional[List[torch.Tensor]], qs: torch.Tensor,
             state: torch.Tensor) -> torch.Tensor:
        mixer = self.model.mixer
        if params is None:
            return mixer(qs, state)
        sub = {k[len("mixer."):]: p for k, p in zip(self.param_names, params)
               if k.startswith("mixer.")}
        return torch.func.functional_call(mixer, sub, (qs, state))

    def _learn(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One update on a device batch of B episodes (obs (B, T+1, n, d),
        actions (B, T, n), reward, done and mask (B, T)); the stats on
        the device."""
        gamma = float(self.config.get("gamma", 0.99))
        obs = batch["obs"].float()
        B, T1, n, d = obs.shape
        T = T1 - 1
        state = obs.reshape(B, T1, n * d)
        actions = batch["actions"].long()
        mask = batch["mask"].float()
        q_all = self._unroll_q(None, obs)  # (B, T+1, n, A), online, with gradient
        with torch.no_grad():
            tq = self._unroll_q(self.target, obs)
            chooser = q_all if self.config.get("double_q", True) else tq
            next_acts = torch.argmax(chooser[:, 1:].detach(), dim=-1)  # (B, T, n)
            tq_sel = tq[:, 1:].gather(-1, next_acts[..., None]).squeeze(-1)
            target_qtot = self._mix(self.target, tq_sel.reshape(B * T, n),
                                    state[:, 1:].reshape(B * T, n * d)).reshape(B, T)
            y = batch["reward"].float() + gamma * (1.0 - batch["done"].float()) * target_qtot
        q_sel = q_all[:, :T].gather(-1, actions[..., None]).squeeze(-1)  # (B, T, n)
        q_tot = self._mix(None, q_sel.reshape(B * T, n),
                          state[:, :T].reshape(B * T, n * d)).reshape(B, T)
        td = (q_tot - y) * mask
        denom = torch.clamp_min(torch.sum(mask), 1.0)
        loss = torch.sum(torch.square(td)) / denom
        grads = torch.autograd.grad(loss, self.params)
        self.opt_state.load_corrections(1)
        adam_update(self.params, list(grads), self.opt_state, self._lr, 1e-8, None)
        self.opt_state.count += 1
        with torch.no_grad():
            return {"loss": loss.detach(), "mean_qtot": torch.sum(q_tot * mask) / denom,
                    "mean_td_error": torch.sum(td) / denom}

    def learn_on_batch(self, batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """One update on a batch of episodes (tensors, moved to the
        algorithm's device); the stats as floats."""
        dev = {k: v.to(self.device) for k, v in batch.items()}
        return {k: float(v) for k, v in self._learn(dev).items()}

    @torch.no_grad()
    def update_target(self) -> None:
        torch._foreach_copy_(self.target, [p.detach() for p in self.params])

    def training_step(self) -> Dict:
        config = self.config
        self._collect(int(config.get("rollout_fragment_length", 16)))
        if (self._counters[NUM_ENV_STEPS_SAMPLED]
                < config.get("num_steps_sampled_before_learning_starts", 0)
                or self.buffer_len() < config["train_batch_size"]):
            return {}
        # train_batch_size counts episodes; env steps trained, unpadded steps
        batch, steps_trained = self.sample_episodes(int(config["train_batch_size"]))
        stats = self.learn_on_batch(batch)
        self._counters[NUM_ENV_STEPS_TRAINED] += steps_trained
        if (self._counters[NUM_ENV_STEPS_TRAINED] - self._last_target_update
                >= config.get("target_network_update_freq", 200)):
            self.update_target()
            self._last_target_update = self._counters[NUM_ENV_STEPS_TRAINED]
            self._counters["num_target_updates"] += 1
        return {DEFAULT_POLICY_ID: stats}

    # -- checkpoint state -------------------------------------------------

    def get_weights(self, read=None) -> Dict[str, np.ndarray]:
        read = read or host_read
        return {n: read(p) for n, p in zip(self.param_names, self.params)}

    def __getstate__(self) -> Dict:
        st = self.opt_state
        return {
            "params": self.get_weights(),
            "target_params": {n: host_read(t) for n, t in zip(self.param_names, self.target)},
            "opt_state": {"count": st.count,
                          "mu": dict(zip(self.param_names, map(host_read, st.mu))),
                          "nu": dict(zip(self.param_names, map(host_read, st.nu)))},
            "counters": dict(self._counters),
            "episodes_total": self._episodes_total,
        }

    @torch.no_grad()
    def __setstate__(self, state: Dict) -> None:
        st, opt = self.opt_state, state["opt_state"]
        st.count = int(opt["count"])
        for i, n in enumerate(self.param_names):
            self.params[i].copy_(torch.as_tensor(np.asarray(state["params"][n])))
            self.target[i].copy_(torch.as_tensor(np.asarray(state["target_params"][n])))
            st.mu[i].copy_(torch.as_tensor(np.asarray(opt["mu"][n])))
            st.nu[i].copy_(torch.as_tensor(np.asarray(opt["nu"][n])))
        self._counters = collections.defaultdict(int, state.get("counters", {}))
        self._episodes_total = state.get("episodes_total", 0)

    cleanup = Algorithm.stop  # the reference's name
