"""MADDPG: multi-agent DDPG with centralized critics.

Counterpart of ``ray_tpu/algorithms/maddpg/maddpg.py`` (Lowe et al.
2017): each agent has a deterministic actor over its own observation and
a centralized critic ``Q_i(s_all, a_all)`` over the joint observation and
the joint action.

Every agent's actor and critic sit stacked along a leading agent axis,
as the reference's ``vmap``ped init lays them out: one
:class:`StackedDense` a layer, whose (n, out, in) weight and (n, out)
bias run as one batched matmul for all n agents. One learn is the
reference's order:

1. the critics' TD targets, from the target actors' next actions;
2. the critic loss, one mean over (n, B), and the critics' Adam step;
3. each actor's loss through **the updated critic**, with its own fresh
   action put in its slot of the logged joint action; the losses summed
   over agents, and the actors' Adam step;
4. the polyak blend at ``tau`` of the targets toward both.

Collection is the reference's joint collector, on the host: the algorithm
steps its one multi-agent env (no worker set), stores each joint step as
a row of a host list, and draws a batch's rows from its numpy generator
(``_np_rng``, the reference's stream, so the same rows). The bootstrap
mask is termination only. Exploration adds ``exploration_stddev`` times
a standard normal from a torch generator on the algorithm's device (the
reference draws from ``jax.random``; tests inject its normals) and clips
to the action bounds. The reference runs no Pallas kernel here, and
neither does the port.

The action space is a ``Box``: the port's ``env/spaces.Box`` or
gymnasium's (the reference asserts ``gym.spaces.Box``).
"""

from __future__ import annotations

import collections
from typing import Dict, Iterable, List, Optional, Sequence

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
from ray_tpu_torch.data.sample_batch import DEFAULT_POLICY_ID
from ray_tpu_torch.env.spaces import agent_space, of_kind
from ray_tpu_torch.evaluation.metrics import RolloutMetrics
from ray_tpu_torch.models.base import get_activation, variance_scaling_
from ray_tpu_torch.policy.torch_policy import AdamState, adam_update, host_read

GROUPS = ("actor", "critic")


class StackedDense(nn.Module):
    """n flax ``Dense`` layers side by side: ``weight`` (n, out, in),
    ``bias`` (n, out); x (n, B, in) → (n, B, out). Each agent's kernel is
    LeCun normal and its bias zero, as flax initialises them."""

    def __init__(self, n: int, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n, out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(n, out_features))
        for i in range(n):
            variance_scaling_(self.weight.data[i], 1.0, in_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.baddbmm(self.bias.unsqueeze(1), x, self.weight.transpose(1, 2))


class _StackedMLP(nn.Module):
    """``fc_i`` (relu) layers, then the head ``head``; all stacked."""

    def __init__(self, n: int, in_size: int, hiddens: Sequence[int], out_size: int,
                 head: str, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_hiddens = len(hiddens)
        self.head = head
        sizes = [int(in_size), *[int(h) for h in hiddens]]
        for i in range(self.num_hiddens):
            setattr(self, f"fc_{i}", StackedDense(n, sizes[i], sizes[i + 1], generator))
        setattr(self, head, StackedDense(n, sizes[-1], out_size, generator))
        self.act = get_activation("relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        for i in range(self.num_hiddens):
            x = self.act(getattr(self, f"fc_{i}")(x))
        return getattr(self, self.head)(x)


class MADDPGModel(nn.Module):
    """Every agent's actor (tanh output rescaled to [low, high]) and
    centralized critic, stacked on the agent axis."""

    def __init__(self, n_agents: int, obs_dim: int, act_dim: int, low: float, high: float,
                 actor_hiddens: Sequence[int], critic_hiddens: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.low, self.high = float(low), float(high)
        self.actor = _StackedMLP(n_agents, obs_dim, actor_hiddens, act_dim, "out", generator)
        self.critic = _StackedMLP(n_agents, n_agents * (obs_dim + act_dim), critic_hiddens, 1,
                                  "q", generator)

    def act(self, obs: torch.Tensor, actor: Optional[nn.Module] = None) -> torch.Tensor:
        """obs (n, B, d) → each agent's action (n, B, a)."""
        raw = torch.tanh((actor or self.actor)(obs))
        mid = (self.high + self.low) / 2.0
        half = (self.high - self.low) / 2.0
        return mid + half * raw

    @staticmethod
    def q(critic: nn.Module, joint_obs: torch.Tensor, joint_actions: torch.Tensor) -> torch.Tensor:
        """Each agent's critic at its own (n, B, ...) joint inputs: (n, B)."""
        return critic(torch.cat([joint_obs.float(), joint_actions.float()], dim=-1)).squeeze(-1)


class MADDPGConfig(AlgorithmConfig):
    """The reference's MADDPGConfig defaults."""

    def __init__(self, algo_class=None):
        super().__init__(algo_class or MADDPG)
        self.actor_hiddens = [64, 64]
        self.critic_hiddens = [64, 64]
        self.actor_lr = 1e-3
        self.critic_lr = 1e-3
        self.tau = 0.01
        self.gamma = 0.95
        self.train_batch_size = 64
        self.rollout_fragment_length = 16
        self.buffer_size = 10000
        self.num_steps_sampled_before_learning_starts = 500
        self.exploration_stddev = 0.1


def _stacked_obs(obs: Dict, agent_ids: List, fallback: Optional[Dict] = None) -> np.ndarray:
    """(n, d) float32: each agent's flat observation (``fallback``'s where
    ``obs`` lacks the agent)."""
    return np.stack([
        np.asarray(obs.get(a, fallback[a]) if fallback is not None else obs[a],
                   np.float32).reshape(-1)
        for a in agent_ids
    ])


class MADDPG(Algorithm):
    """The joint collector, the host replay list and the stacked learn."""

    _joint_collector = True

    @classmethod
    def get_default_config(cls) -> MADDPGConfig:
        return MADDPGConfig(cls)

    def __init__(self, config=None, env=None):
        super().__init__(config, env)
        config = self.config
        obs, _ = self.env.reset(seed=config.get("seed"))
        self.agent_ids: List = sorted(obs.keys())
        self.n_agents = len(self.agent_ids)
        a0 = self.agent_ids[0]
        self.obs_dim = int(np.prod(np.asarray(obs[a0]).shape))
        space = agent_space(getattr(self.env, "action_space", None), a0)
        if not of_kind(space, "Box"):
            raise ValueError(f"MADDPG requires Box agent actions, got {space!r}")
        self.act_dim = int(np.prod(space.shape))
        self.low = float(np.min(space.low))
        self.high = float(np.max(space.high))
        self._cur_obs = obs
        self._episode_reward = 0.0
        self._episode_len = 0

        seed = int(config.get("seed") or 0)
        self._np_rng = np.random.default_rng(seed)
        self.model = MADDPGModel(
            self.n_agents, self.obs_dim, self.act_dim, self.low, self.high,
            tuple(config.get("actor_hiddens", (64, 64))),
            tuple(config.get("critic_hiddens", (64, 64))),
            torch.Generator().manual_seed(seed),
        ).to(self.device)
        self.target = {g: [p.detach().clone() for p in self._group(g)] for g in GROUPS}
        self.opt_states = {g: AdamState(self._group(g)) for g in GROUPS}
        self._lr = {g: torch.tensor(float(config.get(f"{g}_lr", 1e-3)), device=self.device)
                    for g in GROUPS}
        self.action_generator = torch.Generator(device=self.device)
        self.action_generator.manual_seed(seed)
        self._buffer: List[Dict] = []
        self._buffer_idx = 0

    def _group(self, group: str) -> List[torch.Tensor]:
        return list(getattr(self.model, group).parameters())

    def group_param_names(self, group: str) -> List[str]:
        return [n for n, _ in getattr(self.model, group).named_parameters()]

    def _target_module(self, group: str):
        """``(module, target params by name)`` for ``torch.func.functional_call``."""
        return getattr(self.model, group), dict(zip(self.group_param_names(group),
                                                    self.target[group]))

    # -- acting -----------------------------------------------------------

    @torch.no_grad()
    def _actions(self, obs_stack: np.ndarray, explore: bool,
                 normals: Optional[np.ndarray] = None) -> np.ndarray:
        """(n, a) actions for the (n, d) stacked observations: each actor's,
        plus ``exploration_stddev`` x standard normals when exploring
        (``normals``, else from :attr:`action_generator`), clipped."""
        obs = torch.as_tensor(obs_stack, device=self.device)
        acts = self.model.act(obs[:, None])[:, 0]
        if explore:
            if normals is None:
                z = torch.randn(acts.shape, generator=self.action_generator, device=self.device)
            else:
                z = torch.as_tensor(np.array(normals, np.float32), device=self.device)
            stddev = float(self.config.get("exploration_stddev", 0.1))
            acts = torch.clamp(acts + stddev * z, self.low, self.high)
        return acts.cpu().numpy()

    def _collect(self, num_steps: int, normals: Optional[Iterable[np.ndarray]] = None) -> None:
        """``num_steps`` joint env steps into the replay list (``normals``:
        one (n, a) draw a step, injected)."""
        cap = int(self.config.get("buffer_size", 10000))
        draws = iter(normals) if normals is not None else None
        for _ in range(num_steps):
            obs_stack = _stacked_obs(self._cur_obs, self.agent_ids)
            acts = self._actions(obs_stack, True, None if draws is None else next(draws))
            action_dict = {a: acts[i] for i, a in enumerate(self.agent_ids)}
            next_obs, rewards, terms, truncs, _ = self.env.step(action_dict)
            terminated = bool(terms.get("__all__", False))
            done = terminated or bool(truncs.get("__all__", False))
            rew_vec = np.asarray([rewards.get(a, 0.0) for a in self.agent_ids], np.float32)
            next_stack = (_stacked_obs(next_obs, self.agent_ids, self._cur_obs)
                          if next_obs else obs_stack)
            row = {
                "obs": obs_stack,
                "actions": acts.astype(np.float32),
                "rewards": rew_vec,
                "next_obs": next_stack,
                # a time-limit truncation still bootstraps Q(s')
                "done": np.float32(terminated),
            }
            if len(self._buffer) < cap:
                self._buffer.append(row)
            else:
                self._buffer[self._buffer_idx] = row
            self._buffer_idx = (self._buffer_idx + 1) % cap
            self._episode_reward += float(rew_vec.sum())
            self._episode_len += 1
            self._counters[NUM_ENV_STEPS_SAMPLED] += 1
            self._counters[NUM_AGENT_STEPS_SAMPLED] += self.n_agents
            if done:
                self._episode_history.append(RolloutMetrics(self._episode_len,
                                                            self._episode_reward))
                self._episodes_total += 1
                self._episode_reward = 0.0
                self._episode_len = 0
                next_obs, _ = self.env.reset()
            self._cur_obs = next_obs

    # -- learning ---------------------------------------------------------

    def _learn(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One update on a device batch (obs, next_obs (B, n, d); actions
        (B, n, a); rewards (B, n); done (B,)); the stats on the device."""
        model, n = self.model, self.n_agents
        gamma = float(self.config.get("gamma", 0.95))
        tau = float(self.config.get("tau", 0.01))
        obs, next_obs = batch["obs"].float(), batch["next_obs"].float()
        actions = batch["actions"].float()
        B = obs.shape[0]
        joint_obs = obs.reshape(B, -1).expand(n, B, -1)
        joint_actions = actions.reshape(B, -1).expand(n, B, -1)
        for st in self.opt_states.values():
            st.load_corrections(1)

        with torch.no_grad():
            actor_m, actor_t = self._target_module("actor")
            next_acts = model.act(next_obs.transpose(0, 1),
                                  lambda x: torch.func.functional_call(actor_m, actor_t, (x,)))
            joint_next_acts = next_acts.transpose(0, 1).reshape(B, -1).expand(n, B, -1)
            critic_m, critic_t = self._target_module("critic")
            x_next = torch.cat([next_obs.reshape(B, -1).expand(n, B, -1), joint_next_acts], -1)
            tq = torch.func.functional_call(critic_m, critic_t, (x_next,)).squeeze(-1)
            y = batch["rewards"].float().T + gamma * (1.0 - batch["done"].float())[None] * tq

        critic_p = self._group("critic")
        q = model.q(model.critic, joint_obs, joint_actions)  # (n, B)
        c_loss = torch.mean(torch.square(q - y))
        c_grads = torch.autograd.grad(c_loss, critic_p)
        adam_update(critic_p, list(c_grads), self.opt_states["critic"], self._lr["critic"],
                    1e-8, None)

        # each actor through its updated critic, its own fresh action in
        # its slot of the logged joint action
        actor_p = self._group("actor")
        mine = model.act(obs.transpose(0, 1))  # (n, B, a)
        own = torch.eye(n, dtype=torch.bool, device=obs.device)[:, None, :, None]
        mixed = torch.where(own, mine[:, :, None, :], actions[None])  # (n, B, n, a)
        qa = model.q(model.critic, joint_obs, mixed.reshape(n, B, -1))
        a_loss = torch.sum(-torch.mean(qa, dim=1))
        a_grads = torch.autograd.grad(a_loss, actor_p)
        adam_update(actor_p, list(a_grads), self.opt_states["actor"], self._lr["actor"],
                    1e-8, None)

        with torch.no_grad():
            for g in GROUPS:
                torch._foreach_mul_(self.target[g], 1.0 - tau)
                torch._foreach_add_(self.target[g],
                                    torch._foreach_mul([p.detach() for p in self._group(g)], tau))
        for st in self.opt_states.values():
            st.count += 1
        return {"critic_loss": c_loss.detach(), "actor_loss": a_loss.detach(),
                "mean_q": torch.mean(q).detach()}

    def learn_on_batch(self, rows: Dict[str, np.ndarray]) -> Dict[str, float]:
        """One update on a host batch of stacked rows; the stats as floats."""
        batch = {k: torch.as_tensor(np.asarray(v), device=self.device) for k, v in rows.items()}
        stats = self._learn(batch)
        return {k: float(v) for k, v in stats.items()}

    def sample_rows(self, batch_size: int) -> Dict[str, np.ndarray]:
        """``batch_size`` rows of the replay list, drawn from ``_np_rng``
        as the reference draws them, stacked."""
        idx = self._np_rng.integers(0, len(self._buffer), batch_size)
        rows = [self._buffer[i] for i in idx]
        return {k: np.stack([r[k] for r in rows]) for k in rows[0]}

    def training_step(self) -> Dict:
        config = self.config
        self._collect(int(config.get("rollout_fragment_length", 16)))
        bs = int(config["train_batch_size"])
        if (self._counters[NUM_ENV_STEPS_SAMPLED]
                < config.get("num_steps_sampled_before_learning_starts", 0)
                or len(self._buffer) < bs):
            return {}
        stats = self.learn_on_batch(self.sample_rows(bs))
        self._counters[NUM_ENV_STEPS_TRAINED] += bs
        return {DEFAULT_POLICY_ID: stats}

    # -- checkpoint state -------------------------------------------------

    def get_weights(self, read=None) -> Dict[str, Dict[str, np.ndarray]]:
        """``{"actor": {name: array}, "critic": {...}}`` (stacked)."""
        read = read or host_read
        return {g: {n: read(p) for n, p in zip(self.group_param_names(g), self._group(g))}
                for g in GROUPS}

    def __getstate__(self) -> Dict:
        read = host_read
        return {
            "params": self.get_weights(read),
            "target_params": {g: {n: read(t) for n, t in zip(self.group_param_names(g),
                                                             self.target[g])}
                              for g in GROUPS},
            "opt_state": {g: {"count": st.count,
                              "mu": dict(zip(self.group_param_names(g), map(read, st.mu))),
                              "nu": dict(zip(self.group_param_names(g), map(read, st.nu)))}
                          for g, st in self.opt_states.items()},
            "counters": dict(self._counters),
            "episodes_total": self._episodes_total,
        }

    @torch.no_grad()
    def __setstate__(self, state: Dict) -> None:
        for g in GROUPS:
            names = self.group_param_names(g)
            for n, p, t in zip(names, self._group(g), self.target[g]):
                p.copy_(torch.as_tensor(np.asarray(state["params"][g][n])))
                t.copy_(torch.as_tensor(np.asarray(state["target_params"][g][n])))
            st, saved = self.opt_states[g], state["opt_state"][g]
            st.count = int(saved["count"])
            for n, m, v in zip(names, st.mu, st.nu):
                m.copy_(torch.as_tensor(np.asarray(saved["mu"][n])))
                v.copy_(torch.as_tensor(np.asarray(saved["nu"][n])))
        self._counters = collections.defaultdict(int, state.get("counters", {}))
        self._episodes_total = state.get("episodes_total", 0)

    cleanup = Algorithm.stop  # the reference's name
