"""SAC: soft actor-critic with a twin Q critic and a learned entropy
temperature.

Counterpart of ``ray_tpu/algorithms/sac/sac.py``. ``SAC`` extends
``DQN``: its round is DQN's actor-lane ``training_step`` (sample, insert
into the device rings, the replay update phase, the actor's weights to
the workers); there is no device lane, because no tensor env has a
continuous action space (the reference's neither).

:class:`SACTorchPolicy` keeps its own nets (:class:`_ActorNet`, the
squashed Gaussian's mean and log-std; :class:`_TwinQNet`, two towers
over ``concat(obs, act)``), ``log_alpha`` as a 0-d parameter, the
target critic as aux state, and three Adam states (critic, actor,
``log_alpha``), each with its own bias-correction table and step count.
One update (:meth:`SACTorchPolicy._sac_update`) is the reference's
program in its order:

1. ``alpha = exp(log_alpha)``, read once, before any step;
2. the critic step against the soft TD target (the target critic at a
   fresh squashed sample of the next action);
3. the actor step through the **updated** critic, with respect to the
   actor's parameters only;
4. the alpha step on ``-mean(log_alpha * (logp_pi + target_entropy))``
   with ``logp_pi`` held fixed;
5. the Polyak blend ``(1 - tau) * target + tau * critic``.

Its two standard-normal draws (the next action's and the policy
action's) come from the policy's ``action_generator``, which a graphed
superstep slot registers (``sharding/superstep.py``); tests inject the
reference's draws instead (``normals=``). ``compute_td_error`` makes a
third draw, as the reference's does. ``update_target`` is a no-op: the
blend is inside the update, and the algorithm still calls it (and counts
``num_target_updates``) every round, as the reference does with
``target_network_update_freq = 0``. The reference builds the twin critic
whatever ``twin_q`` says, and so does the port. Workers act with the
actor alone (``inference_weight_keys``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ray_tpu_torch.algorithms.dqn.dqn import DQN, DQNConfig
from ray_tpu_torch.data.sample_batch import SampleBatch
from ray_tpu_torch.models.base import Dense, TorchModel, get_activation
from ray_tpu_torch.models.distributions import SquashedGaussian
from ray_tpu_torch.policy.torch_policy import AdamState, TorchPolicy, adam_update

SAC_STATS = ("actor_loss", "critic_loss", "alpha_loss", "alpha_value", "mean_q", "total_loss")
# the columns an update reads, and so the replay columns
TRAIN_COLUMNS = (
    SampleBatch.OBS, SampleBatch.NEXT_OBS, SampleBatch.ACTIONS,
    SampleBatch.REWARDS, SampleBatch.TERMINATEDS,
)
# Adam groups in the order an update steps them
OPT_GROUPS = ("critic", "actor", "log_alpha")
_LR_KEYS = {"critic": "critic_learning_rate", "actor": "actor_learning_rate",
            "log_alpha": "entropy_learning_rate"}


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).reshape(x.shape[0], -1)


class _ActorNet(nn.Module):
    """Hidden layers, then ``2 * action_dim`` outputs (mean, log-std)."""

    def __init__(self, obs_size: int, action_dim: int, hiddens: Sequence[int],
                 activation: str, generator: Optional[torch.Generator]):
        super().__init__()
        self.act = get_activation(activation)
        self.num_hiddens = len(hiddens)
        sizes = [obs_size, *hiddens]
        for i in range(len(hiddens)):
            setattr(self, f"fc_{i}", Dense(sizes[i], sizes[i + 1], generator=generator))
        self.out = Dense(sizes[-1], 2 * action_dim, generator=generator)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        x = _flat(obs)
        for i in range(self.num_hiddens):
            x = self.act(getattr(self, f"fc_{i}")(x))
        return self.out(x)


class _TwinQNet(nn.Module):
    """Two Q towers (``q1_*``, ``q2_*``) over ``concat(obs, actions)``."""

    def __init__(self, in_size: int, hiddens: Sequence[int], activation: str,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.act = get_activation(activation)
        self.num_hiddens = len(hiddens)
        sizes = [in_size, *hiddens]
        for name in ("q1", "q2"):
            for i in range(len(hiddens)):
                setattr(self, f"{name}_fc_{i}", Dense(sizes[i], sizes[i + 1], generator=generator))
            setattr(self, f"{name}_out", Dense(sizes[-1], 1, generator=generator))

    def forward(self, obs: torch.Tensor, actions: torch.Tensor):
        x0 = torch.cat([_flat(obs), _flat(actions)], dim=-1)
        qs = []
        for name in ("q1", "q2"):
            x = x0
            for i in range(self.num_hiddens):
                x = self.act(getattr(self, f"{name}_fc_{i}")(x))
            qs.append(getattr(self, f"{name}_out")(x).squeeze(-1))
        return qs[0], qs[1]


class _SACModel(TorchModel):
    """The actor, the twin critic and ``log_alpha``: parameter names
    ``actor.*``, ``critic.*`` and ``log_alpha``, the reference's
    top-level keys."""

    def __init__(self, obs_size: int, action_dim: int, pm_cfg: Dict, qm_cfg: Dict,
                 initial_alpha: float, generator: Optional[torch.Generator]):
        super().__init__()
        self.actor = _ActorNet(
            obs_size, action_dim, tuple(pm_cfg.get("fcnet_hiddens", (256, 256))),
            pm_cfg.get("fcnet_activation", "relu"), generator,
        )
        self.critic = _TwinQNet(
            obs_size + action_dim, tuple(qm_cfg.get("fcnet_hiddens", (256, 256))),
            qm_cfg.get("fcnet_activation", "relu"), generator,
        )
        self.log_alpha = nn.Parameter(
            torch.tensor(np.log(initial_alpha), dtype=torch.float32)
        )


class SACConfig(DQNConfig):
    """The reference's SACConfig defaults."""

    def __init__(self, algo_class=None):
        super().__init__(algo_class or SAC)
        self.twin_q = True
        self.tau = 5e-3
        self.initial_alpha = 1.0
        self.target_entropy = "auto"
        self.optimization = {
            "actor_learning_rate": 3e-4,
            "critic_learning_rate": 3e-4,
            "entropy_learning_rate": 3e-4,
        }
        self.train_batch_size = 256
        self.rollout_fragment_length = 1
        self.num_steps_sampled_before_learning_starts = 1500
        self.target_network_update_freq = 0
        self.q_model_config = {"fcnet_hiddens": [256, 256]}
        self.policy_model_config = {"fcnet_hiddens": [256, 256]}
        self.n_step = 1
        self.grad_clip = None
        self.replay_buffer_config = {
            "capacity": 100000,
            "prioritized_replay": False,
            "prioritized_replay_alpha": 0.6,
            "prioritized_replay_beta": 0.4,
        }

    def training(
        self,
        *,
        twin_q: Optional[bool] = None,
        tau: Optional[float] = None,
        initial_alpha: Optional[float] = None,
        target_entropy=None,
        optimization: Optional[Dict] = None,
        q_model_config: Optional[Dict] = None,
        policy_model_config: Optional[Dict] = None,
        **kwargs,
    ) -> "SACConfig":
        super().training(**kwargs)
        if optimization is not None:
            self.optimization = {**self.optimization, **optimization}
        for name, value in (
            ("twin_q", twin_q),
            ("tau", tau),
            ("initial_alpha", initial_alpha),
            ("target_entropy", target_entropy),
            ("q_model_config", q_model_config),
            ("policy_model_config", policy_model_config),
        ):
            if value is not None:
                setattr(self, name, value)
        return self


class SACTorchPolicy(TorchPolicy):
    """Actor, critic and alpha losses with three optimizers, one update
    at a time (:meth:`learn_on_device_batch`) or as a superstep slot."""

    inference_weight_keys = ("actor",)

    def __init__(self, observation_space, action_space, config: Dict, device=None):
        for key in ("model", "policy_model_config", "q_model_config"):
            cfg = config.get(key) or {}
            if cfg.get("use_lstm") or cfg.get("use_attention"):
                raise ValueError(
                    f"SAC with a recurrent {key} (use_lstm/use_attention) requires sequence "
                    "replay — use RNNSAC (reference rnnsac.py) or, for Q-learning, the R2D2 "
                    "algorithm (reference r2d2.py); neither is ported yet: ROADMAP.md queue 1 "
                    "item 9"
                )
        self.action_dim = int(np.prod(action_space.shape))
        self.low = float(np.min(action_space.low))
        self.high = float(np.max(action_space.high))
        super().__init__(observation_space, action_space, config, device=device)
        self.actor = self.model.actor
        self.critic = self.model.critic
        self.critic_names = [n for n, _ in self.critic.named_parameters()]
        te = config.get("target_entropy", "auto")
        self.target_entropy = -float(self.action_dim) if te in (None, "auto") else float(te)
        self.tau = float(config.get("tau", 5e-3))
        self.gamma = float(config.get("gamma", 0.99))
        self.n_step = int(config.get("n_step", 1))

    # -- construction ------------------------------------------------------

    def _make_model(self, observation_space, action_space, num_outputs, generator):
        cfg = self.config
        return _SACModel(
            int(np.prod(observation_space.shape)), self.action_dim,
            dict(cfg.get("policy_model_config") or {}), dict(cfg.get("q_model_config") or {}),
            float(cfg.get("initial_alpha", 1.0)), generator,
        )

    def _group_params(self, group: str) -> List[torch.Tensor]:
        if group == "log_alpha":
            return [self.model.log_alpha]
        return list(getattr(self.model, group).parameters())

    def group_param_names(self, group: str) -> List[str]:
        """The full parameter names of an Adam group, in its order."""
        if group == "log_alpha":
            return ["log_alpha"]
        return [f"{group}.{n}" for n, _ in getattr(self.model, group).named_parameters()]

    def _init_optimizer(self) -> None:
        self.opt_states = {g: AdamState(self._group_params(g)) for g in OPT_GROUPS}
        self.opt_state = None

    def _adam_states(self) -> List[AdamState]:
        return [self.opt_states[g] for g in OPT_GROUPS]

    def _init_coeffs(self) -> None:
        opt = self.config.get("optimization") or {}
        for group, key in _LR_KEYS.items():
            self.coeff_values[f"{group}_lr"] = float(opt.get(key, 3e-4))

    def _init_aux_state(self) -> Dict[str, Any]:
        return {"target_critic": [p.detach().clone() for p in self.model.critic.parameters()]}

    def _learner_tensors(self) -> List[torch.Tensor]:
        return super()._learner_tensors() + list(self.aux_state["target_critic"])

    # -- acting ------------------------------------------------------------

    def _dist(self, obs: torch.Tensor) -> SquashedGaussian:
        return SquashedGaussian(self.actor(obs), low=self.low, high=self.high)

    @torch.no_grad()
    def act_dist_signature(self):
        obs = torch.zeros((1,) + tuple(self.observation_space.shape), device=self.device)
        dist_inputs = self.actor(obs)
        return SquashedGaussian, tuple(dist_inputs.shape[1:]), dist_inputs.dtype

    def _action_step_body(self, obs, generator, explore=True, actions=None, coeffs=None,
                          draws=()):
        """The squashed sample and its log-probability (the mode when not
        exploring); SAC fetches ``ACTION_LOGP`` only."""
        dist = self._dist(obs)
        if actions is None:
            actions, logp, _ = self.exploration.sample_fn(
                dist, generator, explore, self.coeff_values if coeffs is None else coeffs, (),
                draws,
            )
        else:
            logp = dist.logp(actions)
        return actions, (), {SampleBatch.ACTION_LOGP: logp}

    # -- the update --------------------------------------------------------

    def _train_columns(self, samples, keep_state_in: bool = False) -> Dict[str, np.ndarray]:
        """The five columns an update reads, float64 ones as float32 (the
        update casts to float32 anyway; half the bytes to the device).
        SAC's nets are feed-forward: there is no state to keep."""
        out = {}
        for k in TRAIN_COLUMNS:
            if k in samples:
                v = np.asarray(samples[k])
                out[k] = v.astype(np.float32) if v.dtype == np.float64 else v
        return out

    def _draw_normals(self, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        shape = (n, self.action_dim)
        g = self.action_generator
        return (torch.randn(shape, generator=g, device=self.device),
                torch.randn(shape, generator=g, device=self.device))

    def _target_q(self, next_obs: torch.Tensor, eps: torch.Tensor, alpha: torch.Tensor):
        """``min(target q1, q2) - alpha * logp`` at a squashed sample of the
        next action (no gradient)."""
        with torch.no_grad():
            next_a, next_logp = self._dist(next_obs).sampled_action_logp(None, eps)
            tq1, tq2 = torch.func.functional_call(
                self.critic, dict(zip(self.critic_names, self.aux_state["target_critic"])),
                (next_obs, next_a),
            )
            return torch.minimum(tq1, tq2) - alpha * next_logp

    def _sac_update(
        self,
        batch: Dict[str, torch.Tensor],
        coeffs: Dict[str, torch.Tensor],
        normals: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> Tuple[Tuple[str, ...], torch.Tensor]:
        """One update with no host read; ``(SAC_STATS, (6,) device
        stats)``. ``normals``: the (B, action_dim) standard normals of the
        next action and of the policy action, else drawn."""
        obs = batch[SampleBatch.OBS]
        next_obs = batch[SampleBatch.NEXT_OBS]
        rewards = batch[SampleBatch.REWARDS].to(torch.float32)
        not_done = 1.0 - batch[SampleBatch.TERMINATEDS].to(torch.float32)
        actions = batch[SampleBatch.ACTIONS].to(torch.float32)
        eps_t, eps_a = self._draw_normals(obs.shape[0]) if normals is None else normals
        log_alpha = self.model.log_alpha
        alpha = torch.exp(log_alpha.detach())
        st = self.opt_states

        # the critic against the soft TD target
        with torch.no_grad():
            td_target = (rewards + self.gamma ** self.n_step * not_done
                         * self._target_q(next_obs, eps_t, alpha))
        critic_p = self._group_params("critic")
        q1, q2 = self.critic(obs, actions)
        c_loss = torch.mean(torch.square(q1 - td_target)) + torch.mean(torch.square(q2 - td_target))
        c_grads = torch.autograd.grad(c_loss, critic_p)
        adam_update(critic_p, list(c_grads), st["critic"], coeffs["critic_lr"], self.adam_eps, None)

        # the actor through the updated critic
        actor_p = self._group_params("actor")
        a, logp = self._dist(obs).sampled_action_logp(None, eps_a)
        aq1, aq2 = self.critic(obs, a)
        a_loss = torch.mean(alpha * logp - torch.minimum(aq1, aq2))
        a_grads = torch.autograd.grad(a_loss, actor_p)
        adam_update(actor_p, list(a_grads), st["actor"], coeffs["actor_lr"], self.adam_eps, None)

        # the temperature
        al_loss = -torch.mean(log_alpha * (logp.detach() + self.target_entropy))
        (al_grad,) = torch.autograd.grad(al_loss, [log_alpha])
        adam_update([log_alpha], [al_grad], st["log_alpha"], coeffs["log_alpha_lr"],
                    self.adam_eps, None)

        with torch.no_grad():
            target = self.aux_state["target_critic"]
            torch._foreach_mul_(target, 1.0 - self.tau)
            torch._foreach_add_(target, torch._foreach_mul([p.detach() for p in critic_p], self.tau))
            a_loss, c_loss, al_loss = a_loss.detach(), c_loss.detach(), al_loss.detach()
            stats = torch.stack([
                a_loss, c_loss, al_loss, alpha,
                torch.mean(torch.minimum(q1, q2)).detach(), a_loss + c_loss + al_loss,
            ])
        return SAC_STATS, stats

    def learn_on_batch(self, samples, normals=None) -> Dict[str, Any]:
        """One update on a host batch."""
        batch, bsize = self.prepare_batch(samples)
        dev = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}
        return self.learn_on_device_batch(dev, bsize, normals=normals)

    def learn_on_device_batch(self, dev_batch, batch_size, normals=None):
        """One update on a device batch: the three Adam steps, the blend
        and the stats as floats."""
        self._update_scheduled_coeffs()
        self._load_corrections(1)
        names, reduced = self._sac_update(dict(dev_batch), self._load_coeffs(), normals)
        for st in self._adam_states():
            st.count += 1
        self.num_grad_updates += 1
        return dict(zip(names, reduced.tolist()))

    def _steps_per_update(self, batch_size: int) -> int:
        return 1

    def _host_permutations(self, batch_size: int) -> torch.Tensor:
        """An update reads its rows in order: a superstep's permutation
        slots hold zeros, and the permutation generator draws nothing (as
        the eager update's)."""
        return torch.zeros((self.num_sgd_iter, self._perm_width(batch_size)), dtype=torch.int64)

    def _info_extras(self) -> Dict[str, float]:
        return {}  # the reference's SAC stats carry no learning rate

    def _slot_update(self, runner, batch, batch_size):
        return self._sac_update(batch, self._coeff_tensors)

    def _td_error(self, batch: Dict[str, torch.Tensor], aux: Dict[str, Any],
                  normal: Optional[torch.Tensor] = None):
        """``(min(q1, q2) - soft TD target,)`` per row, at its own draw of
        the next action (``normal``, else from the generator)."""
        obs = batch[SampleBatch.OBS]
        if normal is None:
            normal = torch.randn((obs.shape[0], self.action_dim),
                                 generator=self.action_generator, device=self.device)
        with torch.no_grad():
            alpha = torch.exp(self.model.log_alpha.detach())
            not_done = 1.0 - batch[SampleBatch.TERMINATEDS].to(torch.float32)
            td_target = (batch[SampleBatch.REWARDS].to(torch.float32)
                         + self.gamma ** self.n_step * not_done
                         * self._target_q(batch[SampleBatch.NEXT_OBS], normal, alpha))
            q1, q2 = self.critic(obs, batch[SampleBatch.ACTIONS].to(torch.float32))
            return (torch.minimum(q1, q2) - td_target,)

    @torch.no_grad()
    def compute_td_error(self, samples, normal: Optional[torch.Tensor] = None) -> np.ndarray:
        """Per-row |TD error| for the priority refresh (host numpy f32)."""
        if getattr(samples, "is_device_resident", False):
            tree = samples.tree
        else:
            tree = {k: torch.as_tensor(v).to(self.device)
                    for k, v in self._train_columns(samples).items()}
        return np.abs(self._td_error(tree, self.aux_state, normal)[0].cpu().numpy())

    def update_target(self) -> None:
        """No-op: the Polyak blend runs inside every update."""

    # -- state -------------------------------------------------------------

    def get_state(self) -> Dict[str, Any]:
        def host(ts, names):
            return {n: t.detach().cpu().numpy() for n, t in zip(names, ts)}

        return {
            "weights": self.get_weights(),
            "opt_state": {
                g: {"count": self.opt_states[g].count,
                    "mu": host(self.opt_states[g].mu, self.group_param_names(g)),
                    "nu": host(self.opt_states[g].nu, self.group_param_names(g))}
                for g in OPT_GROUPS
            },
            "target_weights": host(self.aux_state["target_critic"], self.critic_names),
            "coeff_values": dict(self.coeff_values),
            "global_timestep": self.global_timestep,
            "num_grad_updates": self.num_grad_updates,
            "exploration_state": self.exploration.get_state(),
        }

    @torch.no_grad()
    def set_state(self, state: Dict[str, Any]) -> None:
        self.set_weights(state["weights"])
        for g, s in (state.get("opt_state") or {}).items():
            st = self.opt_states[g]
            st.count = int(s["count"])
            for i, n in enumerate(self.group_param_names(g)):
                st.mu[i].copy_(torch.as_tensor(np.asarray(s["mu"][n])))
                st.nu[i].copy_(torch.as_tensor(np.asarray(s["nu"][n])))
        target = state.get("target_weights")
        if target is not None:
            for n, t in zip(self.critic_names, self.aux_state["target_critic"]):
                t.copy_(torch.as_tensor(np.asarray(target[n])))
        self.coeff_values.update(state.get("coeff_values", {}))
        self.global_timestep = state.get("global_timestep", 0)
        self.num_grad_updates = state.get("num_grad_updates", 0)
        self.exploration.set_state(state.get("exploration_state", {}))


class SAC(DQN):
    _default_policy_class = SACTorchPolicy

    @classmethod
    def get_default_config(cls) -> SACConfig:
        return SACConfig(cls)

    def training_step(self) -> Dict:
        if self.config.get("env_backend") == "jax":
            raise NotImplementedError(
                "SAC runs on the actor lane: no tensor env has a continuous action space "
                "(the reference's SAC neither)"
            )
        return self._training_step_actor_lane()
