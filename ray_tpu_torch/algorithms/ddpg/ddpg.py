"""DDPG and TD3: a deterministic actor and a (twin) critic with target
networks, on the off-policy family's actor lane.

Counterpart of ``ray_tpu/algorithms/ddpg/ddpg.py``. ``DDPG`` extends
``DQN``: its round is DQN's actor-lane ``training_step`` (sample, the
host postprocess, insert into the device rings, the replay update
phase, the actor's weights to the workers); there is no device lane,
because no tensor env has a continuous action space (the reference's
neither). ``TD3`` is DDPG with twin critics, a smoothed target policy,
an actor step every ``policy_delay`` updates and Gaussian exploration.

:class:`DDPGTorchPolicy` keeps the actor (:class:`_DetActorNet`, tanh
mapped onto ``[low, high]``), the critic (SAC's ``_TwinQNet``; the
second tower is read only with ``twin_q``, as the reference builds it
whatever ``twin_q`` says), the target actor and critic and the update
counter ``step`` as aux state, and two Adam states (critic, actor). One
update (:meth:`DDPGTorchPolicy._ddpg_update`) is the reference's program
in its order:

1. the TD target from the target nets, the target action smoothed
   (TD3) by ``clip(target_noise * N(0, 1), ±target_noise_clip)``;
2. the critic step (squared or Huber error, IS ``weights``, ``l2_reg``);
3. the actor step through the **updated** critic, applied only when
   ``step % policy_delay == 0``: a masked step, so parameters, Adam
   moments and Adam's step index stay as they were otherwise (a graphed
   slot cannot branch on the host; the mask reads the device ``step``);
4. the Polyak blends, the target actor's only with the actor step;
5. ``step += 1``.

The smoothing draw comes from the policy's ``action_generator``, which a
graphed superstep slot registers; tests inject the reference's draws
(``normals=``). ``compute_td_error`` (``q1 - target``) makes its own
draw, as the reference's does. ``update_target`` is a no-op: the blends
are inside the update. Acting adds the exploration's noise to the
deterministic action (``Deterministic``); the OU process's per-slot
state lives on the policy, starts afresh whenever the batch size
changes, as the reference's, and travels in the checkpoint's
``exploration_state`` (``carried``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ray_tpu_torch.algorithms.dqn.dqn import DQN, DQNConfig
from ray_tpu_torch.algorithms.sac.sac import _TwinQNet, _flat
from ray_tpu_torch.data.sample_batch import SampleBatch
from ray_tpu_torch.models.base import Dense, TorchModel, get_activation
from ray_tpu_torch.models.distributions import Deterministic
from ray_tpu_torch.policy.torch_policy import AdamState, TorchPolicy, adam_update, global_norm

DDPG_STATS = ("actor_loss", "critic_loss", "mean_q", "mean_td_error", "total_loss")
# the columns an update reads, and so the replay columns
TRAIN_COLUMNS = (
    SampleBatch.OBS, SampleBatch.NEXT_OBS, SampleBatch.ACTIONS, SampleBatch.REWARDS,
    SampleBatch.TERMINATEDS, "weights", "n_steps",
)
# Adam groups in the order an update steps them
OPT_GROUPS = ("critic", "actor")


class _DetActorNet(nn.Module):
    """Hidden layers (``fc_i``), then ``out`` through tanh mapped onto
    ``[low, high]``."""

    def __init__(self, obs_size: int, action_dim: int, low: float, high: float,
                 hiddens: Sequence[int], activation: str, generator: Optional[torch.Generator]):
        super().__init__()
        self.act = get_activation(activation)
        self.num_hiddens = len(hiddens)
        self.mid = (high + low) / 2.0
        self.half = (high - low) / 2.0
        sizes = [obs_size, *hiddens]
        for i in range(len(hiddens)):
            setattr(self, f"fc_{i}", Dense(sizes[i], sizes[i + 1], generator=generator))
        self.out = Dense(sizes[-1], action_dim, generator=generator)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        x = _flat(obs)
        for i in range(self.num_hiddens):
            x = self.act(getattr(self, f"fc_{i}")(x))
        return self.mid + self.half * torch.tanh(self.out(x))


class _DDPGModel(TorchModel):
    """The actor and the critic: parameter names ``actor.*`` and
    ``critic.*``, the reference's top-level keys."""

    def __init__(self, obs_size: int, action_dim: int, low: float, high: float, cfg: Dict,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.actor = _DetActorNet(
            obs_size, action_dim, low, high, tuple(cfg.get("actor_hiddens", (400, 300))),
            cfg.get("actor_hidden_activation", "relu"), generator,
        )
        self.critic = _TwinQNet(
            obs_size + action_dim, tuple(cfg.get("critic_hiddens", (400, 300))),
            cfg.get("critic_hidden_activation", "relu"), generator,
        )


class DDPGConfig(DQNConfig):
    """The reference's DDPGConfig defaults."""

    def __init__(self, algo_class=None):
        super().__init__(algo_class or DDPG)
        self.twin_q = False
        self.policy_delay = 1
        self.smooth_target_policy = False
        self.target_noise = 0.2
        self.target_noise_clip = 0.5
        self.actor_hiddens = [400, 300]
        self.actor_hidden_activation = "relu"
        self.critic_hiddens = [400, 300]
        self.critic_hidden_activation = "relu"
        self.tau = 0.002
        self.use_huber = False
        self.huber_threshold = 1.0
        self.l2_reg = 1e-6
        self.actor_lr = 1e-3
        self.critic_lr = 1e-3
        self.train_batch_size = 256
        self.rollout_fragment_length = 1
        self.num_steps_sampled_before_learning_starts = 1500
        self.target_network_update_freq = 0
        self.n_step = 1
        self.grad_clip = None
        self.exploration_config = {
            "type": "OrnsteinUhlenbeckNoise",
            "scale_timesteps": 10000,
            "initial_scale": 1.0,
            "final_scale": 0.02,
            "ou_base_scale": 0.1,
            "ou_theta": 0.15,
            "ou_sigma": 0.2,
        }
        self.replay_buffer_config = {
            "capacity": 50000,
            "prioritized_replay": False,
            "prioritized_replay_alpha": 0.6,
            "prioritized_replay_beta": 0.4,
        }

    def training(
        self,
        *,
        twin_q: Optional[bool] = None,
        policy_delay: Optional[int] = None,
        smooth_target_policy: Optional[bool] = None,
        target_noise: Optional[float] = None,
        target_noise_clip: Optional[float] = None,
        actor_hiddens: Optional[Sequence[int]] = None,
        critic_hiddens: Optional[Sequence[int]] = None,
        tau: Optional[float] = None,
        use_huber: Optional[bool] = None,
        actor_lr: Optional[float] = None,
        critic_lr: Optional[float] = None,
        l2_reg: Optional[float] = None,
        **kwargs,
    ) -> "DDPGConfig":
        super().training(**kwargs)
        for name, value in (
            ("twin_q", twin_q),
            ("policy_delay", policy_delay),
            ("smooth_target_policy", smooth_target_policy),
            ("target_noise", target_noise),
            ("target_noise_clip", target_noise_clip),
            ("actor_hiddens", None if actor_hiddens is None else list(actor_hiddens)),
            ("critic_hiddens", None if critic_hiddens is None else list(critic_hiddens)),
            ("tau", tau),
            ("use_huber", use_huber),
            ("actor_lr", actor_lr),
            ("critic_lr", critic_lr),
            ("l2_reg", l2_reg),
        ):
            if value is not None:
                setattr(self, name, value)
        return self


class TD3Config(DDPGConfig):
    """The reference's TD3Config: twin critics, a delayed and smoothed
    target policy, Gaussian exploration."""

    def __init__(self, algo_class=None):
        super().__init__(algo_class or TD3)
        self.twin_q = True
        self.policy_delay = 2
        self.smooth_target_policy = True
        self.actor_lr = 1e-3
        self.critic_lr = 1e-3
        self.exploration_config = {
            "type": "GaussianNoise",
            "stddev": 0.1,
            "initial_scale": 1.0,
            "final_scale": 1.0,
            "scale_timesteps": 1,
        }
        self.num_steps_sampled_before_learning_starts = 10000


class DDPGTorchPolicy(TorchPolicy):
    """The deterministic actor-critic loss with two optimizers, one
    update at a time (:meth:`learn_on_device_batch`) or as a superstep
    slot."""

    default_exploration = "OrnsteinUhlenbeckNoise"
    inference_weight_keys = ("actor",)

    def __init__(self, observation_space, action_space, config: Dict, device=None):
        self.action_dim = int(np.prod(action_space.shape))
        self.low = float(np.min(action_space.low))
        self.high = float(np.max(action_space.high))
        super().__init__(observation_space, action_space, config, device=device)
        self.actor = self.model.actor
        self.critic = self.model.critic
        self.actor_names = [n for n, _ in self.actor.named_parameters()]
        self.critic_names = [n for n, _ in self.critic.named_parameters()]
        self.tau = float(config.get("tau", 0.002))
        self.gamma = float(config.get("gamma", 0.99))
        self.n_step = int(config.get("n_step", 1))
        self.twin_q = bool(config.get("twin_q", False))
        self.policy_delay = int(config.get("policy_delay", 1))
        self.use_huber = bool(config.get("use_huber", False))
        self.huber_threshold = float(config.get("huber_threshold", 1.0))
        self.l2_reg = float(config.get("l2_reg", 0.0) or 0.0)
        # the host's mirror of aux_state["step"]: updates made so far
        self.num_updates = 0
        # the OU process's per-slot state (compute_actions)
        self._expl_state = ()
        self._expl_state_batch = -1

    # -- construction ------------------------------------------------------

    def _make_model(self, observation_space, action_space, num_outputs, generator):
        return _DDPGModel(int(np.prod(observation_space.shape)), self.action_dim, self.low,
                          self.high, self.config, generator)

    def _group_params(self, group: str) -> List[torch.Tensor]:
        return list(getattr(self.model, group).parameters())

    def group_param_names(self, group: str) -> List[str]:
        """The full parameter names of an Adam group, in its order."""
        return [f"{group}.{n}" for n, _ in getattr(self.model, group).named_parameters()]

    def _init_optimizer(self) -> None:
        self.opt_states = {g: AdamState(self._group_params(g)) for g in OPT_GROUPS}
        self.opt_state = None

    def _adam_states(self) -> List[AdamState]:
        return [self.opt_states[g] for g in OPT_GROUPS]

    def _init_coeffs(self) -> None:
        for group in OPT_GROUPS:
            self.coeff_values[f"{group}_lr"] = float(self.config.get(f"{group}_lr", 1e-3))

    def _init_aux_state(self) -> Dict[str, Any]:
        return {
            "target_actor": [p.detach().clone() for p in self.model.actor.parameters()],
            "target_critic": [p.detach().clone() for p in self.model.critic.parameters()],
            "step": torch.zeros((), dtype=torch.int64, device=self.device),
        }

    def _learner_tensors(self) -> List[torch.Tensor]:
        aux = self.aux_state
        return (super()._learner_tensors() + list(aux["target_actor"])
                + list(aux["target_critic"]) + [aux["step"]])

    # -- acting ------------------------------------------------------------

    @torch.no_grad()
    def act_dist_signature(self):
        obs = torch.zeros((1,) + tuple(self.observation_space.shape), device=self.device)
        det = self.actor(obs)
        return Deterministic, tuple(det.shape[1:]), det.dtype

    def _act(self, obs, generator, explore, coeffs, draws, expl_state):
        dist = Deterministic(self.actor(obs))
        actions, _, expl_state = self.exploration.sample_fn(
            dist, generator, explore, coeffs, expl_state, draws
        )
        return actions, expl_state

    def _action_step_body(self, obs, generator, explore=True, actions=None, coeffs=None,
                          draws=(), **_):
        """One step of a stateless exploration (the serving plane's
        programs; a stateful one is served by :meth:`compute_actions`):
        the noisy action, no extra fetches, as the reference's."""
        if actions is None:
            actions, _ = self._act(obs, generator, explore,
                                   self.coeff_values if coeffs is None else coeffs, draws, ())
        return actions, (), {}

    @torch.no_grad()
    def compute_actions(self, obs_batch, state_batches=None, prev_action_batch=None,
                        prev_reward_batch=None, explore: bool = True, **kwargs):
        """The actor's action plus the exploration's noise; the OU state
        carries from call to call and starts afresh when the batch size
        changes, as the reference's."""
        self.exploration.update_coeffs(self.coeff_values, self.global_timestep)
        obs = torch.as_tensor(np.asarray(obs_batch), device=self.device)
        n = int(obs.shape[0])
        if self._expl_state_batch != n:
            self._expl_state = self.exploration.initial_state(n, self.device)
            self._expl_state_batch = n
        actions, self._expl_state = self._act(
            obs, self.action_generator, explore, self.coeff_values, (), self._expl_state
        )
        return actions.cpu().numpy(), [], {}

    # -- the update --------------------------------------------------------

    def _train_columns(self, samples, keep_state_in: bool = False) -> Dict[str, np.ndarray]:
        """The columns an update reads, float64 ones as float32 (the
        update casts to float32 anyway; half the bytes to the device)."""
        out = {}
        for k in TRAIN_COLUMNS:
            if k in samples:
                v = np.asarray(samples[k])
                out[k] = v.astype(np.float32) if v.dtype == np.float64 else v
        return out

    def _target_actor(self, obs: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(
            self.actor, dict(zip(self.actor_names, self.aux_state["target_actor"])), (obs,))

    def _td_targets(self, batch: Dict[str, torch.Tensor], normal: Optional[torch.Tensor] = None):
        """``r + gamma^n (1 - done) Q_target(s', a')`` (no gradient), with
        ``a'`` the target actor's action, smoothed under
        ``smooth_target_policy`` by ``normal`` (drawn when None); Q the
        smaller target tower under ``twin_q``, else the first."""
        cfg = self.config
        next_obs = batch[SampleBatch.NEXT_OBS].to(torch.float32)
        rewards = batch[SampleBatch.REWARDS].to(torch.float32)
        not_done = 1.0 - batch[SampleBatch.TERMINATEDS].to(torch.float32)
        steps = batch.get("n_steps")
        gamma_n = (torch.pow(self.gamma, steps.to(torch.float32)) if steps is not None
                   else self.gamma ** self.n_step)
        with torch.no_grad():
            next_a = self._target_actor(next_obs)
            if cfg.get("smooth_target_policy"):
                if normal is None:
                    normal = torch.randn(next_a.shape, generator=self.action_generator,
                                         device=self.device)
                clip = float(cfg.get("target_noise_clip", 0.5))
                noise = torch.clamp(float(cfg.get("target_noise", 0.2)) * normal, -clip, clip)
                next_a = torch.clamp(next_a + noise, self.low, self.high)
            tq1, tq2 = torch.func.functional_call(
                self.critic, dict(zip(self.critic_names, self.aux_state["target_critic"])),
                (next_obs, next_a),
            )
            target_q = torch.minimum(tq1, tq2) if self.twin_q else tq1
            return rewards + gamma_n * not_done * target_q

    def _base_loss(self, err: torch.Tensor) -> torch.Tensor:
        if self.use_huber:
            a, d = torch.abs(err), self.huber_threshold
            return torch.where(a < d, 0.5 * torch.square(err), d * (a - 0.5 * d))
        return torch.square(err)

    def _masked(self, keep: torch.Tensor, tensors: List[torch.Tensor], step) -> None:
        """Run ``step()`` (which writes ``tensors`` in place), then put
        back their old values where ``keep`` is False."""
        saved = [t.detach().clone() for t in tensors]
        step()
        with torch.no_grad():
            for t, old in zip(tensors, saved):
                t.copy_(torch.where(keep, t, old))

    def _ddpg_update(
        self,
        batch: Dict[str, torch.Tensor],
        coeffs: Dict[str, torch.Tensor],
        normal: Optional[torch.Tensor] = None,
    ):
        """One update with no host read; ``(DDPG_STATS, (5,) device
        stats)``. ``normal``: the (B, action_dim) standard normals of the
        target smoothing, else drawn (TD3 only)."""
        obs = batch[SampleBatch.OBS].to(torch.float32)
        actions = batch[SampleBatch.ACTIONS].to(torch.float32)
        td_target = self._td_targets(batch, normal)
        weights = batch.get("weights")
        if weights is None:
            weights = torch.ones_like(td_target)
        st, aux = self.opt_states, self.aux_state

        # the critic
        critic_p = self._group_params("critic")
        q1, q2 = self.critic(obs, actions)
        err1 = q1 - td_target
        c_loss = torch.mean(weights * self._base_loss(err1))
        if self.twin_q:
            c_loss = c_loss + torch.mean(weights * self._base_loss(q2 - td_target))
        if self.l2_reg:
            c_loss = c_loss + self.l2_reg * global_norm(critic_p) ** 2
        c_grads = torch.autograd.grad(c_loss, critic_p, allow_unused=True, materialize_grads=True)
        adam_update(critic_p, list(c_grads), st["critic"], coeffs["critic_lr"], self.adam_eps, None)

        # the actor through the updated critic, every policy_delay-th update
        actor_p = self._group_params("actor")
        aq1, _ = self.critic(obs, self.actor(obs))
        a_loss = -torch.mean(aq1)
        if self.l2_reg:
            a_loss = a_loss + self.l2_reg * global_norm(actor_p) ** 2
        a_grads = torch.autograd.grad(a_loss, actor_p)

        def actor_step():
            adam_update(actor_p, list(a_grads), st["actor"], coeffs["actor_lr"], self.adam_eps,
                        None)

        with torch.no_grad():
            if self.policy_delay == 1:
                actor_step()
                torch._foreach_mul_(aux["target_actor"], 1.0 - self.tau)
                torch._foreach_add_(aux["target_actor"],
                                    torch._foreach_mul([p.detach() for p in actor_p], self.tau))
            else:
                do_update = torch.remainder(aux["step"], self.policy_delay) == 0
                actor_st = st["actor"]
                self._masked(do_update, actor_p + actor_st.mu + actor_st.nu + [actor_st.step],
                             actor_step)
                blended = torch._foreach_mul(aux["target_actor"], 1.0 - self.tau)
                torch._foreach_add_(blended, torch._foreach_mul([p.detach() for p in actor_p],
                                                                self.tau))
                for t, b in zip(aux["target_actor"], blended):
                    t.copy_(torch.where(do_update, b, t))
            target = aux["target_critic"]
            torch._foreach_mul_(target, 1.0 - self.tau)
            torch._foreach_add_(target, torch._foreach_mul([p.detach() for p in critic_p],
                                                           self.tau))
            aux["step"].add_(1)
            a_loss, c_loss = a_loss.detach(), c_loss.detach()
            stats = torch.stack([a_loss, c_loss, torch.mean(q1).detach(),
                                 torch.mean(err1).detach(), a_loss + c_loss])
        return DDPG_STATS, stats

    def learn_on_batch(self, samples, normals=None) -> Dict[str, Any]:
        """One update on a host batch."""
        batch, bsize = self.prepare_batch(samples)
        dev = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}
        return self.learn_on_device_batch(dev, bsize, normals=normals)

    def learn_on_device_batch(self, dev_batch, batch_size, normals=None):
        """One update on a device batch: the two Adam steps, the blends
        and the stats as floats."""
        self._update_scheduled_coeffs()
        self._load_corrections(1)
        names, reduced = self._ddpg_update(dict(dev_batch), self._load_coeffs(), normals)
        self._advance_adam_counts(1)
        self.num_grad_updates += 1
        return dict(zip(names, reduced.tolist()))

    def _advance_adam_counts(self, steps: int) -> None:
        """``steps`` updates: the critic stepped each time, the actor
        where ``num_updates % policy_delay == 0``."""
        first, self.num_updates = self.num_updates, self.num_updates + steps
        self.opt_states["critic"].count += steps
        d = self.policy_delay
        self.opt_states["actor"].count += -(-self.num_updates // d) - (-(-first // d))

    def _steps_per_update(self, batch_size: int) -> int:
        return 1

    def _host_permutations(self, batch_size: int) -> torch.Tensor:
        """An update reads its rows in order: a superstep's permutation
        slots hold zeros, and the permutation generator draws nothing."""
        return torch.zeros((self.num_sgd_iter, self._perm_width(batch_size)), dtype=torch.int64)

    def _info_extras(self) -> Dict[str, float]:
        return {}  # the reference's DDPG stats carry no learning rate

    def _slot_update(self, runner, batch, batch_size):
        return self._ddpg_update(batch, self._coeff_tensors)

    def _td_error(self, batch: Dict[str, torch.Tensor], aux: Dict[str, Any],
                  normal: Optional[torch.Tensor] = None):
        """``(q1 - TD target,)`` per row, with its own smoothing draw."""
        with torch.no_grad():
            td_target = self._td_targets(batch, normal)
            q1, _ = self.critic(batch[SampleBatch.OBS].to(torch.float32),
                                batch[SampleBatch.ACTIONS].to(torch.float32))
            return (q1 - td_target,)

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
        """No-op: the Polyak blends run inside every update."""

    # -- state -------------------------------------------------------------

    def get_state(self) -> Dict[str, Any]:
        def host(ts, names):
            return {n: t.detach().cpu().numpy() for n, t in zip(names, ts)}

        aux = self.aux_state
        return {
            "weights": self.get_weights(),
            "opt_state": {
                g: {"count": self.opt_states[g].count,
                    "mu": host(self.opt_states[g].mu, self.group_param_names(g)),
                    "nu": host(self.opt_states[g].nu, self.group_param_names(g))}
                for g in OPT_GROUPS
            },
            "aux_state": {
                "target_actor": host(aux["target_actor"], self.actor_names),
                "target_critic": host(aux["target_critic"], self.critic_names),
                "step": int(aux["step"]),
            },
            "coeff_values": dict(self.coeff_values),
            "global_timestep": self.global_timestep,
            "num_grad_updates": self.num_grad_updates,
            "exploration_state": {
                **self.exploration.get_state(),
                "carried": [t.cpu().numpy() for t in self._expl_state],
            },
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
        aux = state.get("aux_state")
        if aux is not None:
            for key, names in (("target_actor", self.actor_names),
                               ("target_critic", self.critic_names)):
                for n, t in zip(names, self.aux_state[key]):
                    t.copy_(torch.as_tensor(np.asarray(aux[key][n])))
            self.aux_state["step"].fill_(int(aux["step"]))
            self.num_updates = int(aux["step"])
        self.coeff_values.update(state.get("coeff_values", {}))
        self.global_timestep = state.get("global_timestep", 0)
        self.num_grad_updates = state.get("num_grad_updates", 0)
        expl = dict(state.get("exploration_state", {}))
        carried = expl.pop("carried", None)
        self.exploration.set_state(expl)
        if carried is not None:
            self._expl_state = tuple(torch.as_tensor(np.asarray(c), device=self.device)
                                     for c in carried)
            self._expl_state_batch = int(carried[0].shape[0]) if carried else -1


class DDPG(DQN):
    _default_policy_class = DDPGTorchPolicy

    @classmethod
    def get_default_config(cls) -> DDPGConfig:
        return DDPGConfig(cls)

    def training_step(self) -> Dict:
        if self.config.get("env_backend") == "jax":
            raise NotImplementedError(
                "DDPG and TD3 run on the actor lane: no tensor env has a continuous action "
                "space (the reference's neither)"
            )
        return self._training_step_actor_lane()


class TD3(DDPG):
    @classmethod
    def get_default_config(cls) -> TD3Config:
        return TD3Config(cls)
