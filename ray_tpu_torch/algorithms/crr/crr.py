"""CRR: critic-regularized regression for offline RL.

Counterpart of ``ray_tpu/algorithms/crr/crr.py``. :class:`CRRTorchPolicy`
keeps SAC's nets (actor, twin critic; ``log_alpha`` is built and never
trained, as in the reference) with a target actor and a target critic,
and one update is the reference's, in its order
(:meth:`CRRTorchPolicy._sac_update`):

1. the critic's TD step against ``r + gamma * (1 - done) * min(target
   q1, q2)`` at a squashed sample of the next action from the **target**
   actor;
2. the advantage ``min(q1, q2)(s, a) - mean_n min(q1, q2)(s, a_n)``
   through the updated critic, with ``n_action_sample`` policy samples
   ``a_n``, held fixed;
3. the actor's weighted behaviour cloning, ``-mean(w * logp(a))``, with
   ``w = 1[adv > 0]`` (``weight_type`` "bin") or ``clip(exp(adv /
   temperature), 0, max_weight)`` ("exp");
4. every ``target_update_grad_intervals`` updates, a hard copy of both
   nets into their targets: a device select on the update counter
   ``step`` (aux state), so a captured superstep slot holds it.

An update draws, from the policy's ``action_generator`` or injected
(``learn_on_batch(samples, draws=)``): the next action's (B, act)
normals and the (n_action_sample, B, act) normals of the advantage's
samples. The twin critic is always built, and ``twin_q=False`` is
refused, as the reference refuses it. With an offline reader (``input``
a path) ``training_step`` is ``offline_training_step``; without one CRR
trains online as SAC does.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.algorithms.sac.sac import SAC, SACConfig, SACTorchPolicy
from ray_tpu_torch.data.sample_batch import SampleBatch
from ray_tpu_torch.models.distributions import SquashedGaussian
from ray_tpu_torch.offline.offline_ops import offline_training_step, setup_offline_reader
from ray_tpu_torch.policy.torch_policy import AdamState, adam_update, host_read

CRR_STATS = ("actor_loss", "critic_loss", "mean_q", "mean_advantage", "mean_weight", "total_loss")


class CRRConfig(SACConfig):
    """The reference's CRRConfig defaults."""

    def __init__(self, algo_class=None):
        super().__init__(algo_class or CRR)
        self.weight_type = "bin"  # "bin" | "exp"
        self.temperature = 1.0
        self.max_weight = 20.0
        self.n_action_sample = 4
        self.twin_q = True
        self.target_update_grad_intervals = 100
        self.num_steps_sampled_before_learning_starts = 0
        self.off_policy_estimation_methods = []

    def training(
        self,
        *,
        weight_type: Optional[str] = None,
        temperature: Optional[float] = None,
        max_weight: Optional[float] = None,
        n_action_sample: Optional[int] = None,
        target_update_grad_intervals: Optional[int] = None,
        **kwargs,
    ) -> "CRRConfig":
        super().training(**kwargs)
        for name, value in (
            ("weight_type", weight_type),
            ("temperature", temperature),
            ("max_weight", max_weight),
            ("n_action_sample", n_action_sample),
            ("target_update_grad_intervals", target_update_grad_intervals),
        ):
            if value is not None:
                setattr(self, name, value)
        return self


class CRRTorchPolicy(SACTorchPolicy):
    def __init__(self, observation_space, action_space, config: Dict, device=None):
        super().__init__(observation_space, action_space, config, device=device)
        self.actor_names = [n for n, _ in self.actor.named_parameters()]

    def _init_aux_state(self) -> Dict[str, Any]:
        aux = super()._init_aux_state()
        aux["target_actor"] = [p.detach().clone() for p in self.model.actor.parameters()]
        aux["step"] = torch.zeros((), dtype=torch.int64, device=self.device)
        return aux

    def _adam_states(self) -> List[AdamState]:
        # log_alpha is never stepped: its Adam state keeps a count of 0
        return [self.opt_states["critic"], self.opt_states["actor"]]

    def _learner_tensors(self):
        return (super()._learner_tensors() + list(self.aux_state["target_actor"])
                + [self.aux_state["step"]])

    def draw_update(self, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """One update's draws from ``action_generator``: the next action's
        (n, act) normals and the advantage samples' (n_action_sample, n,
        act) normals."""
        g, dev, act = self.action_generator, self.device, self.action_dim
        eps_t = torch.randn((n, act), generator=g, device=dev)
        adv = torch.randn((int(self.config.get("n_action_sample", 4)), n, act), generator=g,
                          device=dev)
        return eps_t, adv

    def _sac_update(self, batch: Dict[str, torch.Tensor], coeffs: Dict[str, torch.Tensor],
                    normals: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """One CRR update with no host read; ``(CRR_STATS, (6,) device
        stats)``. ``normals``: the update's draws (:meth:`draw_update`),
        else drawn."""
        cfg = self.config
        obs = batch[SampleBatch.OBS]
        next_obs = batch[SampleBatch.NEXT_OBS]
        rewards = batch[SampleBatch.REWARDS].to(torch.float32)
        not_done = 1.0 - batch[SampleBatch.TERMINATEDS].to(torch.float32)
        actions = batch[SampleBatch.ACTIONS].to(torch.float32)
        eps_t, adv_n = self.draw_update(obs.shape[0]) if normals is None else normals
        st = self.opt_states
        aux = self.aux_state

        # the critic against the targets, the next action from the target actor
        with torch.no_grad():
            next_in = torch.func.functional_call(
                self.actor, dict(zip(self.actor_names, aux["target_actor"])), (next_obs,))
            next_a, _ = SquashedGaussian(next_in, low=self.low, high=self.high).sampled_action_logp(
                None, eps_t)
            tq1, tq2 = torch.func.functional_call(
                self.critic, dict(zip(self.critic_names, aux["target_critic"])),
                (next_obs, next_a),
            )
            td_target = rewards + self.gamma ** self.n_step * not_done * torch.minimum(tq1, tq2)
        critic_p = self._group_params("critic")
        q1, q2 = self.critic(obs, actions)
        c_loss = torch.mean(torch.square(q1 - td_target)) + torch.mean(torch.square(q2 - td_target))
        c_grads = torch.autograd.grad(c_loss, critic_p)
        adam_update(critic_p, list(c_grads), st["critic"], coeffs["critic_lr"], self.adam_eps, None)

        # the advantage through the updated critic, then the weighted BC step
        with torch.no_grad():
            qa1, qa2 = self.critic(obs, actions)
            n, B, act = adv_n.shape
            samples, _ = self._dist(obs).sampled_action_logp(None, adv_n)  # (n, B, act)
            sq1, sq2 = self.critic(torch.repeat_interleave(obs, n, dim=0),
                                   samples.transpose(0, 1).reshape(B * n, act))
            v_est = torch.minimum(sq1, sq2).reshape(B, n).mean(dim=1)
            advantage = torch.minimum(qa1, qa2) - v_est
            if cfg.get("weight_type", "bin") == "exp":
                weights = torch.clamp(torch.exp(advantage / float(cfg.get("temperature", 1.0))),
                                      0.0, float(cfg.get("max_weight", 20.0)))
            else:
                weights = (advantage > 0.0).to(torch.float32)
        actor_p = self._group_params("actor")
        a_loss = -torch.mean(weights * self._dist(obs).logp(actions))
        a_grads = torch.autograd.grad(a_loss, actor_p)
        adam_update(actor_p, list(a_grads), st["actor"], coeffs["actor_lr"], self.adam_eps, None)

        with torch.no_grad():
            aux["step"].add_(1)
            sync = (aux["step"] % int(cfg.get("target_update_grad_intervals", 100))) == 0
            for targets, params in ((aux["target_actor"], actor_p),
                                    (aux["target_critic"], critic_p)):
                for t, p in zip(targets, params):
                    t.copy_(torch.where(sync, p, t))
            a_loss, c_loss = a_loss.detach(), c_loss.detach()
            stats = torch.stack([
                a_loss, c_loss, torch.mean(q1).detach(), torch.mean(advantage),
                torch.mean(weights), a_loss + c_loss,
            ])
        return CRR_STATS, stats

    def learn_on_batch(self, samples, draws=None) -> Dict[str, Any]:
        """One update on a host batch; ``draws``: :meth:`draw_update`'s
        pair, else drawn."""
        return super().learn_on_batch(samples, normals=draws)

    def get_state(self, read=None) -> Dict[str, Any]:
        read = read or host_read
        state = super().get_state(read)
        state["target_actor_weights"] = {
            n: read(t) for n, t in zip(self.actor_names, self.aux_state["target_actor"])
        }
        state["aux_step"] = read(self.aux_state["step"], scalar=True)
        return state

    @torch.no_grad()
    def set_state(self, state: Dict[str, Any]) -> None:
        super().set_state(state)
        target = state.get("target_actor_weights")
        if target is not None:
            for n, t in zip(self.actor_names, self.aux_state["target_actor"]):
                t.copy_(torch.as_tensor(np.asarray(target[n])))
        self.aux_state["step"].fill_(int(state.get("aux_step", 0)))


class CRR(SAC):
    _default_policy_class = CRRTorchPolicy

    @classmethod
    def get_default_config(cls) -> CRRConfig:
        return CRRConfig(cls)

    def __init__(self, config=None, env=None):
        cfg = config.to_dict() if hasattr(config, "to_dict") else dict(config or {})
        if cfg.get("twin_q") is False:
            raise NotImplementedError(
                "CRR always trains twin critics, as the reference's; twin_q=False is not "
                "supported"
            )
        super().__init__(config, env)
        self._reader = setup_offline_reader(self.config)

    def training_step(self) -> Dict:
        if self._reader is None:
            return super().training_step()
        return offline_training_step(self)
