"""CQL: conservative Q-learning for offline RL.

Counterpart of ``ray_tpu/algorithms/cql/cql.py``. :class:`CQLTorchPolicy`
is SAC's policy with the reference's update in its order
(:meth:`CQLTorchPolicy._sac_update`):

1. ``alpha = exp(log_alpha)``, read once;
2. the critic step on the TD target ``r + gamma * (1 - done) *
   min(target q1, q2)`` at a squashed sample of the next action (no
   entropy term, as the reference's), plus the conservative penalty of
   each Q tower: ``min_q_weight * (temperature * mean(logsumexp(cat /
   temperature)) - mean(q))``, where ``cat`` holds, per row, the Q
   values of ``num_actions`` uniform actions less the uniform log
   density, of ``num_actions`` next-state policy actions and of
   ``num_actions`` current-state policy actions, each less its
   log-probability;
3. the actor step through the updated critic: behaviour cloning
   (``mean(alpha * logp_pi - logp(data action))``) while the update
   count is below ``bc_iters``, then SAC's actor loss;
4. the alpha step and the Polyak blend of the target critic, as SAC's.

The BC switch is a device select on the update counter ``step`` (aux
state), so a captured superstep slot serves both phases. An update
draws, from the policy's ``action_generator`` or injected
(``learn_on_batch(samples, draws=)``): the next action's and the policy
action's (B, act) normals, the (B * num_actions, act) uniform actions in
the action box, and the current and next states' (num_actions, B, act)
normals. The reference's Lagrangian variant (a learned penalty weight)
is refused, as the reference refuses it. With an offline reader
(``input`` a path) ``training_step`` is ``offline_training_step``;
without one CQL trains online as SAC does.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.algorithms.sac.sac import SAC, SACConfig, SACTorchPolicy
from ray_tpu_torch.data.sample_batch import SampleBatch
from ray_tpu_torch.offline.offline_ops import offline_training_step, setup_offline_reader
from ray_tpu_torch.policy.torch_policy import adam_update, host_read

CQL_STATS = ("actor_loss", "critic_loss", "td_loss", "cql_penalty", "alpha_value", "mean_q",
             "in_bc_warmup", "total_loss")


class CQLConfig(SACConfig):
    """The reference's CQLConfig defaults."""

    def __init__(self, algo_class=None):
        super().__init__(algo_class or CQL)
        self.bc_iters = 20000
        self.temperature = 1.0
        self.num_actions = 10
        self.min_q_weight = 5.0
        self.lagrangian = False
        self.num_steps_sampled_before_learning_starts = 0
        self.off_policy_estimation_methods = []

    def training(
        self,
        *,
        bc_iters: Optional[int] = None,
        temperature: Optional[float] = None,
        num_actions: Optional[int] = None,
        min_q_weight: Optional[float] = None,
        lagrangian: Optional[bool] = None,
        **kwargs,
    ) -> "CQLConfig":
        super().training(**kwargs)
        for name, value in (
            ("bc_iters", bc_iters),
            ("temperature", temperature),
            ("num_actions", num_actions),
            ("min_q_weight", min_q_weight),
            ("lagrangian", lagrangian),
        ):
            if value is not None:
                setattr(self, name, value)
        return self


class CQLTorchPolicy(SACTorchPolicy):
    def _init_aux_state(self) -> Dict[str, Any]:
        aux = super()._init_aux_state()
        aux["step"] = torch.zeros((), dtype=torch.int64, device=self.device)
        return aux

    def _learner_tensors(self):
        return super()._learner_tensors() + [self.aux_state["step"]]

    def draw_update(self, n: int) -> Tuple[torch.Tensor, ...]:
        """One update's draws from ``action_generator``, in the update's
        order: (eps_t, eps_a, uniform actions, current normals, next
        normals)."""
        na, act = int(self.config.get("num_actions", 10)), self.action_dim
        g, dev = self.action_generator, self.device
        eps_t = torch.randn((n, act), generator=g, device=dev)
        eps_a = torch.randn((n, act), generator=g, device=dev)
        rand = torch.rand((n * na, act), generator=g, device=dev) * (self.high - self.low) + self.low
        cur = torch.randn((na, n, act), generator=g, device=dev)
        nxt = torch.randn((na, n, act), generator=g, device=dev)
        return eps_t, eps_a, rand, cur, nxt

    def _repeat_samples(self, dist, normals: torch.Tensor):
        """(B * n, act) squashed samples, row b's n samples together, and
        their (B, n) log-probabilities, from (n, B, act) normals."""
        n, B, act = normals.shape
        acts, logps = dist.sampled_action_logp(None, normals)  # (n, B, act), (n, B)
        return acts.transpose(0, 1).reshape(B * n, act), logps.transpose(0, 1)

    def _q_repeat(self, obs: torch.Tensor, actions_rep: torch.Tensor):
        """Both towers' Q of (B * n) actions against each row's obs
        repeated n times: two (B, n)."""
        B = obs.shape[0]
        n = actions_rep.shape[0] // B
        q1, q2 = self.critic(torch.repeat_interleave(obs, n, dim=0), actions_rep)
        return q1.reshape(B, n), q2.reshape(B, n)

    def _sac_update(self, batch: Dict[str, torch.Tensor], coeffs: Dict[str, torch.Tensor],
                    normals: Optional[Tuple[torch.Tensor, ...]] = None):
        """One CQL update with no host read; ``(CQL_STATS, (8,) device
        stats)``. ``normals``: the update's draws (:meth:`draw_update`),
        else drawn."""
        cfg = self.config
        temp = float(cfg.get("temperature", 1.0))
        min_q_weight = float(cfg.get("min_q_weight", 5.0))
        # the uniform proposal's log density over the action box
        random_density = -float(self.action_dim) * float(np.log(self.high - self.low))
        obs = batch[SampleBatch.OBS]
        next_obs = batch[SampleBatch.NEXT_OBS]
        rewards = batch[SampleBatch.REWARDS].to(torch.float32)
        not_done = 1.0 - batch[SampleBatch.TERMINATEDS].to(torch.float32)
        actions = batch[SampleBatch.ACTIONS].to(torch.float32)
        eps_t, eps_a, rand_actions, cur_n, next_n = (
            self.draw_update(obs.shape[0]) if normals is None else normals)
        log_alpha = self.model.log_alpha
        alpha = torch.exp(log_alpha.detach())
        st = self.opt_states
        step = self.aux_state["step"]

        with torch.no_grad():
            next_dist = self._dist(next_obs)
            next_a, _ = next_dist.sampled_action_logp(None, eps_t)
            tq1, tq2 = torch.func.functional_call(
                self.critic, dict(zip(self.critic_names, self.aux_state["target_critic"])),
                (next_obs, next_a),
            )
            td_target = rewards + self.gamma ** self.n_step * not_done * torch.minimum(tq1, tq2)
            cur_acts, cur_logp = self._repeat_samples(self._dist(obs), cur_n)
            next_acts, next_logp = self._repeat_samples(next_dist, next_n)

        # the critic: TD loss plus the conservative penalty of each tower
        critic_p = self._group_params("critic")
        q1, q2 = self.critic(obs, actions)
        td1 = torch.mean(torch.square(q1 - td_target))
        td2 = torch.mean(torch.square(q2 - td_target))
        q1_rand, q2_rand = self._q_repeat(obs, rand_actions)
        q1_cur, q2_cur = self._q_repeat(obs, cur_acts)
        q1_next, q2_next = self._q_repeat(obs, next_acts)
        penalties = []
        for q, q_rand, q_next, q_cur in ((q1, q1_rand, q1_next, q1_cur),
                                         (q2, q2_rand, q2_next, q2_cur)):
            cat = torch.cat([q_rand - random_density, q_next - next_logp, q_cur - cur_logp], dim=1)
            penalties.append(torch.logsumexp(cat / temp, dim=1).mean() * min_q_weight * temp
                             - q.mean() * min_q_weight)
        c_loss = td1 + td2 + penalties[0] + penalties[1]
        c_grads = torch.autograd.grad(c_loss, critic_p)
        adam_update(critic_p, list(c_grads), st["critic"], coeffs["critic_lr"], self.adam_eps, None)

        # the actor: behaviour cloning for bc_iters updates, then SAC's
        in_warmup = step < int(cfg.get("bc_iters", 20000))
        actor_p = self._group_params("actor")
        dist = self._dist(obs)
        a, logp = dist.sampled_action_logp(None, eps_a)
        bc_logp = dist.logp(actions)
        aq1, aq2 = self.critic(obs, a)
        sac_loss = torch.mean(alpha * logp - torch.minimum(aq1, aq2))
        bc_loss = torch.mean(alpha * logp - bc_logp)
        a_loss = torch.where(in_warmup, bc_loss, sac_loss)
        a_grads = torch.autograd.grad(a_loss, actor_p)
        adam_update(actor_p, list(a_grads), st["actor"], coeffs["actor_lr"], self.adam_eps, None)

        al_loss = -torch.mean(log_alpha * (logp.detach() + self.target_entropy))
        (al_grad,) = torch.autograd.grad(al_loss, [log_alpha])
        adam_update([log_alpha], [al_grad], st["log_alpha"], coeffs["log_alpha_lr"],
                    self.adam_eps, None)

        with torch.no_grad():
            target = self.aux_state["target_critic"]
            torch._foreach_mul_(target, 1.0 - self.tau)
            torch._foreach_add_(target, torch._foreach_mul([p.detach() for p in critic_p], self.tau))
            step.add_(1)
            a_loss, c_loss, al_loss = a_loss.detach(), c_loss.detach(), al_loss.detach()
            stats = torch.stack([
                a_loss, c_loss, (td1 + td2).detach(), (penalties[0] + penalties[1]).detach(),
                alpha, torch.mean(q1).detach(), in_warmup.to(torch.float32),
                a_loss + c_loss + al_loss,
            ])
        return CQL_STATS, stats

    def learn_on_batch(self, samples, draws=None) -> Dict[str, Any]:
        """One update on a host batch; ``draws``: :meth:`draw_update`'s
        tuple, else drawn."""
        return super().learn_on_batch(samples, normals=draws)

    def get_state(self, read=None) -> Dict[str, Any]:
        read = read or host_read
        state = super().get_state(read)
        state["aux_step"] = read(self.aux_state["step"], scalar=True)
        return state

    @torch.no_grad()
    def set_state(self, state: Dict[str, Any]) -> None:
        super().set_state(state)
        self.aux_state["step"].fill_(int(state.get("aux_step", 0)))


class CQL(SAC):
    _default_policy_class = CQLTorchPolicy

    @classmethod
    def get_default_config(cls) -> CQLConfig:
        return CQLConfig(cls)

    def __init__(self, config=None, env=None):
        cfg = config.to_dict() if hasattr(config, "to_dict") else dict(config or {})
        if cfg.get("lagrangian"):
            raise NotImplementedError(
                "Lagrangian CQL (a learned penalty weight) is not implemented, as in the "
                "reference; use the fixed min_q_weight penalty"
            )
        super().__init__(config, env)
        self._reader = setup_offline_reader(self.config)

    def training_step(self) -> Dict:
        if self._reader is None:
            return super().training_step()
        return offline_training_step(self)
