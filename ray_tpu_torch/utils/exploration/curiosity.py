"""Curiosity (ICM) exploration: intrinsic rewards from an Intrinsic
Curiosity Module (Pathak et al. 2017).

Counterpart of ``ray_tpu/utils/exploration/curiosity.py``. Three small
nets over flattened observations: a feature encoder phi, an inverse
model (phi(s), phi(s')) -> action logits, and a forward model (phi(s),
a) -> phi(s'). The intrinsic reward is ``eta * 0.5 * ||phi_hat(s') -
phi(s')||^2``, from the nets as they were before this fragment's update.
``postprocess_trajectory`` runs one ICM update a fragment (loss,
gradients, one Adam step in optax's order) before the policy's own
postprocessing, as the reference's does; the actor lane's sampler calls
it. The nets are ``nn.Module``s on the policy's device (a remote
rollout worker's CPU, or the card for a ``num_workers: 0`` run's local
worker), created at the first fragment (its observation shape sizes
phi) from a generator of their own seeded with the exploration
config's ``seed`` (else the policy's). Their Adam state travels in
:meth:`Curiosity.get_state`, so a checkpoint resumes them. The device
rollout lane runs no postprocessing and refuses the strategy.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.data.sample_batch import SampleBatch
from ray_tpu_torch.models.base import Dense, get_activation
from ray_tpu_torch.utils.exploration.exploration import StochasticSampling, register_exploration


class _MLP(nn.Module):
    """``hiddens`` Dense layers (``h_i``) and a linear ``out``, in
    float32 over the flattened input (the reference's ``_MLP``)."""

    def __init__(self, in_size: int, out: int, hiddens: Sequence[int] = (256,),
                 activation: str = "relu", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = get_activation(activation)
        self.num_hiddens = len(hiddens)
        sizes = [int(in_size), *[int(h) for h in hiddens]]
        for i in range(self.num_hiddens):
            setattr(self, f"h_{i}", Dense(sizes[i], sizes[i + 1], generator=generator))
        self.out = Dense(sizes[-1], int(out), generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.reshape(x.shape[0], -1).float()
        for i in range(self.num_hiddens):
            h = self.act(getattr(self, f"h_{i}")(h))
        return self.out(h)


class _NetsAndAdam:
    """A module's parameters with one optax-ordered Adam state, stepped
    once a fragment; state as host arrays keyed by parameter name."""

    def __init__(self, module: nn.Module, lr: float, device):
        from ray_tpu_torch.policy.torch_policy import AdamState

        self.module = module.to(device)
        self.names = [n for n, _ in self.module.named_parameters()]
        self.params = [p for _, p in self.module.named_parameters()]
        self.opt = AdamState(self.params)
        self.lr = torch.tensor(float(lr), dtype=torch.float32, device=device)

    def step(self, loss: torch.Tensor) -> None:
        from ray_tpu_torch.policy.torch_policy import adam_update

        grads = torch.autograd.grad(loss, self.params)
        self.opt.load_corrections(1)
        adam_update(self.params, list(grads), self.opt, self.lr, 1e-8, None)
        self.opt.count += 1

    def params_state(self) -> Dict[str, np.ndarray]:
        return {n: p.detach().cpu().numpy().copy() for n, p in zip(self.names, self.params)}

    def opt_state(self) -> Dict:
        return {
            "count": int(self.opt.count),
            "mu": {n: m.detach().cpu().numpy().copy() for n, m in zip(self.names, self.opt.mu)},
            "nu": {n: v.detach().cpu().numpy().copy() for n, v in zip(self.names, self.opt.nu)},
        }

    @torch.no_grad()
    def load(self, params: Dict, opt_state: Optional[Dict] = None) -> None:
        for n, p in zip(self.names, self.params):
            p.copy_(torch.as_tensor(np.asarray(params[n])))
        if opt_state is not None:
            self.opt.count = int(opt_state["count"])
            for i, n in enumerate(self.names):
                self.opt.mu[i].copy_(torch.as_tensor(np.asarray(opt_state["mu"][n])))
                self.opt.nu[i].copy_(torch.as_tensor(np.asarray(opt_state["nu"][n])))


def _obs_size(obs: np.ndarray) -> int:
    return int(np.prod(obs.shape[1:]))


def _generator(config: Dict, policy) -> torch.Generator:
    seed = config.get("seed")
    if seed is None:
        seed = (getattr(policy, "config", None) or {}).get("seed") or 0
    return torch.Generator().manual_seed(int(seed))


class Curiosity(StochasticSampling):
    """Stochastic sampling for actions; the module adds the intrinsic
    reward and trains the ICM."""

    def __init__(self, action_space, config, model_config=None):
        super().__init__(action_space, config, model_config)
        cfg = self.config
        self.feature_dim = int(cfg.get("feature_dim", 288))
        self.eta = float(cfg.get("eta", 1.0))
        self.beta = float(cfg.get("beta", 0.2))
        self.lr = float(cfg.get("lr", 1e-3))
        self.hiddens = tuple(cfg.get("feature_net_hiddens", (256,)))
        self.inverse_hiddens = tuple(cfg.get("inverse_net_hiddens", (256,)))
        self.forward_hiddens = tuple(cfg.get("forward_net_hiddens", (256,)))
        if getattr(action_space, "n", None) is None or tuple(action_space.shape or ()) != ():
            raise ValueError(
                "Curiosity currently supports Discrete action spaces "
                "(the reference's curiosity.py has the same restriction)"
            )
        self.num_actions = int(action_space.n)
        self.icm: Optional[_NetsAndAdam] = None
        self._pending: Optional[Dict] = None

    def _build(self, in_size: int, device, generator: Optional[torch.Generator]) -> None:
        # the reference's "forward" net is "forward_net" here (an
        # nn.Module's forward is its call)
        nets = nn.Module()
        nets.phi = _MLP(in_size, self.feature_dim, self.hiddens, generator=generator)
        nets.inverse = _MLP(2 * self.feature_dim, self.num_actions, self.inverse_hiddens,
                            generator=generator)
        nets.forward_net = _MLP(self.feature_dim + self.num_actions, self.feature_dim,
                                self.forward_hiddens, generator=generator)
        self.icm = _NetsAndAdam(nets, self.lr, device)

    def _ensure(self, policy, obs: np.ndarray) -> None:
        if self.icm is not None:
            return
        pending, self._pending = self._pending, None
        if pending is not None:
            in_size = int(np.asarray(pending["params"]["phi.h_0.weight"]).shape[1])
            self._build(in_size, policy.device, None)
            self.icm.load(pending["params"], pending["opt_state"])
        else:
            self._build(_obs_size(obs), policy.device, _generator(self.config, policy))

    def icm_loss(self, obs: torch.Tensor, next_obs: torch.Tensor, actions: torch.Tensor):
        """(loss, intrinsic reward a row) of the ICM's current nets."""
        nets = self.icm.module
        f = nets.phi(obs)
        f_next = nets.phi(next_obs)
        inv_logits = nets.inverse(torch.cat([f, f_next], dim=-1))
        onehot = F.one_hot(actions.long(), self.num_actions).float()
        inv_loss = torch.mean(-torch.sum(onehot * F.log_softmax(inv_logits, dim=-1), dim=-1))
        f_pred = nets.forward_net(torch.cat([f, onehot], dim=-1))
        fwd_err = torch.sum(torch.square(f_pred - f_next.detach()), dim=-1)
        fwd_loss = 0.5 * torch.mean(fwd_err)
        loss = (1.0 - self.beta) * inv_loss + self.beta * fwd_loss
        return loss, self.eta * 0.5 * fwd_err.detach()

    def postprocess_trajectory(self, policy, sample_batch):
        obs = np.asarray(sample_batch[SampleBatch.OBS], np.float32)
        if SampleBatch.NEXT_OBS in sample_batch:
            next_obs = np.asarray(sample_batch[SampleBatch.NEXT_OBS], np.float32)
        else:
            next_obs = np.concatenate([obs[1:], obs[-1:]], axis=0)
        self._ensure(policy, obs)
        device = self.icm.lr.device
        with torch.enable_grad():
            loss, intrinsic = self.icm_loss(
                torch.as_tensor(obs, device=device), torch.as_tensor(next_obs, device=device),
                torch.as_tensor(np.asarray(sample_batch[SampleBatch.ACTIONS]), device=device))
            self.icm.step(loss)
        sample_batch[SampleBatch.REWARDS] = sample_batch[SampleBatch.REWARDS] + (
            intrinsic.cpu().numpy().astype(np.float32))
        return sample_batch

    def get_state(self) -> Dict:
        if self.icm is None:
            return dict(self._pending or {})
        return {"params": self.icm.params_state(), "opt_state": self.icm.opt_state()}

    def set_state(self, state: Dict) -> None:
        if "params" not in state:
            return
        if self.icm is None:
            # built on the policy's device at the next fragment
            self._pending = {"params": state["params"], "opt_state": state["opt_state"]}
        else:
            self.icm.load(state["params"], state["opt_state"])


register_exploration("Curiosity", Curiosity)
