"""Random Network Distillation exploration (Burda et al. 2018).

Counterpart of ``ray_tpu/utils/exploration/rnd.py``: a frozen, randomly
initialised target encoder f(s) and a trained predictor f_hat(s); the
intrinsic reward is ``intrinsic_reward_coeff * ||f_hat(s) - f(s)||^2``
divided by the running standard deviation of that error (a batched
Welford merge in float64 on the host, no mean-centering, as the
reference's). ``postprocess_trajectory`` takes one Adam step of the
predictor a fragment. The nets live on the policy's device and are
created at the first fragment, as :mod:`curiosity`'s; the predictor's
Adam state and the normaliser travel in :meth:`RND.get_state`.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ray_tpu_torch.data.sample_batch import SampleBatch
from ray_tpu_torch.utils.exploration.curiosity import _MLP, _generator, _NetsAndAdam, _obs_size
from ray_tpu_torch.utils.exploration.exploration import StochasticSampling, register_exploration


class RND(StochasticSampling):
    def __init__(self, action_space, config, model_config=None):
        super().__init__(action_space, config, model_config)
        cfg = self.config
        self.embed_dim = int(cfg.get("embed_dim", 128))
        self.eta = float(cfg.get("intrinsic_reward_coeff", 0.5))
        self.lr = float(cfg.get("lr", 1e-4))
        self.hiddens = tuple(cfg.get("hiddens", (256,)))
        self.target: Optional[nn.Module] = None
        self.predictor: Optional[_NetsAndAdam] = None
        self._pending: Optional[Dict] = None
        # Welford running stats of the prediction error
        self._count = 1e-4
        self._mean = 0.0
        self._m2 = 1.0

    def _build(self, in_size: int, device, generator: Optional[torch.Generator]) -> None:
        self.target = _MLP(in_size, self.embed_dim, self.hiddens, generator=generator).to(device)
        self.target.requires_grad_(False)
        self.predictor = _NetsAndAdam(
            _MLP(in_size, self.embed_dim, self.hiddens, generator=generator), self.lr, device)

    def _ensure(self, policy, obs: np.ndarray) -> None:
        if self.predictor is not None:
            return
        pending, self._pending = self._pending, None
        if pending is not None:
            in_size = int(np.asarray(pending["target_params"]["h_0.weight"]).shape[1])
            self._build(in_size, policy.device, None)
            self._load(pending)
        else:
            self._build(_obs_size(obs), policy.device, _generator(self.config, policy))

    @torch.no_grad()
    def _load(self, state: Dict) -> None:
        for n, p in self.target.named_parameters():
            p.copy_(torch.as_tensor(np.asarray(state["target_params"][n])))
        self.predictor.load(state["predictor_params"], state["opt_state"])
        self._count, self._mean, self._m2 = state["norm"]

    def prediction_error(self, obs: torch.Tensor) -> torch.Tensor:
        """||f_hat(s) - f(s)||^2 a row, from the current predictor."""
        t = self.target(obs).detach()
        p = self.predictor.module(obs)
        return torch.sum(torch.square(p - t), dim=-1)

    def postprocess_trajectory(self, policy, sample_batch):
        obs = np.asarray(sample_batch[SampleBatch.OBS], np.float32)
        self._ensure(policy, obs)
        with torch.enable_grad():
            err = self.prediction_error(torch.as_tensor(obs, device=self.predictor.lr.device))
            self.predictor.step(torch.mean(err))
        err = err.detach().cpu().numpy().astype(np.float64)
        # batched Welford merge
        n, mean, var = err.size, err.mean(), err.var()
        delta = mean - self._mean
        tot = self._count + n
        self._mean += delta * n / tot
        self._m2 += var * n + delta ** 2 * self._count * n / tot
        self._count = tot
        std = max(np.sqrt(self._m2 / self._count), 1e-8)
        # scaled by the running std only: mean-centering would hand
        # below-average-novelty states a negative bonus
        intrinsic = self.eta * err / std
        sample_batch[SampleBatch.REWARDS] = sample_batch[SampleBatch.REWARDS] + intrinsic.astype(
            np.float32)
        return sample_batch

    def get_state(self) -> Dict:
        if self.predictor is None:
            return dict(self._pending or {})
        return {
            "target_params": {n: p.detach().cpu().numpy().copy()
                              for n, p in self.target.named_parameters()},
            "predictor_params": self.predictor.params_state(),
            "opt_state": self.predictor.opt_state(),
            "norm": (self._count, self._mean, self._m2),
        }

    def set_state(self, state: Dict) -> None:
        if "target_params" not in state:
            return
        if self.predictor is None:
            self._pending = dict(state)
        else:
            self._load(state)


register_exploration("RND", RND)
