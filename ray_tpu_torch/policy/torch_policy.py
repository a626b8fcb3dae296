"""TorchPolicy: the policy of the port, on one CUDA device (or the CPU).

Counterpart of ``ray_tpu/policy/jax_policy.py``'s ``JaxPolicy``: model
and optimizer construction, the act path (``_action_step_body``,
``compute_actions``, ``value_batch``), the frame-pool rebuild, the
``num_sgd_iter`` epochs x minibatches SGD nest, ``learn_on_batch`` /
``learn_on_device_batch``, and weights and state. PyTorch runs eagerly,
so the nest is a Python loop over minibatches where the reference
compiled one program; there is one data shard and no gradient all-reduce
yet.

Randomness comes from explicit generators seeded from ``config["seed"]``:
a device generator for action sampling and a host generator for the
per-epoch minibatch permutations. Both can be injected instead
(``perms=`` of the learn calls; draws of the rollout lane), which is how
the tests hand the port the reference's draws.

The optimizer is the reference's optax chain, written out: an optional
``clip_by_global_norm(grad_clip)``, then ``scale_by_adam(eps)``
(b1=0.9, b2=0.999), then ``params += -lr * u`` with ``lr`` read on every
minibatch. ``grad_gnorm`` is taken on the last minibatch only; in the
stats reduction it is summed and every other entry averaged.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.data.sample_batch import SampleBatch
from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.models.catalog import ModelCatalog
from ray_tpu_torch.ops.framestack import FRAME_IDX, FRAMES, build_stacks
from ray_tpu_torch.policy.policy import Policy
from ray_tpu_torch.utils.exploration import exploration_from_config
from ray_tpu_torch.utils.schedules import make_schedule


class AdamState:
    """optax ``scale_by_adam`` moments and step count, per parameter."""

    b1 = 0.9
    b2 = 0.999

    def __init__(self, params: List[torch.Tensor]):
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


@torch.no_grad()
def adam_update(
    params: List[torch.Tensor],
    grads: List[torch.Tensor],
    state: AdamState,
    lr: float,
    eps: float,
    grad_clip: Optional[float],
) -> None:
    """One step of [clip_by_global_norm] → scale_by_adam(eps) → -lr·u,
    in place, in optax's operation order."""
    if grad_clip:
        g_norm = global_norm(grads)
        keep = g_norm < grad_clip
        grads = [torch.where(keep, g, (g / g_norm) * grad_clip) for g in grads]
    b1, b2 = state.b1, state.b2
    state.count += 1
    torch._foreach_mul_(state.mu, b1)
    torch._foreach_add_(state.mu, torch._foreach_mul(grads, 1 - b1))
    sq = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(sq, 1 - b2)
    torch._foreach_mul_(state.nu, b2)
    torch._foreach_add_(state.nu, sq)
    # bias corrections in float32, as optax computes decay**count
    one = np.float32(1.0)
    bc1 = float(one - np.float32(b1) ** np.float32(state.count))
    bc2 = float(one - np.float32(b2) ** np.float32(state.count))
    mu_hat = torch._foreach_div(state.mu, bc1)
    den = torch._foreach_sqrt(torch._foreach_div(state.nu, bc2))
    torch._foreach_add_(den, eps)
    u = torch._foreach_div(mu_hat, den)
    torch._foreach_mul_(u, -lr)
    torch._foreach_add_(params, u)


class TorchPolicy(Policy):
    """Base policy. Subclasses override :meth:`loss` and optionally
    :meth:`extra_action_out`, :meth:`after_learn_on_batch`."""

    default_exploration = "StochasticSampling"
    # Losses that never read NEXT_OBS set this False so the train tree
    # does not carry a second obs column to the device.
    _ship_next_obs: bool = True

    def __init__(self, observation_space, action_space, config: Dict, device=None):
        super().__init__(observation_space, action_space, config)
        self.device = resolve_device(device)
        self.model_config = dict(config.get("model") or {})
        self.dist_class, self.num_outputs = ModelCatalog.get_action_dist(
            action_space, self.model_config
        )
        seed = int(config.get("seed") or 0)
        self.model = self._make_model(
            observation_space, action_space, self.num_outputs,
            torch.Generator().manual_seed(seed),
        ).to(self.device)
        self.param_names = [n for n, _ in self.model.named_parameters()]
        self.params = [p for _, p in self.model.named_parameters()]
        # non-gradient state the loss reads (DQN's target network)
        self.aux_state: Dict[str, Any] = self._init_aux_state()

        self.grad_clip = config.get("grad_clip")
        self.adam_eps = float(config.get("adam_epsilon", 1e-8))
        self.opt_state = AdamState(self.params)

        self.action_generator = torch.Generator(device=self.device)
        self.action_generator.manual_seed(seed)
        self.perm_generator = torch.Generator().manual_seed(seed)

        self._lr_schedule = make_schedule(
            config.get("lr_schedule"), config.get("lr", 5e-5)
        )
        self._entropy_schedule = make_schedule(
            config.get("entropy_coeff_schedule"),
            config.get("entropy_coeff", 0.0),
        )
        self.coeff_values: Dict[str, float] = {
            "lr": float(self._lr_schedule(0)),
            "entropy_coeff": float(self._entropy_schedule(0)),
        }
        self._init_coeffs()

        self.train_batch_size = int(config.get("train_batch_size", 4000))
        self.minibatch_size = int(
            config.get("sgd_minibatch_size")
            or config.get("train_batch_size", 4000)
        )
        self.num_sgd_iter = int(config.get("num_sgd_iter", 1))
        self.num_grad_updates = 0

        self.exploration = exploration_from_config(
            config, action_space, self.model_config,
            default=self.default_exploration,
        )
        self.coeff_values.update(self.exploration.init_coeffs())

    # -- subclass hooks --------------------------------------------------

    def _make_model(self, observation_space, action_space, num_outputs, generator):
        """The policy's model on the CPU, initialised from ``generator``."""
        return ModelCatalog.get_model(
            observation_space, action_space, num_outputs, self.model_config,
            generator=generator,
        )

    def _init_coeffs(self) -> None:
        """Subclasses add extra coefficients to self.coeff_values."""

    def _init_aux_state(self) -> Dict[str, Any]:
        """Initial non-gradient state, e.g. target-network params."""
        return {}

    def loss(
        self, batch: Dict[str, torch.Tensor], coeffs: Dict[str, float]
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        raise NotImplementedError

    def loss_with_aux(
        self, batch: Dict[str, torch.Tensor], aux: Dict[str, Any], coeffs: Dict[str, float]
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The nest's loss entry point; ``aux`` is :attr:`aux_state`.
        Policies without aux state ignore it."""
        return self.loss(batch, coeffs)

    def extra_action_out(self, dist_inputs, value, dist) -> Dict[str, torch.Tensor]:
        return {SampleBatch.VF_PREDS: value}

    def after_learn_on_batch(self, stats: Dict[str, float]) -> Dict[str, float]:
        """Host-side coefficient updates (e.g. PPO's KL coefficient)."""
        return {}

    # -- inference -------------------------------------------------------

    def model_forward(self, obs: torch.Tensor):
        """(dist_inputs, value, state_out) for a flat (N, ...) obs batch."""
        return self.model(obs)

    def functional_forward(self, params: List[torch.Tensor], obs: torch.Tensor):
        """:meth:`model_forward` with another parameter list in the
        order of :attr:`param_names` (e.g. target-network params)."""
        return torch.func.functional_call(
            self.model, dict(zip(self.param_names, params)), (obs,)
        )

    def _action_step_body(
        self,
        obs: torch.Tensor,
        generator: Optional[torch.Generator],
        explore: bool = True,
        actions: Optional[torch.Tensor] = None,
    ):
        """Model forward, distribution, sampling and extra fetches for
        one step: ``(actions, state_out, extra)``. Shared by
        :meth:`compute_actions` and the device rollout lane. Given
        ``actions`` (injected draws), only their log-probabilities are
        computed."""
        dist_inputs, value, state_out = self.model_forward(obs)
        dist = self.dist_class(dist_inputs)
        if actions is None:
            actions, logp, _ = self.exploration.sample_fn(
                dist, generator, explore, self.coeff_values, ()
            )
        else:
            logp = dist.logp(actions)
        extra = {
            SampleBatch.ACTION_DIST_INPUTS: dist_inputs,
            SampleBatch.ACTION_LOGP: logp,
        }
        extra.update(self.extra_action_out(dist_inputs, value, dist))
        return actions, state_out, extra

    @torch.no_grad()
    def compute_actions(self, obs_batch, state_batches=None, explore: bool = True, **kwargs):
        self.exploration.update_coeffs(self.coeff_values, self.global_timestep)
        obs = torch.as_tensor(np.asarray(obs_batch), device=self.device)
        actions, state_out, extra = self._action_step_body(
            obs, self.action_generator, explore
        )
        return (
            actions.cpu().numpy(),
            [s.cpu().numpy() for s in state_out],
            {k: v.cpu().numpy() for k, v in extra.items()},
        )

    @torch.no_grad()
    def value_batch(self, obs_batch, state_batches=None) -> np.ndarray:
        """Bootstrap values for GAE."""
        obs = torch.as_tensor(np.asarray(obs_batch), device=self.device)
        return self.model_forward(obs)[1].cpu().numpy()

    # -- learning --------------------------------------------------------

    def _update_scheduled_coeffs(self) -> None:
        t = self.global_timestep
        self.coeff_values["lr"] = float(self._lr_schedule(t))
        self.coeff_values["entropy_coeff"] = float(self._entropy_schedule(t))

    def _batch_to_train_tree(self, samples) -> Dict[str, np.ndarray]:
        """Training columns as a flat dict of host arrays."""
        drop = {SampleBatch.INFOS, SampleBatch.SEQ_LENS}
        if not self._ship_next_obs:
            drop.add(SampleBatch.NEXT_OBS)
        return {
            k: np.asarray(v)
            for k, v in samples.items()
            if k not in drop
            and not k.startswith(("state_in_", "state_out_"))
            and isinstance(v, np.ndarray)
            and v.dtype != object
        }

    def prepare_batch(self, samples) -> Tuple[Dict[str, np.ndarray], int]:
        """Host tree for the learn call and its row count (the frame
        pool of a deduplicated batch is not a row column)."""
        batch = self._batch_to_train_tree(samples)
        bsize = next(len(v) for k, v in batch.items() if k != FRAMES)
        return batch, bsize

    def draw_permutations(self, batch_size: int) -> torch.Tensor:
        """(num_sgd_iter, batch_size) per-epoch row permutations from the
        policy's host generator, on the device."""
        perms = torch.stack([
            torch.randperm(batch_size, generator=self.perm_generator)
            for _ in range(self.num_sgd_iter)
        ])
        return perms.to(self.device)

    def learn_on_batch(self, samples, perms: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """One full multi-epoch SGD update on a host batch."""
        batch, bsize = self.prepare_batch(samples)
        dev = {
            k: torch.as_tensor(v).to(self.device, non_blocking=True)
            for k, v in batch.items()
        }
        return self.learn_on_device_batch(dev, bsize, perms=perms)

    def learn_on_device_batch(
        self,
        dev_batch: Dict[str, torch.Tensor],
        batch_size: int,
        perms: Optional[torch.Tensor] = None,
    ) -> Dict[str, Any]:
        """The SGD nest on a device-resident batch. Frame-pool batches
        (``obs_frames`` + ``obs_frame_idx``) rebuild their observations
        first with the row-gather kernel. ``perms``: (num_sgd_iter,
        batch_size) row permutations; drawn from the policy's generator
        when None."""
        batch = dict(dev_batch)
        if FRAMES in batch:
            stack_k = int(self.observation_space.shape[-1])
            batch[SampleBatch.OBS] = build_stacks(
                batch.pop(FRAMES), batch.pop(FRAME_IDX), stack_k
            )
        self._update_scheduled_coeffs()
        if perms is None:
            perms = self.draw_permutations(batch_size)
        stats = self._sgd_nest(batch, batch_size, perms.to(self.device))
        self.num_grad_updates += self.num_sgd_iter * max(
            1, batch_size // max(1, self.minibatch_size)
        )
        out = dict(stats)
        out.update(self.after_learn_on_batch(out))
        out["cur_lr"] = self.coeff_values["lr"]
        return out

    def _sgd_nest(
        self, batch: Dict[str, torch.Tensor], batch_size: int, perms: torch.Tensor
    ) -> Dict[str, float]:
        mb = min(batch_size, max(1, self.minibatch_size))
        num_mb = max(1, batch_size // mb)
        coeffs = dict(self.coeff_values)
        lr = coeffs["lr"]
        per_step: List[Dict[str, torch.Tensor]] = []
        for epoch in range(self.num_sgd_iter):
            idx = perms[epoch, : num_mb * mb].reshape(num_mb, mb)
            for j in range(num_mb):
                minibatch = {k: v[idx[j]] for k, v in batch.items()}
                loss, stats = self.loss_with_aux(minibatch, self.aux_state, coeffs)
                # a parameter the loss does not read (the transformer's
                # value head under DQN) gets a zero gradient, as jax.grad
                # gives it
                grads = torch.autograd.grad(
                    loss, self.params, allow_unused=True, materialize_grads=True
                )
                last = epoch == self.num_sgd_iter - 1 and j == num_mb - 1
                gnorm = global_norm(grads) if last else torch.zeros(
                    (), device=self.device
                )
                adam_update(
                    self.params, list(grads), self.opt_state, lr,
                    self.adam_eps, self.grad_clip,
                )
                per_step.append(
                    {**stats, "total_loss": loss.detach(), "grad_gnorm": gnorm}
                )
        names = list(per_step[0])
        table = torch.stack(
            [torch.stack([s[n].float() for s in per_step]) for n in names]
        )
        reduced = torch.where(
            torch.tensor([n == "grad_gnorm" for n in names], device=table.device),
            table.sum(dim=1),
            table.mean(dim=1),
        ).tolist()
        return dict(zip(names, reduced))

    # -- weights and state -------------------------------------------------

    def get_weights(self) -> Dict[str, np.ndarray]:
        return {
            n: p.detach().cpu().numpy()
            for n, p in zip(self.param_names, self.params)
        }

    @torch.no_grad()
    def set_weights(self, weights: Dict[str, np.ndarray]) -> None:
        for n, p in zip(self.param_names, self.params):
            if n in weights:
                p.copy_(torch.as_tensor(np.asarray(weights[n])))

    def get_state(self) -> Dict[str, Any]:
        st = self.opt_state
        return {
            "weights": self.get_weights(),
            "opt_state": {
                "count": st.count,
                "mu": {n: m.cpu().numpy() for n, m in zip(self.param_names, st.mu)},
                "nu": {n: v.cpu().numpy() for n, v in zip(self.param_names, st.nu)},
            },
            "coeff_values": dict(self.coeff_values),
            "global_timestep": self.global_timestep,
            "num_grad_updates": self.num_grad_updates,
        }

    @torch.no_grad()
    def set_state(self, state: Dict[str, Any]) -> None:
        self.set_weights(state["weights"])
        opt = state.get("opt_state")
        if opt is not None:
            self.opt_state.count = int(opt["count"])
            for i, n in enumerate(self.param_names):
                self.opt_state.mu[i].copy_(torch.as_tensor(opt["mu"][n]))
                self.opt_state.nu[i].copy_(torch.as_tensor(opt["nu"][n]))
        self.coeff_values.update(state.get("coeff_values", {}))
        self.global_timestep = state.get("global_timestep", 0)
        self.num_grad_updates = state.get("num_grad_updates", 0)
