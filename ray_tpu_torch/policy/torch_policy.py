"""TorchPolicy: the policy of the port, on one CUDA device (or the CPU).

Counterpart of ``ray_tpu/policy/jax_policy.py``'s ``JaxPolicy``: model
and optimizer construction, the act path (``_action_step_body``,
``compute_actions``, ``value_batch``), the frame-pool format (a stacked
batch pooled on the host, a fragment compressed for shipping, the stacks
rebuilt on the device by the row-gather kernel), the
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
(b1=0.9, b2=0.999), then ``params += -lr * u``. ``grad_gnorm`` is taken
on the last minibatch only; in the stats reduction it is summed and
every other entry averaged. Nothing in an update reads the host: ``lr``
and the loss coefficients are device scalars written once per learn
call (:meth:`TorchPolicy._load_coeffs`), and Adam's bias corrections
come from a device table indexed by a device step counter
(:class:`AdamState`).

:meth:`TorchPolicy.learn_superstep` and
:meth:`TorchPolicy.learn_rollout_superstep` run K updates (or K
rollout + update slots) in one host call through
``sharding/superstep.SuperstepRunner``: one CUDA graph replayed K times
on the card, the same body run K times on the CPU.

Recurrent models (``use_lstm``, ``use_attention``) act one step at a
time with their state (``compute_actions``' ``state_batches``), and
learn on fixed (B, T) unrolls of T = ``max_seq_len`` rows: the train
tree gets a ``resets`` column where the trajectory is discontinuous
(:meth:`TorchPolicy._batch_to_train_tree`), :meth:`TorchPolicy.prepare_batch`
tiles or trims the batch to whole unrolls and keeps one stored state an
unroll (``__chunk__state_in_k``, for a model that trains from stored
states), and the nest shuffles whole unrolls: a recurrent policy's
permutations are over unrolls (``batch_size // T`` of them), each
expanded to its T rows.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.data.sample_batch import SampleBatch
from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.models.catalog import ModelCatalog
from ray_tpu_torch.ops.framestack import (
    FRAME_IDX,
    FRAMES,
    build_stacks,
    compress_fragment_obs,
    compress_replay_obs,
    decompose_segmented_obs,
)
from ray_tpu_torch.policy.policy import Policy, ViewRequirement
from ray_tpu_torch.sharding.superstep import SuperstepRunner, batch_finite
from ray_tpu_torch.telemetry import device as device_ledger
from ray_tpu_torch.telemetry import metrics as telemetry_metrics
from ray_tpu_torch.util import tracing
from ray_tpu_torch.utils.metrics import timer_histogram
from ray_tpu_torch.utils.exploration import exploration_from_config
from ray_tpu_torch.utils.schedules import make_schedule

# columns with one row per T-row unroll (the stored chunk-start states)
CHUNK = "__chunk__"
RESETS = "resets"


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, np.dtype(np_dtype))).dtype


def host_read(t: torch.Tensor, scalar: bool = False):
    """A device tensor of a policy's state as its host value: a numpy
    copy, or (``scalar``) a Python int. The default reader of
    ``get_state`` and ``get_weights``."""
    return int(t) if scalar else t.detach().cpu().numpy()


class AdamState:
    """optax ``scale_by_adam`` moments and step count, per parameter.

    ``count`` is the host's count of applied steps. The bias corrections
    of the next steps sit on the device in ``table`` (row 0: ``1 -
    b1**c``, row 1: ``1 - b2**c``, computed on the host in numpy float32
    as optax computes ``decay**count``), and ``step`` (a device int64)
    indexes it, advancing by one per step, so a CUDA graph of many steps
    reads a new correction on each. :meth:`load_corrections` fills the
    table before a learn call or a superstep."""

    b1 = 0.9
    b2 = 0.999
    # steps the table holds before it must grow (a grown table is a new
    # tensor, which invalidates the graphs that read the old one)
    TABLE_STEPS = 1024

    def __init__(self, params: List[torch.Tensor]):
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        device = params[0].device if params else torch.device("cpu")
        self.table = torch.ones((2, self.TABLE_STEPS), dtype=torch.float32, device=device)
        self.step = torch.zeros(1, dtype=torch.int64, device=device)

    def load_corrections(self, n: int) -> bool:
        """The corrections of steps ``count + 1 .. count + n`` into the
        table, and ``step`` to 0. True when the table had to grow."""
        grew = n > self.table.shape[1]
        if grew:
            self.table = torch.ones((2, n), dtype=torch.float32, device=self.table.device)
        one = np.float32(1.0)
        host = np.empty((2, n), np.float32)
        for i in range(n):
            c = np.float32(self.count + 1 + i)
            host[0, i] = one - np.float32(self.b1) ** c
            host[1, i] = one - np.float32(self.b2) ** c
        self.table[:, :n].copy_(torch.from_numpy(host))
        self.step.zero_()
        return grew

    def corrections(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """This step's (bc1, bc2) as 0-d device tensors; advances ``step``."""
        bc = self.table.index_select(1, self.step)
        self.step.add_(1)
        return bc[0, 0], bc[1, 0]


class DeferredStats:
    """A learn call's reduced stats on their way to the host. On CUDA a
    copy into pinned host memory is queued behind the nest with an
    event after it, so :meth:`result` waits for that learn call only,
    not for later work queued on the same stream; on the CPU the stats
    are there already."""

    def __init__(self, names: Tuple[str, ...], reduced: torch.Tensor, lr: float):
        self.names = names
        self.lr = lr
        self._event = None
        if reduced.is_cuda:
            self._host = torch.empty(reduced.shape, dtype=reduced.dtype, pin_memory=True)
            self._host.copy_(reduced, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = reduced

    def result(self) -> Dict[str, float]:
        """The stats as floats (the synchronous learn's dict), with the
        learn call's ``cur_lr``."""
        if self._event is not None:
            self._event.synchronize()
        device_ledger.drain_point()
        out = dict(zip(self.names, self._host.tolist()))
        out["cur_lr"] = self.lr
        return out


def _state_columns(batch: Dict[str, torch.Tensor], prefix: str) -> List[torch.Tensor]:
    """``batch[prefix + "0"], batch[prefix + "1"], ...`` while present."""
    out = []
    while f"{prefix}{len(out)}" in batch:
        out.append(batch[f"{prefix}{len(out)}"])
    return out


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


@torch.no_grad()
def adam_update(
    params: List[torch.Tensor],
    grads: List[torch.Tensor],
    state: AdamState,
    lr: torch.Tensor,
    eps: float,
    grad_clip: Optional[float],
) -> None:
    """One step of [clip_by_global_norm] → scale_by_adam(eps) → -lr·u,
    in place, in optax's operation order. ``lr`` is a 0-d device
    tensor and the corrections come from ``state``'s device table, so
    the step makes no host read (``state.count`` is the caller's)."""
    if grad_clip:
        g_norm = global_norm(grads)
        keep = g_norm < grad_clip
        grads = [torch.where(keep, g, (g / g_norm) * grad_clip) for g in grads]
    b1, b2 = state.b1, state.b2
    bc1, bc2 = state.corrections()
    torch._foreach_mul_(state.mu, b1)
    torch._foreach_add_(state.mu, torch._foreach_mul(grads, 1 - b1))
    sq = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(sq, 1 - b2)
    torch._foreach_mul_(state.nu, b2)
    torch._foreach_add_(state.nu, sq)
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
    # Top-level parameter names (before the first ".") that acting
    # needs: ``get_inference_weights`` ships only these to sampling-only
    # workers (the reference's ``inference_weight_keys``); None: all.
    inference_weight_keys: Optional[Tuple[str, ...]] = None

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
        # the learn path's unroll length (the reference's max_seq_len):
        # flat train rows are chopped into fixed (B, T) unrolls
        self._unroll_T = (
            int(self.model_config.get("max_seq_len", 20)) if self.model.is_recurrent else 1
        )
        # non-gradient state the loss reads (DQN's target network)
        self.aux_state: Dict[str, Any] = self._init_aux_state()

        self.grad_clip = config.get("grad_clip")
        self.adam_eps = float(config.get("adam_epsilon", 1e-8))
        self._init_optimizer()

        # device scalars of coeff_values, the nest's stat masks and the
        # superstep runners (one captured graph each on CUDA)
        self._coeff_tensors: Dict[str, torch.Tensor] = {}
        self._gnorm_masks: Dict[Tuple[str, ...], torch.Tensor] = {}
        self._superstep_runners: Dict[Tuple, SuperstepRunner] = {}

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
        self.last_learn_timers: Dict[str, float] = {}
        # one card holds the whole tree: global = per-shard
        nbytes = sum(p.nbytes for p in self.params)
        telemetry_metrics.set_params_bytes(type(self).__name__, nbytes, nbytes)

        self.exploration = exploration_from_config(
            config, action_space, self.model_config,
            default=self.default_exploration,
        )
        self.coeff_values.update(self.exploration.init_coeffs())

        # the shifted columns the sampler collects for this policy
        mc = self.model_config
        if mc.get("lstm_use_prev_action") or mc.get("use_prev_action"):
            self.view_requirements[SampleBatch.PREV_ACTIONS] = ViewRequirement(
                data_col=SampleBatch.ACTIONS, shift=-1, space=action_space
            )
        if mc.get("lstm_use_prev_reward") or mc.get("use_prev_reward"):
            self.view_requirements[SampleBatch.PREV_REWARDS] = ViewRequirement(
                data_col=SampleBatch.REWARDS, shift=-1
            )

    # -- subclass hooks --------------------------------------------------

    def _make_model(self, observation_space, action_space, num_outputs, generator):
        """The policy's model on the CPU, initialised from ``generator``."""
        return ModelCatalog.get_model(
            observation_space, action_space, num_outputs, self.model_config,
            generator=generator,
        )

    def _init_coeffs(self) -> None:
        """Subclasses add extra coefficients to self.coeff_values."""

    def _init_optimizer(self) -> None:
        """One Adam state over every parameter (SAC keeps three)."""
        self.opt_state = AdamState(self.params)

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

    def model_forward(self, obs: torch.Tensor, state=(), resets=None, prev_actions=None,
                      prev_rewards=None):
        """(dist_inputs, value, state_out): for a feed-forward model, of
        a flat (N, ...) obs batch; for a recurrent one, of (B, T, ...)
        obs from ``state``, with outputs flattened over (B·T,)."""
        if self.model.is_recurrent:
            return self.model(obs, tuple(state), resets=resets, prev_actions=prev_actions,
                              prev_rewards=prev_rewards)
        return self.model(obs)

    def functional_forward(self, params: List[torch.Tensor], obs: torch.Tensor, state=(),
                           **kwargs):
        """:meth:`model_forward` with another parameter list in the
        order of :attr:`param_names` (e.g. target-network params)."""
        args = (obs, tuple(state)) if self.model.is_recurrent else (obs,)
        return torch.func.functional_call(
            self.model, dict(zip(self.param_names, params)), args, kwargs
        )

    def get_initial_state(self) -> List[np.ndarray]:
        return [s[0].numpy() for s in self.model.initial_state(1)]

    def _act_forward(self, obs: torch.Tensor, state=None, prev_actions=None, prev_rewards=None,
                     noise=()):
        """One step's forward of a flat (N, ...) obs batch. A recurrent
        model steps once from ``state`` (its initial state when empty),
        the previous actions and rewards zero where not given, as the
        reference's act function feeds them. A forward that draws (noisy
        heads) reads ``noise`` (:meth:`_act_noise`)."""
        if noise:
            return self.model(obs, noise=noise)
        if not self.model.is_recurrent:
            return self.model_forward(obs)
        n = obs.shape[0]
        if not state:
            state = self.model.initial_state(n, obs.device)
        if getattr(self.model, "use_prev_action", False) and prev_actions is None:
            prev_actions = torch.zeros((n,) + tuple(self.action_space.shape or ()), device=obs.device)
        if getattr(self.model, "use_prev_reward", False) and prev_rewards is None:
            prev_rewards = torch.zeros((n,), device=obs.device)
        return self.model_forward(
            obs[:, None], state,
            prev_actions=None if prev_actions is None else prev_actions[:, None],
            prev_rewards=None if prev_rewards is None else prev_rewards[:, None],
        )

    def model_forward_train(self, batch: Dict[str, torch.Tensor]):
        """The learn path's forward over a flat training batch. A
        feed-forward model passes through; a recurrent one runs the N
        rows as (N / T, T) unrolls, each from the sampler's stored state
        at its first row when the model trains from stored states
        (``__chunk__state_in_k``, one row an unroll; or per-row
        ``state_in_k`` columns, sliced at each unroll's first row), else
        from zero state, with the ``resets`` column restarting the carry
        at trajectory boundaries. Outputs are flat (N,), so losses over
        flat rows work unchanged."""
        obs = batch[SampleBatch.OBS]
        if not self.model.is_recurrent:
            return self.model_forward(obs)
        T = self._unroll_T
        N = obs.shape[0]
        if N % T:
            raise ValueError(
                f"recurrent train batch of {N} rows is not a multiple of the unroll "
                f"length max_seq_len={T}"
            )
        B = N // T
        resets = batch.get(RESETS)
        pa = batch.get(SampleBatch.PREV_ACTIONS) if getattr(
            self.model, "use_prev_action", False) else None
        pr = batch.get(SampleBatch.PREV_REWARDS) if getattr(
            self.model, "use_prev_reward", False) else None
        stored = self.model.supports_stored_train_state
        if stored and f"{CHUNK}state_in_0" in batch:
            state0 = _state_columns(batch, f"{CHUNK}state_in_")
        elif stored and "state_in_0" in batch:
            state0 = [s.reshape((B, T) + tuple(s.shape[1:]))[:, 0]
                      for s in _state_columns(batch, "state_in_")]
        else:
            state0 = self.model.initial_state(B, obs.device)
        return self.model_forward(
            obs.reshape((B, T) + tuple(obs.shape[1:])), state0,
            resets=None if resets is None else resets.reshape(B, T),
            prev_actions=None if pa is None else pa.reshape((B, T) + tuple(pa.shape[1:])),
            prev_rewards=None if pr is None else pr.reshape(B, T),
        )

    def _action_step_body(
        self,
        obs: torch.Tensor,
        generator: Optional[torch.Generator],
        explore: bool = True,
        actions: Optional[torch.Tensor] = None,
        coeffs: Optional[Dict] = None,
        draws: Tuple = (),
        state=None,
        prev_actions: Optional[torch.Tensor] = None,
        prev_rewards: Optional[torch.Tensor] = None,
    ):
        """Model forward, distribution, sampling and extra fetches for
        one step: ``(actions, state_out, extra)``. Shared by
        :meth:`compute_actions`, the device rollout lane and the serving
        plane. Given ``actions`` (injected draws), only their
        log-probabilities are computed; given ``draws``
        (:meth:`action_draws`, taken ahead), the sample reads them
        instead of ``generator``. ``coeffs``: the exploration's
        coefficients (default :attr:`coeff_values`; a graphed slot
        passes the device scalars). A recurrent model steps from
        ``state`` (:meth:`_act_forward`). A model whose forward draws
        (noisy heads) takes its draws first (:meth:`_act_noise`)."""
        noise, draws = self._act_noise(generator, explore, draws)
        dist_inputs, value, state_out = self._act_forward(obs, state, prev_actions, prev_rewards,
                                                          noise)
        dist = self.dist_class(dist_inputs)
        if actions is None:
            actions, logp, _ = self.exploration.sample_fn(
                dist, generator, explore,
                self.coeff_values if coeffs is None else coeffs, (), draws,
            )
        else:
            logp = dist.logp(actions)
        extra = {
            SampleBatch.ACTION_DIST_INPUTS: dist_inputs,
            SampleBatch.ACTION_LOGP: logp,
        }
        extra.update(self.extra_action_out(dist_inputs, value, dist))
        return actions, state_out, extra

    @property
    def supports_batched_serve(self) -> bool:
        """Whether concurrent single-observation requests may coalesce
        into the serving plane's batched programs
        (``serve/policy_server.py``): a feed-forward model and stateless
        exploration, as the reference's
        ``JaxPolicy.supports_batched_serve`` (the port has no
        model-sharded policies)."""
        return not self.model.is_recurrent and self.exploration.initial_state(1) == ()

    @torch.no_grad()
    def act_dist_signature(self) -> Tuple[type, Tuple[int, ...], torch.dtype]:
        """(distribution class, one row's distribution-input shape,
        dtype) of the act path, from one forward of a zero observation
        (no draw)."""
        space = self.observation_space
        obs = torch.zeros((1,) + tuple(space.shape), dtype=_torch_dtype(space.dtype),
                          device=self.device)
        dist_inputs = self._act_forward(obs)[0]
        return self.dist_class, tuple(dist_inputs.shape[1:]), dist_inputs.dtype

    def action_draws(self, generator: Optional[torch.Generator], explore: bool) -> Tuple:
        """The random tensors one observation's :meth:`compute_actions`
        draws from ``generator``, taken now, in its order (each with a
        leading dim of 1); ``_action_step_body(..., draws=)`` uses
        them."""
        sig = self.__dict__.get("_act_sig")
        if sig is None:
            sig = self._act_sig = self.act_dist_signature()
        dist_class, shape, dtype = sig
        noise, _ = self._act_noise(generator, explore)
        return noise + self.exploration.draws(
            dist_class, (1,) + shape, dtype, self.device, generator, explore)

    def _act_noise(self, generator: Optional[torch.Generator], explore: bool,
                   draws: Optional[Tuple] = None) -> Tuple[Tuple, Optional[Tuple]]:
        """``(noise, draws)`` of one act step: the draws its forward takes
        before the exploration's (a noisy head's weight noise; none by
        default), from the front of ``draws`` when they were taken ahead,
        else from ``generator``; and the rest of ``draws``."""
        return (), draws

    @torch.no_grad()
    def compute_actions(self, obs_batch, state_batches=None, prev_action_batch=None,
                        prev_reward_batch=None, explore: bool = True, **kwargs):
        """Actions for a batch of observations. A recurrent model steps
        once from ``state_batches`` (its initial state when None), and
        reads ``prev_action_batch`` / ``prev_reward_batch`` when built
        to (zeros where not given); ``state_out`` is the state after the
        step. No model reads other views (``kwargs``), as no model of
        the reference does."""
        self.exploration.update_coeffs(self.coeff_values, self.global_timestep)
        obs = torch.as_tensor(np.asarray(obs_batch), device=self.device)
        recurrent = {}
        if self.model.is_recurrent:
            recurrent["state"] = self._device_state(state_batches)
            if prev_action_batch is not None:
                recurrent["prev_actions"] = torch.as_tensor(
                    np.asarray(prev_action_batch), device=self.device)
            if prev_reward_batch is not None:
                recurrent["prev_rewards"] = torch.as_tensor(
                    np.asarray(prev_reward_batch, np.float32), device=self.device)
        label = f"act[{type(self).__name__}:{obs.shape[0]}]"
        with device_ledger.eager_program(label, self.device, (obs,)):
            actions, state_out, extra = self._action_step_body(
                obs, self.action_generator, explore, **recurrent
            )
        out = (
            actions.cpu().numpy(),
            [s.cpu().numpy() for s in state_out],
            {k: v.cpu().numpy() for k, v in extra.items()},
        )
        device_ledger.drain_point()
        return out

    def _device_state(self, state_batches) -> List[torch.Tensor]:
        return [torch.as_tensor(np.asarray(s), device=self.device) for s in state_batches or ()]

    @torch.no_grad()
    def value_batch(self, obs_batch, state_batches=None) -> np.ndarray:
        """Bootstrap values for GAE; a recurrent model steps once from
        ``state_batches``."""
        obs = torch.as_tensor(np.asarray(obs_batch), device=self.device)
        return self._act_forward(obs, self._device_state(state_batches))[1].cpu().numpy()

    @torch.no_grad()
    def compute_log_likelihoods(self, actions, obs_batch, state_batches=None) -> np.ndarray:
        """The log-probabilities of ``actions`` under the current policy
        at ``obs_batch`` (the IS/WIS estimators' target policy)."""
        obs = torch.as_tensor(np.asarray(obs_batch), device=self.device)
        dist_inputs = self._act_forward(obs, self._device_state(state_batches))[0]
        acts = torch.as_tensor(np.asarray(actions), device=self.device)
        return self.dist_class(dist_inputs).logp(acts).cpu().numpy()

    # -- learning --------------------------------------------------------

    def _update_scheduled_coeffs(self) -> None:
        t = self.global_timestep
        self.coeff_values["lr"] = float(self._lr_schedule(t))
        self.coeff_values["entropy_coeff"] = float(self._entropy_schedule(t))

    def _train_columns(self, samples, keep_state_in: bool = False) -> Dict[str, np.ndarray]:
        """Training columns as a flat dict of host arrays (the
        ``state_in_k`` columns only with ``keep_state_in``)."""
        drop = {SampleBatch.INFOS, SampleBatch.SEQ_LENS}
        if not self._ship_next_obs:
            drop.add(SampleBatch.NEXT_OBS)
        skip = ("state_out_",) if keep_state_in else ("state_in_", "state_out_")
        return {
            k: np.asarray(v)
            for k, v in samples.items()
            if k not in drop
            and not k.startswith(skip)
            and isinstance(v, np.ndarray)
            and v.dtype != object
        }

    def _batch_to_train_tree(self, samples) -> Dict[str, np.ndarray]:
        """:meth:`_train_columns`; a stacked pixel OBS column whose rows
        slide becomes a frame pool (:meth:`_maybe_dedup_framestack`).

        A recurrent model gets the per-row ``resets`` column its unroll
        forward reads: 1 wherever the trajectory is discontinuous (an
        EPS_ID change, or a step counter T that does not count on, as at
        a fragment boundary between env slots). Row 0 is always a reset,
        except for a model that trains from the sampler's stored states
        (the LSTM), whose ``state_in_k`` columns the tree keeps: there
        row 0 is a reset only where its episode starts (T == 0). Other
        models' states never ship (a GTrXL memory is 12.8 KB a row at
        the catalog's defaults)."""
        stored = self.model.is_recurrent and self.model.supports_stored_train_state
        tree = self._maybe_dedup_framestack(self._train_columns(samples, keep_state_in=stored))
        if self.model.is_recurrent and RESETS not in tree:
            n = len(next(iter(tree.values())))
            resets = np.zeros(n, np.float32)
            eps = tree.get(SampleBatch.EPS_ID)
            tcol = tree.get(SampleBatch.T)
            if not stored or tcol is None or tcol[0] == 0:
                resets[0] = 1.0
            if eps is not None:
                resets[1:] = np.maximum(resets[1:], (eps[1:] != eps[:-1]).astype(np.float32))
            if tcol is not None:
                resets[1:] = np.maximum(resets[1:], (tcol[1:] != tcol[:-1] + 1).astype(np.float32))
            tree[RESETS] = resets
        return tree

    def replay_columns(self, samples) -> Dict[str, np.ndarray]:
        """The host column tree a replay buffer stores for this policy
        (the reference's ``JaxPolicy.replay_columns``): the learn call's
        columns without the frame-pool format, since randomly sampled
        rows are not sliding windows."""
        return self._train_columns(samples)

    # -- the frame-pool format on the host ---------------------------------

    def _pixel_obs(self, obs) -> bool:
        """A stacked (N, H, W, k) pixel column of a feed-forward model."""
        return (
            isinstance(obs, np.ndarray)
            and obs.ndim == 4
            and 2 <= obs.shape[-1] <= 8
            and not self.model.is_recurrent
        )

    def _maybe_dedup_framestack(self, tree: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """A stacked (N, H, W, k) OBS column as the frame pool + index
        columns, when its rows really are sliding windows (about k times
        fewer obs bytes to the device). Segment boundaries (fragment
        starts, episode resets) come from the batch's UNROLL_ID, EPS_ID,
        AGENT_INDEX and T columns; the decomposition checks every slide
        and keeps the stacks when one fails. Config keys as in the
        reference: ``dedup_framestack`` (default on) and
        ``dedup_framestack_min_bytes`` (1 MiB)."""
        obs = tree.get(SampleBatch.OBS)
        if (
            not self._pixel_obs(obs)
            or not self.config.get("dedup_framestack", True)
            or obs.nbytes < self.config.get("dedup_framestack_min_bytes", 1 << 20)
        ):
            return tree
        n = obs.shape[0]
        seg = np.zeros(n, bool)
        seg[0] = True
        for col in (SampleBatch.UNROLL_ID, SampleBatch.EPS_ID, SampleBatch.AGENT_INDEX):
            v = tree.get(col)
            if v is not None and len(v) == n:
                seg[1:] |= v[1:] != v[:-1]
        tcol = tree.get(SampleBatch.T)
        if tcol is not None and len(tcol) == n:
            seg[1:] |= tcol[1:] != tcol[:-1] + 1
        out = decompose_segmented_obs(obs, seg)
        if out is None:
            return tree
        tree = dict(tree)
        del tree[SampleBatch.OBS]
        tree[FRAMES], tree[FRAME_IDX] = out
        return tree

    def compress_for_shipping(self, batch: SampleBatch) -> SampleBatch:
        """On the worker, after postprocessing, before a fragment ships:
        stacked pixel observations become the frame pool + index columns
        (``compress_fragment_obs``), about 2k single frames' bytes per
        step less through pickle, the object plane, the main process's concat
        and the copy to the card. On-policy losses (no NEXT_OBS) and the
        fixed unrolls of the IMPALA family (``_fixed_unrolls``: the loss
        reads only the bootstrap stack, which is the stack at
        ``idx[-1] + 1``) train from the pool; a loss that reads NEXT_OBS
        pools both columns (:meth:`_compress_replay_shipping`).
        ``compress_obs_shipping: False`` or an ``output`` writer keeps
        the stacks."""
        if not self.config.get("compress_obs_shipping", True) or self.config.get("output"):
            return batch
        if self._ship_next_obs and not self.config.get("_fixed_unrolls"):
            return self._compress_replay_shipping(batch)
        return self._compress_with(batch, compress_fragment_obs)

    def _compress_replay_shipping(self, batch: SampleBatch) -> SampleBatch:
        """The replay family's compression: OBS and NEXT_OBS pool
        together, each episode's terminal stack as a pseudo-row, so
        ``materialize_fragment`` rebuilds both columns byte for byte
        (``compress_replay_obs``)."""
        return self._compress_with(batch, compress_replay_obs)

    def _compress_with(self, batch: SampleBatch, compress) -> SampleBatch:
        obs = batch.get(SampleBatch.OBS)
        if not self._pixel_obs(obs) or SampleBatch.NEXT_OBS not in batch:
            return batch
        dones = np.asarray(batch[SampleBatch.TERMINATEDS], bool) | np.asarray(
            batch.get(SampleBatch.TRUNCATEDS, np.zeros(batch.count, bool)), bool
        )
        dec = compress(obs, np.asarray(batch[SampleBatch.NEXT_OBS]), dones)
        if dec is None:
            return batch
        cols = {k: v for k, v in batch.items() if k not in (SampleBatch.OBS, SampleBatch.NEXT_OBS)}
        cols[FRAMES], cols[FRAME_IDX] = dec
        return SampleBatch(cols)

    def prepare_batch(self, samples) -> Tuple[Dict[str, np.ndarray], int]:
        """Host tree for the learn call and its row count (the frame
        pool of a deduplicated batch is not a row column). A recurrent
        policy's rows become whole unrolls: a batch shorter than one is
        tiled up to T rows, with a reset at each wrap (the carry at the
        end of one copy must not leak into the next; a stored state
        covers an unroll's first row only), and a longer one is trimmed
        to a multiple of T. Stored states then ship one an unroll, the
        state of each unroll's first row (``__chunk__state_in_k``)."""
        batch = self._batch_to_train_tree(samples)
        frames = batch.pop(FRAMES, None)
        bsize = len(next(iter(batch.values())))
        T = self._unroll_T
        if bsize < T:
            reps, orig = -(-T // bsize), bsize
            batch = {k: np.tile(v, (reps,) + (1,) * (v.ndim - 1))[:T] for k, v in batch.items()}
            if RESETS in batch:
                resets = batch[RESETS].copy()
                resets[orig::orig] = 1.0
                batch[RESETS] = resets
            bsize = T
        elif bsize % T:
            bsize = (bsize // T) * T
            batch = {k: v[:bsize] for k, v in batch.items()}
        if T > 1:
            k = 0
            while f"state_in_{k}" in batch:
                batch[f"{CHUNK}state_in_{k}"] = batch.pop(f"state_in_{k}")[::T]
                k += 1
        if frames is not None:
            batch[FRAMES] = frames
        return batch, bsize

    def _perm_width(self, batch_size: int) -> int:
        """What a permutation permutes: rows, or a recurrent policy's
        unrolls."""
        return batch_size // self._unroll_T

    def _host_permutations(self, batch_size: int) -> torch.Tensor:
        """(num_sgd_iter, batch_size) per-epoch row permutations from the
        policy's host generator, on the host; a recurrent policy's are
        (num_sgd_iter, batch_size // T) permutations of its unrolls."""
        return torch.stack([
            torch.randperm(self._perm_width(batch_size), generator=self.perm_generator)
            for _ in range(self.num_sgd_iter)
        ])

    def draw_permutations(self, batch_size: int) -> torch.Tensor:
        """:meth:`_host_permutations` on the device."""
        return self._host_permutations(batch_size).to(self.device)

    def _nest_shape(self, batch_size: int) -> Tuple[int, int]:
        """(minibatch rows, minibatches per epoch) of the nest. A
        recurrent policy's minibatch is whole unrolls, ``max(T, (mb //
        T) * T)`` rows."""
        mb = min(batch_size, max(1, self.minibatch_size))
        T = self._unroll_T
        if T > 1:
            if batch_size % T:
                raise ValueError(
                    f"batch {batch_size} not a multiple of max_seq_len={T}"
                )
            mb = max(T, (mb // T) * T)
        return mb, max(1, batch_size // mb)

    def _steps_per_update(self, batch_size: int) -> int:
        """Optimizer steps of one learn call: epochs x minibatches."""
        return self.num_sgd_iter * self._nest_shape(batch_size)[1]

    def _load_coeffs(self) -> Dict[str, torch.Tensor]:
        """``coeff_values`` written into 0-d float32 device tensors, which
        the nest, the loss and a graphed slot read (a graph would freeze
        a host float). Read once per learn call or superstep, as the
        reference's ``_learn_coeffs()``. The dict and its tensors are
        the same objects on every call."""
        for name, value in self.coeff_values.items():
            t = self._coeff_tensors.get(name)
            if t is None:
                t = self._coeff_tensors[name] = torch.zeros(
                    (), dtype=torch.float32, device=self.device
                )
            t.fill_(float(value))
        return self._coeff_tensors

    def _adam_states(self) -> List[AdamState]:
        """Every Adam state an update advances (SAC has three)."""
        return [self.opt_state]

    def _load_corrections(self, steps: int) -> None:
        """Adam's corrections for the next ``steps`` steps of every
        state; a grown table drops the captured graphs, which read the
        old one (each runner captures again at its next call)."""
        grew = [st.load_corrections(steps) for st in self._adam_states()]
        if any(grew):
            for runner in self._superstep_runners.values():
                runner.graph = None

    def learn_on_batch(self, samples, perms: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """One full multi-epoch SGD update on a host batch. The copy to
        the device is timed to its end (``last_learn_timers``:
        ``learn_transfer_s`` and ``learn_transfer_bytes``; the nest
        would wait for it anyway); ``learn_frame_pool`` is 1 for a
        frame-pool batch, whose stacks the row-gather kernel rebuilds."""
        batch, bsize = self.prepare_batch(samples)
        nbytes = sum(v.nbytes for v in batch.values())
        telemetry_metrics.add_h2d_bytes("learn", nbytes)
        t0 = time.perf_counter()
        with tracing.start_span("learn:transfer", batch_size=bsize):
            dev = {
                k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()
            }
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
        transfer_s = time.perf_counter() - t0
        self.last_learn_timers = {
            "learn_transfer_s": transfer_s,
            "learn_transfer_bytes": float(nbytes),
            "learn_frame_pool": float(FRAMES in batch),
        }
        timer_histogram("ray_tpu_learner_transfer_seconds").observe(transfer_s)
        return self.learn_on_device_batch(dev, bsize, perms=perms)

    def _with_stacks(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Frame-pool batches (``obs_frames`` + ``obs_frame_idx``)
        rebuild their observations (:meth:`_rebuild_obs_from_frames`)."""
        if FRAMES not in batch:
            return batch
        batch = dict(batch)
        stack_k = int(self.observation_space.shape[-1])
        return self._rebuild_obs_from_frames(batch.pop(FRAMES), batch, stack_k)

    def _rebuild_obs_from_frames(
        self, frames: torch.Tensor, batch: Dict[str, torch.Tensor], stack_k: int
    ) -> Dict[str, torch.Tensor]:
        """The OBS column from the frame pool and the per-row first-frame
        indices, by the row-gather kernel (``build_stacks``). Policies
        whose rows are not flat (IMPALA's (B, T + 1) unrolls) override
        this."""
        batch[SampleBatch.OBS] = build_stacks(frames, batch.pop(FRAME_IDX), stack_k)
        return batch

    def learn_on_device_batch(
        self,
        dev_batch: Dict[str, torch.Tensor],
        batch_size: int,
        perms: Optional[torch.Tensor] = None,
        defer_stats: bool = False,
    ):
        """The SGD nest on a device-resident batch. Frame-pool batches
        (``obs_frames`` + ``obs_frame_idx``) rebuild their observations
        first with the row-gather kernel. ``perms``: (num_sgd_iter,
        batch_size) row permutations (a recurrent policy's: of its
        ``batch_size // T`` unrolls); drawn from the policy's generator
        when None.

        ``defer_stats=True`` returns the reduced stats still on the
        device, as :class:`DeferredStats`, instead of waiting for them
        (the learner thread materializes them some steps later), and
        skips :meth:`after_learn_on_batch`, whose host coefficient
        updates need host stats (the reference's rule: defer only for
        policies that do not override it)."""
        t0 = time.perf_counter()
        with tracing.start_span("learn:nest", batch_size=batch_size) as span:
            batch = self._with_stacks(dict(dev_batch))
            self._update_scheduled_coeffs()
            if perms is None:
                perms = self.draw_permutations(batch_size)
            steps = self._steps_per_update(batch_size)
            self._load_corrections(steps)
            with device_ledger.eager_program(
                f"learn[{type(self).__name__}:{batch_size}]", self.device, (batch,)
            ):
                names, reduced = self._sgd_nest_device(
                    batch, batch_size, perms.to(self.device), self._load_coeffs()
                )
            self.opt_state.count += steps
            self.num_grad_updates += steps
            span.set_attribute("deferred", bool(defer_stats))
            telemetry_metrics.counter(
                telemetry_metrics.LEARN_STEPS_TOTAL, "SGD-nest programs dispatched",
            ).inc()
            if defer_stats:
                return DeferredStats(names, reduced, self.coeff_values["lr"])
            values = reduced.tolist()
            # the stats landed: the nest has finished
            device_ledger.drain_point()
        timer_histogram("ray_tpu_learner_step_seconds").observe(time.perf_counter() - t0)
        out = dict(zip(names, values))
        out.update(self.after_learn_on_batch(out))
        out["cur_lr"] = self.coeff_values["lr"]
        return out

    def compute_gradients(self, samples) -> Tuple[Dict[str, np.ndarray], Dict[str, float]]:
        """The loss's gradients on one host batch, without an update
        (the reference's A3C-style API): ``({param name: gradient},
        stats)``. The batch skips :meth:`prepare_batch`, so a recurrent
        policy trims it to whole unrolls here, and its unrolls start from
        the per-row stored states (:meth:`model_forward_train`)."""
        batch = self._batch_to_train_tree(samples)
        T = self._unroll_T
        if T > 1:
            n = len(next(iter(batch.values())))
            trim = (n // T) * T
            if trim == 0:
                raise ValueError(
                    f"compute_gradients batch of {n} rows is shorter than one "
                    f"max_seq_len={T} unroll"
                )
            batch = {k: v[:trim] for k, v in batch.items()}
        dev = self._with_stacks({k: torch.as_tensor(v).to(self.device) for k, v in batch.items()})
        loss, stats = self.loss_with_aux(dev, self.aux_state, self._load_coeffs())
        grads = torch.autograd.grad(loss, self.params, allow_unused=True, materialize_grads=True)
        out = {k: float(v) for k, v in stats.items()}
        out["total_loss"] = float(loss.detach())
        return {n: g.cpu().numpy() for n, g in zip(self.param_names, grads)}, out

    def _gnorm_mask(self, names: Tuple[str, ...]) -> torch.Tensor:
        """(len(names),) device bool: which stats are summed (``grad_gnorm``)
        and which averaged; made once per name list, outside any graph."""
        mask = self._gnorm_masks.get(names)
        if mask is None:
            mask = self._gnorm_masks[names] = torch.tensor(
                [n == "grad_gnorm" for n in names], device=self.device
            )
        return mask

    def _sgd_nest_device(
        self,
        batch: Dict[str, torch.Tensor],
        batch_size: int,
        perms: torch.Tensor,
        coeffs: Dict[str, torch.Tensor],
    ) -> Tuple[Tuple[str, ...], torch.Tensor]:
        """The epochs x minibatches nest with no host read: the stat
        names and their (len(names),) reduction on the device."""
        mb, num_mb = self._nest_shape(batch_size)
        T = self._unroll_T
        lr = coeffs["lr"]
        per_step: List[Dict[str, torch.Tensor]] = []
        for epoch in range(self.num_sgd_iter):
            perm = perms[epoch]
            if T > 1:  # whole unrolls, each expanded to its T rows
                perm = (perm[:, None] * T + torch.arange(T, device=perm.device)[None, :]).reshape(-1)
            idx = perm[: num_mb * mb].reshape(num_mb, mb)
            for j in range(num_mb):
                rows = idx[j]
                # a __chunk__ column has one row an unroll
                units = rows.reshape(-1, T)[:, 0] // T if T > 1 else rows
                minibatch = {k: v[units if k.startswith(CHUNK) else rows]
                             for k, v in batch.items()}
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
        names = tuple(per_step[0])
        # detached: deferred stats must not keep the update's autograd
        # graph (and its parameters' gradient nodes, tied to the stream
        # they were made on) alive until they are read
        table = torch.stack(
            [torch.stack([s[n].detach().float() for s in per_step]) for n in names]
        )
        return names, torch.where(self._gnorm_mask(names), table.sum(dim=1), table.mean(dim=1))

    # -- the K-update superstep ---------------------------------------------

    @property
    def supports_superstep(self) -> bool:
        """Whether K queued batches of this policy may be learned by one
        stacked :meth:`learn_superstep` (the learner thread's fusion):
        true when the subclass keeps the base learn composition (the
        nest and the slot's update), as the reference's identity check
        (``jax_policy.py:904-921``)."""
        cls = type(self)
        return (cls.learn_on_device_batch is TorchPolicy.learn_on_device_batch
                and cls._sgd_nest_device is TorchPolicy._sgd_nest_device
                and cls._slot_update is TorchPolicy._slot_update)

    def _learner_tensors(self) -> List[torch.Tensor]:
        """What an update writes: params, Adam moments and step indices."""
        out = list(self.params)
        for st in self._adam_states():
            out += [*st.mu, *st.nu, st.step]
        return out

    def _slot_update(self, runner, batch: Dict[str, torch.Tensor], batch_size: int):
        """A slot's update: the nest with the slot's permutations;
        ``(stat names, (len(names),) device stats)``."""
        perms = runner.perms.index_select(0, runner.slot)[0]
        return self._sgd_nest_device(batch, batch_size, perms, self._coeff_tensors)

    def _slot_priorities(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """A slot's post-update per-row |TD| errors."""
        with torch.no_grad():
            return torch.abs(self._td_error(batch, self.aux_state)[0])

    def _update_slot(self, runner, batch: Dict[str, torch.Tensor], batch_size: int,
                     priorities: bool = False) -> None:
        """One update of a superstep slot, with no host read: the update
        on ``batch`` (:meth:`_slot_update`), the nan guard's masked
        no-op, the stats row and (``priorities``) the post-update |TD|
        errors, into the runner's (K_max, ...) outputs."""
        batch = self._with_stacks(batch)
        guard = bool(self.config.get("nan_guard"))
        if guard:
            ok = batch_finite(batch)
            saved = [t.detach().clone() for t in self._learner_tensors()]
        names, reduced = self._slot_update(runner, batch, batch_size)
        if guard:
            keep = ok > 0.5
            with torch.no_grad():
                for t, old in zip(self._learner_tensors(), saved):
                    t.copy_(torch.where(keep, t, old))
            skip = 1.0 - ok
        else:
            skip = torch.zeros((), device=self.device)
        runner.stat_names = names
        runner.write("stats", torch.cat([reduced, skip.reshape(1)]))
        if priorities:
            runner.write("priorities", self._slot_priorities(batch))

    def _superstep_runner(self, key, k_max: int, batch_size: int, slot_fn, generators=(),
                          kind: str = "superstep"):
        runner = self._superstep_runners.get(key)
        if runner is None:
            runner = SuperstepRunner(
                self.device, k_max, slot_fn,
                generators=(self.action_generator, *generators),
                label=f"{kind}[{type(self).__name__}:{batch_size}x{k_max}]",
            )
            runner.sig_inputs = {
                "params": self.params,
                "adam_tables": [st.table for st in self._adam_states()],
            }
            runner.perms = torch.zeros(
                (k_max, self.num_sgd_iter, self._perm_width(batch_size)), dtype=torch.int64,
                device=self.device,
            )
            self._superstep_runners[key] = runner
        return runner

    def _run_superstep(self, runner, k: int, k_max: int, batch_size: int, overlap=None,
                       h2d_path: str = "learn"):
        """Host work of a superstep, then the k slots and the one drain:
        the scheduled and exploration coefficients read once, the k
        updates' permutations drawn in sequential order and shipped in
        one copy, Adam's corrections for k_max updates. Returns
        ``(infos, skipped, drained outputs)``."""
        if not 1 <= k <= k_max:
            raise ValueError(f"k={k} outside [1, k_max={k_max}]")
        self._update_scheduled_coeffs()
        self._load_coeffs()
        perms = torch.stack([self._host_permutations(batch_size) for _ in range(k)])
        if self.device.type == "cuda":
            # the device lane's whole H2D payload ("rollout")
            telemetry_metrics.add_h2d_bytes(h2d_path, perms.nbytes)
        runner.perms[:k].copy_(perms)
        steps = self._steps_per_update(batch_size)
        self._load_corrections(k_max * steps)
        t0 = time.perf_counter()
        with tracing.start_span("learn:superstep", k=k, batch_size=batch_size,
                                rollout=h2d_path == "rollout"):
            out = runner.run(k, overlap)
        timer_histogram("ray_tpu_learner_step_seconds").observe(time.perf_counter() - t0)
        telemetry_metrics.counter(
            telemetry_metrics.LEARN_STEPS_TOTAL, "SGD-nest programs dispatched",
        ).inc(float(k))
        telemetry_metrics.inc_superstep_updates(k)
        skipped = [bool(s > 0.5) for s in out["stats"][:, -1]]
        self._advance_adam_counts(steps * (k - sum(skipped)))
        self.num_grad_updates += k * steps
        extras = self._info_extras()
        infos = [
            {**dict(zip(runner.stat_names, map(float, row[:-1]))), **extras}
            for row in out["stats"]
        ]
        return infos, skipped, out

    def _advance_adam_counts(self, steps: int) -> None:
        """The host's count of ``steps`` applied optimizer steps, in every
        Adam state (TD3's delayed actor counts its own)."""
        for st in self._adam_states():
            st.count += steps

    def _info_extras(self) -> Dict[str, float]:
        """What a learn call's stats carry beside the update's own."""
        return {"cur_lr": self.coeff_values["lr"]}

    def learn_superstep(
        self,
        k: int,
        batch_size: int,
        *,
        stacked: Optional[Dict[str, torch.Tensor]] = None,
        rings=None,
        k_max: Optional[int] = None,
        refresh_priorities: bool = False,
        overlap: Optional[Callable[[], None]] = None,
    ):
        """``k`` updates in one host call (the reference's
        ``JaxPolicy.learn_superstep``): bitwise ``k`` sequential
        ``learn_on_device_batch`` calls on the same batches and
        permutations, with the coefficients read once and
        :meth:`after_learn_on_batch` left to the caller, applied to the
        drained stats in order. On CUDA the slot is one CUDA graph,
        captured once per (batch size, k_max, feed) and replayed.

        Feed (exactly one): ``stacked``, a (k_max, B, ...) column tree
        (device or host), copied into the slot's static buffers; or
        ``rings``, a ``SuperstepRingFeed`` of the device replay buffer
        (``buf.superstep_feed(...)``), whose slots gather their rows in
        place. ``refresh_priorities`` adds each update's post-update
        |TD| errors. ``overlap`` runs on the host after the k slots are
        launched and before their drain, so its own device work can run
        beside theirs. Returns ``(infos, priorities, skipped)``:
        per-update stat dicts, the (k, B) host |TD| matrix (or None) and
        the nan guard's per-update skip flags."""
        if (stacked is None) == (rings is None):
            raise ValueError("learn_superstep needs exactly one of stacked/rings")
        k = int(k)
        k_max = int(k_max or k)
        if refresh_priorities and not hasattr(self, "_td_error"):
            raise ValueError(
                f"{type(self).__name__} has no per-sample TD error to refresh priorities with"
            )
        if rings is not None:
            feed_key = rings.key

            def slot(runner):
                self._update_slot(runner, rings.batch(runner.slot), batch_size,
                                  refresh_priorities)
        else:
            feed_key = ("stacked",) + tuple(
                (c, tuple(v.shape[1:]), v.dtype) for c, v in sorted(stacked.items())
            )

            def slot(runner):
                batch = {c: v.index_select(0, runner.slot)[0] for c, v in runner.stacked.items()}
                self._update_slot(runner, batch, batch_size, refresh_priorities)

        key = ("replay", batch_size, k_max, feed_key, refresh_priorities)
        runner = self._superstep_runner(key, k_max, batch_size, slot)
        if stacked is not None:
            if runner.stacked is None:
                runner.stacked = {
                    c: torch.zeros((k_max,) + tuple(v.shape[1:]), dtype=v.dtype,
                                   device=self.device)
                    for c, v in stacked.items()
                }
            host = sum(v[:k].nbytes for v in stacked.values()
                       if not isinstance(v, torch.Tensor) or v.device.type == "cpu")
            if self.device.type == "cuda":
                telemetry_metrics.add_h2d_bytes("learn", host)
            for c, v in stacked.items():
                runner.stacked[c][:k].copy_(torch.as_tensor(v)[:k])
        infos, skipped, out = self._run_superstep(runner, k, k_max, batch_size, overlap)
        pri = out["priorities"] if refresh_priorities else None
        if pri is not None:
            telemetry_metrics.add_d2h_bytes("replay_priorities", pri[:k].nbytes)
        return infos, pri, skipped

    def learn_rollout_superstep(self, k: int, batch_size: int, feed, *, k_max: Optional[int] = None):
        """``k`` slots of [rollout of T steps + GAE + the SGD nest] in one
        host call (the reference's ``JaxPolicy.learn_rollout_superstep``).
        ``feed`` is ``DeviceRolloutEngine.superstep_feed()``; slot j rolls
        out with the parameters slot j - 1 left, the on-policy contract.
        On CUDA the whole slot is one CUDA graph, replayed k times; the
        policy's and the engine's generators advance on each replay, so
        the draws are the eager slots' draws. Returns ``(infos, carry,
        metrics, skipped)``: per-update stat dicts, the carry (advanced
        in place), the (k, T, 3, N) host episode metrics and the
        per-update skip flags."""
        k = int(k)
        k_max = int(k_max or k)

        def slot(runner):
            batch, met = feed.body(self._coeff_tensors)
            runner.write("metrics", met)
            self._update_slot(runner, batch, batch_size)

        key = ("rollout", batch_size, k_max, feed.key)
        runner = self._superstep_runner(key, k_max, batch_size, slot, feed.generators,
                                        kind="rollout_superstep")
        infos, skipped, out = self._run_superstep(runner, k, k_max, batch_size,
                                                  h2d_path="rollout")
        return infos, feed.carry, out["metrics"], skipped

    # -- weights and state -------------------------------------------------

    def get_weights(self, read=None) -> Dict[str, np.ndarray]:
        read = read or host_read
        return {n: read(p) for n, p in zip(self.param_names, self.params)}

    def get_inference_weights(self) -> Dict[str, np.ndarray]:
        """The weights that acting reads: those under
        :attr:`inference_weight_keys`, or all of them."""
        keys = self.inference_weight_keys
        if keys is None:
            return self.get_weights()
        return {
            n: p.detach().cpu().numpy()
            for n, p in zip(self.param_names, self.params)
            if n.split(".")[0] in keys
        }

    @torch.no_grad()
    def set_weights(self, weights: Dict[str, np.ndarray]) -> None:
        for n, p in zip(self.param_names, self.params):
            if n in weights:
                p.copy_(torch.as_tensor(np.asarray(weights[n])))

    def get_state(self, read=None) -> Dict[str, Any]:
        read = read or host_read
        st = self.opt_state
        return {
            "weights": self.get_weights(read),
            "opt_state": {
                "count": st.count,
                "mu": {n: read(m) for n, m in zip(self.param_names, st.mu)},
                "nu": {n: read(v) for n, v in zip(self.param_names, st.nu)},
            },
            "coeff_values": dict(self.coeff_values),
            "global_timestep": self.global_timestep,
            "num_grad_updates": self.num_grad_updates,
            "exploration_state": self.exploration.get_state(),
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
        self.exploration.set_state(state.get("exploration_state", {}))
