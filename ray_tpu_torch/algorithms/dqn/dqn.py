"""DQN: double/dueling DQN with (prioritized) replay on the device lane.

Counterpart of ``ray_tpu/algorithms/dqn/dqn.py``. The rollout lane
fills a device-resident replay buffer (``postprocess="none"`` rows,
inserted with the row-scatter kernel); each round then makes one
replay update: a prioritized draw on the device sum tree (the
prefix-descent kernel) and a row gather of every column (the row-gather
kernel), one learn call with the TD loss, a per-row |TD error| readback
and a priority write. The target network is the policy's aux state,
copied from the online params every ``target_network_update_freq``
trained steps.

With ``model: {"use_transformer": True}`` the policy takes the catalog's
transformer torso instead of ``DQNModel`` and reads its logits as Q
values, as the reference's fallback does.

With ``training_intensity`` a round makes several replay updates; under
the superstep (``config.superstep``: 8 per host call on CUDA) every
full window of K of them runs as one ``superstep_train_replay`` call,
one CUDA graph replayed K times, and prioritized replay joins the chain
with its priorities refreshed once per window, as in the reference.

Off the device lane (any other ``env_backend``) a round is the
reference's actor-lane ``training_step``: the workers (or the local
worker, when there are none) sample ``rollout_fragment_length x
num_envs_per_worker`` env steps, the fragment's replay columns cross to
the device rings once (``MultiAgentReplayBuffer.add``: one row-scatter
launch per column), the replay update phase runs as on the lane, and
the workers get the acting weights (``sync_weights(inference_only=
True)``). SAC inherits this round.

Rainbow's parts (``tuned_examples/dqn/cartpole-rainbow.yaml``):

- **n-step returns** on the actor lane: :func:`adjust_nstep`, the
  reference's host numpy fold, runs on each policy batch before the
  insert and adds the ``n_steps`` column, whose ``gamma ** n_steps``
  discounts the bootstrap (the device lane keeps ``n_step = 1``, as the
  reference's);
- **C51** (``num_atoms > 1``): the loss, and the "TD error" prioritized
  replay receives, is the per-row cross-entropy to the projected target
  distribution (``dqn_model.categorical_projection``), with double Q;
- **NoisyNet** (``noisy``): the act step draws its heads' noise from
  the policy's ``action_generator`` before the exploration's draws;
  the learn step draws three sets (online, target, next-action
  selection) and the priority pass one more, from the same generator,
  which a graphed replay slot registers, so a graphed update equals an
  eager one on the same generator state.

The actor lane rebuilds worker-compressed frame pools (the reference's
``compress_replay_obs`` format) into stacked OBS and NEXT_OBS before
the n-step fold (:meth:`DQN._materialize_compressed`). With
``policies`` the actor lane learns a policy map: one device ring per
policy (``MultiAgentReplayBuffer``), one replay update (or superstep)
per policy whose ring holds a batch, priorities refreshed per policy,
and every policy's target synced.

With ``sample_async`` and remote workers the actor lane's round is the
reference's one-round-stale round: it takes the fragments it asked for
in the round before, asks for the next ones at once, and only then
inserts and updates, so the workers sample while the learner learns
(their weights lag the learner by one round). ``per_worker_exploration``
gives remote worker i of n the constant epsilon ``0.4 ** (1 + 7 (i - 1)
/ (n - 1))`` (Ape-X's ladder, ``algorithms/apex_dqn/``).

The replay placement follows the reference's knobs
(``execution/replay_buffer.py``): device rings by default, host rings
with ``replay_device_resident=False`` (an update draws on the host and
uploads the drawn batch; a superstep uploads its k stacked draws once;
the device lane pulls each rollout back once to insert it), and host
trees beside device rows with ``replay_device_tree=False``.

``learn_while_rollout`` on the device lane (the reference's cadence,
``_interleave_ready``): once the lane is warm, a round's fill acts with
the weights from before this round's updates, the updates draw rows of
earlier rounds only, and the fill's rows go in after them, so the
sampled and trained counts are the serial cadence's. The reference
dispatches its fill asynchronously against immutable arrays; the
port's optimizer writes the parameters in place, so the round copies
the acting weights into a second model first, launches the replay
superstep, and runs the eager fill on that copy, on the same stream,
while the superstep's graph runs: the fill's host launches overlap the
graph (:meth:`DQN._interleaved_round`).

Fault tolerance: each replay update phase is one learn call of the
fault injector (``crash_learner``; the reference's replay round consults
none, so its DQN ignores the knob), and a restore writes the rings, the
sum tree and the target in place, under the captured slot's graph.
``nan_batch`` raises here: it poisons a host learn batch, and the replay
family learns from its rings. ``on_fleet_change`` and ``on_recovery``
drop the ``sample_async`` round's pending refs.
"""

from __future__ import annotations

import copy
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.algorithms.algorithm import (
    NUM_ENV_STEPS_SAMPLED,
    NUM_ENV_STEPS_TRAINED,
    Algorithm,
)
from ray_tpu_torch import core
from ray_tpu_torch.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.algorithms.dqn.dqn_model import DQNModel, categorical_projection
from ray_tpu_torch.data.sample_batch import (
    DEFAULT_POLICY_ID,
    MultiAgentBatch,
    SampleBatch,
    concat_samples,
)
from ray_tpu_torch.execution.rollout_ops import synchronous_parallel_sample
from ray_tpu_torch.execution.replay_buffer import (
    MultiAgentReplayBuffer,
    resolve_device_resident,
    resolve_device_tree,
)
from ray_tpu_torch.execution.train_ops import superstep_train_replay
from ray_tpu_torch.models.catalog import MODEL_DEFAULTS
from ray_tpu_torch.models.cnn import get_filter_config
from ray_tpu_torch.ops.framestack import FRAMES, materialize_fragment
from ray_tpu_torch.policy.torch_policy import TorchPolicy, host_read


class DQNConfig(AlgorithmConfig):
    """The reference's DQNConfig defaults (RLlib's DQN defaults)."""

    def __init__(self, algo_class=None):
        super().__init__(algo_class or DQN)
        self.lr = 5e-4
        self.train_batch_size = 32
        self.rollout_fragment_length = 4
        self.gamma = 0.99
        self.num_steps_sampled_before_learning_starts = 1000
        self.target_network_update_freq = 500
        self.double_q = True
        self.dueling = True
        self.n_step = 1
        self.num_atoms = 1
        self.v_min = -10.0
        self.v_max = 10.0
        self.noisy = False
        self.sigma0 = 0.5
        self.replay_buffer_config = {
            "capacity": 50000,
            "prioritized_replay": False,
            "prioritized_replay_alpha": 0.6,
            "prioritized_replay_beta": 0.4,
        }
        self.epsilon_timesteps = 10000
        self.final_epsilon = 0.02
        self.initial_epsilon = 1.0
        self.training_intensity = None
        self.grad_clip = 40.0

    def training(
        self,
        *,
        double_q: Optional[bool] = None,
        dueling: Optional[bool] = None,
        n_step: Optional[int] = None,
        num_atoms: Optional[int] = None,
        v_min: Optional[float] = None,
        v_max: Optional[float] = None,
        noisy: Optional[bool] = None,
        sigma0: Optional[float] = None,
        epsilon_timesteps: Optional[int] = None,
        final_epsilon: Optional[float] = None,
        initial_epsilon: Optional[float] = None,
        **kwargs,
    ) -> "DQNConfig":
        super().training(**kwargs)
        for name, value in (
            ("double_q", double_q),
            ("dueling", dueling),
            ("n_step", n_step),
            ("num_atoms", num_atoms),
            ("v_min", v_min),
            ("v_max", v_max),
            ("noisy", noisy),
            ("sigma0", sigma0),
            ("epsilon_timesteps", epsilon_timesteps),
            ("final_epsilon", final_epsilon),
            ("initial_epsilon", initial_epsilon),
        ):
            if value is not None:
                setattr(self, name, value)
        return self


def adjust_nstep(n_step: int, gamma: float, batch: SampleBatch) -> None:
    """In-place n-step folding of a fragment (the reference's host numpy
    code, bitwise): ``rewards[t] <- sum_{k<n} gamma^k r[t+k]`` and
    ``new_obs[t] <- new_obs[t+k]`` up to the first terminal or the
    fragment's end, with the fold's length in an ``n_steps`` column,
    whose ``gamma ** n_steps`` discounts the row's bootstrap (a fragment
    tail folds fewer than ``n_step`` rewards)."""
    n = batch.count
    rewards = np.asarray(batch[SampleBatch.REWARDS], np.float32)
    dones = np.asarray(batch[SampleBatch.TERMINATEDS], bool)
    next_obs = np.asarray(batch[SampleBatch.NEXT_OBS])
    new_rewards = rewards.copy()
    new_next = next_obs.copy()
    new_dones = dones.copy()
    n_steps = np.ones(n, np.float32)
    for t in range(n):
        acc = rewards[t]
        last = t
        for k in range(1, n_step):
            if t + k >= n or dones[last]:
                break
            acc += (gamma**k) * rewards[t + k]
            last = t + k
        new_rewards[t] = acc
        new_next[t] = next_obs[last]
        new_dones[t] = dones[last]
        n_steps[t] = last - t + 1
    batch[SampleBatch.REWARDS] = new_rewards
    batch[SampleBatch.NEXT_OBS] = new_next
    batch[SampleBatch.TERMINATEDS] = new_dones
    batch["n_steps"] = n_steps


_EPSILON_KEYS = ("initial_epsilon", "final_epsilon", "epsilon_timesteps")


def _epsilon_exploration_config(config: Dict) -> Dict:
    """Fold DQN's flat epsilon knobs into ``exploration_config``: a
    user-supplied ``exploration_config`` wins over the flat defaults.
    With ``per_worker_exploration`` (Ape-X), remote worker i (1-based)
    of n explores at the constant ``eps_i = 0.4 ** (1 + 7 (i - 1) /
    (n - 1))``, the reference's ladder; the local worker keeps the
    schedule."""
    ec = dict(config.get("exploration_config") or {})
    for key in _EPSILON_KEYS:
        if key in config and key not in ec:
            ec[key] = config[key]
    i = int(config.get("worker_index", 0))
    if config.get("per_worker_exploration") and i > 0:
        n = max(1, int(config.get("num_workers", 1)))
        eps = 0.4 ** (1.0 + 7.0 * (i - 1) / max(1, n - 1))
        ec.update(initial_epsilon=eps, final_epsilon=eps, epsilon_timesteps=1)
    return ec


class DQNTorchPolicy(TorchPolicy):
    """Double/dueling TD loss (Huber, IS ``weights``), epsilon-greedy
    acting, and the target network as aux state."""

    default_exploration = "EpsilonGreedy"

    def __init__(self, observation_space, action_space, config: Dict, device=None):
        config = dict(config)
        config["exploration_config"] = _epsilon_exploration_config(config)
        model_cfg = config.get("model") or {}
        if model_cfg.get("use_lstm") or model_cfg.get("use_attention"):
            raise ValueError(
                "DQN with a recurrent model (use_lstm/use_attention) requires sequence "
                "replay — use the R2D2 algorithm (reference r2d2.py; not ported yet: "
                "ROADMAP.md queue 1 item 9) instead"
            )
        # the catalog's model (the transformer torso, a custom model)
        # stands in for DQNModel and its logits are read as Q values: no
        # atoms, no weight noise
        self._uses_dqn_model = not (model_cfg.get("use_transformer")
                                    or model_cfg.get("custom_model"))
        if not self._uses_dqn_model:
            if int(config.get("num_atoms", 1)) > 1:
                raise ValueError(
                    "distributional Q (num_atoms > 1) requires the built-in "
                    "DQNModel; it is unavailable with use_transformer/custom_model"
                )
            if config.get("noisy"):
                raise ValueError(
                    "noisy nets require the built-in DQNModel; unavailable "
                    "with use_transformer/custom_model"
                )
        self._noisy = self._uses_dqn_model and bool(config.get("noisy"))
        self._num_atoms = int(config.get("num_atoms", 1))
        super().__init__(observation_space, action_space, config, device=device)

    def _make_model(self, observation_space, action_space, num_outputs, generator):
        if not self._uses_dqn_model:
            return super()._make_model(observation_space, action_space, num_outputs, generator)
        cfg = {**MODEL_DEFAULTS, **self.model_config}
        shape = tuple(observation_space.shape)
        is_image = len(shape) == 3
        if is_image:
            hiddens = tuple(cfg["post_fcnet_hiddens"] or [512])
            activation = cfg["post_fcnet_activation"]
            filters = cfg["conv_filters"] or get_filter_config(shape)
            conv_filters = tuple(
                (
                    int(c),
                    tuple(k) if isinstance(k, (list, tuple)) else (k, k),
                    tuple(s) if isinstance(s, (list, tuple)) else (s, s),
                )
                for c, k, s in filters
            )
        else:
            hiddens = tuple(cfg["fcnet_hiddens"])
            activation = cfg["fcnet_activation"]
            conv_filters = None
        return DQNModel(
            shape,
            num_outputs,
            hiddens=hiddens,
            activation=activation,
            use_conv=is_image,
            conv_filters=conv_filters,
            conv_activation=cfg["conv_activation"],
            conv_dtype=cfg["dtype"] or "bfloat16",
            num_atoms=int(self.config.get("num_atoms", 1)),
            v_min=float(self.config.get("v_min", -10.0)),
            v_max=float(self.config.get("v_max", 10.0)),
            dueling=bool(self.config.get("dueling", True)),
            noisy=bool(self.config.get("noisy", False)),
            sigma0=float(self.config.get("sigma0", 0.5)),
            generator=generator,
        )

    def _init_aux_state(self) -> Dict[str, Any]:
        return {"target_params": [p.detach().clone() for p in self.params]}

    @torch.no_grad()
    def update_target(self) -> None:
        """Copy the online params into the target network, in place (a
        captured superstep slot reads the target tensors it saw)."""
        torch._foreach_copy_(self.aux_state["target_params"], [p.detach() for p in self.params])

    def extra_action_out(self, dist_inputs, value, dist) -> Dict[str, torch.Tensor]:
        # the Q values already ride ACTION_DIST_INPUTS
        return {}

    # -- the act step's weight noise -----------------------------------------

    def _act_noise(self, generator, explore: bool, draws=None):
        """Exploring with noisy heads, a forward's noise comes first."""
        if not (explore and self._noisy):
            return (), draws
        if draws:
            n = len(self.model.noise_shapes())
            return tuple(draws[:n]), tuple(draws[n:])
        return tuple(self.model.draw_noise(generator, self.device)), draws

    # -- loss ----------------------------------------------------------------

    def _q_dist(self, params, obs: torch.Tensor, noise=None):
        """``(q (B, A), support logits (B, A, atoms), probs or None)``
        of ``params``; the transformer torso's logits are its Q values."""
        if not self._uses_dqn_model:
            if params is self.params:
                q = self.model_forward(obs)[0]
            else:
                q = self.functional_forward(params, obs)[0]
            return q, q[..., None], None
        if params is self.params:
            return self.model(obs, noise, full=True)
        return self.functional_forward(params, obs, noise=noise, full=True)

    def draw_learn_noise(self):
        """The noise sets one TD error draws from ``action_generator``:
        the online net's on OBS, the target net's on NEXT_OBS and (double
        Q) the online net's on NEXT_OBS, each in the model's draw order;
        None without noisy heads."""
        if not self._noisy:
            return None
        sets = 3 if self.config.get("double_q", True) else 2
        return tuple(self.model.draw_noise(self.action_generator, self.device)
                     for _ in range(sets))

    def _td_error(self, batch: Dict[str, torch.Tensor], aux: Dict[str, Any], noise=None):
        """Per-row TD error ``q(s, a) - (r + gamma^n (1 - done)
        q_target(s', a'))``, with ``a'`` the online argmax under
        double-Q and the target argmax otherwise, or under C51 the
        cross-entropy to the projected target distribution;
        ``(td_error, q_sel, q_all)``. ``noise``: the noisy heads' three
        sets (:meth:`draw_learn_noise`, drawn here when None)."""
        cfg = self.config
        gamma = cfg.get("gamma", 0.99)
        if noise is None:
            noise = self.draw_learn_noise()
        k1, k2, k3 = (*noise, None)[:3] if noise is not None else (None,) * 3
        q_all, logits_all, _ = self._q_dist(self.params, batch[SampleBatch.OBS], k1)
        with torch.no_grad():
            q_next_target, _, probs_next = self._q_dist(
                aux["target_params"], batch[SampleBatch.NEXT_OBS], k2)
            if cfg.get("double_q", True):
                next_q_online = self._q_dist(self.params, batch[SampleBatch.NEXT_OBS], k3)[0]
                next_actions = torch.argmax(next_q_online, dim=-1)
            else:
                next_actions = torch.argmax(q_next_target, dim=-1)
        actions = batch[SampleBatch.ACTIONS].long()
        q_sel = q_all.gather(1, actions[:, None]).squeeze(1)
        not_done = 1.0 - batch[SampleBatch.TERMINATEDS].float()
        steps = batch.get("n_steps")
        if steps is not None:
            bootstrap = torch.pow(gamma, steps.float())
        else:
            bootstrap = torch.full_like(q_sel, gamma ** cfg.get("n_step", 1))
        if self._num_atoms > 1:
            with torch.no_grad():
                p_next = probs_next.gather(
                    1, next_actions[:, None, None].expand(-1, 1, probs_next.shape[-1])
                ).squeeze(1)
                m = categorical_projection(
                    p_next, batch[SampleBatch.REWARDS], bootstrap, not_done,
                    self.model.v_min, self.model.v_max, self.model.support, self.model.dz,
                )
            logits_sel = logits_all.gather(
                1, actions[:, None, None].expand(-1, 1, logits_all.shape[-1])
            ).squeeze(1)
            td_error = -torch.sum(m * torch.log_softmax(logits_sel, dim=-1), dim=-1)
            return td_error, q_sel, q_all
        q_next = q_next_target.gather(1, next_actions[:, None]).squeeze(1)
        td_target = batch[SampleBatch.REWARDS] + bootstrap * not_done * q_next
        return q_sel - td_target.detach(), q_sel, q_all

    def loss_with_aux(self, batch, aux, coeffs):
        td_error, q_sel, q_all = self._td_error(batch, aux)
        if self._num_atoms > 1:  # the per-row cross-entropy is the loss
            per_sample = td_error
        else:
            abs_err = torch.abs(td_error)
            per_sample = torch.where(
                abs_err < 1.0, 0.5 * torch.square(td_error), abs_err - 0.5
            )
        weights = batch.get("weights")
        if weights is None:
            weights = torch.ones_like(per_sample)
        loss = torch.mean(weights * per_sample)
        with torch.no_grad():
            stats = {
                "mean_q": torch.mean(q_sel),
                "mean_td_error": torch.mean(td_error),
                "max_q": torch.max(q_all),
            }
        return loss, stats

    def _td_input_tree(self, samples) -> Dict[str, torch.Tensor]:
        if getattr(samples, "is_device_resident", False):
            return samples.tree
        # a stacked batch whose rows slide comes back as a frame pool
        return self._with_stacks({
            k: torch.as_tensor(np.asarray(v)).to(self.device)
            for k, v in self._batch_to_train_tree(samples).items()
        })

    @torch.no_grad()
    def compute_td_error(self, samples, noise=None) -> np.ndarray:
        """Per-row |TD error| for the priority refresh (host numpy f32):
        the one readback of a replay update. With noisy heads it draws
        its own noise, as the reference's priority pass does (``noise``:
        inject it)."""
        td, _, _ = self._td_error(self._td_input_tree(samples), self.aux_state, noise)
        return np.abs(td.cpu().numpy())

    def get_state(self, read=None) -> Dict[str, Any]:
        read = read or host_read
        state = super().get_state(read)
        state["target_weights"] = {
            n: read(t) for n, t in zip(self.param_names, self.aux_state["target_params"])
        }
        return state

    @torch.no_grad()
    def set_state(self, state: Dict[str, Any]) -> None:
        super().set_state(state)
        target = state.get("target_weights")
        if target is None:
            self.update_target()
            return
        for n, t in zip(self.param_names, self.aux_state["target_params"]):
            t.copy_(torch.as_tensor(np.asarray(target[n])))


class DQN(Algorithm):
    _default_policy_class = DQNTorchPolicy
    _actor_lane = True
    _multi_agent = True
    _learns_under_act_lock = True

    @classmethod
    def get_default_config(cls) -> DQNConfig:
        return DQNConfig(cls)

    def __init__(self, config=None, env=None):
        super().__init__(config, env)
        cfg = self.config
        rb_cfg = cfg.get("replay_buffer_config") or {}
        self.local_replay_buffer = MultiAgentReplayBuffer(
            capacity=rb_cfg.get("capacity", 50000),
            prioritized=rb_cfg.get("prioritized_replay", False),
            alpha=rb_cfg.get("prioritized_replay_alpha", 0.6),
            seed=cfg.get("seed"),
            device=self.device,
            memory_cap_bytes=cfg.get("replay_memory_cap_bytes"),
            # host fragments convert to the policy's columns once, at insert
            replay_columns_fn=lambda pid, sb: self.get_policy(pid).replay_columns(sb),
            device_resident=resolve_device_resident(cfg),
            device_tree=resolve_device_tree(cfg),
        )
        self._last_target_update = 0
        self._training_debt = 0.0
        # the sample_async round's requests for the next round
        self._pending_sample_refs = None
        if self._fault_injector is not None and "nan_batch" in self._fault_injector.spec:
            raise ValueError(
                "fault_injection nan_batch poisons a host learn batch; the replay family "
                "learns from its rings, whose rows no injector reaches (the nan guard's "
                "masked slot is checked on a poisoned ring row instead)"
            )

    # -- the device lane ---------------------------------------------------

    def _jax_rollout_engine_get(self):
        """The device rollout engine (``postprocess="none"``), built on
        first use: N = num_envs_per_worker x max(1, num_workers) env
        slots, T = rollout_fragment_length."""
        if self._rollout_engine is None:
            from ray_tpu_torch.execution.device_rollout import DeviceRolloutEngine

            cfg = self.config
            if int(cfg.get("n_step", 1)) > 1:
                raise ValueError(
                    "env_backend='jax' supports n_step=1 only (n-step folding "
                    "is a host-side postprocess)"
                )
            n = int(cfg.get("num_envs_per_worker", 1)) * max(1, int(cfg.get("num_workers", 0)))
            t = int(cfg.get("rollout_fragment_length", 4))
            self._rollout_engine = DeviceRolloutEngine(
                self.get_policy(), self.env, n, t, seed=cfg.get("seed"), postprocess="none",
            )
            self._extra_metric_sources.append(self._rollout_engine.get_metrics)
        return self._rollout_engine

    def _insert_rollout_tree(self, tree: Dict[str, torch.Tensor]) -> None:
        """Absorb one rollout's device rows: into the device rings, or
        pulled back once into a host ring."""
        if self.local_replay_buffer.device_resident:
            self.local_replay_buffer.add_device_tree(tree, DEFAULT_POLICY_ID)
        else:
            self.local_replay_buffer.add(SampleBatch({k: v.cpu().numpy() for k, v in tree.items()}))

    def _jax_rollout_fill(self) -> int:
        """One rollout into the replay buffer; returns the env steps."""
        tree, count = self._jax_rollout_engine_get().rollout()
        self._insert_rollout_tree(tree)
        return count

    # -- replay updates ----------------------------------------------------

    def _single_update(self, prioritized: bool, kwargs: Dict, overlap=None) -> Dict:
        """One replay sample + learn call, then the per-row priority
        refresh ``|td| + 1e-6`` (added in float32, as the reference's
        host call site rounds it). A host ring's batch is a host
        ``SampleBatch``, learned with one upload. Under a superstep
        (K > 1: on CUDA by default) the update is one replay of the
        superstep's captured slot, as the reference's is one compiled
        program: the same draws, the same update bitwise, one host call
        instead of the eager update's few hundred launches."""
        K = self._resolve_superstep_k()
        if K > 1:
            return self._superstep_round(1, K, prioritized, kwargs.get("beta", 0.4), overlap)
        train_info: Dict = {}
        train_batch = self.local_replay_buffer.sample(self.config["train_batch_size"], **kwargs)
        for pid, b in train_batch.items():
            policy = self.get_policy(pid)
            if getattr(b, "is_device_resident", False):
                train_info[pid] = policy.learn_on_device_batch(dict(b.tree), b.count)
                idx = b.indices
            else:
                train_info[pid] = policy.learn_on_batch(b)
                idx = b.get("batch_indexes")
            if prioritized:
                self.local_replay_buffer.buffers[pid].update_priorities(
                    idx, policy.compute_td_error(b) + 1e-6
                )
            self._counters[NUM_ENV_STEPS_TRAINED] += b.count
        return train_info

    def _chained_updates(self, updates: int, prioritized: bool, beta: float, overlap=None) -> Dict:
        """``updates`` replay updates back to back: every full window of
        K runs as one superstep per policy, the rest one at a time
        (``overlap`` goes with the first superstep)."""
        K = self._resolve_superstep_k()
        train_info: Dict = {}
        left = updates
        while K > 1 and left >= K:
            train_info.update(self._superstep_round(K, K, prioritized, beta, overlap))
            overlap = None
            left -= K
        kwargs = {"beta": beta} if prioritized else {}
        for _ in range(left):
            train_info.update(self._single_update(prioritized, kwargs, overlap))
            overlap = None
        return train_info

    def _superstep_round(self, k: int, K: int, prioritized: bool, beta: float,
                         overlap=None) -> Dict:
        """``k`` <= ``K`` replay updates of every policy whose buffer
        holds a batch, as one ``superstep_train_replay`` call each (one
        captured slot per (batch size, K), shared by every k)."""
        bs = int(self.config["train_batch_size"])
        train_info: Dict = {}
        for pid, buf in self.local_replay_buffer.buffers.items():
            if len(buf) < bs:
                continue
            train_info[pid] = superstep_train_replay(
                self, self.get_policy(pid), buf, k, K, bs, prioritized=prioritized, beta=beta,
                overlap=overlap,
            )
            overlap = None
            self._counters[NUM_ENV_STEPS_TRAINED] += k * bs
        return train_info

    def _replay_update_phase(self, sampled_steps: int,
                             overlap: Optional[Callable[[], None]] = None) -> Dict:
        """Once learning has started: ``training_intensity`` debt → the
        number of updates this round (one by default; prioritized replay
        takes the debt only under a superstep, whose stacked refresh
        keeps the update order, and otherwise refreshes between
        samples), then the target-network sync. ``overlap`` runs while
        the round's first superstep runs on the card, if there is one."""
        cfg = self.config
        train_info: Dict = {}
        if not (
            self._counters[NUM_ENV_STEPS_SAMPLED]
            >= cfg.get("num_steps_sampled_before_learning_starts", 0)
            and len(self.local_replay_buffer) > 0
        ):
            return train_info
        if self._fault_injector is not None:
            # the replay family's learn choke point: one learn call a round
            # (``crash_learner``; the reference's replay round consults no
            # injector, the port's own)
            self._fault_injector.on_learn(None)
        rb_cfg = cfg.get("replay_buffer_config") or {}
        prioritized = rb_cfg.get("prioritized_replay", False)
        beta = rb_cfg.get("prioritized_replay_beta", 0.4)
        updates = 1
        ti = cfg.get("training_intensity")
        if ti and (not prioritized or self._resolve_superstep_k() > 1):
            self._training_debt += sampled_steps * float(ti)
            updates = int(self._training_debt // cfg["train_batch_size"])
            self._training_debt -= updates * cfg["train_batch_size"]
        if updates > 1:
            train_info = self._chained_updates(updates, prioritized, beta, overlap)
        elif updates == 1:
            train_info = self._single_update(
                prioritized, {"beta": beta} if prioritized else {}, overlap)
        if (
            self._counters[NUM_ENV_STEPS_TRAINED] - self._last_target_update
            >= cfg.get("target_network_update_freq", 500)
        ):
            for policy in self._policy_map().values():
                policy.update_target()
            self._last_target_update = self._counters[NUM_ENV_STEPS_TRAINED]
            self._counters["num_target_updates"] += 1
        return train_info

    def training_step(self) -> Dict:
        """One round on the device lane: rollout fill, then the replay
        update phase (the actor lane: :meth:`_training_step_actor_lane`)."""
        cfg = self.config
        if cfg.get("env_backend") != "jax":
            return self._training_step_actor_lane()
        if self._interleave_ready():
            train_info = self._interleaved_round()
        else:
            sampled = self._jax_rollout_fill()
            self._counters[NUM_ENV_STEPS_SAMPLED] += sampled
            train_info = self._replay_update_phase(sampled)
        self.get_policy().global_timestep = self._counters[NUM_ENV_STEPS_SAMPLED]
        return train_info

    def _interleave_ready(self) -> bool:
        """``learn_while_rollout``'s cadence engages once the lane is
        warm (the reference's): the engine built, learning started, and
        a full batch of earlier rounds' rows in the buffer."""
        cfg = self.config
        if not cfg.get("learn_while_rollout") or self._rollout_engine is None:
            return False
        buf = self.local_replay_buffer.buffers.get(DEFAULT_POLICY_ID)
        if buf is None or len(buf) < int(cfg["train_batch_size"]):
            return False
        return self._counters[NUM_ENV_STEPS_SAMPLED] >= cfg.get(
            "num_steps_sampled_before_learning_starts", 0)

    def _interleaved_round(self) -> Dict:
        """One ``learn_while_rollout`` round: the acting weights copied
        into the acting model, the update phase launched, the fill run
        on the copy while the updates' superstep runs (``overlap``), then
        the fill's rows inserted. Everything is on the current stream:
        the copy is ordered before the graph's in-place updates and the
        fill's kernels after them, so what overlaps the graph is the
        fill's host work (its eager launches)."""
        engine = self._rollout_engine
        policy = self.get_policy()
        acting = self.__dict__.get("_acting_model")
        if acting is None:
            acting = self._acting_model = copy.deepcopy(policy.model)
        with torch.no_grad():
            torch._foreach_copy_(list(acting.parameters()), [p.detach() for p in policy.params])
        out: Dict[str, Any] = {}

        def fill() -> None:
            if out:
                return
            live = policy.model
            policy.model = acting
            try:
                out["tree"] = engine.rollout()[0]
            finally:
                policy.model = live

        self._counters[NUM_ENV_STEPS_SAMPLED] += engine.batch_size
        train_info = self._replay_update_phase(engine.batch_size, overlap=fill)
        fill()  # no superstep ran it
        self._insert_rollout_tree(out["tree"])
        return train_info

    def _materialize_compressed(self, batch):
        """Worker-compressed frame pools (``compress_replay_obs``: the
        pool covers OBS and NEXT_OBS exactly, terminal stacks included)
        back to stacked OBS and NEXT_OBS, byte for byte, per policy
        batch (``materialize_fragment``)."""

        def mat(pid, sb):
            if FRAMES not in sb:
                return sb
            k = int(self.get_policy(pid).observation_space.shape[-1])
            return SampleBatch(materialize_fragment(dict(sb), k))

        if isinstance(batch, MultiAgentBatch):
            batch.policy_batches = {pid: mat(pid, sb) for pid, sb in batch.policy_batches.items()}
            return batch
        return mat(DEFAULT_POLICY_ID, batch)

    def _postprocess_fragment(self, batch):
        """The actor lane's host work between sampling and the insert, as
        the reference's: frame pools back to stacks, then the n-step fold
        of every policy batch."""
        batch = self._materialize_compressed(batch)
        n_step = int(self.config.get("n_step", 1))
        if n_step > 1:
            parts = batch.policy_batches.values() if isinstance(batch, MultiAgentBatch) else [batch]
            for b in parts:
                adjust_nstep(n_step, self.config["gamma"], b)
        return batch

    def _sample_one_round_stale(self):
        """The ``sample_async`` round's fragments (the reference's
        ``dqn.py:993-1013``): the ones requested in the round before (at
        the first round, requested now), one a remote worker, and the
        next round's requested at once, before the insert and the
        update."""
        workers = self.workers.remote_workers()
        refs = self._pending_sample_refs
        if refs is None:
            refs = [w.sample.remote() for w in workers]
        batches = core.get(refs)
        self._pending_sample_refs = [w.sample.remote() for w in workers]
        return concat_samples(batches)

    def _training_step_actor_lane(self) -> Dict:
        """The reference's off-policy round off the device lane: sample
        ``rollout_fragment_length x num_envs_per_worker`` env steps (with
        ``sample_async`` and remote workers, the fragments requested in
        the round before: :meth:`_sample_one_round_stale`), rebuild frame
        pools and fold n-step returns (:meth:`_postprocess_fragment`),
        insert them into the device rings (one ring per policy), the
        replay update phase, then the acting weights and the timestep to
        every worker. The parts' seconds add up in ``self._timers``
        (``sample_s``, ``insert_s`` with the host postprocess,
        ``update_s``, ``sync_weights_s``) over the run."""
        cfg = self.config
        t0 = time.perf_counter()
        if cfg.get("sample_async") and self.workers.remote_workers():
            batch = self._sample_one_round_stale()
        else:
            batch = synchronous_parallel_sample(
                worker_set=self.workers,
                max_env_steps=int(cfg.get("rollout_fragment_length", 4))
                * max(1, int(cfg.get("num_envs_per_worker", 1))),
            )
        t1 = time.perf_counter()
        batch = self._postprocess_fragment(batch)
        sampled = batch.env_steps()
        self._counters[NUM_ENV_STEPS_SAMPLED] += sampled
        self.local_replay_buffer.add(batch)
        t2 = time.perf_counter()
        # an input reader on the local worker acts from its own threads
        with self.workers.local_worker().act_lock():
            train_info = self._replay_update_phase(sampled)
        t3 = time.perf_counter()
        self.workers.sync_weights(
            global_vars={"timestep": self._counters[NUM_ENV_STEPS_SAMPLED]},
            inference_only=True,
        )
        timers = self._timers
        timers["sample_s"] += t1 - t0
        timers["insert_s"] += t2 - t1
        timers["update_s"] += t3 - t2
        timers["sync_weights_s"] += time.perf_counter() - t3
        return train_info

    def on_fleet_change(self, added, removed) -> None:
        """The synchronous round reads the fleet each time; the
        ``sample_async`` round holds one pending ref per worker of the
        last round's fleet: drop them, so the next round asks the fleet of
        now instead of reading a drained worker's ref."""
        super().on_fleet_change(added, removed)
        if removed:
            self._pending_sample_refs = None

    def on_recovery(self, kind: str) -> None:
        """After a recovery the pending ``sample_async`` refs name dead
        workers (or were sampled before a restore): drop them."""
        super().on_recovery(kind)
        self._pending_sample_refs = None

    def stop(self) -> None:
        self._pending_sample_refs = None
        super().stop()

    # -- checkpoint state ----------------------------------------------------

    def __getstate__(self) -> Dict:
        state = super().__getstate__()
        state["replay_buffer"] = self.local_replay_buffer.get_state()
        state["last_target_update"] = self._last_target_update
        return state

    def __setstate__(self, state: Dict) -> None:
        super().__setstate__(state)
        self._pending_sample_refs = None  # sampled before the restore
        if "replay_buffer" in state:
            self.local_replay_buffer.set_state(state["replay_buffer"])
        self._last_target_update = state.get("last_target_update", 0)
