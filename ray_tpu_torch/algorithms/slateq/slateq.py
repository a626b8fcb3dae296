"""SlateQ: Q-learning over recommendation slates.

Counterpart of ``ray_tpu/algorithms/slateq/slateq.py`` (Ie et al. 2019):
per-item Q values decomposed over a slate with a user-choice model,
``Q(s, slate) = Σ_i v_i Q_i / (Σ_i v_i + v_no_click)``; the greedy slate
maximises that over every ordered slate (the (A, S) table of
``itertools.permutations``), and the TD target bootstraps the best next
slate's value.

- **Observations** are the flat RecSim layout ``[user (E) | docs (C·E) |
  response (2·S)]`` (``env/synthetic_slate.py``, ``SyntheticSlate-v0``);
  the ``NEXT_OBS`` response slot holds this transition's clicks and
  watch times, from which the reward is taken. E, C and S come from the
  env's spaces (:func:`slate_sizes`), where the reference reads the
  config's.
- **The choice model is learned**, as the reference's: a multinomial
  logit with ``beta`` scaling user · doc and a no-click score, both
  starting at 0 and clipped to ±15, fit by the NLL of the observed event
  over S + 1 classes (which shown document was clicked, or none).
- **The learn**: the TD loss on clicked rows only, normalised by the
  clicked count (the reference's ``psum`` over one device), the target's
  Q values at ``NEXT_OBS``'s user and documents, weighted by the current
  choice model with no gradient; plus the choice NLL; two Adam states,
  ``lr`` for ``q`` and ``lr_choice_model`` for ``choice`` (optax's
  ``multi_transform``). The target copies ``q`` only.
- **Acting** is greedy over slate indices, or epsilon-greedy with a
  uniform slate index and a uniform from the policy's generator (the
  reference draws from ``jax.random``; tests inject its draws).

``SlateQ`` is DQN on its actor lane: the local worker (or remote
workers) samples, the fragment's four replay columns (obs, new_obs,
actions, terminateds) cross to the device rings once (the row-scatter
kernel), each update gathers its rows (the row-gather kernel), and on
CUDA an update runs as one replay of a graphed superstep slot
(:meth:`SlateQTorchPolicy._slot_update`), as DQN's. ``n_step != 1`` and
``lr_schedule`` raise, as in the reference; so does ``env_backend:
"jax"``, whose lane has no slate env.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ray_tpu_torch.algorithms.algorithm import refuse_device_lane
from ray_tpu_torch.algorithms.dqn.dqn import DQN, DQNConfig, _epsilon_exploration_config
from ray_tpu_torch.data.sample_batch import SampleBatch
from ray_tpu_torch.env.synthetic_slate import SyntheticSlateEnv
from ray_tpu_torch.models.base import Dense, TorchModel, get_activation
from ray_tpu_torch.policy.torch_policy import AdamState, TorchPolicy, adam_update, host_read

__all__ = ["SlateQ", "SlateQConfig", "SlateQTorchPolicy", "SyntheticSlateEnv"]

OPT_GROUPS = ("q", "choice")
TRAIN_COLUMNS = (SampleBatch.OBS, SampleBatch.NEXT_OBS, SampleBatch.ACTIONS,
                 SampleBatch.TERMINATEDS, "weights")
SLATEQ_STATS = ("total_loss", "choice_loss", "choice_beta", "mean_q_clicked",
                "mean_td_error", "click_fraction")


class ItemQNet(nn.Module):
    """Q(user, doc) of every candidate (the reference's ``_ItemQNet``):
    user (B, E), docs (B, C, E) → (B, C)."""

    def __init__(self, embedding_dim: int, hiddens: Sequence[int] = (64, 64),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_hiddens = len(hiddens)
        sizes = [2 * int(embedding_dim), *[int(h) for h in hiddens]]
        for i in range(self.num_hiddens):
            setattr(self, f"fc_{i}", Dense(sizes[i], sizes[i + 1], generator=generator))
        self.q = Dense(sizes[-1], 1, generator=generator)
        self.act = get_activation("relu")

    def forward(self, user: torch.Tensor, docs: torch.Tensor) -> torch.Tensor:
        B, C, E = docs.shape
        x = torch.cat([user[:, None].expand(B, C, E), docs], dim=-1).reshape(B * C, 2 * E)
        for i in range(self.num_hiddens):
            x = self.act(getattr(self, f"fc_{i}")(x))
        return self.q(x).reshape(B, C)


def score_documents(user: torch.Tensor, docs: torch.Tensor, no_click_score: float = 1.0,
                    min_normalizer: float = -1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's fixed proportional scorer: ``(user · doc -
    min_normalizer (B, C), no_click_score - min_normalizer (B,))``."""
    scores = torch.sum(user[:, None, :] * docs, dim=-1) - min_normalizer
    no_click = torch.full((user.shape[0],), no_click_score - min_normalizer,
                          dtype=scores.dtype, device=scores.device)
    return scores, no_click


class ChoiceModel(nn.Module):
    """The learned multinomial-logit choice model: ``beta`` (scale of
    user · doc) and ``score_no_click``, both starting at 0; scores
    clipped to ±15. user (B, E), docs (B, C, E) → ``(scores (B, C),
    no-click score (B,))``."""

    def __init__(self):
        super().__init__()
        self.beta = nn.Parameter(torch.zeros(()))
        self.score_no_click = nn.Parameter(torch.zeros(()))

    def forward(self, user: torch.Tensor, docs: torch.Tensor):
        dots = torch.sum(user[:, None, :] * docs, dim=-1)
        scores = torch.clamp(self.beta * dots, -15.0, 15.0)
        no_click = torch.clamp(self.score_no_click, -15.0, 15.0).expand(user.shape[0])
        return scores, no_click


def choice_masses(scores: torch.Tensor, no_click: torch.Tensor):
    """The logit's masses: ``exp(score)`` a document, ``exp(no_click)``."""
    return torch.exp(scores), torch.exp(no_click)


def slate_sizes(observation_space, action_space, config: Dict) -> Tuple[int, int, int]:
    """``(embedding_dim, num_candidates, slate_size)`` of the env the
    policy acts in: a ``MultiDiscrete`` slate space gives C and S (its
    ``nvec``), the observation's width ``E + C·E + 2·S`` gives E. The
    reference reads the three from the top-level config, so its own
    ``synthetic-slateq.yaml`` (``env_config`` of 10 candidates, the
    config's default 8) fails on the first learn; another slate space
    takes the config's values, as the reference's."""
    nvec = getattr(action_space, "nvec", None)
    if nvec is None:
        return (int(config.get("embedding_dim", 4)), int(config.get("num_candidates", 8)),
                int(config.get("slate_size", 2)))
    C, S = int(np.asarray(nvec).reshape(-1)[0]), int(np.asarray(nvec).size)
    width = int(np.prod(observation_space.shape))
    E, rest = divmod(width - 2 * S, C + 1)
    if rest or E <= 0:
        raise ValueError(
            f"SlateQ: an observation of {width} is not [user (E) | docs ({C}·E) | "
            f"response (2·{S})]"
        )
    return E, C, S


class SlateQModel(TorchModel):
    """The item Q net (``q``) and the choice model (``choice``)."""

    def __init__(self, embedding_dim: int, hiddens: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.q = ItemQNet(embedding_dim, hiddens, generator)
        self.choice = ChoiceModel()


class SlateQConfig(DQNConfig):
    """The reference's SlateQConfig defaults."""

    def __init__(self, algo_class=None):
        super().__init__(algo_class or SlateQ)
        self.slate_size = 2
        self.num_candidates = 8
        self.embedding_dim = 4
        self.hiddens = [64, 64]
        self.lr = 1e-3
        self.train_batch_size = 64
        self.rollout_fragment_length = 20
        self.n_step = 1
        self.target_network_update_freq = 500
        self.num_steps_sampled_before_learning_starts = 500
        self.replay_buffer_config = {
            "capacity": 20000,
            "prioritized_replay": False,
        }


class SlateQTorchPolicy(TorchPolicy):
    """The decomposed slate Q, its learned choice model, two Adam states
    and the target item Q net as aux state."""

    default_exploration = "EpsilonGreedy"

    def __init__(self, observation_space, action_space, config: Dict, device=None):
        config = dict(config)
        config["exploration_config"] = _epsilon_exploration_config(config)
        self.E, self.C, self.S = slate_sizes(observation_space, action_space, config)
        # every ordered slate, the reference's precomputed policy.slates
        self.slates_np = np.array(list(itertools.permutations(range(self.C), self.S)), np.int32)
        super().__init__(observation_space, action_space, config, device=device)
        self.slates = torch.as_tensor(self.slates_np, dtype=torch.int64, device=self.device)
        self.gamma = float(config.get("gamma", 0.99))
        self.param_groups = {g: [n for n in self.param_names if n.startswith(g + ".")]
                             for g in OPT_GROUPS}
        self.q_names = [n[len("q."):] for n in self.param_groups["q"]]

    # -- construction ------------------------------------------------------

    def _make_model(self, observation_space, action_space, num_outputs, generator):
        return SlateQModel(self.E, tuple(self.config.get("hiddens", (64, 64))), generator)

    def _group_params(self, group: str) -> List[torch.Tensor]:
        return list(getattr(self.model, group).parameters())

    def group_param_names(self, group: str) -> List[str]:
        return [f"{group}.{n}" for n, _ in getattr(self.model, group).named_parameters()]

    def _init_optimizer(self) -> None:
        self.opt_states = {g: AdamState(self._group_params(g)) for g in OPT_GROUPS}
        self.opt_state = None

    def _adam_states(self) -> List[AdamState]:
        return [self.opt_states[g] for g in OPT_GROUPS]

    def _init_coeffs(self) -> None:
        self.coeff_values["lr_choice_model"] = float(self.config.get("lr_choice_model", 1e-2))

    def _init_aux_state(self) -> Dict[str, Any]:
        return {"target_params": [p.detach().clone() for p in self.model.q.parameters()]}

    def _learner_tensors(self) -> List[torch.Tensor]:
        return super()._learner_tensors() + list(self.aux_state["target_params"])

    @torch.no_grad()
    def update_target(self) -> None:
        """The target copies the item Q net in place (the choice model has
        no target: TD targets read its current probabilities)."""
        torch._foreach_copy_(self.aux_state["target_params"],
                             [p.detach() for p in self.model.q.parameters()])

    # -- the decomposition -------------------------------------------------

    def _split_obs(self, obs: torch.Tensor):
        E, C, S = self.E, self.C, self.S
        obs = obs.float()
        return (obs[:, :E], obs[:, E:E + C * E].reshape(-1, C, E),
                obs[:, E + C * E:].reshape(-1, 2, S))

    def _slate_values(self, q_values: torch.Tensor, scores: torch.Tensor,
                      no_click: torch.Tensor) -> torch.Tensor:
        """Q(s, slate) of every slate (B, A) (the reference's
        ``get_per_slate_q_values``)."""
        q_slate = q_values[:, self.slates]  # (B, A, S)
        s_slate = scores[:, self.slates]
        denom = s_slate.sum(-1) + no_click[:, None]
        return (q_slate * s_slate).sum(-1) / denom

    def _target_q(self, user: torch.Tensor, docs: torch.Tensor) -> torch.Tensor:
        params = dict(zip(self.q_names, self.aux_state["target_params"]))
        return torch.func.functional_call(self.model.q, params, (user, docs))

    # -- acting ------------------------------------------------------------

    @torch.no_grad()
    def compute_actions(self, obs_batch, state_batches=None, prev_action_batch=None,
                        prev_reward_batch=None, explore: bool = True, draws=None, **kwargs):
        """(B, S) slates: the greedy slate index, or with probability
        epsilon a uniform one when exploring. ``draws``: the (B,) random
        slate indices and (B,) uniforms, injected; else from
        ``action_generator``."""
        self.exploration.update_coeffs(self.coeff_values, self.global_timestep)
        obs = torch.as_tensor(np.asarray(obs_batch, np.float32), device=self.device)
        user, docs, _ = self._split_obs(obs)
        scores, no_click = choice_masses(*self.model.choice(user, docs))
        idx = torch.argmax(self._slate_values(self.model.q(user, docs), scores, no_click), dim=-1)
        if explore:
            B = idx.shape[0]
            if draws is None:
                rand = torch.randint(0, self.slates.shape[0], (B,),
                                     generator=self.action_generator, device=self.device)
                u = torch.rand((B,), generator=self.action_generator, device=self.device)
            else:
                rand = torch.as_tensor(np.array(draws[0]), device=self.device).to(idx.dtype)
                u = torch.as_tensor(np.array(draws[1], np.float32), device=self.device)
            idx = torch.where(u < self.coeff_values.get("epsilon", 0.0), rand, idx)
        return self.slates[idx].cpu().numpy(), [], {}

    def get_initial_state(self):
        return []

    # -- the update --------------------------------------------------------

    def _train_columns(self, samples, keep_state_in: bool = False) -> Dict[str, np.ndarray]:
        """The columns an update reads (the PER ``weights`` when there)."""
        return {k: np.asarray(samples[k]) for k in TRAIN_COLUMNS if k in samples}

    def _targets(self, batch: Dict[str, torch.Tensor]):
        """``(user, docs, click (B, S), y (B,))``: the TD target from the
        target Q net at NEXT_OBS, under the current choice model's masses
        (no gradient)."""
        user, docs, _ = self._split_obs(batch[SampleBatch.OBS])
        next_user, next_docs, next_resp = self._split_obs(batch[SampleBatch.NEXT_OBS])
        click, watch = next_resp[:, 0, :], next_resp[:, 1, :]
        done = batch[SampleBatch.TERMINATEDS].float()
        with torch.no_grad():
            reward = torch.sum(watch * click, dim=1)
            tq = self._target_q(next_user, next_docs)
            n_scores, n_no_click = choice_masses(*self.model.choice(next_user, next_docs))
            next_max = torch.max(self._slate_values(tq, n_scores, n_no_click), dim=-1).values
            y = reward + self.gamma * (1.0 - done) * next_max
        return user, docs, click, y

    def _slateq_update(self, batch: Dict[str, torch.Tensor],
                       coeffs: Dict[str, torch.Tensor]) -> Tuple[Tuple[str, ...], torch.Tensor]:
        """One update with no host read: ``(SLATEQ_STATS, (6,) device
        stats)``."""
        actions = batch[SampleBatch.ACTIONS].long()
        user, docs, click, y = self._targets(batch)
        weights = batch.get("weights")
        q = self.model.q(user, docs)
        clicked_q = torch.sum(q.gather(1, actions) * click, dim=1)
        clicked = click.sum(dim=1)
        td = (clicked_q - y) * clicked
        n = torch.clamp_min(clicked.sum(), 1.0)
        sq = torch.square(td) if weights is None else weights.float() * torch.square(td)
        td_loss = torch.sum(sq) / n
        c_scores, c_no_click = self.model.choice(user, docs)
        logits = torch.cat([c_scores.gather(1, actions), c_no_click[:, None]], dim=1)
        label = torch.where(clicked > 0, torch.argmax(click, dim=1),
                            torch.full_like(actions[:, 0], self.S))
        nll = -torch.log_softmax(logits, dim=-1).gather(1, label[:, None]).squeeze(1)
        choice_loss = torch.mean(nll)
        loss = td_loss + choice_loss
        params = [*self._group_params("q"), *self._group_params("choice")]
        grads = torch.autograd.grad(loss, params)
        nq = len(self._group_params("q"))
        st = self.opt_states
        adam_update(params[:nq], list(grads[:nq]), st["q"], coeffs["lr"], self.adam_eps, None)
        adam_update(params[nq:], list(grads[nq:]), st["choice"], coeffs["lr_choice_model"],
                    self.adam_eps, None)
        with torch.no_grad():
            stats = torch.stack([
                loss.detach(), choice_loss.detach(), self.model.choice.beta.detach(),
                torch.sum(clicked_q.detach()) / n, torch.sum(td.detach()) / n,
                torch.mean(clicked),
            ])
        return SLATEQ_STATS, stats

    def learn_on_batch(self, samples) -> Dict[str, Any]:
        """One update on a host batch."""
        batch, bsize = self.prepare_batch(samples)
        dev = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}
        return self.learn_on_device_batch(dev, bsize)

    def learn_on_device_batch(self, dev_batch, batch_size, perms=None, defer_stats=False):
        """One update on a device batch: both Adam steps, the stats as
        floats."""
        self._update_scheduled_coeffs()
        self._load_corrections(1)
        names, reduced = self._slateq_update(dict(dev_batch), self._load_coeffs())
        for st in self._adam_states():
            st.count += 1
        self.num_grad_updates += 1
        return {**dict(zip(names, reduced.tolist())), **self._info_extras()}

    def _steps_per_update(self, batch_size: int) -> int:
        return 1

    def _host_permutations(self, batch_size: int) -> torch.Tensor:
        """An update reads its rows in order: a superstep's permutation
        slots hold zeros, and the permutation generator draws nothing."""
        return torch.zeros((self.num_sgd_iter, self._perm_width(batch_size)), dtype=torch.int64)

    def _slot_update(self, runner, batch, batch_size):
        return self._slateq_update(batch, self._coeff_tensors)

    def _td_error(self, batch: Dict[str, torch.Tensor], aux: Dict[str, Any]):
        """``((clicked Q - y) · clicked,)`` per row: unclicked rows carry
        no TD signal."""
        with torch.no_grad():
            user, docs, click, y = self._targets(batch)
            q = self.model.q(user, docs)
            clicked_q = torch.sum(q.gather(1, batch[SampleBatch.ACTIONS].long()) * click, dim=1)
            return ((clicked_q - y) * click.sum(dim=1),)

    @torch.no_grad()
    def compute_td_error(self, samples) -> np.ndarray:
        """Per-row |TD error| for a prioritized refresh (host numpy f32)."""
        if getattr(samples, "is_device_resident", False):
            tree = samples.tree
        else:
            tree = {k: torch.as_tensor(v).to(self.device)
                    for k, v in self._train_columns(samples).items()}
        return np.abs(self._td_error(tree, self.aux_state)[0].cpu().numpy())

    # -- state -------------------------------------------------------------

    def get_state(self, read=None) -> Dict[str, Any]:
        read = read or host_read

        def host(ts, names):
            return {n: read(t) for n, t in zip(names, ts)}

        return {
            "weights": self.get_weights(read),
            "opt_state": {
                g: {"count": self.opt_states[g].count,
                    "mu": host(self.opt_states[g].mu, self.group_param_names(g)),
                    "nu": host(self.opt_states[g].nu, self.group_param_names(g))}
                for g in OPT_GROUPS
            },
            "target_weights": host(self.aux_state["target_params"], self.group_param_names("q")),
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
        if target is None:
            self.update_target()
        else:
            for n, t in zip(self.group_param_names("q"), self.aux_state["target_params"]):
                t.copy_(torch.as_tensor(np.asarray(target[n])))
        self.coeff_values.update(state.get("coeff_values", {}))
        self.global_timestep = state.get("global_timestep", 0)
        self.num_grad_updates = state.get("num_grad_updates", 0)
        self.exploration.set_state(state.get("exploration_state", {}))


class SlateQ(DQN):
    """DQN's actor lane and device rings under :class:`SlateQTorchPolicy`."""

    _default_policy_class = SlateQTorchPolicy

    @classmethod
    def get_default_config(cls) -> SlateQConfig:
        return SlateQConfig(cls)

    def __init__(self, config=None, env=None):
        cfg = config.to_dict() if hasattr(config, "to_dict") else dict(config or {})
        if int(cfg.get("n_step", 1)) != 1:
            raise ValueError(
                "SlateQ derives rewards from the slate response in NEXT_OBS; n-step folding "
                "would pair them wrongly — n_step must be 1"
            )
        if cfg.get("lr_schedule"):
            raise ValueError(
                "SlateQ's compiled step embeds a fixed adam lr; lr_schedule is not supported yet"
            )
        super().__init__(config, env)

    def training_step(self) -> Dict:
        refuse_device_lane(self)
        return self._training_step_actor_lane()
