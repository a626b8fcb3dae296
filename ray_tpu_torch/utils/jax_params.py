"""Load the JAX package's parameters and Adam state into the port.

Takes plain numpy trees (what ``jax.device_get`` returns; nothing here
imports JAX) and maps flax's layouts onto the port's:

- ``{"params": {"conv_0": {"kernel", "bias"}, ...}}`` → the module's
  parameters of the same layer name (``conv_0.weight``, ...);
- conv kernels HWIO → OIHW;
- dense kernels (in, out) → (out, in), with or without a bias;
- a flax ``LayerNorm``'s ``scale`` and ``bias`` as they are;
- a nested module (the LSTM's ``OptimizedLSTMCell_0/{ii,...,ho}``,
  GTrXL's ``gate_attn_0/{wr,...,ug}``) by its path joined with dots, and
  a bare parameter of one (the gate's ``bz``) under its own name.

Flax flattens its last conv map in (H, W, C) order. The port's
``VisionNet`` flattens its NCHW map in that same (H, W, C) order, so
``post_fc_0``'s rows need no permutation: the kernel is only transposed.

Layer names pass through unchanged, except the flax ``DQNModel``'s
private ones (:data:`FLAX_RENAMES`): ``_convs_i`` → ``conv_i``,
``_fcs_i`` → ``fc_i``, ``_adv_head`` → ``adv_head``, ``_value_head`` →
``value_head``.

Models that are not flax modules (the transformer torso) keep a plain
nested dict with no ``"params"`` collection; the port's module keeps
their names and layouts, so such a tree maps leaf for leaf, its path
joined with dots (:func:`plain_to_state_dict`).

SAC's trees (``{"actor", "critic", "log_alpha"}`` params, the target
critic as aux state and three optax Adam states) go into a
``SACTorchPolicy`` whole through :func:`from_jax_sac_state`; CQL's add
the BC-warmup counter (:func:`from_jax_cql_state`), CRR's a target
actor and the sync counter (:func:`from_jax_crr_state`); MARWIL's and
BC's model, Adam state and squared-advantage normaliser go in through
:func:`from_jax_marwil_state`. DDPG's and
TD3's (``{"actor", "critic"}`` params; the target actor, target critic
and update ``step`` as aux state; two Adam states; the OU process's
carried state) into a ``DDPGTorchPolicy`` through
:func:`from_jax_ddpg_state`, and a DQN target network (the aux state's
``target_params``; a Rainbow model's noisy heads keep flax's ``w_mu``,
``w_sigma``, ``b_mu``, ``b_sigma``) through :func:`from_jax_dqn_target`. A reference
worker's multi-policy weights (``{pid: params}``) go into the port's
policy map through :func:`from_jax_policy_weights`. A reference
checkpoint's unpickled ``algorithm_state.pkl`` goes into a port
``Algorithm`` through :func:`from_jax_algorithm_state`, one of its policy
states into a port policy through :func:`from_jax_policy_state` (the
serving plane's restore and hot reload, which tell the two layouts
apart with :func:`is_jax_policy_state`), and one of its observation
filters through :func:`from_jax_filter`. A reference replay buffer's
``get_state()`` (a host ring, a host or device tree beside device rows,
spilled or not) becomes a state any port buffer restores through
:func:`from_jax_replay_state`; an Ape-X algorithm's learner and shards
(its DDPG form's through :func:`from_jax_ddpg_state`) go across through
:func:`from_jax_apex_state`. A reference stream snapshot (its
``CheckpointStreamer``'s payload) becomes the port's through
:func:`from_jax_stream_snapshot`. Curiosity's and RND's exploration
states (their nets, Adam states and RND's normaliser) become the port
strategies' through :func:`from_jax_exploration_state`. A reference
custom model's flax tree goes through :func:`from_jax_params` like any
other: its layers' names are the port model's. R2D2's online and target
LSTM Q nets and Adam state go in through :func:`from_jax_r2d2_state`;
RNNSAC's recurrent actor, twin Q nets, their target, ``log_alpha`` and
three Adam states through :func:`from_jax_rnnsac_state`; an ES or ARS
driver's theta, flat Adam and observation filter through
:func:`from_jax_es_state`; a linear bandit's precision and moment
through :func:`from_jax_bandit_state`. MADDPG's agent-stacked actors and
critics (kernels (n, in, out) → weights (n, out, in)), their targets and
two Adam states go into a port ``MADDPG`` through
:func:`from_jax_maddpg_state`; QMIX's agent net (flax's GRU names) and
mixer, target and Adam state into a ``QMIX`` through
:func:`from_jax_qmix_state`; SlateQ's item Q net and choice model, target
and ``multi_transform`` Adam states into a ``SlateQTorchPolicy`` through
:func:`from_jax_slateq_state`.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn


# (flax layer-name pattern, port layer name)
FLAX_RENAMES = (
    (re.compile(r"^_convs_(\d+)$"), r"conv_\1"),
    (re.compile(r"^_fcs_(\d+)$"), r"fc_\1"),
    (re.compile(r"^_adv_head$"), "adv_head"),
    (re.compile(r"^_value_head$"), "value_head"),
)


def port_layer_name(flax_name: str) -> str:
    for pattern, repl in FLAX_RENAMES:
        if pattern.match(flax_name):
            return pattern.sub(repl, flax_name)
    return flax_name


def _flax_module(name: str, leaves, out: Dict[str, np.ndarray]) -> None:
    if "kernel" in leaves:  # Dense or Conv
        kernel = np.asarray(leaves["kernel"])
        if kernel.ndim == 4:  # HWIO → OIHW
            out[f"{name}.weight"] = np.transpose(kernel, (3, 2, 0, 1))
        elif kernel.ndim == 2:  # (in, out) → (out, in)
            out[f"{name}.weight"] = kernel.T
        else:
            raise ValueError(f"{name}: unexpected kernel rank {kernel.ndim}")
        if "bias" in leaves:
            out[f"{name}.bias"] = np.asarray(leaves["bias"])
        return
    for key, value in leaves.items():
        if isinstance(value, Mapping):
            _flax_module(f"{name}.{key}", value, out)
        else:  # LayerNorm's scale and bias, a bare parameter
            out[f"{name}.{key}"] = np.asarray(value)


def flax_to_state_dict(tree) -> Dict[str, np.ndarray]:
    """Flax param tree → ``{"layer.weight" | "layer.bias" | ...: array}``
    in PyTorch layouts and the port's layer names."""
    params = tree.get("params", tree)
    out: Dict[str, np.ndarray] = {}
    for flax_layer, leaves in params.items():
        _flax_module(port_layer_name(flax_layer), leaves, out)
    return out


def plain_to_state_dict(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """A plain nested-dict param tree → ``{"a.b.leaf": array}``, layouts
    unchanged."""
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(plain_to_state_dict(value, name + "."))
        else:
            out[name] = np.asarray(value)
    return out


def to_state_dict(tree) -> Dict[str, np.ndarray]:
    """A flax tree (a ``"params"`` collection) through
    :func:`flax_to_state_dict`, any other nested dict through
    :func:`plain_to_state_dict`."""
    if "params" in tree:
        return flax_to_state_dict(tree)
    return plain_to_state_dict(tree)


def from_jax_params(tree, module: nn.Module) -> nn.Module:
    """Copy a reference param tree into ``module`` in place; every
    parameter of the module must be covered, with matching shapes."""
    sd = to_state_dict(tree)
    own = dict(module.named_parameters())
    if set(sd) != set(own):
        raise ValueError(
            "flax tree and module disagree: missing "
            f"{sorted(set(own) - set(sd))}, extra {sorted(set(sd) - set(own))}"
        )
    with torch.no_grad():
        for name, p in own.items():
            src = torch.tensor(np.asarray(sd[name]))
            if src.shape != p.shape:
                raise ValueError(f"{name}: {tuple(src.shape)} != {tuple(p.shape)}")
            p.copy_(src)
    return module


def from_jax_policy_weights(weights: Mapping, policy_map: Mapping) -> None:
    """Copy a reference worker's ``get_weights()`` (``{pid: param
    tree}`` of numpy arrays) into the models of the port's policy map
    (``{pid: TorchPolicy}``), policy by policy; both must name the same
    policies."""
    if set(weights) != set(policy_map):
        raise ValueError(
            f"reference policies {sorted(weights)} != port policies {sorted(policy_map)}"
        )
    for pid, tree in weights.items():
        from_jax_params(tree, policy_map[pid].model)


def _find_adam(opt_state):
    if all(hasattr(opt_state, a) for a in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _find_adam(s)
            if found is not None:
                return found
    return None


def from_jax_adam_state(opt_state) -> Tuple[int, Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """optax chain state (numpy leaves) → ``(count, mu, nu)`` with the
    moments keyed and laid out like :func:`to_state_dict`."""
    adam = _find_adam(opt_state)
    if adam is None:
        raise ValueError("no scale_by_adam state in the optax state")
    return (
        int(np.asarray(adam.count)),
        to_state_dict(adam.mu),
        to_state_dict(adam.nu),
    )


def from_jax_sac_state(policy, params, aux_state, opt_state):
    """Carry a reference SAC policy's state into ``policy`` (a
    ``SACTorchPolicy``) in place: the actor, both Q towers and
    ``log_alpha`` (``params``), the target critic (``aux_state``; None
    leaves the policy's target as it is, as the reference's restore
    does, whose checkpoint has no aux state) and the critic's, actor's
    and ``log_alpha``'s Adam states (``opt_state``: count, mu, nu).
    Returns ``policy``."""
    weights = {}
    for group in ("actor", "critic"):
        weights.update({f"{group}.{k}": v for k, v in to_state_dict(params[group]).items()})
    weights["log_alpha"] = np.asarray(params["log_alpha"])
    if set(weights) != set(policy.param_names):
        raise ValueError(
            f"SAC trees and policy disagree: {sorted(set(weights) ^ set(policy.param_names))}"
        )
    policy.set_weights(weights)
    with torch.no_grad():
        if aux_state is not None:
            target = to_state_dict(aux_state["target_critic"])
            for name, t in zip(policy.critic_names, policy.aux_state["target_critic"]):
                t.copy_(torch.as_tensor(np.asarray(target[name])))
        for group, st in policy.opt_states.items():
            adam = _find_adam(opt_state[group])
            if adam is None:
                raise ValueError(f"no scale_by_adam state for {group!r}")
            st.count = int(np.asarray(adam.count))
            if group == "log_alpha":
                mu, nu = {"log_alpha": adam.mu}, {"log_alpha": adam.nu}
            else:
                mu = {f"{group}.{k}": v for k, v in to_state_dict(adam.mu).items()}
                nu = {f"{group}.{k}": v for k, v in to_state_dict(adam.nu).items()}
            for i, name in enumerate(policy.group_param_names(group)):
                st.mu[i].copy_(torch.as_tensor(np.asarray(mu[name])))
                st.nu[i].copy_(torch.as_tensor(np.asarray(nu[name])))
    return policy


def _load_adam(policy, opt_state) -> None:
    """An optax chain's Adam state into the policy's one Adam state."""
    count, mu, nu = from_jax_adam_state(opt_state)
    st = policy.opt_state
    with torch.no_grad():
        st.count = count
        for i, name in enumerate(policy.param_names):
            st.mu[i].copy_(torch.as_tensor(np.asarray(mu[name])))
            st.nu[i].copy_(torch.as_tensor(np.asarray(nu[name])))


def from_jax_cql_state(policy, params, aux_state, opt_state):
    """A reference CQL policy's state into ``policy`` (a ``CQLTorchPolicy``)
    in place: SAC's part through :func:`from_jax_sac_state`, and the
    update counter that switches off the BC warmup (``aux_state["step"]``).
    Returns ``policy``."""
    from_jax_sac_state(policy, params, aux_state, opt_state)
    if aux_state is not None:
        policy.aux_state["step"].fill_(int(np.asarray(aux_state["step"])))
    return policy


def from_jax_crr_state(policy, params, aux_state, opt_state):
    """A reference CRR policy's state into ``policy`` (a ``CRRTorchPolicy``)
    in place: the nets and ``log_alpha`` (``params``), the target actor,
    the target critic and the update counter that times the hard sync
    (``aux_state``), and the critic's, actor's and ``log_alpha``'s Adam
    states (``opt_state``; ``log_alpha``'s is never stepped). Returns
    ``policy``."""
    from_jax_sac_state(policy, params, None, opt_state)
    with torch.no_grad():
        if aux_state is not None:
            for key, names in (("target_actor", policy.actor_names),
                               ("target_critic", policy.critic_names)):
                target = to_state_dict(aux_state[key])
                for name, t in zip(names, policy.aux_state[key]):
                    t.copy_(torch.as_tensor(np.asarray(target[name])))
            policy.aux_state["step"].fill_(int(np.asarray(aux_state["step"])))
    return policy


def from_jax_marwil_state(policy, params, opt_state=None, coeff_values=None):
    """A reference MARWIL or BC policy's state into ``policy`` (a
    ``MARWILTorchPolicy``) in place: the model (``params``), the Adam
    state (``opt_state``) and the moving-average squared-advantage
    normaliser (``coeff_values["ma_sqd_adv_norm"]``, the reference
    policy's ``coeff_values``). None leaves a part as it is. Returns
    ``policy``."""
    from_jax_params(params, policy.model)
    if opt_state is not None:
        _load_adam(policy, opt_state)
    if coeff_values is not None and "ma_sqd_adv_norm" in coeff_values:
        policy.coeff_values["ma_sqd_adv_norm"] = float(coeff_values["ma_sqd_adv_norm"])
    return policy


def _copy_group_adam(st, opt_state, names, prefix: str) -> None:
    adam = _find_adam(opt_state)
    if adam is None:
        raise ValueError(f"no scale_by_adam state for {prefix!r}")
    st.count = int(np.asarray(adam.count))
    mu = {f"{prefix}.{k}": v for k, v in to_state_dict(adam.mu).items()}
    nu = {f"{prefix}.{k}": v for k, v in to_state_dict(adam.nu).items()}
    for i, name in enumerate(names):
        st.mu[i].copy_(torch.as_tensor(np.asarray(mu[name])))
        st.nu[i].copy_(torch.as_tensor(np.asarray(nu[name])))


def from_jax_ddpg_state(policy, params, aux_state=None, opt_state=None, expl_state=None):
    """Carry a reference DDPG or TD3 policy's state into ``policy`` (a
    ``DDPGTorchPolicy``) in place: the actor and critic (``params``),
    the target actor, target critic and update ``step`` (``aux_state``),
    the critic's and actor's Adam states (``opt_state``; the actor's
    count is its own, since TD3 skips actor steps) and the OU process's
    carried ``x`` (``expl_state``, the reference policy's
    ``_expl_state``). None leaves a part as it is. Returns ``policy``."""
    weights = {}
    for group in ("actor", "critic"):
        weights.update({f"{group}.{k}": v for k, v in to_state_dict(params[group]).items()})
    if set(weights) != set(policy.param_names):
        raise ValueError(
            f"DDPG trees and policy disagree: {sorted(set(weights) ^ set(policy.param_names))}"
        )
    policy.set_weights(weights)
    with torch.no_grad():
        if aux_state is not None:
            for key, names in (("target_actor", policy.actor_names),
                               ("target_critic", policy.critic_names)):
                target = to_state_dict(aux_state[key])
                for name, t in zip(names, policy.aux_state[key]):
                    t.copy_(torch.as_tensor(np.asarray(target[name])))
            step = int(np.asarray(aux_state["step"]))
            policy.aux_state["step"].fill_(step)
            policy.num_updates = step
        if opt_state is not None:
            for group, st in policy.opt_states.items():
                _copy_group_adam(st, opt_state[group], policy.group_param_names(group), group)
    if expl_state is not None:
        policy._expl_state = tuple(torch.as_tensor(np.asarray(x), device=policy.device)
                                   for x in expl_state)
        policy._expl_state_batch = int(np.asarray(expl_state[0]).shape[0]) if expl_state else -1
    return policy


def from_jax_dqn_target(policy, aux_state):
    """A reference DQN policy's target network (``aux_state
    ["target_params"]``, a param tree like the online one) into the
    port policy's target, in place. Returns ``policy``."""
    sd = to_state_dict(aux_state["target_params"])
    if set(sd) != set(policy.param_names):
        raise ValueError(f"target tree and policy disagree: {sorted(set(sd) ^ set(policy.param_names))}")
    with torch.no_grad():
        for name, t in zip(policy.param_names, policy.aux_state["target_params"]):
            t.copy_(torch.as_tensor(np.asarray(sd[name])))
    return policy


def from_jax_filter(ref_filter):
    """A reference observation filter (``NoFilter`` or ``MeanStdFilter``,
    duck-typed) as the port's, with the same statistics."""
    from ray_tpu_torch.utils.filter import MeanStdFilter, NoFilter, RunningStat

    if not hasattr(ref_filter, "rs"):
        return NoFilter()
    out = MeanStdFilter(ref_filter.shape, ref_filter.demean, ref_filter.destd, ref_filter.clip)
    for name in ("rs", "buffer"):
        src, dst = getattr(ref_filter, name), RunningStat()
        dst.num = int(src.num)
        dst.mean_ = np.array(src.mean_, np.float64)
        dst.s = np.array(src.s, np.float64)
        setattr(out, name, dst)
    return out


def is_jax_policy_state(state: Mapping) -> bool:
    """Whether a policy state holds the reference's nested param trees
    (the port's weights are a flat ``{"layer.weight": array}``)."""
    weights = state.get("weights") if isinstance(state, Mapping) else None
    return isinstance(weights, Mapping) and any(
        isinstance(v, Mapping) for v in weights.values()
    )


def from_jax_policy_state(policy, ps: Mapping):
    """One reference policy state (a ``get_state()`` of numpy trees)
    into the port ``policy`` in place: the params (``from_jax_params``;
    SAC's through ``from_jax_sac_state``), the optax Adam state
    (``from_jax_adam_state``), ``coeff_values``, ``global_timestep``,
    ``num_grad_updates`` and ``exploration_state``. Returns ``policy``."""
    if hasattr(policy, "actor_names"):  # DDPG's and TD3's two optimizers, targets, step
        from_jax_ddpg_state(policy, ps["weights"], ps.get("aux_state"), ps["opt_state"])
    elif hasattr(policy, "opt_states"):  # SAC's three optimizers
        from_jax_sac_state(policy, ps["weights"], None, ps["opt_state"])
    else:
        from_jax_params(ps["weights"], policy.model)
        _load_adam(policy, ps["opt_state"])
    policy.coeff_values.update({k: float(v) for k, v in ps.get("coeff_values", {}).items()})
    policy.global_timestep = int(ps.get("global_timestep", 0))
    policy.num_grad_updates = int(ps.get("num_grad_updates", 0))
    policy.exploration.set_state(from_jax_exploration_state(ps.get("exploration_state", {})))
    return policy


# the ICM's nets by the reference's keys: its forward model is the
# port's ``forward_net`` (an nn.Module's ``forward`` is its call)
_ICM_NETS = {"phi": "phi", "inverse": "inverse", "forward": "forward_net"}


def _icm_state_dict(tree: Mapping) -> Dict[str, np.ndarray]:
    out = {}
    for ref_key, port_key in _ICM_NETS.items():
        for name, value in flax_to_state_dict(tree[ref_key]).items():
            out[f"{port_key}.{name}"] = value
    return out


def _adam_dict(opt_state, to_sd) -> Dict:
    adam = _find_adam(opt_state)
    if adam is None:
        raise ValueError("no scale_by_adam state in the optax state")
    return {"count": int(np.asarray(adam.count)), "mu": to_sd(adam.mu), "nu": to_sd(adam.nu)}


def from_jax_exploration_state(state: Mapping) -> Dict:
    """A reference exploration's ``get_state()`` (numpy trees) as the
    port strategy's: Curiosity's ICM (``params``: phi, inverse and
    forward flax trees; their optax Adam state) and RND's target and
    predictor trees, the predictor's Adam state and the reward
    normaliser (``norm``: count, mean, M2). A state that is neither (the
    other strategies', or already the port's) passes through as it is."""
    state = dict(state or {})
    if isinstance(state.get("params"), Mapping) and "phi" in state["params"]:
        return {"params": _icm_state_dict(state["params"]),
                "opt_state": _adam_dict(state["opt_state"], _icm_state_dict)}
    if isinstance(state.get("target_params"), Mapping) and "params" in state["target_params"]:
        return {
            "target_params": flax_to_state_dict(state["target_params"]),
            "predictor_params": flax_to_state_dict(state["predictor_params"]),
            "opt_state": _adam_dict(state["opt_state"], flax_to_state_dict),
            "norm": tuple(float(v) for v in state["norm"]),
        }
    return state


def from_jax_algorithm_state(algo, state: Mapping):
    """Load the unpickled ``algorithm_state.pkl`` of a reference
    checkpoint (numpy trees) into the port ``Algorithm`` ``algo`` built
    for the same config, in place, and send the weights to its remote
    workers: each policy of ``state["worker"]["policy_states"]`` through
    :func:`from_jax_policy_state`. The reference's state has no aux
    state for DQN and SAC: their targets stay as they are, as the
    reference's restore leaves them; DDPG's and TD3's carry theirs. A
    replay buffer in the state is not loaded. Then the filters (:func:`from_jax_filter`), the
    counters and the episode total. Returns ``algo``."""
    worker = state["worker"]
    for pid, ps in worker["policy_states"].items():
        from_jax_policy_state(algo.get_policy(pid), ps)
    if algo.workers is not None:
        local = algo.workers.local_worker()
        local.sync_filters({pid: from_jax_filter(f) for pid, f in worker.get("filters", {}).items()})
        algo.workers.sync_weights()
    algo._counters.clear()
    algo._counters.update({k: int(v) for k, v in state.get("counters", {}).items()})
    algo._episodes_total = int(state.get("episodes_total", 0))
    return algo


def from_jax_replay_state(state: Mapping) -> Dict:
    """A reference replay buffer's ``get_state()`` (numpy or jax arrays)
    as host numpy in the same layout, ``cols``, ring position, size,
    count, ``spilled`` and the priorities' leaf values (f64) and max
    priority, which every port buffer's ``set_state`` takes, whatever
    plane wrote it."""
    out = {
        "cols": {k: np.array(v) for k, v in state["cols"].items()},
        "idx": int(state["idx"]),
        "size": int(state["size"]),
        "num_added": int(state["num_added"]),
        "spilled": bool(state.get("spilled", False)),
    }
    if "priorities" in state:
        pri = state["priorities"]
        out["priorities"] = {
            "leaf_values": np.array(pri["leaf_values"], np.float64),
            "max_priority": float(pri.get("max_priority", 1.0)),
        }
    return out


def from_jax_apex_state(algo, policy_state: Mapping, shard_states=(), counters=None):
    """A reference Ape-X run into the port ``ApexDQN`` or ``ApexDDPG``
    ``algo`` built for the same config, in place: the learner's policy
    state (:func:`from_jax_policy_state`; DDPG's trees, targets, update
    step and two Adam states through :func:`from_jax_ddpg_state`), each
    device shard's ``get_state()`` (:func:`from_jax_replay_state`), and
    the counters. Returns ``algo``."""
    from_jax_policy_state(algo.get_policy(), policy_state)
    for shard, st in zip(algo.replay_shards, shard_states):
        shard.set_state(from_jax_replay_state(st))
    if counters is not None:
        algo._counters.clear()
        algo._counters.update({k: int(v) for k, v in counters.items()})
    if algo.workers is not None:
        algo.workers.sync_weights()
    return algo


def from_jax_stream_snapshot(payload: Mapping, algo=None) -> Dict:
    """A reference stream snapshot (``ray_tpu/resilience/streamer.py``'s
    payload: ``policy_states`` of flax weights and optax Adam state,
    counters, filters, superstep, iteration) as the port's payload, which
    ``resilience/streamer.load_payload`` loads. Each policy state: the
    weights through :func:`to_state_dict`, the Adam state through
    :func:`from_jax_adam_state` (the one-optimizer layout of PPO, IMPALA,
    APPO and DQN); with ``algo``, each goes through
    :func:`from_jax_policy_state` into ``algo``'s policy of that id (every
    layout it takes, SAC's and DDPG's too) and the port state is that
    policy's ``get_state()``. The filters through :func:`from_jax_filter`."""
    states = {}
    for pid, ps in payload.get("policy_states", {}).items():
        if algo is not None:
            states[pid] = from_jax_policy_state(algo.get_policy(pid), ps).get_state()
            continue
        count, mu, nu = from_jax_adam_state(ps["opt_state"])
        states[pid] = {
            "weights": to_state_dict(ps["weights"]),
            "opt_state": {"count": count, "mu": mu, "nu": nu},
            "coeff_values": {k: float(v) for k, v in ps.get("coeff_values", {}).items()},
            "global_timestep": int(ps.get("global_timestep", 0)),
            "num_grad_updates": int(ps.get("num_grad_updates", 0)),
            "exploration_state": ps.get("exploration_state", {}),
        }
    return {
        "superstep": int(payload.get("superstep", 0)),
        "iteration": int(payload.get("iteration", 0)),
        "counters": {k: int(v) for k, v in payload.get("counters", {}).items()},
        "episodes_total": int(payload.get("episodes_total", 0)),
        "policy_states": states,
        "filters": {pid: from_jax_filter(f) for pid, f in payload.get("filters", {}).items()},
    }


def from_jax_r2d2_state(policy, params, aux_state=None, opt_state=None):
    """A reference R2D2 policy's state into ``policy`` (an
    ``R2D2TorchPolicy``) in place: the online LSTM Q net (``params``),
    its target (``aux_state["target_params"]``) and the Adam state
    (``opt_state``). None leaves a part as it is. Returns ``policy``."""
    from_jax_params(params, policy.model)
    if aux_state is not None:
        from_jax_dqn_target(policy, aux_state)
    if opt_state is not None:
        _load_adam(policy, opt_state)
    return policy


def from_jax_rnnsac_state(policy, params, aux_state=None, opt_state=None):
    """A reference RNNSAC policy's state into ``policy`` (an
    ``RNNSACTorchPolicy``) in place: the recurrent actor, the twin Q
    nets and ``log_alpha`` (``params``), the target critic
    (``aux_state``) and the three Adam states (``opt_state``). The
    port's nets keep the flax names (the actor's ``_fcs_i`` as ``fc_i``),
    so SAC's loader carries them. Returns ``policy``."""
    return from_jax_sac_state(policy, params, aux_state, opt_state)


def from_jax_es_state(algo, es_state: Mapping):
    """A reference ES or ARS driver's ``__getstate__()["es"]`` (``theta``,
    the ``_FlatAdam``'s ``__dict__``, the observation filter) into the
    port ``algo`` in place: theta (the same ravel order, so the same
    weights) into the policy on the card too. Returns ``algo``."""
    algo._theta = np.array(es_state["theta"], np.float32)
    opt = dict(es_state.get("optimizer") or {})
    for key in ("m", "v"):
        if key in opt:
            opt[key] = np.array(opt[key], np.float32)
    algo._optimizer.__dict__.update(opt)
    if es_state.get("filter") is not None:
        algo._filter.sync(from_jax_filter(es_state["filter"]))
    algo.get_policy().set_flat_weights(algo._theta)
    return algo


def from_jax_bandit_state(policy, weights: Mapping):
    """A reference linear bandit policy's ``get_weights()`` (precision
    (A, d, d), moment (A, d)) into the port ``policy``. Returns
    ``policy``."""
    policy.set_weights({k: np.asarray(weights[k]) for k in ("precision", "moment")})
    return policy


def _stacked_to_state_dict(tree) -> Dict[str, np.ndarray]:
    """A reference tree of agent-stacked flax Dense layers (kernels (n,
    in, out), biases (n, out): MADDPG's ``vmap``ped init) → ``{"layer.weight":
    (n, out, in), "layer.bias": (n, out)}``."""
    out = {}
    for layer, leaves in tree.get("params", tree).items():
        out[f"{layer}.weight"] = np.transpose(np.asarray(leaves["kernel"]), (0, 2, 1))
        out[f"{layer}.bias"] = np.asarray(leaves["bias"])
    return out


def _copy_named(tensors, names, values: Mapping) -> None:
    with torch.no_grad():
        for t, n in zip(tensors, names):
            src = torch.as_tensor(np.array(values[n]))
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{n}: {tuple(src.shape)} != {tuple(t.shape)}")
            t.copy_(src)


def from_jax_maddpg_state(algo, params, target_params=None, opt_state=None):
    """A reference MADDPG's state into the port ``algo`` (a ``MADDPG``) in
    place: the agent-stacked actors and critics (``params``, ``{"actor",
    "critic"}``), their targets (``target_params``) and the actors' and
    critics' Adam states (``opt_state``). None leaves a part as it is.
    Returns ``algo``."""
    for group in ("actor", "critic"):
        names = algo.group_param_names(group)
        sd = _stacked_to_state_dict(params[group])
        if set(sd) != set(names):
            raise ValueError(f"MADDPG {group}: {sorted(set(sd) ^ set(names))}")
        _copy_named(algo._group(group), names, sd)
        if target_params is not None:
            _copy_named(algo.target[group], names, _stacked_to_state_dict(target_params[group]))
        if opt_state is not None:
            adam = _find_adam(opt_state[group])
            st = algo.opt_states[group]
            st.count = int(np.asarray(adam.count))
            _copy_named(st.mu, names, _stacked_to_state_dict(adam.mu))
            _copy_named(st.nu, names, _stacked_to_state_dict(adam.nu))
    return algo


def _qmix_state_dict(tree) -> Dict[str, np.ndarray]:
    """QMIX's ``{"agent": flax tree, "mixer": flax tree}`` → the port
    model's names (``agent.gru.ir.weight``, ``mixer.hyper_w1.bias``, ...)."""
    return {f"{part}.{k}": v for part in ("agent", "mixer")
            for k, v in flax_to_state_dict(tree[part]).items()}


def from_jax_qmix_state(algo, params, target_params=None, opt_state=None):
    """A reference QMIX's state into the port ``algo`` (a ``QMIX``) in
    place: the agent net (flax's GRU names) and the mixer (``params``),
    their target (``target_params``) and the one Adam state
    (``opt_state``). None leaves a part as it is. Returns ``algo``."""
    sd = _qmix_state_dict(params)
    if set(sd) != set(algo.param_names):
        raise ValueError(f"QMIX trees and model disagree: {sorted(set(sd) ^ set(algo.param_names))}")
    _copy_named(algo.params, algo.param_names, sd)
    if target_params is not None:
        _copy_named(algo.target, algo.param_names, _qmix_state_dict(target_params))
    if opt_state is not None:
        adam = _find_adam(opt_state)
        st = algo.opt_state
        st.count = int(np.asarray(adam.count))
        _copy_named(st.mu, algo.param_names, _qmix_state_dict(adam.mu))
        _copy_named(st.nu, algo.param_names, _qmix_state_dict(adam.nu))
    return algo


def _slateq_group(tree, group: str) -> Dict[str, np.ndarray]:
    """One group of SlateQ's ``{"q", "choice"}`` params under the port's
    names: the item Q net's flax layers, the choice model's two scalars."""
    if group == "q":
        return {f"q.{k}": v for k, v in flax_to_state_dict(tree).items()}
    leaves = tree.get("params", tree)
    return {f"choice.{k}": np.asarray(leaves[k]) for k in ("beta", "score_no_click")}


def from_jax_slateq_state(policy, params, aux_state=None, opt_state=None):
    """A reference SlateQ policy's state into ``policy`` (a
    ``SlateQTorchPolicy``) in place: the item Q net and the choice model
    (``params``, ``{"q", "choice"}``), the target Q net
    (``aux_state["target_params"]``) and the two Adam states of optax's
    ``multi_transform`` (``opt_state``: one ``scale_by_adam`` a group,
    its moments under the group's own key). None leaves a part as it is.
    Returns ``policy``."""
    weights = {k: np.array(v) for k, v in {**_slateq_group(params["q"], "q"),
                                           **_slateq_group(params["choice"], "choice")}.items()}
    if set(weights) != set(policy.param_names):
        raise ValueError(
            f"SlateQ trees and policy disagree: {sorted(set(weights) ^ set(policy.param_names))}"
        )
    policy.set_weights(weights)
    if aux_state is not None:
        _copy_named(policy.aux_state["target_params"], policy.group_param_names("q"),
                    _slateq_group(aux_state["target_params"], "q"))
    if opt_state is not None:
        for group, st in policy.opt_states.items():
            inner = opt_state.inner_states[group]
            adam = _find_adam(getattr(inner, "inner_state", inner))
            if adam is None:
                raise ValueError(f"no scale_by_adam state for {group!r}")
            st.count = int(np.asarray(adam.count))
            names = policy.group_param_names(group)
            _copy_named(st.mu, names, _slateq_group(adam.mu[group], group))
            _copy_named(st.nu, names, _slateq_group(adam.nu[group], group))
    return policy
