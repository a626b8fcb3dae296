"""BaseEnv: the poll/send interface of asynchronous and external envs.

Copy of ``ray_tpu/env/base_env.py``. ``poll()`` returns whatever
observations are ready as ``{env_id: {agent_id: value}}`` dicts
(observations, rewards, terminateds, truncateds, infos; the terminated
and truncated dicts carry ``"__all__"``), and ``send_actions()`` pushes
the actions of those env ids. :func:`convert_to_base_env` wraps a
``VectorEnv``, a ``MultiAgentEnv`` or a plain env (vectorized through
``make_env``). A finished episode resets at once: the reset observation
is the next poll's, and the terminal observation rides in that agent's
info dict under ``__terminal_obs__``. Single-agent envs report under the
agent id ``agent0``. The samplers drive ``VectorEnv`` directly; this is
the surface for envs whose observations arrive on their own schedule.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

from ray_tpu_torch.env.multi_agent_env import MultiAgentEnv
from ray_tpu_torch.env.vector_env import VectorEnv

_DUMMY_AGENT_ID = "agent0"


class BaseEnv:
    """The poll/send contract; ``dones[env_id]["__all__"]`` marks the end
    of a sub-env's episode."""

    def poll(self) -> Tuple[Dict, Dict, Dict, Dict, Dict]:
        """(obs, rewards, terminateds, truncateds, infos) of every sub-env
        with data ready."""
        raise NotImplementedError

    def send_actions(self, action_dict: Dict[Any, Dict]) -> None:
        """The actions of the env ids the last poll returned."""
        raise NotImplementedError

    def try_reset(self, env_id) -> Optional[Dict]:
        """Reset one sub-env now: its first obs dict (None when
        unsupported)."""
        return None

    def get_sub_environments(self):
        return []

    def stop(self) -> None:
        for e in self.get_sub_environments():
            close = getattr(e, "close", None)
            if close is not None:
                close()


def _check_turn(wrapper, polling: bool) -> None:
    if polling and wrapper._awaiting_actions:
        raise RuntimeError("poll() called twice without send_actions()")
    if not polling and not wrapper._awaiting_actions:
        raise RuntimeError("send_actions() without a poll()")
    wrapper._awaiting_actions = polling


class _VectorEnvToBaseEnv(BaseEnv):
    """A synchronous VectorEnv behind the poll/send contract: every poll
    has every sub-env ready."""

    def __init__(self, vector_env: VectorEnv):
        self.vector_env = vector_env
        obs, infos = vector_env.vector_reset()
        self._pending = {i: (obs[i], 0.0, False, False, infos[i])
                         for i in range(vector_env.num_envs)}
        self._awaiting_actions = False

    def poll(self):
        _check_turn(self, True)
        obs, rewards, terms, truncs, infos = {}, {}, {}, {}, {}
        for i, (o, r, te, tr, info) in self._pending.items():
            obs[i] = {_DUMMY_AGENT_ID: o}
            rewards[i] = {_DUMMY_AGENT_ID: r}
            terms[i] = {_DUMMY_AGENT_ID: te, "__all__": te}
            truncs[i] = {_DUMMY_AGENT_ID: tr, "__all__": tr}
            infos[i] = {_DUMMY_AGENT_ID: info}
        return obs, rewards, terms, truncs, infos

    def send_actions(self, action_dict: Dict[Any, Dict]) -> None:
        _check_turn(self, False)
        n = self.vector_env.num_envs
        actions = [action_dict[i][_DUMMY_AGENT_ID] for i in range(n)]
        obs, rewards, terms, truncs, infos = self.vector_env.vector_step(actions)
        pending = {}
        for i in range(n):
            info = dict(infos[i] or {})
            o = obs[i]
            if bool(terms[i]) or bool(truncs[i]):
                info["__terminal_obs__"] = o
                o, _ = self.vector_env.reset_at(i)
            pending[i] = (o, float(rewards[i]), bool(terms[i]), bool(truncs[i]), info)
        self._pending = pending

    def try_reset(self, env_id) -> Optional[Dict]:
        o, _ = self.vector_env.reset_at(env_id)
        self._pending[env_id] = (o, 0.0, False, False, {})
        return {_DUMMY_AGENT_ID: o}

    def get_sub_environments(self):
        return self.vector_env.get_sub_environments()


class _MultiAgentEnvToBaseEnv(BaseEnv):
    """MultiAgentEnvs behind the poll/send contract: the per-agent dicts
    pass through, and ``"__all__"`` drives the reset."""

    def __init__(self, make_env: Callable[[int], MultiAgentEnv], num_envs: int):
        self.envs = [make_env(i) for i in range(num_envs)]
        self._pending = {}
        for i, e in enumerate(self.envs):
            obs, infos = e.reset()
            flags = {aid: False for aid in obs}
            flags["__all__"] = False
            self._pending[i] = (obs, {aid: 0.0 for aid in obs}, dict(flags), dict(flags), infos)
        self._awaiting_actions = False

    def poll(self):
        _check_turn(self, True)
        obs, rewards, terms, truncs, infos = {}, {}, {}, {}, {}
        for i, (o, r, te, tr, info) in self._pending.items():
            obs[i], rewards[i] = o, r
            terms[i], truncs[i], infos[i] = te, tr, info
        return obs, rewards, terms, truncs, infos

    def send_actions(self, action_dict: Dict[Any, Dict]) -> None:
        _check_turn(self, False)
        pending = {}
        for i, env in enumerate(self.envs):
            obs, rewards, terms, truncs, infos = env.step(action_dict[i])
            if bool(terms.get("__all__")) or bool(truncs.get("__all__")):
                infos = {aid: {**(infos.get(aid) or {}), "__terminal_obs__": obs.get(aid)}
                         for aid in obs}
                obs, _ = env.reset()
            pending[i] = (obs, rewards, terms, truncs, infos)
        self._pending = pending

    def get_sub_environments(self):
        return list(self.envs)


def convert_to_base_env(env, *, make_env: Optional[Callable[[int], Any]] = None,
                        num_envs: int = 1) -> BaseEnv:
    """Any supported env as a BaseEnv: a BaseEnv as it is; a VectorEnv or
    a MultiAgentEnv wrapped; a plain env vectorized to ``num_envs``
    copies through ``make_env`` (the env itself when ``num_envs`` is 1)."""
    if isinstance(env, BaseEnv):
        return env
    if isinstance(env, VectorEnv):
        return _VectorEnvToBaseEnv(env)
    if isinstance(env, MultiAgentEnv):
        if make_env is None and num_envs > 1:
            raise ValueError("vectorizing a MultiAgentEnv needs make_env")
        return _MultiAgentEnvToBaseEnv(make_env or (lambda i: env), num_envs)
    if make_env is None:
        if num_envs > 1:
            raise ValueError("vectorizing a gym env needs make_env")
        make_env = lambda i: env  # noqa: E731
    return _VectorEnvToBaseEnv(VectorEnv.vectorize_gym_envs(make_env, num_envs))
