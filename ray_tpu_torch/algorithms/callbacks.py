"""User callback hooks into the sampling and training loop.

Copy of ``ray_tpu/algorithms/callbacks.py``: subclass
:class:`DefaultCallbacks`, override the hooks you need and pass the
class as ``config["callbacks_class"]`` (``config.callbacks(cls)``).
Every hook takes keyword arguments only (accept ``**kwargs``). The
episode a hook gets has ``user_data`` (scratch space for the episode),
``custom_metrics`` (scalars that the result aggregates as
``custom_metrics/<name>_mean|min|max``) and ``last_info`` (the env's
info of the step). The episode hooks and ``on_sample_end`` run in the
actor lane's ``SyncSampler``, on whichever worker samples;
``on_train_result`` runs at the end of ``Algorithm.train()`` on both
lanes (the device lane has no episode hooks, as the reference's).
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class DefaultCallbacks:
    """Every hook a no-op."""

    def on_episode_start(self, *, worker=None, base_env=None, policies=None,
                         episode=None, env_index: Optional[int] = None, **kwargs) -> None:
        pass

    def on_episode_step(self, *, worker=None, base_env=None, policies=None,
                        episode=None, env_index: Optional[int] = None, **kwargs) -> None:
        pass

    def on_episode_end(self, *, worker=None, base_env=None, policies=None,
                       episode=None, env_index: Optional[int] = None, **kwargs) -> None:
        pass

    def on_sample_end(self, *, worker=None, samples=None, **kwargs) -> None:
        pass

    def on_postprocess_trajectory(self, *, worker=None, episode=None, agent_id=None,
                                  policy_id=None, policies=None, postprocessed_batch=None,
                                  original_batches=None, **kwargs) -> None:
        pass

    def on_train_result(self, *, algorithm=None, result: Optional[Dict] = None, **kwargs) -> None:
        pass


class MultiCallbacks(DefaultCallbacks):
    """One hook call fanned out to several callback objects, in order."""

    def __init__(self, callbacks_classes):
        self._callbacks = [c() for c in callbacks_classes]

    def __getattribute__(self, name: str) -> Any:
        if name.startswith("on_"):
            cbs = object.__getattribute__(self, "_callbacks")

            def fan_out(**kwargs):
                for cb in cbs:
                    getattr(cb, name)(**kwargs)

            return fan_out
        return object.__getattribute__(self, name)
