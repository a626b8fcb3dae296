"""The elastic rollout fleet (``fleet.py``: ``FleetController``).

Counterpart of ``ray_tpu/autoscaler``, cut to the fleet controller the
training loop runs; the node autoscaler and its providers are
``ROADMAP.md`` queue 1 item 9."""

from ray_tpu_torch.autoscaler.fleet import FleetController  # noqa: F401

__all__ = ["FleetController"]
