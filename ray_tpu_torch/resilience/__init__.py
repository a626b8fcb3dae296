"""The two resilience modules the serving plane reads: checkpoint
discovery (``discovery.py``) and the provider preemption notice
(``provider_notice.py``). The rest of the reference's
``ray_tpu/resilience`` (the checkpoint streamer, recovery, fault
injection) is ROADMAP queue 1 item 3d."""
