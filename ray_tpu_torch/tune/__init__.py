"""The port's ``tune`` package: for now only :class:`Trainable`, the
save and restore protocol that ``Algorithm`` derives from (the rest of
``ray_tpu/tune`` is ``ROADMAP.md`` queue 1 item 9)."""
