"""Several ranks: meshes of process groups, their bring-up, the
device-plane collectives and sequence-parallel ring attention.

Counterpart of ``ray_tpu/parallel/`` (``mesh.py``, ``distributed.py``,
``collectives.py``, ``ring_attention.py``) and of the mesh helpers of
``ray_tpu/sharding/mesh.py``. See each module for its transport rules.
"""
