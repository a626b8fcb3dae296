"""EnvContext: an env config dict plus where the env runs.

Copy of ``ray_tpu/env/env_context.py``: the env config a creator gets,
with the worker index, the worker count and the env's slot in its
worker's vector env.
"""

from __future__ import annotations


class EnvContext(dict):
    def __init__(
        self,
        env_config: dict | None = None,
        worker_index: int = 0,
        num_workers: int = 0,
        vector_index: int = 0,
        remote: bool = False,
    ):
        super().__init__(env_config or {})
        self.worker_index = worker_index
        self.num_workers = num_workers
        self.vector_index = vector_index
        self.remote = remote

    def copy_with_overrides(
        self,
        env_config: dict | None = None,
        worker_index: int | None = None,
        num_workers: int | None = None,
        vector_index: int | None = None,
    ) -> "EnvContext":
        return EnvContext(
            env_config if env_config is not None else dict(self),
            worker_index if worker_index is not None else self.worker_index,
            num_workers if num_workers is not None else self.num_workers,
            vector_index if vector_index is not None else self.vector_index,
        )
