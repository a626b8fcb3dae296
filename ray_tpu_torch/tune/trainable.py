"""Trainable: the checkpoint protocol of a training loop.

Counterpart of ``ray_tpu/tune/trainable.py:18-113``. ``save()`` writes a
checkpoint directory (by default ``<logdir>/checkpoint_{iteration:06d}``)
through the subclass's ``save_checkpoint`` and then ``.tune_metadata``
(iteration, timesteps and training time), atomically; ``restore(path)``
takes a checkpoint directory or a file in it, reads ``.tune_metadata``
when it is there and hands the path to ``load_checkpoint``. ``logdir``
is a fresh temporary directory, made on first use.

The PBT exploit protocol (``get_exploit_state`` / ``apply_exploit``,
reference ``:118-152``) is not ported: it raises, naming ``ROADMAP.md``
queue 1 item 9 (``tune/``).
"""

from __future__ import annotations

import os
import pickle
import tempfile
from typing import Optional

from ray_tpu_torch.util.atomic_io import atomic_write

_PBT_ITEM = "ROADMAP.md queue 1 item 9"


class Trainable:
    def __init__(self):
        self._iteration = 0
        self._timesteps_total = 0
        self._time_total = 0.0
        self._logdir: Optional[str] = None

    # -- the subclass's part -----------------------------------------------

    def save_checkpoint(self, checkpoint_dir: str) -> str:
        raise NotImplementedError

    def load_checkpoint(self, checkpoint_path: str) -> None:
        raise NotImplementedError

    # -- the caller's part -------------------------------------------------

    @property
    def iteration(self) -> int:
        return self._iteration

    @property
    def logdir(self) -> str:
        if self._logdir is None:
            self._logdir = tempfile.mkdtemp(prefix="ray_tpu_torch_trainable_")
        return self._logdir

    def save(self, checkpoint_dir: Optional[str] = None) -> str:
        """Write a checkpoint; returns its directory."""
        checkpoint_dir = checkpoint_dir or os.path.join(
            self.logdir, f"checkpoint_{self._iteration:06d}"
        )
        os.makedirs(checkpoint_dir, exist_ok=True)
        path = self.save_checkpoint(checkpoint_dir)
        meta = {
            "iteration": self._iteration,
            "timesteps_total": self._timesteps_total,
            "time_total": self._time_total,
        }
        atomic_write(os.path.join(checkpoint_dir, ".tune_metadata"), lambda f: pickle.dump(meta, f))
        return path or checkpoint_dir

    def restore(self, checkpoint_path: str) -> None:
        """Load a checkpoint directory (or a file in it)."""
        if os.path.isfile(checkpoint_path):
            checkpoint_dir = os.path.dirname(checkpoint_path)
        else:
            checkpoint_dir = checkpoint_path
        meta_path = os.path.join(checkpoint_dir, ".tune_metadata")
        if os.path.exists(meta_path):
            with open(meta_path, "rb") as f:
                meta = pickle.load(f)
            self._iteration = meta["iteration"]
            self._timesteps_total = meta["timesteps_total"]
            self._time_total = meta["time_total"]
        self.load_checkpoint(checkpoint_path)

    # -- PBT (not ported) --------------------------------------------------

    def get_exploit_state(self):
        raise NotImplementedError(f"the PBT exploit protocol is not ported yet: {_PBT_ITEM}")

    def apply_exploit(self, state, scalar_overrides):
        raise NotImplementedError(f"the PBT exploit protocol is not ported yet: {_PBT_ITEM}")
