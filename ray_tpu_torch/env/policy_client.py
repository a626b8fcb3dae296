"""PolicyClient: the external env's side of the policy server.

Copy of ``ray_tpu/env/policy_client.py``, the same wire format: one HTTP
POST a call, a JSON body ``{"command": ..., "episode_id": ..., ...}``
(``START_EPISODE``, ``GET_ACTION`` with ``observation`` as nested lists,
``LOG_RETURNS`` with ``reward``, ``END_EPISODE`` with ``observation``
and ``truncated``), a JSON answer, and ``{"error": ...}`` with status
500 on a server-side failure. Either package's client drives either
package's ``PolicyServerInput``. Standard library only.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Optional

import numpy as np


class PolicyClient:
    def __init__(self, address: str, timeout: float = 60.0):
        if not address.startswith("http"):
            address = f"http://{address}"
        self.address = address.rstrip("/")
        self.timeout = timeout

    def _call(self, payload: dict) -> dict:
        req = urllib.request.Request(
            self.address, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as e:
            try:
                detail = json.loads(e.read()).get("error", "")
            except Exception:  # a body that is not the server's JSON
                detail = ""
            raise RuntimeError(f"policy server error {e.code}: {detail}") from None

    def start_episode(self, episode_id: Optional[str] = None, training_enabled: bool = True) -> str:
        return self._call({"command": "START_EPISODE", "episode_id": episode_id,
                           "training_enabled": training_enabled})["episode_id"]

    def get_action(self, episode_id: str, observation) -> np.ndarray:
        out = self._call({"command": "GET_ACTION", "episode_id": episode_id,
                          "observation": np.asarray(observation).tolist()})
        return np.asarray(out["action"])

    def log_returns(self, episode_id: str, reward: float) -> None:
        self._call({"command": "LOG_RETURNS", "episode_id": episode_id, "reward": float(reward)})

    def end_episode(self, episode_id: str, observation, truncated: bool = False) -> None:
        """``truncated=True`` marks a time-limit end: the server keeps the
        last row's ``terminateds`` False, so GAE bootstraps V(s_T)."""
        self._call({"command": "END_EPISODE", "episode_id": episode_id,
                    "observation": np.asarray(observation).tolist(),
                    "truncated": bool(truncated)})
