"""Long-poll pub/sub for serve config propagation.

Counterpart of ``ray_tpu/serve/long_poll.py`` (the reference's
LongPollHost / LongPollClient): subscribers ask "anything newer than
version v for key k?" and block until the host publishes a change, so
config updates (replica membership, user_config, a staged policy state)
propagate promptly without polling loops or restarts. The host is an
in-process object; handles subscribe from any thread.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional, Tuple


class LongPollHost:
    def __init__(self):
        self._values: Dict[str, Any] = {}
        self._versions: Dict[str, int] = {}
        self._cond = threading.Condition()

    def notify(self, key: str, value: Any) -> int:
        """Publish a new value for key; wakes all listeners."""
        with self._cond:
            self._versions[key] = self._versions.get(key, 0) + 1
            self._values[key] = value
            self._cond.notify_all()
            return self._versions[key]

    def listen(
        self,
        key: str,
        last_version: int = 0,
        timeout: Optional[float] = None,
    ) -> Optional[Tuple[int, Any]]:
        """Block until key's version exceeds last_version; returns
        (version, value), or None on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._versions.get(key, 0) <= last_version:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return None
                self._cond.wait(remaining)
            return self._versions[key], self._values[key]

    def current(self, key: str) -> Tuple[int, Any]:
        with self._cond:
            return self._versions.get(key, 0), self._values.get(key)
