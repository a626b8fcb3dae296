"""Provider preemption-notice probe.

Counterpart of ``ray_tpu/resilience/provider_notice.py``. Cloud
providers announce spot/preemptible eviction through a local endpoint
(GCE's ``instance/preempted`` metadata key, AWS's
``spot/instance-action``); this is the in-repo stand-in, one
non-blocking probe that a serving replica
(``PolicyDeployment.preemption_notice``) and the ingress front door
consult. A real deployment replaces :func:`probe`'s sources with the
provider endpoint; the callers do not change.

Sources, first hit wins:

- ``RAY_TPU_PREEMPTION_NOTICE``: grace seconds as a float;
- ``RAY_TPU_PREEMPTION_NOTICE_FILE``: a path; the notice is armed the
  moment the file exists, its content the grace seconds (empty or
  unparseable = 0.0, evict now);
- ``RAY_TPU_PREEMPTION_NOTICE_DIR``: a directory of per-host notice
  files named ``<host>``, read by ``probe(host=...)``.
"""

from __future__ import annotations

import os
from typing import Optional

NOTICE_ENV = "RAY_TPU_PREEMPTION_NOTICE"
NOTICE_FILE_ENV = "RAY_TPU_PREEMPTION_NOTICE_FILE"
NOTICE_DIR_ENV = "RAY_TPU_PREEMPTION_NOTICE_DIR"


def _parse_grace(raw: str) -> float:
    try:
        return max(0.0, float(raw.strip()))
    except (TypeError, ValueError):
        return 0.0


def _probe_file(path: str) -> Optional[float]:
    try:
        with open(path) as f:
            return _parse_grace(f.read())
    except OSError:
        return None  # file absent: notice not armed (yet)


def probe(host: Optional[str] = None) -> Optional[float]:
    """Seconds of grace left before this process's announced
    preemption, or None when no notice is outstanding. Non-blocking and
    exception-free. ``host`` scopes the directory source to one host's
    notice file; the env and single-file sources fire regardless."""
    raw = os.environ.get(NOTICE_ENV)
    if raw is not None and raw.strip():
        return _parse_grace(raw)
    path = os.environ.get(NOTICE_FILE_ENV)
    if path:
        got = _probe_file(path)
        if got is not None:
            return got
    root = os.environ.get(NOTICE_DIR_ENV)
    if root and host:
        return _probe_file(os.path.join(root, host))
    return None
