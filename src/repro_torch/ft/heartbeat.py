"""Liveness beacons, shared by the train driver and the serve loop.

jax-free on purpose: the serving re-install manager imports this and
must stay importable anywhere the installer runs (repro.launch.profile
has the same constraint).
"""

from __future__ import annotations

import time
from typing import Any

__all__ = ["write_heartbeat", "read_heartbeat"]


def write_heartbeat(path: str, tag: Any) -> None:
    """Overwrite ``path`` with ``"<tag> <unix time>"``.

    A coordinator watching mtimes (or reading the tag) detects dead or
    wedged workers.  The train driver stamps its step number per step;
    the serving re-install manager stamps its install phase, so a
    background install that dies mid-gather is distinguishable from one
    that never fired.
    """
    with open(path, "w") as f:
        f.write(f"{tag} {time.time()}")


def read_heartbeat(path: str) -> tuple[str, float]:
    """``(tag, unix_time)`` of the last beat."""
    with open(path) as f:
        tag, _, ts = f.read().strip().rpartition(" ")
    return tag, float(ts)
