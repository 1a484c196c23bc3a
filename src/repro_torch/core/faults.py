"""Fault-tolerance primitives shared by the shard driver and the client.

This module sits *below* both ``core.procdriver`` and ``core.client`` in
the import graph (procdriver imports client; client must catch driver
failures), so the error/budget vocabulary lives here:

  * ``ShardUnavailableError`` — a typed, per-shard failure the client can
    catch to serve a degraded read instead of surfacing a crash.
  * ``RestartBudget`` — sliding-window restart rate limit: a shard that
    keeps dying stops being respawned and is marked permanently DOWN.
  * shard state constants (``SHARD_UP`` / ``SHARD_RESTARTING`` /
    ``SHARD_DOWN``) used by the driver's supervisor and reported through
    ``fault_stats()``.

See docs/RELIABILITY.md for the full failure model.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional

__all__ = [
    "DaemonUnavailableError", "RestartBudget", "SHARD_DOWN",
    "SHARD_RESTARTING", "SHARD_UP", "ShardUnavailableError",
]

# Shard lifecycle states (strings: cheap to report through stats dicts).
# The daemon supervisor reuses the same vocabulary for the whole-daemon
# lifecycle (up / restarting / down), reported via its events log.
SHARD_UP = "up"                  # worker alive, serving RPCs
SHARD_RESTARTING = "restarting"  # worker died, respawn in progress
SHARD_DOWN = "down"              # restart budget exhausted: permanently out


class DaemonUnavailableError(ConnectionError):
    """The cache daemon behind a ``RemoteCacheClient`` is unreachable —
    crashed, draining, or gone past its restart budget.

    Subclasses ``ConnectionError`` so pre-existing handlers (which
    matched the raw socket errors the old client surfaced) keep working;
    new callers catch this type for the daemon analog of
    :class:`ShardUnavailableError`.  With ``degraded=True`` (the client
    default) readers never see it — reads are served straight from the
    backing store until the daemon returns; it surfaces only for
    ``degraded=False`` clients and for operations that *need* the daemon
    (stats, snapshots, flush-with-result).

    ``state`` is the client's view of the connection
    (``"down"`` while reconnecting, ``"closed"`` after ``close()``).
    """

    def __init__(self, message: str, *, state: str = "down") -> None:
        super().__init__(message)
        self.state = state


class ShardUnavailableError(RuntimeError):
    """A shard worker is dead, restarting, or permanently down.

    Subclasses ``RuntimeError`` so pre-fault-tolerance callers (which
    matched the driver's generic worker-died RuntimeError) keep working;
    new callers catch this type to trigger degraded-mode reads.

    ``partial`` / ``indices`` carry partial-batch context for
    ``read_batch``: ``partial`` is the per-request outcome list with
    ``None`` holes at the failed positions, ``indices`` names those
    positions.  The client patches only the holes via degraded fetches —
    re-issuing the whole batch would double-observe the surviving
    shards' keys and distort their kernels' access streams.
    """

    def __init__(self, message: str, *, sid: int = -1,
                 state: str = SHARD_RESTARTING,
                 partial: Optional[list] = None,
                 indices: Optional[List[int]] = None) -> None:
        super().__init__(message)
        self.sid = sid
        self.state = state
        self.partial = partial
        self.indices = indices


@dataclass
class RestartBudget:
    """Sliding-window restart rate limit.

    ``allow(now)`` consumes one restart token if fewer than
    ``max_restarts`` fired within the trailing ``window_s`` seconds;
    otherwise returns ``False`` — the caller marks the shard permanently
    DOWN.  A crash-looping worker (bad region, poisoned store) thus
    converges to a stable degraded state instead of flapping forever.

    Timestamps are caller-supplied (wall or virtual clock) so tests are
    deterministic.
    """

    max_restarts: int = 3
    window_s: float = 60.0
    history: Deque[float] = field(default_factory=deque)

    def allow(self, now: float) -> bool:
        while self.history and now - self.history[0] > self.window_s:
            self.history.popleft()
        if len(self.history) >= self.max_restarts:
            return False
        self.history.append(now)
        return True

    @property
    def used(self) -> int:
        return len(self.history)
