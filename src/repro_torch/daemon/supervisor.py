"""``DaemonSupervisor``: keep one cache daemon alive on a fixed socket.

The process driver's shard supervisor answered *fault of the worker* — a shard
process dies, the driver respawns it inside a :class:`RestartBudget`.
This module lifts the same shape one level: the unit of failure is the
whole daemon.  A supervisor owns a ``factory()`` that builds-and-starts
a :class:`~repro_torch.daemon.server.CacheDaemon` **on the same socket path**
every time (clients reconnect to the address they already know — no
re-discovery protocol), a monitor thread that notices a crashed daemon,
and the same sliding-window budget semantics: a daemon that keeps
dying (poisoned journal, bad disk) stops being respawned and the
supervisor converges to a stable ``down`` state — clients with
``degraded=True`` keep serving reads from the backing store.

State machine mirrors the shard vocabulary (``up`` / ``restarting`` /
``down``); transitions land in ``events`` with wall-clock timestamps
and, for each respawn, the measured ``recovery_s`` (factory return to
listening socket — the number the recovery benchmark reports).

In-process by design: the daemon here is an object, not a child
process, so "crash" means :meth:`CacheDaemon.crash` (sockets die
abruptly, journal unsynced, stale UDS path left behind) and drills can
run inside one pytest process with no fork/exec variance.  The factory
indirection is exactly what a process-level supervisor would keep —
swapping in ``subprocess.Popen`` changes the factory, not the loop.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

from ..core.faults import (RestartBudget, SHARD_DOWN, SHARD_RESTARTING,
                           SHARD_UP)
from .server import CacheDaemon

__all__ = ["DaemonSupervisor"]


class DaemonSupervisor:
    """Respawn a crashed :class:`CacheDaemon` on its fixed socket path.

    ``factory`` builds **and starts** a daemon each time it is called;
    it must bind the same address every call (pass an explicit ``uds``
    path and the same ``journal_dir`` so respawns warm-start).
    ``restart_budget`` / ``restart_window_s`` bound the respawn rate —
    exhaustion marks the service permanently ``down``.  ``poll_s`` is
    the monitor cadence for noticing an abrupt crash.
    """

    def __init__(self, factory: Callable[[], CacheDaemon], *,
                 restart_budget: int = 3, restart_window_s: float = 60.0,
                 poll_s: float = 0.05) -> None:
        self._factory = factory
        self._budget = RestartBudget(max_restarts=restart_budget,
                                     window_s=restart_window_s)
        self._poll_s = float(poll_s)
        self._lock = threading.RLock()
        self._closing = False
        self.state = SHARD_UP
        self.restarts = 0
        self.events: List[dict] = []
        self.daemon: CacheDaemon = factory()
        self._log("spawn", recovery_s=None)
        self._stop = threading.Event()
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         name="igt-daemon-supervisor",
                                         daemon=True)
        self._monitor.start()

    # ------------------------------------------------------------- events
    def _log(self, kind: str, **extra) -> None:
        ev = {"t": time.monotonic(), "kind": kind, "state": self.state}
        ev.update(extra)
        self.events.append(ev)

    @property
    def uri(self) -> str:
        """The (stable) ``cache://`` URI clients connect to."""
        return self.daemon.uri

    # ------------------------------------------------------------ respawn
    def _respawn(self, reason: str) -> bool:
        """Budget-checked respawn; returns True when the daemon is back
        up.  Caller holds ``self._lock``."""
        if self._closing:
            return False
        if not self._budget.allow(time.monotonic()):
            self.state = SHARD_DOWN
            self._log("budget_exhausted", reason=reason)
            return False
        self.state = SHARD_RESTARTING
        self._log("respawn_start", reason=reason)
        t0 = time.monotonic()
        self.daemon = self._factory()
        self.restarts += 1
        self.state = SHARD_UP
        self._log("respawn_done", reason=reason,
                  recovery_s=time.monotonic() - t0,
                  restore=dict(self.daemon.restore_stats))
        return True

    def _monitor_loop(self) -> None:
        while not self._stop.wait(self._poll_s):
            with self._lock:
                if self._closing or self.state == SHARD_DOWN:
                    return
                if self.daemon._crashed and self.state == SHARD_UP:
                    self._respawn("crash")

    # ------------------------------------------------------------- drills
    def kill_daemon(self) -> None:
        """Abrupt kill (the ``daemon_kill`` strike): sockets die
        mid-conversation, no final snapshot.  The monitor thread
        notices and respawns within the budget."""
        with self._lock:
            self.daemon.crash()
            self._log("kill", recovery_s=None)

    def drain_restart(self) -> bool:
        """Graceful roll (the ``daemon_restart`` strike / SIGTERM
        path): drain — clients get ``going_down``, a final snapshot is
        written — then respawn immediately.  Returns True when the new
        daemon is up."""
        with self._lock:
            self.daemon.drain()
            self._log("drain", recovery_s=None)
            return self._respawn("drain")

    # ---------------------------------------------------------- lifecycle
    def close(self) -> None:
        with self._lock:
            if self._closing:
                return
            self._closing = True
        self._stop.set()
        self._monitor.join(timeout=5.0)
        self.daemon.close()

    def __enter__(self) -> "DaemonSupervisor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- stats
    def supervisor_stats(self) -> dict:
        with self._lock:
            return {
                "state": self.state,
                "restarts": self.restarts,
                "budget_used": self._budget.used,
                "budget_max": self._budget.max_restarts,
                "events": [dict(e) for e in self.events],
            }
