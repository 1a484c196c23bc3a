"""Chaos harness: seeded worker-failure injection for the fault runtime.

The supervision/recovery machinery in ``core.procdriver`` is only as
trustworthy as the failures it has been marched through.  This module is
the controlled failure source: a :class:`ChaosMonkey` that kills
(SIGKILL) or wedges (SIGSTOP/SIGCONT) the shard workers of a
``ProcessShardedCache`` on demand, a deterministic strike planner
(``plan_strikes`` — same seed, same schedule), and a
:class:`ChaosSchedule` that fires the planned strikes as a trace driver
advances through its steps.  The cluster simulator accepts the same
strikes as virtual-time events (``ClusterSim(chaos_events=...)``), so a
mixed-workload trace can lose a shard mid-run and the whole
read → degrade → respawn → re-warm arc plays out inside one test.

Strikes are *count-driven* (fire at step N), not wall-clock-driven:
schedules replay bit-identically regardless of machine speed, which is
what lets the fault matrix in tests/test_chaos.py assert exact
bookkeeping (conservation identities, zero lost reads) instead of
sampling a race.

The *client* failure domain: ``client_kill`` strikes a
registered daemon client (anything with a ``kill()`` — a
``repro_torch.daemon.RemoteCacheClient`` dies silently, socket held open, so
only the daemon's session lease can notice), drilling the
fault-of-the-client arc the same way ``kill``/``suspend`` drill the
fault-of-the-worker one.

The *daemon* failure domain: ``daemon_kill`` crashes a
supervised cache daemon abruptly (sockets die mid-conversation, no
final snapshot — the SIGKILL stand-in; the
``repro_torch.daemon.DaemonSupervisor`` notices and respawns on the same
socket path, warm-starting from the journal), and ``daemon_restart``
rolls it gracefully (SIGTERM shape: drain → ``going_down`` to
sessions → final snapshot → respawn).  Register the supervisor via
``ChaosMonkey(daemon=...)``; the drill asserts the full kill →
degraded reads → respawn → reconnect → CHR re-convergence arc.

Only the process driver has failure domains to strike; handing an
in-process engine to the monkey is a ``TypeError``, not a silent no-op.
"""
from __future__ import annotations

import os
import random
import signal
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set

__all__ = ["ChaosMonkey", "ChaosSchedule", "ChaosStrike", "plan_strikes"]

KINDS = ("kill", "suspend", "resume", "client_kill", "daemon_kill",
         "daemon_restart")


@dataclass(frozen=True)
class ChaosStrike:
    """One planned failure: at trace step ``step``, do ``kind`` to shard
    (or, for ``client_kill``, registered client) ``sid``.  The daemon
    strikes ignore ``sid`` — there is one supervised daemon."""

    step: int
    kind: str          # "kill" | "suspend" | "resume" | "client_kill"
                       # | "daemon_kill" | "daemon_restart"
    sid: int


class ChaosMonkey:
    """Failure injector over a multi-process shard driver.

    ``target`` is a ``ProcessShardedCache`` or a ``CacheClient`` wrapping
    one.  ``kill`` routes through the driver's own kill path (so the
    fault shows up in ``fault_stats()`` exactly like an RPC-timeout
    kill); ``suspend``/``resume`` SIGSTOP/SIGCONT the worker process
    directly — a stopped worker is the hung-worker case: the pipe stays
    open, no EOF fires, and only heartbeat/RPC deadlines can notice.

    ``clients`` registers daemon-client victims for the ``client_kill``
    strike (index = sid): each must expose ``kill()`` — the
    ``RemoteCacheClient`` drill that goes silent without closing the
    socket, so the daemon's *lease*, not EOF, must reclaim the session.
    ``target`` may be ``None`` when only client strikes are planned.

    Every strike lands in ``self.strikes`` (kind, sid, pid, generation,
    wall time) for post-run audit.
    """

    def __init__(self, target, clients: Sequence = (),
                 daemon=None) -> None:
        driver = getattr(target, "engine", target) \
            if target is not None else None
        if driver is not None and (
                not hasattr(driver, "_channels")
                or not hasattr(driver, "_kill_worker")):
            raise TypeError(
                "ChaosMonkey needs a ProcessShardedCache (or a CacheClient "
                f"over one); got {type(driver).__name__} — in-process "
                "engines have no worker processes to strike")
        if daemon is not None and (
                not hasattr(daemon, "kill_daemon")
                or not hasattr(daemon, "drain_restart")):
            raise TypeError(
                "daemon= needs a DaemonSupervisor (kill_daemon/"
                f"drain_restart); got {type(daemon).__name__} — an "
                "unsupervised daemon would stay dead after the strike")
        if driver is None and not clients and daemon is None:
            raise TypeError("ChaosMonkey with no process driver needs "
                            "at least one registered client victim or a "
                            "supervised daemon")
        self.driver = driver
        self.clients = list(clients)
        self.daemon = daemon
        self.strikes: List[dict] = []
        self._suspended: Set[int] = set()

    # ------------------------------------------------------------- strikes
    def _log(self, kind: str, sid: int, pid: Optional[int]) -> None:
        gen = (self.driver._channels[sid].generation
               if kind in ("kill", "suspend", "resume") else None)
        self.strikes.append({"kind": kind, "sid": sid, "pid": pid,
                             "generation": gen,
                             "at": time.monotonic()})

    def _require_driver(self, kind: str) -> None:
        if self.driver is None:
            raise RuntimeError(f"strike {kind!r} needs a process driver; "
                               "this monkey only has client victims")

    def kill(self, sid: int, reason: str = "chaos") -> None:
        """SIGKILL the shard's current worker via the driver's kill path
        (fault event recorded, supervisor respawns if budget allows)."""
        self._require_driver("kill")
        ch = self.driver._channels[sid]
        pid = ch.proc.pid
        self.driver._kill_worker(sid, reason)
        self._suspended.discard(sid)
        self._log("kill", sid, pid)

    def suspend(self, sid: int) -> None:
        """SIGSTOP the worker: alive to the OS, dead to its callers.
        Undetectable by pipe EOF — this is the case heartbeats and RPC
        deadlines exist for."""
        self._require_driver("suspend")
        pid = self.driver._channels[sid].proc.pid
        try:
            os.kill(pid, signal.SIGSTOP)
            self._suspended.add(sid)
        except ProcessLookupError:      # already gone: nothing to wedge
            pid = None
        self._log("suspend", sid, pid)

    def resume(self, sid: int) -> None:
        """SIGCONT a suspended worker (no-op if it was never suspended or
        the supervisor already killed and replaced it)."""
        if sid not in self._suspended:
            return
        self._require_driver("resume")
        self._suspended.discard(sid)
        pid = self.driver._channels[sid].proc.pid
        try:
            os.kill(pid, signal.SIGCONT)
        except ProcessLookupError:
            pid = None
        self._log("resume", sid, pid)

    def resume_all(self) -> None:
        """Un-wedge everything — call from test teardown so a failing
        assertion never leaves stopped processes behind."""
        for sid in list(self._suspended):
            self.resume(sid)

    def client_kill(self, sid: int) -> None:
        """Kill registered client ``sid`` the crashed-process way: it
        goes silent (heartbeats stop, socket stays open), so the
        daemon's session lease — not EOF — must notice and reclaim."""
        victim = self.clients[sid]
        victim.kill()
        self._log("client_kill", sid, getattr(victim, "pid", None))

    def _require_daemon(self, kind: str) -> None:
        if self.daemon is None:
            raise RuntimeError(f"strike {kind!r} needs a supervised "
                               "daemon (ChaosMonkey(daemon=...))")

    def daemon_kill(self, sid: int = 0) -> None:
        """Crash the supervised daemon abruptly (SIGKILL stand-in):
        every session socket dies mid-conversation, no final snapshot.
        The supervisor respawns within its restart budget; clients see
        EOF, serve degraded reads, and reconnect to the same path."""
        self._require_daemon("daemon_kill")
        self.daemon.kill_daemon()
        self._log("daemon_kill", sid, None)

    def daemon_restart(self, sid: int = 0) -> None:
        """Roll the daemon gracefully (SIGTERM shape): drain — sessions
        get ``going_down``, executor flushed, final snapshot written —
        then respawn immediately on the same socket path."""
        self._require_daemon("daemon_restart")
        self.daemon.drain_restart()
        self._log("daemon_restart", sid, None)

    def strike(self, kind: str, sid: int) -> None:
        if kind not in KINDS:
            raise ValueError(f"unknown strike kind {kind!r}; "
                             f"expected one of {KINDS}")
        getattr(self, kind)(sid)


def plan_strikes(n_steps: int, *, n_shards: int, seed: int = 0,
                 n_strikes: int = 1, kinds: Sequence[str] = ("kill",),
                 min_step: int = 1, resume_after: int = 3,
                 n_clients: int = 0) -> List[ChaosStrike]:
    """Deterministic strike schedule: ``n_strikes`` failures at distinct
    pseudo-random steps in ``[min_step, n_steps)``, kinds and target
    shards drawn from the same seeded stream.  Every planned ``suspend``
    is paired with a ``resume`` ``resume_after`` steps later (clamped to
    the trace) so a schedule can never leave a worker wedged past the
    run.  ``client_kill`` strikes draw their victim from
    ``range(n_clients)`` instead of the shard space.  Same (seed,
    shape) → same schedule, always."""
    for k in kinds:
        if k not in ("kill", "suspend", "client_kill", "daemon_kill",
                     "daemon_restart"):
            raise ValueError("plannable kinds are kill/suspend/client_kill/"
                             f"daemon_kill/daemon_restart, got {k!r}")
    if "client_kill" in kinds and n_clients <= 0:
        raise ValueError("client_kill strikes need n_clients > 0")
    if n_steps <= min_step:
        raise ValueError("trace too short for the requested strike window")
    rng = random.Random(seed)
    span = range(min_step, n_steps)
    steps = sorted(rng.sample(span, min(n_strikes, len(span))))
    out: List[ChaosStrike] = []
    for step in steps:
        kind = kinds[rng.randrange(len(kinds))]
        if kind in ("daemon_kill", "daemon_restart"):
            sid = 0                       # one supervised daemon
        else:
            sid = rng.randrange(n_clients if kind == "client_kill"
                                else n_shards)
        out.append(ChaosStrike(step, kind, sid))
        if kind == "suspend":
            out.append(ChaosStrike(min(n_steps - 1, step + resume_after),
                                   "resume", sid))
    return sorted(out, key=lambda s: (s.step, s.kind != "resume"))


class ChaosSchedule:
    """Binds a strike plan to a monkey: the trace driver calls
    ``on_step(i)`` once per step and every strike planned at step ``i``
    fires.  ``fired`` is the executed subset (a strike against a shard
    can fire at most once per plan entry)."""

    def __init__(self, monkey: ChaosMonkey,
                 strikes: Sequence[ChaosStrike]) -> None:
        self.monkey = monkey
        self._by_step: Dict[int, List[ChaosStrike]] = defaultdict(list)
        for s in strikes:
            self._by_step[s.step].append(s)
        self.fired: List[ChaosStrike] = []

    def on_step(self, step: int) -> List[ChaosStrike]:
        due = self._by_step.pop(step, [])
        for s in due:
            self.monkey.strike(s.kind, s.sid)
            self.fired.append(s)
        return due

    def close(self) -> None:
        self.monkey.resume_all()
