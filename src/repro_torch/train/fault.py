"""Fault tolerance & straggler mitigation for the training driver.

At 1000+-node scale the failure domains are: worker crash (restart from the
latest checkpoint), slow worker (straggler), and preemption (checkpoint on
signal).  On a single host we implement the full control flow against a
simulated failure injector so the logic is testable end-to-end:

  * ``Heartbeat`` — per-worker liveness with a deadline; missed deadline =
    failure → driver restores from the last committed checkpoint and
    reassigns the worker's data shard.
  * ``StragglerDetector`` — EWMA of per-worker step times; a worker slower
    than ``factor``× the median is flagged; mitigation = deterministic data
    re-sharding (the IGTCache layer makes the replacement warm: the dataset's
    blocks are already resident, so a restarted worker skips the cold-start
    misses).
  * ``PreemptionGuard`` — SIGTERM → synchronous checkpoint then exit.

The multi-controller JAX runtime handles collective-level failure detection;
this module is the *policy* layer above it.
"""
from __future__ import annotations

import signal
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set


@dataclass
class Heartbeat:
    """Per-worker liveness with a deadline.

    Thread-safe: the cache driver's supervisor polls ``dead_workers``
    from its own thread while per-channel receiver threads ``beat`` —
    the beat map is snapshotted under a lock so concurrent beats never
    race the scan (it is also the training driver's single-threaded
    liveness tracker, which the lock leaves untouched semantically).
    """

    deadline_s: float = 60.0
    last_beat: Dict[int, float] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def beat(self, worker: int, now: Optional[float] = None) -> None:
        with self._lock:
            self.last_beat[worker] = now if now is not None else time.time()

    def dead_workers(self, now: Optional[float] = None) -> List[int]:
        now = now if now is not None else time.time()
        with self._lock:
            items = list(self.last_beat.items())
        return [w for w, t in items if now - t > self.deadline_s]


class StragglerDetector:
    def __init__(self, factor: float = 1.8, alpha: float = 0.3) -> None:
        self.factor = factor
        self.alpha = alpha
        self.ewma: Dict[int, float] = {}

    def record(self, worker: int, step_time: float) -> None:
        prev = self.ewma.get(worker, step_time)
        self.ewma[worker] = (1 - self.alpha) * prev + self.alpha * step_time

    def stragglers(self) -> List[int]:
        if len(self.ewma) < 2:
            return []
        times = sorted(self.ewma.values())
        median = times[len(times) // 2]
        return [w for w, t in self.ewma.items() if t > self.factor * median]


def reassign_shards(n_shards: int, workers: Set[int]) -> Dict[int, List[int]]:
    """Deterministic shard→worker assignment for the surviving workers
    (stable under membership change: shard s → sorted_workers[s % n])."""
    ws = sorted(workers)
    out: Dict[int, List[int]] = {w: [] for w in ws}
    for s in range(n_shards):
        out[ws[s % len(ws)]].append(s)
    return out


class PreemptionGuard:
    """SIGTERM/SIGINT → run the checkpoint callback once, then re-raise."""

    def __init__(self, on_preempt: Callable[[], None]) -> None:
        self.on_preempt = on_preempt
        self.preempted = False
        self._old = {}

    def __enter__(self):
        for sig in (signal.SIGTERM, signal.SIGINT):
            self._old[sig] = signal.signal(sig, self._handler)
        return self

    def _handler(self, signum, frame):
        if not self.preempted:
            self.preempted = True
            self.on_preempt()
        raise KeyboardInterrupt

    def __exit__(self, *exc):
        for sig, old in self._old.items():
            signal.signal(sig, old)
        return False


@dataclass
class FailureInjector:
    """Deterministic failure schedule for tests: {step: [workers]}."""

    crash_at: Dict[int, List[int]] = field(default_factory=dict)
    slow_at: Dict[int, List[int]] = field(default_factory=dict)
    slow_factor: float = 3.0

    def crashed(self, step: int) -> List[int]:
        return self.crash_at.get(step, [])

    def step_time(self, worker: int, step: int, base: float) -> float:
        if worker in self.slow_at.get(step, []):
            return base * self.slow_factor
        return base
