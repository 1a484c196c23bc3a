"""Shared remote link: a single bandwidth pipe with request latency.

Demand (read-miss) transfers strictly precede background prefetch transfers;
within a class, FIFO.  A transfer occupies the pipe for bytes/bandwidth and
completes ``latency`` later (pipelined requests — latency adds delay but does
not hold the pipe).  This is the contention model that makes the
hierarchical-prefetch experiment meaningful: indiscriminate directory
prefetch saturates the pipe and inflates demand latency (Fig. 7, 15.7× JCT).
"""
from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, Optional, Tuple


@dataclass(order=True)
class _Transfer:
    seq: int
    nbytes: int = field(compare=False)
    key: str = field(compare=False)
    demand: bool = field(compare=False)
    callback: Callable[[float], None] = field(compare=False)


class SharedLink:
    def __init__(self, bandwidth_Bps: float, latency_s: float) -> None:
        self.bw = bandwidth_Bps
        self.latency = latency_s
        self.free_at = 0.0
        self._demand: Deque[_Transfer] = deque()
        self._background: Deque[_Transfer] = deque()
        self._seq = itertools.count()
        # key -> (finish_time, transfer) for in-flight/queued background work
        self.inflight: Dict[str, _Transfer] = {}
        self.bytes_moved = 0
        self.busy_time = 0.0

    def enqueue(self, nbytes: int, key: str, demand: bool,
                callback: Callable[[float], None]) -> None:
        t = _Transfer(next(self._seq), nbytes, key, demand, callback)
        (self._demand if demand else self._background).append(t)
        self.inflight[key] = t

    def promote(self, key: str) -> bool:
        """A queued background transfer became demand-critical."""
        t = self.inflight.get(key)
        if t is None or t.demand:
            return False
        try:
            self._background.remove(t)
        except ValueError:
            return False  # already started
        t.demand = True
        self._demand.append(t)
        return True

    def pending(self, key: str) -> bool:
        return key in self.inflight

    def idle(self) -> bool:
        return not self._demand and not self._background

    def pump(self, now: float):
        """Start the next transfer if the pipe is free.

        Returns (finish_time, transfer) or None.  The caller (event loop)
        schedules the completion event and re-pumps afterwards.
        """
        if now < self.free_at or self.idle():
            return None
        t = self._demand.popleft() if self._demand else self._background.popleft()
        start = max(now, self.free_at)
        busy = t.nbytes / self.bw
        self.free_at = start + busy
        self.bytes_moved += t.nbytes
        self.busy_time += busy
        finish = start + busy + self.latency
        self.inflight.pop(t.key, None)
        return finish, t
