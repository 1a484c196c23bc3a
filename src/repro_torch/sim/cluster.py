"""Discrete-event cluster simulator: jobs × IGTCache × shared remote link.

Semantics:
  * every job owns its compute device (Table 3 assigns distinct GPUs), so
    jobs contend only for the remote link and the shared cache;
  * a step = read batch → compute; the step's compute starts when all its
    demand bytes have landed (hits cost the local service time);
  * engine-issued prefetch candidates ride the link at background priority
    and are admitted on completion (``complete_prefetch``);
  * a demand read that finds its block already in flight (as someone else's
    miss or a background prefetch) waits for that transfer instead of
    re-fetching (single-flight).

The simulator is a ``CacheClient`` consumer: it drives the kernel through
the client layer with a :class:`LinkExecutor` — the executor that models
prefetch transport as background-priority transfers on the shared link
(the sim owns time and bandwidth, so candidates cannot complete inline;
they complete when the event loop lands their transfer and calls
``client.complete_prefetch``).
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple, Union

# The simulator drives the kernel only through the client layer, which
# itself only uses the public kernel surface (read_batch /
# complete_prefetch / tick / ...), so the sharded facade slots in
# unchanged.
from ..core import path_key
from ..core.allocation import marginal_benefit
from ..core.client import CacheClient, PrefetchExecutor
from ..core.sharded import Engine
from ..core.types import PathT
from .link import SharedLink
from .workloads import Job, WorkloadSuite


class LinkExecutor(PrefetchExecutor):
    """PrefetchExecutor over the simulated shared link.

    ``submit`` enqueues each candidate as a background-priority transfer
    (skipping blocks already in flight — single-flight); the sim's event
    loop completes or promotes them.  Completion/cancellation accounting
    therefore lives in the event loop, not here: the executor only hands
    candidates to the bandwidth model.
    """

    def __init__(self, link: SharedLink) -> None:
        super().__init__()
        self.link = link
        # tier-aware transport: when the client's backing store is a
        # TieredStore (mode="index"), disk-resident prefetch candidates
        # complete instantly from local disk instead of riding the link
        self.tier = None

    def submit(self, candidates, now: float) -> None:
        self.stats.submitted += len(candidates)
        for ppath, psize in candidates:
            pkey = path_key(ppath)
            t = self.link.inflight.get(pkey)
            if t is None:
                if self.tier is not None and \
                        self.tier.sim_read(pkey, psize, prefetch=True):
                    self.engine.complete_prefetch(ppath, psize, now)
                    self.stats.completed += 1
                    continue
                self.link.enqueue(psize, pkey, demand=False,
                                  callback=(ppath, psize))
            elif t.callback is None:
                # the in-flight transfer is pure demand: it will land
                # without calling complete_prefetch, so this candidate
                # must be cancelled, not skipped — otherwise its kernel
                # pending-table entry leaks and suppresses re-issue
                self.engine.cancel_prefetch(ppath)
                self.stats.cancelled += 1
            # else: an in-flight prefetch transfer for the same block —
            # its completion clears the (shared) pending entry; skip


@dataclass
class SimResult:
    jct: Dict[int, float]                      # job_id -> completion seconds
    hit_ratio: float
    stats: dict
    makespan: float
    link_utilization: float
    step_trace: Dict[int, List[float]]         # job_id -> step finish times
    alloc_trace: List[dict] = field(default_factory=list)
    chaos_log: List[dict] = field(default_factory=list)
    # per-round cross-shard rebalance stats (moves applied, bytes moved,
    # summary payload bytes, ghost mass) — empty for unsharded engines
    rebalance_trace: List[dict] = field(default_factory=list)
    # tiered-backing accounting (storage.tiers tier_stats snapshot):
    # disk hits / remote bytes for the bytes-moved comparison — empty
    # when the backing store has no tiers
    tier_stats: dict = field(default_factory=dict)
    # total bytes that crossed the remote link (demand + prefetch): the
    # bytes-moved axis of the tiered-vs-flat comparison
    link_bytes: int = 0

    @property
    def avg_jct(self) -> float:
        return sum(self.jct.values()) / max(1, len(self.jct))


class ClusterSim:
    def __init__(self, suite: WorkloadSuite, engine: Union[Engine, CacheClient],
                 bandwidth_Bps: float = 125e6, latency_s: float = 0.150,
                 local_latency_s: float = 0.0005,
                 local_bandwidth_Bps: float = 6e9,
                 disk_latency_s: float = 0.002,
                 disk_bandwidth_Bps: float = 2e9,
                 trace_alloc: bool = False,
                 stop_job_at: Optional[Tuple[int, float]] = None,
                 chaos_events: Optional[List[Tuple[float, str, int]]]
                 = None,
                 chaos_clients: Optional[List] = None,
                 chaos_daemon=None) -> None:
        self.suite = suite
        self.link = SharedLink(bandwidth_Bps, latency_s)
        # Accept any of three layers: a CacheClient (open_cache path), a
        # bare kernel, or a RemoteCacheClient session against a running
        # CacheDaemon.  For the local layers the sim re-routes prefetch
        # transport onto its own link — inside the simulation, background
        # bytes must contend for the modeled bandwidth, so an
        # inline/threaded executor would be wrong here.  A passed client
        # is reused (its previous executor is closed, with queued
        # candidates cancelled on the kernel).  A *remote* client has no
        # local executor to re-route (the daemon owns prefetch transport)
        # — the sim charges its demand misses to the link as pure-demand
        # transfers and drives the shared kernel timeline via explicit
        # ``now`` stamps; this is the harness the daemon-kill chaos
        # drills run in (wall-clock daemon recovery under a virtual-time
        # trace, reconciled via ``at()`` probes).
        self._remote = bool(getattr(engine, "is_remote_cache_client",
                                    False))
        if self._remote:
            self.client = engine
            self.engine = None
        elif isinstance(engine, CacheClient):
            self.client = engine
            self.client.set_executor(LinkExecutor(self.link))
            self.engine = self.client.engine
        else:
            self.client = CacheClient(engine,
                                      executor=LinkExecutor(self.link),
                                      clock=lambda: self.now)
            self.engine = self.client.engine
        self.local_latency = local_latency_s
        self.local_bw = local_bandwidth_Bps
        self.disk_latency = disk_latency_s
        self.disk_bw = disk_bandwidth_Bps
        # a tiered backing store (storage.tiers) exposes sim_read: missed
        # blocks resident in the spill tier cost a local disk read, not a
        # remote-link transfer — the tier-aware bytes-moved model
        backing = getattr(self.client, "backing", None)
        self._tier = backing if callable(getattr(backing, "sim_read",
                                                 None)) else None
        if not self._remote:
            self.client.executor.tier = self._tier
        self.trace_alloc = trace_alloc
        self.stop_job_at = stop_job_at       # (job_id, time): forced stop (Fig 11)
        # (virtual time, kind, sid) strikes against a process-backed
        # engine: the chaos arc (kill → degraded reads → respawn →
        # re-warm) plays out inside the simulated trace.  Worker strikes
        # (kill/suspend/resume) need a multi-process driver (sim.chaos);
        # "client_kill" strikes target ``chaos_clients[sid]`` instead —
        # daemon clients registered as victims, so a trace can lose a
        # remote cache client mid-run and the daemon's lease reclaim
        # plays out alongside the simulated workload.
        self.chaos_events = list(chaos_events or [])
        self.chaos_clients = list(chaos_clients or [])
        # a DaemonSupervisor: the victim of daemon_kill/daemon_restart
        # strikes (sim.chaos) — the daemon failure domain
        self.chaos_daemon = chaos_daemon
        self._chaos = None
        self._chaos_log: List[dict] = []
        self._events: List[Tuple[float, int, str, object]] = []
        self._seq = itertools.count()
        self._waiters: Dict[str, List[int]] = {}
        self._outstanding: Dict[int, int] = {}
        self._step_idx: Dict[int, int] = {}
        self._jobs: Dict[int, Job] = {j.job_id: j for j in suite.jobs}
        self._done: Dict[int, float] = {}
        self._step_trace: Dict[int, List[float]] = {j.job_id: [] for j in suite.jobs}
        self._alloc_trace: List[dict] = []
        self._stopped: set = set()
        self.now = 0.0

    # ---------------------------------------------------------------- events
    def _push(self, t: float, kind: str, payload: object = None) -> None:
        heapq.heappush(self._events, (t, next(self._seq), kind, payload))

    def at(self, t: float, fn: Callable[["ClusterSim"], None]) -> None:
        """Schedule ``fn(sim)`` at virtual time ``t`` (before ``run``):
        a measurement probe inside the event loop — the chaos tests use
        it to snapshot stats at fixed virtual times so windowed CHR is
        comparable across baseline and fault runs."""
        self._push(t, "probe", fn)

    def run(self, max_time: float = 1e7) -> SimResult:
        for j in self.suite.jobs:
            self._push(j.submit_time, "job_start", j.job_id)
        self._push(5.0, "tick", None)
        if self.stop_job_at is not None:
            self._push(self.stop_job_at[1], "stop_job", self.stop_job_at[0])
        for t, kind, sid in self.chaos_events:
            self._push(t, "chaos", (kind, sid))
        while self._events:
            t, _, kind, payload = heapq.heappop(self._events)
            if t > max_time:
                break
            self.now = t
            if kind == "job_start":
                self._step_idx[payload] = 0
                self._start_step(payload)
            elif kind == "compute_done":
                jid = payload
                if jid in self._stopped:
                    continue
                self._step_trace[jid].append(self.now)
                self._step_idx[jid] += 1
                self._start_step(jid)
            elif kind == "pump":
                self._pump()
            elif kind == "transfer_done":
                self._on_transfer_done(*payload)
            elif kind == "tick":
                self.client.tick(self.now)
                if self.trace_alloc:
                    self._sample_alloc()
                if len(self._done) + len(self._stopped) < len(self._jobs):
                    self._push(self.now + 5.0, "tick", None)
            elif kind == "stop_job":
                self._stopped.add(payload)
            elif kind == "chaos":
                self._strike(*payload)
            elif kind == "probe":
                payload(self)
        jct = {jid: t - self._jobs[jid].submit_time
               for jid, t in self._done.items()}
        if self._chaos is not None:       # never leave a worker wedged
            self._chaos.resume_all()
        util = self.link.busy_time / max(1e-9, self.now)
        reb = getattr(self.engine, "global_rebalancer", None)
        # remote mode: the daemon owns the kernel — ask over the wire
        # (best-effort: the trace may end with the daemon still away)
        src = self.client if self._remote else self.engine
        try:
            hit_ratio, stats = src.hit_ratio(), src.snapshot()
        except ConnectionError:         # incl. DaemonUnavailableError
            hit_ratio, stats = -1.0, {}
        return SimResult(jct=jct, hit_ratio=hit_ratio,
                         stats=stats, makespan=self.now,
                         link_utilization=util, step_trace=self._step_trace,
                         alloc_trace=self._alloc_trace,
                         chaos_log=self._chaos_log,
                         rebalance_trace=(list(reb.round_log)
                                          if reb is not None else []),
                         tier_stats=(self._tier.tier_stats()
                                     if self._tier is not None else {}),
                         link_bytes=self.link.bytes_moved)

    def _strike(self, kind: str, sid: int) -> None:
        if self._chaos is None:
            from .chaos import ChaosMonkey
            driver_like = (hasattr(self.engine, "_channels")
                           and hasattr(self.engine, "_kill_worker"))
            if driver_like or not (self.chaos_clients
                                   or self.chaos_daemon is not None):
                # preserves the TypeError for worker strikes against an
                # in-process engine with no other victims either
                self._chaos = ChaosMonkey(self.engine,
                                          clients=self.chaos_clients,
                                          daemon=self.chaos_daemon)
            else:
                self._chaos = ChaosMonkey(None,
                                          clients=self.chaos_clients,
                                          daemon=self.chaos_daemon)
        self._chaos.strike(kind, sid)
        self._chaos_log.append({"t": self.now, "kind": kind, "sid": sid})

    # ----------------------------------------------------------------- steps
    def _start_step(self, jid: int) -> None:
        if jid in self._stopped:
            return
        job = self._jobs[jid]
        i = self._step_idx[jid]
        if i >= len(job.steps):
            self._done[jid] = self.now
            return
        compute, reqs = job.steps[i]
        waits = 0
        local_cost = 0.0
        # batched client path: one kernel call per step batch (tick cadence
        # amortized per batch); the client hands each outcome's prefetch
        # candidates to the LinkExecutor, which puts them on the link at
        # background priority.  The sim then settles the demand blocks.
        results = self.client.read_batch(reqs, self.now)
        for res in results:
            for blk in res.blocks:
                if blk.hit:
                    local_cost += self.local_latency + blk.size / self.local_bw
                    if self.link.pending(blk.key):
                        # bytes still in flight (admitted at miss/prefetch
                        # issue time) — single-flight: wait on that transfer
                        self.link.promote(blk.key)
                        self._waiters.setdefault(blk.key, []).append(jid)
                        waits += 1
                else:
                    if self.link.pending(blk.key):
                        self.link.promote(blk.key)
                    elif self._tier is not None and \
                            self._tier.sim_read(blk.key, blk.size):
                        # spill-tier hit: the block is on local disk —
                        # serve it at disk cost, no link transfer
                        local_cost += (self.disk_latency
                                       + blk.size / self.disk_bw)
                        continue
                    else:
                        self.link.enqueue(blk.size, blk.key, demand=True,
                                          callback=None)
                    self._waiters.setdefault(blk.key, []).append(jid)
                    waits += 1
        self._outstanding[jid] = waits
        self._pump()
        if waits == 0:
            self._push(self.now + compute + local_cost, "compute_done", jid)
        else:
            # stash compute duration; applied when last byte lands
            self._pending_compute = getattr(self, "_pending_compute", {})
            self._pending_compute[jid] = compute + local_cost

    def _pump(self) -> None:
        while True:
            got = self.link.pump(self.now)
            if got is None:
                break
            finish, t = got
            self._push(finish, "transfer_done", (t.key, t.demand, t.callback))
            # link frees (busy end) possibly before 'finish' due to latency
            self._push(self.link.free_at, "pump", None)

    def _on_transfer_done(self, key: str, demand: bool, callback) -> None:
        if callback is not None:
            ppath, psize = callback
            self.client.complete_prefetch(ppath, psize, self.now)
        for jid in self._waiters.pop(key, ()):  # wake demand waiters
            if jid in self._stopped:
                continue
            self._outstanding[jid] -= 1
            if self._outstanding[jid] == 0:
                compute = self._pending_compute.pop(jid, 0.0)
                self._push(self.now + compute, "compute_done", jid)
        self._pump()

    # ----------------------------------------------------------------- traces
    def _sample_alloc(self) -> None:
        row = {"t": self.now}
        for path, cmu in self.engine.iter_workload_cmus():
            est = marginal_benefit(cmu, self.now, self.engine.cfg)
            row["/".join(path)] = {"quota": cmu.quota, "used": cmu.used,
                                   "benefit": est.benefit}
        self._alloc_trace.append(row)
