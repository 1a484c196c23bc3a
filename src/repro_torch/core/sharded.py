"""Path-hash sharded engine behind a unified facade (scaling PR).

The paper's engine is one Python state machine; every access of every job
serializes through it.  ``ShardedIGTCache`` splits the *observe/recognize*
hot path into N independent ``IGTCache`` shards — each with its own
AccessStreamTree, chain/ctx caches, LevelCache and ``UnifiedCache``
partition — while keeping *space allocation* cluster-wide, the split Hoard
(arXiv:1812.00669) uses for distributed DL caches (shard by key, global
placement view).

Routing granularity: the **top-level path component** (the dataset root).
A whole dataset maps to one shard, so every AccessStream — directory
levels, file level, block level, and the CMU's flattened dataset-granular
window — observes exactly the accesses it would observe unsharded:
recognition state is bitwise-identical per dataset, and sharding only
partitions *capacity*.  That skew (a hot random dataset stuck in a
quarter-capacity shard next to sequential streams that need nothing) is
what the cross-shard ``GlobalRebalancer`` repairs: it merges per-CMU
``marginal_benefit`` estimates across shards and moves quota *and the
backing shard capacity* from the cluster-wide minimum-benefit donor to the
maximum-benefit taker, so the paper's skew-aware space allocation (§4.3)
still operates over the whole cache.

``ShardedIGTCache(n_shards=1)`` is bitwise-identical to ``IGTCache`` on
any trace (tests/test_equivalence.py pins this): one shard holds the full
capacity, every call forwards to it, and the global layer stays inert.
"""
from __future__ import annotations

import math
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

from .allocation import DemandEstimate, Rebalancer, marginal_benefit
from .cache import CacheManageUnit, path_key
from .igtcache import EngineOptions, IGTCache, ReadOutcome
from .meta import StoreMeta
from .sketch import CountMinSketch, SpaceSaving
from .types import CacheConfig, CacheStats, PathT, Pattern


def shard_index(path: PathT, n_shards: int) -> int:
    """Deterministic shard for a path: CRC-32 of the top-level component.

    Stable across processes and runs (unlike the salted builtin ``hash``),
    so the same path always lands on the same shard — the routing invariant
    tests/test_sharded.py pins.
    """
    if n_shards <= 1:
        return 0
    top = path[0] if path else ""
    return zlib.crc32(top.encode("utf-8")) % n_shards


class ShardRouting:
    """Memoized path → shard routing, shared by every shard driver.

    The CRC-32 of the top-level component is computed **once per
    dataset**: routing for every subsequent access of that dataset is a
    single dict lookup (datasets are few; the memo is unbounded by
    design).  Both the in-process ``ShardedIGTCache`` facade and the
    multi-process ``core.procdriver.ProcessShardedCache`` inherit this,
    so the two drivers cannot drift on placement — a path routes to the
    same shard index under either."""

    def _init_routing(self, n_shards: int) -> None:
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = n_shards
        # top-level component -> shard id (memoized CRC-32)
        self._route: Dict[str, int] = {}

    def shard_id(self, path: PathT) -> int:
        if self.n_shards == 1:
            return 0
        top = path[0] if path else ""
        sid = self._route.get(top)
        if sid is None:
            sid = shard_index(path, self.n_shards)
            self._route[top] = sid
        return sid

    def bucket_by_shard(self, items: Sequence,
                        path_of=None) -> Dict[int, List[tuple]]:
        """Group indexed items by owning shard:
        ``{sid: [(original_index, item), ...]}`` — the one split-and-
        reassemble-in-order primitive every batched fan-out uses (both
        drivers' ``read_batch``, both executors' ``fetch_demand``), so
        ordering/empty-bucket edge cases cannot drift between copies.
        ``path_of`` extracts the routing path (default: ``item[0]``,
        the shape of read requests and range requests)."""
        buckets: Dict[int, List[tuple]] = {}
        if path_of is None:
            for i, item in enumerate(items):
                buckets.setdefault(self.shard_id(item[0]), []).append(
                    (i, item))
        else:
            for i, item in enumerate(items):
                buckets.setdefault(self.shard_id(path_of(item)), []).append(
                    (i, item))
        return buckets


@dataclass
class DemandSummary:
    """One CMU's demand estimate, serialized for the cross-shard
    allocation round.

    This is the wire format of the rebalance-summary protocol: worker
    processes ship these rows to the driver instead of live
    ``CacheManageUnit`` objects, and the in-process facade builds the
    same rows from its shards, so both drivers run the identical greedy
    rule (``GlobalRebalancer.plan_moves``).  ``demand_limit`` carries
    enough state to re-evaluate ``wants_more`` after a mid-round quota
    move (RANDOM streams stop wanting at ``dataset_bytes``); patterns
    whose demand does not depend on quota leave it ``None``.

    ``want``/``floor``/``free`` are the adaptive planner's sizing
    fields (``quantum_policy="adaptive"``): ``want`` is the measured
    unmet demand in bytes (sketch-derived for SKEWED streams), ``floor``
    the pattern-aware minimum quota below which the stream starves, and
    ``free`` the bytes the CMU could donate without evicting anything.
    The fixed-quantum planner ignores them.
    """

    shard: int                 # owning shard index
    key: PathT                 # CMU root path (unique within its shard)
    benefit: float             # marginal benefit B (quota-independent)
    wants_more: bool           # unmet demand at current quota
    can_take: bool             # workload CMU; shard defaults only donate
    quota: int
    headroom: int              # donatable bytes (see tracker._row)
    demand_limit: Optional[float] = None   # wants_more := quota < limit
    want: int = 0              # unmet demand, bytes (adaptive sizing)
    floor: int = 0             # pattern-aware minimum quota
    free: int = 0              # quota - used (donatable without eviction)


# Rough per-row wire cost (fixed fields as packed ints/floats + framing);
# used only for the summary-bytes accounting in rebalance stats.
_ROW_OVERHEAD = 64


@dataclass
class ShardSummary:
    """One shard's complete demand summary for a cross-shard round.

    Exact :class:`DemandSummary` rows are shipped only for the shard's
    default CMU plus the top ``cfg.topk`` workload CMUs (ranked by
    unmet demand + donatable headroom); the remainder is aggregated
    into the ``tail_*`` counters, and the per-block heat detail rides
    in the two O(KB) sketch payloads (``core.sketch``).  Total payload
    is therefore bounded regardless of how many CMUs or distinct
    blocks the shard serves.
    """

    shard: int
    rows: List[DemandSummary] = field(default_factory=list)
    n_cmus: int = 0            # workload CMUs on the shard
    tail_cmus: int = 0         # workload CMUs beyond the exact-row cap
    tail_quota: int = 0
    tail_want: int = 0
    ghost_mass: int = 0        # ghost hits folded this interval
    cms_payload: bytes = b""   # serialized CountMinSketch (block heat)
    topk_payload: bytes = b""  # serialized SpaceSaving (heavy hitters)

    def payload_bytes(self) -> int:
        rows_cost = sum(len("/".join(r.key)) + _ROW_OVERHEAD
                        for r in self.rows)
        return (len(self.cms_payload) + len(self.topk_payload)
                + rows_cost + 48)


class GlobalRebalancer(Rebalancer):
    """Cross-shard space allocation: the paper's greedy max-B ← min-B rule
    over the *merged* CMU population of all shards.

    Within a shard, the per-shard ``Rebalancer`` (inside each ``IGTCache``
    tick) already shifts quota between co-located CMUs; this layer handles
    the moves those rounds cannot see — donor and taker living in
    *different* shards.  A cross-shard move shifts both the CMU quota and
    the backing pool capacity (``UnifiedCache.adjust_capacity``), so total
    capacity is conserved and every shard keeps ``sum(quota) == capacity``.

    Ghost-window coherence: shard-local rounds fire on each shard's own
    read-triggered tick cadence and reset the per-round BufferWindow
    counters, so at global-round time the windows of different shards span
    different (phase-dependent) intervals.  SKEWED demand is therefore
    measured from the windows' *cumulative* counters as a delta over this
    layer's own round interval — every CMU is compared over the same span
    of simulated time regardless of local reset phase.  The other patterns'
    benefits don't read the per-round window, so ``marginal_benefit`` is
    used as-is.
    """

    def __init__(self, cfg: CacheConfig) -> None:
        super().__init__(cfg)
        self.tracker = ShardDemandTracker(cfg)
        # (donor rkey, taker rkey) pairs of the previous round — the
        # adaptive planner refuses to reverse a fresh flow (ping-pong
        # damping beyond scalar hysteresis, needed once moves are
        # demand-sized rather than one-quantum)
        self._flow: set = set()
        # per-round stats, newest last (bounded); SimResult surfaces these
        self.round_log: List[dict] = []
        self.last_stats: Optional[dict] = None
        # cluster-wide heat view merged from the shards' shipped sketches
        self.cluster_heat: Optional[CountMinSketch] = None
        self.cluster_hot: Optional[SpaceSaving] = None

    def _estimate(self, cmu: CacheManageUnit, now: float) -> DemandEstimate:
        return self.tracker.estimate(cmu, now)

    def plan_moves(self, rows: Sequence[DemandSummary],
                   max_moves: Optional[int] = None
                   ) -> List[Tuple[DemandSummary, DemandSummary, int]]:
        """Plan one cross-shard round over serialized demand rows — pure
        planning, no engine access.  Both drivers run this: the
        in-process facade applies the returned moves to live CMUs, the
        process driver ships them to workers as quota/capacity deltas.
        Rows are mutated in place (quota, headroom, ``want``,
        ``wants_more`` via ``demand_limit``) so successive moves see
        the post-move state, exactly like a live-object round would.

        ``cfg.quantum_policy`` selects the planner: ``"adaptive"``
        (default) sizes each move by the taker's measured unmet demand
        with pattern-aware floors; ``"fixed"`` is the legacy
        one-quantum-per-move greedy loop, kept verbatim for comparison
        (the ``rebalance_path`` benchmark axis measures both)."""
        if self.cfg.quantum_policy == "fixed":
            return self._plan_moves_fixed(rows, max_moves)
        return self._plan_moves_adaptive(rows, max_moves)

    def _plan_moves_fixed(self, rows: Sequence[DemandSummary],
                          max_moves: Optional[int] = None
                          ) -> List[Tuple[DemandSummary, DemandSummary, int]]:
        """The paper's greedy max-B ← min-B rule, one quantum per move."""
        moves: List[Tuple[DemandSummary, DemandSummary, int]] = []
        if not rows or len({r.shard for r in rows}) < 2:
            return moves
        if max_moves is None:
            max_moves = len(rows)
        quantum = self.cfg.rebalance_quantum
        for _ in range(max_moves):
            takers = [r for r in rows if r.can_take and r.wants_more]
            if not takers:
                break
            taker = max(takers, key=lambda r: r.benefit)
            # donors restricted to OTHER shards: co-located pairs are the
            # shard-local rebalancer's job
            donors = [r for r in rows
                      if r.headroom >= quantum and r.shard != taker.shard]
            if not donors:
                break
            donor = min(donors, key=lambda r: r.benefit)
            if not self.clears_hysteresis(donor.benefit, taker.benefit):
                break
            amt = min(quantum, donor.headroom)
            if amt <= 0:
                break
            for row, delta in ((donor, -amt), (taker, amt)):
                row.quota += delta
                row.headroom += delta
                if row.demand_limit is not None:
                    row.wants_more = row.quota < row.demand_limit
            moves.append((donor, taker, amt))
        return moves

    def _plan_moves_adaptive(self, rows: Sequence[DemandSummary],
                             max_moves: Optional[int] = None
                             ) -> List[Tuple[DemandSummary, DemandSummary,
                                             int]]:
        """Demand-sized planning: two phases.

        Phase 1 (floor top-up, hysteresis-exempt): any workload CMU
        below its pattern floor is starving — born after the shard
        defaults drained, or an active sequential stream squeezed below
        its prefetch window — and is topped up from the lowest-benefit
        donors regardless of benefit ordering.  Retried every round, so
        a top-up that finds no donor today succeeds when capacity
        frees up (one-shot seeding provably strands CMUs).

        Phase 2 (want-sized moves): the greedy max-B ← min-B rule, but
        each move carries ``min(taker.want, donor budget)`` instead of
        one fixed quantum, so convergence no longer needs O(gap/quantum)
        rounds as shard count grows.  A donor's budget is its free
        (unused) bytes plus a forced-eviction allowance that scales
        with the benefit gap and shard count and vanishes near
        convergence — the adaptive quantum.  Fresh donor→taker flows
        from the previous round must not reverse this round (cooldown),
        which replaces the one-quantum loop's implicit damping."""
        moves: List[Tuple[DemandSummary, DemandSummary, int]] = []
        shard_ids = {r.shard for r in rows}
        if not rows or len(shard_ids) < 2:
            return moves
        if max_moves is None:
            max_moves = 4 * len(rows)
        min_share = self.cfg.min_share
        n_shards = len(shard_ids)
        base_q = self.cfg.rebalance_quantum
        prev_flow = self._flow
        flow: set = set()
        hot_spent: Dict[tuple, int] = {}

        def rk(r: DemandSummary) -> tuple:
            return (r.shard, tuple(r.key))

        def apply(donor: DemandSummary, taker: DemandSummary,
                  amt: int) -> None:
            for row, delta in ((donor, -amt), (taker, amt)):
                row.quota += delta
                row.headroom += delta
                if row.demand_limit is not None:
                    row.wants_more = row.quota < row.demand_limit
            donor.free = max(0, donor.free - amt)
            taker.want = max(0, taker.want - amt)
            flow.add((rk(donor), rk(taker)))
            moves.append((donor, taker, amt))

        def hot_room(donor: DemandSummary, taker: DemandSummary) -> int:
            # Forced-eviction (hot-byte) allowance for this donor: grows
            # with the donor/taker benefit gap and the shard count
            # (big imbalances at high n must close fast), shrinks to one
            # quantum near the hysteresis threshold.
            ratio = taker.benefit / max(donor.benefit, 1e-18)
            scale = max(1.0, min(
                4.0 * n_shards,
                n_shards * math.log2(max(1.0, ratio / self.HYSTERESIS))))
            cap = int(base_q * scale)
            return max(0, cap - hot_spent.get(rk(donor), 0))

        # ------------------------- phase 1: floor top-up ----------------
        for taker in sorted([r for r in rows if r.can_take],
                            key=lambda r: -r.benefit):
            guard = 0
            while taker.quota < taker.floor and guard < 64:
                guard += 1
                donors = [d for d in rows
                          if d.shard != taker.shard and d.headroom > 0
                          and (not d.can_take or d.quota > min_share)
                          and (rk(taker), rk(d)) not in flow]
                if not donors:
                    break
                donor = min(donors, key=lambda d: (d.benefit, -d.free))
                amt = min(taker.floor - taker.quota, donor.headroom)
                if amt <= 0:
                    break
                apply(donor, taker, amt)

        # ------------------------- phase 2: want-sized moves ------------
        for _ in range(max_moves - len(moves)):
            takers = [r for r in rows if r.can_take and r.want > 0]
            if not takers:
                break
            progressed = False
            for taker in sorted(takers, key=lambda r: -r.benefit):
                cands = []
                for d in rows:
                    if d.shard == taker.shard or d.headroom <= 0:
                        continue
                    if not self.clears_hysteresis(d.benefit, taker.benefit):
                        continue
                    if ((rk(taker), rk(d)) in prev_flow
                            or (rk(taker), rk(d)) in flow):
                        continue      # would reverse a fresh flow
                    avail = min(d.headroom, d.free + hot_room(d, taker))
                    if avail > 0:
                        cands.append((d, avail))
                if not cands:
                    continue
                donor, avail = min(cands,
                                   key=lambda e: (e[0].benefit, -e[1]))
                amt = min(taker.want, avail)
                if amt <= 0:
                    continue
                hot = max(0, amt - donor.free)
                if hot:
                    hot_spent[rk(donor)] = hot_spent.get(rk(donor), 0) + hot
                apply(donor, taker, amt)
                progressed = True
                break
            if not progressed:
                break
        self._flow = flow
        return moves

    def note_round(self, now: float, summaries: Sequence[ShardSummary],
                   moves: Sequence[tuple]) -> dict:
        """Record per-round stats and merge the shards' shipped sketches
        into the cluster-wide heat view.  Both drivers call this once
        per round; ``sim.cluster`` surfaces ``round_log`` as the
        ``rebalance_trace``."""
        heat: Optional[CountMinSketch] = None
        hot: Optional[SpaceSaving] = None
        for s in summaries:
            if s.cms_payload:
                c = CountMinSketch.deserialize(s.cms_payload)
                heat = c if heat is None else heat.merge(c)
            if s.topk_payload:
                t = SpaceSaving.deserialize(s.topk_payload)
                hot = t if hot is None else hot.merge(t)
        self.cluster_heat, self.cluster_hot = heat, hot
        stat = {
            "t": now,
            "policy": self.cfg.quantum_policy,
            "moves": len(moves),
            "bytes_moved": int(sum(m[2] for m in moves)),
            "max_move": int(max((m[2] for m in moves), default=0)),
            "summary_bytes": int(sum(s.payload_bytes() for s in summaries)),
            "ghost_mass": int(sum(s.ghost_mass for s in summaries)),
            "hot_blocks": len(hot.counts) if hot is not None else 0,
        }
        self.last_stats = stat
        self.round_log.append(stat)
        if len(self.round_log) > 4096:
            del self.round_log[:len(self.round_log) - 4096]
        return stat

    def urgent(self, shards: Sequence[IGTCache]) -> bool:
        """True when some workload CMU sits below its minimum share — a
        stream created after the defaults drained would otherwise wait a
        full period with zero quota (adaptive policy only)."""
        if self.cfg.quantum_policy == "fixed":
            return False
        for eng in shards:
            for _, c in eng.iter_workload_cmus():
                if c.quota < self.cfg.min_share:
                    return True
        return False

    def urgent_due(self, now: float, shards: Sequence[IGTCache]) -> bool:
        """Rate-limited starvation trigger: an early round may fire at
        most every period/4 (a starving CMU with no donors anywhere must
        not force a round per tick)."""
        if now - self.last_round < max(1.0, self.cfg.rebalance_period / 4):
            return False
        return self.urgent(shards)

    def rebalance_shards(self, shards: Sequence[IGTCache], now: float,
                         max_moves: Optional[int] = None) -> List[tuple]:
        """In-process round: summarize each shard (the same rows a worker
        would ship), plan with the shared greedy rule, apply to the live
        engines.  A cross-shard move shifts CMU quota and backing pool
        capacity together, so total capacity is conserved and every
        shard keeps ``sum(quota) == capacity``.

        The facade plans over the full row set (it holds the live
        objects anyway); the process driver plans over the wire
        summaries' capped rows.  The cap only binds past ``cfg.topk``
        workload CMUs per shard, where the tail carries negligible
        weight by construction."""
        self.last_round = now
        rows: List[DemandSummary] = []
        live: List[CacheManageUnit] = []     # rows[i] describes live[i]
        owner: List[IGTCache] = []
        summaries: List[ShardSummary] = []
        for sid, eng in enumerate(shards):
            for row, cmu in self.tracker.summarize(eng, sid, now,
                                                   mark=False):
                rows.append(row)
                live.append(cmu)
                owner.append(eng)
            got = self.tracker.summaries.get(sid)
            if got is not None:
                summaries.append(got)
        self.tracker.mark_all(live)
        index = {id(r): i for i, r in enumerate(rows)}
        moves: List[tuple] = []
        if len(shards) < 2:
            self.note_round(now, summaries, moves)
            return moves
        for d_row, t_row, amt in self.plan_moves(rows, max_moves):
            donor, taker = live[index[id(d_row)]], live[index[id(t_row)]]
            d_eng, t_eng = owner[index[id(d_row)]], owner[index[id(t_row)]]
            donor.set_quota(donor.quota - amt)
            d_eng.cache.adjust_capacity(-amt)
            t_eng.cache.adjust_capacity(amt)
            taker.set_quota(taker.quota + amt)
            moves.append((donor, taker, amt))
        self.note_round(now, summaries, moves)
        return moves


class ShardDemandTracker:
    """Per-shard demand summarization for the cross-shard round.

    Lives next to the engine it measures: in-process the facade's
    ``GlobalRebalancer`` holds one for all shards; under the process
    driver each worker holds its own and ships the rows over the pipe
    (the ``rebalance_summary`` command).  SKEWED demand is measured from
    the BufferWindows' *cumulative* counters as deltas over this
    tracker's own round interval — shard-local rounds reset the
    per-round counters on their own read-triggered phase, so the
    cumulative delta is the only phase-independent signal (see
    ``allocation.BufferWindow``)."""

    def __init__(self, cfg: CacheConfig) -> None:
        self.cfg = cfg
        # cmu -> (total_hits, total_probes) at the end of our last round
        self._ghost_mark: Dict[CacheManageUnit, Tuple[int, int]] = {}
        # cmu -> EMA-smoothed benefit (adaptive policy only): want-sized
        # moves amplify one noisy interval into a large transfer, so the
        # planner sees a half-life-one-round smoothed B instead
        self._ema: Dict[CacheManageUnit, float] = {}
        # sid -> last wire summary built by summarize()
        self.summaries: Dict[int, ShardSummary] = {}

    def estimate(self, cmu: CacheManageUnit, now: float) -> DemandEstimate:
        est = marginal_benefit(cmu, now, self.cfg)
        if cmu.effective_pattern() is Pattern.SKEWED:
            bw = cmu.buffer_window
            th, tp = self._ghost_mark.get(cmu, (0, 0))
            dh, dp = bw.total_hits - th, bw.total_probes - tp
            f = dh / dp if dp else 0.0
            est = DemandEstimate(cmu.arrival_rate(now) * f / bw.w,
                                 dh > 0, est.can_shrink)
        if self.cfg.quantum_policy != "fixed":
            prev = self._ema.get(cmu)
            b = est.benefit if prev is None else 0.5 * prev + 0.5 * est.benefit
            self._ema[cmu] = b
            est = DemandEstimate(b, est.wants_more, est.can_shrink)
        return est

    def _row(self, cmu: CacheManageUnit, sid: int, now: float,
             can_take: bool, sketch=None) -> DemandSummary:
        est = self.estimate(cmu, now)
        limit: Optional[float] = None
        pat = cmu.effective_pattern()
        min_share = self.cfg.min_share
        if pat is Pattern.RANDOM:
            limit = float(cmu.dataset_bytes)
        elif pat is Pattern.UNKNOWN and can_take:
            # wants_more was `used >= 0.95 * quota` — express as a quota
            # threshold so mid-round moves re-evaluate it
            limit = cmu.used / 0.95 if cmu.used else 0.0
        # ---- adaptive sizing: want / floor / free ----------------------
        want = 0
        floor = min_share
        if can_take:
            if pat is Pattern.RANDOM:
                # insatiable below the dataset (paper §3.3)
                want = max(0, cmu.dataset_bytes - cmu.quota)
            elif pat is Pattern.SKEWED:
                # unmet working set = distinct ghost-hit blocks this
                # interval: tracked heavy hitters exactly (SpaceSaving
                # lower bounds), the cold tail upper-bounded by the
                # unattributed ghost-hit mass (>= 1 hit per block)
                th, _tp = self._ghost_mark.get(cmu, (0, 0))
                dh = cmu.buffer_window.total_hits - th
                if dh > 0:
                    distinct = dh
                    if sketch is not None and sketch.cms.total > 0:
                        head, head_mass = sketch.distinct_under(
                            path_key(cmu.root_path) + "/")
                        distinct = head + max(0, dh - head_mass)
                    want = distinct * self.cfg.block_size
            elif pat is Pattern.UNKNOWN:
                if cmu.used >= 0.95 * cmu.quota:
                    want = max(0, int(cmu.used / 0.95) - cmu.quota)
            else:       # SEQUENTIAL: wants nothing beyond its prefetch
                # window, but squeezing an *active* stream below that
                # window thrashes the readahead (issue → evict before
                # access), so the floor covers it
                if cmu.arrival_rate(now) > 1e-3:
                    floor = max(min_share, self.cfg.prefetch_budget_bytes)
            if cmu.dataset_bytes:
                want = min(want, max(0, cmu.dataset_bytes - cmu.quota))
                floor = min(floor, cmu.dataset_bytes)
        if can_take or self.cfg.quantum_policy == "fixed":
            headroom = cmu.quota - min_share
        else:
            # zero-floor defaults (adaptive): a shard default exists to
            # lend capacity, reserving min_share on every one of N
            # shards locks away N×min_share the workload CMUs need
            headroom = cmu.quota
        return DemandSummary(
            shard=sid, key=cmu.root_path, benefit=est.benefit,
            wants_more=est.wants_more, can_take=can_take, quota=cmu.quota,
            headroom=headroom, demand_limit=limit, want=int(want),
            floor=int(floor), free=max(0, cmu.quota - cmu.used))

    def summarize(self, eng: IGTCache, sid: int, now: float,
                  mark: bool = True
                  ) -> List[Tuple[DemandSummary, CacheManageUnit]]:
        """Demand rows for one shard, plus the wire :class:`ShardSummary`
        (stashed in ``self.summaries[sid]``).

        The shard's *default* CMU is included as a donor-only row
        (``can_take=False``): a shard whose datasets happen to be
        all-sequential — or that drew no dataset at all — must not hold
        1/N of the cluster capacity hostage.  Mirrors the shard-local
        round, which also passes the default CMU as a donor.

        One demand-sketch measurement interval spans one call: the
        sketch is folded, read for the rows, serialized into the wire
        summary, then reset.

        ``mark=True`` (the single-shard / worker-resident case) advances
        the ghost marks to now; a tracker measuring several shards must
        pass ``mark=False`` per shard and call :meth:`mark_all` once
        with every shard's CMUs — marking per shard would reset the
        other shards' intervals early."""
        sketch = getattr(eng.cache, "demand_sketch", None)
        if sketch is not None:
            sketch.fold()
        pairs: List[Tuple[DemandSummary, CacheManageUnit]] = []
        for c in eng.workload_cmus():
            pairs.append((self._row(c, sid, now, True, sketch), c))
        d = eng.cache.default_cmu
        pairs.append((self._row(d, sid, now, False, sketch), d))
        self.summaries[sid] = self._wire(sid, [r for r, _ in pairs], sketch)
        if sketch is not None:
            sketch.reset()
        if mark:
            self.mark_all(c for _, c in pairs)
        return pairs

    def _wire(self, sid: int, rows: List[DemandSummary],
              sketch) -> ShardSummary:
        """Bounded wire summary: default row + top-k workload rows by
        demand weight, tail aggregated, sketches serialized."""
        work = [r for r in rows if r.can_take]
        work.sort(key=lambda r: -(r.want + max(0, r.headroom)))
        keep, tail = work[:self.cfg.topk], work[self.cfg.topk:]
        return ShardSummary(
            shard=sid,
            rows=[r for r in rows if not r.can_take] + keep,
            n_cmus=len(work),
            tail_cmus=len(tail),
            tail_quota=sum(r.quota for r in tail),
            tail_want=sum(r.want for r in tail),
            ghost_mass=sketch.noted if sketch is not None else 0,
            cms_payload=(sketch.cms.serialize()
                         if sketch is not None and sketch.cms.total else b""),
            topk_payload=(sketch.topk.serialize()
                          if sketch is not None and sketch.topk.counts
                          else b""))

    def mark_all(self, cmus) -> None:
        """Start the next measurement interval at the current cumulative
        ghost counters.  Marks (and benefit EMAs) of CMUs no longer
        summarized — TTL-removed or evicted since last round — are
        pruned in the same pass, so the tables stay bounded by the live
        CMU population without rebuilding the dict every round."""
        marks = self._ghost_mark
        seen = set()
        for c in cmus:
            marks[c] = (c.buffer_window.total_hits,
                        c.buffer_window.total_probes)
            seen.add(id(c))
        stale = [c for c in marks if id(c) not in seen]
        for c in stale:
            del marks[c]
            self._ema.pop(c, None)


def split_capacity(capacity: int, n_shards: int) -> List[int]:
    """Initial per-shard capacity partition (both drivers use this)."""
    base, rem = divmod(capacity, n_shards)
    return [base + (1 if i < rem else 0) for i in range(n_shards)]


class ShardedIGTCache(ShardRouting):
    """N path-hash ``IGTCache`` shards behind the engine's public API.

    Exactly the surface callers use — ``read``, ``read_batch``,
    ``read_serial``, ``complete_prefetch``, ``cancel_prefetch``, ``pin``,
    ``never_cache``, ``tick``, ``stats``, ``hit_ratio``, ``snapshot`` —
    so the cluster simulator, the training pipeline and the baselines run
    sharded without knowing it.
    """

    def __init__(self, meta: StoreMeta, capacity: int,
                 cfg: Optional[CacheConfig] = None,
                 options: Optional[EngineOptions] = None,
                 n_shards: int = 1) -> None:
        self._init_routing(n_shards)
        self.meta = meta
        self.cfg = cfg or CacheConfig()
        self.options = options or EngineOptions()
        self.capacity = capacity
        self.shards: List[IGTCache] = [
            IGTCache(meta, cap, cfg=self.cfg, options=self.options)
            for cap in split_capacity(capacity, n_shards)
        ]
        self.global_rebalancer = GlobalRebalancer(self.cfg)

    # ------------------------------------------------------------- routing
    def shard_for(self, path: PathT) -> IGTCache:
        return self.shards[self.shard_id(path)]

    # ------------------------------------------------------------ user API
    def pin(self, path: PathT) -> None:
        for s in self.shards:          # prefix may be shorter than the
            s.pin(path)                # routing key — broadcast is exact

    def never_cache(self, path: PathT) -> None:
        for s in self.shards:
            s.never_cache(path)

    def invalidate_meta_cache(self) -> None:
        for s in self.shards:
            s.invalidate_meta_cache()

    # ------------------------------------------------------------------ read
    def read(self, file_path: PathT, offset: int, size: int,
             now: float) -> ReadOutcome:
        return self.shard_for(file_path).read(file_path, offset, size, now)

    def read_serial(self, file_path: PathT, offset: int, size: int,
                    now: float) -> ReadOutcome:
        return self.shard_for(file_path).read_serial(file_path, offset,
                                                     size, now)

    def read_batch(self, requests: Sequence[Tuple[PathT, int, int]],
                   now: float) -> List[ReadOutcome]:
        """Split the batch by shard, serve each sub-batch on its shard
        (tick cadence amortized per shard, as in the unsharded engine),
        and reassemble outcomes in the original request order."""
        if self.n_shards == 1:
            return self.shards[0].read_batch(requests, now)
        buckets = self.bucket_by_shard(requests)
        outs: List[Optional[ReadOutcome]] = [None] * len(requests)
        for sid, items in buckets.items():
            got = self.shards[sid].read_batch([r for _, r in items], now)
            for (i, _), out in zip(items, got):
                outs[i] = out
        return outs  # type: ignore[return-value]

    # ------------------------------------------------------------- prefetch
    def complete_prefetch(self, path: PathT, size: int, now: float) -> bool:
        return self.shard_for(path).complete_prefetch(path, size, now)

    def cancel_prefetch(self, path: PathT) -> None:
        self.shard_for(path).cancel_prefetch(path)

    # ------------------------------------------------------------------ tick
    def tick(self, now: float) -> None:
        """Per-shard maintenance plus, when due, the cross-shard allocation
        round.  The global layer is phase-independent of the shards'
        read-triggered local rounds: SKEWED demand is measured from
        cumulative ghost counters over the global round's own interval
        (see GlobalRebalancer), so ordering here is not load-bearing."""
        if self.n_shards > 1 and self.options.allocation == "adaptive":
            gr = self.global_rebalancer
            if gr.due(now) or gr.urgent_due(now, self.shards):
                gr.rebalance_shards(self.shards, now)
        for s in self.shards:
            s.tick(now)

    # ----------------------------------------------------------------- stats
    @property
    def stats(self) -> CacheStats:
        """Point-in-time merge of the shards' counters.

        Unlike ``IGTCache.stats`` this is a *snapshot*, not the live
        counter object — re-read the property for fresh values.  The
        semantic is deliberately identical at every shard count (a live
        view would only be possible at ``n_shards == 1``)."""
        return CacheStats.merged(s.stats for s in self.shards)

    def hit_ratio(self) -> float:
        return self.stats.hit_ratio

    def used_bytes(self) -> int:
        return sum(s.cache.used_bytes() for s in self.shards)

    def node_count(self) -> int:
        return sum(s.tree.node_count() for s in self.shards)

    def workload_cmus(self) -> List[CacheManageUnit]:
        return [c for s in self.shards for c in s.workload_cmus()]

    def iter_workload_cmus(self):
        for s in self.shards:
            yield from s.iter_workload_cmus()

    def shard_capacities(self) -> List[int]:
        return [s.cache.capacity for s in self.shards]

    def snapshot(self) -> dict:
        s = self.stats.snapshot()
        s["nodes"] = self.node_count()
        s["cmus"] = sum(len(sh.cache.cmus) - 1 for sh in self.shards)
        s["used_bytes"] = self.used_bytes()
        return s

    # ---------------------------------------------------------- warm restart
    def warm_state(self) -> dict:
        """Cluster-wide warm-restart manifest: per-shard CMU/residency
        manifests merged (every key names its shard via path routing, so
        the merge loses nothing); pins/bans are broadcast state — any
        shard's copy is the full set."""
        states = [s.warm_state() for s in self.shards]
        merged = {"cmus": [], "resident": [], "verdicts": {},
                  "pins": states[0]["pins"],
                  "never_cache": states[0]["never_cache"]}
        for st in states:
            merged["cmus"].extend(st["cmus"])
            merged["resident"].extend(st["resident"])
            merged["verdicts"].update(st["verdicts"])
        return merged

    def warm_admit(self, state: dict, now: float) -> dict:
        """Route a merged manifest back onto the shards (the same
        path-hash routing reads use, so every entry lands on the shard
        that journaled it) and sum the restore counters."""
        per = [{"cmus": [], "resident": [], "verdicts": {},
                "pins": state.get("pins", ()),
                "never_cache": state.get("never_cache", ())}
               for _ in self.shards]
        for row in state.get("cmus", ()):
            per[self.shard_id(tuple(row["root"]))]["cmus"].append(row)
        for key, size in state.get("resident", ()):
            per[self.shard_id(tuple(key.split("/")))]["resident"].append(
                (key, size))
        for top, verdict in (state.get("verdicts") or {}).items():
            per[self.shard_id((str(top),))]["verdicts"][top] = verdict
        total: Dict[str, int] = {}
        for shard, st in zip(self.shards, per):
            got = shard.warm_admit(st, now)
            for k, v in got.items():
                total[k] = total.get(k, 0) + v
        # pins/bans were replayed once per shard; report the set size
        total["pins"] = len(state.get("pins", ()))
        return total


# Either engine satisfies the same public read/prefetch/tick/stats surface;
# callers (cluster sim, training pipeline, benchmarks) annotate with this.
Engine = Union[IGTCache, ShardedIGTCache]


def make_engine(meta: StoreMeta, capacity: int,
                cfg: Optional[CacheConfig] = None,
                options: Optional[EngineOptions] = None,
                n_shards: int = 1) -> Engine:
    """Engine constructor shared by sim/benchmarks/examples: the plain
    state machine for ``n_shards=1`` (zero facade overhead), the sharded
    facade otherwise."""
    if n_shards == 1:
        return IGTCache(meta, capacity, cfg=cfg, options=options)
    return ShardedIGTCache(meta, capacity, cfg=cfg, options=options,
                           n_shards=n_shards)
