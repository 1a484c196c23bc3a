"""Cache space allocation (§3.3 "Cache Allocation Optimization" + §4).

The marginal benefit metric B quantifies the remote-transmission reduction per
unit time obtained by granting one more unit of cache to a stream:

  * sequential: B = 0                       (never re-read)
  * random:     B = 1 / (q * n)             (q = inter-access gap, n = blocks;
                                             each block re-read once per epoch
                                             of length q*n — multiple jobs on
                                             the same dataset shrink q)
  * skewed:     B = lambda * f_bufferhit/w  (ghost "BufferWindow" of the last
                                             w evicted blocks; hits there are
                                             the misses one more w-block grant
                                             would have saved)

The rebalancer runs in rounds (60 s): one ``rebalance_quantum`` (640 MB) moves
from the minimum-B donor to the maximum-B recipient with unmet demand; every
stream keeps ``min_share``.  Quiver- and Fluid-style allocators are provided
as §5.4 baselines.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, TYPE_CHECKING

from .types import CacheConfig, Pattern

if TYPE_CHECKING:  # pragma: no cover
    from .cache import CacheManageUnit


class BufferWindow:
    """Ghost cache of recently-evicted blocks (§3.3), LRU, max w entries.

    ``hits``/``probes`` are per-round counters reset by the owning pool's
    rebalance round; ``total_hits``/``total_probes`` accumulate for the
    pool's lifetime so an *outside* observer (the cross-shard
    GlobalRebalancer, whose round phase is independent of each shard's
    read-triggered local rounds) can measure hit frequency over its own
    interval via deltas instead of inheriting whatever reset phase the
    local round left behind.
    """

    def __init__(self, w: int) -> None:
        self.w = max(1, w)
        self._ghost: "OrderedDict[str, None]" = OrderedDict()
        self.hits = 0
        self.probes = 0
        self.total_hits = 0
        self.total_probes = 0
        # optional ghost-hit sink (core.sketch.DemandSketch.note): the
        # pool wires every CMU's window into its per-shard demand sketch
        # so the cross-shard round can size unmet working sets
        self.sink: Optional[Callable[[str], None]] = None

    def on_evict(self, key: str) -> None:
        self._ghost[key] = None
        self._ghost.move_to_end(key)
        while len(self._ghost) > self.w:
            self._ghost.popitem(last=False)

    def probe(self, key: str) -> bool:
        """Called on every cache miss; True = the miss was ghost-avoidable."""
        self.probes += 1
        self.total_probes += 1
        if key in self._ghost:
            self.hits += 1
            self.total_hits += 1
            del self._ghost[key]
            if self.sink is not None:
                self.sink(key)
            return True
        return False

    def hit_frequency(self) -> float:
        return self.hits / self.probes if self.probes else 0.0

    def reset_window(self) -> None:
        self.hits = 0
        self.probes = 0


@dataclass
class DemandEstimate:
    benefit: float          # B
    wants_more: bool        # has unmet demand at current quota
    can_shrink: bool        # above min share


def marginal_benefit(cmu: "CacheManageUnit", now: float, cfg: CacheConfig) -> DemandEstimate:
    """Compute B for one CacheManageUnit (pattern-dependent, §3.3)."""
    pat = cmu.effective_pattern()
    can_shrink = cmu.quota - cfg.min_share >= cfg.rebalance_quantum
    if pat is Pattern.SEQUENTIAL:
        return DemandEstimate(0.0, False, can_shrink)
    if pat is Pattern.RANDOM:
        q = cmu.mean_access_gap(now)
        # n = number of access units in the dataset (files for small-file
        # sets, blocks for big-file sets) — estimated from the observed mean
        # access size; one epoch re-touches each unit once, t = q * n.
        n_units = max(1, cmu.dataset_bytes // cmu.mean_access_size())
        if q is None or q <= 0:
            return DemandEstimate(0.0, cmu.quota < cmu.dataset_bytes, can_shrink)
        b = 1.0 / (q * n_units)
        return DemandEstimate(b, cmu.quota < cmu.dataset_bytes, can_shrink)
    if pat is Pattern.SKEWED:
        lam = cmu.arrival_rate(now)
        f = cmu.buffer_window.hit_frequency()
        b = lam * f / cmu.buffer_window.w
        return DemandEstimate(b, f > 0.0, can_shrink)
    # UNKNOWN: neutral small benefit proportional to recent activity.
    lam = cmu.arrival_rate(now)
    return DemandEstimate(1e-9 * lam, cmu.used >= 0.95 * cmu.quota, can_shrink)


@dataclass(frozen=True)
class PlacementHint:
    """Where one stream's blocks belong in a RAM/disk tier hierarchy
    (consumed by ``storage.tiers.TieredStore`` via ``note_pattern``)."""

    pattern: Pattern
    pin_ram: bool           # hot working set: keep RAM-resident (sticky)


def placement_hint(cmu: "CacheManageUnit", now: float,
                   cfg: CacheConfig) -> PlacementHint:
    """Tier placement verdict for one stream, from the same classifier
    state that drives allocation: SKEWED hot sets pin in RAM; a RANDOM
    set that *fits* its quota is worth pinning too (uniform residency);
    SEQUENTIAL/UNKNOWN data is never worth displacing RAM blocks —
    sequential extents are disk-eligible and stream from the spill tier.
    """
    pat = cmu.effective_pattern()
    if pat is Pattern.SKEWED:
        return PlacementHint(pat, True)
    if pat is Pattern.RANDOM:
        return PlacementHint(pat, cmu.dataset_bytes <= cmu.quota)
    return PlacementHint(pat, False)


class Rebalancer:
    """IGTCache's round-based quota shifting (§4)."""

    def __init__(self, cfg: CacheConfig) -> None:
        self.cfg = cfg
        self.last_round = 0.0

    def due(self, now: float) -> bool:
        return now - self.last_round >= self.cfg.rebalance_period

    # a taker must beat the donor by this factor (ping-pong damping)
    HYSTERESIS = 1.25

    def clears_hysteresis(self, donor_benefit: float,
                          taker_benefit: float) -> bool:
        """The taker must beat the donor by the damping factor."""
        return taker_benefit > max(donor_benefit * self.HYSTERESIS,
                                   donor_benefit + 1e-12)

    def pick_move(self, est: Dict["CacheManageUnit", DemandEstimate],
                  donors: List["CacheManageUnit"],
                  takers: List["CacheManageUnit"]) -> Optional[tuple]:
        """The paper's greedy rule for one quantum move: max-B taker with
        unmet demand ← min-B shrinkable donor, damped by hysteresis.
        Returns (donor, taker, bytes) or None when benefits have crossed.
        Shared by the per-pool round below and the cross-shard
        GlobalRebalancer (core.sharded)."""
        if not donors or not takers:
            return None
        donor = min(donors, key=lambda c: est[c].benefit)
        taker = max(takers, key=lambda c: est[c].benefit)
        if donor is taker or not self.clears_hysteresis(est[donor].benefit,
                                                        est[taker].benefit):
            return None
        amt = min(self.cfg.rebalance_quantum,
                  donor.quota - self.cfg.min_share)
        if amt <= 0:
            return None
        return donor, taker, amt

    def rebalance(self, cmus: List["CacheManageUnit"], now: float,
                  max_moves: Optional[int] = None) -> List[tuple]:
        """One round: shift quanta from min-B donors to max-B takers until
        benefits cross (with hysteresis) or the per-round move budget is hit.
        Returns the list of (donor, taker, bytes) moves."""
        self.last_round = now
        moves: List[tuple] = []
        if len(cmus) < 2:
            for c in cmus:
                c.buffer_window.reset_window()
            return moves
        if max_moves is None:
            max_moves = len(cmus)
        est = {c: marginal_benefit(c, now, self.cfg) for c in cmus}
        # Greedy max-B ← min-B quantum moves (the paper's rule), several per
        # round so convergence keeps pace with job lifetimes.
        for _ in range(max_moves):
            donors = [c for c in cmus if est[c].can_shrink]
            takers = [c for c in cmus if est[c].wants_more]
            got = self.pick_move(est, donors, takers)
            if got is None:
                break
            donor, taker, amt = got
            donor.set_quota(donor.quota - amt)
            taker.set_quota(taker.quota + amt)
            moves.append((donor, taker, amt))
            est[donor] = marginal_benefit(donor, now, self.cfg)
            est[taker] = marginal_benefit(taker, now, self.cfg)
        for c in cmus:
            c.buffer_window.reset_window()
        return moves

    def seed(self, newcomer: "CacheManageUnit",
             cmus: List["CacheManageUnit"]) -> None:
        """A newly promoted stream immediately receives its minimum share
        from the lowest-benefit donors (late arrivals must not starve until
        the next round)."""
        while newcomer.quota < self.cfg.min_share:
            donors = [c for c in cmus
                      if c is not newcomer
                      and c.quota - self.cfg.min_share >= self.cfg.rebalance_quantum]
            if not donors:
                break
            est = {c: marginal_benefit(c, 0.0, self.cfg) for c in donors}
            donor = min(donors, key=lambda c: est[c].benefit)
            amt = min(self.cfg.rebalance_quantum,
                      donor.quota - self.cfg.min_share,
                      self.cfg.min_share - newcomer.quota)
            if amt <= 0:
                break
            donor.set_quota(donor.quota - amt)
            newcomer.set_quota(newcomer.quota + amt)


# ---------------------------------------------------------------------------
# Baseline allocators (§5.4): Quiver-style and Fluid-style, extended to mixed
# workloads exactly as the paper's evaluation does.
# ---------------------------------------------------------------------------

class QuiverAllocator:
    """Quiver [49]-style: profile per-training-job benefit; split the space
    evenly between workload *types*, then give the training half to the
    highest-benefit training job (winner-take, per the paper's extension)."""

    def __init__(self, cfg: CacheConfig) -> None:
        self.cfg = cfg
        self.last_round = 0.0

    def due(self, now: float) -> bool:
        return now - self.last_round >= self.cfg.rebalance_period

    def rebalance(self, cmus: List["CacheManageUnit"], now: float,
                  capacity: int) -> None:
        self.last_round = now
        if not cmus:
            return
        training = [c for c in cmus if c.effective_pattern() is Pattern.RANDOM]
        other = [c for c in cmus if c not in training]
        half = capacity // 2
        if training:
            # benefit ~ data consumption rate / dataset size (Quiver's probe)
            best = max(training, key=lambda c: c.arrival_rate(now) /
                       max(1, c.dataset_bytes))
            for c in training:
                c.set_quota(self.cfg.min_share if c is not best else
                            max(self.cfg.min_share,
                                half - self.cfg.min_share * (len(training) - 1)))
        pool = capacity - sum(c.quota for c in training)
        if other:
            share = max(self.cfg.min_share, pool // len(other))
            for c in other:
                c.set_quota(share)


class FluidAllocator:
    """Fluid [40]-style: quota proportional to batch size (demand rate) for
    training jobs; query workloads share whatever training left unclaimed."""

    def __init__(self, cfg: CacheConfig) -> None:
        self.cfg = cfg
        self.last_round = 0.0

    def due(self, now: float) -> bool:
        return now - self.last_round >= self.cfg.rebalance_period

    def rebalance(self, cmus: List["CacheManageUnit"], now: float,
                  capacity: int) -> None:
        self.last_round = now
        training = [c for c in cmus if c.effective_pattern() is Pattern.RANDOM]
        other = [c for c in cmus if c not in training]
        rates = {c: max(1e-9, c.arrival_rate(now)) for c in training}
        total_rate = sum(rates.values())
        claimed = 0
        for c in training:
            q = (int(capacity * 0.7 * rates[c] / total_rate)
                 if total_rate > 0 else self.cfg.min_share)
            q = max(self.cfg.min_share, min(q, c.dataset_bytes))
            c.set_quota(q)
            claimed += q
        pool = max(0, capacity - claimed)
        if other:
            share = max(self.cfg.min_share, pool // len(other))
            for c in other:
                c.set_quota(share)
