"""AccessStreamTree (§3.1): hierarchical organization of recent accesses.

Each node is an *AccessStream*: the set of accesses sharing the node's path
prefix.  A node records, in a bounded observation window, which of its
children each passing access descended into (``index`` = the child's listing
position, ``total`` = the listing size c).  Once a node has observed
``window`` accesses it becomes *non-trivial* and pattern analysis (§3.2) runs
at that level; it re-runs every ``reanalyze_every`` accesses so a stream that
changes behaviour (e.g. warm-up scan then random epochs) is re-classified
promptly.

Overhead controls (§4):
  * layer compression — interior levels with a one-entry listing store no
    records; nodes materialize only down to the deepest informative level;
  * child pruning — a non-trivial node keeps at most ``window`` child nodes,
    discarding the least-recently-touched;
  * node cap — a global LRU bound (default 10 000) on tree nodes; childless
    nodes are detached first, found in O(1) via a dedicated leaf LRU;
  * observation windows are NumPy ring buffers (no per-access allocation),
    and analysis is vectorized (``pattern.classify_batch``) over every due
    window in one matrix pass;
  * repeated walks down an unchanged path are replayed from an
    ``ObservedChain`` (built once per file by the engine) without any
    dict-walk of the tree — the batched read path of §4.

Per-access update cost is O(depth); the tree never exceeds ``node_cap``
nodes (property-tested).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from .pattern import (PatternResult, classify_batch, fit_adaptive_ttl_arr,
                      fit_adaptive_ttl_batch)
from .types import AccessRecord, CacheConfig, PathT, Pattern

_INT64 = np.int64
_F64 = np.float64


def ring_chrono(buf: list, pos: int, count: int, cap: int) -> list:
    """Chronological view of a ring buffer backed by a plain list.

    Invariant shared by every ring in this codebase (AccessStream windows,
    CacheManageUnit.flat ring): the buffer only wraps once full, so
    ``count < cap`` implies the data is the contiguous prefix ``buf[:count]``
    and ``count == cap`` implies the oldest entry sits at ``pos``.
    """
    if count < cap:
        return buf[:count]
    if pos == 0:
        return buf
    return buf[pos:] + buf[:pos]


class AccessStream:
    """One node of the AccessStreamTree.

    The observation window is a fixed-size ring: ``_idx``/``_tim`` hold the
    last ``window`` (item-index, timestamp) pairs in arrival order starting
    at ``_pos`` (once wrapped); ``_keys`` carries the child keys for the
    sliding ``child_hits`` profile used by hierarchical prefetching.
    """

    __slots__ = (
        "key", "path", "parent", "children", "total",
        "accesses", "pattern", "last_analyzed_at", "last_access_time",
        "ttl", "child_hits", "distinct_children", "depth", "detached",
        "_win", "_cap", "_idx", "_tim", "_keys", "_pos", "count",
        "last_index",
    )

    def __init__(self, key: str, path: PathT, parent: Optional["AccessStream"],
                 window: int) -> None:
        self.key = key
        self.path = path
        self.parent = parent
        self.children: "OrderedDict[str, AccessStream]" = OrderedDict()
        self.total = 0              # listing size c at this level
        self.accesses = 0
        self.pattern = PatternResult(Pattern.UNKNOWN)
        self.last_analyzed_at = 0
        self.last_access_time = 0.0
        self.ttl: Optional[float] = None
        # child_key -> number of window accesses that touched it (for the
        # vertical/hot-child statistics of hierarchical prefetching, §3.3).
        self.child_hits: dict = {}
        self.distinct_children = 0
        self.depth = len(path)
        self.detached = False
        # Observation-window ring buffers.  Stored as plain Python lists —
        # a scalar store into a list is ~10× cheaper than into an ndarray,
        # and the window only becomes an ndarray at analysis time
        # (window_indices/window_times), amortized over reanalyze_every
        # accesses.  The ring starts small and doubles up to ``window``:
        # most tree nodes (leaf-side file nodes) see only a handful of
        # accesses before being pruned, so pre-allocating the full window
        # per node would waste both the allocation and the memory.
        self._win = window
        cap = 8 if window > 8 else window
        self._cap = cap
        self._idx: List[int] = [0] * cap
        self._tim: List[float] = [0.0] * cap
        self._keys: List[Optional[str]] = [None] * cap
        self._pos = 0               # next write slot
        self.count = 0              # live entries (<= window)
        self.last_index = -1

    # -- observation window --------------------------------------------------
    def record_raw(self, index: int, total: int, time: float,
                   child_key: str) -> None:
        """Append one access to the ring (the hot-path form of record())."""
        if total > self.total:
            self.total = total
        pos = self._pos
        ch = self.child_hits
        if self.count == self._cap:
            if self._cap < self._win:
                pos = self._grow()
            else:
                old = self._keys[pos]
                h = ch.get(old)
                if h is not None:
                    if h <= 1:
                        del ch[old]
                    else:
                        ch[old] = h - 1
                self.count -= 1
        self.count += 1
        self._idx[pos] = index
        self._tim[pos] = time
        self._keys[pos] = child_key
        self._pos = 0 if pos + 1 == self._cap else pos + 1
        ch[child_key] = ch.get(child_key, 0) + 1
        self.accesses += 1
        self.last_access_time = time
        self.last_index = index

    def _grow(self) -> int:
        """Double the ring capacity (called with the ring exactly full, so
        the buffer is already in chronological order with _pos == 0)."""
        ncap = self._cap * 2
        if ncap > self._win:
            ncap = self._win
        extra = ncap - self._cap
        self._idx.extend([0] * extra)
        self._tim.extend([0.0] * extra)
        self._keys.extend([None] * extra)
        self._pos = self._cap
        self._cap = ncap
        return self._pos

    def record(self, rec: AccessRecord) -> None:
        """Compatibility wrapper over :meth:`record_raw`."""
        self.record_raw(rec.index, rec.total, rec.time, rec.child_key)

    def ring_memory_bytes(self) -> int:
        """Approximate heap bytes held by this node's observation window."""
        import sys
        return (sys.getsizeof(self._idx) + sys.getsizeof(self._tim)
                + sys.getsizeof(self._keys) + 56 * self.count)

    def window_indices(self) -> np.ndarray:
        """Window item indices in chronological order (fresh ndarray)."""
        return np.array(ring_chrono(self._idx, self._pos, self.count,
                                    self._cap), dtype=_INT64)

    def window_times(self) -> np.ndarray:
        """Window timestamps in chronological order (fresh ndarray)."""
        return np.array(ring_chrono(self._tim, self._pos, self.count,
                                    self._cap), dtype=_F64)

    def window_records(self) -> List[AccessRecord]:
        """Materialize the window as AccessRecords (reference/debug path)."""
        idx, tim = self.window_indices(), self.window_times()
        keys = ring_chrono(self._keys, self._pos, self.count, self._cap)
        return [AccessRecord(index=int(i), total=self.total, time=float(t),
                             child_key=k or "")
                for i, t, k in zip(idx, tim, keys)]

    # -- classification ------------------------------------------------------
    def non_trivial(self, cfg: CacheConfig) -> bool:
        return self.accesses >= cfg.window

    def analysis_due(self, cfg: CacheConfig) -> bool:
        return (self.accesses >= cfg.window
                and (self.pattern.pattern is Pattern.UNKNOWN
                     or self.accesses - self.last_analyzed_at
                     >= cfg.reanalyze_every))

    _TTL_UNSET = object()      # sentinel: fit here (solo path) vs batched

    def apply_analysis(self, result: PatternResult, cfg: CacheConfig,
                       ttl=_TTL_UNSET) -> None:
        """Install a (re)classification result.  RANDOM streams get an
        adaptive TTL — fitted here on the solo path, or passed in by
        :func:`analyze_streams`, which fits every random node of the batch
        in one ``fit_adaptive_ttl_batch`` matrix pass (§4)."""
        self.pattern = result
        self.last_analyzed_at = self.accesses
        if result.pattern is Pattern.RANDOM:
            if ttl is self._TTL_UNSET:
                ttl = fit_adaptive_ttl_arr(self.window_times(), cfg)
            self.ttl = ttl

    def analyze(self, cfg: CacheConfig) -> PatternResult:
        res = classify_batch([(self.window_indices(), self.total)], cfg)[0]
        self.apply_analysis(res, cfg)
        return self.pattern

    def maybe_analyze(self, cfg: CacheConfig) -> Optional[PatternResult]:
        if self.analysis_due(cfg):
            return self.analyze(cfg)
        return None

    def hot_children(self, f_p: float) -> List[str]:
        """Children whose in-window access frequency f = x/n >= f_p (§3.3)."""
        n = self.count
        if n == 0:
            return []
        return [k for k, x in self.child_hits.items() if x / n >= f_p]

    def __repr__(self) -> str:  # pragma: no cover
        return (f"AccessStream({'/'.join(self.path) or '<root>'}, "
                f"acc={self.accesses}, pat={self.pattern.pattern.value})")


def analyze_streams(nodes: List[AccessStream], cfg: CacheConfig) -> None:
    """Vectorized (re)analysis of every due node in one matrix pass (§4):
    one ``classify_batch`` call for the labels, then one
    ``fit_adaptive_ttl_batch`` call fitting the adaptive TTL of every node
    that classified RANDOM (previously a per-node fit)."""
    if not nodes:
        return
    results = classify_batch([(n.window_indices(), n.total) for n in nodes],
                             cfg)
    rand_nodes = [n for n, res in zip(nodes, results)
                  if res.pattern is Pattern.RANDOM]
    ttls = iter(fit_adaptive_ttl_batch(
        [n.window_times() for n in rand_nodes], cfg)) if rand_nodes else None
    for n, res in zip(nodes, results):
        if res.pattern is Pattern.RANDOM:
            n.apply_analysis(res, cfg, ttl=next(ttls))
        else:
            n.apply_analysis(res, cfg)


class ObservedChain:
    """A replayable root→file walk for one file path (§4 batched read path).

    Built once by :meth:`AccessStreamTree.build_chain`; every later access to
    any block of the file replays it without touching the children dicts:
    record at the informative nodes, refresh the LRU positions, done.  The
    chain is invalidated (``valid()`` False) as soon as any involved node is
    detached by child pruning or the node cap.

    ``steps`` is one flattened entry per walked level:
    ``(node, index, total, child_key, mchildren, mkey)`` — ``index >= 0``
    means the level is informative and ``node`` records (index, total,
    child_key); ``index < 0`` means trivial (touch only).  ``mchildren``
    is the parent's children OrderedDict to refresh (``mkey`` moved to MRU),
    or None at the level the walk stops on.
    """

    __slots__ = ("steps", "cnodes", "leaf_node", "leaf_total", "final_node",
                 "tail_path", "check_nodes")

    def __init__(self) -> None:
        self.steps: List[Tuple] = []
        self.cnodes: List[AccessStream] = []        # child chain, root-side first
        self.leaf_node: Optional[AccessStream] = None  # records block level
        self.leaf_total = 1
        self.final_node: Optional[AccessStream] = None
        self.tail_path: Optional[PathT] = None      # deepest child's path
        self.check_nodes: List[AccessStream] = []

    def valid(self) -> bool:
        for n in self.check_nodes:
            if n.detached:
                return False
        return True


class AccessStreamTree:
    """The tree + global node accounting (§3.1, §4)."""

    def __init__(self, cfg: Optional[CacheConfig] = None) -> None:
        self.cfg = cfg or CacheConfig()
        self.root = AccessStream("", (), None, self.cfg.window)
        # Registry of all non-root nodes (plain dict — insertion order only)
        # plus an LRU of *childless* nodes so cap enforcement finds its
        # least-recently-touched leaf victim in O(1) instead of scanning the
        # whole registry (the seed's accidental quadratic).  Interior nodes
        # need no recency order: they are never victims while they have
        # children, so only the leaf LRU is refreshed per access.
        self._lru: Dict[PathT, AccessStream] = {}
        self._leaf_lru: "OrderedDict[PathT, AccessStream]" = OrderedDict()

    # -- observation ---------------------------------------------------------
    def observe(self, levels: Iterable[Tuple[str, int, int]], time: float,
                size: int = 0) -> List[AccessStream]:
        """Insert one leaf access (reference per-access path).

        ``levels`` is the root-to-leaf decomposition of the access:
        ``(child_key, child_index, level_total)`` per level — e.g. for
        ``ImageNet/train/n014/4716.JPEG`` block 0:
        ``[("ImageNet", 3, 10), ("train", 0, 1), ("n014", 17, 1000),
        ("4716.JPEG", 561, 1300), ("#0", 0, 1)]``.

        Layer compression (§4), generalized: a level with a single-entry
        listing (total <= 1) carries no pattern information, so it is not
        recorded; nodes are only materialized down to the deepest level that
        still has informative structure below it.  A 1-block file in a flat
        directory therefore costs ZERO nodes beyond its parent directory —
        the directory node's observation window carries the file-level
        pattern.

        Returns the list of nodes (root-side first) that recorded the access.
        """
        levels = list(levels)
        # deepest level with an informative (>1 entry) listing
        last_informative = -1
        for d, (_, _, total) in enumerate(levels):
            if total > 1:
                last_informative = d
        node = self.root
        touched: List[AccessStream] = []
        due: List[AccessStream] = []
        for d, (child_key, index, total) in enumerate(levels):
            if total > 1:
                node.record_raw(index, total, time, child_key)
                if node.analysis_due(self.cfg):
                    due.append(node)
                touched.append(node)
            else:
                node.last_access_time = time
            if d >= last_informative:
                break  # nothing informative below — stop materializing
            child = node.children.get(child_key)
            if child is None:
                child = self._create_child(node, child_key)
            else:
                node.children.move_to_end(child_key)
                if child.path in self._leaf_lru:
                    self._leaf_lru.move_to_end(child.path)
            node = child
        node.last_access_time = time
        analyze_streams(due, self.cfg)
        return touched

    def _create_child(self, node: AccessStream, child_key: str) -> AccessStream:
        child = AccessStream(child_key, node.path + (child_key,), node,
                             self.cfg.window)
        if not node.children and node.parent is not None:
            self._leaf_lru.pop(node.path, None)   # parent is a leaf no more
        node.children[child_key] = child
        self._lru[child.path] = child
        self._leaf_lru[child.path] = child
        self._prune_children(node)
        self._enforce_node_cap()
        return child

    # -- batched read path (§4) ----------------------------------------------
    def build_chain(self, dir_levels: Tuple[Tuple[str, int, int], ...],
                    nblocks: int) -> ObservedChain:
        """Walk (and materialize) the path once, returning a replayable chain.

        ``dir_levels`` is the (name, index, total) decomposition of the FILE
        path; the block level (total = ``nblocks``) is handled separately so
        one chain serves every block of the file.  The walk itself records
        nothing — the caller replays the chain for each observed block.
        """
        L = len(dir_levels)
        last_informative = -1
        for d, (_, _, total) in enumerate(dir_levels):
            if total > 1:
                last_informative = d
        if nblocks > 1:
            last_informative = L
        chain = ObservedChain()
        node = self.root
        for d in range(L + 1):
            if d == L:
                # block level: recorded at the deepest materialized node
                if nblocks > 1:
                    chain.leaf_node = node
                    chain.leaf_total = nblocks
                break
            child_key, index, total = dir_levels[d]
            if d >= last_informative:
                chain.steps.append((node, index if total > 1 else -1, total,
                                    child_key, None, None))
                break
            child = node.children.get(child_key)
            if child is None:
                child = self._create_child(node, child_key)
            chain.steps.append((node, index if total > 1 else -1, total,
                                child_key, node.children, child_key))
            chain.cnodes.append(child)
            node = child
        chain.final_node = node
        if chain.cnodes:
            chain.tail_path = chain.cnodes[-1].path
        # every non-root node the chain touches IS a chain child (rec/touch
        # nodes at depth d are the root or cnodes[d-1]), so validity reduces
        # to the child chain
        chain.check_nodes = chain.cnodes
        return chain

    def replay_chain(self, chain: ObservedChain, block: int, time: float,
                     due_out: List[AccessStream]) -> None:
        """One access through a valid chain: records + LRU refresh only.

        Mutation-for-mutation identical to :meth:`observe` on the same
        (existing) path; appends any node whose analysis is now due to
        ``due_out`` (the caller batch-classifies them via analyze_streams).
        """
        cfg = self.cfg
        window, reanalyze = cfg.window, cfg.reanalyze_every
        unknown = Pattern.UNKNOWN
        for node, index, total, child_key, mchildren, mkey in chain.steps:
            if index >= 0:
                node.record_raw(index, total, time, child_key)
                acc = node.accesses
                if acc >= window and (node.pattern.pattern is unknown
                                      or acc - node.last_analyzed_at
                                      >= reanalyze):
                    due_out.append(node)
            else:
                node.last_access_time = time
            if mchildren is not None:
                mchildren.move_to_end(mkey)
        leaf = chain.leaf_node
        if leaf is not None:
            leaf.record_raw(block, chain.leaf_total, time, f"#{block}")
            acc = leaf.accesses
            if acc >= window and (leaf.pattern.pattern is unknown
                                  or acc - leaf.last_analyzed_at >= reanalyze):
                due_out.append(leaf)
        tail = chain.tail_path
        if tail is not None:
            # only the deepest chain node can be childless (interior chain
            # nodes hold the next chain node as a child while the chain is
            # valid), so a single leaf-LRU refresh suffices
            leaf_lru = self._leaf_lru
            if tail in leaf_lru:
                leaf_lru.move_to_end(tail)
        chain.final_node.last_access_time = time

    # -- overhead control ----------------------------------------------------
    def _prune_children(self, node: AccessStream) -> None:
        """Child pruning (§4): bound children of a non-trivial node."""
        limit = self.cfg.window
        while len(node.children) > limit:
            old_key, old_child = node.children.popitem(last=False)
            self._detach_subtree(old_child)

    def _detach_subtree(self, node: AccessStream) -> None:
        self._lru.pop(node.path, None)
        self._leaf_lru.pop(node.path, None)
        node.detached = True
        for child in node.children.values():
            self._detach_subtree(child)
        node.children.clear()
        node.parent = None

    def _enforce_node_cap(self) -> None:
        while len(self._lru) > self.cfg.node_cap:
            if self._leaf_lru:
                _, victim = next(iter(self._leaf_lru.items()))
            else:  # degenerate: no childless node tracked — evict oldest
                _, victim = next(iter(self._lru.items()))
            self._lru.pop(victim.path, None)
            self._leaf_lru.pop(victim.path, None)
            victim.detached = True
            parent = victim.parent
            if parent is not None:
                parent.children.pop(victim.key, None)
                victim.parent = None
                if not parent.children and parent.parent is not None \
                        and parent.path in self._lru:
                    self._leaf_lru[parent.path] = parent

    # -- queries --------------------------------------------------------------
    def node_count(self) -> int:
        return len(self._lru)

    def find(self, path: PathT) -> Optional[AccessStream]:
        node = self.root
        for comp in path:
            node = node.children.get(comp)
            if node is None:
                return None
        return node

    def iter_nodes(self):
        yield from self._lru.values()

    def shallowest_non_trivial(self, path: PathT) -> Optional[AccessStream]:
        """First non-trivial node on the root→path walk (the CMU anchor)."""
        node = self.root
        for comp in path:
            child = node.children.get(comp)
            if child is None:
                break
            if child.non_trivial(self.cfg):
                return child
            node = child
        return None

    def deepest_informative(self, path: PathT) -> Optional[AccessStream]:
        """Deepest non-trivial node with a classified pattern along the path.

        This is the level whose pattern governs policy for accesses under it
        (e.g. block level inside a large file, file level inside a dataset
        directory) — 'depending on where a non-trivial data access pattern
        exists' (§3.3).
        """
        node = self.root
        best: Optional[AccessStream] = None
        for comp in path:
            child = node.children.get(comp)
            if child is None:
                break
            if (child.non_trivial(self.cfg)
                    and child.pattern.pattern is not Pattern.UNKNOWN):
                best = child
            node = child
        return best
