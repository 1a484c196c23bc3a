"""The IGTCache engine (§3, §4): observe → recognize → adapt.

This is the **kernel layer** of the two-layer public API (docs/API.md):
one object drives the full read path:

    outcome = engine.read(file_path, offset, size, now)

``outcome`` reports, per 4 MB block, whether it was served from cache, and
carries the prefetch candidates the engine wants fetched in the background.
The *caller* owns time and bandwidth: it fetches misses/prefetches and
calls ``complete_prefetch`` when background bytes land (or
``cancel_prefetch`` for candidates it will never run — every candidate
must get one or the other).  This keeps the engine a pure, deterministic
state machine — the property-test surface.  Most consumers don't drive
the kernel by hand: the *client layer* (``core.client.CacheClient`` via
``open_cache``) owns the I/O contract and runs candidates on a pluggable
``PrefetchExecutor``; the discrete-event simulator plugs its shared-link
transport in as one of those executors.

Hot-path architecture (§4 overhead claim, Fig. 17):

  * ``read()`` is the *batched extent path*: the root→leaf level resolution
    is memoized per directory (``meta.LevelCache``), the tree walk is built
    once per file as a replayable ``ObservedChain`` and every block of the
    extent is observed by replaying it (no dict-walk), routing reuses the
    chain nodes instead of re-walking the tree, and ``tick()`` runs once per
    read instead of once per block;
  * ``read_serial()`` is the per-block reference path kept for
    cross-checking — tests/test_equivalence.py asserts both paths produce
    identical ReadOutcomes, stats and tree state on seeded mixed traces;
  * pattern analysis is vectorized: every observation window due for
    (re)classification is pushed through ``pattern.classify_batch`` in one
    matrix pass (K-S statistic, distinct-deficit z, sequential screen).

Baselines (§5) are the same engine with adaptivity switched off via
``EngineOptions`` — e.g. JuiceFS ≈ enhanced-stride readahead + one global LRU
pool + fixed TTL; see ``baselines.py`` for the named bundles.
"""
from __future__ import annotations

from collections import OrderedDict, defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .access_stream_tree import (AccessStream, AccessStreamTree,
                                 ObservedChain, analyze_streams)
from .allocation import (FluidAllocator, QuiverAllocator, Rebalancer,
                         placement_hint)
from .cache import (CacheManageUnit, SubStream, UnifiedCache, path_key)
from .eviction import EagerEviction
from .meta import LevelCache, StoreMeta
from .prefetch import (block_sequential_candidates, sequential_candidates,
                       statistical_candidates)
from .types import (CacheConfig, CacheStats, PathT, Pattern, block_key,
                    split_block_key)


@dataclass
class EngineOptions:
    """Feature switches; defaults = full IGTCache."""

    prefetch: str = "adaptive"     # adaptive|stride|enhanced_stride|sfp|none
    eviction: str = "adaptive"     # adaptive|lru|fifo|lfu|arc|sieve|uniform
    allocation: str = "adaptive"   # adaptive|shared|quiver|fluid|static
    static_fraction: float = 0.5   # for allocation == "static"
    fixed_ttl: Optional[float] = None
    name: str = "igtcache"


class BlockResult:
    """Per-block read result (slotted by hand — one is built per block on
    the hot path)."""

    __slots__ = ("key", "size", "hit", "prefetched_hit")

    def __init__(self, key: str, size: int, hit: bool,
                 prefetched_hit: bool = False) -> None:
        self.key = key
        self.size = size
        self.hit = hit
        self.prefetched_hit = prefetched_hit

    def __eq__(self, other) -> bool:
        return (isinstance(other, BlockResult)
                and self.key == other.key and self.size == other.size
                and self.hit == other.hit
                and self.prefetched_hit == other.prefetched_hit)

    def __reduce__(self):
        # positional-args reduce: ~3× cheaper than the generic slotted
        # __reduce_ex__ state dance — BlockResults cross the process
        # boundary in every multi-process-driver read_batch reply
        return (BlockResult, (self.key, self.size, self.hit,
                              self.prefetched_hit))

    def __repr__(self) -> str:  # pragma: no cover
        return (f"BlockResult({self.key!r}, {self.size}, hit={self.hit}, "
                f"pf={self.prefetched_hit})")


class ReadOutcome:
    __slots__ = ("blocks", "prefetches")

    def __init__(self, blocks: Optional[List[BlockResult]] = None,
                 prefetches: Optional[List[Tuple[PathT, int]]] = None) -> None:
        self.blocks = [] if blocks is None else blocks
        self.prefetches = [] if prefetches is None else prefetches

    def __reduce__(self):
        return (ReadOutcome, (self.blocks, self.prefetches))

    @property
    def remote_bytes(self) -> int:
        return sum(b.size for b in self.blocks if not b.hit)

    @property
    def cached_bytes(self) -> int:
        return sum(b.size for b in self.blocks if b.hit)


class _PrefixSet:
    """Pin/ban table with O(path-depth) membership (was an O(table) scan)."""

    __slots__ = ("_set", "_lens")

    def __init__(self) -> None:
        self._set: set = set()
        self._lens: Tuple[int, ...] = ()

    def add(self, prefix: PathT) -> None:
        self._set.add(prefix)
        self._lens = tuple(sorted({len(p) for p in self._set}))

    def covers(self, path: PathT) -> bool:
        s = self._set
        if not s:
            return False
        n = len(path)
        for length in self._lens:
            if length > n:
                break
            if path[:length] in s:
                return True
        return False

    def __len__(self) -> int:
        return len(self._set)

    def __iter__(self):
        return iter(self._set)


class _FileCtx:
    """Per-file read-path context: memoized geometry + replayable chain +
    generation-checked CMU resolution (§4 batched read path)."""

    __slots__ = ("file_path", "dir_levels", "fsize", "nblocks", "key_prefix",
                 "keys", "flat_start", "flat_total", "chain", "cmu",
                 "cmu_gen")

    _KEY_CACHE_MAX_BLOCKS = 512

    def __init__(self, file_path: PathT, dir_levels, fsize: int,
                 nblocks: int, key_prefix: str) -> None:
        self.file_path = file_path
        self.dir_levels = dir_levels
        self.fsize = fsize
        self.nblocks = nblocks
        self.key_prefix = key_prefix
        if nblocks <= self._KEY_CACHE_MAX_BLOCKS:
            if key_prefix:
                self.keys: Optional[Tuple[str, ...]] = tuple(
                    f"{key_prefix}/#{b}" for b in range(nblocks))
            else:
                self.keys = tuple(f"#{b}" for b in range(nblocks))
        else:
            self.keys = None
        self.flat_start = 0
        self.flat_total = -1           # -1 = not resolved yet
        self.chain: Optional[ObservedChain] = None
        self.cmu: Optional[CacheManageUnit] = None
        self.cmu_gen = -1


class IGTCache:
    def __init__(self, meta: StoreMeta, capacity: int,
                 cfg: Optional[CacheConfig] = None,
                 options: Optional[EngineOptions] = None) -> None:
        self.meta = meta
        self.cfg = cfg or CacheConfig()
        self.options = options or EngineOptions()
        self.tree = AccessStreamTree(self.cfg)
        self.cache = UnifiedCache(capacity, self.cfg)
        self.stats = self.cache.stats
        self._blocks = self.cache.blocks   # hot-path residency alias
        self.rebalancer = Rebalancer(self.cfg)
        self.quiver = QuiverAllocator(self.cfg)
        self.fluid = FluidAllocator(self.cfg)
        # memoized metadata resolution + per-file read contexts (§4)
        self.levels = LevelCache(meta)
        self._ctx_cache: "OrderedDict[PathT, _FileCtx]" = OrderedDict()
        self._ctx_cap = max(4 * self.cfg.node_cap, 4096)
        # prefetch bookkeeping
        self._pending_prefetch: set = set()
        self._prefetched_resident: set = set()
        self._node_last_prefetch_idx: Dict[PathT, int] = {}
        self._ra_depth: Dict[PathT, int] = {}
        # stride/enhanced-stride readahead state per file
        self._stride_state: Dict[PathT, Tuple[int, int, int]] = {}
        # SFP: file-level first-order Markov transitions per dataset
        self._sfp_prev: Dict[str, PathT] = {}
        self._sfp_trans: Dict[PathT, Dict[PathT, int]] = defaultdict(dict)
        self._last_ttl_sweep = 0.0
        # explicit user instructions (§3.3 footnote 8): path prefixes the
        # user pinned (never evict / never TTL) or banned (never cache)
        self._pinned = _PrefixSet()
        self._never_cache = _PrefixSet()
        # tiered-backing placement hooks (storage.tiers): a store exposing
        # note_evicted gets every kernel eviction (its spill signal), one
        # exposing note_pattern gets per-dataset placement verdicts from
        # tick().  Observation-only taps — kernel decisions never read
        # tier state, so a tiered stack stays bitwise-identical to flat.
        ev = getattr(meta, "note_evicted", None)
        if callable(ev):
            self.cache.evict_hook = ev
        self._placement_hook = getattr(meta, "note_pattern", None)
        self._placement_sent: Dict[str, Tuple[str, bool]] = {}

    # -------------------------------------------------------- user controls
    def pin(self, path: PathT) -> None:
        """Persistently cache everything under ``path`` (user override):
        exempt from TTL expiry and from allocation donation below its use."""
        self._pinned.add(path)

    def never_cache(self, path: PathT) -> None:
        """Never admit blocks under ``path`` (reads pass through)."""
        self._never_cache.add(path)

    def invalidate_meta_cache(self) -> None:
        """Call if the backing store re-registers datasets mid-run."""
        self.levels.invalidate()
        self._ctx_cache.clear()

    # ------------------------------------------------------------------ read
    def read(self, file_path: PathT, offset: int, size: int,
             now: float) -> ReadOutcome:
        """Batched extent read (§4): resolve once, observe by chain replay,
        route from the chain, tick once."""
        out = self._read_impl(file_path, offset, size, now)
        if out.blocks:
            self.tick(now)
        return out

    def _read_impl(self, file_path: PathT, offset: int, size: int,
                   now: float) -> ReadOutcome:
        out = ReadOutcome()
        ctx = self._file_ctx(file_path)
        size = max(0, min(size, ctx.fsize - offset))
        if size == 0:
            return out
        bs = self.cfg.block_size
        first, last = offset // bs, (offset + size - 1) // bs
        chain = ctx.chain
        ok = chain is not None
        if ok:
            for nd in chain.check_nodes:    # inlined chain.valid()
                if nd.detached:
                    ok = False
                    break
        if not ok:
            chain = self.tree.build_chain(ctx.dir_levels, ctx.nblocks)
            ctx.chain = chain
        if not chain.valid():
            # pathological: the build itself tripped the node cap onto this
            # very path — fall back to the reference per-block walk
            ctx.chain = None
            for b in range(first, last + 1):
                self._read_block(file_path, b, min(bs, ctx.fsize - b * bs),
                                 now, out)
        else:
            tree = self.tree
            cfg = self.cfg
            prefix = ctx.key_prefix
            keys = ctx.keys
            fsize = ctx.fsize
            due: List[AccessStream] = []
            for b in range(first, last + 1):
                bsize = min(bs, fsize - b * bs)
                del due[:]
                tree.replay_chain(chain, b, now, due)
                if due:
                    analyze_streams(due, cfg)
                cmu, sub, governing = self._route_chain(ctx, chain, b, now)
                if keys is not None:
                    key = keys[b]
                else:
                    key = f"{prefix}/#{b}" if prefix else f"#{b}"
                self._serve_block(file_path, key, bsize, cmu, sub,
                                  governing, now, out)
                cands = self._gen_prefetch_chain(ctx, chain, b, cmu,
                                                 governing, now)
                if cands:
                    out.prefetches.extend(cands)
        if self.options.prefetch == "sfp":
            self._sfp_observe(file_path, out, now)
        return out

    def read_batch(self, requests: Sequence[Tuple[PathT, int, int]],
                   now: float) -> List[ReadOutcome]:
        """Serve a batch of (file_path, offset, size) requests at one
        timestamp, running the tick/allocation cadence once for the batch."""
        outs = [self._read_impl(fp, off, sz, now)
                for fp, off, sz in requests]
        self.tick(now)
        return outs

    def read_serial(self, file_path: PathT, offset: int, size: int,
                    now: float) -> ReadOutcome:
        """Reference per-block read path (uncached walks; cross-checked
        against the batched read() by tests/test_equivalence.py)."""
        out = ReadOutcome()
        fsize = self.meta.file_size(file_path)
        size = max(0, min(size, fsize - offset))
        if size == 0:
            return out
        bs = self.cfg.block_size
        first, last = offset // bs, (offset + size - 1) // bs
        for b in range(first, last + 1):
            bsize = min(bs, fsize - b * bs)
            self._read_block(file_path, b, bsize, now, out)
        if self.options.prefetch == "sfp":
            self._sfp_observe(file_path, out, now)
        self.tick(now)
        return out

    def _read_block(self, file_path: PathT, b: int, bsize: int, now: float,
                    out: ReadOutcome) -> None:
        leaf_path = block_key(file_path, b)
        key = path_key(leaf_path)
        levels = self._resolve_levels(file_path, b)
        self.tree.observe(levels, now, bsize)
        cmu, sub, governing = self._route(file_path, leaf_path, now, b)
        self._serve_block(file_path, key, bsize, cmu, sub, governing, now,
                          out)
        out.prefetches.extend(self._gen_prefetch(file_path, leaf_path, cmu,
                                                 governing, now))

    def _serve_block(self, file_path: PathT, key: str, bsize: int,
                     cmu: CacheManageUnit, sub: SubStream,
                     governing: Optional[AccessStream], now: float,
                     out: ReadOutcome) -> None:
        """Hit/miss accounting + admission for one block (both read paths)."""
        cmu.note_access(now, bsize)
        if governing is not None and governing.ttl is not None:
            cmu.ttl = governing.ttl
        if self.options.fixed_ttl is not None:
            cmu.ttl = self.options.fixed_ttl

        stats = self.stats
        if key in self._blocks:
            stats.hits += 1
            cmu.hits += 1
            stats.bytes_from_cache += bsize
            pf_hit = key in self._prefetched_resident
            if pf_hit:
                self._prefetched_resident.discard(key)
                stats.prefetch_hits += 1
            cmu.on_hit(key)
            cmu.after_read(key)  # eager eviction for sequential streams
            out.blocks.append(BlockResult(key, bsize, True, pf_hit))
        else:
            stats.misses += 1
            cmu.misses += 1
            stats.bytes_from_remote += bsize
            cmu.on_miss(key, sub)
            # Eager (sequential) streams read demand misses *through* the
            # cache: the block is consumed on arrival, so admitting it would
            # only evict a useful readahead block (§3.3 eager eviction).
            banned = self._never_cache.covers(file_path)
            if not banned and not isinstance(sub.policy, EagerEviction):
                self.cache.insert_key(key, bsize, cmu, sub)
            out.blocks.append(BlockResult(key, bsize, False))

    # ------------------------------------------------------- path resolution
    def _file_ctx(self, file_path: PathT) -> _FileCtx:
        cache = self._ctx_cache
        ctx = cache.get(file_path)
        if ctx is None:
            fsize = self.meta.file_size(file_path)
            nblocks = max(1, -(-fsize // self.cfg.block_size))
            ctx = _FileCtx(file_path, self.levels.dir_levels(file_path),
                           fsize, nblocks, "/".join(file_path))
            cache[file_path] = ctx
            if len(cache) > self._ctx_cap:
                cache.popitem(last=False)
        return ctx

    def _resolve_levels(self, file_path: PathT, b: int):
        """Root-to-leaf (key, index, parent-listing-size); the tree applies
        layer compression internally (degenerate levels record nothing).
        Reference (uncached) form of the LevelCache resolution."""
        levels: List[Tuple[str, int, int]] = []
        for depth in range(len(file_path)):
            parent = file_path[:depth]
            name = file_path[depth]
            total = self.meta.listing_size(parent)
            idx = self.meta.child_index(parent, name)
            levels.append((name, idx, total))
        fsize = self.meta.file_size(file_path)
        nblocks = max(1, -(-fsize // self.cfg.block_size))
        levels.append((f"#{b}", b, nblocks))
        return levels

    # --------------------------------------------------------------- routing
    def _route(self, file_path: PathT, leaf_path: PathT, now: float,
               block: int):
        """Map an access to (CMU, SubStream, governing pattern node).

        Policy pattern precedence: the CMU's flattened dataset-granularity
        classification (when its window is full) overrides the per-level
        node pattern for RANDOM/SKEWED decisions — skew spread across few
        large files is only visible in the flat index space.  SEQUENTIAL
        detections at any level are kept (they carry the prefetch structure).
        """
        isolating = self.options.allocation != "shared"
        governing = self.tree.deepest_informative(leaf_path)
        if isolating:
            anchor = self.tree.shallowest_non_trivial(file_path)
            self._maybe_create_cmu(anchor, now)
        cmu = self.cache.cmu_for_path(leaf_path)
        flat = Pattern.UNKNOWN
        if cmu is not self.cache.default_cmu:
            # flat dataset-granularity view (meaningless for the default CMU,
            # which mixes unrelated datasets)
            ordinal, total = self.meta.flat_block_index(file_path, block)
            flat = cmu.note_flat(ordinal, total, now)
        return self._pick_substream(cmu, governing, flat)

    def _chain_governing(self, chain: ObservedChain) -> Optional[AccessStream]:
        """Deepest non-trivial classified chain node — the chain-scan form
        of ``tree.deepest_informative`` (shared by read and prefetch
        completion)."""
        W = self.cfg.window
        for n in reversed(chain.cnodes):
            if n.accesses >= W and n.pattern.pattern is not Pattern.UNKNOWN:
                return n
        return None

    def _resolve_ctx_cmu(self, ctx: _FileCtx) -> CacheManageUnit:
        """Per-file CMU resolution, cached until the CMU registry changes."""
        cache = self.cache
        if ctx.cmu is None or ctx.cmu_gen != cache.cmu_gen:
            ctx.cmu = cache.cmu_for_path(ctx.file_path)
            ctx.cmu_gen = cache.cmu_gen
        return ctx.cmu

    def _route_chain(self, ctx: _FileCtx, chain: ObservedChain, block: int,
                     now: float):
        """Chain-replay form of :meth:`_route`: the governing/anchor walks
        become scans over the (already resolved) chain nodes."""
        governing = self._chain_governing(chain)
        if self.options.allocation != "shared":
            W = self.cfg.window
            anchor = None
            for n in chain.cnodes:
                if n.accesses >= W:
                    anchor = n
                    break
            self._maybe_create_cmu(anchor, now)
        cmu = self._resolve_ctx_cmu(ctx)
        cache = self.cache
        flat = Pattern.UNKNOWN
        if cmu is not cache.default_cmu:
            if ctx.flat_total < 0:
                ctx.flat_start, ctx.flat_total = \
                    self.meta.flat_block_index(ctx.file_path, 0)
            flat = cmu.note_flat(ctx.flat_start + block, ctx.flat_total, now)
        return self._pick_substream(cmu, governing, flat)

    def _maybe_create_cmu(self, anchor: Optional[AccessStream],
                          now: float) -> None:
        if anchor is None or anchor.path in self.cache.cmus:
            return
        cmu = self.cache.create_cmu(
            anchor.path, self.meta.subtree_bytes(anchor.path), now)
        if self.options.allocation == "static":
            want = int(self.options.static_fraction *
                       max(1, cmu.dataset_bytes))
            self._set_static_quota(cmu, want)
        elif self.options.allocation == "adaptive":
            # late arrivals get their minimum share immediately
            self.rebalancer.seed(cmu, list(self.cache.cmus.values()))

    def _pick_substream(self, cmu: CacheManageUnit,
                        governing: Optional[AccessStream], flat: Pattern):
        pattern = Pattern.UNKNOWN
        gpath = cmu.root_path
        if governing is not None:
            pattern = governing.pattern.pattern
            gpath = governing.path
        if flat is not Pattern.UNKNOWN and pattern is not Pattern.SEQUENTIAL:
            pattern = flat
            gpath = cmu.root_path
        if self.options.eviction != "adaptive":
            sub = self._fixed_substream(cmu)
        else:
            sub = cmu.substream(gpath, pattern)
        return cmu, sub, governing

    def _fixed_substream(self, cmu: CacheManageUnit) -> SubStream:
        from .eviction import make_policy
        sub = cmu.substreams.get(cmu.root_path)
        if sub is None or getattr(sub.policy, "name", "") != self.options.eviction:
            cap_blocks = max(1, cmu.quota // self.cfg.block_size)
            policy = make_policy(self.options.eviction, cap_blocks)
            if sub is not None:
                for k in sub.blocks:
                    policy.record_insert(k)
                sub.policy = policy
            else:
                sub = SubStream(cmu.root_path, Pattern.UNKNOWN, policy)
                cmu.substreams[cmu.root_path] = sub
        return sub

    def _set_static_quota(self, cmu: CacheManageUnit, want: int) -> None:
        default = self.cache.default_cmu
        extra = want - cmu.quota
        if extra > 0:
            take = min(extra, max(0, default.quota - self.cfg.min_share))
            default.set_quota(default.quota - take)
            cmu.set_quota(cmu.quota + take)

    # ------------------------------------------------------------- prefetch
    def _gen_prefetch(self, file_path: PathT, leaf_path: PathT,
                      cmu: CacheManageUnit, governing: Optional[AccessStream],
                      now: float) -> List[Tuple[PathT, int]]:
        mode = self.options.prefetch
        if mode == "none" or self.cache.capacity <= 0:
            return []
        if mode in ("stride", "enhanced_stride"):
            return self._stride_prefetch(file_path, int(leaf_path[-1][1:]),
                                         enhanced=(mode == "enhanced_stride"))
        if mode == "sfp":
            return []  # handled at file switch in read()
        # -------- adaptive (IGTCache §3.3) --------
        cands: List[Tuple[PathT, int]] = []
        budget = min(cmu.quota, self.cfg.prefetch_budget_bytes)
        # sequential levels: hierarchical prefetch at every sequential node
        node = self.tree.root
        for comp in leaf_path:
            child = node.children.get(comp)
            if child is None:
                break
            self._seq_node_candidates(child, budget, cands)
            node = child
        self._stat_candidates(cmu, cands)
        return self._dedup_prefetch(cands)

    def _gen_prefetch_chain(self, ctx: _FileCtx, chain: ObservedChain,
                            block: int, cmu: CacheManageUnit,
                            governing: Optional[AccessStream],
                            now: float) -> List[Tuple[PathT, int]]:
        mode = self.options.prefetch
        if mode == "none" or self.cache.capacity <= 0:
            return []
        if mode in ("stride", "enhanced_stride"):
            return self._stride_prefetch(ctx.file_path, block,
                                         enhanced=(mode == "enhanced_stride"))
        if mode == "sfp":
            return []
        cands: List[Tuple[PathT, int]] = []
        budget = None
        window = self.cfg.window
        seq = Pattern.SEQUENTIAL
        for child in chain.cnodes:
            # inline gate (hot path): only sequential non-trivial nodes with
            # a recorded window generate candidates
            if (child.accesses >= window and child.count
                    and child.pattern.pattern is seq):
                if budget is None:
                    budget = min(cmu.quota, self.cfg.prefetch_budget_bytes)
                self._seq_node_candidates(child, budget, cands)
        self._stat_candidates(cmu, cands)
        if not cands:
            return cands
        return self._dedup_prefetch(cands)

    def _seq_node_candidates(self, child: AccessStream, budget: int,
                             cands: List[Tuple[PathT, int]]) -> None:
        """Sequential readahead at one tree level (shared by both paths).

        Readahead horizon: bounded by the stream's quota (admission will
        evict consumed/stale blocks as needed) and the global horizon cap.
        """
        if not (child.non_trivial(self.cfg)
                and child.pattern.pattern is Pattern.SEQUENTIAL
                and child.count):
            return
        idx = child.last_index
        if self._node_last_prefetch_idx.get(child.path) == idx:
            return
        self._node_last_prefetch_idx[child.path] = idx
        # Adaptive depth: double while the stream keeps advancing
        # (fast consumers outrun a fixed N=4 window).
        depth = self._ra_depth.get(child.path, self.cfg.prefetch_depth)
        if self.meta.is_file(child.path):
            got = block_sequential_candidates(
                self.meta, child, self.cfg, budget, depth=depth)
        else:
            got = sequential_candidates(
                self.meta, child, self.cfg, budget, depth=depth)
        if got:
            self._ra_depth[child.path] = min(
                depth * 2, self.cfg.max_readahead_items)
        cands.extend(got)

    def _stat_candidates(self, cmu: CacheManageUnit,
                         cands: List[Tuple[PathT, int]]) -> None:
        # random: statistical whole-dataset prefetch, once per (re)classify
        if (not cmu.stat_prefetch_done
                and cmu.effective_pattern() is Pattern.RANDOM):
            cmu.stat_prefetch_done = True
            cands.extend(statistical_candidates(
                self.meta, cmu.root_path, cmu.quota, cmu.dataset_bytes,
                self.cfg, lambda p: self.cache.resident(path_key(p))))

    def _stride_prefetch(self, file_path: PathT, b: int,
                         enhanced: bool) -> List[Tuple[PathT, int]]:
        """JuiceFS-style block readahead within one file."""
        last, run, depth = self._stride_state.get(file_path, (-2, 0, 4))
        if b == last + 1:
            run += 1
            if enhanced and run % 4 == 0:
                depth = min(32, depth * 2)
        else:
            run, depth = 0, 4
        self._stride_state[file_path] = (b, run, depth)
        if run < 3:
            return []
        fsize = self.meta.file_size(file_path)
        nblocks = max(1, -(-fsize // self.cfg.block_size))
        cands = []
        for nb in range(b + 1, min(nblocks, b + 1 + depth)):
            bsize = min(self.cfg.block_size, fsize - nb * self.cfg.block_size)
            cands.append((block_key(file_path, nb), bsize))
        return self._dedup_prefetch(cands)

    def _sfp_observe(self, file_path: PathT, out: ReadOutcome,
                     now: float) -> List[Tuple[PathT, int]]:
        """SFP [76]-style file-level Markov prefetch (baseline)."""
        ds = file_path[0] if file_path else ""
        prev = self._sfp_prev.get(ds)
        cands: List[Tuple[PathT, int]] = []
        if prev is not None and prev != file_path:
            t = self._sfp_trans[prev]
            t[file_path] = t.get(file_path, 0) + 1
            succ = self._sfp_trans.get(file_path)
            if succ:
                best, cnt = max(succ.items(), key=lambda kv: kv[1])
                total = sum(succ.values())
                if cnt >= 2 and cnt / total >= 0.5:
                    fsize = self.meta.file_size(best)
                    nblocks = max(1, -(-fsize // self.cfg.block_size))
                    for nb in range(min(nblocks, 8)):
                        bsize = min(self.cfg.block_size,
                                    fsize - nb * self.cfg.block_size)
                        cands.append((block_key(best, nb), bsize))
        self._sfp_prev[ds] = file_path
        got = self._dedup_prefetch(cands)
        out.prefetches.extend(got)
        return got

    def _dedup_prefetch(self, cands: List[Tuple[PathT, int]]):
        out = []
        for path, size in cands:
            key = path_key(path)
            if key in self._pending_prefetch or self.cache.resident(key):
                continue
            self._pending_prefetch.add(key)
            self.stats.prefetch_issued += 1
            out.append((path, size))
        return out

    def complete_prefetch(self, path: PathT, size: int, now: float) -> bool:
        """Background fetch landed — admit without polluting the tree."""
        key = path_key(path)
        self._pending_prefetch.discard(key)
        if self.cache.resident(key):
            return True
        file_path, _ = split_block_key(path)
        ctx = self._file_ctx(file_path)
        cmu = self._resolve_ctx_cmu(ctx)
        chain = ctx.chain
        if chain is not None and chain.valid():
            governing = self._chain_governing(chain)
        else:
            governing = self.tree.deepest_informative(path)
        pattern = governing.pattern.pattern if governing else Pattern.UNKNOWN
        gpath = governing.path if governing else cmu.root_path
        if self.options.eviction != "adaptive":
            sub = self._fixed_substream(cmu)
        else:
            sub = cmu.substream(gpath, pattern)
        ok = self.cache.insert_key(key, size, cmu, sub)
        if ok:
            self._prefetched_resident.add(key)
        else:
            self.stats.prefetch_wasted += 1
        return ok

    def cancel_prefetch(self, path: PathT) -> None:
        self._pending_prefetch.discard(path_key(path))

    # ------------------------------------------------------------------ tick
    def tick(self, now: float) -> None:
        """Scheduled maintenance: TTL sweep + allocation round.

        Runs once per read()/read_batch() and on the caller's own cadence
        (the simulator's 5 s event) — never per block (§4).
        """
        # TTL sweep (rate-limited).  Eviction exists to free space for other
        # active workloads (§3.3) — so it only fires under cache pressure.
        if now - self._last_ttl_sweep >= 5.0:
            self._last_ttl_sweep = now
            pressure = self.cache.used_bytes() > 0.85 * self.cache.capacity
            for path, cmu in list(self.cache.cmus.items()):
                if cmu is self.cache.default_cmu:
                    continue
                if self._pinned.covers(path):
                    continue  # user-pinned: exempt from TTL expiry
                ttl = (self.options.fixed_ttl if self.options.fixed_ttl
                       is not None else cmu.effective_ttl())
                if ttl is None:
                    continue
                idle_since = max(cmu.last_access_time, cmu.created_at)
                if pressure and now - idle_since > ttl and cmu.used > 0:
                    self.cache.remove_cmu(path)
        # allocation round (list materialization only when a round fires)
        alloc = self.options.allocation
        if alloc == "adaptive":
            if self.rebalancer.due(now):
                self.rebalancer.rebalance(list(self.cache.cmus.values()), now)
        elif alloc == "quiver":
            if self.quiver.due(now):
                self.quiver.rebalance(self.workload_cmus(), now,
                                      self._workload_capacity())
                self._give_rest_to_default()
        elif alloc == "fluid":
            if self.fluid.due(now):
                self.fluid.rebalance(self.workload_cmus(), now,
                                     self._workload_capacity())
                self._give_rest_to_default()
        if self._placement_hook is not None:
            self._emit_placement(now)

    def _emit_placement(self, now: float) -> None:
        """Push changed per-dataset placement verdicts to a tiered
        backing store (``meta.note_pattern``).  Change-detected so the
        steady state costs one dict probe per stream per tick."""
        hook = self._placement_hook
        for path, cmu in self.cache.cmus.items():
            if cmu is self.cache.default_cmu:
                continue
            hint = placement_hint(cmu, now, self.cfg)
            cur = (hint.pattern.value, hint.pin_ram)
            top = path[0]
            if self._placement_sent.get(top) != cur:
                self._placement_sent[top] = cur
                hook(top, hint.pattern.value, hint.pin_ram)

    def workload_cmus(self) -> List[CacheManageUnit]:
        """Non-default CacheManageUnits of this engine (shard-local view;
        the ShardedIGTCache facade merges these across shards for
        cluster-wide allocation)."""
        return [c for _, c in self.iter_workload_cmus()]

    def iter_workload_cmus(self):
        """(root_path, CMU) pairs for every workload stream — the uniform
        accessor shared with ShardedIGTCache (sim tracing, examples)."""
        default = self.cache.default_cmu
        for path, cmu in self.cache.cmus.items():
            if cmu is not default:
                yield path, cmu

    def _workload_capacity(self) -> int:
        return self.cache.capacity - self.cfg.min_share  # default keeps a floor

    def _give_rest_to_default(self) -> None:
        rest = self.cache.capacity - sum(
            c.quota for c in self.cache.cmus.values()
            if c is not self.cache.default_cmu)
        self.cache.default_cmu.set_quota(max(0, rest))

    # ----------------------------------------------------------------- stats
    def hit_ratio(self) -> float:
        return self.stats.hit_ratio

    def snapshot(self) -> dict:
        s = self.stats.snapshot()
        s["nodes"] = self.tree.node_count()
        s["cmus"] = len(self.cache.cmus) - 1
        s["used_bytes"] = self.cache.used_bytes()
        return s

    # ---------------------------------------------------------- warm restart
    def warm_state(self) -> dict:
        """Serializable hot-state manifest for warm restart
        (``daemon.journal``): CMU roots/quotas, resident block keys,
        sticky pin/ban prefixes, and the per-dataset placement verdicts
        already pushed to a tiered store.  Metadata only — the kernel
        never held payload bytes, so :meth:`warm_admit` on a fresh
        engine reproduces the residency exactly."""
        cmus = [{"root": tuple(path), "quota": int(cmu.quota),
                 "dataset_bytes": int(cmu.dataset_bytes)}
                for path, cmu in self.iter_workload_cmus()]
        return {
            "cmus": cmus,
            "resident": [(key, int(size))
                         for key, (size, _c) in self.cache.blocks.items()],
            "pins": [tuple(p) for p in self._pinned],
            "never_cache": [tuple(p) for p in self._never_cache],
            "verdicts": dict(self._placement_sent),
        }

    def warm_admit(self, state: dict, now: float) -> dict:
        """Re-admit a :meth:`warm_state` manifest into this (fresh)
        engine: recreate CMUs with their journaled quotas, replay
        pins/bans, re-push placement verdicts (a tiered backing store
        regains its hints before the first read), and re-insert the
        resident keys — bytes arrive from the backing store on the
        first hit's fetch, as for any metadata hit.  Idempotent; banned
        or unadmittable keys are skipped, not errors.  Returns restore
        counters."""
        restored = {"cmus": 0, "blocks": 0, "bytes": 0, "pins": 0,
                    "verdicts": 0, "skipped": 0}
        for p in state.get("pins", ()):
            self.pin(tuple(p))
            restored["pins"] += 1
        for p in state.get("never_cache", ()):
            self.never_cache(tuple(p))
        for row in state.get("cmus", ()):
            root = tuple(row["root"])
            cmu = self.cache.cmus.get(root)
            if cmu is None:
                db = int(row.get("dataset_bytes") or 0)
                if db <= 0:
                    try:
                        db = self.meta.subtree_bytes(root)
                    except Exception:
                        db = 0
                cmu = self.cache.create_cmu(root, db, now)
                restored["cmus"] += 1
            want = int(row.get("quota", 0))
            if want > cmu.quota:
                self._set_static_quota(cmu, want)
        for top, verdict in (state.get("verdicts") or {}).items():
            pattern, pin_ram = verdict
            self._placement_sent[str(top)] = (str(pattern), bool(pin_ram))
            if self._placement_hook is not None:
                self._placement_hook(str(top), str(pattern), bool(pin_ram))
            restored["verdicts"] += 1
        for key, size in state.get("resident", ()):
            if self.cache.resident(key):
                continue
            path = tuple(key.split("/"))
            file_path, b = split_block_key(path)
            if b is None or self._never_cache.covers(file_path):
                restored["skipped"] += 1
                continue
            cmu = self.cache.cmu_for_path(path)
            sub = cmu.substream(cmu.root_path, Pattern.UNKNOWN)
            if self.cache.insert_key(key, int(size), cmu, sub):
                restored["blocks"] += 1
                restored["bytes"] += int(size)
            else:
                restored["skipped"] += 1
        return restored


def informative_depth(levels: List[Tuple[str, int, int]]) -> int:
    """Deepest level index with an informative (>1 entry) listing — the depth
    to which the AccessStreamTree materializes nodes (layer compression §4)."""
    last = -1
    for d, (_, _, total) in enumerate(levels):
        if total > 1:
            last = d
    return last
