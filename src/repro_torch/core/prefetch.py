"""Prefetching strategies (§3.3).

Pattern adaptivity:
  * sequential  → next-N items at the level where the sequential pattern was
                  detected (N = ``prefetch_depth``), in listing order;
  * random      → *statistical prefetching*: bulk-prefetch the dataset when
                  the expected hit ratio (allocatable quota / dataset size)
                  clears ``statistical_prefetch_threshold``;
  * skewed      → no prefetching.

Granularity adaptivity — *hierarchical prefetching*: horizontal candidates at
the detected level; vertical selection below it keeps only descendants that
were hot (frequency >= f_p) in previously-visited sibling subtrees (Fig. 7),
falling back to "everything" when siblings were read in full.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

from .access_stream_tree import AccessStream
from .meta import StoreMeta
from .types import CacheConfig, PathT, Pattern, block_key

# A prefetch candidate is (block_path, size).
Candidate = Tuple[PathT, int]


def _sibling_child_profile(node: AccessStream, f_p: float) -> Optional[set]:
    """Relative-child keys hot across the *visited* children of ``node``.

    f(k) = (#visited children whose subtree touched k) / (#visited children).
    Returns None when the profile says "everything" (all visited siblings were
    read in full, or nothing informative yet).
    """
    visited = [c for c in node.children.values() if c.child_hits]
    if not visited:
        return None
    counts: dict = {}
    for v in visited:
        for k in v.child_hits:
            counts[k] = counts.get(k, 0) + 1
    n = len(visited)
    hot = {k for k, x in counts.items() if x / n >= f_p}
    if not hot:
        return None
    # If siblings were read ~in full, selection buys nothing — prefetch all.
    avg_children = sum(len(v.child_hits) for v in visited) / n
    if visited[0].total and avg_children >= 0.9 * visited[0].total:
        return None
    return hot


def _expand_candidate(meta: StoreMeta, path: PathT, node: Optional[AccessStream],
                      hot_filter: Optional[set], cfg: CacheConfig,
                      budget: int, depth: int = 0) -> List[Candidate]:
    """Vertically expand one horizontal candidate into block keys."""
    if budget <= 0 or depth > 4:
        return []
    out: List[Candidate] = []
    if meta.is_file(path):
        size = meta.file_size(path)
        nblocks = max(1, -(-size // cfg.block_size))
        block_filter = hot_filter  # hot blocks of sibling files, if any
        for b in range(nblocks):
            bkey = f"#{b}"
            if block_filter is not None and bkey not in block_filter:
                continue
            bsize = min(cfg.block_size, size - b * cfg.block_size)
            out.append((block_key(path, b), bsize))
            budget -= bsize
            if budget <= 0:
                break
        return out
    children = meta.listing(path)
    for name in children:
        if hot_filter is not None and name not in hot_filter:
            continue
        # The next level's hot filter is the profile of the *visited siblings*
        # at this level (which relative grand-children they touched).
        child_node = node.children.get(name) if node is not None else None
        got = _expand_candidate(meta, path + (name,), child_node,
                                _grandchild_profile(node, cfg.f_p),
                                cfg, budget, depth + 1)
        out.extend(got)
        budget -= sum(s for _, s in got)
        if budget <= 0:
            break
    return out


def _grandchild_profile(node: Optional[AccessStream], f_p: float) -> Optional[set]:
    if node is None:
        return None
    return _sibling_child_profile(node, f_p)


def sequential_candidates(meta: StoreMeta, node: AccessStream,
                          cfg: CacheConfig, budget: int,
                          depth: int = 0) -> List[Candidate]:
    """Next-N prefetch at ``node``'s level after its latest access (§3.3).

    ``node`` is the AccessStream where the sequential pattern was detected;
    its last record names the child just accessed.  Candidates are the next
    N siblings (stride-aware), each vertically narrowed by the hot profile of
    previously visited siblings (hierarchical prefetching).  ``depth``
    overrides the base N (the engine grows it while the stream keeps
    consuming readahead — footnote-7 policy extension).
    """
    if node.count == 0:
        return []
    depth = depth or cfg.prefetch_depth
    last_index = node.last_index
    stride = max(1, node.pattern.stride)
    listing = meta.listing(node.path)
    if not listing:
        return []
    hot = _sibling_child_profile(node, cfg.f_p)
    out: List[Candidate] = []
    for step in range(1, depth + 1):
        idx = last_index + step * stride
        if idx >= len(listing):
            break
        name = listing[idx]
        child_node = node.children.get(name)
        got = _expand_candidate(meta, node.path + (name,), child_node, hot,
                                cfg, budget)
        out.extend(got)
        budget -= sum(s for _, s in got)
        if budget <= 0:
            break
    return out


def block_sequential_candidates(meta: StoreMeta, file_node: AccessStream,
                                cfg: CacheConfig, budget: int,
                                depth: int = 0) -> List[Candidate]:
    """Next-N blocks inside one file (the classic readahead case)."""
    if file_node.count == 0:
        return []
    depth = depth or cfg.prefetch_depth
    last_index = file_node.last_index
    stride = max(1, file_node.pattern.stride)
    size = meta.file_size(file_node.path)
    nblocks = max(1, -(-size // cfg.block_size))
    out: List[Candidate] = []
    for step in range(1, depth + 1):
        b = last_index + step * stride
        if b >= nblocks:
            break
        bsize = min(cfg.block_size, size - b * cfg.block_size)
        out.append((block_key(file_node.path, b), bsize))
        budget -= bsize
        if budget <= 0:
            break
    return out


def statistical_candidates(meta: StoreMeta, root_path: PathT, quota: int,
                           dataset_bytes: int, cfg: CacheConfig,
                           resident) -> List[Candidate]:
    """Whole-dataset prefetch for random streams (§3.3).

    Fires when expected hit ratio = quota / dataset_bytes >= threshold;
    fills at most the quota, skipping already-resident blocks.
    """
    if dataset_bytes <= 0:
        return []
    expected_hit = min(1.0, quota / dataset_bytes)
    if expected_hit < cfg.statistical_prefetch_threshold:
        return []
    out: List[Candidate] = []
    budget = quota
    for bpath, bsize in meta.iter_block_keys(root_path):
        if budget - bsize < 0:
            break
        if resident(bpath):
            budget -= bsize  # counts against quota but no fetch needed
            continue
        out.append((bpath, bsize))
        budget -= bsize
    return out
