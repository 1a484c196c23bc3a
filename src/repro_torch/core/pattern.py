"""Online pattern recognition for one AccessStream (§3.2) + adaptive TTL (§3.3).

Decision procedure, purely from cache-side information:

1. sequential — the signed spatial gaps of consecutive accesses are
   overwhelmingly a small constant positive stride (unit stride for block
   scans and listing-order traversals).  Existing-practice detector.
2. otherwise run the K-S test of the |gap| samples against the triangular
   permutation law over [1, c]:  accept → random, reject → skewed.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .ks import (ks_critical, ks_test_random, ks_test_random_matrix,
                 normal_quantile)
from .types import AccessRecord, CacheConfig, Pattern


@dataclass
class PatternResult:
    pattern: Pattern
    d_stat: float = 0.0
    d_critical: float = 0.0
    stride: int = 1  # detected stride when sequential
    seq_fraction: float = 0.0


def spatial_gaps(records: Sequence[AccessRecord]) -> list[int]:
    return [records[i].index - records[i - 1].index for i in range(1, len(records))]


MAX_STRIDE = 16


def detect_sequential(gaps: Sequence[int], threshold: float) -> tuple[bool, int, float]:
    """Return (is_sequential, stride, fraction-in-order).

    A stream is sequential when consecutive accesses move monotonically
    forward in small steps: at least ``threshold`` of the gaps lie in
    [0, MAX_STRIDE], backwards seeks are rare (<= 1 - threshold), and there is
    net forward drift.  Gap 0 counts as in-order — a coarse (directory) level
    sees long runs of 0 while a child is being traversed, punctuated by +1 on
    child switches.  Random streams fail on the backwards-seek test
    (~half their gaps are negative); skewed streams fail on both.
    """
    if not gaps:
        return False, 1, 0.0
    n = len(gaps)
    in_order = sum(1 for g in gaps if 0 <= g <= MAX_STRIDE) / n
    backwards = sum(1 for g in gaps if g < 0) / n
    drift = sum(gaps)
    pos = [g for g in gaps if 0 < g <= MAX_STRIDE]
    counts: dict[int, int] = {}
    for g in pos:
        counts[g] = counts.get(g, 0) + 1
    stride = max(counts.items(), key=lambda kv: kv[1])[0] if counts else 1
    is_seq = in_order >= threshold and backwards <= (1.0 - threshold) and drift > 0
    return is_seq, stride, in_order


def distinct_deficit(indices: Sequence[int], c: int) -> float:
    """z-score of the distinct-count against the uniform null.

    Under uniform(-with-replacement) sampling of w items from [1, c]:
        E[D]   = c (1 - (1-1/c)^w)
        Var[D] = c (1-1/c)^w + c(c-1)(1-2/c)^w - c^2 (1-1/c)^{2w}
    Permutation epochs (the random pattern) give >= E[D] distinct items; a
    frequency-skewed stream revisits hot items and lands far BELOW.  Returns
    (E[D] - observed) / sd — large positive = skew.  This screen catches hot
    sets that are scattered in index space, which the spatial-gap K-S test is
    blind to (the skew is in access *frequency*, not position).
    """
    w = len(indices)
    if w < 4 or c < 4:
        return 0.0
    d_obs = len(set(indices))
    p1 = (1.0 - 1.0 / c) ** w
    p2 = (1.0 - 2.0 / c) ** w
    e_d = c * (1.0 - p1)
    var = c * p1 + c * (c - 1) * p2 - c * c * p1 * p1
    sd = math.sqrt(max(var, 1e-9))
    return (e_d - d_obs) / max(sd, 1.0)


def classify(records: Sequence[AccessRecord], total: int, cfg: CacheConfig) -> PatternResult:
    """Classify one observation window of accesses (§3.2).

    Order: sequential gap screen → distinct-count z-test (frequency skew) →
    K-S against the triangular permutation law (positional randomness).
    """
    if len(records) < 2:
        return PatternResult(Pattern.UNKNOWN)
    gaps = spatial_gaps(records)

    is_seq, stride, frac = detect_sequential(gaps, cfg.sequential_threshold)
    if is_seq:
        return PatternResult(Pattern.SEQUENTIAL, stride=stride, seq_fraction=frac)

    c = max(total, max(r.index for r in records) + 1)
    # Degenerate index space (single-item listing / one hot child): nothing to
    # infer at this level — defer to an ancestor/descendant stream.
    if c <= 2 or len({r.index for r in records}) <= 1:
        return PatternResult(Pattern.UNKNOWN)

    z = distinct_deficit([r.index for r in records], c)
    if z > cfg.distinct_z_threshold:
        return PatternResult(Pattern.SKEWED)
    abs_gaps = [abs(g) for g in gaps]
    accept, d, d_alpha = ks_test_random(abs_gaps, c, cfg.alpha)
    pattern = Pattern.RANDOM if accept else Pattern.SKEWED
    return PatternResult(pattern, d_stat=d, d_critical=d_alpha, seq_fraction=frac)


# ---------------------------------------------------------------------------
# Vectorized classification (§4 overhead optimization): all windows due for
# (re)analysis are classified in one matrix pass.  The scalar classify()
# above stays as the cross-checked reference; per-row results are designed to
# be independent of batching (integer counts, elementwise ops, masked maxes —
# no cross-column float accumulation), so classify_batch([w]) == the result
# of w inside any larger batch.
# ---------------------------------------------------------------------------

# One analysis window: (chronological item indices, listing size c).
Window = Tuple[np.ndarray, int]


def _mode_stride(gaps: np.ndarray) -> int:
    """First-occurrence-wins mode of the in-range positive gaps (matches the
    dict-insertion-order tie-break of detect_sequential)."""
    pos = gaps[(gaps > 0) & (gaps <= MAX_STRIDE)]
    if pos.size == 0:
        return 1
    vals, counts = np.unique(pos, return_counts=True)
    best = counts.max()
    cands = vals[counts == best]
    if cands.size == 1:
        return int(cands[0])
    first_occ = [int(np.argmax(pos == v)) for v in cands]
    return int(cands[int(np.argmin(first_occ))])


def _classify_one(a: np.ndarray, total: int,
                  cfg: CacheConfig) -> PatternResult:
    """Single-window fast path of :func:`classify_batch`.

    Same decision procedure and the same float expressions (in the same
    evaluation order) as the matrix path below, on 1-D arrays — a window
    classifies identically whether it rides alone or in a batch.
    """
    n = int(a.size)
    if n < 2:
        return PatternResult(Pattern.UNKNOWN)
    gaps = np.diff(a)
    m = n - 1
    in_cnt = int(np.count_nonzero((gaps >= 0) & (gaps <= MAX_STRIDE)))
    back_cnt = int(np.count_nonzero(gaps < 0))
    drift = int(gaps.sum())
    frac = in_cnt / m
    thr = cfg.sequential_threshold
    if frac >= thr and back_cnt / m <= 1.0 - thr and drift > 0:
        return PatternResult(Pattern.SEQUENTIAL, stride=_mode_stride(gaps),
                             seq_fraction=float(frac))
    srt_idx = np.sort(a)
    c = max(int(total), int(srt_idx[-1]) + 1)
    distinct = 1 + int(np.count_nonzero(srt_idx[1:] != srt_idx[:-1]))
    if c <= 2 or distinct <= 1:
        return PatternResult(Pattern.UNKNOWN)
    if n >= 4 and c >= 4:
        cf = float(c)
        wf = float(n)
        p1 = (1.0 - 1.0 / cf) ** wf
        p2 = (1.0 - 2.0 / cf) ** wf
        e_d = cf * (1.0 - p1)
        var = cf * p1 + cf * (cf - 1.0) * p2 - cf * cf * p1 * p1
        sd = math.sqrt(max(var, 1e-9))
        z = (e_d - distinct) / max(sd, 1.0)
        if z > cfg.distinct_z_threshold:
            return PatternResult(Pattern.SKEWED)
    cf = float(c)
    # kf = floor(min(|gap|, c-1)) — exact on int64 without the float round
    # trip (values < 2^53); identical to the matrix path's floor/minimum
    kf = np.minimum(np.sort(np.abs(gaps)), c - 1)
    f = 2.0 * kf / (cf - 1.0) - kf * (kf + 1.0) / (cf * (cf - 1.0))
    f[kf < 1] = 0.0
    pos, pos_prev = _ecdf_positions(m)
    dev = np.maximum(pos - f, f - pos_prev)
    d = float(dev.max())
    d_alpha = ks_critical(m, cfg.alpha)
    pat = Pattern.RANDOM if d < d_alpha else Pattern.SKEWED
    return PatternResult(pat, d_stat=d, d_critical=d_alpha,
                         seq_fraction=float(frac))


_ECDF_CACHE: dict = {}


def _ecdf_positions(m: int) -> Tuple[np.ndarray, np.ndarray]:
    """(i/m, (i-1)/m) for i=1..m — cached; windows recur at the same size."""
    got = _ECDF_CACHE.get(m)
    if got is None:
        pos = np.arange(1, m + 1, dtype=np.float64)
        got = (pos / m, (pos - 1.0) / m)
        if len(_ECDF_CACHE) < 1024:
            _ECDF_CACHE[m] = got
    return got


def classify_batch(windows: Sequence[Window],
                   cfg: CacheConfig) -> List[PatternResult]:
    """Classify many observation windows in one vectorized pass.

    Each window is (indices, total): the chronological item indices of one
    AccessStream's observation window plus its listing size.  Implements the
    same decision procedure as :func:`classify` — sequential screen →
    distinct-deficit z-test → K-S against the triangular law — with every
    stage computed over the padded (R, W) matrix at once.
    """
    R = len(windows)
    if R == 0:
        return []
    if R == 1:
        a, total = windows[0]
        return [_classify_one(np.asarray(a, dtype=np.int64), int(total), cfg)]
    lens = np.fromiter((len(w[0]) for w in windows), np.int64, R)
    totals = np.fromiter((w[1] for w in windows), np.int64, R)
    W = max(int(lens.max()), 2)
    idx = np.zeros((R, W), np.int64)
    for r, (a, _) in enumerate(windows):
        idx[r, : len(a)] = a

    cols = np.arange(W, dtype=np.int64)[None, :]
    imask = cols < lens[:, None]
    m = np.maximum(lens - 1, 0)                    # gap count per row
    gaps = idx[:, 1:] - idx[:, :-1]
    gmask = cols[:, : W - 1] < m[:, None]

    # -- sequential screen (exact integer counts) ---------------------------
    in_cnt = ((gaps >= 0) & (gaps <= MAX_STRIDE) & gmask).sum(axis=1)
    back_cnt = ((gaps < 0) & gmask).sum(axis=1)
    drift = np.where(gmask, gaps, 0).sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = np.where(m > 0, in_cnt / np.maximum(m, 1), 0.0)
        backfrac = np.where(m > 0, back_cnt / np.maximum(m, 1), 0.0)
    thr = cfg.sequential_threshold
    is_seq = (m > 0) & (frac >= thr) & (backfrac <= 1.0 - thr) & (drift > 0)

    # -- index-space geometry ----------------------------------------------
    row_max = np.where(imask, idx, np.iinfo(np.int64).min).max(axis=1)
    c = np.maximum(totals, row_max + 1)
    srt = np.sort(np.where(imask, idx, np.iinfo(np.int64).max), axis=1)
    changed = (srt[:, 1:] != srt[:, :-1]) & gmask
    distinct = np.where(lens > 0, changed.sum(axis=1) + 1, 0)

    # -- distinct-count z (frequency skew), same formula as distinct_deficit
    w_f = lens.astype(np.float64)
    c_f = c.astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        p1 = (1.0 - 1.0 / c_f) ** w_f
        p2 = (1.0 - 2.0 / c_f) ** w_f
        e_d = c_f * (1.0 - p1)
        var = c_f * p1 + c_f * (c_f - 1.0) * p2 - c_f * c_f * p1 * p1
        sd = np.sqrt(np.maximum(var, 1e-9))
        z = (e_d - distinct) / np.maximum(sd, 1.0)
    z = np.where((lens >= 4) & (c >= 4), z, 0.0)

    # -- K-S against the triangular permutation law ------------------------
    abs_gaps = np.where(gmask, np.abs(gaps), np.iinfo(np.int64).max
                        ).astype(np.float64)
    accept, d, d_alpha = ks_test_random_matrix(abs_gaps, m, c, cfg.alpha)

    out: List[PatternResult] = []
    for r in range(R):
        if lens[r] < 2:
            out.append(PatternResult(Pattern.UNKNOWN))
        elif is_seq[r]:
            stride = _mode_stride(gaps[r, : m[r]])
            out.append(PatternResult(Pattern.SEQUENTIAL, stride=stride,
                                     seq_fraction=float(frac[r])))
        elif c[r] <= 2 or distinct[r] <= 1:
            out.append(PatternResult(Pattern.UNKNOWN))
        elif z[r] > cfg.distinct_z_threshold:
            out.append(PatternResult(Pattern.SKEWED))
        else:
            pat = Pattern.RANDOM if accept[r] else Pattern.SKEWED
            out.append(PatternResult(pat, d_stat=float(d[r]),
                                     d_critical=float(d_alpha[r]),
                                     seq_fraction=float(frac[r])))
    return out


def fit_adaptive_ttl_arr(times: np.ndarray,
                         cfg: CacheConfig) -> Optional[float]:
    """Array form of :func:`fit_adaptive_ttl` over a chronological window."""
    if times.size < 3:
        return None
    diffs = times[1:] - times[:-1]
    gaps = diffs[diffs >= 0.0]
    n = gaps.size
    if n < 2:
        return None
    mu = float(gaps.sum()) / n
    var = float(((gaps - mu) ** 2).sum()) / max(1, n - 1)
    sigma = math.sqrt(var)
    z = normal_quantile(1.0 - cfg.ttl_significance)
    return mu + z * sigma + cfg.ttl_base


def fit_adaptive_ttl_batch(windows: Sequence[np.ndarray],
                           cfg: CacheConfig) -> List[Optional[float]]:
    """Vectorized :func:`fit_adaptive_ttl_arr` over many chronological
    windows in one padded-matrix pass (§4 overhead lever).

    The classify pass hands every node that just (re)classified RANDOM to
    this in one call (``access_stream_tree.analyze_streams``) instead of
    fitting per node.  Per-row decision logic (>= 3 samples, >= 2
    non-negative gaps, the N(mu, sigma) quantile) matches the scalar form;
    masked/padded entries contribute exact zeros to the row reductions.
    """
    R = len(windows)
    if R == 0:
        return []
    if R == 1:
        return [fit_adaptive_ttl_arr(
            np.asarray(windows[0], dtype=np.float64), cfg)]
    lens = np.fromiter((len(w) for w in windows), np.int64, R)
    W = max(int(lens.max()), 2)
    mat = np.zeros((R, W), np.float64)
    for r, w in enumerate(windows):
        mat[r, : len(w)] = w
    diffs = mat[:, 1:] - mat[:, :-1]
    cols = np.arange(W - 1, dtype=np.int64)[None, :]
    valid = (cols < (lens - 1)[:, None]) & (diffs >= 0.0)
    n = valid.sum(axis=1)
    gaps = np.where(valid, diffs, 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        mu = gaps.sum(axis=1) / np.maximum(n, 1)
        dev = np.where(valid, diffs - mu[:, None], 0.0)
        var = (dev * dev).sum(axis=1) / np.maximum(n - 1, 1)
    sigma = np.sqrt(var)
    z = normal_quantile(1.0 - cfg.ttl_significance)
    ttl = mu + z * sigma + cfg.ttl_base
    ok = (lens >= 3) & (n >= 2)
    return [float(ttl[r]) if ok[r] else None for r in range(R)]


# ---------------------------------------------------------------------------
# Adaptive TTL (§3.3): temporal gaps ~ Normal(mu, sigma); TTL is the
# (1 - significance) quantile plus a base time guarding against small
# disturbances.  A stream idle longer than its TTL is presumed finished and
# its resident data is evicted wholesale.
# ---------------------------------------------------------------------------

def fit_adaptive_ttl(times: Sequence[float], cfg: CacheConfig) -> Optional[float]:
    """Fit TTL from the access timestamps of one observation window."""
    if len(times) < 3:
        return None
    gaps = [times[i] - times[i - 1] for i in range(1, len(times)) if times[i] >= times[i - 1]]
    if len(gaps) < 2:
        return None
    n = len(gaps)
    mu = sum(gaps) / n
    var = sum((g - mu) ** 2 for g in gaps) / max(1, n - 1)
    sigma = math.sqrt(var)
    z = normal_quantile(1.0 - cfg.ttl_significance)
    return mu + z * sigma + cfg.ttl_base
