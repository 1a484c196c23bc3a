"""Kolmogorov–Smirnov machinery (§3.2).

Self-contained (no scipy at runtime; tests cross-check against scipy.stats).

The one-sample K-S test compares the empirical CDF of the observed spatial
gaps against a reference CDF.  For the *random* pattern the reference is the
triangular gap law of a uniform-without-replacement (permutation) stream over
[1, c]:

    P(Z = k) = 2 (c - k) / (c (c - 1)),   1 <= k <= c - 1
    F(k)     = 2k/(c-1) - k(k+1)/(c(c-1))

(the distribution of |i - j| for an ordered pair of distinct uniform indices).
"""
from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

import numpy as np


def triangular_cdf(k: float, c: int) -> float:
    """CDF of the spatial-gap law under the random pattern (eq. 1)."""
    if c < 2:
        return 1.0
    if k < 1:
        return 0.0
    k = min(float(k), float(c - 1))
    kf = math.floor(k)
    return 2.0 * kf / (c - 1) - kf * (kf + 1) / (c * (c - 1.0))


def ecdf_ks_statistic(samples: Sequence[float], cdf: Callable[[float], float]) -> float:
    """D_max = sup_x |ECDF(x) - F(x)| for a one-sample K-S test.

    Uses the standard two-sided evaluation at the order statistics:
    D+ = max(i/n - F(x_i)),  D- = max(F(x_i) - (i-1)/n).
    """
    xs = sorted(samples)
    n = len(xs)
    if n == 0:
        return 0.0
    d = 0.0
    for i, x in enumerate(xs, start=1):
        fx = cdf(x)
        d = max(d, i / n - fx, fx - (i - 1) / n)
    return d


def ks_critical(n: int, alpha: float) -> float:
    """Critical value D_alpha for sample size n at significance alpha.

    Asymptotic (Smirnov) form  D_alpha = sqrt(-ln(alpha/2) / (2 n)),
    with the small-sample correction  sqrt(n) -> sqrt(n) + 0.12 + 0.11/sqrt(n)
    (Stephens 1970), accurate to <1% for n >= 5 — the paper's reference-table
    lookup, in closed form.
    """
    if n <= 0:
        return 1.0
    c_alpha = math.sqrt(-0.5 * math.log(alpha / 2.0))
    sqrt_n = math.sqrt(n)
    return c_alpha / (sqrt_n + 0.12 + 0.11 / sqrt_n)


def ks_pvalue(d: float, n: int) -> float:
    """Two-sided asymptotic p-value via the Kolmogorov distribution tail.

    P(D > d) ~ 2 * sum_{j>=1} (-1)^{j-1} exp(-2 j^2 n d^2).
    """
    if n <= 0 or d <= 0:
        return 1.0
    t = (math.sqrt(n) + 0.12 + 0.11 / math.sqrt(n)) * d
    total = 0.0
    for j in range(1, 101):
        term = (-1.0) ** (j - 1) * math.exp(-2.0 * j * j * t * t)
        total += term
        if abs(term) < 1e-12:
            break
    return max(0.0, min(1.0, 2.0 * total))


def ks_test_random(gaps: Sequence[float], c: int, alpha: float) -> tuple[bool, float, float]:
    """Test H0: 'gaps are drawn from the triangular law over [1, c]'.

    Returns (accept_H0, D_max, D_alpha).  accept_H0=True means the stream is
    consistent with the *random* pattern at significance ``alpha``.
    A zero gap (immediate re-access of the same item) is impossible under H0
    (one access per item per epoch), so zero gaps land below the support and
    inflate D_max naturally via F(0)=0.
    """
    n = len(gaps)
    if n == 0 or c < 3:
        return False, 1.0, 0.0
    d = ecdf_ks_statistic(gaps, lambda k: triangular_cdf(k, c))
    d_alpha = ks_critical(n, alpha)
    return d < d_alpha, d, d_alpha


# ---------------------------------------------------------------------------
# Vectorized (matrix) forms — one K-S test per row, all rows in one shot.
# The scalar functions above are the cross-checked reference (see
# tests/test_equivalence.py); these must agree with them row by row.
# ---------------------------------------------------------------------------

def triangular_cdf_matrix(k: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Elementwise triangular CDF; ``c`` broadcasts per row (shape (R, 1)).

    Mirrors :func:`triangular_cdf`: F = 2k/(c-1) - k(k+1)/(c(c-1)) with k
    clamped to [?, c-1], floored, and F=0 below the support / F=1 for c<2.
    """
    c = c.astype(np.float64)
    kf = np.floor(np.minimum(k.astype(np.float64), c - 1.0))
    with np.errstate(divide="ignore", invalid="ignore"):
        f = 2.0 * kf / (c - 1.0) - kf * (kf + 1.0) / (c * (c - 1.0))
    f = np.where(kf < 1.0, 0.0, f)
    return np.where(c < 2.0, 1.0, f)


def ks_critical_vec(n: np.ndarray, alpha: float) -> np.ndarray:
    """Row-wise Smirnov critical values (same closed form as ks_critical)."""
    n = n.astype(np.float64)
    c_alpha = math.sqrt(-0.5 * math.log(alpha / 2.0))
    with np.errstate(divide="ignore", invalid="ignore"):
        sqrt_n = np.sqrt(n)
        d = c_alpha / (sqrt_n + 0.12 + 0.11 / sqrt_n)
    return np.where(n <= 0, 1.0, d)


def ks_test_random_matrix(abs_gaps: np.ndarray, lengths: np.ndarray,
                          c: np.ndarray, alpha: float
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Matrix form of :func:`ks_test_random`.

    ``abs_gaps`` is an (R, G) matrix of |gap| samples, row r padded beyond
    ``lengths[r]`` with a value larger than any real sample (so the padded
    tail sorts to the end and is masked out).  ``c`` is the per-row index-
    space size.  Returns (accept_H0, D, D_alpha) arrays of shape (R,).

    Row results are independent of the other rows and of the padded width:
    every per-row quantity is either an exact integer count, an elementwise
    float op, or a masked max — no cross-column float accumulation — so a
    window classifies identically whether it rides alone or in a batch.
    """
    R, G = abs_gaps.shape
    srt = np.sort(abs_gaps, axis=1)
    pos = np.arange(1, G + 1, dtype=np.float64)[None, :]
    mask = pos <= lengths[:, None]
    n = lengths.astype(np.float64)[:, None]
    f = triangular_cdf_matrix(srt, c[:, None])
    with np.errstate(divide="ignore", invalid="ignore"):
        d_plus = pos / n - f
        d_minus = f - (pos - 1.0) / n
    dev = np.maximum(d_plus, d_minus)
    dev = np.where(mask, dev, -np.inf)
    d = np.max(dev, axis=1)
    d = np.where(lengths > 0, d, 0.0)
    d_alpha = ks_critical_vec(lengths, alpha)
    accept = (d < d_alpha) & (lengths > 0) & (c >= 3)
    d = np.where((lengths == 0) | (c < 3), 1.0, d)
    d_alpha = np.where((lengths == 0) | (c < 3), 0.0, d_alpha)
    return accept, d, d_alpha


def normal_quantile(p: float) -> float:
    """Inverse standard-normal CDF (Acklam's rational approximation).

    Used by the adaptive-TTL fit (§3.3); |error| < 1.15e-9 over (0,1).
    """
    if not 0.0 < p < 1.0:
        raise ValueError("p must be in (0,1)")
    a = [-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00]
    plow, phigh = 0.02425, 1 - 0.02425
    if p < plow:
        q = math.sqrt(-2 * math.log(p))
        return (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
               ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    if p > phigh:
        q = math.sqrt(-2 * math.log(1 - p))
        return -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
               ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    q = p - 0.5
    r = q * q
    return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q / \
           (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)
