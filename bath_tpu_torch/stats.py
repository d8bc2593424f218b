"""Extreme-value statistics: Gumbel and exponential distributions.

Re-provides the subset of Easel's esl_gumbel / esl_exponential that
the pipeline and calibration use (ref: p7_pipeline.c esl_gumbel_surv /
esl_exp_surv calls; evalues.c fitting).
"""

from __future__ import annotations

import numpy as np


# --- Gumbel (Type I EVD) ----------------------------------------------
def gumbel_surv(x, mu, lam):
    """P(S > x) for Gumbel(mu, lambda).  Matches esl_gumbel_surv:
    1 - exp(-exp(-lambda(x-mu))), computed accurately in both tails."""
    y = lam * (x - mu)
    ey = -np.exp(-y)
    # for tiny |ey|, 1-exp(ey) ~ -ey
    if np.ndim(ey) == 0:
        # scalar fast path (the per-ORF gates call this millions of
        # times): same arithmetic, branch instead of where
        return -ey if -1e-4 < ey else 1.0 - np.exp(ey)
    return np.where(np.abs(ey) < 1e-4, -ey, 1.0 - np.exp(ey))


def gumbel_logsurv(x, mu, lam):
    """log P(S > x) for Gumbel; matches esl_gumbel_logsurv's branches."""
    y = lam * (x - mu)
    ey = -np.exp(-y)
    out = np.where(
        np.abs(ey) < 1e-4,
        np.log(-ey),
        np.where(np.exp(ey) < 1e-4, ey, np.log(1.0 - np.exp(ey))),
    )
    return out


def gumbel_invsurv(p, mu, lam):
    """x such that P(S > x) = p (esl_gumbel_invsurv).

    Guarded at p >= 1 (e.g. --max sets filter thresholds to 1.0):
    the limit is x = -inf (every score survives), returned without
    tripping numpy's divide-by-zero warning in log1p."""
    if np.ndim(p) == 0:
        if p >= 1.0:
            return -np.inf
        return mu - np.log(-1.0 * np.log1p(-p)) / lam
    p = np.asarray(p, dtype=np.float64)
    with np.errstate(divide="ignore"):
        return np.where(p >= 1.0, -np.inf,
                        mu - np.log(-1.0 * np.log1p(np.minimum(p, 1.0 - 1e-300))) / lam)


# --- Exponential ------------------------------------------------------
def exp_surv(x, mu, lam):
    """P(S > x) for exponential tail starting at mu (esl_exp_surv):
    exp(-lambda (x-mu)) for x>=mu else 1."""
    if np.ndim(x) == 0:
        x = np.float64(x)         # scalar fast path, same arithmetic
        return 1.0 if x < mu else np.exp(-lam * (x - mu))
    x = np.asarray(x, dtype=np.float64)
    return np.where(x < mu, 1.0, np.exp(-lam * (x - mu)))


def exp_logsurv(x, mu, lam):
    x = np.asarray(x, dtype=np.float64)
    return np.where(x < mu, 0.0, -lam * (x - mu))


# --- Gumbel ML fitting (esl_gumbel_FitComplete) ----------------------
def gumbel_fit_complete(x: np.ndarray) -> tuple[float, float]:
    """Complete-data ML fit of Gumbel; returns (mu, lambda).
    Newton/bisection on the transcendental lambda equation, then
    mu from lambda (ref: easel esl_gumbel.c lawless416)."""
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    mean = x.mean()

    def lawless(lam):
        ex = np.exp(-lam * x)
        sx = ex.sum()
        sxe = (x * ex).sum()
        sx2e = (x * x * ex).sum()
        f = 1.0 / lam - mean + sxe / sx
        df = (sxe * sxe) / (sx * sx) - sx2e / sx - 1.0 / (lam * lam)
        return f, df

    lam = np.pi / np.sqrt(6.0 * np.var(x))
    for _ in range(100):
        f, df = lawless(lam)
        if abs(f) < 1e-6:
            break
        lam -= f / df
        if lam <= 0:
            lam = 0.001
    ex = np.exp(-lam * x)
    mu = -np.log(ex.mean()) / lam
    return float(mu), float(lam)


def gumbel_fit_fixlambda(x: np.ndarray, lam: float) -> float:
    """ML mu given fixed lambda (esl_gumbel_FitCompleteLoc)."""
    x = np.asarray(x, dtype=np.float64)
    return float(-np.log(np.exp(-lam * x).mean()) / lam)


# --- Exponential tail fitting (esl_exp_FitComplete) ------------------
def exp_fit_complete(x: np.ndarray) -> tuple[float, float]:
    """ML fit of exponential to complete data; returns (mu, lambda).
    mu = min(x); lambda = 1/(mean - mu)."""
    x = np.asarray(x, dtype=np.float64)
    mu = x.min()
    lam = 1.0 / (x.mean() - mu)
    return float(mu), float(lam)
