"""Table-driven log-sum-exp, matching the reference numerics.

Reference: src/logsum.c.  p7_FLogsum(a,b) approximates
log(e^a + e^b) using a 16000-entry lookup of log(1+e^(-d)) on a
0.001-nat grid.  The DP "generic" kernels in the reference use this
table; the table error is part of the golden outputs, so we reproduce
it exactly (float32).  Exact mode is available for kernel-vs-kernel
tolerance-tightening tests (the reference's recompile-as-exact trick,
ref: impl_sse/fwdback_fs.c:3185).
"""

from __future__ import annotations

import numpy as np

SCALE = 1000.0
TBL = 16000

_table = None


def _lookup_table() -> np.ndarray:
    global _table
    if _table is None:
        i = np.arange(TBL, dtype=np.float64)
        _table = np.log1p(np.exp(-i / SCALE)).astype(np.float32)
    return _table


def flogsum(a, b):
    """Scalar table-driven logsum in float32, matching p7_FLogsum."""
    tbl = _lookup_table()
    a = np.float32(a)
    b = np.float32(b)
    mx = max(a, b)
    mn = min(a, b)
    if mn == np.float32(-np.inf) or (mx - mn) >= np.float32(15.7):
        return mx
    return np.float32(mx + tbl[int((mx - mn) * SCALE)])


def flogsum_vec(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Vectorized table-driven logsum (float32 arrays)."""
    tbl = _lookup_table()
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    mx = np.maximum(a, b)
    mn = np.minimum(a, b)
    d = mx - mn
    with np.errstate(invalid="ignore"):
        idx = (d * np.float32(SCALE)).astype(np.int64)
    take_max = np.isneginf(mn) | (d >= np.float32(15.7)) | ~np.isfinite(d)
    idx = np.where(take_max, 0, np.clip(idx, 0, TBL - 1))
    out = mx + tbl[idx]
    return np.where(take_max, mx, out).astype(np.float32)


def logsum_exact(a, b):
    """Exact log(e^a+e^b) (float64)."""
    return np.logaddexp(a, b)
