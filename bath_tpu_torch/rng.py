"""Deterministic RNG re-providing Easel's esl_randomness semantics.

The reference calibrates models with ``esl_randomness_CreateFast(42)``
(ref: evalues.c:95) and samples background sequences with
``esl_rsq_xfIID`` / ``esl_rnd_FChoose`` / ``esl_rnd_Roll``.  Modern
Easel's generator is the standard Mersenne Twister MT19937 with
uniform deviates u32/2^32; we implement that public algorithm here.
The Easel source is not vendored in this mount, so exact stream parity
with the reference binaries is not verifiable; calibration parity is
asserted statistically against the golden .bhmm STATS lines instead
(tests/test_calibration.py).
"""

from __future__ import annotations

import numpy as np

_N = 624
_M = 397
_MATRIX_A = 0x9908B0DF
_UPPER = 0x80000000
_LOWER = 0x7FFFFFFF


class Randomness:
    """MT19937 stream with Easel-style sampling helpers."""

    def __init__(self, seed: int = 42):
        if seed == 0:
            # one-time arbitrary seed (ref: esl_randomness_Create(0)
            # -> choose_arbitrary_seed: time ^ pid based)
            import os
            import time
            seed = ((int(time.time()) ^ (os.getpid() << 8))
                    & 0x7FFFFFFF) or 42
        self.seed_value = seed
        self._mt = np.zeros(_N, dtype=np.uint64)
        self._mti = _N + 1
        self._init_genrand(seed)

    def _init_genrand(self, s: int):
        mt = self._mt
        mt[0] = s & 0xFFFFFFFF
        for i in range(1, _N):
            mt[i] = (1812433253 * (mt[i - 1] ^ (mt[i - 1] >> 30)) + i) \
                & 0xFFFFFFFF
        self._mti = _N

    def reset(self):
        """Re-init from the original seed
        (ref: esl_randomness_Init(r, esl_randomness_GetSeed(r)))."""
        self._init_genrand(self.seed_value)

    def u32(self) -> int:
        if self._mti >= _N:
            self._generate_seq()
        y = int(self._mt[self._mti])
        self._mti += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60000
        y ^= y >> 18
        return y & 0xFFFFFFFF

    def _generate_seq(self):
        """Exact sequential MT19937 state refresh."""
        mt = self._mt
        for i in range(_N):
            y = (int(mt[i]) & _UPPER) | (int(mt[(i + 1) % _N]) & _LOWER)
            mt[i] = (int(mt[(i + _M) % _N]) ^ (y >> 1)
                     ^ (_MATRIX_A if y & 1 else 0)) & 0xFFFFFFFF
        self._mti = 0

    def random(self) -> float:
        """Uniform deviate on [0, 1) (esl_random)."""
        return self.u32() / 4294967296.0

    def roll(self, n: int) -> int:
        """Uniform integer 0..n-1 (esl_rnd_Roll)."""
        return int(self.random() * n)

    def f_choose(self, p: np.ndarray) -> int:
        """Sample index from discrete distribution p (esl_rnd_FChoose)."""
        roll = self.random()
        s = 0.0
        K = len(p)
        for a in range(K):
            s += float(p[a])
            if roll < s:
                return a
        # floating-point shortfall: return last index with p > 0
        for a in range(K - 1, -1, -1):
            if p[a] > 0:
                return a
        raise ValueError("f_choose: all-zero distribution")

    def sample_iid(self, p: np.ndarray, L: int) -> np.ndarray:
        """L iid draws from p (esl_rsq_xfIID), digital residues."""
        cum = np.cumsum(np.asarray(p, dtype=np.float64))
        from .native import sample_iid_native
        out = sample_iid_native(self, cum, L)
        if out is not None:
            return out
        rolls = np.array([self.random() for _ in range(L)])
        idx = np.searchsorted(cum, rolls, side="right")
        return np.minimum(idx, len(cum) - 1).astype(np.int32)
