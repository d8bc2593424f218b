"""Null (background) models: null1, the bias-filter HMM, and BATH's
three-frame translated variants.

Re-provides P7_BG (ref: src/p7_bg.c) plus the subset of
Easel's esl_hmm general-HMM module used by the bias filter
(esl_hmm_Configure / esl_hmm_Forward semantics, scaled float32 forward
with per-row max normalization).
"""

from __future__ import annotations

import numpy as np

from .alphabet import Alphabet, amino
from .gencode import GeneticCode
from .logsum import flogsum

# Swiss-Prot 50.8 background amino frequencies (ref: hmmer.c:161-183).
AMINO_FREQS = np.array([
    0.0787945, 0.0151600, 0.0535222, 0.0668298, 0.0397062,
    0.0695071, 0.0229198, 0.0590092, 0.0594422, 0.0963728,
    0.0237718, 0.0414386, 0.0482904, 0.0395639, 0.0540978,
    0.0683364, 0.0540687, 0.0673417, 0.0114135, 0.0304133,
], dtype=np.float32)


class Background:
    """null1 + 2-state bias filter HMM (ref: p7_bg.c)."""

    def __init__(self, abc: Alphabet | None = None):
        self.abc = abc or amino()
        if self.abc.kind == "amino":
            self.f = AMINO_FREQS.copy()
        else:
            self.f = np.full(self.abc.K, 1.0 / self.abc.K, dtype=np.float32)
        self.p1 = np.float32(350.0 / 351.0)
        self.omega = np.float32(1.0 / 256.0)
        # 2-state filter HMM: t[2][3] ([to0, to1, toE]), pi[2], e[2][K]
        self._t = np.zeros((2, 3), dtype=np.float32)
        self._pi = np.zeros(2, dtype=np.float32)
        self._e = np.zeros((2, self.abc.K), dtype=np.float32)
        self._eo = None   # odds ratios [Kp, 2]

    # ref: p7_bg_SetLength (p7_bg.c:188)
    def set_length(self, L: int):
        self.p1 = np.float32(L) / np.float32(L + 1)
        self._t[0, 0] = self.p1
        self._t[0, 1] = np.float32(1.0) - self.p1

    # ref: p7_bg_NullOne (p7_bg.c:356)
    def null_one(self, L: int) -> float:
        return float(np.float32(L) * np.log(self.p1) + np.log(1.0 - self.p1))

    # ref: p7_bg_fs_NullOne (p7_bg.c:377)
    def fs_null_one(self, amino_L: int) -> float:
        return float(np.float32(amino_L) * np.log(self.p1)
                     + np.log(1.0 - self.p1) + np.log(3.0))

    # ref: p7_bg_SetFilter (p7_bg.c:449)
    def set_filter(self, M: int, compo: np.ndarray):
        # memoized: bathsearch re-sets the same (M, om->compo) filter
        # for every window (and briefly swaps in per-window local
        # compositions) — key on the actual values
        key = (M, compo[: self.abc.K].tobytes())
        cache = self.__dict__.setdefault("_filter_cache", {})
        ent = cache.get(key)
        if ent is not None:
            # _t is later mutated in place by set_length; hand out a
            # copy so the cached pristine version stays intact
            self._t = ent[0].copy()
            self._e, self._pi, self._eo = ent[1], ent[2], ent[3]
            return
        L0 = np.float32(400.0)
        L1 = np.float32(M) / np.float32(8.0)
        self._t = np.array([[L0 / (L0 + 1), 1.0 / (L0 + 1), 1.0],
                            [1.0 / (L1 + 1), L1 / (L1 + 1), 1.0]],
                           dtype=np.float32)
        self._e = np.stack([self.f,
                            compo[: self.abc.K].astype(np.float32)])
        self._pi = np.array([0.999, 0.001], dtype=np.float32)
        self._configure()
        if len(cache) > 64:
            cache.clear()
        cache[key] = (self._t.copy(), self._e, self._pi, self._eo)

    # ref: easel esl_hmm_Configure — emission odds ratios incl. degenerates
    def _configure(self):
        K, Kp = self.abc.K, self.abc.Kp
        eo = np.zeros((Kp, 2), dtype=np.float32)
        for x in range(K):
            eo[x] = self._e[:, x] / self.f[x]
        eo[K] = 1.0          # gap
        eo[Kp - 2] = 1.0     # nonresidue
        eo[Kp - 1] = 1.0     # missing
        for x in range(K + 1, Kp - 2):
            mem = self.abc.degen[x, :K]
            denom = self.f[mem].sum()
            num = self._e[:, mem].sum(axis=1)
            eo[x] = num / denom if denom > 0 else 0.0
        self._eo = eo

    # ref: easel esl_hmm_Forward — scaled forward over the 2-state HMM
    def _hmm_forward(self, dsq: np.ndarray) -> float:
        L = len(dsq)
        if L == 0:
            return 0.0
        from .native import bg_hmm_forward_native
        sc = bg_hmm_forward_native(dsq, self._eo, self._pi, self._t)
        if sc is not None:
            return sc
        eo = self._eo
        t = self._t
        logsc = np.float32(0.0)
        d0 = np.float32(eo[dsq[0], 0] * self._pi[0])
        d1 = np.float32(eo[dsq[0], 1] * self._pi[1])
        mx = max(d0, d1)
        d0, d1 = d0 / mx, d1 / mx
        logsc += np.float32(np.log(mx))
        # explicit mul/mul/add order (the canonical IEEE-f32 order the
        # native path uses; numpy's tiny `@` routes through BLAS whose
        # FMA differs by 1 ulp)
        for i in range(1, L):
            e0, e1 = eo[dsq[i], 0], eo[dsq[i], 1]
            n0 = np.float32(d0 * t[0, 0] + d1 * t[1, 0]) * e0
            n1 = np.float32(d0 * t[0, 1] + d1 * t[1, 1]) * e1
            mx = max(n0, n1)
            d0, d1 = n0 / mx, n1 / mx
            logsc += np.float32(np.log(mx))
        end = np.float32(d0 * t[0, 2] + d1 * t[1, 2])
        return float(logsc + np.float32(np.log(end)))

    # ref: p7_bg_FilterScore (p7_bg.c:491)
    def filter_score(self, dsq: np.ndarray) -> float:
        L = len(dsq)
        nullsc = self._hmm_forward(dsq)
        return float(nullsc + np.float32(L) * np.log(self.p1)
                     + np.log(np.float32(1.0) - self.p1))

    # ref: p7_bg_fs_FilterScore (p7_bg.c:522) — translate 3 frames,
    # drop non-canonical aminos, logsum the 3 forward scores.
    def fs_filter_score(self, dna_dsq: np.ndarray,
                        gcode: GeneticCode) -> float:
        L = len(dna_dsq)
        sum_nullsc = np.float32(-np.inf)
        for f in range(3):
            aa = gcode.translate_vec(dna_dsq[f:], 0) if f else \
                gcode.translate_vec(dna_dsq, 0)
            aa = aa[aa < self.abc.K]
            nullsc = self._hmm_forward(aa)
            sum_nullsc = flogsum(sum_nullsc, np.float32(nullsc))
        return float(sum_nullsc + np.float32(L // 3) * np.log(self.p1)
                     + np.log(np.float32(1.0) - self.p1) + np.log(3.0))
