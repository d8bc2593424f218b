"""Search profiles: standard (amino) and frameshift codon profiles.

Re-provides P7_PROFILE / P7_FS_PROFILE and their configuration
(ref: src/modelconfig.c p7_ProfileConfig :47,
p7_ProfileConfig_fs :220; p7_profile.c).  Scores are natural-log
odds ratios stored in dense numpy arrays:

  tsc[M, 8]      transitions, [k][P_*] for k=0..M-1; BM stored
                 off-by-one: tsc[k-1][P_BM] is the B->Mk entry score
  msc[Kp, M+1]   match emission log-odds (isc is implicitly 0/-inf:
                 reference hardwires insert scores to 0, ref
                 modelconfig.c:153-169)
  xsc[4][2]      special transitions [ENJC][LOOP/MOVE]

Frameshift profile adds:
  rsc_fs[MAXCODONS + Kp, M+1]  codon/quasicodon emission scores
  codons[MAXCODONS, M+1]       best-scoring amino per (codon,k)
  indel_pos[MAXCODONS, M+1]    indel placement code per (codon,k)
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import constants as C
from .alphabet import Alphabet
from .bg import Background
from .gencode import GeneticCode
from .hmm import HMM

NEG_INF = np.float32(-np.inf)


@dataclass
class Profile:
    M: int
    abc: Alphabet
    tsc: np.ndarray        # [M, 8] float32
    msc: np.ndarray        # [Kp, M+1] float32
    xsc: np.ndarray        # [4, 2] float32
    mode: int = C.P7_LOCAL
    L: int = 0
    nj: float = 1.0
    max_length: int = -1
    name: str = ""
    acc: str = ""
    desc: str = ""
    consensus: str = ""
    rf: str = ""
    mm: str = ""
    cs: str = ""
    evparam: np.ndarray = field(default_factory=lambda: np.full(
        C.NEVPARAM, C.EVPARAM_UNSET, dtype=np.float32))
    cutoff: np.ndarray = field(default_factory=lambda: np.full(
        C.NCUTOFFS, C.CUTOFF_UNSET, dtype=np.float32))
    compo: np.ndarray | None = None

    # ref: modelconfig.c p7_ReconfigLength :722
    def reconfig_length(self, L: int):
        pmove = (np.float32(2.0) + np.float32(self.nj)) / (
            np.float32(L) + np.float32(2.0) + np.float32(self.nj))
        ploop = np.float32(1.0) - pmove
        self.xsc[C.X_N, C.LOOP] = self.xsc[C.X_C, C.LOOP] = \
            self.xsc[C.X_J, C.LOOP] = np.log(ploop)
        self.xsc[C.X_N, C.MOVE] = self.xsc[C.X_C, C.MOVE] = \
            self.xsc[C.X_J, C.MOVE] = np.log(pmove)
        self.L = L

    # ref: modelconfig.c p7_ReconfigMultihit :797 / p7_ReconfigUnihit :848
    def reconfig_multihit(self, L: int):
        self.xsc[C.X_E, C.MOVE] = -np.float32(C.CONST_LOG2)
        self.xsc[C.X_E, C.LOOP] = -np.float32(C.CONST_LOG2)
        self.nj = 1.0
        self.reconfig_length(L)

    def reconfig_unihit(self, L: int):
        self.xsc[C.X_E, C.MOVE] = np.float32(0.0)
        self.xsc[C.X_E, C.LOOP] = NEG_INF
        self.nj = 0.0
        self.reconfig_length(L)

    @property
    def is_local(self) -> bool:
        return C.is_local(self.mode)

    @property
    def is_multihit(self) -> bool:
        return self.nj > 0.0


def _entry_scores(hmm: HMM, local: bool) -> np.ndarray:
    """B->Mk entry scores; returns [M] array where entry[k-1] is B->Mk
    (ref: modelconfig.c:85-111)."""
    M = hmm.M
    out = np.empty(M, dtype=np.float32)
    if local:
        occ, _ = hmm.calculate_occupancy()
        Z = np.float32(0.0)
        for k in range(1, M + 1):
            Z += occ[k] * np.float32(M - k + 1)
        out[:] = np.log(occ[1:] / Z)
    else:
        t = hmm.t
        Z = np.log(t[0, C.H_MD])
        out[0] = np.log(1.0 - t[0, C.H_MD])
        for k in range(1, M):
            out[k] = Z + np.log(t[k, C.H_DM])
            Z += np.log(t[k, C.H_DD])
    return out


def _copy_annotation(gm, hmm: HMM):
    gm.max_length = hmm.max_length
    gm.name, gm.acc, gm.desc = hmm.name, hmm.acc, hmm.desc
    gm.consensus, gm.rf, gm.mm, gm.cs = (hmm.consensus, hmm.rf, hmm.mm,
                                         hmm.cs)
    gm.evparam = hmm.evparam.copy()
    gm.cutoff = hmm.cutoff.copy()
    gm.compo = None if hmm.compo is None else hmm.compo.copy()



def _pairwise_rows(A):
    """numpy's 1-D pairwise f32 sum (n <= 128), vectorized over
    rows — bit-identical to per-row np.sum of the 1-D slices."""
    n = A.shape[1]
    if n == 0:
        return np.zeros(A.shape[0], np.float32)
    if n < 8:
        s = A[:, 0].copy()
        for j in range(1, n):
            s = s + A[:, j]
        return s
    r = [A[:, j].copy() for j in range(8)]
    i = 8
    while i + 8 <= n:
        for j in range(8):
            r[j] = r[j] + A[:, i + j]
        i += 8
    res = ((r[0] + r[1]) + (r[2] + r[3])) \
        + ((r[4] + r[5]) + (r[6] + r[7]))
    while i < n:
        res = res + A[:, i]
        i += 1
    return res


def profile_config(hmm: HMM, bg: Background, L: int = 100,
                   mode: int = C.P7_LOCAL) -> Profile:
    """Standard profile configuration (ref: modelconfig.c p7_ProfileConfig)."""
    M, abc = hmm.M, hmm.abc
    K, Kp = abc.K, abc.Kp

    tsc = np.full((M, C.NTRANS), NEG_INF, dtype=np.float32)
    with np.errstate(divide="ignore"):
        t = hmm.t
        for k in range(1, M):
            tsc[k, C.P_MM] = np.log(t[k, C.H_MM])
            tsc[k, C.P_MI] = np.log(t[k, C.H_MI])
            tsc[k, C.P_MD] = np.log(t[k, C.H_MD])
            tsc[k, C.P_IM] = np.log(t[k, C.H_IM])
            tsc[k, C.P_II] = np.log(t[k, C.H_II])
            tsc[k, C.P_DM] = np.log(t[k, C.H_DM])
            tsc[k, C.P_DD] = np.log(t[k, C.H_DD])
        tsc[:, C.P_BM] = _entry_scores(hmm, C.is_local(mode))

    # match emission log-odds + degenerate expectations, batched
    # over k (same f32/pairwise-sum arithmetic as the per-position
    # expect_score_vec loop it replaces — a visible cost at
    # database scale)
    msc = np.full((Kp, M + 1), NEG_INF, dtype=np.float32)
    with np.errstate(divide="ignore"):
        sc_all = np.log(hmm.mat[1:M + 1].astype(np.float64)
                        / bg.f).astype(np.float32)       # [M, K]
    msc[:K, 1:] = sc_all.T
    fK = bg.f[:K].astype(np.float32)
    for x in range(K + 1, Kp - 2):
        mem = abc.degen[x, :K]
        denom = np.float32(fK[mem].sum())
        num = _pairwise_rows(
            np.ascontiguousarray(sc_all[:, mem] * fK[mem]))
        msc[x, 1:] = num / denom

    xsc = np.zeros((4, 2), dtype=np.float32)
    gm = Profile(M=M, abc=abc, tsc=tsc, msc=msc, xsc=xsc, mode=mode)
    _copy_annotation(gm, hmm)
    if C.is_multihit(mode):
        gm.xsc[C.X_E, C.MOVE] = -np.float32(C.CONST_LOG2)
        gm.xsc[C.X_E, C.LOOP] = -np.float32(C.CONST_LOG2)
        gm.nj = 1.0
    else:
        gm.xsc[C.X_E, C.MOVE] = 0.0
        gm.xsc[C.X_E, C.LOOP] = NEG_INF
        gm.nj = 0.0
    gm.reconfig_length(L)
    return gm


@dataclass
class FSProfile:
    """Frameshift-aware codon profile (ref: hmmer.h P7_FS_PROFILE)."""
    M: int
    abc: Alphabet
    codon_lengths: int          # 5, 3, or 1
    tsc: np.ndarray             # [M, 8]
    rsc_fs: np.ndarray          # [maxcodons + Kp, M+1] float32
    codons: np.ndarray          # [maxcodons, M+1] int16
    indel_pos: np.ndarray       # [maxcodons, M+1] int8
    xsc: np.ndarray
    mode: int = C.P7_LOCAL
    L: int = 0                  # in amino units
    nj: float = 1.0
    fs: bool = False
    fsprob: float = 0.0
    max_length: int = -1
    name: str = ""
    acc: str = ""
    desc: str = ""
    consensus: str = ""
    evparam: np.ndarray = field(default_factory=lambda: np.full(
        C.NEVPARAM, C.EVPARAM_UNSET, dtype=np.float32))
    cutoff: np.ndarray = field(default_factory=lambda: np.full(
        C.NCUTOFFS, C.CUTOFF_UNSET, dtype=np.float32))
    compo: np.ndarray | None = None

    @property
    def maxcodons(self) -> int:
        return {5: C.MAXCODONS5, 3: C.MAXCODONS3, 1: C.MAXCODONS1}[
            self.codon_lengths]

    def amino_score(self, k: int, a: int) -> float:
        return float(self.rsc_fs[self.maxcodons + a, k])

    # ref: modelconfig.c p7_fs_ReconfigLength :760 (L in amino units)
    def reconfig_length(self, L_amino: int):
        pmove = (np.float32(2.0) + np.float32(self.nj)) / (
            np.float32(L_amino) + np.float32(2.0) + np.float32(self.nj))
        ploop = np.float32(1.0) - pmove
        self.xsc[C.X_N, C.LOOP] = self.xsc[C.X_C, C.LOOP] = \
            self.xsc[C.X_J, C.LOOP] = np.log(ploop)
        self.xsc[C.X_N, C.MOVE] = self.xsc[C.X_C, C.MOVE] = \
            self.xsc[C.X_J, C.MOVE] = np.log(pmove)
        self.L = L_amino

    def reconfig_multihit(self, L_amino: int):
        self.xsc[C.X_E, C.MOVE] = -np.float32(C.CONST_LOG2)
        self.xsc[C.X_E, C.LOOP] = -np.float32(C.CONST_LOG2)
        self.nj = 1.0
        self.reconfig_length(L_amino)

    def reconfig_unihit(self, L_amino: int):
        self.xsc[C.X_E, C.MOVE] = np.float32(0.0)
        self.xsc[C.X_E, C.LOOP] = NEG_INF
        self.nj = 0.0
        self.reconfig_length(L_amino)



# ---------------------------------------------------------------------
# Cached candidate enumeration for the fs codon tables: the (slot,
# amino, indel) triples and penalty classes depend only on the genetic
# code and codon system, not the model.  Candidate ORDER preserves the
# reference's strict-'>' tie-breaking (first max wins).
# ---------------------------------------------------------------------
_FS_CAND_CACHE: dict = {}


def _fs_candidates(gcode, codon_lengths: int, maxcodons: int, Kp: int):
    key = (gcode.transl_table, codon_lengths)
    hit = _FS_CAND_CACHE.get(key)
    if hit is not None:
        return hit
    basic = gcode.basic
    stop_aa = Kp - 2
    per_ci: dict[int, list] = {}

    def consider(ci, a, ind):
        lst = per_ci.setdefault(ci, [])
        # duplicates of the same amino can never win a strict-'>'
        # comparison against the first occurrence — drop them
        for aa, _ in lst:
            if aa == a:
                return
        lst.append((a, ind))

    c1 = C.codon1_fs5 if codon_lengths == 5 else None
    c2 = C.codon2_fs5 if codon_lengths == 5 else C.codon2_fs3
    c3 = C.codon3_fs5 if codon_lengths == 5 else C.codon3_fs3
    c4 = C.codon4_fs5 if codon_lengths == 5 else C.codon4_fs3
    # 0=none, 1=no_indel, 2=one_indel, 3=two_indel, 4=stop_codon
    pen_class = np.zeros(maxcodons, np.int8)
    for x in range(4):
        if codon_lengths == 5:
            pen_class[c1(x)] = 3
        for w in range(4):
            pen_class[c2(w, x)] = 2
            for v in range(4):
                a = int(basic[16 * v + 4 * w + x])
                if codon_lengths == 5:
                    consider(c1(x), a, C.I___X)
                    consider(c1(v), a, C.I_X__)
                consider(c2(w, x), a, C.I__XX)
                consider(c2(v, x), a, C.I_X_X)
                consider(c2(v, w), a, C.I_XX_)
                ci3 = c3(v, w, x)
                pen_class[ci3] = 4 if a == stop_aa else 1
                if a == stop_aa:
                    for subn in range(4):
                        consider(ci3, int(basic[16 * subn + 4 * w + x]),
                                 C.I_xXX)
                        consider(ci3, int(basic[16 * v + 4 * subn + x]),
                                 C.I_XxX)
                        consider(ci3, int(basic[16 * v + 4 * w + subn]),
                                 C.I_XXx)
                else:
                    consider(ci3, a, C.I_XXX)
                for u in range(4):
                    ci4 = c4(u, v, w, x)
                    pen_class[ci4] = 2
                    consider(ci4, int(basic[16 * u + 4 * v + x]),
                             C.I_XXxX)
                    consider(ci4, int(basic[16 * u + 4 * w + x]),
                             C.I_XxXX)
                    consider(ci4, int(basic[16 * v + 4 * w + x]),
                             C.I_xXXX)
                    if codon_lengths == 5:
                        for tt in range(4):
                            ci5 = C.codon5_fs5(tt, u, v, w, x)
                            pen_class[ci5] = 3
                            consider(ci5,
                                     int(basic[16 * tt + 4 * u + x]),
                                     C.I_XXxxX)
                            consider(ci5,
                                     int(basic[16 * tt + 4 * w + x]),
                                     C.I_XxxXX)
                            consider(ci5,
                                     int(basic[16 * v + 4 * w + x]),
                                     C.I_xxXXX)
    cis = np.array(sorted(per_ci), np.int64)
    width = max(len(v) for v in per_ci.values())
    # pad with the nonresidue amino (score always -inf, after all real
    # candidates, so first-max selection is unaffected)
    cand = np.full((len(cis), width), stop_aa, np.int16)
    ind = np.zeros((len(cis), width), np.int8)
    for r, ci in enumerate(cis):
        lst = per_ci[ci]
        for j, (a, d) in enumerate(lst):
            cand[r, j] = a
            ind[r, j] = d
    out = (cis, cand, ind, pen_class)
    _FS_CAND_CACHE[key] = out
    return out


def profile_config_fs(hmm: HMM, bg: Background, gcode: GeneticCode,
                      codon_lengths: int, L_amino: int = 100,
                      mode: int = C.P7_LOCAL) -> FSProfile:
    """Frameshift codon profile configuration
    (ref: modelconfig.c p7_ProfileConfig_fs :220-698).

    For every codon/quasicodon slot we take the max-scoring amino over
    all compatible interpretations, record the winning amino and indel
    placement, then add the frameshift penalties: log(fsprob) for one
    indel, log(fsprob/2) for two, log(1-4*fsprob) (5-codon) or
    log(1-3*fsprob) (3-codon) for a clean codon; stop codons score via
    their best single-nucleotide substitution with penalty log(fsprob).
    The loop order matches the reference exactly so that tie-breaking
    (strict '>' comparisons) picks the same amino/indel annotation.
    """
    M, abc = hmm.M, hmm.abc
    K, Kp = abc.K, abc.Kp
    maxcodons = {5: C.MAXCODONS5, 3: C.MAXCODONS3, 1: C.MAXCODONS1}[
        codon_lengths]
    fsprob = hmm.fsprob

    one_indel = two_indel = no_indel = stop_codon = np.float32(0.0)
    with np.errstate(divide="ignore"):   # fsprob=0 -> -inf intended
        if codon_lengths == 5:
            one_indel = np.float32(np.log(fsprob))
            two_indel = np.float32(np.log(fsprob / 2.0))
            stop_codon = np.float32(np.log(fsprob))
            no_indel = np.float32(np.log(1.0 - fsprob * 4.0))
        elif codon_lengths == 3:
            one_indel = np.float32(np.log(fsprob))
            stop_codon = np.float32(np.log(fsprob))
            no_indel = np.float32(np.log(1.0 - fsprob * 3.0))

    # transitions identical to the standard profile
    tsc = np.full((M, C.NTRANS), NEG_INF, dtype=np.float32)
    with np.errstate(divide="ignore"):
        t = hmm.t
        for k in range(1, M):
            tsc[k, C.P_MM] = np.log(t[k, C.H_MM])
            tsc[k, C.P_MI] = np.log(t[k, C.H_MI])
            tsc[k, C.P_MD] = np.log(t[k, C.H_MD])
            tsc[k, C.P_IM] = np.log(t[k, C.H_IM])
            tsc[k, C.P_II] = np.log(t[k, C.H_II])
            tsc[k, C.P_DM] = np.log(t[k, C.H_DM])
            tsc[k, C.P_DD] = np.log(t[k, C.H_DD])
        tsc[:, C.P_BM] = _entry_scores(hmm, C.is_local(mode))

    rsc = np.full((maxcodons + Kp, M + 1), NEG_INF, dtype=np.float32)
    codons = np.zeros((maxcodons, M + 1), dtype=np.int16)
    indel = np.zeros((maxcodons, M + 1), dtype=np.int8)

    # amino section of the emission table (rows maxcodons..maxcodons+Kp-1)
    # — batched over k (np.sum rows reduce pairwise exactly like the
    # per-k vectors of the scalar build)
    with np.errstate(divide="ignore"):
        sc_all = np.log(hmm.mat[1:M + 1].astype(np.float64)
                        / bg.f).astype(np.float32)       # [M, K]
    asc_all = np.full((M, Kp), NEG_INF, np.float32)
    asc_all[:, :K] = sc_all
    fK = bg.f[:K].astype(np.float32)

    for x in range(K + 1, Kp - 2):
        mem = abc.degen[x, :K]
        denom = np.float32(fK[mem].sum())
        num = _pairwise_rows(
            np.ascontiguousarray(sc_all[:, mem] * fK[mem]))
        asc_all[:, x] = num / denom
    rsc[maxcodons:, 1:M + 1] = asc_all.T

    asc = rsc[maxcodons:, :]          # [Kp, M+1] amino scores view
    basic = gcode.basic
    stop_aa = Kp - 2

    if codon_lengths in (5, 3):
        # vectorized max-over-candidates (ref loop order preserved in
        # the cached candidate lists; np.argmax keeps the first max =
        # the reference's strict-'>' tie-break)
        cis, cand, ind_arr, pen_class = _fs_candidates(
            gcode, codon_lengths, maxcodons, Kp)
        n_ci, width = cand.shape
        best = np.full((n_ci, M + 1), NEG_INF, np.float32)
        ba = np.zeros((n_ci, M + 1), np.int16)
        bi = np.zeros((n_ci, M + 1), np.int8)
        for j in range(width):
            cj = asc[cand[:, j]]            # [n_ci, M+1]
            upd = cj > best
            best = np.where(upd, cj, best)
            ba = np.where(upd, cand[:, j:j + 1], ba)
            bi = np.where(upd, ind_arr[:, j:j + 1], bi)
        rsc[cis] = best
        codons[cis] = ba
        indel[cis] = bi

        # indel costs (ref: modelconfig.c:497-519 / :632-648)
        pen_values = np.array([0.0, no_indel, one_indel, two_indel,
                               stop_codon], np.float32)
        rsc[:maxcodons] += pen_values[pen_class][:, None]

        # degenerate placeholders (ref: modelconfig.c:521-537 / :650-661)
        a = Kp - 3
        if codon_lengths == 5:
            for ci, pen in ((C.DEGEN5_C, no_indel), (C.DEGEN5_QC1, one_indel),
                            (C.DEGEN5_QC2, two_indel)):
                rsc[ci] = asc[a] + pen
                codons[ci] = a
                indel[ci] = C.I_xxx
        else:
            for ci, pen in ((C.DEGEN3_C, no_indel), (C.DEGEN3_QC1, one_indel)):
                rsc[ci] = asc[a] + pen
                codons[ci] = a
                indel[ci] = C.I_xxx
    elif codon_lengths == 1:
        for x in range(4):
            for w in range(4):
                for v in range(4):
                    a = int(basic[16 * v + 4 * w + x])
                    ci = C.codon3_fs1(v, w, x)
                    rsc[ci] = asc[a]
                    codons[ci] = a
                    indel[ci] = C.I_XXX
        a = Kp - 3
        rsc[C.DEGEN1_C] = asc[a]
        codons[C.DEGEN1_C] = a
        indel[C.DEGEN1_C] = C.I_xxx
    else:
        raise ValueError("codon_lengths must be 1, 3, or 5")

    # k=0 column is unused: force -inf so no path can use it
    rsc[:, 0] = NEG_INF

    xsc = np.zeros((4, 2), dtype=np.float32)
    gm = FSProfile(M=M, abc=abc, codon_lengths=codon_lengths, tsc=tsc,
                   rsc_fs=rsc, codons=codons, indel_pos=indel, xsc=xsc,
                   mode=mode, fs=hmm.fs, fsprob=fsprob)
    _copy_annotation(gm, hmm)
    if C.is_multihit(mode):
        gm.xsc[C.X_E, C.MOVE] = -np.float32(C.CONST_LOG2)
        gm.xsc[C.X_E, C.LOOP] = -np.float32(C.CONST_LOG2)
        gm.nj = 1.0
    else:
        gm.xsc[C.X_E, C.MOVE] = 0.0
        gm.xsc[C.X_E, C.LOOP] = NEG_INF
        gm.nj = 0.0
    gm.reconfig_length(L_amino)
    return gm
