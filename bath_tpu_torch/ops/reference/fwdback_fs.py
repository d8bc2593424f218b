"""Frameshift-aware Forward/Backward/decoding/OptAcc kernels —
reference semantics in k-contiguous numpy.

These reproduce impl_sse/{fwdback_fs,decoding_fs,optacc_fs,null2_fs}.c:
prob-space DP over codon emissions of 1-5 (or 2-4) nucleotides, with
the IVX shared-entry recurrence, circular-row scaling schemes, and the
reference's nucleotide-degeneracy handling (p7P_MINIDX routing to the
degenerate codon slots).

  fs_oprofile_convert()      ref: impl_sse/p7_fs_oprofile.c Convert
  forward_parser_fs3()       ref: fwdback_fs.c :97  (global rescale)
  backward_parser_fs3()      ref: fwdback_fs.c :565 (mirror)
  domain_decoding_fs()       ref: decoding_fs.c :242
  forward_fs5()              ref: fwdback_fs.c p7_Forward_Frameshift :2054
  backward_fs5()             ref: fwdback_fs.c p7_Backward_Frameshift :2634
  decoding_fs()              ref: decoding_fs.c p7_Decoding_Frameshift :55
  optimal_accuracy_fs()      ref: optacc_fs.c :53
  oa_trace_fs()              ref: optacc_fs.c :538
  null2_fs_by_expectation()  ref: null2_fs.c :53
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ... import constants as C
from ...logsum import flogsum
from ...profile import FSProfile
from .fwdback import PMatrix, RangeError, Trace

F32 = np.float32
NEG_INF = F32(-np.inf)

# Native C fast paths for the full-matrix fs5 stages (bit-identical;
# see native.fs5_*_native).  Tests flip this off to exercise the pure
# numpy reference.
_use_native_fs5 = True


@dataclass
class FSOProfile:
    """Prob-space frameshift profile (ref: P7_FS_OPROFILE, float part)."""
    M: int
    codon_lengths: int
    maxcodons: int
    Kp: int
    K: int
    rfv: np.ndarray          # [maxcodons + Kp, M+1] float32 odds (exp scores)
    tfv: np.ndarray          # [M+1, 8] float32 (slot k = transitions out of k)
    xf: np.ndarray           # [4, 2] float32
    mode: int = C.P7_LOCAL
    L: int = 0
    nj: float = 1.0
    fsprob: float = 0.0
    max_length: int = -1
    name: str = ""
    acc: str = ""
    desc: str = ""
    consensus: str = ""
    evparam: np.ndarray | None = None
    # carried from the FSProfile for traceback/display
    codons: np.ndarray | None = None
    indel_pos: np.ndarray | None = None
    rsc_amino: np.ndarray | None = None   # log-space amino scores

    def reconfig_length(self, L_amino: int):
        """pspace N/C/J loop/move (ref: p7_fs_oprofile_ReconfigLength)."""
        pmove = (F32(2.0) + F32(self.nj)) / (F32(L_amino) + F32(2.0)
                                             + F32(self.nj))
        ploop = F32(1.0) - pmove
        for s in (C.X_N, C.X_C, C.X_J):
            self.xf[s, C.LOOP] = ploop
            self.xf[s, C.MOVE] = pmove
        self.L = L_amino

    def reconfig_unihit(self, L_amino: int):
        self.xf[C.X_E, C.MOVE] = 1.0
        self.xf[C.X_E, C.LOOP] = 0.0
        self.nj = 0.0
        self.reconfig_length(L_amino)

    def reconfig_multihit(self, L_amino: int):
        self.xf[C.X_E, C.MOVE] = 0.5
        self.xf[C.X_E, C.LOOP] = 0.5
        self.nj = 1.0
        self.reconfig_length(L_amino)


def fs_oprofile_convert(gm_fs: FSProfile) -> FSOProfile:
    maxc = gm_fs.maxcodons
    with np.errstate(over="ignore"):
        rfv = np.exp(gm_fs.rsc_fs.astype(F32))
    tfv = np.zeros((gm_fs.M + 1, C.NTRANS), dtype=F32)
    tfv[: gm_fs.M] = np.exp(gm_fs.tsc)
    xf = np.exp(gm_fs.xsc.astype(F32))
    om = FSOProfile(M=gm_fs.M, codon_lengths=gm_fs.codon_lengths,
                    maxcodons=maxc, Kp=gm_fs.abc.Kp, K=gm_fs.abc.K,
                    rfv=rfv, tfv=tfv, xf=xf, mode=gm_fs.mode,
                    nj=gm_fs.nj, fsprob=gm_fs.fsprob,
                    max_length=gm_fs.max_length, name=gm_fs.name,
                    acc=gm_fs.acc, desc=gm_fs.desc,
                    consensus=gm_fs.consensus,
                    evparam=None if gm_fs.evparam is None
                    else gm_fs.evparam.copy(),
                    codons=gm_fs.codons, indel_pos=gm_fs.indel_pos,
                    rsc_amino=gm_fs.rsc_fs[maxc:, :])
    om.reconfig_length(gm_fs.L)
    return om


def codon_indices(dsq: np.ndarray, codon_lengths: int) -> dict:
    """Per-position codon/quasicodon emission-table indices, with the
    p7P_MINIDX degeneracy routing (ref: fwdback_fs.c codon index
    computation in the i-loops).  Entry [c][i-1] is the index for the
    codon of length c ending at 1-based position i (valid once i >= c,
    except the reference allows early rows to read placeholder-based
    indices, which we replicate via the MAXCODONS placeholder)."""
    L = len(dsq)
    if codon_lengths == 5:
        PLACE = C.MAXCODONS5
        x = np.where(dsq < C.MAXNUC, dsq, PLACE).astype(np.int64)
        xm1 = np.concatenate([[PLACE], x[:-1]])
        xm2 = np.concatenate([[PLACE, PLACE], x[:-2]])
        xm3 = np.concatenate([[PLACE] * 3, x[:-3]])
        xm4 = np.concatenate([[PLACE] * 4, x[:-4]])
        c1 = np.minimum(x * C.NUC1_FS5, C.DEGEN5_QC2)
        c2 = np.minimum(x * C.NUC1_FS5 + xm1 * C.NUC2_FS5 + C.C2,
                        C.DEGEN5_QC1)
        c3 = np.minimum(x * C.NUC1_FS5 + xm1 * C.NUC2_FS5
                        + xm2 * C.NUC3_FS5 + C.C3, C.DEGEN5_C)
        c4 = np.minimum(x * C.NUC1_FS5 + xm1 * C.NUC2_FS5
                        + xm2 * C.NUC3_FS5 + xm3 * C.NUC4_FS5 + C.C4,
                        C.DEGEN5_QC1)
        c5 = np.minimum(x * C.NUC1_FS5 + xm1 * C.NUC2_FS5
                        + xm2 * C.NUC3_FS5 + xm3 * C.NUC4_FS5 + xm4
                        + C.C5, C.DEGEN5_QC2)
        return {1: c1, 2: c2, 3: c3, 4: c4, 5: c5}
    elif codon_lengths == 3:
        PLACE = C.MAXCODONS3
        x = np.where(dsq < C.MAXNUC, dsq, PLACE).astype(np.int64)
        xm1 = np.concatenate([[PLACE], x[:-1]])
        xm2 = np.concatenate([[PLACE, PLACE], x[:-2]])
        xm3 = np.concatenate([[PLACE] * 3, x[:-3]])
        c2 = np.minimum(x * C.NUC1_FS3 + xm1 * C.NUC2_FS3, C.DEGEN3_QC1)
        c3 = np.minimum(x * C.NUC1_FS3 + xm1 * C.NUC2_FS3
                        + xm2 * C.NUC3_FS3 + C.C2, C.DEGEN3_C)
        c4 = np.minimum(x * C.NUC1_FS3 + xm1 * C.NUC2_FS3
                        + xm2 * C.NUC3_FS3 + xm3 + C.C3, C.DEGEN3_QC1)
        return {2: c2, 3: c3, 4: c4}
    raise ValueError("codon_lengths must be 3 or 5")


def _trans_views_fs(om: FSOProfile):
    M = om.M
    tfv = om.tfv
    z = np.zeros(1, dtype=F32)
    tBM = np.concatenate([z, tfv[:M, C.P_BM]])
    tMM = np.concatenate([z, tfv[:M, C.P_MM]])
    tIM = np.concatenate([z, tfv[:M, C.P_IM]])
    tDM = np.concatenate([z, tfv[:M, C.P_DM]])
    tMD = np.concatenate([z, tfv[:M, C.P_MD]])
    tDD = np.concatenate([z, tfv[:M, C.P_DD]])
    tMI = tfv[: M + 1, C.P_MI].copy()
    tII = tfv[: M + 1, C.P_II].copy()
    return tBM, tMM, tIM, tDM, tMD, tDD, tMI, tII


_FAST_DD_CACHE: dict = {}


def _dd_closure(dc: np.ndarray, tDD: np.ndarray, M: int,
                U: np.ndarray | None = None):
    """Sequential DD closure (reference order).  With <U> (a
    precomputed upper-triangular closure operator, see
    dd_closure_operator), uses one matvec instead — same values up to
    float summation order; used by calibration where speed matters."""
    if U is not None:
        dc[:] = dc @ U
        return
    from ...native import dd_closure_native
    if dc.dtype == np.float32 and tDD.dtype == np.float32 and \
            dc.flags.c_contiguous and tDD.flags.c_contiguous and \
            dd_closure_native(dc, tDD, M):
        return
    for k in range(2, M + 1):
        dc[k] += dc[k - 1] * tDD[k]


def dd_closure_operator(tDD: np.ndarray, M: int) -> np.ndarray:
    """U[j,k] = prod_{r=j+1}^{k} tDD[r] for k>=j (0..M index space,
    matching the dc arrays which have slot 0 unused)."""
    key = (tDD.tobytes(), M)
    if key in _FAST_DD_CACHE:
        return _FAST_DD_CACHE[key]
    with np.errstate(divide="ignore"):
        la = np.maximum(np.log(np.maximum(tDD[:M + 1], 0.0)), -745.0)
    cum = np.concatenate([[0.0], np.cumsum(la)])
    U = np.zeros((M + 1, M + 1), np.float32)
    for j in range(M + 1):
        with np.errstate(over="ignore"):
            v = np.exp(np.minimum(cum[j + 1:M + 2] - cum[j + 1], 0.0))
        U[j, j:] = np.where(np.isfinite(v), v, 0.0)
    _FAST_DD_CACHE[key] = U
    return U


def forward_parser_fs3(dsq: np.ndarray, om: FSOProfile,
                       fast: bool = False) -> tuple[PMatrix, float]:
    """3-codon frameshift Forward parser with the reference's global
    live-row rescaling (ref: fwdback_fs.c :97-560).  Stores specials +
    per-row scales only."""
    if not fast and _use_native_fs5:
        from ...native import fs3_parser_fwd_fill_native
        r = fs3_parser_fwd_fill_native(dsq, om)
        if r is not None:
            return r
    L, M = len(dsq), om.M
    xf = om.xf
    rfv = om.rfv
    tBM, tMM, tIM, tDM, tMD, tDD, tMI, tII = _trans_views_fs(om)
    ci = codon_indices(dsq, 3)
    U = dd_closure_operator(tDD, M) if fast else None

    ox = PMatrix(L=L, M=M,
                 xE=np.zeros(L + 1, F32), xN=np.zeros(L + 1, F32),
                 xJ=np.zeros(L + 1, F32), xB=np.zeros(L + 1, F32),
                 xC=np.zeros(L + 1, F32), scale=np.ones(L + 1, F32))
    # live circular rows: M, I, D for rows i, i-1, i-2, i-3
    NR = 4
    mrow = np.zeros((NR, M + 1), F32)
    irow = np.zeros((NR, M + 1), F32)
    drow = np.zeros((NR, M + 1), F32)
    ivx = np.zeros((3, M + 1), F32)
    xNb = np.zeros(NR, F32)
    xBb = np.zeros(NR, F32)
    xJb = np.zeros(NR, F32)
    xCb = np.zeros(NR, F32)
    xNb[0] = xNb[1] = 1.0
    xBb[0] = xBb[1] = xf[C.X_N, C.MOVE]
    for r in (0, 1):
        ox.xN[r] = 1.0
        ox.xB[r] = xf[C.X_N, C.MOVE]
    totscale = 0.0
    if L < 2:
        raise RangeError("sequence too short for fs parser")

    for i in range(2, L + 1):
        curr = i % NR
        prev2 = (i - 2) % NR
        prev3 = (i - 3) % NR
        s2 = i % 3
        s3 = (i - 1) % 3
        s4 = (i - 2) % 3
        b2 = (i - 2) % NR
        b3 = (i - 3) % NR

        mp = np.empty(M + 1, F32); mp[0] = 0; mp[1:] = mrow[prev2][:-1]
        ip = np.empty(M + 1, F32); ip[0] = 0; ip[1:] = irow[prev2][:-1]
        dp = np.empty(M + 1, F32); dp[0] = 0; dp[1:] = drow[prev2][:-1]
        sv = xBb[b2] * tBM + mp * tMM + ip * tIM + dp * tDM
        sv[0] = 0
        ivx[s2] = sv
        msv = sv * rfv[ci[2][i - 1]]
        if i >= 3:
            msv = msv + ivx[s3] * rfv[ci[3][i - 1]]
            msv = msv + ivx[s4] * rfv[ci[4][i - 1]]
        msv[0] = 0
        new_i = mrow[prev3] * tMI + irow[prev3] * tII
        new_i[0] = 0
        dc = np.zeros(M + 1, F32)
        dc[2:] = msv[1:M] * tMD[2:]
        _dd_closure(dc, tDD, M, U)
        mrow[curr], irow[curr], drow[curr] = msv, new_i, dc
        xE = F32(msv[1:].sum()) + F32(dc[1:].sum())
        if i >= 3:
            xN = xNb[b3] * xf[C.X_N, C.LOOP]
            xJ = xJb[b3] * xf[C.X_J, C.LOOP] + xE * xf[C.X_E, C.LOOP]
            xC = xCb[b3] * xf[C.X_C, C.LOOP] + xE * xf[C.X_E, C.MOVE]
        else:
            xN = F32(1.0)
            xJ = xE * xf[C.X_E, C.LOOP]
            xC = xE * xf[C.X_E, C.MOVE]
        xB = xN * xf[C.X_N, C.MOVE] + xJ * xf[C.X_J, C.MOVE]

        if xE > F32(1.0e4):
            inv = F32(1.0) / xE
            xN, xJ, xC, xB = xN * inv, xJ * inv, xC * inv, xB * inv
            mrow *= inv; irow *= inv; drow *= inv; ivx *= inv
            xNb *= inv; xBb *= inv; xJb *= inv; xCb *= inv
            ox.scale[i] = xE
            totscale += float(np.log(xE))
            xE = F32(1.0)
        xNb[curr], xBb[curr], xJb[curr], xCb[curr] = xN, xB, xJ, xC
        ox.xE[i], ox.xN[i], ox.xJ[i] = xE, xN, xJ
        ox.xB[i], ox.xC[i] = xB, xC

    ox.totscale = totscale
    xCtot = (xCb[L % NR] + xCb[(L - 1) % NR] * xf[C.X_C, C.LOOP]
             + xCb[(L - 2) % NR] * xf[C.X_C, C.LOOP])
    if np.isnan(xCtot) or np.isinf(xCtot):
        raise RangeError("fs forward parser over/underflow")
    if L > 2 and xCtot == 0.0:
        raise RangeError("fs forward parser underflow")
    score = totscale + float(np.log(xCtot * xf[C.X_C, C.MOVE]))
    return ox, score


def backward_parser_fs3(dsq: np.ndarray, om: FSOProfile, fwd: PMatrix
                        ) -> tuple[PMatrix, float]:
    """3-codon frameshift Backward parser (mirror of the Forward;
    ref: fwdback_fs.c p7_BackwardParser_Frameshift_3Codons :565).
    Stores specials + scales; borrows the forward's scale factors with
    an overflow fallback to its own (has_own_scales)."""
    if _use_native_fs5:
        from ...native import fs3_parser_bwd_fill_native
        r = fs3_parser_bwd_fill_native(dsq, om, fwd)
        if r is not None:
            return r
    L, M = len(dsq), om.M
    xf = om.xf
    rfv = om.rfv
    tBM, tMM, tIM, tDM, tMD, tDD, tMI, tII = _trans_views_fs(om)
    ci = codon_indices(dsq, 3)

    bx = PMatrix(L=L, M=M,
                 xE=np.zeros(L + 1, F32), xN=np.zeros(L + 1, F32),
                 xJ=np.zeros(L + 1, F32), xB=np.zeros(L + 1, F32),
                 xC=np.zeros(L + 1, F32), scale=np.ones(L + 1, F32),
                 has_own_scales=False)
    # live rows for i+1..i+4 (codon reach 4) and i+3 for I
    NR = 6
    mrow = np.zeros((NR, M + 1), F32)
    irow = np.zeros((NR, M + 1), F32)
    drow = np.zeros((NR, M + 1), F32)
    xNb = np.zeros(NR, F32)
    xBb = np.zeros(NR, F32)
    xJb = np.zeros(NR, F32)
    xCb = np.zeros(NR, F32)
    totscale = 0.0

    cmove = xf[C.X_C, C.MOVE]
    cloop = xf[C.X_C, C.LOOP]

    for i in range(L, 0, -1):
        curr = i % NR
        # ivxb(i,k) = sum_c rfv[c at i+c][k] * bM(i+c, k), c in 2..4
        ivxb = np.zeros(M + 1, F32)
        for c in (2, 3, 4):
            j = i + c
            if j <= L:
                ivxb += rfv[ci[c][j - 1]] * mrow[j % NR]
        # specials
        if i == L or i == L - 1 or i == L - 2:
            xC = cmove if i == L else cloop * cmove
        else:
            xC = cloop * xCb[(i + 3) % NR]
        xB = F32((ivxb[1:] * tBM[1:]).sum())
        xJ = (xJb[(i + 3) % NR] * xf[C.X_J, C.LOOP] if i + 3 <= L else
              F32(0.0)) + xB * xf[C.X_J, C.MOVE]
        xN = (xNb[(i + 3) % NR] * xf[C.X_N, C.LOOP] if i + 3 <= L else
              F32(0.0)) + xB * xf[C.X_N, C.MOVE]
        xE = xC * xf[C.X_E, C.MOVE] + xJ * xf[C.X_E, C.LOOP]

        # ivxb at k+1 for M/I/D recurrences
        iv1 = np.zeros(M + 1, F32)
        iv1[:M] = ivxb[1:]
        bI3 = irow[(i + 3) % NR] if i + 3 <= L else np.zeros(M + 1, F32)
        bM3 = mrow[(i + 3) % NR] if i + 3 <= L else np.zeros(M + 1, F32)
        # transitions out of k use slot k: tfv[k]
        tMMk = np.zeros(M + 1, F32); tMMk[:M] = tMM[1:]
        tIMk = np.zeros(M + 1, F32); tIMk[:M] = tIM[1:]
        tDMk = np.zeros(M + 1, F32); tDMk[:M] = tDM[1:]
        new_i = tIMk * iv1 + tII * bI3
        new_m = tMMk * iv1 + tMI * bI3 + xE
        new_d = np.zeros(M + 1, F32)
        # D: tDM[k]*ivxb(k+1) + tDD[k]*D(i,k+1) + xE  (sequential k desc)
        tMDk = np.zeros(M + 1, F32); tMDk[:M] = tMD[1:]
        tDDk = np.zeros(M + 1, F32); tDDk[:M] = tDD[1:]
        new_d[M] = xE
        from ...native import bwd_d_fs_native
        if not bwd_d_fs_native(new_d, tDMk, iv1, tDDk, xE, M):
            for k in range(M - 1, 0, -1):
                new_d[k] = tDMk[k] * iv1[k] + tDDk[k] * new_d[k + 1] \
                    + xE
        # M->D
        dshift = np.zeros(M + 1, F32)
        dshift[:M] = new_d[1:]
        new_m = new_m + tMDk * dshift
        new_m[0] = new_i[0] = new_d[0] = 0

        # rescale with forward's factor for this row (plus own if huge)
        sc = float(fwd.scale[i])
        if xB > 1.0e16:
            bx.has_own_scales = True
        if bx.has_own_scales:
            sc = float(xB) if xB > 1.0e4 else 1.0
        if sc != 1.0:
            inv = F32(1.0 / sc)
            new_m *= inv; new_i *= inv; new_d *= inv
            mrow *= inv; irow *= inv; drow *= inv
            xNb *= inv; xBb *= inv; xJb *= inv; xCb *= inv
            xN, xB, xJ, xC, xE = (xN * inv, xB * inv, xJ * inv,
                                  xC * inv, xE * inv)
            totscale += float(np.log(sc))
        bx.scale[i] = sc
        mrow[curr], irow[curr], drow[curr] = new_m, new_i, new_d
        xNb[curr], xBb[curr], xJb[curr], xCb[curr] = xN, xB, xJ, xC
        bx.xE[i], bx.xN[i], bx.xJ[i], bx.xB[i], bx.xC[i] = xE, xN, xJ, xB, xC

    # rows 0..2: N-side termination; Z = logsum over bN(0),bN(1),bN(2)
    for i in (0, 1, 2):
        ivxb = np.zeros(M + 1, F32)
        for c in (2, 3, 4):
            j = i + c
            if 1 <= j <= L:
                ivxb += rfv[ci[c][j - 1]] * mrow[j % NR]
        xB = F32((ivxb[1:] * tBM[1:]).sum())
        xN = (xNb[(i + 3) % NR] if i + 3 <= L else F32(0.0)) \
            * xf[C.X_N, C.LOOP] + xB * xf[C.X_N, C.MOVE]
        bx.xB[i], bx.xN[i] = xB, xN
        bx.scale[i] = 1.0
    bx.totscale = totscale
    return bx, totscale


def domain_decoding_fs(om: FSOProfile, oxf: PMatrix, oxb: PMatrix
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """ref: decoding_fs.c p7_DomainDecoding_Frameshift :242."""
    L = oxf.L
    with np.errstate(divide="ignore"):
        log_sfwd = np.cumsum(np.log(oxf.scale.astype(np.float64)))
        lsb = np.log(oxb.scale.astype(np.float64))
    log_sbck = np.zeros(L + 2)
    for i in range(L, -1, -1):
        log_sbck[i] = log_sbck[i + 1] + lsb[i]
    with np.errstate(divide="ignore"):
        log_inv_Z = -float(flogsum(
            np.log(oxb.xN[0]) + log_sbck[0],
            flogsum(np.log(oxb.xN[1]) + log_sbck[1],
                    np.log(oxb.xN[2]) + log_sbck[2])))
    if np.isinf(log_inv_Z):
        raise RangeError("fs domain decoding overflow")
    if _use_native_fs5:
        from ...native import fs_domain_decoding_native
        r = fs_domain_decoding_native(om, oxf, oxb, log_inv_Z)
        if r is not None:
            return r
    btot = np.zeros(L + 1, F32)
    etot = np.zeros(L + 1, F32)
    mocc = np.zeros(L + 1, F32)
    nloop = om.xf[C.X_N, C.LOOP]
    jloop = om.xf[C.X_J, C.LOOP]
    cloop = om.xf[C.X_C, C.LOOP]
    for i in range(3, L + 1):
        btot[i] = btot[i - 3] + oxf.xB[i - 3] * oxb.xB[i - 3] * \
            np.exp(log_sfwd[i - 3] + log_sbck[i - 3] + log_inv_Z)
        etot[i] = etot[i - 3] + oxf.xE[i] * oxb.xE[i] * \
            np.exp(log_sfwd[i] + log_sbck[i] + log_inv_Z)
        njcp = 0.0
        for (lo, hi) in ((i - 3, i), (i - 2, i + 1), (i - 1, i + 2)):
            if hi > L:
                continue
            f = np.exp(log_sfwd[lo] + log_sbck[hi] + log_inv_Z)
            njcp += oxf.xN[lo] * oxb.xN[hi] * nloop * f
            njcp += oxf.xJ[lo] * oxb.xJ[hi] * jloop * f
            njcp += oxf.xC[lo] * oxb.xC[hi] * cloop * f
        mocc[i] = F32(1.0) - F32(njcp)
    if np.isinf(log_inv_Z):
        raise RangeError("fs domain decoding overflow")
    return btot, etot, mocc


@dataclass
class FSMatrix:
    """Full frameshift DP matrix: M sublanes per codon length plus
    combined C0, I, D (ref: P7_OMX with p7X_NSCELLS_FS layout)."""
    L: int
    M: int
    mc: np.ndarray        # [6, L+1, M+1]: C0..C5
    im: np.ndarray        # [L+1, M+1]
    dm: np.ndarray        # [L+1, M+1]
    xE: np.ndarray
    xN: np.ndarray
    xJ: np.ndarray
    xB: np.ndarray
    xC: np.ndarray
    scale: np.ndarray
    totscale: float = 0.0
    has_own_scales: bool = True


def forward_fs5(dsq: np.ndarray, om: FSOProfile,
                fast: bool = False) -> tuple[FSMatrix, float]:
    """Full 5-codon frameshift Forward with per-row sparse rescaling and
    cross-row scale adjustment (ref: p7_Forward_Frameshift :2054)."""
    if not fast and _use_native_fs5:
        from ...native import fs5_forward_fill_native
        r = fs5_forward_fill_native(dsq, om)
        if r is not None:
            return r
    L, M = len(dsq), om.M
    xf = om.xf
    rfv = om.rfv
    tBM, tMM, tIM, tDM, tMD, tDD, tMI, tII = _trans_views_fs(om)
    ci = codon_indices(dsq, 5)
    U = dd_closure_operator(tDD, M) if fast else None

    fx = FSMatrix(L=L, M=M,
                  mc=np.zeros((6, L + 1, M + 1), F32),
                  im=np.zeros((L + 1, M + 1), F32),
                  dm=np.zeros((L + 1, M + 1), F32),
                  xE=np.zeros(L + 1, F32), xN=np.zeros(L + 1, F32),
                  xJ=np.zeros(L + 1, F32), xB=np.zeros(L + 1, F32),
                  xC=np.zeros(L + 1, F32), scale=np.ones(L + 1, F32))
    # live structures (rescaled in place); committed rows are stored
    ivx = np.zeros((5, M + 1), F32)
    NR = 4
    xNb = np.zeros(NR, F32); xBb = np.zeros(NR, F32)
    xJb = np.zeros(NR, F32); xCb = np.zeros(NR, F32)
    xNb[0] = xNb[1] = xNb[2] = 1.0
    xBb[0] = xBb[1] = xBb[2] = xf[C.X_N, C.MOVE]
    for r in range(min(3, L + 1)):
        fx.xN[r] = 1.0
        fx.xB[r] = xf[C.X_N, C.MOVE]
    totscale = 0.0

    for i in range(1, L + 1):
        b1 = (i - 1) % NR
        b3 = (i - 3) % NR
        s1 = i % 5
        s2 = (i - 1) % 5
        s3 = (i - 2) % 5
        s4 = (i - 3) % 5
        s5 = (i - 4) % 5
        prev1 = fx.mc[0][i - 1]
        mp = np.empty(M + 1, F32); mp[0] = 0; mp[1:] = prev1[:-1]
        ip = np.empty(M + 1, F32); ip[0] = 0; ip[1:] = fx.im[i - 1][:-1]
        dp = np.empty(M + 1, F32); dp[0] = 0; dp[1:] = fx.dm[i - 1][:-1]
        # prev row 'live' values are stored rows; for i-1 the stored row
        # shares the current running scale, so no adjustment needed.
        xB1 = fx.xB[i - 1]
        sv = xB1 * tBM + mp * tMM + ip * tIM + dp * tDM
        sv[0] = 0
        ivx[s1] = sv
        mcs = [None] * 6
        mcs[1] = sv * rfv[ci[1][i - 1]]
        mcs[2] = ivx[s2] * rfv[ci[2][i - 1]] if i >= 2 else np.zeros(M + 1, F32)
        mcs[3] = ivx[s3] * rfv[ci[3][i - 1]] if i >= 3 else np.zeros(M + 1, F32)
        mcs[4] = ivx[s4] * rfv[ci[4][i - 1]] if i >= 4 else np.zeros(M + 1, F32)
        mcs[5] = ivx[s5] * rfv[ci[5][i - 1]] if i >= 5 else np.zeros(M + 1, F32)
        msv = mcs[1] + mcs[2] + mcs[3] + mcs[4] + mcs[5]
        msv[0] = 0
        # I state: lag-3 with scale adjustment (ref insert_adj)
        if i >= 3:
            insert_adj = F32(1.0) / (fx.scale[i - 2] * fx.scale[i - 1])
            new_i = (fx.mc[0][i - 3] * insert_adj) * tMI \
                + (fx.im[i - 3] * insert_adj) * tII
        else:
            new_i = np.zeros(M + 1, F32)
        new_i[0] = 0
        dc = np.zeros(M + 1, F32)
        dc[2:] = msv[1:M] * tMD[2:]
        _dd_closure(dc, tDD, M, U)
        xE = F32(msv[1:].sum()) + F32(dc[1:].sum())
        if i >= 3:
            xN = xNb[b3] * xf[C.X_N, C.LOOP]
            xJ = xJb[b3] * xf[C.X_J, C.LOOP] + xE * xf[C.X_E, C.LOOP]
            xC = xCb[b3] * xf[C.X_C, C.LOOP] + xE * xf[C.X_E, C.MOVE]
        else:
            xN = F32(1.0)
            xJ = xE * xf[C.X_E, C.LOOP]
            xC = xE * xf[C.X_E, C.MOVE]
        xB = xN * xf[C.X_N, C.MOVE] + xJ * xf[C.X_J, C.MOVE]

        if xE > F32(1.0e4):
            inv = F32(1.0) / xE
            for c in range(1, 6):
                mcs[c] = mcs[c] * inv
            msv = msv * inv
            new_i = new_i * inv
            dc = dc * inv
            ivx *= inv
            xN, xJ, xC, xB = xN * inv, xJ * inv, xC * inv, xB * inv
            xNb *= inv; xBb *= inv; xJb *= inv; xCb *= inv
            fx.scale[i] = xE
            totscale += float(np.log(xE))
            xE = F32(1.0)
        fx.mc[0][i] = msv
        for c in range(1, 6):
            fx.mc[c][i] = mcs[c]
        fx.im[i], fx.dm[i] = new_i, dc
        xNb[i % NR], xBb[i % NR] = xN, xB
        xJb[i % NR], xCb[i % NR] = xJ, xC
        fx.xE[i], fx.xN[i], fx.xJ[i] = xE, xN, xJ
        fx.xB[i], fx.xC[i] = xB, xC

    fx.totscale = totscale
    xCtot = (xCb[L % NR] + xCb[(L - 1) % NR] * xf[C.X_C, C.LOOP]
             + xCb[(L - 2) % NR] * xf[C.X_C, C.LOOP])
    if np.isnan(xCtot) or np.isinf(xCtot):
        raise RangeError("fs forward over/underflow")
    if L > 1 and xCtot == 0.0:
        raise RangeError("fs forward underflow")
    return fx, totscale + float(np.log(xCtot * xf[C.X_C, C.MOVE]))


def backward_fs5(dsq: np.ndarray, om: FSOProfile, fwd: FSMatrix
                 ) -> tuple[PMatrix, float]:
    """Full 5-codon frameshift Backward (standard M/I/D cells), using
    its own per-row scaling recorded in scale[] (ref:
    p7_Backward_Frameshift :2634; our scale schedule may differ from
    the C's but the decoding uses the recorded factors, so posterior
    values agree)."""
    if _use_native_fs5:
        from ...native import fs5_backward_fill_native
        r = fs5_backward_fill_native(dsq, om)
        if r is not None:
            return r
    L, M = len(dsq), om.M
    xf = om.xf
    rfv = om.rfv
    tBM, tMM, tIM, tDM, tMD, tDD, tMI, tII = _trans_views_fs(om)
    ci = codon_indices(dsq, 5)

    bx = PMatrix(L=L, M=M,
                 xE=np.zeros(L + 1, F32), xN=np.zeros(L + 1, F32),
                 xJ=np.zeros(L + 1, F32), xB=np.zeros(L + 1, F32),
                 xC=np.zeros(L + 1, F32), scale=np.ones(L + 1, F32),
                 mm=np.zeros((L + 1, M + 1), F32),
                 im=np.zeros((L + 1, M + 1), F32),
                 dm=np.zeros((L + 1, M + 1), F32),
                 has_own_scales=True)
    totscale = 0.0
    cmove = xf[C.X_C, C.MOVE]
    cloop = xf[C.X_C, C.LOOP]

    # csum[j] = cumulative scale products applied to committed rows > i;
    # committed row j stored = true(j) * prod_{r>=j} 1/scale[r].  When
    # reading row j from row i we need adj(j, i) = prod_{r=i+1..j} ...
    # We maintain stored rows directly and adjustment factors on the fly.
    def row_adj(j, i):
        """Multiply stored row j to bring it to row-i's running scale:
        factor = prod_{r=i+1}^{j} scale[r] applied... stored(j) =
        true(j) / prod_{r>=j} scale[r]; running scale at i (before
        scaling row i) = prod_{r>i} scale[r].  true_rel_i(j) =
        true(j) / prod_{r>i} scale[r] = stored(j) * prod_{r=j}^{?}...
        """
        f = F32(1.0)
        for r in range(i + 1, j):
            f = f / bx.scale[r]
        return f

    tMMk = np.zeros(M + 1, F32); tMMk[:M] = tMM[1:]
    tIMk = np.zeros(M + 1, F32); tIMk[:M] = tIM[1:]
    tDMk = np.zeros(M + 1, F32); tDMk[:M] = tDM[1:]
    tMDk = np.zeros(M + 1, F32); tMDk[:M] = tMD[1:]
    tDDk = np.zeros(M + 1, F32); tDDk[:M] = tDD[1:]

    for i in range(L, 0, -1):
        # ivxb(i,k) = sum_c rfv[c@(i+c)][k] * bM(i+c,k) with scale adj
        ivxb = np.zeros(M + 1, F32)
        for c in (1, 2, 3, 4, 5):
            j = i + c
            if j <= L:
                ivxb += rfv[ci[c][j - 1]] * bx.mm[j] * row_adj(j, i)
        if i >= L - 2:
            xC = cmove if i == L else cloop * cmove
        else:
            xC = cloop * bx.xC[i + 3] * row_adj(i + 3, i)
        xB = F32((ivxb[1:] * tBM[1:]).sum())
        xJ = (bx.xJ[i + 3] * row_adj(i + 3, i) * xf[C.X_J, C.LOOP]
              if i + 3 <= L else F32(0.0)) + xB * xf[C.X_J, C.MOVE]
        xN = (bx.xN[i + 3] * row_adj(i + 3, i) * xf[C.X_N, C.LOOP]
              if i + 3 <= L else F32(0.0)) + xB * xf[C.X_N, C.MOVE]
        xE = xC * xf[C.X_E, C.MOVE] + xJ * xf[C.X_E, C.LOOP]

        iv1 = np.zeros(M + 1, F32)
        iv1[:M] = ivxb[1:]
        if i + 3 <= L:
            adj3 = row_adj(i + 3, i)
            bI3 = bx.im[i + 3] * adj3
        else:
            bI3 = np.zeros(M + 1, F32)
        new_i = tIMk * iv1 + tII * bI3
        new_m = tMMk * iv1 + tMI * bI3 + xE
        new_d = np.zeros(M + 1, F32)
        new_d[M] = xE
        from ...native import bwd_d_fs_native
        if not bwd_d_fs_native(new_d, tDMk, iv1, tDDk, xE, M):
            for k in range(M - 1, 0, -1):
                new_d[k] = tDMk[k] * iv1[k] + tDDk[k] * new_d[k + 1] \
                    + xE
        dshift = np.zeros(M + 1, F32)
        dshift[:M] = new_d[1:]
        new_m = new_m + tMDk * dshift
        new_m[0] = new_i[0] = new_d[0] = 0

        mx = float(max(new_m.max(), xB))
        if mx > 1.0e4:
            sc = F32(mx)
            inv = F32(1.0) / sc
            new_m *= inv; new_i *= inv; new_d *= inv
            xN, xB, xJ, xC, xE = (xN * inv, xB * inv, xJ * inv,
                                  xC * inv, xE * inv)
            bx.scale[i] = sc
            totscale += float(np.log(sc))
        bx.mm[i], bx.im[i], bx.dm[i] = new_m, new_i, new_d
        bx.xE[i], bx.xN[i], bx.xJ[i], bx.xB[i], bx.xC[i] = xE, xN, xJ, xB, xC

    # rows 0..2 N-side
    for i in (2, 1, 0):
        ivxb = np.zeros(M + 1, F32)
        for c in (1, 2, 3, 4, 5):
            j = i + c
            if 1 <= j <= L:
                ivxb += rfv[ci[c][j - 1]] * bx.mm[j] * row_adj(j, i)
        xB = F32((ivxb[1:] * tBM[1:]).sum())
        xN = (bx.xN[i + 3] * row_adj(i + 3, i) * xf[C.X_N, C.LOOP]
              if i + 3 <= L else F32(0.0)) + xB * xf[C.X_N, C.MOVE]
        bx.xB[i], bx.xN[i] = xB, xN
        bx.scale[i] = 1.0
    bx.totscale = totscale
    return bx, totscale


def decoding_fs(om: FSOProfile, fwd: FSMatrix, bck: PMatrix) -> FSMatrix:
    """Posterior decoding into an FS pp matrix
    (ref: decoding_fs.c p7_Decoding_Frameshift :55).  Returns a new
    FSMatrix whose mc sublanes/im hold posteriors, and whose xN/xJ/xC
    hold the special posteriors."""
    if _use_native_fs5:
        from ...native import fs5_decoding_native
        r = fs5_decoding_native(om, fwd, bck)
        if r is not None:
            return r
    L, M = fwd.L, fwd.M
    with np.errstate(divide="ignore"):
        log_sfwd = np.cumsum(np.log(fwd.scale.astype(np.float64)))
        lsb = np.log(bck.scale.astype(np.float64))
    log_sbck = np.zeros(L + 2)
    for i in range(L, -1, -1):
        log_sbck[i] = log_sbck[i + 1] + lsb[i]
    with np.errstate(divide="ignore"):
        log_inv_Z = -float(flogsum(
            np.log(bck.xN[0]) + log_sbck[0],
            flogsum(np.log(bck.xN[1]) + log_sbck[1],
                    np.log(bck.xN[2]) + log_sbck[2])))
    pp = FSMatrix(L=L, M=M,
                  mc=np.zeros((6, L + 1, M + 1), F32),
                  im=np.zeros((L + 1, M + 1), F32),
                  dm=np.zeros((L + 1, M + 1), F32),
                  xE=np.zeros(L + 1, F32), xN=np.zeros(L + 1, F32),
                  xJ=np.zeros(L + 1, F32), xB=np.zeros(L + 1, F32),
                  xC=np.zeros(L + 1, F32), scale=np.ones(L + 1, F32))
    N_odds = om.xf[C.X_N, C.LOOP]
    J_odds = om.xf[C.X_J, C.LOOP]
    C_odds = om.xf[C.X_C, C.LOOP]
    nlag = np.zeros(4, F32); jlag = np.zeros(4, F32); clag = np.zeros(4, F32)
    nlag[0], jlag[0], clag[0] = fwd.xN[0], fwd.xJ[0], fwd.xC[0]
    for i in range(1, L + 1):
        nlag[i % 4] = fwd.xN[i]
        jlag[i % 4] = fwd.xJ[i]
        clag[i % 4] = fwd.xC[i]
        fN3 = nlag[(i + 1) % 4]
        fJ3 = jlag[(i + 1) % 4]
        fC3 = clag[(i + 1) % 4]
        factor_mdi = np.float64(
            np.exp(log_sfwd[i] + log_sbck[i] + log_inv_Z))
        if np.isinf(factor_mdi):
            raise RangeError("fs decoding overflow")
        bM = bck.mm[i]
        bI = bck.im[i]
        ppi = fwd.im[i] * bI
        ppcs = [fwd.mc[c][i] * bM for c in range(6)]
        raw = (ppcs[0][1:].astype(np.float64).sum()
               + ppi[1:].astype(np.float64).sum())
        if i > 2:
            factor_njc = np.exp(log_sfwd[i - 3] + log_sbck[i] + log_inv_Z)
            N_pp = fN3 * bck.xN[i] * N_odds * factor_njc
            J_pp = fJ3 * bck.xJ[i] * J_odds * factor_njc
            C_pp = fC3 * bck.xC[i] * C_odds * factor_njc
        else:
            f0 = np.exp(log_sbck[i] + log_inv_Z)
            N_pp = bck.xN[i] * f0
            J_pp = 0.0
            C_pp = 0.0
        denom = raw * factor_mdi + N_pp + J_pp + C_pp
        if denom <= 0 or np.isinf(1.0 / denom):
            raise RangeError("fs decoding denom overflow")
        scv = F32(factor_mdi / denom)
        for c in range(6):
            pp.mc[c][i] = ppcs[c] * scv
        pp.im[i] = ppi * scv
        pp.xN[i] = F32(N_pp / denom)
        pp.xJ[i] = F32(J_pp / denom)
        pp.xC[i] = F32(C_pp / denom)
    return pp


def optimal_accuracy_fs(om: FSOProfile, pp: FSMatrix
                        ) -> tuple[PMatrix, float]:
    """OA fill over the FS pp matrix (ref: optacc_fs.c :53)."""
    if _use_native_fs5:
        from ...native import fs5_optacc_native
        r = fs5_optacc_native(om, pp)
        if r is not None:
            return r
    L, M = pp.L, pp.M
    xf = om.xf
    tBM, tMM, tIM, tDM, tMD, tDD, tMI, tII = _trans_views_fs(om)
    masks = {"BM": tBM > 0, "MM": tMM > 0, "IM": tIM > 0, "DM": tDM > 0,
             "MD": tMD > 0, "DD": tDD > 0, "MI": tMI > 0, "II": tII > 0}

    ox = PMatrix(L=L, M=M,
                 xE=np.full(L + 1, NEG_INF, F32),
                 xN=np.zeros(L + 1, F32),
                 xJ=np.full(L + 1, NEG_INF, F32),
                 xB=np.zeros(L + 1, F32),
                 xC=np.full(L + 1, NEG_INF, F32),
                 scale=np.ones(L + 1, F32),
                 mm=np.full((L + 1, M + 1), NEG_INF, F32),
                 im=np.full((L + 1, M + 1), NEG_INF, F32),
                 dm=np.full((L + 1, M + 1), NEG_INF, F32))
    ox.xN[0] = 0.0
    ox.xB[0] = 0.0

    def masked(m, v):
        return np.where(m, v, F32(0.0))

    # short-circuit all-true masks (the usual local profile): the
    # np.where is an identity there, and it dominated the profile
    mk = {name: (None if bool(m.all()) else m)
          for name, m in masks.items()}

    def mval(name, v):
        m = mk[name]
        return v if m is None else np.where(m, v, F32(0.0))

    dd_all = bool(masks["DD"][2:].all())
    sentinel = np.full(M + 1, NEG_INF, F32)

    for i in range(1, L + 1):
        svs = []
        for c in range(1, 6):
            j = i - c
            if j >= 0:
                mp = np.empty(M + 1, F32); mp[0] = NEG_INF
                mp[1:] = ox.mm[j][:-1]
                ip = np.empty(M + 1, F32); ip[0] = NEG_INF
                ip[1:] = ox.im[j][:-1]
                dp = np.empty(M + 1, F32); dp[0] = NEG_INF
                dp[1:] = ox.dm[j][:-1]
                xB = ox.xB[j]
            else:
                mp = ip = dp = sentinel
                xB = NEG_INF
            sv = mval("BM", xB)
            sv = np.maximum(sv, mval("MM", mp))
            sv = np.maximum(sv, mval("IM", ip))
            sv = np.maximum(sv, mval("DM", dp))
            svs.append(sv + pp.mc[c][i])
        sv = np.maximum.reduce(svs)
        sv[0] = NEG_INF
        ox.mm[i] = sv
        j3 = i - 3 if i >= 3 else 0
        iv = np.maximum(mval("MI", ox.mm[j3]),
                        mval("II", ox.im[j3]))
        iv = iv + pp.im[i]
        iv[0] = NEG_INF
        iv[M] = NEG_INF
        ox.im[i] = iv
        dv = np.full(M + 1, NEG_INF, F32)
        dv[2:] = sv[1:M] if mk["MD"] is None else \
            masked(masks["MD"][2:], sv[1:M])
        if dd_all:
            # DD transitions all >0 (the usual local profile): the
            # gated chain reduces to a running max — byte-identical
            # to the scalar loop, ~Mx fewer Python ops
            np.maximum.accumulate(dv[2:], out=dv[2:])
        else:
            for k in range(2, M + 1):
                dv[k] = max(dv[k], masked(masks["DD"][k], dv[k - 1]))
        ox.dm[i] = dv
        xE = max(float(sv[1:].max(initial=-np.inf)),
                 float(dv[1:].max(initial=-np.inf)))
        ox.xE[i] = xE
        if i > 2:
            xN = 0.0 if xf[C.X_N, C.LOOP] == 0.0 else \
                float(ox.xN[i - 3] + pp.xN[i])
            t1 = 0.0 if xf[C.X_J, C.LOOP] == 0.0 else \
                float(ox.xJ[i - 3] + pp.xJ[i])
            t2 = 0.0 if xf[C.X_E, C.LOOP] == 0.0 else xE
            xJ = max(t1, t2)
            t1 = 0.0 if xf[C.X_C, C.LOOP] == 0.0 else \
                float(ox.xC[i - 3] + pp.xC[i])
            t2 = 0.0 if xf[C.X_E, C.MOVE] == 0.0 else xE
            xC = max(t1, t2)
        else:
            xN = 0.0 if xf[C.X_N, C.LOOP] == 0.0 else float(pp.xN[i])
            xJ = 0.0 if xf[C.X_E, C.LOOP] == 0.0 else xE
            xC = 0.0 if xf[C.X_E, C.MOVE] == 0.0 else xE
        ox.xN[i], ox.xJ[i], ox.xC[i] = xN, xJ, xC
        t1 = 0.0 if xf[C.X_N, C.MOVE] == 0.0 else xN
        t2 = 0.0 if xf[C.X_J, C.MOVE] == 0.0 else xJ
        ox.xB[i] = max(t1, t2)

    ret = float(ox.xC[L] + ox.xC[L - 1] + ox.xC[L - 2])
    return ox, ret


def oa_trace_fs(om: FSOProfile, pp: FSMatrix, ox: PMatrix) -> Trace:
    """FS OA traceback (ref: optacc_fs.c p7_OATrace_Frameshift :538)."""
    if _use_native_fs5:
        from ...native import fs5_oa_trace_native
        r = fs5_oa_trace_native(om, pp, ox)
        if r is not None:
            return r
    L, M = ox.L, ox.M
    xf = om.xf
    tfv = om.tfv
    tr = Trace(M=M, L=L)
    i, k, c = L, 0, 0
    tr.append(C.T_T, 0, i, 0.0, 0)
    tr.append(C.T_C, 0, i, 0.0, 0)
    sprv = C.T_C

    def tprob(slot, t):
        return tfv[slot, t] if 0 <= slot < M else 0.0

    while sprv != C.T_S:
        if sprv == C.T_M:
            path = [
                ox.mm[i][k - 1] if k >= 2 and tprob(k - 1, C.P_MM) > 0 else NEG_INF,
                ox.im[i][k - 1] if k >= 2 and tprob(k - 1, C.P_IM) > 0 else NEG_INF,
                ox.dm[i][k - 1] if k >= 2 and tprob(k - 1, C.P_DM) > 0 else NEG_INF,
                ox.xB[i] if tprob(k - 1, C.P_BM) > 0 else NEG_INF,
            ]
            states = [C.T_M, C.T_I, C.T_D, C.T_B]
            scur = states[int(np.argmax(path))]
            k -= 1
        elif sprv == C.T_D:
            p0 = ox.mm[i][k - 1] if k >= 2 and tprob(k - 1, C.P_MD) > 0 else NEG_INF
            p1 = ox.dm[i][k - 1] if k >= 2 and tprob(k - 1, C.P_DD) > 0 else NEG_INF
            scur = C.T_M if p0 >= p1 else C.T_D
            k -= 1
        elif sprv == C.T_I:
            j3 = i - 3 if i >= 3 else 0
            p0 = ox.mm[j3][k] if tprob(k, C.P_MI) > 0 else NEG_INF
            p1 = ox.im[j3][k] if tprob(k, C.P_II) > 0 else NEG_INF
            scur = C.T_M if p0 >= p1 else C.T_I
            i -= 3
        elif sprv == C.T_N:
            scur = C.T_S if i == 0 else C.T_N
        elif sprv == C.T_C:
            if i < 4:
                scur = C.T_E
            else:
                t1 = xf[C.X_C, C.LOOP] != 0.0
                paths = [
                    float(ox.xC[i - 3] + pp.xC[i]) if t1 else -np.inf,
                    float(ox.xC[i - 2] + pp.xC[i + 1]) if (i < L and t1) else -np.inf,
                    float(ox.xC[i - 1] + pp.xC[i + 2]) if (i < L - 1 and t1) else -np.inf,
                    float(ox.xE[i]) if xf[C.X_E, C.MOVE] != 0.0 else -np.inf,
                ]
                scur = [C.T_C, C.T_C, C.T_C, C.T_E][int(np.argmax(paths))]
        elif sprv == C.T_J:
            if i <= 5:
                scur = C.T_E
            else:
                p0 = float(ox.xJ[i] + pp.xJ[i]) \
                    if xf[C.X_J, C.LOOP] != 0.0 else -np.inf
                p1 = float(ox.xE[i]) if xf[C.X_E, C.LOOP] != 0.0 else -np.inf
                scur = C.T_J if p0 >= p1 else C.T_E
        elif sprv == C.T_E:
            mx = -np.inf
            smax, kmax = C.T_M, 1
            for kk in range(1, M + 1):
                vM = float(ox.mm[i][kk])
                if vM > mx:
                    mx, smax, kmax = vM, C.T_M, kk
                vD = float(ox.dm[i][kk])
                if vD > mx:
                    mx, smax, kmax = vD, C.T_D, kk
            k = kmax
            scur = smax
        elif sprv == C.T_B:
            p0 = float(ox.xN[i]) if xf[C.X_N, C.MOVE] != 0.0 else -np.inf
            p1 = float(ox.xJ[i]) if xf[C.X_J, C.MOVE] != 0.0 else -np.inf
            scur = C.T_N if p0 > p1 else C.T_J
        else:
            raise ValueError("bogus state in FS OA traceback")

        # postprob (ref get_postprob_fs)
        if scur == C.T_M:
            postprob = float(pp.mc[0][i][k])
        elif scur == C.T_I:
            postprob = float(pp.im[i][k])
        elif scur in (C.T_N, C.T_C, C.T_J) and scur == sprv:
            postprob = float({C.T_N: pp.xN, C.T_C: pp.xC,
                              C.T_J: pp.xJ}[scur][i])
        else:
            postprob = 0.0

        if scur == C.T_M:
            cvals = [float(pp.mc[cc][i][k]) for cc in range(1, 6)]
            c = int(np.argmax(cvals)) + 1
        else:
            c = 0

        # record (emitting states carry i)
        if scur == C.T_M:
            tr.append(scur, k, i, postprob, c)
        elif scur == C.T_I:
            tr.append(scur, k, i, postprob, 0)
        elif scur in (C.T_N, C.T_C, C.T_J) and scur == sprv:
            tr.append(scur, 0, i, postprob, 0)
        else:
            tr.append(scur, k if scur == C.T_D else 0, 0, postprob, 0)

        if scur in (C.T_N, C.T_C, C.T_J) and scur == sprv:
            i -= 1
        sprv = scur
        i -= c

    tr.M, tr.L = M, L
    tr.reverse()
    return tr


def null2_fs_by_expectation(om: FSOProfile, pp: FSMatrix) -> np.ndarray:
    """ref: null2_fs.c p7_Null2_fs_ByExpectation :53."""
    Ld = pp.L
    K, Kp = om.K, om.Kp
    mexp = pp.mc[0][1:Ld + 1].sum(axis=0, dtype=F32)
    iexp = pp.im[1:Ld + 1].sum(axis=0, dtype=F32)
    xN = F32(pp.xN[1:Ld + 1].sum())
    xC = F32(pp.xC[1:Ld + 1].sum())
    xJ = F32(pp.xJ[1:Ld + 1].sum())
    norm = F32(1.0) / F32(Ld)
    mexp *= norm; iexp *= norm
    xfactor = xN * norm + xC * norm + xJ * norm
    null2 = np.zeros(Kp, F32)
    isum = F32(iexp[1:].sum())
    amino = om.rfv[om.maxcodons:, :]
    for x in range(K):
        null2[x] = F32((mexp[1:] * amino[x][1:]).sum()) + isum + xfactor
    return null2
