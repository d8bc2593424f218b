"""Spliced translated Viterbi: 1-codon translated Viterbi with intron
jump (P) states gated by splice signals (GT-AG / GC-AG / AT-AC)
(ref: generic_viterbi_spliced.c p7_GViterbi_Spliced :65,
p7_GViterbi_SplicedTrace :483; impl_sse/viterbi_sp.c).

Numpy reference semantics, vectorized over the model dimension.  The
donor-side scores are accumulated in running-max buffers keyed by
(signal, codon-split) exactly as the reference's SSX macros do; the
traceback re-derives the winning donor site by scanning, as the
reference does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .. import constants as C
from ..profile import FSProfile

NEG_INF = np.float32(-np.inf)
F32 = np.float32

# signal identities (ref: p7_splice.h DONOR_GT etc: SIGNAL(a,b)=4a+b)
DONOR_GT = 11       # G=2,T=3
DONOR_GC = 9        # G=2,C=1
DONOR_AT = 3        # A=0,T=3
ACCEPT_AG = 2       # A=0,G=2
ACCEPT_AC = 1       # A=0,C=1

S_GTAG, S_GCAG, S_ATAC = 0, 1, 2

TSC_P = float(np.log(np.float32(4.5e-5)))   # P->M cost (ref: p7_splice.h TSC_P)

# default splice signal scores (ref: p7_splicepipeline.c p7_SignalScores :26)
SIGNAL_SCORES = np.log(np.array([0.9921, 0.0073, 0.0006], dtype=np.float64))


# grow-only DP matrix pool: a fresh multi-100MB np.full per call
# costs seconds in page faults on lazily-backed VMs; pooled buffers
# fault once per process.  Callers must not hold a returned view
# across viterbi_spliced() calls (the splice pipeline never does:
# each matrix dies before the next exon pair runs).
_MAT_POOL: dict[str, np.ndarray] = {}


def _pooled_mat(name: str, rows: int, cols: int) -> np.ndarray:
    n = rows * cols
    buf = _MAT_POOL.get(name)
    if buf is None or buf.size < n:
        buf = np.empty(max(n, 2 * len(_MAT_POOL.get(name, ()))),
                       dtype=F32)
        _MAT_POOL[name] = buf
    return buf[:n].reshape(rows, cols)


def _sig(a: int, b: int) -> int:
    return 4 * a + b


def _nt(x: int) -> int:
    """Map non-ACGT to the 1-codon placeholder."""
    return x if x < 4 else C.MAXCODONS1


def _codon1(v: int, w: int, x: int) -> int:
    return min(C.codon3_fs1(v, w, x), C.DEGEN1_C)


@dataclass
class SplicedMatrix:
    L: int
    M: int
    mmx: np.ndarray     # [L+1, M+1]
    imx: np.ndarray
    dmx: np.ndarray
    xN: np.ndarray
    xB: np.ndarray
    xE: np.ndarray
    xC: np.ndarray


def viterbi_spliced(dsq: np.ndarray, gm: FSProfile, i_start: int,
                    i_end: int, k_start: int, k_end: int,
                    min_intron: int = 30,
                    signal_scores: np.ndarray = SIGNAL_SCORES,
                    global_start: bool = True, global_end: bool = True
                    ) -> SplicedMatrix:
    """Fill the spliced Viterbi matrix on dsq[i_start-1 .. i_end-1]
    (1-based closed coords like the reference) against submodel
    k_start..k_end of the 1-codon profile <gm>
    (ref: p7_GViterbi_Spliced :65)."""
    assert gm.codon_lengths == 1
    L = i_end - i_start + 1
    M = k_end - k_start + 1
    rsc = gm.rsc_fs                       # [MAXCODONS1+Kp, Mfull+1]
    tsc = gm.tsc                          # [Mfull, 8]
    xsc = gm.xsc
    entry = NEG_INF if global_start else F32(0.0)
    exitc = NEG_INF if global_end else F32(0.0)
    sub = dsq[i_start - 1:i_end]          # local 0-based view, len L

    ks = np.arange(1, M + 1)              # local k
    sub_k = k_start + ks - 1              # global model positions 1..Mfull
    # transitions *into* node sub_k come from slot sub_k-1 (tsc row
    # sub_k-1); transitions out of sub_k use row sub_k
    tMM = tsc[sub_k - 1, C.P_MM]
    tIM = tsc[sub_k - 1, C.P_IM]
    tDM = tsc[sub_k - 1, C.P_DM]
    tMD = tsc[sub_k - 1, C.P_MD]
    tDD = tsc[sub_k - 1, C.P_DD]
    tMI = np.where(sub_k < gm.M, tsc[np.minimum(sub_k, gm.M - 1), C.P_MI],
                   NEG_INF)
    tII = np.where(sub_k < gm.M, tsc[np.minimum(sub_k, gm.M - 1), C.P_II],
                   NEG_INF)

    # contiguous f32 transition rows for the native D max-chain
    tMD_c = np.ascontiguousarray(tMD, dtype=F32)
    tDD_c = np.ascontiguousarray(tDD, dtype=F32)
    from ..native import bind_d_max_chain
    _dmax = bind_d_max_chain()

    def _d_chain(m_new, tMDc, tDDc, M):
        d = np.full(M + 1, NEG_INF, F32)
        if _dmax is not None and m_new.flags.c_contiguous:
            _dmax(d.ctypes.data, m_new.ctypes.data,
                  tMDc.ctypes.data, tDDc.ctypes.data, M)
            return d
        for k in range(2, M + 1):
            d[k] = max(m_new[k - 2] + tMDc[k - 1],
                       d[k - 1] + tDDc[k - 1])
        return d

    # The native fill writes every cell of rows 3..L (cols 1..M plus
    # the col-0 sentinel) and only READS rows 0-2 — so the O(L*M)
    # -inf prefill is wasted there.  Worse, on this class of VM a
    # fresh 100MB+ allocation page-faults at ~100us/page, so the
    # matrices come from a grow-only pool (pages fault once per
    # process) and only the 3 boundary rows are seeded per call.
    # The Python fallback below re-fills everything before running.
    mmx = _pooled_mat("mmx", L + 1, M + 1)
    imx = _pooled_mat("imx", L + 1, M + 1)
    dmx = _pooled_mat("dmx", L + 1, M + 1)
    for a in (mmx, imx, dmx):
        a[:3] = NEG_INF
    xN = np.full(L + 1, NEG_INF, F32)
    xB = np.full(L + 1, NEG_INF, F32)
    xE = np.full(L + 1, NEG_INF, F32)
    xC = np.full(L + 1, NEG_INF, F32)
    pvx = np.full((4, M + 1), NEG_INF, F32)   # circular P-state rows

    # donor-score buffers (ref: SSX macros)
    ssx0 = np.full((M + 1, 3), NEG_INF, F32)
    ssx1 = np.full((M + 1, 3, 5), NEG_INF, F32)
    ssx2 = np.full((M + 1, 3, 5), NEG_INF, F32)
    sigsc = signal_scores.astype(np.float64)

    xN[0] = 0.0
    xB[0] = xsc[C.X_N, C.MOVE]

    # vectorized per-row precomputation: placeholder-mapped nts, codon
    # indices, and splice-signal codes (replaces ~9 scalar nt()/sig
    # calls per row)
    ntv = np.where(sub < 4, sub, C.MAXCODONS1).astype(np.int64)
    if L >= 3:
        # ci_arr[j] = 1-codon index of the codon ending at row i=j+3
        ci_arr = np.minimum(ntv[2:] * C.NUC1_FS1
                            + ntv[1:-1] * C.NUC2_FS1 + ntv[:-2],
                            C.DEGEN1_C)
        c1_base = np.minimum(ntv[2:] * C.NUC1_FS1
                             + ntv[1:-1] * C.NUC2_FS1, C.DEGEN1_C)
    else:
        ci_arr = c1_base = np.empty(0, np.int64)
    if L >= 2:
        both = (ntv[:-1] < 4) & (ntv[1:] < 4)
        pair = np.where(both, 4 * ntv[:-1] + ntv[1:], -1)
        accv = np.where(pair == ACCEPT_AG, ACCEPT_AG,
                        np.where(pair == ACCEPT_AC, ACCEPT_AC, -1))
        donv = np.where(pair == _sig(2, 3), S_GTAG,
                        np.where(pair == _sig(2, 1), S_GCAG,
                                 np.where(pair == _sig(0, 3), S_ATAC,
                                          -1)))
    else:
        accv = donv = np.empty(0, np.int64)

    def nt(i_local):     # 1-based local -> placeholder-mapped nt
        return int(ntv[i_local - 1])

    for i in (1, 2):
        if i <= L:
            xN[i] = 0.0
            xB[i] = xsc[C.X_N, C.MOVE]

    def c0_rsc(i):
        return rsc[int(ci_arr[i - 3])]

    # native fill (bit-identical to the loops below)
    from ..native import spliced_vit_fill_native
    if L >= 3 and rsc.dtype == F32 and spliced_vit_fill_native(
            ntv, ci_arr, c1_base, accv, donv, L, M, rsc, sub_k,
            (tMM, tIM, tDM, tMD_c, tDD_c, tMI, tII),
            entry, exitc, global_start, global_end,
            (xsc[C.X_N, C.LOOP], xsc[C.X_N, C.MOVE],
             xsc[C.X_C, C.LOOP], xsc[C.X_E, C.MOVE]),
            sigsc, TSC_P, min_intron,
            (mmx, imx, dmx, xN, xB, xE, xC)):
        return SplicedMatrix(L=L, M=M, mmx=mmx, imx=imx, dmx=dmx,
                             xN=xN, xB=xB, xE=xE, xC=xC)

    # Python fallback: needs the full -inf prefill the lazy boundary
    # init above skipped
    for a in (mmx, imx, dmx):
        a[3:] = NEG_INF

    # rows 3 .. min(L, min_intron+2): no donor lookbacks yet
    loop_end = min(L, min_intron + 2)
    for i in range(3, loop_end + 1):
        rc = c0_rsc(i)                       # [Mfull+1] emission row
        emits = rc[sub_k]                    # [M]
        if not global_start:
            xN[i] = xN[i - 3] + xsc[C.X_N, C.LOOP]
            xB[i] = xN[i] + xsc[C.X_N, C.MOVE]
        prevm = mmx[i - 3]
        previ = imx[i - 3]
        prevd = dmx[i - 3]
        cand = np.maximum.reduce([
            prevm[ks - 1] + tMM, previ[ks - 1] + tIM,
            prevd[ks - 1] + tDM,
            np.full(M, xB[i - 3] + entry, F32)])
        if global_start:
            # only B->M1 at the very first codon row
            cand[0] = xB[i - 3] if i == 3 else NEG_INF
            cand[1:] = np.maximum.reduce([
                prevm[ks[1:] - 1] + tMM[1:], previ[ks[1:] - 1] + tIM[1:],
                prevd[ks[1:] - 1] + tDM[1:]])
        m_new = cand + emits
        i_new = np.maximum(prevm[ks] + tMI, previ[ks] + tII)
        i_new = np.where(emits == NEG_INF, NEG_INF, i_new)
        i_new[M - 1] = NEG_INF
        d_new = _d_chain(m_new, tMD_c, tDD_c, M)
        mmx[i, 1:] = m_new
        imx[i, 1:] = i_new
        dmx[i] = d_new
        if global_end:
            pass
        else:
            xE[i] = max(float(m_new.max()), float(d_new.max())) + float(exitc)
        ei = max(float(m_new[M - 1]), float(d_new[M]))
        if not global_end:
            xE[i] = max(xE[i], ei)
            xC[i] = max(xC[i - 3] + xsc[C.X_C, C.LOOP] if i >= 3 else -np.inf,
                        xE[i] + xsc[C.X_E, C.MOVE])

    # main recursion with donor/acceptor machinery
    for i in range(min_intron + 3, L + 1):
        pv_i = i % 4
        pv_pi = (i - 3) % 4
        x = nt(i)
        rc = rsc[int(ci_arr[i - 3])]
        emits = rc[sub_k]

        # split-codon emissions: C1[nuc1] = (nuc1, w, x)
        base = int(c1_base[i - 3])
        c1_idx = np.minimum(
            base + np.array([0, 1, 2, 3, C.MAXCODONS1]), C.DEGEN1_C)
        c1_rows = rsc[c1_idx][:, sub_k]                     # [5, M]

        # acceptor signals ending at i-2 (acc0), i-1 (acc1), i (acc2)
        # (pair j in accv = 1-based nts (j+1, j+2))
        def acc_at(off):
            return int(accv[i - 3 - off])
        acc0, acc1, acc2 = acc_at(2), acc_at(1), acc_at(0)

        # P-state values for this row, vectorized over k
        pv_new = np.full(M + 1, NEG_INF, F32)
        if acc0 >= 0 or acc1 >= 0 or acc2 >= 0:
            kk = np.arange(1, M)             # k = 1..M-1 (ref loop)
            skk = sub_k[kk - 1]              # global model positions
            best = np.full(M - 1, -np.inf)
            if acc0 == ACCEPT_AG:
                t0 = np.maximum(ssx0[kk, S_GTAG] + sigsc[S_GTAG],
                                ssx0[kk, S_GCAG] + sigsc[S_GCAG]) \
                    + rc[skk]
                best = np.maximum(best, t0)
            elif acc0 == ACCEPT_AC:
                best = np.maximum(best, ssx0[kk, S_ATAC] + sigsc[S_ATAC]
                                  + rc[skk])
            if acc1 == ACCEPT_AG:
                t1 = np.maximum(
                    ssx1[kk, S_GTAG, :] + sigsc[S_GTAG],
                    ssx1[kk, S_GCAG, :] + sigsc[S_GCAG]) \
                    + c1_rows[:, kk - 1].T
                best = np.maximum(best, t1.max(axis=1))
            elif acc1 == ACCEPT_AC:
                t1 = ssx1[kk, S_ATAC, :] + sigsc[S_ATAC] \
                    + c1_rows[:, kk - 1].T
                best = np.maximum(best, t1.max(axis=1))
            nuc3 = min(x, 4)
            if acc2 == ACCEPT_AG:
                t2 = np.maximum(ssx2[kk, S_GTAG, nuc3] + sigsc[S_GTAG],
                                ssx2[kk, S_GCAG, nuc3] + sigsc[S_GCAG])
                best = np.maximum(best, t2)
            elif acc2 == ACCEPT_AC:
                best = np.maximum(best, ssx2[kk, S_ATAC, nuc3]
                                  + sigsc[S_ATAC])
            pv_new[1:M] = best.astype(F32)
        pvx[pv_i] = pv_new

        if not global_start:
            xN[i] = xN[i - 3] + xsc[C.X_N, C.LOOP]
            xB[i] = xN[i] + xsc[C.X_N, C.MOVE]

        prevm = mmx[i - 3]
        previ = imx[i - 3]
        prevd = dmx[i - 3]
        cand = np.maximum.reduce([
            prevm[ks - 1] + tMM, previ[ks - 1] + tIM,
            prevd[ks - 1] + tDM,
            np.concatenate([[NEG_INF],
                            pvx[pv_pi][ks[1:] - 1]]) + F32(TSC_P),
            np.full(M, xB[i - 3] + entry, F32)])
        if global_start:
            c2 = np.maximum.reduce([
                prevm[ks - 1] + tMM, previ[ks - 1] + tIM,
                prevd[ks - 1] + tDM,
                np.concatenate([[NEG_INF],
                                pvx[pv_pi][ks[1:] - 1]]) + F32(TSC_P)])
            cand = c2
        m_new = cand + emits
        i_new = np.maximum(prevm[ks] + tMI, previ[ks] + tII)
        i_new = np.where(emits == NEG_INF, NEG_INF, i_new)
        i_new[M - 1] = NEG_INF
        d_new = _d_chain(m_new, tMD_c, tDD_c, M)
        mmx[i, 1:] = m_new
        imx[i, 1:] = i_new
        dmx[i] = d_new
        if not global_end:
            xE[i] = max(float(m_new[:M - 1].max()) if M > 1 else -np.inf,
                        float(d_new[1:M].max()) if M > 1 else -np.inf)
            xE[i] = max(xE[i] + float(exitc),
                        float(m_new[M - 1]), float(d_new[M]))
            xC[i] = max(xC[i - 3] + xsc[C.X_C, C.LOOP],
                        xE[i] + xsc[C.X_E, C.MOVE])

        # donor updates: record scores at the row min_intron+3 back
        don_row_m = mmx[i - min_intron - 3]
        don_row_d = dmx[i - min_intron - 3]
        tmp = np.maximum(don_row_m[ks[:-1]], don_row_d[ks[:-1]])  # k-1 for k=2..M

        def don_at(off):
            return int(donv[i - min_intron - off - 1])
        don0, don1, don2 = don_at(2), don_at(1), don_at(0)

        kk = np.arange(2, M)
        if don2 >= 0 and M > 2:
            r_, s_ = nt(i - min_intron - 2), nt(i - min_intron - 1)
            skk = sub_k[kk - 1]
            for j, n3 in enumerate((0, 1, 2, 3, C.MAXCODONS1)):
                em = rsc[_codon1(r_, s_, n3)][skk]
                ssx2[kk, don2, j] = np.maximum(ssx2[kk, don2, j],
                                               tmp[kk - 2] + em)
        if don1 >= 0 and M > 2:
            r_ = min(nt(i - min_intron - 2), 4)
            ssx1[kk, don1, r_] = np.maximum(ssx1[kk, don1, r_],
                                            tmp[kk - 2])
        if don0 >= 0 and M > 2:
            ssx0[kk, don0] = np.maximum(ssx0[kk, don0], tmp[kk - 2])

    if global_end:
        xE[L] = max(float(mmx[L, M]), float(dmx[L, M]))
        xC[L] = xE[L] + xsc[C.X_E, C.MOVE]

    return SplicedMatrix(L=L, M=M, mmx=mmx, imx=imx, dmx=dmx,
                         xN=xN, xB=xB, xE=xE, xC=xC)


# trace state codes (subset of reference p7T_*)
T_M, T_D, T_I, T_S, T_N, T_B, T_E, T_C, T_P = range(9)


@dataclass
class SplicedTrace:
    """Trace with per-step codon length c; P states mark introns
    (ref: P7_TRACE with sp[] / c[] extensions)."""
    st: list
    k: list       # global model positions
    i: list       # global (1-based, within dsq) seq positions
    c: list       # codon lengths (3 for M; split length for P)
    vitsc: float = 0.0


def _close(a, b, r_tol=1e-5, a_tol=1e-4):
    if a == b:
        return True
    if not (math.isfinite(a) and math.isfinite(b)):
        return False
    return abs(a - b) <= a_tol or abs(a - b) <= r_tol * max(abs(a), abs(b))


def viterbi_spliced_trace(dsq: np.ndarray, gm: FSProfile,
                          gx: SplicedMatrix, i_start: int, i_end: int,
                          k_start: int, k_end: int,
                          min_intron: int = 30,
                          signal_scores: np.ndarray = SIGNAL_SCORES
                          ) -> SplicedTrace:
    """Traceback of the spliced Viterbi matrix
    (ref: p7_GViterbi_SplicedTrace :483).  Returns the trace in
    forward order with global coordinates, and the splice-cost-
    corrected Viterbi score."""
    L, M = gx.L, gx.M
    rsc = gm.rsc_fs
    tsc = gm.tsc
    xsc = gm.xsc
    sigsc = signal_scores.astype(np.float64)
    mmx, imx, dmx = gx.mmx, gx.imx, gx.dmx
    sub = dsq[i_start - 1:i_end]

    # native traceback (identical decisions; Python loop below is the
    # parity oracle)
    from ..native import spliced_vit_trace_native
    if (rsc.dtype == F32 and tsc.dtype == F32
            and tsc.flags.c_contiguous):
        nat = spliced_vit_trace_native(
            sub, L, M, gm.M, rsc, tsc,
            (xsc[C.X_C, C.MOVE], xsc[C.X_C, C.LOOP],
             xsc[C.X_E, C.MOVE], xsc[C.X_N, C.MOVE]),
            sigsc, (mmx, imx, dmx, gx.xN, gx.xB, gx.xE, gx.xC),
            k_start, i_start, min_intron, TSC_P)
        if nat is not None:
            nst, nk, ni, nc, nvsc = nat
            return SplicedTrace(st=nst[::-1].tolist(),
                                k=nk[::-1].tolist(),
                                i=ni[::-1].tolist(),
                                c=nc[::-1].tolist(), vitsc=nvsc)

    def nt(i_local):
        if i_local < 1 or i_local > L:
            return C.MAXCODONS1
        return _nt(int(sub[i_local - 1]))

    def TSC(t, kglob):
        if kglob < 0 or kglob >= gm.M:
            return -np.inf
        return float(tsc[kglob, t])

    i, k = L, 0
    vsc = float(gx.xC[i]) + float(xsc[C.X_C, C.MOVE])
    st = [T_C, 8]     # placeholder; we build reversed then flip
    out_st, out_k, out_i, out_c = [], [], [], []

    def append(s, kk, ii, cc):
        out_st.append(s)
        out_k.append(k_start + kk - 1 if kk > 0 else 0)
        out_i.append(i_start + ii - 1 if ii > 0 else 0)
        out_c.append(cc)

    append(9, 0, i, 0)     # T (terminal marker, state code 9)
    append(T_C, 0, i, 0)
    sprv = T_C
    donor_i = -1
    c = 0
    while sprv != T_S:
        if sprv == T_C:
            if (gx.xC[i] < gx.xC[i - 2] if i >= 2 else False) or \
               (gx.xC[i] < gx.xC[i - 1] if i >= 1 else False):
                scur = T_C
            elif gx.xC[i] == -np.inf:
                raise RuntimeError(f"impossible C at i={i}")
            elif i >= 3 and _close(float(gx.xC[i]),
                                   float(gx.xC[i - 3])
                                   + float(xsc[C.X_C, C.LOOP])):
                scur = T_C
            elif _close(float(gx.xC[i]),
                        float(gx.xE[i]) + float(xsc[C.X_E, C.MOVE])):
                scur = T_E
            else:
                raise RuntimeError(f"C at i={i} couldn't be traced")
        elif sprv == T_E:
            if gx.xE[i] == -np.inf:
                raise RuntimeError(f"impossible E at i={i}")
            scur = None
            for kq in range(M, 0, -1):
                if _close(float(gx.xE[i]), float(mmx[i, kq])):
                    scur, k = T_M, kq
                    break
                if _close(float(gx.xE[i]), float(dmx[i, kq])):
                    scur, k = T_D, kq
                    break
            if scur is None:
                raise RuntimeError(f"E at i={i} couldn't be traced")
        elif sprv == T_M:
            if mmx[i, k] == -np.inf:
                raise RuntimeError(f"impossible M at k={k},i={i}")
            v, w, x = nt(i - 2), nt(i - 1), nt(i)
            sub_k = k_start + k - 1
            emit = float(rsc[_codon1(v, w, x)][sub_k])
            cur = float(mmx[i, k])
            if _close(cur, float(mmx[i - 3, k - 1])
                      + TSC(C.P_MM, sub_k - 1) + emit):
                scur = T_M
            elif _close(cur, float(imx[i - 3, k - 1])
                        + TSC(C.P_IM, sub_k - 1) + emit):
                scur = T_I
            elif _close(cur, float(dmx[i - 3, k - 1])
                        + TSC(C.P_DM, sub_k - 1) + emit):
                scur = T_D
            elif _close(cur, float(gx.xB[i - 3]) + emit):
                scur = T_B
            else:
                # P state: re-derive the donor site by scanning
                if i < min_intron + 7:
                    raise RuntimeError(f"M at k={k},i={i} untraceable")
                vsc -= TSC_P
                acc = [0, 0, 0]
                for a_off, slot in ((7, 0), (6, 1), (5, 2)):
                    aa, bb = nt(i - a_off), nt(i - a_off + 1)
                    if aa <= 3 and bb <= 3:
                        s = _sig(aa, bb)
                        if s == ACCEPT_AG:
                            acc[slot] = 1
                        elif s == ACCEPT_AC:
                            acc[slot] = 2
                if not any(acc):
                    raise RuntimeError(f"M at k={k},i={i} untraceable")
                scur = None
                for j in range(0, i - min_intron - 4):
                    da = nt(i - min_intron - j - 1)
                    db = nt(i - min_intron - j)
                    if da > 3 or db > 3:
                        continue
                    s = _sig(da, db)
                    if s == DONOR_GT:
                        don_sig = S_GTAG
                    elif s == DONOR_GC:
                        don_sig = S_GCAG
                    elif s == DONOR_AT:
                        don_sig = S_ATAC
                    else:
                        continue
                    t_ = nt(i - min_intron - j - 3)
                    u_ = nt(i - min_intron - j - 2)
                    v_, w_, x_ = nt(i - 5), nt(i - 4), nt(i - 3)
                    emit2 = float(rsc[_codon1(t_, u_, x_)][sub_k - 1])
                    emit1 = float(rsc[_codon1(u_, w_, x_)][sub_k - 1])
                    emit0 = float(rsc[_codon1(v_, w_, x_)][sub_k - 1])
                    want = 1 if don_sig in (S_GTAG, S_GCAG) else 2
                    for cc, emx, d_i in ((2, emit2, i - min_intron - j - 4),
                                         (1, emit1, i - min_intron - j - 3),
                                         (0, emit0, i - min_intron - j - 2)):
                        if acc[cc] != want:
                            continue
                        ps = max(float(mmx[d_i, k - 2]),
                                 float(dmx[d_i, k - 2])) \
                            + float(sigsc[don_sig]) + emx
                        if _close(cur, ps + TSC_P + emit):
                            scur = T_P
                            c = cc
                            donor_i = d_i
                            vsc -= float(sigsc[don_sig])
                            break
                    if scur == T_P:
                        break
                if scur != T_P:
                    raise RuntimeError(f"M at k={k},i={i} untraceable")
            k -= 1
            i -= 3
        elif sprv == T_D:
            if dmx[i, k] == -np.inf:
                raise RuntimeError(f"impossible D at k={k},i={i}")
            sub_k = k_start + k - 1
            if _close(float(dmx[i, k]), float(mmx[i, k - 1])
                      + TSC(C.P_MD, sub_k - 1)):
                scur = T_M
            elif _close(float(dmx[i, k]), float(dmx[i, k - 1])
                        + TSC(C.P_DD, sub_k - 1)):
                scur = T_D
            else:
                raise RuntimeError(f"D at k={k},i={i} untraceable")
            k -= 1
        elif sprv == T_I:
            if imx[i, k] == -np.inf:
                raise RuntimeError(f"impossible I at k={k},i={i}")
            sub_k = k_start + k - 1
            if _close(float(imx[i, k]), float(mmx[i - 3, k])
                      + TSC(C.P_MI, sub_k)):
                scur = T_M
            elif _close(float(imx[i, k]), float(imx[i - 3, k])
                        + TSC(C.P_II, sub_k)):
                scur = T_I
            else:
                raise RuntimeError(f"I at k={k},i={i} untraceable")
            i -= 3
        elif sprv == T_P:
            if mmx[donor_i, k - 1] > dmx[donor_i, k - 1]:
                scur = T_M
            else:
                scur = T_D
            k -= 1
            i = donor_i
        elif sprv == T_N:
            if gx.xN[i] == -np.inf:
                raise RuntimeError(f"impossible N at i={i}")
            scur = T_S if i == 0 else T_N
        elif sprv == T_B:
            # add back the B->M entry cost of the first matched node
            # (k was already decremented past it, so entry slot is
            # tsc[k_start+k-1][BM]; the global DP used free entry)
            vsc += TSC(C.P_BM, k_start + k - 1)
            if gx.xB[i] == -np.inf:
                raise RuntimeError(f"impossible B at i={i}")
            if _close(float(gx.xB[i]), float(gx.xN[i])
                      + float(xsc[C.X_N, C.MOVE])):
                scur = T_N
            else:
                raise RuntimeError(f"B at i={i} untraceable")
        else:
            raise RuntimeError("bogus state in traceback")

        if scur == T_M:
            c = 3
        elif scur != T_P:
            c = 0
        append(scur, k, i, c)
        if scur in (T_N, T_C) and scur == sprv:
            i -= 1
        sprv = scur

    tr = SplicedTrace(st=out_st[::-1], k=out_k[::-1], i=out_i[::-1],
                      c=out_c[::-1], vitsc=vsc)
    return tr
