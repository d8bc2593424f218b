"""Probability-space Forward/Backward with sparse rescaling, posterior
decoding, optimal-accuracy alignment, and null2 — reference semantics.

These reproduce impl_sse/{fwdback,decoding,optacc,null2}.c in clean
k-contiguous float32 (the striped 4-pass DD serialization converges to
the full DD closure in exact arithmetic; we compute the closure with a
sequential scan, so values agree up to float32 summation-order noise,
well below the 0.1-bit output precision).

  forward()          ref: impl_sse/fwdback.c forward_engine :255
  backward()         ref: impl_sse/fwdback.c backward_engine :467
  decoding()         ref: impl_sse/decoding.c p7_Decoding :75
  domain_decoding()  ref: impl_sse/decoding.c p7_DomainDecoding :160
  optimal_accuracy() ref: impl_sse/optacc.c p7_OptimalAccuracy :57
  oa_trace()         ref: impl_sse/optacc.c p7_OATrace :230
  null2_by_expectation() ref: impl_sse/null2.c :44
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ... import constants as C
from ...oprofile import OProfile

F32 = np.float32


class RangeError(Exception):
    """Numeric under/overflow (maps to eslERANGE)."""


@dataclass
class PMatrix:
    """Prob-space DP matrix with per-row scale factors (ref: P7_OMX)."""
    L: int
    M: int
    xE: np.ndarray
    xN: np.ndarray
    xJ: np.ndarray
    xB: np.ndarray
    xC: np.ndarray
    scale: np.ndarray
    totscale: float = 0.0
    has_own_scales: bool = True
    # full-matrix rows (None in parser mode)
    mm: np.ndarray | None = None    # [L+1, M+1]
    im: np.ndarray | None = None
    dm: np.ndarray | None = None


def _trans_views(om: OProfile):
    """Shifted transition prob views so index k means 'into/at k'."""
    M = om.M
    tfv = om.tfv
    z = np.zeros(1, dtype=F32)
    tBM = np.concatenate([z, tfv[:M, C.P_BM]])   # tBM[k] = B->Mk
    tMM = np.concatenate([z, tfv[:M, C.P_MM]])   # tMM[k] = Mk-1->Mk
    tIM = np.concatenate([z, tfv[:M, C.P_IM]])
    tDM = np.concatenate([z, tfv[:M, C.P_DM]])
    tMD = np.concatenate([z, tfv[:M, C.P_MD]])   # tMD[k] = Mk-1->Dk  (slot k-1)
    tDD = np.concatenate([z, tfv[:M, C.P_DD]])   # tDD[k] = Dk-1->Dk  (slot k-1)
    # note: reference slots MD/DD at index k are Mk->Dk+1 / Dk->Dk+1;
    # the concatenated views shift them so position k holds the
    # transition INTO k (from k-1), matching the k-space recurrences.
    tMI = tfv[: M + 1, C.P_MI].copy()            # tMI[k] = Mk->Ik
    tII = tfv[: M + 1, C.P_II].copy()
    return tBM, tMM, tIM, tDM, tMD, tDD, tMI, tII


def forward(dsq: np.ndarray, om: OProfile, full: bool = False,
            fast: bool = False) -> tuple[PMatrix, float]:
    """Forward in prob space with sparse rescaling; returns (matrix,
    score in nats).  Raises RangeError on overflow/underflow
    (ref: forward_engine)."""
    L, M = len(dsq), om.M
    if not fast:
        from ...native import fwd_fill_native
        r = fwd_fill_native(dsq, om, full=full)
        if r is not None:
            return r
    rfv = om.rfv
    xf = om.xf
    tBM, tMM, tIM, tDM, tMD, tDD, tMI, tII = _trans_views(om)
    if fast:
        from .fwdback_fs import dd_closure_operator
        U = dd_closure_operator(tDD, M)
    else:
        U = None

    ox = PMatrix(L=L, M=M,
                 xE=np.zeros(L + 1, F32), xN=np.zeros(L + 1, F32),
                 xJ=np.zeros(L + 1, F32), xB=np.zeros(L + 1, F32),
                 xC=np.zeros(L + 1, F32), scale=np.ones(L + 1, F32))
    if full:
        ox.mm = np.zeros((L + 1, M + 1), F32)
        ox.im = np.zeros((L + 1, M + 1), F32)
        ox.dm = np.zeros((L + 1, M + 1), F32)

    mc = np.zeros(M + 1, F32)
    ic = np.zeros(M + 1, F32)
    dc = np.zeros(M + 1, F32)
    xN = F32(1.0)
    xB = xf[C.X_N, C.MOVE]
    xE = xJ = xC = F32(0.0)
    ox.xN[0], ox.xB[0] = xN, xB
    totscale = 0.0

    for i in range(1, L + 1):
        row = rfv[dsq[i - 1]]
        mpv = np.empty_like(mc); mpv[0] = 0; mpv[1:] = mc[:-1]
        ipv = np.empty_like(ic); ipv[0] = 0; ipv[1:] = ic[:-1]
        dpv = np.empty_like(dc); dpv[0] = 0; dpv[1:] = dc[:-1]
        sv = (xB * tBM + mpv * tMM + ipv * tIM + dpv * tDM) * row
        sv[0] = 0
        new_i = mc * tMI + ic * tII
        new_i[0] = 0
        # D paths: partial M->D then full DD closure
        dc = np.zeros(M + 1, F32)
        dc[2:] = sv[1:M] * tMD[2:]
        if U is not None:
            dc[:] = dc @ U
        else:
            from ...native import dd_closure_native
            if not (tDD.dtype == np.float32 and tDD.flags.c_contiguous
                    and dd_closure_native(dc, tDD, M)):
                for k in range(2, M + 1):    # sequential DD closure
                    dc[k] += dc[k - 1] * tDD[k]
        mc, ic = sv, new_i
        xE = F32(mc[1:].sum()) + F32(dc[1:].sum())
        xN = xN * xf[C.X_N, C.LOOP]
        xC = xC * xf[C.X_C, C.LOOP] + xE * xf[C.X_E, C.MOVE]
        xJ = xJ * xf[C.X_J, C.LOOP] + xE * xf[C.X_E, C.LOOP]
        xB = xJ * xf[C.X_J, C.MOVE] + xN * xf[C.X_N, C.MOVE]

        if xE > F32(1.0e4):
            scale = xE
            xN, xC, xJ, xB = xN / scale, xC / scale, xJ / scale, xB / scale
            inv = F32(1.0) / scale
            mc *= inv; ic *= inv; dc *= inv
            ox.scale[i] = scale
            totscale += float(np.log(scale))
            xE = F32(1.0)
        else:
            ox.scale[i] = 1.0

        ox.xE[i], ox.xN[i], ox.xJ[i], ox.xB[i], ox.xC[i] = xE, xN, xJ, xB, xC
        if full:
            ox.mm[i], ox.im[i], ox.dm[i] = mc, ic, dc

    ox.totscale = totscale
    if np.isnan(xC):
        raise RangeError("forward score is NaN")
    if L > 0 and xC == 0.0:
        raise RangeError("forward score underflow")
    if np.isinf(xC):
        raise RangeError("forward score overflow")
    score = totscale + float(np.log(xC * xf[C.X_C, C.MOVE]))
    return ox, score


def backward(dsq: np.ndarray, om: OProfile, fwd: PMatrix,
             full: bool = False) -> tuple[PMatrix, float]:
    """Backward in prob space, borrowing the Forward's scale factors
    (ref: backward_engine).  Returns (matrix, score)."""
    L, M = len(dsq), om.M
    from ...native import bwd_fill_native
    r = bwd_fill_native(dsq, om, fwd, full=full)
    if r is not None:
        return r
    rfv = om.rfv
    xf = om.xf
    tBM, tMM, tIM, tDM, tMD, tDD, tMI, tII = _trans_views(om)

    bx = PMatrix(L=L, M=M,
                 xE=np.zeros(L + 1, F32), xN=np.zeros(L + 1, F32),
                 xJ=np.zeros(L + 1, F32), xB=np.zeros(L + 1, F32),
                 xC=np.zeros(L + 1, F32), scale=np.ones(L + 1, F32),
                 has_own_scales=False)
    if full:
        bx.mm = np.zeros((L + 1, M + 1), F32)
        bx.im = np.zeros((L + 1, M + 1), F32)
        bx.dm = np.zeros((L + 1, M + 1), F32)

    # init row L
    xJ = xB = xN = F32(0.0)
    xC = xf[C.X_C, C.MOVE]
    xE = xC * xf[C.X_E, C.MOVE]
    mc = np.full(M + 1, xE, F32)
    dc = np.full(M + 1, xE, F32)
    ic = np.zeros(M + 1, F32)
    mc[0] = dc[0] = 0
    # DD closure on row L: D(L,k) += tDD[k+1] * D(L,k+1), k=M-1..1
    from ...native import bwd_dd_native
    if not bwd_dd_native(dc, tDD, M):
        for k in range(M - 1, 0, -1):
            dc[k] = dc[k] + dc[k + 1] * tDD[k + 1]
    # M->D: M(L,k) += D(L,k+1) * tMD[k+1]
    mc[1:M] += dc[2:M + 1] * tMD[2:M + 1]

    sc = fwd.scale[L]
    if sc > 1.0:
        inv = F32(1.0) / F32(sc)
        xE, xN, xC, xJ, xB = xE * inv, xN * inv, xC * inv, xJ * inv, xB * inv
        mc *= inv; dc *= inv; ic *= inv
    bx.scale[L] = sc
    bx.totscale = float(np.log(sc))
    bx.xE[L], bx.xN[L], bx.xJ[L], bx.xB[L], bx.xC[L] = xE, xN, xJ, xB, xC
    if full:
        bx.mm[L], bx.im[L], bx.dm[L] = mc, ic, dc

    for i in range(L - 1, 0, -1):
        # mstar(k) = M(i+1,k) * e(k, x_{i+1})
        mstar = mc * rfv[dsq[i]]            # dsq[i] is residue i+1 (0-based)
        mstar[0] = 0
        xB = F32((mstar[1:] * tBM[1:]).sum())
        nexti = ic
        new_i = np.zeros(M + 1, F32)
        new_m = np.zeros(M + 1, F32)
        new_d = np.zeros(M + 1, F32)
        ms1 = np.zeros(M + 1, F32)          # mstar(k+1)
        ms1[:M] = mstar[1:]
        # tMM[k+1] is Mk->Mk+1 (slot k) etc.
        tMMk = np.zeros(M + 1, F32); tMMk[:M] = tMM[1:]
        tIMk = np.zeros(M + 1, F32); tIMk[:M] = tIM[1:]
        tDMk = np.zeros(M + 1, F32); tDMk[:M] = tDM[1:]
        new_i[1:] = nexti[1:] * tII[1:] + ms1[1:] * tIMk[1:]
        new_m[1:] = nexti[1:] * tMI[1:] + ms1[1:] * tMMk[1:]
        new_d[1:] = ms1[1:] * tDMk[1:]

        xC = xC * xf[C.X_C, C.LOOP]
        xJ = xB * xf[C.X_J, C.MOVE] + xJ * xf[C.X_J, C.LOOP]
        xN = xB * xf[C.X_N, C.MOVE] + xN * xf[C.X_N, C.LOOP]
        xE = xC * xf[C.X_E, C.MOVE] + xJ * xf[C.X_E, C.LOOP]

        # {MD}->E and DD closure: D(i,k) = D_part(k) + xE + tDD[k+1]*D(i,k+1)
        new_d += xE
        new_d[0] = 0
        if not bwd_dd_native(new_d, tDD, M):
            for k in range(M - 1, 0, -1):
                new_d[k] = new_d[k] + new_d[k + 1] * tDD[k + 1]
        new_m += xE
        new_m[0] = 0
        new_m[1:M] += new_d[2:M + 1] * tMD[2:M + 1]

        mc, ic, dc = new_m, new_i, new_d

        if xB > 1.0e16:
            bx.has_own_scales = True
        if bx.has_own_scales:
            sc = float(xB) if xB > 1.0e4 else 1.0
        else:
            sc = float(fwd.scale[i])
        bx.scale[i] = sc
        if sc > 1.0:
            inv = F32(1.0) / F32(sc)
            xE, xN, xJ, xB, xC = xE * inv, xN * inv, xJ * inv, xB * inv, xC * inv
            mc *= inv; ic *= inv; dc *= inv
            bx.totscale += float(np.log(sc))
        bx.xE[i], bx.xN[i], bx.xJ[i], bx.xB[i], bx.xC[i] = xE, xN, xJ, xB, xC
        if full:
            bx.mm[i], bx.im[i], bx.dm[i] = mc, ic, dc

    # termination at i=0
    mstar = mc * rfv[dsq[0]]
    mstar[0] = 0
    xB = F32((mstar[1:] * tBM[1:]).sum())
    xN = xB * xf[C.X_N, C.MOVE] + xN * xf[C.X_N, C.LOOP]
    bx.xB[0], bx.xN[0] = xB, xN
    bx.scale[0] = 1.0
    if np.isnan(xN):
        raise RangeError("backward score is NaN")
    if L > 0 and xN == 0.0:
        raise RangeError("backward score underflow")
    if np.isinf(xN):
        raise RangeError("backward score overflow")
    return bx, bx.totscale + float(np.log(xN))


def decoding(om: OProfile, oxf: PMatrix, oxb: PMatrix) -> PMatrix:
    """Posterior decoding into a pp matrix (ref: p7_Decoding).
    Raises RangeError on scaleproduct overflow."""
    from ...native import decoding_native
    r = decoding_native(om, oxf, oxb)
    if r is not None:
        return r
    L, M = oxf.L, oxf.M
    pp = PMatrix(L=L, M=M,
                 xE=np.zeros(L + 1, F32), xN=np.zeros(L + 1, F32),
                 xJ=np.zeros(L + 1, F32), xB=np.zeros(L + 1, F32),
                 xC=np.zeros(L + 1, F32), scale=np.ones(L + 1, F32),
                 mm=np.zeros((L + 1, M + 1), F32),
                 im=np.zeros((L + 1, M + 1), F32),
                 dm=np.zeros((L + 1, M + 1), F32))
    scaleproduct = F32(1.0) / oxb.xN[0]
    for i in range(1, L + 1):
        totr = scaleproduct * oxf.scale[i]
        pp.mm[i] = oxf.mm[i] * oxb.mm[i] * totr
        pp.im[i] = oxf.im[i] * oxb.im[i] * totr
        pp.xN[i] = oxf.xN[i - 1] * oxb.xN[i] * om.xf[C.X_N, C.LOOP] * scaleproduct
        pp.xJ[i] = oxf.xJ[i - 1] * oxb.xJ[i] * om.xf[C.X_J, C.LOOP] * scaleproduct
        pp.xC[i] = oxf.xC[i - 1] * oxb.xC[i] * om.xf[C.X_C, C.LOOP] * scaleproduct
        if oxb.has_own_scales:
            scaleproduct = scaleproduct * oxf.scale[i] / oxb.scale[i]
    if np.isinf(scaleproduct):
        raise RangeError("decoding scaleproduct overflow")
    return pp


def domain_decoding(om: OProfile, oxf: PMatrix, oxb: PMatrix
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Domain-location decoding: returns (btot, etot, mocc), each
    [L+1] (ref: p7_DomainDecoding).  Raises RangeError on overflow."""
    L = oxf.L
    btot = np.zeros(L + 1, F32)
    etot = np.zeros(L + 1, F32)
    mocc = np.zeros(L + 1, F32)
    scaleproduct = F32(1.0) / oxb.xN[0]
    for i in range(1, L + 1):
        btot[i] = btot[i - 1] + (oxf.xB[i - 1] * oxb.xB[i - 1]
                                 * oxf.scale[i - 1] * scaleproduct)
        if oxb.has_own_scales:
            scaleproduct = scaleproduct * oxf.scale[i - 1] / oxb.scale[i - 1]
        etot[i] = etot[i - 1] + (oxf.xE[i] * oxb.xE[i]
                                 * oxf.scale[i] * scaleproduct)
        njcp = oxf.xN[i - 1] * oxb.xN[i] * om.xf[C.X_N, C.LOOP] * scaleproduct
        njcp += oxf.xJ[i - 1] * oxb.xJ[i] * om.xf[C.X_J, C.LOOP] * scaleproduct
        njcp += oxf.xC[i - 1] * oxb.xC[i] * om.xf[C.X_C, C.LOOP] * scaleproduct
        mocc[i] = F32(1.0) - njcp
    if np.isinf(scaleproduct):
        raise RangeError("domain decoding scaleproduct overflow")
    return btot, etot, mocc


NEG_INF = F32(-np.inf)


def optimal_accuracy(om: OProfile, pp: PMatrix) -> tuple[PMatrix, float]:
    """Optimal accuracy DP fill (ref: p7_OptimalAccuracy).  The masked
    max uses (t>0 ? value : 0.0), reproducing the reference's
    and_ps(cmpgt) idiom."""
    L, M = pp.L, pp.M
    from ...native import oa_fill_native
    r = oa_fill_native(om, pp)
    if r is not None:
        return r
    xf = om.xf
    tBM, tMM, tIM, tDM, tMD, tDD, tMI, tII = _trans_views(om)
    mBM = tBM > 0; mMM = tMM > 0; mIM = tIM > 0; mDM = tDM > 0
    mMD = tMD > 0; mDD = tDD > 0; mMI = tMI > 0; mII = tII > 0

    ox = PMatrix(L=L, M=M,
                 xE=np.full(L + 1, NEG_INF, F32), xN=np.zeros(L + 1, F32),
                 xJ=np.full(L + 1, NEG_INF, F32), xB=np.zeros(L + 1, F32),
                 xC=np.full(L + 1, NEG_INF, F32), scale=np.ones(L + 1, F32),
                 mm=np.full((L + 1, M + 1), NEG_INF, F32),
                 im=np.full((L + 1, M + 1), NEG_INF, F32),
                 dm=np.full((L + 1, M + 1), NEG_INF, F32))
    ox.xN[0] = 0.0
    ox.xB[0] = 0.0

    def masked(mask, val):
        return np.where(mask, val, F32(0.0))

    dd_all = bool(mDD[2:].all())

    for i in range(1, L + 1):
        mpv = np.empty(M + 1, F32); mpv[0] = NEG_INF; mpv[1:] = ox.mm[i - 1][:-1]
        ipv = np.empty(M + 1, F32); ipv[0] = NEG_INF; ipv[1:] = ox.im[i - 1][:-1]
        dpv = np.empty(M + 1, F32); dpv[0] = NEG_INF; dpv[1:] = ox.dm[i - 1][:-1]
        sv = masked(mBM, ox.xB[i - 1])
        sv = np.maximum(sv, masked(mMM, mpv))
        sv = np.maximum(sv, masked(mIM, ipv))
        sv = np.maximum(sv, masked(mDM, dpv))
        sv = sv + pp.mm[i]
        sv[0] = NEG_INF
        ox.mm[i] = sv
        iv = np.maximum(masked(mMI, ox.mm[i - 1]), masked(mII, ox.im[i - 1]))
        iv = iv + pp.im[i]
        iv[0] = NEG_INF
        ox.im[i] = iv
        # D: masked max closure
        dv = np.full(M + 1, NEG_INF, F32)
        dv[2:] = masked(mMD[2:], sv[1:M])
        if dd_all:
            # all DD transitions >0: the gated chain is a running
            # max (byte-identical to the scalar loop)
            np.maximum.accumulate(dv[2:], out=dv[2:])
        else:
            for k in range(2, M + 1):
                dv[k] = max(dv[k], masked(mDD[k], dv[k - 1]))
        ox.dm[i] = dv
        xE = max(float(sv[1:].max(initial=-np.inf)),
                 float(dv[1:].max(initial=-np.inf)))
        ox.xE[i] = xE
        t1 = 0.0 if xf[C.X_J, C.LOOP] == 0.0 else float(ox.xJ[i - 1] + pp.xJ[i])
        t2 = 0.0 if xf[C.X_E, C.LOOP] == 0.0 else float(ox.xE[i])
        ox.xJ[i] = max(t1, t2)
        t1 = 0.0 if xf[C.X_C, C.LOOP] == 0.0 else float(ox.xC[i - 1] + pp.xC[i])
        t2 = 0.0 if xf[C.X_E, C.MOVE] == 0.0 else float(ox.xE[i])
        ox.xC[i] = max(t1, t2)
        ox.xN[i] = 0.0 if xf[C.X_N, C.LOOP] == 0.0 else \
            float(ox.xN[i - 1] + pp.xN[i])
        t1 = 0.0 if xf[C.X_N, C.MOVE] == 0.0 else float(ox.xN[i])
        t2 = 0.0 if xf[C.X_J, C.MOVE] == 0.0 else float(ox.xJ[i])
        ox.xB[i] = max(t1, t2)

    return ox, float(ox.xC[L])


@dataclass
class Trace:
    """State path (ref: P7_TRACE).  Arrays grow by append; i/k are 0
    where not applicable; pp holds posterior probabilities; c holds
    per-step codon lengths (frameshift traces)."""
    st: list = field(default_factory=list)
    k: list = field(default_factory=list)
    i: list = field(default_factory=list)
    pp: list = field(default_factory=list)
    c: list = field(default_factory=list)
    sp: list = field(default_factory=list)
    M: int = 0
    L: int = 0
    fs: int = 0
    # indexing (filled by index())
    ndom: int = 0
    tfrom: list = field(default_factory=list)
    tto: list = field(default_factory=list)
    sqfrom: list = field(default_factory=list)
    sqto: list = field(default_factory=list)
    hmmfrom: list = field(default_factory=list)
    hmmto: list = field(default_factory=list)

    @property
    def N(self):
        return len(self.st)

    def append(self, st, k, i, pp=0.0, c=0):
        self.st.append(st)
        self.k.append(k)
        self.i.append(i)
        self.pp.append(pp)
        self.c.append(c)
        self.sp.append(-1)

    def reverse(self):
        self.st.reverse(); self.k.reverse(); self.i.reverse()
        self.pp.reverse(); self.c.reverse(); self.sp.reverse()

    def index(self):
        """Find domain boundaries (ref: p7_trace_Index)."""
        self.ndom = 0
        self.tfrom, self.tto = [], []
        self.sqfrom, self.sqto = [], []
        self.hmmfrom, self.hmmto = [], []
        z = 0
        while z < self.N:
            if self.st[z] == C.T_B:
                tfrom = z
                sqfrom = sqto = hmmfrom = hmmto = 0
                zz = z + 1
                while zz < self.N and self.st[zz] not in (C.T_E,):
                    if self.st[zz] == C.T_M:
                        if sqfrom == 0:
                            sqfrom = self.i[zz] - max(0, self.c[zz] - 1)
                            hmmfrom = self.k[zz]
                        sqto = self.i[zz]
                        hmmto = self.k[zz]
                    zz += 1
                self.ndom += 1
                self.tfrom.append(tfrom)
                self.tto.append(zz)
                self.sqfrom.append(sqfrom)
                self.sqto.append(sqto)
                self.hmmfrom.append(hmmfrom)
                self.hmmto.append(hmmto)
                z = zz
            z += 1


def oa_trace(om: OProfile, pp: PMatrix, ox: PMatrix) -> Trace:
    """Optimal accuracy traceback (ref: p7_OATrace :230).  Tie-breaks
    reproduce the reference's striped select_e traversal order
    (stripe width 4)."""
    from ...native import oa_trace_std_native
    r = oa_trace_std_native(om, pp, ox)
    if r is not None:
        return r
    L, M = ox.L, ox.M
    xf = om.xf
    tfv = om.tfv
    Qf = max(1, (M + 3) // 4)
    tr = Trace(M=M, L=L)
    i, k = L, 0
    tr.append(C.T_T, 0, 0)
    tr.append(C.T_C, 0, 0)
    s0 = C.T_C

    def tprob(k_slot, t):
        return tfv[k_slot, t] if 0 <= k_slot < M else 0.0

    while s0 != C.T_S:
        if s0 == C.T_M:
            # transitions into Mk live in tsc slot k-1 (ref select_m)
            path = [
                ox.mm[i - 1][k - 1] if k >= 2 and tprob(k - 1, C.P_MM) > 0 else NEG_INF,
                ox.im[i - 1][k - 1] if k >= 2 and tprob(k - 1, C.P_IM) > 0 else NEG_INF,
                ox.dm[i - 1][k - 1] if k >= 2 and tprob(k - 1, C.P_DM) > 0 else NEG_INF,
                ox.xB[i - 1] if tprob(k - 1, C.P_BM) > 0 else NEG_INF,
            ]
            states = [C.T_M, C.T_I, C.T_D, C.T_B]
            s1 = states[int(np.argmax(path))]
            k -= 1
            i -= 1
        elif s0 == C.T_D:
            p0 = ox.mm[i][k - 1] if k >= 2 and tprob(k - 1, C.P_MD) > 0 else NEG_INF
            p1 = ox.dm[i][k - 1] if k >= 2 and tprob(k - 1, C.P_DD) > 0 else NEG_INF
            s1 = C.T_M if p0 >= p1 else C.T_D
            k -= 1
        elif s0 == C.T_I:
            p0 = ox.mm[i - 1][k] if tprob(k, C.P_MI) > 0 else NEG_INF
            p1 = ox.im[i - 1][k] if tprob(k, C.P_II) > 0 else NEG_INF
            s1 = C.T_M if p0 >= p1 else C.T_I
            i -= 1
        elif s0 == C.T_N:
            s1 = C.T_S if i == 0 else C.T_N
        elif s0 == C.T_C:
            p0 = (float(ox.xC[i - 1] + pp.xC[i])
                  if xf[C.X_C, C.LOOP] != 0.0 else -np.inf)
            p1 = float(ox.xE[i]) if xf[C.X_E, C.MOVE] != 0.0 else -np.inf
            s1 = C.T_C if p0 > p1 else C.T_E
        elif s0 == C.T_J:
            p0 = (float(ox.xJ[i - 1] + pp.xJ[i])
                  if xf[C.X_J, C.LOOP] != 0.0 else -np.inf)
            p1 = float(ox.xE[i]) if xf[C.X_E, C.LOOP] != 0.0 else -np.inf
            s1 = C.T_J if p0 > p1 else C.T_E
        elif s0 == C.T_E:
            # striped traversal: q-major, lanes r; M wins ties (>=),
            # D only beats with strict >
            mx = -np.inf
            smax, kmax = C.T_M, 1
            for q in range(Qf):
                for r in range(4):
                    kk = r * Qf + q + 1
                    vM = float(ox.mm[i][kk]) if kk <= M else 0.0
                    if vM >= mx:
                        mx = vM; smax = C.T_M; kmax = kk
                for r in range(4):
                    kk = r * Qf + q + 1
                    vD = float(ox.dm[i][kk]) if kk <= M else 0.0
                    if vD > mx:
                        mx = vD; smax = C.T_D; kmax = kk
            k = kmax
            s1 = smax
        elif s0 == C.T_B:
            p0 = float(ox.xN[i]) if xf[C.X_N, C.MOVE] != 0.0 else -np.inf
            p1 = float(ox.xJ[i]) if xf[C.X_J, C.MOVE] != 0.0 else -np.inf
            s1 = C.T_N if p0 > p1 else C.T_J
        else:
            raise ValueError("bogus state in traceback")

        # posterior annotation (ref: get_postprob)
        if s1 == C.T_M:
            postprob = float(pp.mm[i][k])
        elif s1 == C.T_I:
            postprob = float(pp.im[i][k])
        elif s1 in (C.T_N, C.T_C, C.T_J) and s1 == s0:
            postprob = float({C.T_N: pp.xN, C.T_C: pp.xC,
                              C.T_J: pp.xJ}[s1][i])
        else:
            postprob = 0.0

        # emitting? record i; else 0
        if s1 == C.T_M or s1 == C.T_I:
            tr.append(s1, k, i, postprob)
        elif s1 in (C.T_N, C.T_C, C.T_J) and s1 == s0:
            tr.append(s1, 0, i, postprob)
        else:
            tr.append(s1, k if s1 == C.T_D else 0, 0, postprob)

        if s1 in (C.T_N, C.T_J, C.T_C) and s1 == s0:
            i -= 1
        s0 = s1

    tr.M, tr.L = M, L
    tr.reverse()
    return tr


def null2_by_expectation(om: OProfile, pp: PMatrix, K: int) -> np.ndarray:
    """null2[Kp] odds ratios from posterior expectations
    (ref: p7_Null2_ByExpectation).  <K> is the canonical alphabet size."""
    Ld, M = pp.L, pp.M
    Kp = om.Kp
    mexp = pp.mm[1:Ld + 1].sum(axis=0, dtype=F32)
    iexp = pp.im[1:Ld + 1].sum(axis=0, dtype=F32)
    xN = F32(pp.xN[1:Ld + 1].sum())
    xC = F32(pp.xC[1:Ld + 1].sum())
    xJ = F32(pp.xJ[1:Ld + 1].sum())
    norm = F32(1.0) / F32(Ld)
    mexp *= norm; iexp *= norm
    xfactor = xN * norm + xC * norm + xJ * norm
    null2 = np.zeros(Kp, F32)
    isum = F32(iexp[1:].sum())
    for x in range(K):
        null2[x] = F32((mexp[1:] * om.rfv[x][1:]).sum()) + isum + xfactor
    # degeneracies: unweighted average of member odds (esl_abc_FAvgScVec)
    return null2


def finish_null2(null2: np.ndarray, abc) -> np.ndarray:
    """Degenerate/gap entries (ref: null2.c tail + esl_abc_FAvgScVec)."""
    K, Kp = abc.K, abc.Kp
    for x in range(K + 1, Kp - 2):
        mem = abc.degen[x, :K]
        null2[x] = F32(null2[:K][mem].mean())
    null2[K] = 1.0
    null2[Kp - 2] = 1.0
    null2[Kp - 1] = 1.0
    return null2


# ---------------------------------------------------------------------
# Full-matrix log-space Viterbi + traceback, used by the splice
# pipeline's decoding-underflow recovery (ref: impl_sse/viterbi.c
# p7_Viterbi :67 / p7_Viterbi_Trace :230; the reference runs these on
# om_log, a p7_oprofile_Logify'd clone, so the score tables are just
# np.log of the pspace fb tables).
# ---------------------------------------------------------------------

def viterbi(dsq: np.ndarray, om: OProfile) -> tuple[PMatrix, float]:
    """Float log-space Viterbi retaining all rows for traceback.
    Returns (matrix with log-space mm/im/dm + specials, score nats)."""
    L, M = len(dsq), om.M
    with np.errstate(divide="ignore"):
        ltfv = np.log(om.tfv.astype(F32))
        lrfv = np.log(om.rfv.astype(F32))
        lxf = np.log(om.xf.astype(F32))
    z = np.full(1, NEG_INF, F32)
    tBM = np.concatenate([z, ltfv[:M, C.P_BM]])
    tMM = np.concatenate([z, ltfv[:M, C.P_MM]])
    tIM = np.concatenate([z, ltfv[:M, C.P_IM]])
    tDM = np.concatenate([z, ltfv[:M, C.P_DM]])
    tMD = np.concatenate([z, ltfv[:M, C.P_MD]])
    tDD = np.concatenate([z, ltfv[:M, C.P_DD]])
    tMI = ltfv[: M + 1, C.P_MI].copy()
    tII = ltfv[: M + 1, C.P_II].copy()

    ox = PMatrix(L=L, M=M,
                 xE=np.full(L + 1, NEG_INF, F32),
                 xN=np.full(L + 1, NEG_INF, F32),
                 xJ=np.full(L + 1, NEG_INF, F32),
                 xB=np.full(L + 1, NEG_INF, F32),
                 xC=np.full(L + 1, NEG_INF, F32),
                 scale=np.ones(L + 1, F32),
                 mm=np.full((L + 1, M + 1), NEG_INF, F32),
                 im=np.full((L + 1, M + 1), NEG_INF, F32),
                 dm=np.full((L + 1, M + 1), NEG_INF, F32))
    xN = F32(0.0)
    xB = F32(lxf[C.X_N, C.MOVE])
    xE = xJ = xC = NEG_INF
    ox.xN[0], ox.xB[0] = xN, xB

    with np.errstate(invalid="ignore"):
        for i in range(1, L + 1):
            r = lrfv[int(dsq[i - 1])]
            mpv = np.empty(M + 1, F32)
            mpv[0] = NEG_INF
            mpv[1:] = ox.mm[i - 1][:-1]
            ipv = np.empty(M + 1, F32)
            ipv[0] = NEG_INF
            ipv[1:] = ox.im[i - 1][:-1]
            dpv = np.empty(M + 1, F32)
            dpv[0] = NEG_INF
            dpv[1:] = ox.dm[i - 1][:-1]
            sv = xB + tBM
            sv = np.maximum(sv, mpv + tMM)
            sv = np.maximum(sv, ipv + tIM)
            sv = np.maximum(sv, dpv + tDM)
            sv = sv + r
            sv[0] = NEG_INF
            np.nan_to_num(sv, copy=False, nan=-np.inf)
            ox.mm[i] = sv
            iv = np.maximum(ox.mm[i - 1] + tMI, ox.im[i - 1] + tII)
            iv[0] = NEG_INF
            np.nan_to_num(iv, copy=False, nan=-np.inf)
            ox.im[i] = iv
            # D along k: sequential max(M(i,k-1)+tMD, D(i,k-1)+tDD);
            # the striped multi-pass sweep converges to this closure
            dv = ox.dm[i]
            dprev = NEG_INF
            for k in range(2, M + 1):
                dprev = max(sv[k - 1] + tMD[k], dprev + tDD[k])
                dv[k] = dprev
            xE = F32(sv[1:].max(initial=NEG_INF))      # Mk->E only
            xN = F32(xN + lxf[C.X_N, C.LOOP])
            xC = F32(max(xC + lxf[C.X_C, C.LOOP],
                         xE + lxf[C.X_E, C.MOVE]))
            xJ = F32(max(xJ + lxf[C.X_J, C.LOOP],
                         xE + lxf[C.X_E, C.LOOP]))
            xB = F32(max(xJ + lxf[C.X_J, C.MOVE],
                         xN + lxf[C.X_N, C.MOVE]))
            ox.xE[i], ox.xN[i], ox.xJ[i] = xE, xN, xJ
            ox.xB[i], ox.xC[i] = xB, xC

    return ox, float(ox.xC[L] + lxf[C.X_C, C.MOVE])


def _fcompare(x0: float, x: float,
              r_tol: float = 1e-5, a_tol: float = 1e-4) -> bool:
    """esl_FCompare semantics as used by p7_Viterbi_Trace."""
    if x0 == x:
        return True
    if not (np.isfinite(x0) and np.isfinite(x)):
        return False
    d = abs(x0 - x)
    return d <= a_tol or d <= r_tol * max(abs(x0), abs(x))


def viterbi_trace(dsq: np.ndarray, om: OProfile, ox: PMatrix) -> Trace:
    """Traceback of viterbi()'s matrix (ref: p7_Viterbi_Trace :230).
    State choice order and tolerances follow the reference."""
    L, M = ox.L, ox.M
    with np.errstate(divide="ignore"):
        ltfv = np.log(om.tfv.astype(F32))
        lrfv = np.log(om.rfv.astype(F32))
        lxf = np.log(om.xf.astype(F32))

    def mm(i, k):
        return float(ox.mm[i][k]) if k >= 1 else -np.inf

    def dm(i, k):
        return float(ox.dm[i][k]) if k >= 1 else -np.inf

    def im(i, k):
        return float(ox.im[i][k]) if k >= 1 else -np.inf

    tr = Trace(M=M, L=L)
    i, k = L, 0
    tr.append(C.T_T, 0, 0)
    tr.append(C.T_C, 0, 0)
    sprv = C.T_C
    while sprv != C.T_S:
        if sprv == C.T_C:
            xc = float(ox.xC[i])
            if xc == -np.inf:
                raise RangeError("impossible C in Viterbi trace")
            if _fcompare(xc, float(ox.xC[i - 1] + lxf[C.X_C, C.LOOP])):
                scur = C.T_C
            elif _fcompare(xc, float(ox.xE[i] + lxf[C.X_E, C.MOVE])):
                scur = C.T_E
            else:
                raise RangeError("untraceable C in Viterbi trace")
        elif sprv == C.T_E:
            xe = float(ox.xE[i])
            if xe == -np.inf:
                raise RangeError("impossible E in Viterbi trace")
            scur = C.T_M
            for k in range(M, 0, -1):
                if _fcompare(xe, mm(i, k)):
                    break
            else:
                raise RangeError("untraceable E in Viterbi trace")
        elif sprv == C.T_M:
            v = mm(i, k)
            if v == -np.inf:
                raise RangeError("impossible M in Viterbi trace")
            rsc = float(lrfv[int(dsq[i - 1])][k])
            if _fcompare(v, float(ox.xB[i - 1] + ltfv[k - 1, C.P_BM])
                         + rsc):
                scur = C.T_B
            elif _fcompare(v, mm(i - 1, k - 1)
                           + float(ltfv[k - 1, C.P_MM]) + rsc):
                scur = C.T_M
            elif _fcompare(v, im(i - 1, k - 1)
                           + float(ltfv[k - 1, C.P_IM]) + rsc):
                scur = C.T_I
            elif _fcompare(v, dm(i - 1, k - 1)
                           + float(ltfv[k - 1, C.P_DM]) + rsc):
                scur = C.T_D
            else:
                raise RangeError("untraceable M in Viterbi trace")
            k -= 1
            i -= 1
        elif sprv == C.T_D:
            v = dm(i, k)
            if v == -np.inf:
                raise RangeError("impossible D in Viterbi trace")
            # our tfv row j holds Mj->Dj+1 / Dj->Dj+1, so the
            # transition INTO Dk sits at row k-1 (the reference's
            # striped element k-2 in its 0-based stripe space)
            tMDv = float(ltfv[k - 1, C.P_MD]) if k > 1 else -np.inf
            tDDv = float(ltfv[k - 1, C.P_DD]) if k > 1 else -np.inf
            if _fcompare(v, mm(i, k - 1) + tMDv):
                scur = C.T_M
            elif _fcompare(v, dm(i, k - 1) + tDDv):
                scur = C.T_D
            else:
                raise RangeError("untraceable D in Viterbi trace")
            k -= 1
        elif sprv == C.T_I:
            v = im(i, k)
            if v == -np.inf:
                raise RangeError("impossible I in Viterbi trace")
            if _fcompare(v, mm(i - 1, k) + float(ltfv[k, C.P_MI])):
                scur = C.T_M
            elif _fcompare(v, im(i - 1, k) + float(ltfv[k, C.P_II])):
                scur = C.T_I
            else:
                raise RangeError("untraceable I in Viterbi trace")
            i -= 1
        elif sprv == C.T_N:
            scur = C.T_S if i == 0 else C.T_N
        elif sprv == C.T_B:
            xb = float(ox.xB[i])
            if xb == -np.inf:
                raise RangeError("impossible B in Viterbi trace")
            if _fcompare(xb, float(ox.xN[i] + lxf[C.X_N, C.MOVE])):
                scur = C.T_N
            elif _fcompare(xb, float(ox.xJ[i] + lxf[C.X_J, C.MOVE])):
                scur = C.T_J
            else:
                raise RangeError("untraceable B in Viterbi trace")
        elif sprv == C.T_J:
            xj = float(ox.xJ[i])
            if xj == -np.inf:
                raise RangeError("impossible J in Viterbi trace")
            if _fcompare(xj, float(ox.xJ[i - 1] + lxf[C.X_J, C.LOOP])):
                scur = C.T_J
            elif _fcompare(xj, float(ox.xE[i] + lxf[C.X_E, C.LOOP])):
                scur = C.T_E
            else:
                raise RangeError("untraceable J in Viterbi trace")
        else:
            raise RangeError("bogus state in Viterbi trace")
        if scur in (C.T_M, C.T_I):
            tr.append(scur, k, i)
        elif scur in (C.T_N, C.T_J, C.T_C) and scur == sprv:
            tr.append(scur, 0, i)           # emitting N/C/J step
        else:
            tr.append(scur, k if scur == C.T_D else 0, 0)
        if scur in (C.T_N, C.T_J, C.T_C) and scur == sprv:
            i -= 1
        sprv = scur
    tr.reverse()
    return tr
