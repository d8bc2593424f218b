"""Acceleration filters: SSV, MSV, Viterbi filter — exact integer
reference semantics.

These reproduce the reference's quantized filter arithmetic
bit-for-bit, but in clean k-contiguous layout instead of striped SIMD
(the striping is a CPU register-layout artifact; see analysis notes
below for why the k-space recurrences are exactly equivalent):

  * p7_SSVFilter (ref: impl_sse/ssvfilter.c:875): per-diagonal int8
    saturated accumulation, D(i,k)=sat8(D(i-1,k-1) - sbv[x_i][k]),
    diagonals start at -128; score read out of the unsigned-max with
    the documented overflow guards.
  * p7_MSVFilter (ref: impl_sse/msvfilter.c:76): uint8 offset
    arithmetic with xB/xJ specials.
  * p7_SSVFilter_BATH (ref: impl_sse/msvfilter.c:250): window capture
    with the striped-order argmax tie-breaking reproduced (stripe
    width 16).
  * p7_ViterbiFilter[_BATH] (ref: impl_sse/vitfilter.c:39, :286):
    int16 saturated Viterbi with the lazy-F DD closure (the striped
    multi-pass converges to the exact max-plus closure, so a k-order
    scan is bit-identical); window capture reproduces the striped
    argmax order (stripe width 8).

Numeric codes: eslOK=0-like semantics are mapped to Python returns;
overflow returns float('inf') scores (treated as "hit passes" by the
pipeline, as in the reference).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ... import constants as C
from ...oprofile import OProfile
from ...scoredata import ScoreData
from ...stats import gumbel_invsurv


# ---------------------------------------------------------------------
# SSV filter
# ---------------------------------------------------------------------
def ssv_filter(dsq: np.ndarray, om: OProfile) -> float | None:
    """SSV score in nats; None means "no result" (caller must fall
    back to the full MSV filter); inf means overflow (certain hit).
    ref: impl_sse/ssvfilter.c p7_SSVFilter :875."""
    if om.tjb_b + om.tbm_b + om.tec_b + om.bias_b >= 127:
        return None
    L = len(dsq)
    M = om.M
    sbv = om.sbv.astype(np.int16)       # [Kp, M+1]
    # D(i,k) = sat8(D(i-1,k-1) - sbv[x_i][k]); D(:,0)=D(0,:)=-128
    d = np.full(M + 1, -128, dtype=np.int16)
    xE_u = 0
    for i in range(L):
        row = sbv[dsq[i]]               # [M+1]
        d[1:] = np.clip(d[:-1].copy() - row[1:], -128, 127)
        d[0] = -128
        u = d.view()
        xE_u = max(xE_u, int(np.max(d.astype(np.int16) & 0xFF)))
    xE = np.uint16(xE_u)

    if xE >= 255 - om.bias_b:
        if om.base_b - om.tjb_b - om.tbm_b < 128:
            return None
        return float("inf")

    xE = np.uint16(xE + om.base_b - om.tjb_b - om.tbm_b)
    xE = np.uint16(xE - 128)
    if xE >= 255 - om.bias_b:
        return float("inf")
    xJ = np.uint16(xE - om.tec_b)
    if xJ > om.base_b:
        return None
    sc = (float(int(xJ) - om.tjb_b) - float(om.base_b)) / om.scale_b - 3.0
    return float(np.float32(sc))


# ---------------------------------------------------------------------
# MSV filter
# ---------------------------------------------------------------------
def msv_filter(dsq: np.ndarray, om: OProfile) -> float:
    """MSV score in nats (inf on overflow = certain hit).
    ref: impl_sse/msvfilter.c p7_MSVFilter :76.  Tries the SSV filter
    first, exactly as the reference does.  Uses the bit-exact native
    C++ implementation when available (native/src/bathio.cpp)."""
    from ...native import msv_filter_native
    sc = msv_filter_native(dsq, om)
    if sc is not None:
        return sc
    sc = ssv_filter(dsq, om)
    if sc is not None:
        return sc

    L, M = len(dsq), om.M
    rbv = om.rbv.astype(np.int16)     # [Kp, M+1] uint8 costs
    bias = np.int16(om.bias_b)
    dp = np.zeros(M + 1, dtype=np.int16)   # uint8 semantics in int16
    xJ = 0
    tjbm = np.int16((om.tjb_b + om.tbm_b) & 0xFF)
    base = np.int16(om.base_b)
    xB = max(0, int(base) - int(tjbm))     # subs_epu8

    for i in range(L):
        row = rbv[dsq[i]]
        mpv = np.empty_like(dp)
        mpv[0] = 0
        mpv[1:] = dp[:-1]
        sv = np.maximum(mpv, xB)
        sv = np.minimum(sv + bias, 255)          # adds_epu8
        sv = np.maximum(sv - row, 0)             # subs_epu8
        dp = sv
        dp[0] = 0
        xE = int(sv[1:].max()) if M >= 1 else 0
        if xE + om.bias_b >= 255:                # overflow test
            return float("inf")
        xE = max(0, xE - om.tec_b)               # subs_epu8
        xJ = max(xJ, xE)
        xB = max(0, max(int(base), xJ) - int(tjbm))

    sc = (float(xJ - om.tjb_b) - float(om.base_b)) / om.scale_b - 3.0
    return float(np.float32(sc))


# ---------------------------------------------------------------------
# Window list
# ---------------------------------------------------------------------
@dataclass
class Window:
    """One diagonal/DNA window (ref: hmmer.h P7_HMM_WINDOW)."""
    id: int
    n: int          # position (target coords, or DNA start)
    k: int          # model position at diagonal end
    length: int
    score: float = 0.0
    complementarity: int = 0
    target_len: int = 0
    pass_forward: bool = False


def ssv_filter_bath(dsq: np.ndarray, om: OProfile, data: ScoreData,
                    nullsc: float, P: float,
                    windows: list[Window]) -> None:
    """SSV filter that captures above-threshold diagonal windows
    (ref: impl_sse/msvfilter.c p7_SSVFilter_BATH :250).

    Caller must already have applied p7_bg_SetLength(L) /
    ReconfigMSVLength(L) conventions: we take the precomputed null
    score and compute sc_thresh exactly as the reference does.
    """
    L, M, Kp = len(dsq), om.M, om.Kp
    invP = float(gumbel_invsurv(P, om.evparam[C.EV_MMU],
                                om.evparam[C.EV_MLAMBDA]))
    val = (nullsc + invP * C.CONST_LOG2 + 3.0) * om.scale_b \
        + om.base_b + om.tec_b + om.tjb_b
    # P=1 (--max) makes the threshold -inf: capture everything
    sc_thresh = int(math.ceil(val)) if math.isfinite(val) \
        else -(1 << 30)

    from ...native import ssv_filter_bath_native
    wins = ssv_filter_bath_native(dsq, om, data, sc_thresh)
    if wins is not None:
        for n, k, length, score in wins:
            windows.append(Window(id=0, n=n, k=k, length=length,
                                  score=score,
                                  complementarity=C.NOCOMPLEMENT,
                                  target_len=L))
        return

    rbv = om.rbv.astype(np.int16)
    bias = np.int16(om.bias_b)
    tjbm = om.tjb_b + om.tbm_b
    base = om.base_b
    xB = max(0, base - tjbm)
    dp = np.zeros(M + 1, dtype=np.int16)
    Qb = max(2, (M + 15) // 16)      # stripe count for argmax order

    i = 1
    while i <= L:
        row = rbv[dsq[i - 1]]
        mpv = np.empty_like(dp)
        mpv[0] = 0
        mpv[1:] = dp[:-1]
        sv = np.maximum(mpv, xB)
        sv = np.minimum(sv + bias, 255)
        sv = np.maximum(sv - row, 0)
        dp = sv
        dp[0] = 0

        if M >= 1 and int(sv[1:].max()) >= sc_thresh:
            # find 'end': max-scoring k, tie-broken in striped
            # traversal order (q-major over stripes of 16 lanes)
            end, rem_sc = -1, -1
            for q in range(Qb):
                for z in range(16):
                    k = q + Qb * z + 1
                    if k <= M and int(dp[k]) >= sc_thresh \
                            and int(dp[k]) > rem_sc:
                        end = k
                        rem_sc = int(dp[k])
            dp[:] = 0          # reset DP after window capture
            _ssv_walk(dsq, om, data, i, end, rem_sc, windows, L)
        i += 1


def _ssv_walk(dsq, om, data, i, end, rem_sc, windows, L):
    """Complete one SSV_BATH capture event (row i, diagonal end k,
    captured score) into a Window: backward walk to the diagonal
    start + forward single-diagonal extension on the static score
    table (ref: impl_sse/msvfilter.c :250 capture tail).  Shared by
    the scalar scan above and the batched device capture kernel
    (ops.ssv.ssv_capture)."""
    M, Kp = om.M, om.Kp
    tjbm = om.tjb_b + om.tbm_b
    base = om.base_b
    sc = rem_sc
    # walk the diagonal backwards to its start
    start, tstart = end, i
    while rem_sc > base - tjbm:
        rem_sc -= om.bias_b - int(
            data.ssv_scores[start * Kp + dsq[tstart - 1]])
        start -= 1
        tstart -= 1
    start += 1
    tstart += 1
    # forward single-diagonal extension
    k2, n2 = end + 1, i + 1
    max_end, max_sc, pos_since_max = i, sc, 0
    while k2 < M and n2 <= L:
        sc += om.bias_b - int(data.ssv_scores[k2 * Kp + dsq[n2 - 1]])
        if sc >= max_sc:
            max_sc, max_end, pos_since_max = sc, n2, 0
        else:
            pos_since_max += 1
            if pos_since_max == 5:
                break
        k2 += 1
        n2 += 1
    end += max_end - i
    ret_sc = (float(max_sc - om.tjb_b) - float(om.base_b)) \
        / om.scale_b - 3.0
    windows.append(Window(id=0, n=tstart, k=end,
                          length=end - start + 1,
                          score=float(np.float32(ret_sc)),
                          complementarity=C.NOCOMPLEMENT,
                          target_len=L))


def ssv_thresh_bath(om, nullsc: float, P: float) -> int:
    """sc_thresh of p7_SSVFilter_BATH (ref: msvfilter.c :250) — the
    integer capture threshold derived from the F1 P-value; -2^30
    for P=1 (--max: capture everything)."""
    invP = float(gumbel_invsurv(P, om.evparam[C.EV_MMU],
                                om.evparam[C.EV_MLAMBDA]))
    val = (nullsc + invP * C.CONST_LOG2 + 3.0) * om.scale_b \
        + om.base_b + om.tec_b + om.tjb_b
    return int(math.ceil(val)) if math.isfinite(val) else -(1 << 30)


def ssv_windows_from_captures(dsq, om, data, caps, windows,
                              sc_thresh=None) -> bool:
    """Turn device capture tuples (nwin, [(i, k, sc), ...]) into
    Windows via the shared walks.  Returns False (caller must run the
    full scalar/native path) when the device capture overflowed its
    slots."""
    nwin, events = caps
    if nwin > len(events):
        return False
    L = len(dsq)
    for i, end, rem_sc in events[:nwin]:
        _ssv_walk(dsq, om, data, int(i), int(end), int(rem_sc),
                  windows, L)
    return True


# ---------------------------------------------------------------------
# Viterbi filter
# ---------------------------------------------------------------------
def vit_thresh_bath(om, filtersc: float, P: float) -> tuple[int, int]:
    """(sc_thresh, sc_ext_thresh) of p7_ViterbiFilter_BATH (ref:
    vitfilter.c :286) — the int16-space capture threshold (Viterbi
    Gumbel) and the SSV-space extension start (MSV Gumbel); -2^30
    for P=1 (--max: capture everything).  sc_ext_thresh depends on
    om.tjb_b, so om must be reconfigured to the ORF length."""
    invP = float(gumbel_invsurv(P, om.evparam[C.EV_VMU],
                                om.evparam[C.EV_VLAMBDA]))
    val = (filtersc + C.CONST_LOG2 * invP + 3.0) * om.scale_w \
        - float(om.xw[C.X_E, C.MOVE]) - float(om.xw[C.X_C, C.MOVE]) \
        + float(om.base_w)
    sc_thresh = int(math.ceil(val)) if math.isfinite(val) \
        else -(1 << 30)
    invP = float(gumbel_invsurv(P, om.evparam[C.EV_MMU],
                                om.evparam[C.EV_MLAMBDA]))
    val = (filtersc + C.CONST_LOG2 * invP + 3.0) * om.scale_b \
        + om.base_b + om.tec_b + om.tjb_b
    sc_ext_thresh = int(math.ceil(val)) if math.isfinite(val) \
        else -(1 << 30)
    return sc_thresh, sc_ext_thresh


def _vit_ext_walk(dsq, om, data, i, k_start, sc_ext_thresh, L):
    """Forward diagonal extension of one ViterbiFilter_BATH capture
    event in SSV score space from (i, k_start): extend M->M until the
    score stops improving for 5 steps (ref: vitfilter.c :286 capture
    tail).  Shared by the scalar scan above and the batched device
    event kernel (ops.vit.vit_capture).  Returns
    (max_k_end, max_i_end)."""
    M, Kp = om.M, om.Kp
    max_k_end, max_i_end = k_start, i
    sc_ext = sc_ext_thresh
    max_sc_ext, pos_since_max = sc_ext, 0
    kk, nn = k_start + 1, i + 1
    while kk <= M and nn <= L:
        sc_ext += om.bias_b - int(
            data.ssv_scores[kk * Kp + dsq[nn - 1]])
        if sc_ext >= max_sc_ext:
            max_sc_ext, max_k_end, max_i_end = sc_ext, kk, nn
            pos_since_max = 0
        else:
            pos_since_max += 1
            if pos_since_max == 5:
                break
        kk += 1
        nn += 1
    return max_k_end, max_i_end


def vit_windows_from_captures(dsq, om, data, rows, ks, windows,
                              sc_ext_thresh) -> None:
    """Replay device ViterbiFilter_BATH capture events into Windows:
    <rows>/<ks> are the ascending crossing rows (1-based) and their
    striped-order k_start from _vit_bath_mb_impl.  Events at
    i <= skip_until are suppressed exactly as the reference's scan
    does; each survivor pays one O(window) diagonal extension."""
    L = len(dsq)
    skip_until = 0
    for i, k_start in zip(rows, ks):
        i, k_start = int(i), int(k_start)
        if i <= skip_until:
            continue
        max_k_end, max_i_end = _vit_ext_walk(
            dsq, om, data, i, k_start, sc_ext_thresh, L)
        windows.append(Window(id=0, n=i, k=max_k_end,
                              length=max_k_end - k_start + 1,
                              score=0.0,
                              complementarity=C.NOCOMPLEMENT,
                              target_len=L))
        skip_until = max_i_end
def viterbi_filter(dsq: np.ndarray, om: OProfile, data: ScoreData | None = None,
                   filtersc: float = 0.0, P: float = 0.0,
                   windows: list[Window] | None = None) -> float:
    """Viterbi filter score in nats; when <windows> is provided, also
    captures diagonal windows at rows whose xE crosses the derived
    threshold (ref: impl_sse/vitfilter.c p7_ViterbiFilter :39 and
    p7_ViterbiFilter_BATH :286).  Score-only calls use the bit-exact
    native C implementation when available."""
    if windows is None:
        from ...native import vit_filter_native
        sc = vit_filter_native(dsq, om)
        if sc is not None:
            return sc
    L, M, Kp = len(dsq), om.M, om.Kp
    sat = lambda a: np.clip(a, -32768, 32767)
    twv = np.zeros((M + 1, C.NTRANS), dtype=np.int32)
    twv[:M + 1] = om.twv.astype(np.int32)
    rwv = om.rwv.astype(np.int32)
    xw = om.xw.astype(np.int32)

    capture = windows is not None
    if capture:
        sc_thresh, sc_ext_thresh = vit_thresh_bath(om, filtersc, P)
        from ...native import vit_filter_bath_native
        res = vit_filter_bath_native(dsq, om, data, sc_thresh,
                                     sc_ext_thresh)
        if res is not None:
            nsc, wins = res
            for wn, wk, wl in wins:
                windows.append(Window(id=0, n=wn, k=wk, length=wl,
                                      score=0.0,
                                      complementarity=C.NOCOMPLEMENT,
                                      target_len=L))
            return nsc
        skip_until = 0
        Qw = max(2, (M + 7) // 8)

    dm = np.full(M + 1, -32768, dtype=np.int32)
    di = np.full(M + 1, -32768, dtype=np.int32)
    dd = np.full(M + 1, -32768, dtype=np.int32)
    xN = om.base_w
    xB = xN + int(xw[C.X_N, C.MOVE])
    xJ = xC = -32768

    # transition views shifted so index k uses slot k-1 (BM/MM/IM/DM)
    tBM = np.empty(M + 1, dtype=np.int32); tBM[0] = -32768; tBM[1:] = twv[:M, C.P_BM]
    tMM = np.empty(M + 1, dtype=np.int32); tMM[0] = -32768; tMM[1:] = twv[:M, C.P_MM]
    tIM = np.empty(M + 1, dtype=np.int32); tIM[0] = -32768; tIM[1:] = twv[:M, C.P_IM]
    tDM = np.empty(M + 1, dtype=np.int32); tDM[0] = -32768; tDM[1:] = twv[:M, C.P_DM]
    tMD = np.empty(M + 1, dtype=np.int32); tMD[0] = -32768; tMD[1:] = twv[:M, C.P_MD]
    tDD = np.empty(M + 1, dtype=np.int32); tDD[0] = -32768; tDD[1:] = twv[:M, C.P_DD]
    tMI = twv[:, C.P_MI].copy()
    tII = twv[:, C.P_II].copy()

    for i in range(1, L + 1):
        row = rwv[dsq[i - 1]]
        mpv = np.empty_like(dm); mpv[0] = -32768; mpv[1:] = dm[:-1]
        ipv = np.empty_like(di); ipv[0] = -32768; ipv[1:] = di[:-1]
        dpv = np.empty_like(dd); dpv[0] = -32768; dpv[1:] = dd[:-1]
        sv = sat(np.int32(xB) + tBM)
        sv = np.maximum(sv, sat(mpv + tMM))
        sv = np.maximum(sv, sat(ipv + tIM))
        sv = np.maximum(sv, sat(dpv + tDM))
        sv = sat(sv + row)
        sv[0] = -32768
        xE = int(sv[1:].max()) if M >= 1 else -32768
        if xE >= 32767:
            return float("inf")
        new_i = np.maximum(sat(dm + tMI), sat(di + tII))
        new_i[0] = -32768
        # D partials: D(i,k) = M(i,k-1)+tMD[k-1]; Dmax tracks the
        # pre-shift dcv set {M(i,k)+tMD[k]} as the striped code does
        dcv = np.full(M + 1, -32768, dtype=np.int32)
        dcv[1:M] = sat(sv[1:M] + twv[1:M, C.P_MD])
        Dmax = int(dcv[1:M].max()) if M > 1 else -32768
        d_part = np.full(M + 1, -32768, dtype=np.int32)
        d_part[2:] = dcv[1:M + 1][:M - 1]

        dm, di = sv, new_i

        # specials
        xN = xN + int(xw[C.X_N, C.LOOP])
        xC = max(xC + int(xw[C.X_C, C.LOOP]), xE + int(xw[C.X_E, C.MOVE]))
        xJ = max(xJ + int(xw[C.X_J, C.LOOP]), xE + int(xw[C.X_E, C.LOOP]))
        xB = max(xJ + int(xw[C.X_J, C.MOVE]), xN + int(xw[C.X_N, C.MOVE]))

        if capture and i > skip_until and xE >= sc_thresh:
            # striped-order scan for the first k where M(i,k) == xE
            k_start = 0
            for q in range(Qw):
                for z in range(8):
                    k = q + Qw * z + 1
                    if k <= M and int(dm[k]) == xE:
                        k_start = k
                        break
                if k_start:
                    break
            max_k_end, max_i_end = _vit_ext_walk(
                dsq, om, data, i, k_start, sc_ext_thresh, L)
            windows.append(Window(id=0, n=i, k=max_k_end,
                                  length=max_k_end - k_start + 1,
                                  score=0.0,
                                  complementarity=C.NOCOMPLEMENT,
                                  target_len=L))
            skip_until = max_i_end

        # lazy-F DD closure
        if Dmax + om.ddbound_w > xB:
            dd = d_part
            for k in range(2, M + 1):
                dd[k] = max(dd[k], sat(np.int32(dd[k - 1]) + tDD[k]))
        else:
            dd = d_part

    if xC > -32768:
        sc = (float(xC + int(xw[C.X_C, C.MOVE])) - float(om.base_w)) \
            / om.scale_w - 3.0
        return float(np.float32(sc))
    return float("-inf")
