"""Stochastic-trace ensemble resolution of multidomain regions
(ref: p7_domaindef.c region_trace_ensemble :~530,
generic_stotrace.c p7_GStochasticTrace :42, p7_spensemble.c
p7_spensemble_Cluster :321, generic_null2.c p7_GNull2_ByTrace).

A multidomain region's Forward matrix is sampled <nsamples> times;
sampled domain segments are single-linkage clustered (overlap +
diagonal rules), significant clusters become envelopes with consensus
endpoints, and the ensemble also yields per-position null2 odds.
"""

from __future__ import annotations

import math

import numpy as np

from . import constants as C
from .oprofile import OProfile
from .ops.reference import fwdback as fb
from .ops.reference.fwdback import PMatrix, Trace
from .rng import Randomness

F32 = np.float32


# ---------------------------------------------------------------------
# Stochastic traceback from a full Forward matrix
# ---------------------------------------------------------------------
def stochastic_trace(r: Randomness, dsq: np.ndarray, om: OProfile,
                     oxf: PMatrix) -> Trace:
    """Sample one state path from P(path | seq) using the scaled
    prob-space Forward matrix (ref: p7_GStochasticTrace :42 semantics;
    sparse-rescale corrections for cross-row selections).

    Documented divergence from the reference binary (SURVEY §7 hard
    part 3): the reference samples from its *striped SIMD* Forward
    matrix, visiting E-state predecessors in striped lane order
    (impl_sse/stotrace.c select_e: k = r*Q+q+1, M/D interleaved per
    stripe) over values that carry striped-arithmetic rounding.  This
    implementation consumes the exact same MT19937 stream but visits
    k = 1..M linearly over its own (differently-rounded) matrix, so
    on a roll that lands within ulps of a cumulative boundary the
    selected k may differ from the reference binary.  Effects are
    confined to multidomain-region resolution; all golden outputs are
    unaffected, and results remain fully deterministic per seed."""
    from .native import stotrace_native
    ntr = stotrace_native(r, om, oxf)
    if ntr is not None:
        return ntr

    L, M = oxf.L, oxf.M
    xf = om.xf
    tBM, tMM, tIM, tDM, tMD, tDD, tMI, tII = fb._trans_views(om)
    rfv = om.rfv
    mm, im, dm = oxf.mm, oxf.im, oxf.dm
    scale = oxf.scale
    tr = Trace()
    tr.append(C.T_T, 0, 0)
    tr.append(C.T_C, 0, 0)

    def choose(weights):
        tot = float(sum(weights))
        if tot <= 0:
            return 0
        roll = r.random() * tot
        s = 0.0
        for a, w in enumerate(weights):
            s += w
            if roll < s:
                return a
        return len(weights) - 1

    i = L
    k = 0
    st = C.T_C
    while st != C.T_S:
        if st == C.T_C:
            w_loop = float(oxf.xC[i - 1]) * float(xf[C.X_C, C.LOOP]) \
                / float(scale[i]) if i > 0 else 0.0
            w_move = float(oxf.xE[i]) * float(xf[C.X_E, C.MOVE])
            nxt = (C.T_C, C.T_E)[choose((w_loop, w_move))]
            if nxt == C.T_C:
                i -= 1
        elif st == C.T_E:
            # local exit from any M or D at row i
            wts = np.concatenate([mm[i][1:], dm[i][1:]])
            sel = choose(wts)
            if sel < M:
                nxt, k = C.T_M, sel + 1
            else:
                nxt, k = C.T_D, sel - M + 1
        elif st == C.T_M:
            w = (float(oxf.xB[i - 1]) * float(tBM[k]),
                 float(mm[i - 1][k - 1]) * float(tMM[k]),
                 float(im[i - 1][k - 1]) * float(tIM[k]),
                 float(dm[i - 1][k - 1]) * float(tDM[k]))
            nxt = (C.T_B, C.T_M, C.T_I, C.T_D)[choose(w)]
            i -= 1
            k -= 1
        elif st == C.T_D:
            w = (float(mm[i][k - 1]) * float(tMD[k]),
                 float(dm[i][k - 1]) * float(tDD[k]))
            nxt = (C.T_M, C.T_D)[choose(w)]
            k -= 1
        elif st == C.T_I:
            w = (float(mm[i - 1][k]) * float(tMI[k]),
                 float(im[i - 1][k]) * float(tII[k]))
            nxt = (C.T_M, C.T_I)[choose(w)]
            i -= 1
        elif st == C.T_B:
            w_nmove = float(oxf.xN[i]) * float(xf[C.X_N, C.MOVE])
            w_jmove = float(oxf.xJ[i]) * float(xf[C.X_J, C.MOVE])
            nxt = (C.T_N, C.T_J)[choose((w_nmove, w_jmove))]
        elif st == C.T_J:
            w_loop = float(oxf.xJ[i - 1]) * float(xf[C.X_J, C.LOOP]) \
                / float(scale[i]) if i > 0 else 0.0
            w_move = float(oxf.xE[i]) * float(xf[C.X_E, C.LOOP])
            nxt = (C.T_J, C.T_E)[choose((w_loop, w_move))]
            if nxt == C.T_J:
                i -= 1
        elif st == C.T_N:
            nxt = C.T_S if i == 0 else C.T_N
            if nxt == C.T_N:
                i -= 1
        else:
            raise RuntimeError("bogus state in stochastic trace")
        if nxt == C.T_M:
            tr.append(nxt, k, i)
        elif nxt == C.T_I:
            tr.append(nxt, k, i)
        elif nxt == C.T_D:
            tr.append(nxt, k, 0)
        else:
            tr.append(nxt, 0, 0 if nxt == C.T_S else i)
        st = nxt
    tr.reverse()
    tr.M, tr.L = M, L
    return tr


def null2_by_trace(om: OProfile, tr: Trace, z1: int, z2: int
                   ) -> np.ndarray:
    """Null2 odds ratios from one trace segment
    (ref: p7_GNull2_ByTrace :~60)."""
    M, K = om.M, 20
    musage = np.zeros(M + 1, F32)
    iusage = np.zeros(M + 1, F32)
    xfactor = 0.0
    Ld = 0
    for z in range(z1, z2 + 1):
        s = tr.st[z]
        if s == C.T_M:
            Ld += 1
            musage[tr.k[z]] += 1.0
        elif s == C.T_I:
            Ld += 1
            iusage[tr.k[z]] += 1.0
        elif s in (C.T_N, C.T_C, C.T_J):
            if z > 0 and tr.st[z - 1] == s:
                Ld += 1
                xfactor += 1.0
    if Ld == 0:
        return np.ones(om.Kp, F32)
    musage /= Ld
    iusage /= Ld
    xfactor /= Ld
    null2 = np.zeros(om.Kp, F32)
    # M/I emission odds; insert odds are 1 in H3
    null2[:K] = musage[1:M + 1] @ om.rfv[:K, 1:M + 1].T
    null2[:K] += iusage[1:M].sum() * 1.0
    null2[:K] += xfactor
    from .alphabet import amino
    null2 = fb.finish_null2(null2, amino())
    return null2


# ---------------------------------------------------------------------
# Single-linkage clustering of sampled segments
# ---------------------------------------------------------------------
def _link(h1, h2, min_overlap, of_smaller, max_diagdiff,
          fs=False) -> bool:
    """ref: p7_spensemble.c link_spsamples :191 (fs variant
    link_spsamples_fs :227 divides seq coords by 3 in the diagonal
    test)."""
    _, i1, j1, k1, m1 = h1
    _, i2, j2, k2, m2 = h2
    nov = min(j1, j2) - max(i1, i2) + 1
    n = min(j1 - i1 + 1, j2 - i2 + 1) if of_smaller \
        else max(j1 - i1 + 1, j2 - i2 + 1)
    if n <= 0 or nov / n < min_overlap:
        return False
    nov = min(m1, m2) - max(k1, k2)
    n = min(m1 - k1 + 1, m2 - k2 + 1) if of_smaller \
        else max(m1 - k1 + 1, m2 - k2 + 1)
    if n <= 0 or nov / n < min_overlap:
        return False
    if fs:
        if abs((i1 // 3 - k1) - (i2 // 3 - k2)) <= max_diagdiff:
            return True
        if abs((j1 // 3 - m1) - (j2 // 3 - m2)) <= max_diagdiff:
            return True
        return False
    if abs((i1 - k1) - (i2 - k2)) <= max_diagdiff:
        return True
    if abs((j1 - m1) - (j2 - m2)) <= max_diagdiff:
        return True
    return False


def cluster_segments(samples, nsamples, min_overlap, of_smaller,
                     max_diagdiff, min_posterior, min_endpointp,
                     fs=False):
    """Single-linkage cluster sampled (t, i, j, k, m) segments;
    return significant clusters' consensus coords
    [(i, j, k, m, prob)] sorted by i (ref: p7_spensemble_Cluster)."""
    n = len(samples)
    if n == 0:
        return []
    # vectorized pairwise _link (same float-division comparisons as
    # the scalar predicate, so boundary cases agree bit-for-bit)
    arr = np.asarray([s[:5] for s in samples], dtype=np.int64)
    iv, jv, kv, mv = (np.ascontiguousarray(arr[:, c])
                      for c in (1, 2, 3, 4))
    from .native import cluster_components_native
    nc = cluster_components_native(iv, jv, kv, mv, min_overlap,
                                   of_smaller, max_diagdiff, fs)
    if nc is not None:
        labels, ncomp = nc
        return _consensus_clusters(arr, labels, nsamples,
                                   min_posterior, min_endpointp)
    len_s = jv - iv + 1
    nov_s = (np.minimum.outer(jv, jv)
             - np.maximum.outer(iv, iv) + 1).astype(np.float64)
    ns = (np.minimum.outer(len_s, len_s) if of_smaller
          else np.maximum.outer(len_s, len_s)).astype(np.float64)
    len_k = mv - kv + 1
    nov_k = (np.minimum.outer(mv, mv)
             - np.maximum.outer(kv, kv)).astype(np.float64)
    nk = (np.minimum.outer(len_k, len_k) if of_smaller
          else np.maximum.outer(len_k, len_k)).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        ok = ((ns > 0) & ~(nov_s / ns < min_overlap)
              & (nk > 0) & ~(nov_k / nk < min_overlap))
    if fs:
        d1 = iv // 3 - kv
        d2 = jv // 3 - mv
    else:
        d1 = iv - kv
        d2 = jv - mv
    ok &= ((np.abs(d1[:, None] - d1[None, :]) <= max_diagdiff)
           | (np.abs(d2[:, None] - d2[None, :]) <= max_diagdiff))
    # connected components by vectorized BFS (importing scipy.csgraph
    # costs ~0.9s of startup; n is at most a few thousand here)
    labels = np.full(n, -1, np.int64)
    ncomp = 0
    for s0 in range(n):
        if labels[s0] >= 0:
            continue
        seen = np.zeros(n, bool)
        seen[s0] = True
        frontier = seen.copy()
        while frontier.any():
            nxt = ok[frontier].any(axis=0) & ~seen
            seen |= nxt
            frontier = nxt
        labels[seen] = ncomp
        ncomp += 1
    return _consensus_clusters(arr, labels, nsamples, min_posterior,
                               min_endpointp)


def _consensus_clusters(arr, labels, nsamples, min_posterior,
                        min_endpointp):
    """Per-cluster posterior gate + consensus coordinates (the tail
    of p7_spensemble_Cluster)."""
    clusters: dict[int, list[int]] = {}
    for a in range(len(labels)):
        clusters.setdefault(int(labels[a]), []).append(a)

    sigc = []
    for members in clusters.values():
        mem = np.asarray(members, np.int64)
        # posterior prob: distinct sample indices in the cluster
        ninc = int(np.unique(arr[mem, 0]).size)
        if ninc / nsamples < min_posterior:
            continue
        epc_threshold = math.ceil(ninc * min_endpointp)

        def consensus(vals, leftmost):
            vmin = int(vals.min())
            counts = np.bincount(vals - vmin)
            hit = np.nonzero(counts >= epc_threshold)[0]
            if hit.size:
                return vmin + int(hit[0] if leftmost else hit[-1])
            return vmin + int(np.argmax(counts))

        best_i = consensus(arr[mem, 1], True)
        best_j = consensus(arr[mem, 2], False)
        best_k = consensus(arr[mem, 3], True)
        best_m = consensus(arr[mem, 4], False)
        if best_i > best_j or best_k > best_m:
            continue
        sigc.append((best_i, best_j, best_k, best_m, ninc / nsamples))
    sigc.sort(key=lambda s: s[0])
    return sigc


# ---------------------------------------------------------------------
# The region resolver used by domaindef
# ---------------------------------------------------------------------
def region_trace_ensemble(ddef, om: OProfile, orfsq, ireg: int,
                          jreg: int, saveL: int):
    """Resolve a multidomain region into envelopes and set the
    region's n2sc null2 scores (ref: region_trace_ensemble; the
    returned envelopes are ORF coords).  Returns None on failure so
    the caller falls back to a single envelope."""
    Lr = jreg - ireg + 1
    r = Randomness(ddef.seed)      # do_reseeding: reset per region
    om.reconfig_multihit(saveL)
    try:
        sub = orfsq.dsq[ireg - 1:jreg]
        oxf, _ = fb.forward(sub, om, full=True)
    except fb.RangeError:
        _restore_unihit(om, saveL)
        return None
    # f32 accumulator with per-position f32 adds, then f32 division
    # and log — the reference's `float n2sc[pos] += ...` then
    # `logf(n2sc[pos] / (float) nsamples)` (region_trace_ensemble)
    n2acc = np.zeros(Lr, np.float32)
    samples = []
    for t in range(ddef.nsamples):
        tr = stochastic_trace(r, sub, om, oxf)
        tr.index()
        pos = 1
        for d in range(tr.ndom):
            samples.append((t, tr.sqfrom[d] + ireg - 1,
                            tr.sqto[d] + ireg - 1,
                            tr.hmmfrom[d], tr.hmmto[d]))
            null2 = null2_by_trace(om, tr, tr.tfrom[d], tr.tto[d])
            while pos <= tr.sqfrom[d]:
                n2acc[pos - 1] += F32(1.0)
                pos += 1
            while pos <= tr.sqto[d]:
                n2acc[pos - 1] += F32(null2[sub[pos - 1]])
                pos += 1
        while pos <= Lr:
            n2acc[pos - 1] += F32(1.0)
            pos += 1
    with np.errstate(divide="ignore"):
        ddef.n2sc[ireg:jreg + 1] = np.log(
            n2acc / np.float32(ddef.nsamples))

    sigc = cluster_segments(samples, ddef.nsamples, ddef.min_overlap,
                            ddef.of_smaller, ddef.max_diagdiff,
                            ddef.min_posterior, ddef.min_endpointp)
    envs = _undominated_envs(sigc)
    _restore_unihit(om, saveL)
    return envs if envs else None


def _undominated_envs(sigc):
    """Remove dominated overlapping clusters (ref:
    region_trace_ensemble ~:575: >= 80% seq overlap of the smaller ->
    keep the higher-probability cluster); returns (i, j) envelopes."""
    keep = [True] * len(sigc)
    for d in range(len(sigc)):
        for d2 in range(d + 1, len(sigc)):
            nov = min(sigc[d][1], sigc[d2][1]) \
                - max(sigc[d][0], sigc[d2][0]) + 1
            if nov <= 0:
                break
            nmin = min(sigc[d][1] - sigc[d][0] + 1,
                       sigc[d2][1] - sigc[d2][0] + 1)
            if nov / nmin >= 0.8:
                if sigc[d][4] > sigc[d2][4]:
                    keep[d2] = False
                else:
                    keep[d] = False
    return [(s[0], s[1]) for s, kp in zip(sigc, keep) if kp]


def _restore_unihit(om, saveL):
    # identical end state to the inline xf/xw/nj writes it replaces:
    # reconfig_length == reconfig_msv_length + reconfig_rest_length
    om.reconfig_unihit(saveL)


# ---------------------------------------------------------------------
# Frameshift (5-codon) stochastic trace + region ensemble
# (ref: impl_sse/stotrace_fs.c p7_StochasticTrace_Frameshift :72,
#  p7_domaindef.c region_trace_ensemble_frameshift :~460)
# ---------------------------------------------------------------------
def stochastic_trace_fs5(r: Randomness, dsq: np.ndarray, om_fs,
                         fx) -> Trace:
    """Sample one path from the full 5-codon frameshift Forward
    matrix (ops/reference/fwdback_fs.FSMatrix).  M steps carry their
    sampled codon length in tr.c."""
    from .ops.reference import fwdback_fs as ffs

    from .native import fs5_stotrace_native
    ntr = fs5_stotrace_native(r, om_fs, fx)
    if ntr is not None:
        return ntr

    L, M = fx.L, fx.M
    xf = om_fs.xf
    tBM, tMM, tIM, tDM, tMD, tDD, tMI, tII = ffs._trans_views_fs(om_fs)
    mc, im, dm = fx.mc, fx.im, fx.dm
    scale = fx.scale
    cloop = float(xf[C.X_C, C.LOOP])
    jloop = float(xf[C.X_J, C.LOOP])
    nloop = float(xf[C.X_N, C.LOOP])
    tr = Trace()
    tr.append(C.T_T, 0, 0)

    def choose(weights):
        tot = float(sum(weights))
        if tot <= 0:
            return 0
        roll = r.random() * tot
        s = 0.0
        for a, w in enumerate(weights):
            s += w
            if roll < s:
                return a
        return len(weights) - 1

    # terminal row selection (score logsums C at L, L-1, L-2)
    wL = float(fx.xC[L])
    wL1 = float(fx.xC[L - 1]) * cloop / float(scale[L]) if L >= 1 else 0
    wL2 = float(fx.xC[L - 2]) * cloop / (float(scale[L])
                                         * float(scale[L - 1])) \
        if L >= 2 else 0
    i = (L, L - 1, L - 2)[choose((wL, wL1, wL2))]
    tr.append(C.T_C, 0, i)
    k = 0
    st = C.T_C
    while st != C.T_S:
        if st == C.T_C:
            if i >= 3:
                adj = float(scale[i]) * float(scale[i - 1]) \
                    * float(scale[i - 2])
                w_loop = float(fx.xC[i - 3]) * cloop / adj
            else:
                w_loop = 0.0
            w_move = float(fx.xE[i]) * float(xf[C.X_E, C.MOVE])
            nxt = (C.T_C, C.T_E)[choose((w_loop, w_move))]
            if nxt == C.T_C:
                i -= 3
        elif st == C.T_E:
            wts = np.concatenate([mc[0][i][1:], dm[i][1:]])
            sel = choose(wts)
            if sel < M:
                k = sel + 1
                c = 1 + choose([float(mc[cc][i][k])
                                for cc in range(1, 6)])
                nxt = C.T_M
            else:
                nxt, k, c = C.T_D, sel - M + 1, 0
        elif st == C.T_M:
            # predecessors live at row i-c (entry term of the codon)
            ip = i - c
            w = (float(fx.xB[ip]) * float(tBM[k]),
                 float(mc[0][ip][k - 1]) * float(tMM[k]),
                 float(im[ip][k - 1]) * float(tIM[k]),
                 float(dm[ip][k - 1]) * float(tDM[k]))
            nxt = (C.T_B, C.T_M, C.T_I, C.T_D)[choose(w)]
            i = ip
            k -= 1
            if nxt == C.T_M:
                c = 1 + choose([float(mc[cc][i][k])
                                for cc in range(1, 6)])
        elif st == C.T_D:
            w = (float(mc[0][i][k - 1]) * float(tMD[k]),
                 float(dm[i][k - 1]) * float(tDD[k]))
            nxt = (C.T_M, C.T_D)[choose(w)]
            k -= 1
            if nxt == C.T_M:
                c = 1 + choose([float(mc[cc][i][k])
                                for cc in range(1, 6)])
        elif st == C.T_I:
            w = (float(mc[0][i - 3][k]) * float(tMI[k]),
                 float(im[i - 3][k]) * float(tII[k]))
            nxt = (C.T_M, C.T_I)[choose(w)]
            i -= 3
            if nxt == C.T_M:
                c = 1 + choose([float(mc[cc][i][k])
                                for cc in range(1, 6)])
        elif st == C.T_B:
            w_n = float(fx.xN[i]) * float(xf[C.X_N, C.MOVE])
            w_j = float(fx.xJ[i]) * float(xf[C.X_J, C.MOVE])
            nxt = (C.T_N, C.T_J)[choose((w_n, w_j))]
        elif st == C.T_J:
            if i >= 3:
                adj = float(scale[i]) * float(scale[i - 1]) \
                    * float(scale[i - 2])
                w_loop = float(fx.xJ[i - 3]) * jloop / adj
            else:
                w_loop = 0.0
            w_move = float(fx.xE[i]) * float(xf[C.X_E, C.LOOP])
            nxt = (C.T_J, C.T_E)[choose((w_loop, w_move))]
            if nxt == C.T_J:
                i -= 3
        elif st == C.T_N:
            nxt = C.T_S if i <= 2 else C.T_N
            if nxt == C.T_N:
                i -= 3
        else:
            raise RuntimeError("bogus state in fs stochastic trace")
        if nxt == C.T_M:
            tr.append(nxt, k, i, c=c)
        elif nxt == C.T_I:
            tr.append(nxt, k, i, c=3)
        elif nxt == C.T_D:
            tr.append(nxt, k, 0)
        else:
            tr.append(nxt, 0, 0 if nxt == C.T_S else i)
        st = nxt
    tr.reverse()
    tr.M, tr.L = M, L
    return tr


def region_trace_ensemble_fs(ddef, om_fs5, windowsq, ireg: int,
                             jreg: int, saveL: int):
    """Frameshift-branch multidomain resolution: full fs5 Forward on
    the region, sampled fs traces, fs-rule clustering (diagonals in
    amino units), domination filtering
    (ref: region_trace_ensemble_frameshift)."""
    from .ops.reference import fwdback_fs as ffs

    r = Randomness(ddef.seed)
    om_fs5.reconfig_multihit(saveL)
    try:
        sub = windowsq.dsq[ireg - 1:jreg]
        # non-fast: the native sequential-closure fill (bit-equal to
        # the numpy loop); the matmul-closure 'fast' variant differs
        # in float summation order, and sampling must see the same
        # matrix on every backend
        fx, _ = ffs.forward_fs5(sub, om_fs5)
    except ffs.RangeError:
        om_fs5.reconfig_unihit(saveL)
        return None
    samples = []
    from .native import fs5_stotrace_domains_native, fs5_stotrace_prep
    prep = None
    try:
        prep = fs5_stotrace_prep(om_fs5, fx)
    except Exception:
        prep = None
    for t in range(ddef.nsamples):
        doms = (fs5_stotrace_domains_native(r, om_fs5, fx, prep)
                if prep is not None else None)
        if doms is None:
            # python path (identical stream + Trace.index semantics)
            tr = stochastic_trace_fs5(r, sub, om_fs5, fx)
            tr.index()
            doms = list(zip(tr.sqfrom, tr.sqto, tr.hmmfrom, tr.hmmto))
        for sqf, sqt, hmf, hmt in doms:
            samples.append((t, sqf + ireg - 1, sqt + ireg - 1,
                            hmf, hmt))
    sigc = cluster_segments(samples, ddef.nsamples, ddef.min_overlap,
                            ddef.of_smaller, ddef.max_diagdiff,
                            ddef.min_posterior, ddef.min_endpointp,
                            fs=True)
    envs = _undominated_envs(sigc)
    om_fs5.reconfig_unihit(saveL)
    return envs if envs else None
