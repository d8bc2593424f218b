"""The frameshift branch of the BATH pipeline.

Re-provides p7_pli_Frameshift and its helpers
(ref: src/p7_pipeline.c :1338, p7_pli_BuildDNAWindows
:461, p7_pli_postDomainDef_Frameshift_BATH :1004) plus the frameshift
domain definition (ref: p7_domaindef.c
p7_domaindef_ByPosteriorHeuristics_Frameshift_BATH :300,
rescore_isolated_domain_frameshift :992) and the frameshift alignment
display (ref: p7_alidisplay.c p7_alidisplay_fs_Create :538).
"""

from __future__ import annotations

import math

import numpy as np

from . import constants as C
from . import stats
from .alidisplay import AliDisplay, encode_postprob
from .alphabet import amino, dna
from .domaindef import Domain, compute_ali_scores_bath
from .logsum import flogsum
from .ops.reference import fwdback_fs as ffs
from .ops.reference.fwdback import RangeError, Trace
from .pipeline import compute_local_compo
from .sequence import Sequence

F32 = np.float32


# ---------------------------------------------------------------------
# DNA window building (ref: p7_pli_BuildDNAWindows :461)
# ---------------------------------------------------------------------
def build_dna_windows(pli, orfs, dnasq, om, data, P_orf, hit_windows,
                      complementarity, pct_overlap=0.0, bounds=None):
    """<bounds>: optional (lo, hi) window-coordinate clamp replacing
    the default (1, dnasq.n) — the multi-query drive passes the
    query's SERIAL window extent (its own max_length*3 overlap, ref
    bathsearch.c:1099) so fs windows clamp exactly where the serial
    per-query stream would."""
    lo, hi = bounds if bounds is not None else (1, dnasq.n)
    windows = []
    # one pass over hit_windows, best per ORF id (same strict-'>'
    # score tie-break, longer-window-on-equal-score, as the per-ORF
    # scan it replaces — that scan was O(orfs x windows) and a
    # visible cost at database scale)
    best_by_id: dict = {}
    for w_i, w in enumerate(hit_windows):
        b = best_by_id.get(w.id, -1)
        if b < 0:
            if w.score > float("-inf"):
                best_by_id[w.id] = w_i
        else:
            bw = hit_windows[b]
            if w.score > bw.score or (w.score == bw.score
                                      and w.length > bw.length):
                best_by_id[w.id] = w_i
    P_arr = np.asarray(P_orf, np.float64)
    for f in np.nonzero(~(P_arr > pli.F4))[0]:
        f = int(f)
        orf = orfs[f]
        best_idx = best_by_id.get(f, -1)
        if best_idx >= 0:
            cw_n = hit_windows[best_idx].n
            cw_k = hit_windows[best_idx].k
            cw_len = hit_windows[best_idx].length
        else:
            if orf.n >= om.M:
                cw_n = (orf.n - om.M) // 2 + 1
                cw_k = om.M
                cw_len = om.M
            else:
                cw_n = 1
                cw_k = om.M - (om.M - orf.n) // 2
                cw_len = orf.n
        ws = cw_n - int(om.max_length
                        * (0.1 + data.prefix_lengths[cw_k - cw_len + 1])) + 1
        we = cw_n + cw_len + int(om.max_length
                                 * (0.1 + data.suffix_lengths[cw_k])) - 2
        # NOTE (ref p7_pipeline.c:521-522): ESL_MIN(0, start) clamps the
        # start to <=0 (the reference's comment says "at least the
        # beginning of the ORF"); replicate the code, not the comment.
        ws = min(0, ws)
        we = max(orf.n, we)
        if complementarity:
            ws_dna = max(lo, (dnasq.n - orf.start + 1) + ws * 3)
            we_dna = min(hi, (dnasq.n - orf.start + 1) + we * 3)
        else:
            ws_dna = max(lo, orf.start + ws * 3)
            we_dna = min(hi, orf.start + we * 3)
        windows.append([ws_dna, we_dna - ws_dna + 1])
        orf.idx = len(windows) - 1

    if not windows:
        return []
    windows.sort(key=lambda w: w[0])
    merged = [windows[0]]
    for w in windows[1:]:
        prev = merged[-1]
        ov_s = max(prev[0], w[0])
        ov_e = min(prev[0] + prev[1] - 1, w[0] + w[1] - 1)
        ov_len = ov_e - ov_s + 1
        ws = min(prev[0], w[0])
        we = max(prev[0] + prev[1] - 1, w[0] + w[1] - 1)
        wl = we - ws + 1
        if (ov_len / min(prev[1], w[1]) > pct_overlap
                and wl < 2 * om.max_length * 3):
            prev[0] = ws
            prev[1] = wl
        else:
            merged.append(w)
    return merged


# ---------------------------------------------------------------------
# FS alignment display (ref: p7_alidisplay_fs_Create :538)
# ---------------------------------------------------------------------
def _get_codon_index5(nts):
    """ref: p7_alidisplay.c get_codon_index :32 (5-codon system)."""
    c = len(nts)
    if any(n >= C.MAXNUC for n in nts):
        return {1: C.DEGEN5_QC2, 2: C.DEGEN5_QC1, 3: C.DEGEN5_C,
                4: C.DEGEN5_QC1, 5: C.DEGEN5_QC2}[c]
    if c == 1:
        return C.codon1_fs5(nts[0])
    if c == 2:
        return C.codon2_fs5(nts[0], nts[1])
    if c == 3:
        return C.codon3_fs5(nts[0], nts[1], nts[2])
    if c == 4:
        return C.codon4_fs5(nts[0], nts[1], nts[2], nts[3])
    return C.codon5_fs5(nts[0], nts[1], nts[2], nts[3], nts[4])


def _codon_cell(c, indel, nts, sym):
    """5-char display cell for a 1-5 nt codon with indel annotation
    (ref: p7_alidisplay.c nuc_one..nuc_five :91-185)."""
    n = [sym[x] for x in nts]

    def lc(ch):
        return ch.lower()

    c1 = n[0] if len(n) > 0 else "?"
    c2 = n[1] if len(n) > 1 else "?"
    c3 = n[2] if len(n) > 2 else "?"
    c4 = n[3] if len(n) > 3 else "?"
    c5 = n[4] if len(n) > 4 else "?"
    # position 1
    if c < 4:
        p1 = " "
    elif indel in (C.I_xXXX, C.I_xxXXX, C.I_xxx):
        p1 = lc(c1)
    else:
        p1 = c1
    # position 2
    if c < 4:
        if indel in (C.I___X, C.I__XX):
            p2 = "-"
        elif indel in (C.I_xXX, C.I_xxx):
            p2 = lc(c1)
        else:
            p2 = c1
    elif indel in (C.I_XXxX, C.I_xXXX, C.I_XXxxX):
        p2 = c2
    else:
        p2 = lc(c2)
    # position 3
    if c == 1 or indel == C.I_X_X:
        p3 = "-"
    elif indel == C.I__XX:
        p3 = c1
    elif c < 4:
        if indel in (C.I_XxX, C.I_xxx):
            p3 = lc(c2)
        else:
            p3 = c2
    elif indel in (C.I_XxXX, C.I_xXXX, C.I_xxXXX):
        p3 = c3
    else:
        p3 = lc(c3)
    # position 4
    if indel == C.I___X:
        p4 = c1
    elif indel in (C.I_X_X, C.I__XX):
        p4 = c2
    elif c < 3:
        p4 = "-"
    elif c == 3:
        if indel in (C.I_XXx, C.I_xxx):
            p4 = lc(c3)
        else:
            p4 = c3
    elif indel in (C.I_XXxxX, C.I_xxx):
        p4 = lc(c4)
    else:
        p4 = c4
    # position 5
    if c < 5:
        p5 = " "
    elif indel == C.I_xxx:
        p5 = lc(c5)
    else:
        p5 = c5
    return p1 + p2 + p3 + p4 + p5


def fs_create(tr: Trace, which: int, gm_fs5, sq: Sequence,
              show_cigar: bool = False) -> AliDisplay | None:
    """FS alignment display (ref: p7_alidisplay_fs_Create :538).
    <gm_fs5> may be an FSProfile or FSOProfile carrying codons/indel_pos
    and log-space amino scores."""
    abc_a, abc_d = amino(), dna()
    if tr.ndom == 0:
        raise ValueError("trace must be indexed")
    z1 = tr.tfrom[which]
    while z1 < tr.N and tr.st[z1] != C.T_M:
        z1 += 1
    if z1 == tr.N:
        return None
    z2 = tr.tto[which]
    while z2 >= 0 and tr.st[z2] != C.T_M:
        z2 -= 1
    if z2 < 0:
        return None

    ad = AliDisplay()
    ad.hmmname = gm_fs5.name
    ad.hmmacc = gm_fs5.acc or ""
    ad.hmmdesc = gm_fs5.desc or ""
    ad.sqname, ad.sqacc, ad.sqdesc = sq.name, sq.acc or "", sq.desc or ""
    ad.hmmfrom, ad.hmmto, ad.M = tr.k[z1], tr.k[z2], gm_fs5.M
    if sq.start < sq.end:
        ad.sqfrom = tr.i[z1] - (tr.c[z1] - 1)
        ad.sqto = tr.i[z2]
    else:
        ad.sqto = tr.i[z1]
        ad.sqfrom = tr.i[z2]
    ad.L = sq.L

    consensus = gm_fs5.consensus
    codons_tbl = gm_fs5.codons
    indel_tbl = gm_fs5.indel_pos
    if hasattr(gm_fs5, "rsc_amino") and gm_fs5.rsc_amino is not None:
        amino_sc = gm_fs5.rsc_amino       # log space
    else:
        amino_sc = gm_fs5.rsc_fs[gm_fs5.maxcodons:, :]
    # per-profile caches: the "+" mask (exp>1 in f32 — NOT the same as
    # sc>0 near the rounding boundary) and the consensus digit map
    cache = gm_fs5.__dict__.get("_fs_create_cache")
    if cache is None or cache[0] is not amino_sc:
        with np.errstate(over="ignore"):
            amino_pos = np.exp(amino_sc) > 1.0
        cons_dig = np.array([abc_a.inmap.get(ch, -1)
                             for ch in gm_fs5.consensus], np.int32)
        cache = (amino_sc, amino_pos, cons_dig)
        gm_fs5.__dict__["_fs_create_cache"] = cache
    _, amino_pos, cons_dig = cache

    model, mline, aseq, ntseq, ppl, codon = [], [], [], [], [], []
    exact = 0
    dsq = sq.dsq
    for z in range(z1, z2 + 1):
        k, i, s, c = tr.k[z], tr.i[z], tr.st[z], tr.c[z]
        ppl.append("." if s == C.T_D else encode_postprob(tr.pp[z]))
        if s == C.T_M:
            model.append(consensus[k - 1])
            nts = [int(dsq[i - c + d]) for d in range(c)]
            ci = _get_codon_index5(nts)
            aa = int(codons_tbl[ci, k])
            indel = int(indel_tbl[ci, k])
            ntseq.append(_codon_cell(c, indel, nts, abc_d.sym))
            if aa == cons_dig[k - 1]:
                mline.append(consensus[k - 1])
                exact += 1
            elif amino_pos[aa, k]:
                mline.append("+")
            else:
                mline.append(" ")
            aseq.append(abc_a.sym[aa].upper())
            cl = c
            if c != 3:
                ad.frameshifts += 1
            elif indel in (C.I_XXx, C.I_XxX, C.I_xXX):
                cl = 6
                ad.stops += 1
            codon.append(cl)
        elif s == C.T_I:
            nts = [int(dsq[i - 3 + d]) for d in range(3)]
            ci = _get_codon_index5(nts)
            indel = int(indel_tbl[ci, k])
            if indel in (C.I_XXx, C.I_XxX, C.I_xXX):
                codon.append(6)
                ad.stops += 1
                aa = 27
            else:
                codon.append(3)
                aa = int(codons_tbl[ci, k])
            model.append(".")
            mline.append(" ")
            aseq.append(abc_a.sym[aa].lower())
            ntseq.append(" %c%c%c " % tuple(abc_d.sym[x] for x in nts))
        elif s == C.T_D:
            codon.append(0)
            model.append(consensus[k - 1])
            mline.append(" ")
            aseq.append("-")
            ntseq.append(" --- ")
        else:
            raise ValueError("invalid state in FS alidisplay trace")

    ad.model = "".join(model)
    ad.mline = "".join(mline)
    ad.aseq = "".join(aseq)
    ad.ntseq = "".join(ntseq)
    ad.ppline = "".join(ppl)
    ad.codon = codon
    ad.N = z2 - z1 + 1
    ad.pid = (exact / ad.N) * 100 if ad.N else 0.0
    if show_cigar:
        ad.cigar = _fs_cigar(tr, z1, z2, gm_fs5, dsq)
    return ad


def _fs_cigar(tr: Trace, z1: int, z2: int, gm_fs5, dsq) -> str:
    """Frameshift-aware CIGAR with B (backward/delete-nt) and F
    (forward/insert-nt) ops (ref: p7_alidisplay_fs_Create cigar
    blocks :778-820)."""
    parts = []
    n_count = 0
    indel_tbl = gm_fs5.indel_pos
    for z in range(z1, z2 + 1):
        s = tr.st[z]
        nxt = tr.st[z + 1] if z < z2 else -1
        if s == C.T_M:
            c = tr.c[z]
            i = tr.i[z]
            nts = [int(dsq[i - c + d]) for d in range(c)]
            ci = _get_codon_index5(nts)
            indel = int(indel_tbl[ci, tr.k[z]])
            if nxt != C.T_M or c != 3:
                if c == 3:
                    n_count += 3
                elif indel in (C.I_XX_, C.I_XXxX, C.I_XXxxX):
                    n_count += 2
                elif indel in (C.I_X_X, C.I_X__, C.I_XxXX, C.I_XxxXX):
                    n_count += 1
                parts.append("%dM" % n_count)
                n_count = 0
                if c == 1:
                    parts.append("2B")
                elif c == 2:
                    parts.append("1B")
                elif c == 4:
                    parts.append("1F")
                elif c == 5:
                    parts.append("2F")
                if indel in (C.I___X, C.I_X_X, C.I_XXxX, C.I_XXxxX):
                    n_count = 1
                elif indel in (C.I__XX, C.I_XxXX, C.I_XxxXX):
                    n_count = 2
                elif indel in (C.I_xXXX, C.I_xxXXX):
                    n_count = 3
                if nxt != C.T_M and n_count > 0:
                    parts.append("%dM" % n_count)
                    n_count = 0
            else:
                n_count += 3
        elif s == C.T_I:
            n_count += 3
            if nxt != C.T_I:
                parts.append("%dI" % n_count)
                n_count = 0
        elif s == C.T_D:
            n_count += 3
            if nxt != C.T_D:
                parts.append("%dD" % n_count)
                n_count = 0
    return "".join(parts)


# ---------------------------------------------------------------------
# FS domain definition (ref: p7_domaindef.c :300)
# ---------------------------------------------------------------------
def is_multidomain_region_fs(ddef, i, j):
    """ref: p7_domaindef.c is_multidomain_region_frameshift :675."""
    etot, btot = ddef.etot, ddef.btot
    mx = -1.0
    f = (j - i + 1) % 3
    for z in range(i + 2, j - f + 1, 3):
        mx = max(mx, min(float(etot[z] - etot[i - 1]),
                         float(btot[j - f] - btot[z - 3])))
    f = (j - i) % 3
    for z in range(i + 3, j - f + 1, 3):
        mx = max(mx, min(float(etot[z] - etot[i]),
                         float(btot[j - f] - btot[z - 3])))
    f = (j - i - 1) % 3
    for z in range(i + 4, j - f + 1, 3):
        mx = max(mx, min(float(etot[z] - etot[i + 1]),
                         float(btot[j - f] - btot[z - 3])))
    return mx >= ddef.rt3


def rescore_isolated_domain_fs(ddef, pli, om_fs5, gm_fs5, windowsq,
                               i, j, bg, gcode) -> bool:
    """ref: p7_domaindef.c rescore_isolated_domain_frameshift :992."""
    from .phasestats import phase
    with phase("envelope-fs5"):
        return _rescore_isolated_domain_fs(
            ddef, pli, om_fs5, gm_fs5, windowsq, i, j, bg, gcode)


def _rescore_isolated_domain_fs(ddef, pli, om_fs5, gm_fs5, windowsq,
                                i, j, bg, gcode) -> bool:
    Ld = j - i + 1
    if Ld < 15:
        return True
    bg.set_length(Ld // 3)
    nullsc = bg.fs_null_one(Ld // 3)
    om_fs5.reconfig_length(Ld // 3)
    sub = windowsq.dsq[i - 1:j]
    try:
        fx, envsc = ffs.forward_fs5(sub, om_fs5)
    except RangeError:
        return True
    seqscore = (envsc - nullsc) / C.CONST_LOG2
    P = float(stats.exp_surv(seqscore, om_fs5.evparam[C.EV_FTAUFS5],
                             om_fs5.evparam[C.EV_FLAMBDA]))
    pli.Z = float(pli.nres) / float(gm_fs5.max_length)
    if pli.inc_by_E and P * pli.Z > pli.E:
        return True
    try:
        bx, _ = ffs.backward_fs5(sub, om_fs5, fx)
    except RangeError:
        # backward underflow: the reference returns eslOK here (the
        # domain is skipped but counted; ref p7_domaindef.c:1041)
        return True
    try:
        pp = ffs.decoding_fs(om_fs5, fx, bx)
    except RangeError:
        # decoding overflow: eslFAIL — "repetitive garbage" (:1046)
        return False
    ox, oasc = ffs.optimal_accuracy_fs(om_fs5, pp)
    tr = ffs.oa_trace_fs(om_fs5, pp, ox)
    for z in range(tr.N):
        if tr.i[z] >= 0:
            tr.i[z] += i - 1
    tr.index()

    dom = Domain()
    compute_ali_scores_bath(dom, tr, windowsq, gm_fs5)
    if dom.aliscore < 0.0:
        return False

    # null2 scores per residue from the trace (ref :1087-1143)
    null2 = ffs.null2_fs_by_expectation(om_fs5, pp)
    from .ops.reference.fwdback import finish_null2
    null2 = finish_null2(null2, amino())
    nuc = windowsq.dsq
    n2sc = ddef.n2sc
    z = 0
    pos = i
    st, ii_, cc_, kk_ = tr.st, tr.i, tr.c, tr.k
    hist = [C.MAXCODONS5] * 4   # t,u,v,w rolling window

    def codon_index_of(c, x, hist):
        w, v, u, t = hist[3], hist[2], hist[1], hist[0]
        if c == 1:
            return min(C.codon1_fs5(x), C.DEGEN5_QC2)
        if c == 2:
            return min(C.codon2_fs5(w, x), C.DEGEN5_QC1)
        if c == 3:
            return min(C.codon3_fs5(v, w, x), C.DEGEN5_C)
        if c == 4:
            return min(C.codon4_fs5(u, v, w, x), C.DEGEN5_QC1)
        return min(C.codon5_fs5(t, u, v, w, x), C.DEGEN5_QC2)

    N = tr.N
    while pos <= j and z < N:
        x = int(nuc[pos - 1]) if nuc[pos - 1] < C.MAXNUC else C.MAXCODONS5
        s = st[z]
        if s in (C.T_N, C.T_C, C.T_J):
            n2sc[pos] = 0.0
            if ii_[z] == pos and pos > i + 1:
                pos += 1
                hist = hist[1:] + [x]
                continue
            z += 1
            continue
        elif s in (C.T_X, C.T_S, C.T_B, C.T_E, C.T_T, C.T_D):
            z += 1
            continue
        elif s == C.T_M:
            if ii_[z] == pos:
                ci = codon_index_of(cc_[z], x, hist)
                v = float(np.log(null2[int(gm_fs5.codons[ci, kk_[z]])])) \
                    if null2[int(gm_fs5.codons[ci, kk_[z]])] > 0 else -np.inf
                n2sc[pos] = 0.0 if np.isinf(v) else v
                z += 1
            else:
                n2sc[pos] = 0.0
            pos += 1
        elif s == C.T_I:
            if ii_[z] == pos:
                w, v_, u = hist[3], hist[2], hist[1]
                ci = min(C.codon3_fs5(v_, w, x), C.DEGEN5_C)
                vv = null2[int(gm_fs5.codons[ci, kk_[z]])]
                lv = float(np.log(vv)) if vv > 0 else 0.0
                n2sc[pos] = lv
                z += 1
            else:
                n2sc[pos] = 0.0
            pos += 1
        hist = hist[1:] + [x]

    from .native import f32_seq_sum
    domcorrection = f32_seq_sum(n2sc[i:j + 1])
    dom.domcorrection = max(0.0, domcorrection)

    z1 = 0
    while z1 < tr.N and st[z1] != C.T_M:
        z1 += 1
    z2 = tr.N - 1
    while z2 >= 0 and st[z2] != C.T_M:
        z2 -= 1
    if windowsq.start < windowsq.end:
        dom.iali = tr.i[z1] - (tr.c[z1] - 1)
        dom.jali = tr.i[z2]
        dom.ienv, dom.jenv = i, j
    else:
        dom.iali = tr.i[z2] - (tr.c[z1] - 1)
        dom.jali = tr.i[z1]
        dom.ienv, dom.jenv = j, i
    dom.ihmm, dom.jhmm = tr.k[z1], tr.k[z2]
    dom.envsc = envsc
    dom.oasc = oasc
    dom.tr = tr
    dom.scores_per_pos = None
    dom.k_per_pos = None
    ddef.dcl.append(dom)
    ddef.ndom += 1
    return True


def fs_domdec_margin(wlen: int) -> float:
    """Safety margin (posterior-probability units) for device fs3
    domain-decoding trigger decisions.  Measured device-vs-host error
    on the compared quantities grows ~7e-7*L up to 13 kb windows
    (tests/test_jax_kernels.py pins it); this gives >=4x headroom."""
    return 8e-3 + 2e-6 * wlen


def region_scan_margin_fs(btot, etot, mocc, n: int, ddef,
                          eps: float) -> None:
    """Dry-run the 3-frame region-detection automaton of
    by_posterior_heuristics_fs on (btot, etot, mocc) and raise
    PosteriorMargin if ANY comparison it makes (the rt1 trigger, the
    rt2 start/end backtracks, is_multidomain_region_fs's rt3) is
    within <eps> of its threshold.  If every margin clears, a run
    with values perturbed by < eps makes identical decisions at every
    step, so host and device posteriors yield the same
    regions/envelopes by induction (mirror of
    domaindef.region_scan_margin for the fs automaton)."""
    from .domaindef import PosteriorMargin
    rt1, rt2, rt3 = ddef.rt1, ddef.rt2, ddef.rt3

    def near(v, t, what, at):
        if abs(float(v) - t) < eps:
            raise PosteriorMargin(f"{what} at {at}")

    def bcond(d):
        v = mocc[d] - (btot[d] - btot[d - 3])
        near(v, rt2, "rt2/b", d)
        return v < rt2

    def econd(d):
        v = mocc[d] - (etot[d] - etot[d - 3])
        near(v, rt2, "rt2/e", d)
        return v < rt2

    i = -1
    triggered = start = end = False
    j = 1
    L = n
    d = 0
    while j < L:
        if not triggered:
            near(mocc[j], rt1, "rt1", j)
            if mocc[j] >= rt1:
                triggered = True
            d = j
        else:
            while d > 1 and not start:
                d -= 1
                if d > 3 and bcond(d):
                    d -= 1
                    if d > 3 and bcond(d):
                        d -= 1
                        if d > 3 and bcond(d):
                            d -= 1
                            start = True
            i = max(1, d - 3)
            d = j + 1
            while d < L and not end:
                d += 1
                if d < L and econd(d):
                    d += 1
                    if d < L and econd(d):
                        d += 1
                        if d < L and econd(d):
                            d += 1
                            end = True
            j = min(L, d + 3)
            if j - i + 1 < 12:
                i = -1
                triggered = start = end = False
                j += 1
                continue
            # is_multidomain_region_fs's rt3 decision, with margin
            mx = -1.0
            f = (j - i + 1) % 3
            for z in range(i + 2, j - f + 1, 3):
                mx = max(mx, min(float(etot[z] - etot[i - 1]),
                                 float(btot[j - f] - btot[z - 3])))
            f = (j - i) % 3
            for z in range(i + 3, j - f + 1, 3):
                mx = max(mx, min(float(etot[z] - etot[i]),
                                 float(btot[j - f] - btot[z - 3])))
            f = (j - i - 1) % 3
            for z in range(i + 4, j - f + 1, 3):
                mx = max(mx, min(float(etot[z] - etot[i + 1]),
                                 float(btot[j - f] - btot[z - 3])))
            near(mx, rt3, "rt3", f"{i}..{j}")
            i = -1
            triggered = start = end = False
        j += 1


def by_posterior_heuristics_fs(pli, windowsq, om_fs5, gm_fs5, bg, gcode,
                               oxf, oxb, ensemble_fn=None,
                               posteriors=None,
                               margin_eps: float = 0.0):
    """ref: p7_domaindef_ByPosteriorHeuristics_Frameshift_BATH :300.

    <posteriors>: optional precomputed (btot, etot, mocc) — the device
    fs3 fused domdec kernel's output — used instead of the host
    p7_DomainDecoding_Frameshift (oxf/oxb may then be None).  With
    <margin_eps> > 0, PosteriorMargin is raised BEFORE any side
    effects if a trigger decision is within eps of its threshold."""
    ddef = pli.ddef
    n = windowsq.n
    saveL = gm_fs5.L
    save_multi = gm_fs5.nj > 0
    if posteriors is not None:
        btot, etot, mocc = posteriors
        if margin_eps > 0.0:
            region_scan_margin_fs(btot, etot, mocc, n, ddef,
                                  margin_eps)
    else:
        btot, etot, mocc = ffs.domain_decoding_fs(om_fs5, oxf, oxb)
    ddef.btot, ddef.etot, ddef.mocc = btot, etot, mocc
    ddef.n2sc = np.zeros(n + 1, dtype=F32)
    ddef.nexpected = float(btot[n])
    gm_fs5.reconfig_unihit(saveL // 3)
    om_fs5.reconfig_unihit(saveL // 3)

    i = -1
    triggered = start = end = False
    j = 1
    L = n if oxf is None else oxf.L
    while j < L:
        if not triggered:
            if mocc[j] >= ddef.rt1:
                triggered = True
            d = j
        else:
            # start must drop in all three frames (ref :343-360)
            while d > 1 and not start:
                d -= 1
                if d > 3 and mocc[d] - (btot[d] - btot[d - 3]) < ddef.rt2:
                    d -= 1
                    if d > 3 and mocc[d] - (btot[d] - btot[d - 3]) < ddef.rt2:
                        d -= 1
                        if d > 3 and mocc[d] - (btot[d] - btot[d - 3]) < ddef.rt2:
                            d -= 1
                            start = True
            i = max(1, d - 3)
            d = j + 1
            while d < L and not end:
                d += 1
                if d < L and mocc[d] - (etot[d] - etot[d - 3]) < ddef.rt2:
                    d += 1
                    if d < L and mocc[d] - (etot[d] - etot[d - 3]) < ddef.rt2:
                        d += 1
                        if d < L and mocc[d] - (etot[d] - etot[d - 3]) < ddef.rt2:
                            d += 1
                            end = True
            j = min(L, d + 3)
            if j - i + 1 < 12:
                i = -1
                triggered = start = end = False
                j += 1
                continue
            ddef.nregions += 1
            if is_multidomain_region_fs(ddef, i, j):
                ddef.nclustered += 1
                envs = None
                if ensemble_fn is not None:
                    envs = ensemble_fn(ddef, om_fs5, windowsq, i, j, saveL)
                if envs is None:
                    envs = [(i, j)]
                last_j2 = 0
                for (i2, j2) in envs:
                    if i2 <= last_j2:
                        ddef.noverlaps += 1
                    i2 = max(1, i2)
                    ddef.nenvelopes += 2
                    if rescore_isolated_domain_fs(ddef, pli, om_fs5,
                                                  gm_fs5, windowsq, i2, j2,
                                                  bg, gcode):
                        last_j2 = j2
            else:
                ddef.nenvelopes += 1
                rescore_isolated_domain_fs(ddef, pli, om_fs5, gm_fs5,
                                           windowsq, i, j, bg, gcode)
            i = -1
            triggered = start = end = False
        j += 1

    if save_multi:
        gm_fs5.reconfig_multihit(saveL // 3)
        om_fs5.reconfig_multihit(saveL // 3)
    else:
        gm_fs5.reconfig_unihit(saveL // 3)
        om_fs5.reconfig_unihit(saveL // 3)


def _postdomaindef_fs(pli, gm_fs5, om_fs5, bg, hitlist, seqidx,
                      window_start, dnasq, windowsq, complementarity):
    """ref: p7_pli_postDomainDef_Frameshift_BATH :1004."""
    ddef = pli.ddef
    for dom in ddef.dcl:
        ali_len = dom.jali - dom.iali + 1
        if ali_len < 12:
            continue
        tmp_i = dom.ienv
        env_len = dom.jenv - dom.ienv + 1
        if not complementarity:
            dom.ienv = dnasq.start + window_start + dom.ienv - 2
            dom.jenv = dnasq.start + window_start + dom.jenv - 2
            dom.iali = dnasq.start + window_start + dom.iali - 2
            dom.jali = dnasq.start + window_start + dom.jali - 2
        else:
            dom.ienv = dnasq.start - (window_start + dom.ienv) + 2
            dom.jenv = dnasq.start - (window_start + dom.jenv) + 2
            dom.iali = dnasq.start - (window_start + dom.iali) + 2
            dom.jali = dnasq.start - (window_start + dom.jali) + 2

        bitscore = dom.envsc
        bitscore -= 2 * math.log(2.0 / ((env_len / 3.0) + 2))
        bitscore += 2 * math.log(2.0 / (gm_fs5.max_length + 2))
        bitscore -= ((env_len - ali_len) / 3.0) * math.log(
            (env_len / 3.0) / ((env_len / 3.0) + 2))
        bitscore += ((max(env_len, gm_fs5.max_length * 3) - ali_len) / 3.0) \
            * math.log(float(gm_fs5.max_length)
                       / float(gm_fs5.max_length + 2))

        if pli.do_null2:
            dom_bias = float(flogsum(0.0, np.float32(
                math.log(bg.omega) + dom.domcorrection)))
        else:
            dom_bias = 0.0
        bg.set_length(max(env_len // 3, gm_fs5.max_length))
        nullsc = bg.fs_null_one(max(env_len // 3, gm_fs5.max_length))
        dom_score = (bitscore - (nullsc + dom_bias)) / C.CONST_LOG2
        dom_lnP = float(stats.exp_logsurv(
            dom_score, gm_fs5.evparam[C.EV_FTAUFS5],
            gm_fs5.evparam[C.EV_FLAMBDA]))
        pli.Z = float(pli.nres) / float(gm_fs5.max_length)
        keep = (math.exp(dom_lnP) * pli.Z <= pli.E) if pli.inc_by_E \
            else (dom_score >= pli.T)
        if not keep:
            continue

        ad = fs_create(dom.tr, 0, om_fs5, windowsq, pli.show_cigar)
        if ad is None:
            continue
        ad.sqfrom = dom.iali
        ad.sqto = dom.jali
        ad.L = dnasq.L
        dom.ad = ad
        hit = hitlist.create_next_hit()
        hit.ndom = 1
        hit.best_domain = 0
        hit.window_length = gm_fs5.max_length
        hit.target_len = dnasq.n
        hit.seqidx = seqidx
        if not complementarity:
            hit.subseq_start = dom.ienv - tmp_i + 1
        else:
            hit.subseq_start = dom.ienv + tmp_i - 1
        hit.dcl = [dom]
        hit.pre_score = bitscore / C.CONST_LOG2
        hit.pre_lnP = float(stats.exp_logsurv(
            hit.pre_score, gm_fs5.evparam[C.EV_FTAUFS5],
            gm_fs5.evparam[C.EV_FLAMBDA]))
        dom.dombias = dom_bias
        dom.bitscore = dom_score
        dom.lnP = dom_lnP
        hit.sum_score = hit.score = dom_score
        hit.sum_lnP = hit.lnP = dom_lnP
        hit.sortkey = -dom_lnP if pli.inc_by_E else dom_score
        hit.frameshift = True
        hit.name = dnasq.name
        hit.acc = dnasq.acc
        hit.desc = dnasq.desc
    ddef.reuse()


# ---------------------------------------------------------------------
# The frameshift pipeline driver (ref: p7_pli_Frameshift :1338)
# ---------------------------------------------------------------------
class FSWindowCand:
    """One merged DNA window ready for the fs3-Forward gate: the
    prepared inputs + arbitration statistics, so the gate can run as a
    device batch spanning many calls (ref: p7_pli_Frameshift
    :1338-1465)."""
    __slots__ = ("w_idx", "wn", "wlen", "tmpseq", "P_tot", "P_min",
                 "orf_cnt", "nullsc", "filtersc")

    def __init__(self, w_idx, wn, wlen, tmpseq, P_tot, P_min, orf_cnt,
                 nullsc, filtersc):
        self.w_idx = w_idx
        self.wn = wn
        self.wlen = wlen
        self.tmpseq = tmpseq
        self.P_tot = P_tot
        self.P_min = P_min
        self.orf_cnt = orf_cnt
        self.nullsc = nullsc
        self.filtersc = filtersc


def fs_prepare(pli, om, data, bg, orfs, dnasq, gcode, P_orf, fwdsc_arr,
               hit_windows, complementarity,
               widx=None, bounds=None) -> list[FSWindowCand]:
    """Phase 1 of the frameshift branch: DNA window building plus the
    per-window statistics and bias filtering that precede the
    fs3-Forward gate (ref: p7_pli_Frameshift :1338-1463).

    <widx>: optional dict filled with {orf index -> window idx} — the
    per-query side table the multi-query drive uses instead of the
    Orf.idx attribute (ORF lists are shared across queries there, so
    attribute writes from one query would leak into another)."""
    windows = build_dna_windows(pli, orfs, dnasq, om, data, P_orf,
                                hit_windows, complementarity,
                                bounds=bounds)
    cands = []
    # vectorized per-survivor DNA coordinates: the per-window scan
    # over ALL ORFs was O(windows x orfs) python (a visible cost at
    # database scale); the per-ORF bookkeeping below runs only for
    # the ORFs each window actually contains, in the same f order
    nsurv = 0
    if windows:
        P_arr = np.asarray(P_orf, np.float64)
        surv = np.nonzero(~(P_arr > pli.F4))[0]
        nsurv = len(surv)
    if nsurv:
        sts = np.fromiter((orfs[int(f)].start for f in surv),
                          np.int64, nsurv)
        ens = np.fromiter((orfs[int(f)].end for f in surv),
                          np.int64, nsurv)
        if complementarity:
            ostart = dnasq.start - (dnasq.n - ens + 1) + 1
            oend = dnasq.start - (dnasq.n - sts + 1) + 1
        else:
            ostart = dnasq.start + sts - 1
            oend = dnasq.start + ens - 1
    for w_idx, (wn, wlen) in enumerate(windows):
        window_start = (dnasq.start - (wn + wlen)) if complementarity \
            else (dnasq.start + wn - 1)
        window_end = (dnasq.start - wn + 1) if complementarity \
            else (window_start + wlen - 1)
        tmpseq = Sequence(name=dnasq.name, acc=dnasq.acc, desc=dnasq.desc,
                          dsq=dnasq.dsq[wn - 1:wn + wlen - 1],
                          start=wn, end=wn + wlen - 1, L=wlen,
                          abc=dnasq.abc)

        orf_cnt = 0
        tot_orfsc = float("-inf")
        P_min = float("inf")
        k_min, k_max = om.M, 0
        last_window_cnt = 0
        contained = surv[(ostart >= window_start)
                         & (oend <= window_end)] if nsurv else ()
        for f in contained:
            f = int(f)
            orfsq = orfs[f]
            orfsq.idx = w_idx
            if widx is not None:
                widx[f] = w_idx
            P_min = min(P_min, P_orf[f])
            tot_orfsc = float(flogsum(np.float32(tot_orfsc),
                                      np.float32(fwdsc_arr[f])))
            orf_cnt += 1
            h = last_window_cnt
            while h < len(hit_windows) and hit_windows[h].id != f:
                h += 1
            if h < len(hit_windows):
                while h < len(hit_windows) and hit_windows[h].id == f:
                    k_min = min(k_min,
                                hit_windows[h].k - hit_windows[h].length + 1)
                    k_max = max(k_max, hit_windows[h].k)
                    h += 1
                last_window_cnt = h

        P_tot = float(stats.exp_surv(tot_orfsc / C.CONST_LOG2,
                                     om.evparam[C.EV_FTAU],
                                     om.evparam[C.EV_FLAMBDA]))
        bg.set_length(wlen // 3)
        nullsc = bg.fs_null_one(wlen // 3)
        if pli.do_biasfilter:
            filtersc = bg.fs_filter_score(tmpseq.dsq, gcode)
            if k_min <= k_max:
                local_compo = compute_local_compo(data, om, bg, k_min, k_max)
                bg.set_filter(om.M, local_compo)
                bg.set_length(wlen // 3)
                local_filtersc = bg.fs_filter_score(tmpseq.dsq, gcode)
                if local_filtersc > filtersc:
                    filtersc = local_filtersc
                bg.set_filter(om.M, om.compo)
                bg.set_length(wlen // 3)
        else:
            filtersc = nullsc
        if not pli.std_pipe:
            P_tot = 1.0
        cands.append(FSWindowCand(w_idx, wn, wlen, tmpseq, P_tot,
                                  P_min, orf_cnt, nullsc, filtersc))
    return cands


def pli_frameshift(pli, om, gm, om_fs3, om_fs5, gm_fs5, data, bg, hitlist,
                   seqidx, orfs, dnasq, gcode, P_orf, fwdsc_arr, oxf_holder,
                   hit_windows, complementarity, fs3_dev=None):
    """The frameshift pipeline driver (ref: p7_pli_Frameshift :1338):
    window preparation, the fs3-Forward gate, arbitration, and domain
    definition."""
    cands = fs_prepare(pli, om, data, bg, orfs, dnasq, gcode, P_orf,
                       fwdsc_arr, hit_windows, complementarity)
    fs_gate_and_define(pli, om, gm, om_fs3, om_fs5, gm_fs5, bg, hitlist,
                       seqidx, orfs, dnasq, gcode, P_orf, oxf_holder,
                       complementarity, cands, fs3_dev)


def fs_gate_and_define(pli, om, gm, om_fs3, om_fs5, gm_fs5, bg, hitlist,
                       seqidx, orfs, dnasq, gcode, P_orf, oxf_holder,
                       complementarity, cands, fs3_dev=None,
                       fs_domdec_fn=None, widx=None):
    """Phase 2 of the frameshift branch: fs3-Forward gate,
    arbitration, domain definition and hit assembly per prepared DNA
    window (ref: p7_pli_Frameshift :1450-1511).  <fs3_dev>: optional
    per-window device fs3-Forward scores (nats); windows whose device
    P is above F3*DEVICE_GATE_BAND skip the host fs3 parser entirely
    (the exact P can only be within the band, so it also fails the
    gate), the rest are re-scored bit-exactly on the host.

    <fs_domdec_fn(seqs, dec_loop) -> (btot, etot, mocc, ok)>: optional
    batched device fused fs3 Backward-parser + domain-decoding run
    over the fs-branch survivors; survivors then skip the host full
    fs3 Forward + Backward parsers entirely unless flagged or
    margin-tripped (ref: impl_sse/fwdback_fs.c :565,
    decoding_fs.c :242)."""
    from .domaindef import by_posterior_heuristics_bath
    from .ops.reference import fwdback as fb
    from .pipeline import DEVICE_GATE_BAND, _postdomaindef_bath

    # ---- pass 1: the fs3-Forward gate + arbitration per window ----
    # branch[ci]: True = fs branch, False = std branch, None = window
    # skipped (parser over/underflow, ref p7_pipeline.c:1471)
    branch: list = [False] * len(cands)
    for ci, cand in enumerate(cands):
        wlen = cand.wlen
        tmpseq = cand.tmpseq
        nullsc, filtersc = cand.nullsc, cand.filtersc
        P_tot, P_min, orf_cnt = cand.P_tot, cand.P_min, cand.orf_cnt

        om_fs3.reconfig_length(wlen // 3)
        fs_branch = True
        if fs3_dev is not None:
            sc_dev = float(fs3_dev[ci])
            P_dev = float(stats.exp_surv(
                (sc_dev - filtersc) / C.CONST_LOG2,
                om_fs3.evparam[C.EV_FTAUFS3],
                om_fs3.evparam[C.EV_FLAMBDA]))
            if P_dev > pli.F3 * DEVICE_GATE_BAND:
                fs_branch = False       # clear rejection, no host DP
        if fs_branch:
            try:
                # bit-exact native score first (gate); the full parser
                # matrix is only computed for gate survivors
                from .native import fs3_parser_score_native
                fwdsc = fs3_parser_score_native(tmpseq.dsq, om_fs3)
                if fwdsc is None:
                    _, fwdsc = ffs.forward_parser_fs3(tmpseq.dsq,
                                                      om_fs3)
            except RangeError:
                branch[ci] = None
                continue
            seqscore = (fwdsc - filtersc) / C.CONST_LOG2
            P_fs = float(stats.exp_surv(seqscore,
                                        om_fs3.evparam[C.EV_FTAUFS3],
                                        om_fs3.evparam[C.EV_FLAMBDA]))
            P_null = float(stats.exp_surv(
                (fwdsc - nullsc) / C.CONST_LOG2,
                om_fs3.evparam[C.EV_FTAUFS3],
                om_fs3.evparam[C.EV_FLAMBDA]))
            # Arbitration (ref :1465)
            fs_branch = P_fs <= pli.F3 and (
                P_null < P_tot
                or (P_null == P_tot and orf_cnt > 1)
                or P_min > pli.F3)
        branch[ci] = fs_branch

    # ---- batched device fused Backward + domain decoding ----------
    fs_idx = [ci for ci, b in enumerate(branch) if b]
    posts = None
    if fs_domdec_fn is not None and fs_idx:
        # the host decoder runs with the fs5 model pinned at
        # multihit(100) (see below), whose N/J/C LOOP = 100/103
        posts = fs_domdec_fn([cands[ci].tmpseq for ci in fs_idx],
                             dec_loop=100.0 / 103.0)
    post_of = {ci: k for k, ci in enumerate(fs_idx)}

    # ---- pass 2: domain definition + hit assembly, window order ---
    for ci, cand in enumerate(cands):
        fs_branch = branch[ci]
        if fs_branch is None:
            continue
        w_idx, wn, wlen = cand.w_idx, cand.wn, cand.wlen
        tmpseq = cand.tmpseq

        if fs_branch:
            om_fs3.reconfig_length(wlen // 3)
            pli.pos_past_fwd += wlen
            from .domaindef import PosteriorMargin
            from .ensemble import region_trace_ensemble_fs
            done = False
            if posts is not None and ci in post_of:
                bt, et, mo, okv = posts
                k = post_of[ci]
                if okv[k]:
                    # pin the fs5 models (see the host-path comment
                    # below) BEFORE domain definition
                    gm_fs5.reconfig_multihit(100)
                    om_fs5.reconfig_multihit(100)
                    try:
                        by_posterior_heuristics_fs(
                            pli, tmpseq, om_fs5, gm_fs5, bg, gcode,
                            None, None,
                            ensemble_fn=region_trace_ensemble_fs,
                            posteriors=(bt[k][:wlen + 1],
                                        et[k][:wlen + 1],
                                        mo[k][:wlen + 1]),
                            margin_eps=fs_domdec_margin(wlen))
                        done = True
                    except PosteriorMargin:
                        done = False
                    except RangeError:
                        continue
            if not done:
                try:
                    oxf, _ = ffs.forward_parser_fs3(tmpseq.dsq,
                                                    om_fs3)
                    oxb, _ = ffs.backward_parser_fs3(tmpseq.dsq,
                                                     om_fs3, oxf)
                except RangeError:
                    continue
                # pin the fs5 models to their canonical initial config
                # before domain definition: the reference enters with
                # whatever length/mode the PREVIOUS window's last
                # envelope left behind (p7_domaindef.c:313-325 saveL
                # chain, om_fs5 never restored), making results depend
                # on window processing order.  The canonical state
                # (L=100 multihit = a fresh worker = every
                # single-window golden) makes output invariant to
                # window order and worker count.
                gm_fs5.reconfig_multihit(100)
                om_fs5.reconfig_multihit(100)
                try:
                    by_posterior_heuristics_fs(
                        pli, tmpseq, om_fs5, gm_fs5, bg, gcode, oxf,
                        oxb, ensemble_fn=region_trace_ensemble_fs)
                except RangeError:
                    continue
            if pli.ddef.nregions == 0 or pli.ddef.nenvelopes == 0:
                pli.ddef.reuse()
                continue
            _postdomaindef_fs(pli, gm_fs5, om_fs5, bg, hitlist, seqidx,
                              wn, dnasq, tmpseq, complementarity)
        elif pli.std_pipe:
            for f in range(len(orfs)):
                # cheap float gates first so non-surviving ORFs are
                # never materialized (LazyOrfList)
                if P_orf[f] > pli.F3 or oxf_holder[f] is None:
                    continue
                orfsq = orfs[f]
                w_of = orfsq.idx if widx is None else widx.get(f, -1)
                if w_of != w_idx:
                    continue
                pli.pos_past_fwd += orfsq.n * 3
                om.reconfig_length(orfsq.n)
                try:
                    oxb2, _ = fb.backward(orfsq.dsq, om, oxf_holder[f],
                                          full=False)
                except RangeError:
                    oxf_holder[f] = None
                    continue
                if complementarity:
                    orf_start = dnasq.n - orfsq.start + 1
                    orf_end = dnasq.n - orfsq.end + 1
                else:
                    orf_start = orfsq.start
                    orf_end = orfsq.end
                windowsq = Sequence(
                    name=dnasq.name, acc=dnasq.acc, desc=dnasq.desc,
                    dsq=dnasq.dsq[orf_start - 1:orf_end],
                    start=orf_start, end=orf_end,
                    L=orf_end - orf_start + 1, abc=dnasq.abc)
                from .ensemble import region_trace_ensemble
                by_posterior_heuristics_bath(
                    orfsq, windowsq, dnasq.n, om, gm_fs5,
                    oxf_holder[f], oxb2, pli.ddef, amino(),
                    ensemble_fn=region_trace_ensemble)
                if pli.ddef.nregions == 0 or pli.ddef.nenvelopes == 0:
                    pli.ddef.reuse()
                    oxf_holder[f] = None
                    continue
                _postdomaindef_bath(pli, om, gm, gm_fs5, bg, hitlist,
                                    seqidx, orf_start, orfsq, dnasq,
                                    windowsq, complementarity)
                oxf_holder[f] = None
