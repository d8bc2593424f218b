"""The BATH comparison pipeline: per-window filter cascade and hit
assembly.

Re-provides p7_Pipeline_BATH and its helpers
(ref: src/p7_pipeline.c :1583 and the functions it
calls).  For each DNA window, ORFs run through the MSV -> bias ->
Viterbi -> Forward cascade; survivors go through domain definition and
hit assembly.  The frameshift branch (--fs) runs the frameshift
Forward arbitration on merged DNA windows.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from . import constants as C
from . import stats
from .alidisplay import nonfs_create
from .alphabet import amino, dna
from .bg import Background
from .domaindef import DomainDef
from .gencode import GeneticCode, Orf, extract_orfs
from .logsum import flogsum
from .oprofile import OProfile
from .ops.reference import fwdback as fb
from .ops.reference.filters import (Window, msv_filter, ssv_filter_bath,
                                    viterbi_filter)
from .ops.reference.fwdback import RangeError
from .profile import FSProfile, Profile
from .scoredata import ScoreData
from .sequence import Sequence
from .tophits import Hit, TopHits

F32 = np.float32


@dataclass
class Pipeline:
    """Pipeline configuration and counters (ref: P7_PIPELINE)."""
    F1: float = C.F1_DEFAULT
    F2: float = C.F2_DEFAULT
    F3: float = C.F3_DEFAULT
    F4: float = C.F4_DEFAULT
    E: float = 10.0
    T: float = 0.0
    by_E: bool = True
    incE: float = 0.01
    incT: float = 0.0
    inc_by_E: bool = True
    do_max: bool = False
    do_biasfilter: bool = True
    do_null2: bool = True
    fs_pipe: bool = False
    std_pipe: bool = True
    spliced: bool = False
    show_alignments: bool = True
    show_accessions: bool = False
    show_frameline: bool = False
    show_trans: bool = True
    show_cigar: bool = False
    Z: float = 0.0
    Z_setby_opt: bool = False
    strands: int = C.STRAND_BOTH
    block_length: int = C.BLOCK_LENGTH_DEFAULT
    use_bit_cutoffs: bool = False
    # counters
    nmodels: int = 0
    nseqs: int = 0
    nres: int = 0
    nnodes: int = 0
    n_past_msv: int = 0
    n_past_bias: int = 0
    n_past_vit: int = 0
    n_past_fwd: int = 0
    n_output: int = 0
    pos_past_msv: int = 0
    pos_past_bias: int = 0
    pos_past_vit: int = 0
    pos_past_fwd: int = 0
    pos_output: int = 0
    W: int = 0
    ddef: DomainDef = field(default_factory=DomainDef)

    def target_reportable(self, score, lnP):
        if self.by_E:
            return math.exp(lnP) <= self.E
        return score >= self.T

    def target_includable(self, score, lnP):
        if self.inc_by_E:
            return math.exp(lnP) <= self.incE
        return score >= self.incT

    def merge(self, other: "Pipeline"):
        """ref: p7_pipeline_Merge :735."""
        self.nseqs += other.nseqs
        self.nres += other.nres
        for a in ("n_past_msv", "n_past_bias", "n_past_vit", "n_past_fwd",
                  "n_output", "pos_past_msv", "pos_past_bias",
                  "pos_past_vit", "pos_past_fwd", "pos_output"):
            setattr(self, a, getattr(self, a) + getattr(other, a))
        if not self.Z_setby_opt:
            self.Z += other.Z


def compute_local_compo(data: ScoreData, om: OProfile, bg: Background,
                        k_start: int, k_end: int) -> np.ndarray:
    """ref: p7_pli_ComputeLocalCompo (p7_pipeline.c:426)."""
    K = len(bg.f)
    Kp = om.Kp
    k_len = k_end - k_start + 1
    if k_len < 20:
        k_start -= (20 - k_len) // 2
        k_end += (20 - k_len) // 2
    k_start = max(1, k_start)
    k_end = min(om.M, k_end)
    # fully vectorized; np.cumsum is a sequential f32 accumulation,
    # so the per-k summation order matches the scalar loop
    # bit-for-bit (compo[x] summed in ascending k)
    ssv = np.asarray(data.ssv_scores, dtype=np.float64)
    ks = np.arange(k_start, k_end + 1)
    idx = (ks[:, None] * Kp + np.arange(K)[None, :]).ravel()
    log_odds = ((float(om.base_b) - ssv[idx]) / om.scale_b) \
        .astype(F32).reshape(len(ks), K)
    rows = (bg.f[None, :K] * np.exp(log_odds)).astype(F32)
    compo = np.cumsum(rows, axis=0, dtype=F32)[-1].copy()
    compo /= compo.sum()
    return compo


def _postdomaindef_bath(pli: Pipeline, om: OProfile, gm: Profile,
                        gm_fs5: FSProfile, bg: Background,
                        hitlist: TopHits, seqidx: int, window_start: int,
                        orfsq: Orf, dnasq: Sequence, windowsq: Sequence,
                        complementarity: int):
    """Hit assembly after domain definition, standard branch
    (ref: p7_pipeline.c p7_pli_postDomainDef_BATH :1171)."""
    ddef = pli.ddef
    for dom in ddef.dcl:
        env_len = dom.jenv - dom.ienv + 1
        ali_len = (dom.jali - dom.iali + 1) // 3
        if ali_len < 4:
            continue
        tmp_i = dom.ienv
        if not complementarity:
            dom.ienv = dnasq.start + orfsq.start + dom.ienv * 3 - 4
            dom.jenv = dnasq.start + orfsq.start + dom.jenv * 3 - 2
            dom.iali = dnasq.start + window_start + dom.iali - 2
            dom.jali = dnasq.start + window_start + dom.jali - 2
        else:
            dom.ienv = dnasq.end + orfsq.start - dom.ienv * 3 + 2
            dom.jenv = dnasq.end + orfsq.start - dom.jenv * 3
            dom.jali = dnasq.start - (window_start + dom.jali) + 2
            dom.iali = dnasq.start - (window_start + dom.iali) + 2

        # adjust score from env_len to max window length
        # (ref: p7_pipeline.c:1230-1239)
        bitscore = dom.envsc
        bitscore -= 2 * math.log(2.0 / (env_len + 2))
        bitscore += 2 * math.log(2.0 / (om.max_length + 2))
        bitscore -= (env_len - ali_len) * math.log(
            float(env_len) / float(env_len + 2))
        bitscore += (om.max_length - ali_len) * math.log(
            float(om.max_length) / float(om.max_length + 2))

        if pli.do_null2:
            dom_bias = float(flogsum(0.0, np.float32(
                math.log(bg.omega) + dom.domcorrection)))
        else:
            dom_bias = 0.0
        bg.set_length(om.max_length)
        nullsc = bg.null_one(om.max_length)
        dom_score = (bitscore - (nullsc + dom_bias)) / C.CONST_LOG2
        dom_lnP = float(stats.exp_logsurv(
            dom_score, om.evparam[C.EV_FTAU], om.evparam[C.EV_FLAMBDA]))

        pli.Z = float(pli.nres) / float(om.max_length)
        keep = (math.exp(dom_lnP) * pli.Z <= pli.E) if pli.inc_by_E \
            else (dom_score >= pli.T)
        if pli.spliced:
            keep = keep or math.exp(dom_lnP) < pli.F3
        if not keep:
            continue

        ad = nonfs_create(dom.tr, 0, om, gm, windowsq, orfsq,
                          dom.orf_sqfrom, amino(), dna(), pli.show_cigar)
        if ad is None:
            continue
        ad.exon_cnt = 1
        ad.sqfrom = dom.iali
        ad.sqto = dom.jali
        ad.L = dnasq.L
        dom.ad = ad

        hit = hitlist.create_next_hit()
        hit.ndom = 1
        hit.best_domain = 0
        hit.window_length = orfsq.n
        hit.target_len = dnasq.n
        hit.seqidx = seqidx
        if not complementarity:
            hit.subseq_start = dom.ienv - (orfsq.start - windowsq.start
                                           + tmp_i * 3) + 3
        else:
            hit.subseq_start = dom.ienv + (dnasq.n - orfsq.start + 1) \
                - windowsq.start + tmp_i * 3 - 3
        hit.dcl = [dom]
        hit.pre_score = bitscore / C.CONST_LOG2
        hit.pre_lnP = float(stats.exp_logsurv(
            hit.pre_score, om.evparam[C.EV_FTAU], om.evparam[C.EV_FLAMBDA]))
        dom.dombias = dom_bias
        dom.bitscore = dom_score
        dom.lnP = dom_lnP
        hit.sum_score = hit.score = dom_score
        hit.sum_lnP = hit.lnP = dom_lnP
        hit.sortkey = -dom_lnP if pli.inc_by_E else dom_score
        hit.name = dnasq.name
        hit.acc = dnasq.acc
        hit.desc = dnasq.desc
    ddef.reuse()


class F3Candidate:
    """One ORF that survived the Vit gate: everything the Forward
    (F3/F4) stage needs, so that stage can run on a device batch
    spanning many windows (ref: the per-ORF tail of p7_Pipeline_BATH,
    p7_pipeline.c:1735-1789)."""
    __slots__ = ("idx", "orfsq", "filtersc", "nullsc", "win_lo",
                 "win_hi")

    def __init__(self, idx, orfsq, filtersc, nullsc, win_lo, win_hi):
        self.idx = idx
        self.orfsq = orfsq
        self.filtersc = filtersc
        self.nullsc = nullsc
        self.win_lo = win_lo
        self.win_hi = win_hi


def pipeline_bath(pli: Pipeline, om: OProfile, gm: Profile,
                  om_fs3, om_fs5, gm_fs5: FSProfile, data: ScoreData,
                  bg: Background, hitlist: TopHits, seqidx: int,
                  dnasq: Sequence, orfs: list[Orf], gcode: GeneticCode,
                  hit_windows: list[Window], complementarity: int,
                  fs_funcs=None, usc_pre=None) -> None:
    """One DNA window vs one profile (ref: p7_Pipeline_BATH :1583).

    <usc_pre>: optional per-ORF MSV scores precomputed by the batched
    device kernel (bit-exact vs msv_filter); when given, the native
    MSV batch call is skipped.

    Implemented as gates (MSV/bias/Vit + window capture) followed by
    the Forward stage; the device pipeline (device_pipeline.py) calls
    the phases separately so device batches span windows."""
    win_start = len(hit_windows)
    cands, P_orf, fwdsc_arr, oxf_holder = pipeline_gates(
        pli, om, data, bg, dnasq, orfs, hit_windows, seqidx,
        complementarity, usc_pre)
    pipeline_fwd_stage(pli, om, gm, gm_fs5, bg, hitlist, seqidx, dnasq,
                       hit_windows, complementarity, cands, P_orf,
                       fwdsc_arr, oxf_holder)
    if pli.fs_pipe and fs_funcs is not None:
        fs_funcs(pli, om, gm, om_fs3, om_fs5, gm_fs5, data, bg, hitlist,
                 seqidx, orfs, dnasq, gcode, P_orf, fwdsc_arr,
                 oxf_holder, hit_windows[win_start:], complementarity)


class GatePlan:
    """Vectorized F1 + bias gate results, up to (but not including)
    the Viterbi scores — the seam where the chunk driver batches the
    device ViterbiFilter across windows."""
    __slots__ = ("usc", "null", "P1", "cand", "filtersc", "P2",
                 "vit_idx", "ssv_idx")

    def __init__(self, usc=None, null=None, P1=None, cand=None,
                 filtersc=None, P2=None, vit_idx=None, ssv_idx=None):
        self.usc = usc
        self.null = null
        self.P1 = P1
        self.cand = cand
        self.filtersc = filtersc
        self.P2 = P2
        self.vit_idx = vit_idx
        self.ssv_idx = ssv_idx


def pipeline_gate_plan(pli: Pipeline, om: OProfile, bg: Background,
                       dnasq: Sequence, orfs,
                       usc_pre=None) -> GatePlan:
    """Vectorized MSV (F1) + bias gates over a window's ORFs: exactly
    the scalar path's f32/f64 op order, no side effects beyond bias
    filter configuration.  plan.vit_idx lists the ORFs that need a
    ViterbiFilter score (the F2 gate input)."""
    n_orfs = len(orfs) if orfs is not None else 0
    if usc_pre is None:
        # one native call for the whole window's ORFs (bit-identical
        # to the per-ORF scalar path; ref: msvfilter.c p7_MSVFilter)
        from .native import msv_filter_native_batch
        usc_pre = msv_filter_native_batch(orfs, om)
    if usc_pre is None:
        return GatePlan()

    # vectorized F1 gate: null scores and Gumbel P-values for the
    # whole batch, with the scalar path's exact f32/f64 op order
    lens_a = (orfs.lens.astype(np.int64)
              if getattr(orfs, "lens", None) is not None
              else np.array([o.n for o in orfs], dtype=np.int64))
    p1v = lens_a.astype(np.float32) / (lens_a + 1).astype(np.float32)
    with np.errstate(divide="ignore"):
        null_pre = (lens_a.astype(np.float32) * np.log(p1v)
                    + np.log(np.float32(1.0) - p1v))
    seqscv = (np.asarray(usc_pre, np.float64)
              - null_pre.astype(np.float64)) / C.CONST_LOG2
    P1_pre = stats.gumbel_surv(seqscv, om.evparam[C.EV_MMU],
                               om.evparam[C.EV_MLAMBDA])
    plan = GatePlan(usc=usc_pre, null=null_pre, P1=P1_pre)
    if getattr(orfs, "starts", None) is None:
        return plan

    # vectorized context-skip + F1 gate over the lazy ORF arrays:
    # at scale ~99% of ORFs die here without ever materializing
    # as Python objects
    st, en = orfs.starts, orfs.ends
    ctx = (((st < en) & (en < dnasq.C))
           | ((en < st) & (st < dnasq.C)))
    cand = np.nonzero(~ctx & (orfs.lens > 0)
                      & ~(P1_pre > pli.F1))[0]
    plan.cand = cand
    # batched bias gate over the F1 survivors (bit-identical to the
    # per-ORF calls; one OpenMP library call instead of thousands)
    if pli.do_biasfilter and len(cand):
        from .native import bg_filter_score_batch
        bg.set_filter(om.M, om.compo)
        fsc = bg_filter_score_batch(orfs, cand, bg)
        if fsc is not None:
            filtersc_pre = np.full(n_orfs, np.nan)
            filtersc_pre[cand] = fsc
            seqscv = (np.asarray(usc_pre, np.float64)[cand]
                      - fsc) / C.CONST_LOG2
            P2 = stats.gumbel_surv(seqscv, om.evparam[C.EV_MMU],
                                   om.evparam[C.EV_MLAMBDA])
            plan.filtersc = filtersc_pre
            plan.P2 = P2
            plan.vit_idx = cand[~(P2 > pli.F1) & (P2 > pli.F2)]
            # bias survivors already under F2 skip Viterbi and go
            # straight to SSV window capture (ref: p7_pipeline.c
            # :1669-1677 else-branch) — the chunk driver batches
            # those captures on device
            plan.ssv_idx = cand[~(P2 > pli.F1) & ~(P2 > pli.F2)]
    return plan


def pipeline_gates(pli: Pipeline, om: OProfile, data: ScoreData,
                   bg: Background, dnasq: Sequence, orfs,
                   hit_windows: list[Window], seqidx: int,
                   complementarity: int, usc_pre=None,
                   plan: GatePlan | None = None, vitsc=None,
                   ssvcaps=None, vitcaps=None):
    """Phase 1 of the pipeline: MSV -> bias -> Viterbi gates plus
    window capture and local-compo rescue.  Returns (candidates for
    the Forward stage, P_orf, fwdsc_arr, oxf_holder) — the last three
    pre-sized for the fs branch.

    <plan>/<vitsc>: the chunk driver precomputes the gate plan and
    batches device ViterbiFilter scores (aligned to plan.vit_idx)
    across windows; both default to the in-call host path."""
    n_orfs = len(orfs) if orfs is not None else 0
    P_orf = [1.0] * n_orfs
    fwdsc_arr = [float("-inf")] * n_orfs
    oxf_holder = [None] * n_orfs
    cands: list[F3Candidate] = []
    if dnasq.n < 15 or not orfs:
        return cands, P_orf, fwdsc_arr, oxf_holder

    if plan is None:
        plan = pipeline_gate_plan(pli, om, bg, dnasq, orfs, usc_pre)
    usc_pre, null_pre, P1_pre = plan.usc, plan.null, plan.P1

    filtersc_pre = plan.filtersc
    vitsc_pre = None
    if P1_pre is not None and plan.cand is not None:
        cand = plan.cand
        orf_iter = ((int(i), orfs[int(i)]) for i in cand)
        if plan.vit_idx is not None:
            vit_idx, P2 = plan.vit_idx, plan.P2
            # Viterbi score gate over the bias survivors: device
            # scores when the chunk driver batched them, else one
            # native OpenMP call (both bit-identical to the scalar
            # filter)
            if vitsc is not None:
                vsc = vitsc if len(vit_idx) else vitsc[:0]
            else:
                from .native import vit_filter_score_batch
                vsc = vit_filter_score_batch(orfs, vit_idx, om)
            if vsc is not None and len(vit_idx):
                vitsc_pre = np.full(n_orfs, np.nan)
                vitsc_pre[vit_idx] = vsc
            if vsc is not None or not len(vit_idx):
                # fully-batched cascade: ORFs dying at the bias
                # or Viterbi gate contribute their filter-stage
                # residue counters here and never materialize;
                # the loop handles only capture-stage survivors
                lens3 = orfs.lens.astype(np.int64) * 3
                surv2 = cand[~(P2 > pli.F1)]
                Pv = np.empty(0)
                if len(vit_idx):
                    seqv = (vsc - filtersc_pre[vit_idx]) \
                        / C.CONST_LOG2
                    Pv = stats.gumbel_surv(
                        seqv, om.evparam[C.EV_VMU],
                        om.evparam[C.EV_VLAMBDA])
                dead_vit = (vit_idx[Pv > pli.F2]
                            if len(vit_idx) else vit_idx)
                pli.pos_past_msv += int(
                    lens3[cand].sum() - lens3[surv2].sum()
                    + lens3[dead_vit].sum())
                pli.pos_past_bias += int(lens3[dead_vit].sum())
                keep = np.ones(n_orfs, dtype=bool)
                keep[dead_vit] = False
                final_idx = surv2[keep[surv2]]
                orf_iter = ((int(i), orfs[int(i)])
                            for i in final_idx)
    elif P1_pre is not None:
        orf_iter = ((int(i), orfs[int(i)])
                    for i in range(n_orfs))
    else:
        orf_iter = enumerate(orfs)
    for idx, orfsq in orf_iter:
        # skip ORFs entirely inside the previous window's context
        if (orfsq.start < orfsq.end and orfsq.end < dnasq.C) or \
                (orfsq.end < orfsq.start and orfsq.start < dnasq.C):
            continue
        if orfsq.n <= 0:
            continue
        vfsc = float("-inf")
        if P1_pre is not None:
            # batch-gated: only survivors pay the per-ORF reconfig
            P = float(P1_pre[idx])
            if P > pli.F1:
                continue
            nullsc = float(null_pre[idx])
            usc = float(usc_pre[idx])
            bg.set_length(orfsq.n)
            om.reconfig_length(orfsq.n)
        else:
            bg.set_length(orfsq.n)
            om.reconfig_length(orfsq.n)
            nullsc = bg.null_one(orfsq.n)
            usc = msv_filter(orfsq.dsq, om)
            seqsc = (usc - nullsc) / C.CONST_LOG2
            P = float(stats.gumbel_surv(seqsc, om.evparam[C.EV_MMU],
                                        om.evparam[C.EV_MLAMBDA]))
            if P > pli.F1:
                continue
        pli.pos_past_msv += orfsq.n * 3

        if pli.do_biasfilter:
            bg.set_filter(om.M, om.compo)
            bg.set_length(orfsq.n)
            if filtersc_pre is not None:
                filtersc = float(filtersc_pre[idx])
            else:
                filtersc = bg.filter_score(orfsq.dsq)
            seqsc = (usc - filtersc) / C.CONST_LOG2
            P = float(stats.gumbel_surv(seqsc, om.evparam[C.EV_MMU],
                                        om.evparam[C.EV_MLAMBDA]))
            if P > pli.F1:
                continue
        else:
            filtersc = nullsc
        pli.pos_past_bias += orfsq.n * 3

        old_window_cnt = len(hit_windows)
        if P > pli.F2:
            if vitsc_pre is not None and \
                    not np.isnan(vitsc_pre[idx]):
                nv = float(vitsc_pre[idx])
            else:
                from .native import vit_filter_native
                nv = vit_filter_native(orfsq.dsq, om)
            if nv is not None:
                # score gate first (batched device/native value,
                # bit-identical); scalar capture only for survivors
                seqsc = (nv - filtersc) / C.CONST_LOG2
                Pn = float(stats.gumbel_surv(
                    seqsc, om.evparam[C.EV_VMU],
                    om.evparam[C.EV_VLAMBDA]))
                if Pn > pli.F2:
                    continue
            if vitcaps is not None and idx in vitcaps \
                    and nv is not None:
                # device crossing events: only the O(window)
                # replay walks run on host; the gate score is the
                # bit-identical device int16 score
                from .ops.reference.filters import (
                    vit_thresh_bath, vit_windows_from_captures)
                rows, ks = vitcaps[idx]
                _, sc_ext = vit_thresh_bath(om, filtersc, pli.F2)
                vit_windows_from_captures(orfsq.dsq, om, data, rows,
                                          ks, hit_windows, sc_ext)
                vfsc = float(nv)
            else:
                vfsc = viterbi_filter(orfsq.dsq, om, data, filtersc,
                                      pli.F2, hit_windows)
            seqsc = (vfsc - filtersc) / C.CONST_LOG2
            P = float(stats.gumbel_surv(seqsc, om.evparam[C.EV_VMU],
                                        om.evparam[C.EV_VLAMBDA]))
            if P > pli.F2:
                del hit_windows[old_window_cnt:]
                continue
        else:
            done = False
            if ssvcaps is not None and idx in ssvcaps:
                # device capture events: only the O(window) diagonal
                # walks run on host (overflowed lanes fall back)
                from .ops.reference.filters import \
                    ssv_windows_from_captures
                done = ssv_windows_from_captures(
                    orfsq.dsq, om, data, ssvcaps[idx], hit_windows)
            if not done:
                ssv_filter_bath(orfsq.dsq, om, data, nullsc, pli.F1,
                                hit_windows)
        for w in hit_windows[old_window_cnt:]:
            w.id = idx
        pli.pos_past_vit += orfsq.n * 3

        # local-composition bias rescue (ref: :1667-1718)
        if pli.do_biasfilter and old_window_cnt < len(hit_windows):
            k_max = hit_windows[old_window_cnt].k
            k_min = k_max - hit_windows[old_window_cnt].length + 1
            for w in hit_windows[old_window_cnt + 1:]:
                k_max = max(k_max, w.k)
                k_min = min(k_min, w.k - w.length + 1)
            local_compo = compute_local_compo(data, om, bg, k_min, k_max)
            bg.set_filter(om.M, local_compo)
            bg.set_length(orfsq.n)
            local_filtersc = bg.filter_score(orfsq.dsq)
            if local_filtersc > filtersc:
                filtersc = local_filtersc
                if vfsc == float("-inf"):
                    seqsc = (usc - filtersc) / C.CONST_LOG2
                    P = float(stats.gumbel_surv(
                        seqsc, om.evparam[C.EV_MMU],
                        om.evparam[C.EV_MLAMBDA]))
                    if P > pli.F2:
                        vfsc = viterbi_filter(orfsq.dsq, om)
                        seqsc = (vfsc - filtersc) / C.CONST_LOG2
                        P = float(stats.gumbel_surv(
                            seqsc, om.evparam[C.EV_VMU],
                            om.evparam[C.EV_VLAMBDA]))
                        if P > pli.F2:
                            del hit_windows[old_window_cnt:]
                            bg.set_filter(om.M, om.compo)
                            continue
                else:
                    seqsc = (vfsc - filtersc) / C.CONST_LOG2
                    P = float(stats.gumbel_surv(
                        seqsc, om.evparam[C.EV_VMU],
                        om.evparam[C.EV_VLAMBDA]))
                    if P > pli.F2:
                        del hit_windows[old_window_cnt:]
                        bg.set_filter(om.M, om.compo)
                        continue
            bg.set_filter(om.M, om.compo)
            bg.set_length(orfsq.n)

        if not pli.fs_pipe and pli.spliced:
            for w in hit_windows[old_window_cnt:]:
                w.id = seqidx
                w.complementarity = complementarity
                if complementarity:
                    w.n = dnasq.end + orfsq.start - \
                        ((w.n + w.length - 1) * 3)
                else:
                    w.n = dnasq.start + orfsq.start + (w.n * 3) - 4
                w.length *= 3
        cands.append(F3Candidate(idx, orfsq, filtersc, nullsc,
                                 old_window_cnt, len(hit_windows)))
    return cands, P_orf, fwdsc_arr, oxf_holder


# P-value safety band for device-gated Forward: a candidate whose
# device P is above threshold*BAND is rejected without host work; any
# candidate within the band (or passing) is re-scored bit-exactly on
# the host, so gate decisions (and all downstream bytes) are identical
# to the host path as long as the device score error stays below
# ln(BAND)/lambda bits (~3 bits at BAND=8; measured device error is
# ~0.01 bits, tests/test_device_pipeline.py pins the bound).
DEVICE_GATE_BAND = 8.0


# margin (in posterior-probability units) within which a device
# domain-decoding value is considered too close to an rt1/rt2/rt3
# trigger threshold to decide on: the ORF falls back to the host
# Backward + p7_DomainDecoding.  Measured device-vs-host error is
# <= ~3e-4 on 2 kaa multi-domain ORFs (tests/test_jax_kernels.py);
# 2e-3 gives ~7x headroom while tripping rarely.
DOMDEC_MARGIN = 2e-3


def _f3_survivor_domaindef(pli, om, gm, gm_fs5, bg, hitlist, seqidx,
                           dnasq, hit_windows, complementarity, cand,
                           posteriors=None, deferred=None) -> None:
    """Domain definition + hit assembly for one F3-surviving ORF
    (ref: p7_pipeline.c:1740-1771).  <posteriors>: optional device
    (btot, etot, mocc); the host Backward runs only when absent or
    when a trigger margin trips (PosteriorMargin).  <deferred>: a list
    that takes the survivor's ``SurvivorPlan`` when it has envelopes,
    for ``finish_survivors`` to rescore with the card's fills; without
    it the host fills rescore them here."""
    from .domaindef import PosteriorMargin, plan_domains_bath
    from .ensemble import region_trace_ensemble
    orfsq = cand.orfsq
    old_window_cnt = cand.win_lo
    if pli.spliced:
        for w in hit_windows[old_window_cnt:cand.win_hi]:
            w.pass_forward = True
    if complementarity:
        orf_start = dnasq.n - orfsq.start + 1
        orf_end = dnasq.n - orfsq.end + 1
    else:
        orf_start = orfsq.start
        orf_end = orfsq.end
    windowsq = Sequence(
        name=dnasq.name, acc=dnasq.acc, desc=dnasq.desc,
        dsq=dnasq.dsq[orf_start - 1:orf_end],
        start=orf_start, end=orf_end, L=orf_end - orf_start + 1,
        abc=dnasq.abc)
    pli.pos_past_fwd += orfsq.n * 3
    plan = None
    if posteriors is not None:
        try:
            plan = plan_domains_bath(
                orfsq, om, None, None, pli.ddef,
                ensemble_fn=region_trace_ensemble, posteriors=posteriors,
                margin_eps=DOMDEC_MARGIN)
        except PosteriorMargin:
            plan = None
    if plan is None:
        try:
            oxf, _ = fb.forward(orfsq.dsq, om, full=False)
            oxb, _ = fb.backward(orfsq.dsq, om, oxf, full=False)
        except RangeError:
            return
        plan = plan_domains_bath(orfsq, om, oxf, oxb, pli.ddef,
                                 ensemble_fn=region_trace_ensemble)
    if pli.ddef.nregions == 0 or pli.ddef.nenvelopes == 0:
        pli.ddef.reuse()
        return
    rec = SurvivorPlan(plan, orfsq, windowsq, orf_start, dnasq, hitlist,
                       seqidx, complementarity, pli.nres)
    if deferred is not None:
        pli.ddef.reuse()
        deferred.append(rec)
        return
    _finish_survivor(pli, om, gm, gm_fs5, bg, rec)


def _finish_survivor(pli, om, gm, gm_fs5, bg, rec: SurvivorPlan,
                     fills=None) -> None:
    """The survivor's envelopes rescored (<fills>: the card's, one an
    envelope of its plan; None: the host fills), then its hits."""
    from .domaindef import finish_domains_bath
    pli.nres = rec.nres
    finish_domains_bath(rec.plan, rec.orfsq, rec.windowsq, rec.dnasq.n, om,
                        gm_fs5, pli.ddef, amino(), fills)
    _postdomaindef_bath(pli, om, gm, gm_fs5, bg, rec.hitlist, rec.seqidx,
                        rec.orf_start, rec.orfsq, rec.dnasq, rec.windowsq,
                        rec.complementarity)


class SurvivorPlan:
    """One F3 survivor between its domain plan and its envelopes'
    rescoring (``pipeline_fwd_stage``'s <deferred>): the plan
    (``domaindef.DomainPlan``) and what the survivor's finish and hit
    assembly read, the window's residue count (``pli.nres``) included."""
    __slots__ = ("plan", "orfsq", "windowsq", "orf_start", "dnasq",
                 "hitlist", "seqidx", "complementarity", "nres")

    def __init__(self, plan, orfsq, windowsq, orf_start, dnasq, hitlist,
                 seqidx, complementarity, nres):
        self.plan, self.orfsq, self.windowsq = plan, orfsq, windowsq
        self.orf_start, self.dnasq, self.hitlist = orf_start, dnasq, hitlist
        self.seqidx, self.complementarity = seqidx, complementarity
        self.nres = nres


def finish_survivors(pli, om, gm, gm_fs5, bg, deferred: list,
                     rescore_fn) -> None:
    """The deferred survivors of ``pipeline_fwd_stage`` finished in the
    order they were planned: every envelope of them filled by one call
    of <rescore_fn>([(residues, length model), ...]) -> [Fills], then
    each survivor rescored and assembled into its hit list, with the
    window's ``pli.nres`` of its plan (the caller restores its own)."""
    envs = [(rec.orfsq.dsq[i - 1:j], xff)
            for rec in deferred for (i, j, xff) in rec.plan.envelopes()]
    fills = rescore_fn(envs) if envs else []
    pos = 0
    for rec in deferred:
        n = len(rec.plan.envelopes())
        _finish_survivor(pli, om, gm, gm_fs5, bg, rec, fills[pos:pos + n])
        pos += n


def pipeline_fwd_stage(pli: Pipeline, om: OProfile, gm: Profile,
                       gm_fs5, bg: Background, hitlist: TopHits,
                       seqidx: int, dnasq: Sequence,
                       hit_windows: list[Window], complementarity: int,
                       cands: list[F3Candidate], P_orf, fwdsc_arr,
                       oxf_holder, fwd_dev=None, domdec_fn=None,
                       deferred=None) -> None:
    """Phase 2: the Forward gate — F3 + domaindef + hit assembly for
    the standard pipeline (ref: p7_pipeline.c:1735-1771), or the
    per-ORF F4 gate for the frameshift pipeline (ref: :1774-1789).

    <fwd_dev>: optional per-candidate device Forward scores (nats).
    Candidates whose device P-value exceeds threshold*DEVICE_GATE_BAND
    are rejected with no host Forward; the rest are re-scored with the
    bit-exact host kernel so output bytes never depend on the device
    arithmetic.

    <domdec_fn(orfseqs) -> (btot, etot, mocc, ok)>: optional batched
    device domain decoding (the fused Backward-parser kernel) run
    over every F3 survivor; survivors then skip the per-ORF host
    Forward+Backward entirely unless flagged or margin-tripped.

    <deferred>: a list that takes each F3 survivor's ``SurvivorPlan``
    (``_f3_survivor_domaindef``) for ``finish_survivors``."""
    from .native import fwd_parser_score_native
    thresh = pli.F3 if not pli.fs_pipe else pli.F4
    survivors = []
    for ci, cand in enumerate(cands):
        idx, orfsq = cand.idx, cand.orfsq
        filtersc, nullsc = cand.filtersc, cand.nullsc
        om.reconfig_length(orfsq.n)
        if fwd_dev is not None:
            sc_dev = float(fwd_dev[ci])
            seqsc_dev = (sc_dev - filtersc) / C.CONST_LOG2
            P_dev = float(stats.exp_surv(
                seqsc_dev, om.evparam[C.EV_FTAU],
                om.evparam[C.EV_FLAMBDA]))
            if P_dev > thresh * DEVICE_GATE_BAND:
                # clear rejection: the exact P can only be within
                # BAND of P_dev, so it also fails the gate
                if pli.fs_pipe:
                    P_orf[idx] = P_dev
                continue
        if not pli.fs_pipe:
            try:
                # bit-exact native score gates first; the parser
                # matrix is only built for survivors
                fwdsc = fwd_parser_score_native(orfsq.dsq, om)
                if fwdsc is None:
                    _, fwdsc = fb.forward(orfsq.dsq, om, full=False)
            except RangeError:
                continue
            seqsc = (fwdsc - filtersc) / C.CONST_LOG2
            P = float(stats.exp_surv(seqsc, om.evparam[C.EV_FTAU],
                                     om.evparam[C.EV_FLAMBDA]))
            if P > pli.F3:
                continue
            survivors.append(cand)
        else:
            # frameshift pipeline F4 gate: run Forward per ORF, save
            # the parser matrix only for gate survivors
            # (ref: :1774-1789)
            try:
                fwdsc = fwd_parser_score_native(orfsq.dsq, om)
                oxf = None
                if fwdsc is None:
                    oxf, fwdsc = fb.forward(orfsq.dsq, om, full=False)
            except RangeError:
                continue
            seqsc = (fwdsc - filtersc) / C.CONST_LOG2
            P_orf[idx] = float(stats.exp_surv(
                seqsc, om.evparam[C.EV_FTAU], om.evparam[C.EV_FLAMBDA]))
            fwdsc_arr[idx] = fwdsc - nullsc
            if P_orf[idx] > pli.F4:
                oxf_holder[idx] = None
            else:
                if oxf is None:
                    try:
                        oxf, _ = fb.forward(orfsq.dsq, om, full=False)
                    except RangeError:
                        continue
                oxf_holder[idx] = oxf

    if pli.fs_pipe:
        return
    posts = None
    if domdec_fn is not None and survivors:
        posts = domdec_fn([c.orfsq for c in survivors])
    for si, cand in enumerate(survivors):
        n = cand.orfsq.n
        om.reconfig_length(n)
        p = None
        if posts is not None:
            btot, etot, mocc, ok = posts
            if ok[si]:
                p = (btot[si][:n + 1], etot[si][:n + 1],
                     mocc[si][:n + 1])
        _f3_survivor_domaindef(pli, om, gm, gm_fs5, bg, hitlist,
                               seqidx, dnasq, hit_windows,
                               complementarity, cand, posteriors=p,
                               deferred=deferred)


def statistics_text(pli: Pipeline, elapsed: float | None = None) -> str:
    """ref: p7_pli_Statistics :1835."""
    out = []
    out.append("Internal pipeline statistics summary:\n")
    out.append("-------------------------------------\n")
    out.append("Query model(s):              %15d  (%d nodes)\n" %
               (pli.nmodels, pli.nnodes))
    out.append("Target %-12s          %15d  (%d residues searched)\n" %
               ("sequence(s):", pli.nseqs, pli.nres))
    denom = pli.nres * pli.nmodels if pli.nres * pli.nmodels else 1
    out.append("Residues passing SSV filter: %15d  (%.3g); expected (%.3g)\n" %
               (pli.pos_past_msv, pli.pos_past_msv / denom, pli.F1))
    out.append("Residues passing bias filter:%15d  (%.3g); expected (%.3g)\n" %
               (pli.pos_past_bias, pli.pos_past_bias / denom, pli.F1))
    out.append("Residues passing Vit filter: %15d  (%.3g); expected (%.3g)\n" %
               (pli.pos_past_vit, pli.pos_past_vit / denom, pli.F2))
    out.append("Residues passing Fwd filter: %15d  (%.3g); expected (%.3g)\n" %
               (pli.pos_past_fwd, pli.pos_past_fwd / denom, pli.F3))
    out.append("Total number of hits:        %15d  (%.3g)\n" %
               (pli.n_output, pli.pos_output / denom))
    if elapsed is not None:
        out.append("# CPU time: %.2fu %.2fs %02d:%02d:%02.2f Elapsed: "
                   "%02d:%02d:%02.2f\n" % (
                       elapsed, 0.0,
                       int(elapsed // 3600), int(elapsed % 3600 // 60),
                       elapsed % 60,
                       int(elapsed // 3600), int(elapsed % 3600 // 60),
                       elapsed % 60))
        mcs = pli.nres * pli.nnodes / (elapsed * 1e6) if elapsed > 0 else 0.0
        out.append("# Mc/sec: %.2f\n" % mcs)
    return "".join(out)
