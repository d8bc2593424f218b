"""Domain definition by posterior heuristics.

Re-provides p7_domaindef (ref: src/p7_domaindef.c):
region finding from decoded posteriors, multidomain-region detection,
and per-envelope rescoring (Forward/Backward/decoding/OptAcc/null2).

Stochastic-trace ensemble clustering of multidomain regions is
implemented in ensemble.py; region resolution divergence from the
reference is confined to RNG-stream differences there (see SURVEY.md
hard part 3).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import constants as C
from .oprofile import OProfile
from .ops.reference import fwdback as fb
from .ops.reference.fwdback import PMatrix, RangeError, Trace
from .profile import FSProfile
from .sequence import Sequence

F32 = np.float32


@dataclass
class Domain:
    """One domain/envelope result (ref: P7_DOMAIN in hmmer.h:818)."""
    ienv: int = 0
    jenv: int = 0
    iali: int = 0
    jali: int = 0
    ihmm: int = 0
    jhmm: int = 0
    envsc: float = 0.0
    domcorrection: float = 0.0
    dombias: float = 0.0
    oasc: float = 0.0
    bitscore: float = 0.0
    lnP: float = 0.0
    is_reported: bool = False
    is_included: bool = False
    aliscore: float = 0.0
    scores_per_pos: np.ndarray | None = None
    k_per_pos: np.ndarray | None = None
    tr: Trace | None = None
    ad: object | None = None


@dataclass
class DomainDef:
    """ref: P7_DOMAINDEF defaults (p7_domaindef.c:82-91)."""
    rt1: float = 0.25
    rt2: float = 0.10
    rt3: float = 0.20
    nsamples: int = 200
    min_overlap: float = 0.8
    of_smaller: bool = True
    max_diagdiff: int = 4
    min_posterior: float = 0.25
    min_endpointp: float = 0.02
    do_reseeding: bool = True
    seed: int = 42
    splice: bool = False
    fstbl: bool = False
    # envelopes filled by the native host fills, over the object's life
    host_fills: int = 0

    nexpected: float = 0.0
    nregions: int = 0
    nclustered: int = 0
    noverlaps: int = 0
    nenvelopes: int = 0
    ndom: int = 0
    dcl: list = field(default_factory=list)
    mocc: np.ndarray | None = None
    btot: np.ndarray | None = None
    etot: np.ndarray | None = None
    n2sc: np.ndarray | None = None

    def reuse(self):
        self.ndom = 0
        self.dcl = []
        self.nexpected = 0.0
        self.nregions = self.nclustered = 0
        self.noverlaps = self.nenvelopes = 0


def is_multidomain_region(ddef: DomainDef, i: int, j: int) -> bool:
    """ref: p7_domaindef.c is_multidomain_region :629."""
    etot, btot = ddef.etot, ddef.btot
    mx = -1.0
    for z in range(i, j + 1):
        expected_n = min(float(etot[z] - etot[i - 1]),
                         float(btot[j] - btot[z - 1]))
        mx = max(mx, expected_n)
    return mx >= ddef.rt3


class PosteriorMargin(Exception):
    """A region-detection comparison with device-computed posteriors
    landed within the safety margin of its threshold: the caller must
    redo the ORF with the host kernels so knife-edge trigger decisions
    never depend on device arithmetic."""


def region_scan_margin(btot, etot, mocc, n: int, ddef: DomainDef,
                       eps: float) -> None:
    """Dry-run the region-detection automaton of
    by_posterior_heuristics_bath on (btot, etot, mocc) and raise
    PosteriorMargin if ANY comparison it makes (rt1/rt2 triggers,
    the is_multidomain rt3 decision) is within <eps> of its
    threshold.  If every margin clears, a run with values perturbed
    by < eps makes identical decisions at every step, so host and
    device posteriors yield the same regions/envelopes by induction."""
    rt1, rt2, rt3 = ddef.rt1, ddef.rt2, ddef.rt3
    i = -1
    triggered = False
    for j in range(1, n + 1):
        if not triggered:
            if abs((mocc[j] - (btot[j] - btot[j - 1])) - rt2) < eps:
                raise PosteriorMargin(f"rt2/b at {j}")
            if abs(mocc[j] - rt1) < eps:
                raise PosteriorMargin(f"rt1 at {j}")
            if mocc[j] - (btot[j] - btot[j - 1]) < rt2:
                i = j
            elif i == -1:
                i = j
            if mocc[j] >= rt1:
                triggered = True
        else:
            if abs((mocc[j] - (etot[j] - etot[j - 1])) - rt2) < eps:
                raise PosteriorMargin(f"rt2/e at {j}")
            if mocc[j] - (etot[j] - etot[j - 1]) < rt2:
                mx = -1.0
                for z in range(i, j + 1):
                    mx = max(mx, min(float(etot[z] - etot[i - 1]),
                                     float(btot[j] - btot[z - 1])))
                if abs(mx - rt3) < eps:
                    raise PosteriorMargin(f"rt3 region {i}..{j}")
                i = -1
                triggered = False


def compute_ali_scores_bath(dom: Domain, tr: Trace, windowsq: Sequence,
                            gm_fs5: FSProfile) -> None:
    """Per-position Viterbi-style scores of a (converted) trace
    (ref: p7_pipeline.c p7_pli_computeAliScores_BATH :780).  Also
    counts frameshifts/stop-codons into tr.fs.  dsq coords in tr.i are
    1-based window nt positions of codon ends."""
    nuc = windowsq.dsq
    maxc = gm_fs5.maxcodons
    st, kk, ii, cc = tr.st, tr.k, tr.i, tr.c
    N = tr.N
    z1 = 0
    while z1 < N and st[z1] != C.T_M:
        z1 += 1
    z2 = N - 1
    while z2 >= 0 and st[z2] != C.T_M:
        z2 -= 1
    n_len = z2 - z1 + 1
    # f32 storage: each element is at most one add of two f32 values,
    # so the store's single rounding == the reference's C float math
    scores = np.zeros(n_len, dtype=np.float32)
    kpos = np.zeros(n_len, dtype=np.int32)

    def codon_index(i, c):
        """(quasi)codon index for codon of length c ending at nt i
        (1-based); degenerate nts route to the degen slots."""
        nts = [int(nuc[i - 1 - d]) for d in range(c)][::-1]
        if any(x >= C.MAXNUC for x in nts):
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

    n = 0
    z = z1
    tsc = gm_fs5.tsc
    while z <= z2:
        s = st[z]
        if s == C.T_M:
            first = True
            while z <= z2 and st[z] == C.T_M:
                i, c, k = ii[z], cc[z], kk[z]
                ci = codon_index(i, c)
                if c in (1, 2, 4, 5):
                    tr.fs += 1
                elif c == 3:
                    ind = int(gm_fs5.indel_pos[ci, k])
                    if ind in (C.I_XXx, C.I_XxX, C.I_xXX):
                        tr.fs += 1
                amino = int(gm_fs5.codons[ci, k])
                sc = gm_fs5.amino_score(k, amino)
                if first:
                    if z > 0 and st[z - 1] == C.T_I:
                        sc += float(tsc[k - 1, C.P_IM])
                    elif z > 0 and st[z - 1] == C.T_D:
                        sc += float(tsc[k - 1, C.P_DM])
                elif z < z2:
                    # the final M of the trace gets NO transition
                    # term: the reference's inner M loop runs
                    # `while (z1 < z2)`, so z2 is re-processed as a
                    # run start whose predecessor is M (ref:
                    # p7_pipeline.c p7_pli_computeAliScores_BATH)
                    sc += float(tsc[k - 1, C.P_MM])
                scores[n] = sc
                kpos[n] = k
                n += 1
                z += 1
                first = False
        elif s == C.T_I:
            k = kk[z]
            scores[n] = float(tsc[k, C.P_MI])
            kpos[n] = k
            n += 1
            z += 1
            while z <= z2 and st[z] == C.T_I:
                scores[n] = float(tsc[kk[z], C.P_II])
                kpos[n] = kk[z]
                n += 1
                z += 1
        elif s == C.T_D:
            k = kk[z]
            scores[n] = float(tsc[k - 1, C.P_MD])
            kpos[n] = k
            n += 1
            z += 1
            while z <= z2 and st[z] == C.T_D:
                scores[n] = float(tsc[kk[z] - 1, C.P_DD])
                kpos[n] = kk[z]
                n += 1
                z += 1
        else:
            raise ValueError("impossible state in computeAliScores")

    dom.scores_per_pos = scores[:n]
    dom.k_per_pos = kpos[:n]
    from .native import f32_seq_sum
    dom.aliscore = f32_seq_sum(scores[:n])


def rescore_isolated_domain_bath(ddef: DomainDef, om: OProfile,
                                 gm_fs5: FSProfile, orfsq,
                                 windowsq: Sequence, ntsqlen: int,
                                 i: int, j: int,
                                 null2_is_done: bool,
                                 abc, fills=None) -> bool:
    """Envelope rescore for the standard (non-frameshift) branch
    (ref: p7_domaindef.c rescore_isolated_domain_bath :1236).
    Returns True if a domain was registered.  <fills>: the envelope's
    Forward, Backward, decoding and OA fills made by the card's stage
    (``ops/rescore.py`` ``Fills``); None runs the native host fills and
    counts them in ``ddef.host_fills``."""
    from .phasestats import phase
    with phase("envelope-std"):
        return _rescore_isolated_domain_bath(
            ddef, om, gm_fs5, orfsq, windowsq, ntsqlen, i, j,
            null2_is_done, abc, fills)


def envelope_fills(om: OProfile, dsq):
    """(Forward matrix, envsc, Backward matrix, pp) of the envelope <dsq>
    under <om>'s length model, by the native host fills; raises
    RangeError as they do."""
    oxf, envsc = fb.forward(dsq, om, full=True)
    oxb, _ = fb.backward(dsq, om, oxf, full=True)
    return oxf, envsc, oxb, fb.decoding(om, oxf, oxb)


def host_fills(om: OProfile, dsq):
    """(envsc, pp, ox, oasc) of the envelope <dsq> under <om>'s length
    model, by the native host fills; None where they raise RangeError."""
    try:
        _, envsc, _, pp = envelope_fills(om, dsq)
    except RangeError:
        return None
    ox, oasc = fb.optimal_accuracy(om, pp)
    return envsc, pp, ox, oasc


def _rescore_isolated_domain_bath(ddef: DomainDef, om: OProfile,
                                  gm_fs5: FSProfile, orfsq,
                                  windowsq: Sequence, ntsqlen: int,
                                  i: int, j: int,
                                  null2_is_done: bool,
                                  abc, fills=None) -> bool:
    Ld = j - i + 1
    om.reconfig_length(Ld)
    if fills is None:
        ddef.host_fills += 1
        got = host_fills(om, orfsq.dsq[i - 1:j])
    else:
        got = fills.host(om)
    if got is None:
        return False
    envsc, pp, ox, oasc = got
    tr = fb.oa_trace(om, pp, ox)
    # offset trace seq coords to the original ORF dsq
    for z in range(tr.N):
        if tr.i[z] > 0:
            tr.i[z] += i - 1
    tr.index()
    orf_sqfrom = tr.sqfrom[0] if tr.ndom else 0

    # convert to DNA window coords (ref: p7_trace_fs_Convert)
    if orfsq.start < orfsq.end:
        conv_start = orfsq.start - windowsq.start
    else:
        conv_start = (ntsqlen - orfsq.start + 1) - windowsq.start
    for z in range(tr.N):
        s = tr.st[z]
        if s in (C.T_N, C.T_C, C.T_J):
            if z > 0 and tr.st[z - 1] == s:
                tr.i[z] = conv_start + tr.i[z] * 3
            tr.c[z] = 0
        elif s == C.T_M:
            tr.i[z] = conv_start + tr.i[z] * 3
            tr.c[z] = 3
        elif s == C.T_I:
            tr.i[z] = conv_start + tr.i[z] * 3
            tr.c[z] = 0
        else:
            tr.c[z] = 0

    dom = Domain()
    compute_ali_scores_bath(dom, tr, windowsq, gm_fs5)
    if dom.aliscore < 0.0:
        return False

    if not null2_is_done:
        null2 = fb.null2_by_expectation(om, pp, abc.K)
        null2 = fb.finish_null2(null2, abc)
        with np.errstate(divide="ignore"):
            ddef.n2sc[i:j + 1] = np.log(null2[orfsq.dsq[i - 1:j]]).astype(F32)
    from .native import f32_seq_sum
    domcorrection = f32_seq_sum(ddef.n2sc[i:j + 1])
    dom.domcorrection = max(0.0, domcorrection)

    st = tr.st
    z1 = 0
    while z1 < tr.N and st[z1] != C.T_M:
        z1 += 1
    z2 = tr.N - 1
    while z2 >= 0 and st[z2] != C.T_M:
        z2 -= 1
    dom.ihmm, dom.jhmm = tr.k[z1], tr.k[z2]
    if windowsq.start < windowsq.end:
        dom.iali = tr.i[z1] - (tr.c[z1] - 1)
        dom.jali = tr.i[z2]
    else:
        dom.iali = tr.i[z2] - (tr.c[z1] - 1)
        dom.jali = tr.i[z1]
    dom.ienv, dom.jenv = i, j
    dom.envsc = envsc
    dom.oasc = oasc
    dom.tr = tr
    dom.orf_sqfrom = orf_sqfrom
    if not ddef.splice:
        dom.scores_per_pos = None
        dom.k_per_pos = None
    ddef.dcl.append(dom)
    ddef.ndom += 1
    return True


@dataclass
class DomainPlan:
    """One ORF's domain definition up to its envelopes' fills: the
    regions the posterior scan found, in order, each [(i, j, xff)] of its
    envelopes (xff: the unihit length model of the envelope, the eight
    floats the fills read) and whether it was multidomain; and the
    DomainDef state the envelopes' rescoring reads (the posteriors, the
    null2 scores the ensemble set, the scan's counters)."""
    regions: list
    saveL: int
    multihit: bool
    btot: np.ndarray
    etot: np.ndarray
    mocc: np.ndarray
    n2sc: np.ndarray
    nexpected: float
    nregions: int
    nclustered: int
    nenvelopes: int

    def envelopes(self) -> list:
        return [env for _, envs in self.regions for env in envs]


def _unihit(om: OProfile, saveL: int) -> None:
    """Envelope rescoring's mode: unihit at the ORF's length."""
    om.nj = 0.0
    om.xf[C.X_E, C.MOVE] = 1.0
    om.xf[C.X_E, C.LOOP] = 0.0
    om.xw[C.X_E, C.MOVE] = 0
    om.xw[C.X_E, C.LOOP] = -32768
    om.reconfig_rest_length(saveL)


def _restore_mode(om: OProfile, saveL: int, multihit: bool) -> None:
    if multihit:
        om.nj = 1.0
        om.xf[C.X_E, C.MOVE] = 0.5
        om.xf[C.X_E, C.LOOP] = 0.5
        from .oprofile import _wordify
        om.xw[C.X_E, C.MOVE] = _wordify(om.scale_w, np.log(0.5))
        om.xw[C.X_E, C.LOOP] = _wordify(om.scale_w, np.log(0.5))
    om.reconfig_rest_length(saveL)


def plan_domains_bath(orfsq, om: OProfile, oxf: PMatrix, oxb: PMatrix,
                      ddef: DomainDef, ensemble_fn=None, posteriors=None,
                      margin_eps: float = 0.0) -> DomainPlan:
    """The region scan of p7_domaindef_ByPosteriorHeuristics_BATH
    (ref: p7_domaindef.c :499) without the envelopes' rescoring, which
    no decision of the scan reads: regions, multidomain tests and the
    ensemble's envelopes (the ensemble runs here, its RNG stream in the
    serial order), counted in <ddef> as the serial path counts them but
    ``noverlaps``, which reads the rescoring.  <ddef> keeps the state the
    plan also holds; <om> ends in the mode it started in.  Arguments as
    ``by_posterior_heuristics_bath``'s."""
    from .native import _xff_of
    n = orfsq.n
    saveL = om.L
    save_mode_multihit = om.nj > 0
    if posteriors is not None:
        btot, etot, mocc = posteriors
        if margin_eps > 0.0:
            region_scan_margin(btot, etot, mocc, n, ddef, margin_eps)
    else:
        btot, etot, mocc = fb.domain_decoding(om, oxf, oxb)
    ddef.btot, ddef.etot, ddef.mocc = btot, etot, mocc
    ddef.n2sc = np.zeros(n + 1, dtype=F32)
    ddef.nexpected = float(btot[n])
    _unihit(om, saveL)

    def env(a, b):
        om.reconfig_length(b - a + 1)
        return (a, b, _xff_of(om))

    regions = []
    i = -1
    triggered = False
    j = 1
    while j <= n:
        if not triggered:
            if mocc[j] - (btot[j] - btot[j - 1]) < ddef.rt2:
                i = j
            elif i == -1:
                i = j
            if mocc[j] >= ddef.rt1:
                triggered = True
        elif mocc[j] - (etot[j] - etot[j - 1]) < ddef.rt2:
            ddef.nregions += 1
            if is_multidomain_region(ddef, i, j):
                ddef.nclustered += 1
                envs = None
                if ensemble_fn is not None:
                    envs = ensemble_fn(ddef, om, orfsq, i, j, saveL)
                if envs is None:
                    envs = [(i, j)]
                if len(envs) == 0:
                    ddef.nenvelopes += 1
                ddef.nenvelopes += len(envs)
                regions.append((True, [env(i2, j2) for i2, j2 in envs]))
            else:
                ddef.nenvelopes += 1
                regions.append((False, [env(i, j)]))
            i = -1
            triggered = False
        j += 1

    _restore_mode(om, saveL, save_mode_multihit)
    return DomainPlan(regions, saveL, save_mode_multihit, btot, etot, mocc,
                      ddef.n2sc, ddef.nexpected, ddef.nregions,
                      ddef.nclustered, ddef.nenvelopes)


def finish_domains_bath(plan: DomainPlan, orfsq, windowsq: Sequence,
                        ntsqlen: int, om: OProfile, gm_fs5: FSProfile,
                        ddef: DomainDef, abc, fills=None) -> None:
    """The envelopes of <plan> rescored in the scan's order, with <ddef>
    set back to the plan's state first and the overlaps of each
    multidomain region's envelopes counted: <fills> one ``Fills`` an
    envelope of ``plan.envelopes()`` (the card's), or None for the host
    fills.  <om> ends in the mode it started in."""
    ddef.btot, ddef.etot, ddef.mocc = plan.btot, plan.etot, plan.mocc
    ddef.n2sc, ddef.nexpected = plan.n2sc, plan.nexpected
    ddef.nregions, ddef.nclustered = plan.nregions, plan.nclustered
    ddef.nenvelopes = plan.nenvelopes
    _unihit(om, plan.saveL)
    fill = iter(fills) if fills is not None else None
    for multi, envs in plan.regions:
        last_j2 = 0
        for (i, j, _) in envs:
            if multi and i <= last_j2:
                ddef.noverlaps += 1
            if rescore_isolated_domain_bath(
                    ddef, om, gm_fs5, orfsq, windowsq, ntsqlen, i, j,
                    multi, abc, None if fill is None else next(fill)):
                last_j2 = j
    _restore_mode(om, plan.saveL, plan.multihit)


def by_posterior_heuristics_bath(orfsq, windowsq: Sequence, ntsqlen: int,
                                 om: OProfile, gm_fs5: FSProfile,
                                 oxf: PMatrix, oxb: PMatrix,
                                 ddef: DomainDef, abc,
                                 ensemble_fn=None,
                                 posteriors=None,
                                 margin_eps: float = 0.0) -> None:
    """Standard-branch domain definition on an ORF
    (ref: p7_domaindef.c p7_domaindef_ByPosteriorHeuristics_BATH :499):
    the region scan (``plan_domains_bath``), then each envelope rescored
    by the host fills (``finish_domains_bath``).

    <ensemble_fn(i, j)> resolves a multidomain region into envelope
    coordinates; if None, the region is treated as one envelope.

    <posteriors>: optional precomputed (btot, etot, mocc) — the device
    domdec kernel's output — used instead of running the host
    Backward + p7_DomainDecoding (oxf/oxb may then be None).  With
    <margin_eps> > 0, PosteriorMargin is raised BEFORE any side
    effects if a trigger decision is within eps of its threshold."""
    plan = plan_domains_bath(orfsq, om, oxf, oxb, ddef, ensemble_fn,
                             posteriors, margin_eps)
    finish_domains_bath(plan, orfsq, windowsq, ntsqlen, om, gm_fs5, ddef,
                        abc)
