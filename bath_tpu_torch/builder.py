"""Model construction: MSA -> calibrated HMM, and single-sequence ->
HMM (ref: p7_builder.c p7_Builder :419, p7_SingleBuilder :478;
build.c p7_Fastmodelmaker :155, matassign2hmm :258;
p7_trace.c p7_trace_FauxFromMSA :2754, _Doctor :2843, _Count :2931;
eweight.c p7_EntropyWeight :61; seqmodel.c p7_Seqmodel :48).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np

from . import constants as C
from .alphabet import Alphabet, amino
from .bg import Background
from .evalues import (CalibrateConfig, calibrate,
                      mean_match_relative_entropy)
from .hmm import (H_CHKSUM, H_CONS, H_GA, H_NC, H_TC, HMM)
from .msa import MSA
from .prior import Prior, amino_prior, parameter_estimation
from .rng import Randomness

# trace state codes (subset of the reference's p7T_*)
ST_B, ST_M, ST_I, ST_D, ST_X, ST_E = range(6)

ETARGET_AMINO = 0.59        # ref: p7_config.h p7_ETARGET_AMINO
LOG2R = 1.0 / math.log(2.0)


@dataclass
class BuilderConfig:
    """Build-time knobs (ref: p7_builder_Create defaults,
    bathbuild.c options :63-170)."""
    arch: str = "fast"            # fast | hand
    symfrac: float = 0.5
    fragthresh: float = 0.5
    wgt: str = "pb"               # pb | gsc | blosum | none | given
    wid: float = 0.62             # --wblosum identity cutoff
    effn: str = "entropy"   # entropy | entropy_exp | clust | none | set
    eid: float = 0.62             # --eclust identity cutoff
    eset: float = -1.0
    re_target: float = ETARGET_AMINO
    esigma: float = 45.0
    prior: str = "default"        # default | laplace | none
    max_insert_len: int = 0
    w_beta: float = C.DEFAULT_WINDOW_BETA
    w_len: int = 0
    popen: float = 0.02
    pextend: float = 0.4
    mx: str = "BLOSUM62"          # single-seq substitution matrix
    mxfile: str | None = None     # ... or read it from a file
    # BATH extras
    fs: bool = True               # calibrate frameshift taus
    fsprob: float = 0.01
    ct: int = 1
    calibration: CalibrateConfig = field(default_factory=CalibrateConfig)
    seed: int = 42


# ---------------------------------------------------------------------
# Faux traces and trace counting
# ---------------------------------------------------------------------
def faux_trace(ax_row: np.ndarray, matassign: np.ndarray, abc: Alphabet):
    """One core faux trace from an aligned row, MSA coords
    (ref: p7_trace_FauxFromMSA :2754).  Returns (st, k, i) int lists;
    i is the 0-based alignment column (or -1)."""
    K, Kp = abc.K, abc.Kp
    st, kk, ii = [ST_B], [0], [-1]
    k = 0
    for apos in range(len(ax_row)):
        x = int(ax_row[apos])
        is_res = (x < K) or (K < x < Kp - 2)
        is_nonres = (x == Kp - 2)
        is_missing = (x == Kp - 1)
        if matassign[apos]:
            k += 1
            if is_res or is_nonres:
                st.append(ST_M); kk.append(k); ii.append(apos)
            elif is_missing:
                if st[-1] != ST_X:
                    st.append(ST_X); kk.append(k); ii.append(-1)
            else:
                st.append(ST_D); kk.append(k); ii.append(-1)
        else:
            if is_res or is_nonres:
                st.append(ST_I); kk.append(k); ii.append(apos)
            elif is_missing:
                if st[-1] != ST_X:
                    st.append(ST_X); kk.append(k); ii.append(-1)
    st.append(ST_E); kk.append(0); ii.append(-1)
    return st, kk, ii


def doctor_trace(st, kk, ii):
    """Collapse illegal D->I / I->D chatter into M
    (ref: p7_trace_Doctor :2843)."""
    n = len(st)
    o = 0
    nst, nkk, nii = [], [], []
    while o < n:
        if o + 1 < n and st[o] == ST_D and st[o + 1] == ST_I:
            nst.append(ST_M); nkk.append(kk[o]); nii.append(ii[o + 1])
            o += 2
        elif o + 1 < n and st[o] == ST_I and st[o + 1] == ST_D:
            nst.append(ST_M); nkk.append(kk[o + 1]); nii.append(ii[o])
            o += 2
        else:
            nst.append(st[o]); nkk.append(kk[o]); nii.append(ii[o])
            o += 1
    return nst, nkk, nii


def count_trace(hmm: HMM, ax_row: np.ndarray, wt: float, st, kk, ii):
    """Count a doctored core trace into the counts-form HMM
    (ref: p7_trace_Count :2931)."""
    abc = hmm.abc
    K, Kp = abc.K, abc.Kp
    n = len(st)
    z1, z2 = 0, n - 1
    if st[0] == ST_B and n > 1 and st[1] == ST_X:
        for z in range(2, n - 1):
            if st[z] == ST_M:
                z1 = z
                break
    if st[-1] == ST_E and n > 1 and st[-2] == ST_X:
        for z in range(n - 3, 0, -1):
            if st[z] == ST_M:
                z2 = z
                break

    def fcount(vec, x):
        # esl_abc_FCount: canonical -> direct; degenerate -> spread
        # uniformly over members; '*' ignored as emission count
        if x < K:
            vec[x] += wt
        elif K < x < Kp - 2:
            mem = abc.degen[x, :K]
            vec[mem] += wt / mem.sum()

    for z in range(z1, z2):
        if st[z] == ST_X:
            continue
        s1, s2 = st[z], st[z + 1]
        k, k2 = kk[z], kk[z + 1]
        if s1 == ST_M:
            fcount(hmm.mat[k], int(ax_row[ii[z]]))
        elif s1 == ST_I:
            fcount(hmm.ins[k], int(ax_row[ii[z]]))
        if s2 == ST_X:
            continue
        if s1 == ST_B:
            if s2 == ST_M and k2 > 1:    # wing-retracted B->DD->Mk
                hmm.t[0, C.H_MD] += wt
                for kt in range(1, k2 - 1):
                    hmm.t[kt, C.H_DD] += wt
                hmm.t[k2 - 1, C.H_DM] += wt
            elif s2 == ST_M:
                hmm.t[0, C.H_MM] += wt
            elif s2 == ST_I:
                hmm.t[0, C.H_MI] += wt
            elif s2 == ST_D:
                hmm.t[0, C.H_MD] += wt
        elif s1 == ST_M:
            if s2 in (ST_M, ST_E):
                hmm.t[k, C.H_MM] += wt
            elif s2 == ST_I:
                hmm.t[k, C.H_MI] += wt
            elif s2 == ST_D:
                hmm.t[k, C.H_MD] += wt
        elif s1 == ST_I:
            if s2 in (ST_M, ST_E):
                hmm.t[k, C.H_IM] += wt
            elif s2 == ST_I:
                hmm.t[k, C.H_II] += wt
        elif s1 == ST_D:
            if s2 in (ST_M, ST_E):
                hmm.t[k, C.H_DM] += wt
            elif s2 == ST_D:
                hmm.t[k, C.H_DD] += wt


# ---------------------------------------------------------------------
# Model makers
# ---------------------------------------------------------------------
def _matassign_fast(msa: MSA, symfrac: float) -> np.ndarray:
    """Column consensus assignment by weighted occupancy
    (ref: p7_Fastmodelmaker :155)."""
    K, Kp = msa.abc.K, msa.abc.Kp
    ax = msa.ax
    is_res = (ax < K) | ((ax > K) & (ax < Kp - 2))
    is_missing = ax == Kp - 1
    w = msa.wgt[:, None]
    r = (is_res * w).sum(axis=0)
    totwgt = ((is_res | ~is_missing) * 0).astype(float)  # placeholder
    totwgt = (np.where(is_missing, 0.0, 1.0) * w).sum(axis=0)
    with np.errstate(invalid="ignore", divide="ignore"):
        frac = np.where(totwgt > 0, r / totwgt, 0.0)
    return (r > 0) & (frac >= symfrac)


def _matassign_hand(msa: MSA) -> np.ndarray:
    """Consensus from #=GC RF annotation (ref: p7_Handmodelmaker :81)."""
    if not msa.rf:
        raise ValueError("--hand requires #=GC RF annotation")
    return np.array([c not in ".-_~" for c in msa.rf])


def _apply_model_mask(msa: MSA):
    """#=GC MM masking: masked residues become the 'any' degenerate
    (ref: build.c do_modelmask :223)."""
    if not msa.mm:
        return
    K, Kp = msa.abc.K, msa.abc.Kp
    anyx = Kp - 3
    for apos, c in enumerate(msa.mm):
        if c == "m":
            col = msa.ax[:, apos]
            mask = (col != K) & (col != Kp - 1)
            msa.ax[mask, apos] = anyx


def matassign_to_hmm(msa: MSA, matassign: np.ndarray
                     ) -> tuple[HMM, list]:
    """Traces + counts (ref: build.c matassign2hmm :258)."""
    _apply_model_mask(msa)
    M = int(matassign.sum())
    if M == 0:
        raise ValueError("no consensus columns; can't build a model")
    hmm = HMM.zeros(M, msa.abc)
    traces = []
    for idx in range(msa.nseq):
        tr = doctor_trace(*faux_trace(msa.ax[idx], matassign, msa.abc))
        traces.append(tr)
        count_trace(hmm, msa.ax[idx], float(msa.wgt[idx]), *tr)
    hmm.nseq = msa.nseq
    hmm.eff_nseq = msa.nseq
    # annotation transfer (ref: build.c annotate_model :338)
    from .hmm import H_CS, H_MAP, H_MMASK, H_RF
    cols = np.nonzero(matassign)[0]
    hmm.map = np.zeros(M + 1, dtype=np.int32)
    hmm.map[1:] = cols + 1
    hmm.flags |= H_MAP
    if msa.rf:
        hmm.rf = " " + "".join(msa.rf[c] for c in cols)
        hmm.flags |= H_RF
    if msa.mm:
        hmm.mm = " " + "".join(msa.mm[c] for c in cols)
        hmm.flags |= H_MMASK
    if msa.cs:
        hmm.cs = " " + "".join(msa.cs[c] for c in cols)
        hmm.flags |= H_CS
    return hmm, traces


# ---------------------------------------------------------------------
# Entropy weighting (ref: eweight.c p7_EntropyWeight :61)
# ---------------------------------------------------------------------
def entropy_weight(hmm: HMM, bg: Background, pri: Prior | None,
                   etarget: float) -> float:
    """Find eff_nseq such that the parameterized model's mean match
    relative entropy equals <etarget> (bisection, abs tol 0.01)."""
    base_t = hmm.t.copy()
    base_mat = hmm.mat.copy()
    base_ins = hmm.ins.copy()

    def f(neff: float) -> float:
        h2 = HMM.zeros(hmm.M, hmm.abc)
        sc = neff / hmm.nseq
        h2.t = base_t * sc
        h2.mat = base_mat * sc
        h2.ins = base_ins * sc
        h2.nseq = hmm.nseq
        parameter_estimation(h2, pri)
        return mean_match_relative_entropy(h2, bg) - etarget

    neff = float(hmm.nseq)
    fx = f(neff)
    if fx <= 0.0:
        return neff
    lo, hi = 0.0, float(hmm.nseq)
    # f(lo) < 0 (prior-dominated), f(hi) > 0: bisect
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if f(mid) > 0.0:
            hi = mid
        else:
            lo = mid
        if hi - lo < 0.01:
            break
    return 0.5 * (lo + hi)


def scale_exponential(hmm: HMM, ex: float):
    """Rescale per-column counts C_k -> C_k^ex
    (ref: p7_hmm.c p7_hmm_ScaleExponential :831)."""
    K = hmm.abc.K
    for k in range(1, hmm.M + 1):
        count = hmm.mat[k, :K].sum()
        scale = (count ** ex) / count if count > 0 else 1.0
        hmm.t[k] *= scale
        hmm.mat[k] *= scale
        hmm.ins[k] *= scale


def entropy_weight_exp(hmm: HMM, bg: Background, pri: Prior | None,
                       etarget: float) -> float:
    """Find the exponent in [0, 1] such that exponentially rescaled
    counts hit <etarget> mean relative entropy
    (ref: eweight.c p7_EntropyWeight_exp :142)."""
    def f(ex: float) -> float:
        h2 = HMM.zeros(hmm.M, hmm.abc)
        h2.t = hmm.t.copy()
        h2.mat = hmm.mat.copy()
        h2.ins = hmm.ins.copy()
        h2.nseq = hmm.nseq
        scale_exponential(h2, ex)
        parameter_estimation(h2, pri)
        return mean_match_relative_entropy(h2, bg) - etarget

    if f(1.0) <= 0.0:
        return 1.0
    lo, hi = 0.0, 1.0
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        if f(mid) > 0.0:
            hi = mid
        else:
            lo = mid
        if hi - lo < 0.001:
            break
    return 0.5 * (lo + hi)


def set_consensus(hmm: HMM, dsq: np.ndarray | None = None):
    """ref: p7_hmm.c p7_hmm_SetConsensus :709."""
    K = hmm.abc.K
    mthresh = 0.5 if hmm.abc.kind == "amino" else 0.9
    out = []
    for k in range(1, hmm.M + 1):
        x = int(dsq[k - 1]) if dsq is not None else int(np.argmax(hmm.mat[k, :K]))
        c = hmm.abc.sym[x]
        out.append(c.upper() if x < K and hmm.mat[k, x] >= mthresh
                   else c.lower())
    hmm.consensus = " " + "".join(out)
    hmm.flags |= H_CONS


# ---------------------------------------------------------------------
# The Builder
# ---------------------------------------------------------------------
def validate_msa(msa: MSA):
    """Missing-data chars allowed only at fragment edges
    (ref: p7_builder.c validate_msa :811)."""
    Kp = msa.abc.Kp
    for idx in range(msa.nseq):
        row = msa.ax[idx]
        miss = row == Kp - 1
        # pattern must be: miss* nonmiss* miss*
        nz = np.nonzero(~miss)[0]
        if len(nz) and miss[nz[0]:nz[-1] + 1].any():
            raise ValueError(
                f"sequence {msa.names[idx]} has missing data chars (~) "
                "other than at fragment edges")


def build(msa: MSA, cfg: BuilderConfig | None = None,
          bg: Background | None = None,
          r: Randomness | None = None,
          postmsa_file: str | None = None,
          do_calibrate: bool = True) -> HMM:
    """MSA -> calibrated probability-form HMM
    (ref: p7_builder.c p7_Builder :419).  postmsa_file resaves the
    trace-implied annotated alignment (ref: make_post_msa :371).
    do_calibrate=False defers E-value calibration (the device backend
    batch-calibrates whole model sets: evalues_device.py)."""
    cfg = cfg or BuilderConfig()
    bg = bg or Background(msa.abc)
    validate_msa(msa)
    checksum = msa.checksum()

    if cfg.wgt == "pb":
        msa.set_pb_weights()
    elif cfg.wgt == "gsc":
        msa.set_gsc_weights()
    elif cfg.wgt == "blosum":
        msa.set_blosum_weights(cfg.wid)
    elif cfg.wgt == "none":
        msa.wgt = np.ones(msa.nseq)
    # "given": keep msa.wgt

    msa.mark_fragments(cfg.fragthresh)

    if cfg.arch == "hand":
        matassign = _matassign_hand(msa)
    else:
        matassign = _matassign_fast(msa, cfg.symfrac)
    hmm, traces = matassign_to_hmm(msa, matassign)
    if postmsa_file:
        from .tracealign import tracealign_msa, write_stockholm
        names, rows, rf = tracealign_msa(msa, traces)
        write_stockholm(postmsa_file, names, rows, rf=rf,
                        name=msa.name)

    # cap weighted-average insert length (ref: p7_builder.c :437-439)
    if cfg.max_insert_len > 0:
        for i in range(1, hmm.M):
            hmm.t[i, C.H_II] = min(hmm.t[i, C.H_II],
                                   cfg.max_insert_len * hmm.t[i, C.H_MI])

    hmm.fs = cfg.fs
    hmm.fsprob = cfg.fsprob
    hmm.ct = cfg.ct

    pri = None
    if cfg.prior == "default":
        pri = amino_prior() if msa.abc.kind == "amino" else None
    elif cfg.prior == "laplace":
        from .prior import laplace_prior
        pri = laplace_prior(msa.abc.K)

    # effective sequence number (ref: effective_seqnumber :905)
    if cfg.effn == "entropy_exp":
        etarget = (cfg.esigma - LOG2R * math.log(
            2.0 / (hmm.M * (hmm.M + 1)))) / hmm.M
        etarget = max(cfg.re_target, etarget)
        ex = entropy_weight_exp(hmm, bg, pri, etarget)
        scale_exponential(hmm, ex)
        hmm.eff_nseq = float(
            hmm.mat[1:, :msa.abc.K].sum() / hmm.M)
    else:
        if cfg.effn == "entropy":
            etarget = (cfg.esigma - LOG2R * math.log(
                2.0 / (hmm.M * (hmm.M + 1)))) / hmm.M
            etarget = max(cfg.re_target, etarget)
            neff = entropy_weight(hmm, bg, pri, etarget)
            hmm.eff_nseq = neff
        elif cfg.effn == "clust":
            _, nclust = msa.single_linkage_clusters(cfg.eid)
            hmm.eff_nseq = float(nclust)
        elif cfg.effn == "set":
            hmm.eff_nseq = cfg.eset
        else:
            hmm.eff_nseq = msa.nseq
        scale = hmm.eff_nseq / hmm.nseq
        hmm.t *= scale
        hmm.mat *= scale
        hmm.ins *= scale

    parameter_estimation(hmm, pri)

    # annotate (ref: annotate :1000)
    hmm.name = msa.name or "query"
    if msa.acc:
        hmm.acc = msa.acc
    if msa.desc:
        hmm.desc = msa.desc
    hmm.ctime = time.asctime()
    hmm.set_composition()
    set_consensus(hmm)
    for tag, flag, slot in (("GA", H_GA, (C.CUT_GA1, C.CUT_GA2)),
                            ("TC", H_TC, (C.CUT_TC1, C.CUT_TC2)),
                            ("NC", H_NC, (C.CUT_NC1, C.CUT_NC2))):
        if tag in msa.cutoffs:
            c1, c2 = msa.cutoffs[tag]
            hmm.cutoff[slot[0]] = c1
            if c2 is not None:
                hmm.cutoff[slot[1]] = c2
            hmm.flags |= flag

    ccfg = cfg.calibration
    ccfg.fs = cfg.fs
    if do_calibrate:
        calibrate(hmm, ccfg, r=r or Randomness(cfg.seed), bg=bg)

    if cfg.w_len > 0:
        hmm.max_length = cfg.w_len
    elif cfg.w_beta == 0.0:
        hmm.max_length = hmm.M * 4
    else:
        hmm.set_max_length(cfg.w_beta)

    hmm.checksum = checksum
    hmm.flags |= H_CHKSUM
    return hmm


# ---------------------------------------------------------------------
# Single-sequence builder (ref: p7_SingleBuilder :478, seqmodel.c)
# ---------------------------------------------------------------------
def seqmodel(dsq: np.ndarray, name: str, Q: np.ndarray, f: np.ndarray,
             popen: float, pextend: float,
             abc: Alphabet | None = None) -> HMM:
    """Query seq + conditional-probability matrix -> probability HMM
    (ref: seqmodel.c p7_Seqmodel :48)."""
    abc = abc or amino()
    M = len(dsq)
    hmm = HMM.zeros(M, abc)
    for k in range(M + 1):
        if k > 0:
            hmm.mat[k] = Q[int(dsq[k - 1])]
        hmm.ins[k] = f
        hmm.t[k, C.H_MM] = 1.0 - 2 * popen
        hmm.t[k, C.H_MI] = popen
        hmm.t[k, C.H_MD] = popen
        hmm.t[k, C.H_IM] = 1.0 - pextend
        hmm.t[k, C.H_II] = pextend
        hmm.t[k, C.H_DM] = 1.0 - pextend
        hmm.t[k, C.H_DD] = pextend
    hmm.t[M, C.H_MM] = 1.0 - popen
    hmm.t[M, C.H_MD] = 0.0
    hmm.t[M, C.H_DM] = 1.0
    hmm.t[M, C.H_DD] = 0.0
    hmm.mat[0, :] = 0.0
    hmm.mat[0, 0] = 1.0
    hmm.name = name
    hmm.nseq = 1
    hmm.ctime = time.asctime()
    return hmm


def single_build(dsq: np.ndarray, name: str,
                 cfg: BuilderConfig | None = None,
                 bg: Background | None = None,
                 r: Randomness | None = None,
                 do_calibrate: bool = True) -> HMM:
    """Single query sequence -> calibrated HMM via substitution-matrix
    probabilities, BLOSUM62 by default (ref: p7_SingleBuilder :478,
    p7_builder_SetScoreSystem :286)."""
    from .scorematrix import (matrix_conditionals, named_matrix,
                              read_matrix_file)

    cfg = cfg or BuilderConfig()
    bg = bg or Background()
    # drop non-residues (ref: p7_SingleBuilder :512-520)
    abc = bg.abc if hasattr(bg, "abc") else amino()
    K, Kp = abc.K, abc.Kp
    keep = (dsq < K) | ((dsq > K) & (dsq < Kp - 2))
    dsq = dsq[keep]
    S = (read_matrix_file(cfg.mxfile) if cfg.mxfile
         else named_matrix(cfg.mx))
    Q = matrix_conditionals(S, bg.f[:K])
    # degenerates emit like background (conditionals defined on
    # canonicals; map degenerate query residues to bg)
    Qfull = np.tile(bg.f[:K], (Kp, 1)).astype(np.float64)
    Qfull[:K] = Q
    hmm = seqmodel(dsq, name, Qfull, bg.f[:K], cfg.popen, cfg.pextend,
                   abc)
    hmm.fs = cfg.fs
    hmm.fsprob = cfg.fsprob
    hmm.ct = cfg.ct
    hmm.set_composition()
    set_consensus(hmm, dsq)
    ccfg = cfg.calibration
    ccfg.fs = cfg.fs
    if do_calibrate:
        calibrate(hmm, ccfg, r=r or Randomness(cfg.seed), bg=bg)
    if cfg.w_len > 0:
        hmm.max_length = cfg.w_len
    elif cfg.w_beta == 0.0:
        hmm.max_length = hmm.M * 4
    else:
        hmm.set_max_length(cfg.w_beta)
    return hmm
