"""E-value calibration: lambda, MSV/Viterbi Gumbel mu, Forward tau,
and the frameshift taus (ref: evalues.c p7_Calibrate :64, p7_Lambda
:244, p7_MSVMu :298, p7_ViterbiMu :367, p7_Tau :537,
p7_fs_Tau_3codons :608, p7_fs_Tau_5codons).

Simulation defaults follow the reference (evalues.c:79-85):
EmL/EmN = 200/200, EvL/EvN = 200/200, EfL/EfN = 100/200, Eft = 0.04,
seeded RNG 42 (evalues.c:95).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from . import constants as C
from .bg import Background
from .codontable import CodonTable
from .gencode import GeneticCode
from .hmm import HMM
from .oprofile import OProfile, oprofile_convert
from .profile import profile_config, profile_config_fs
from .rng import Randomness
from .stats import gumbel_fit_complete, gumbel_fit_fixlambda, gumbel_invsurv

LOG2 = math.log(2.0)


@dataclass
class CalibrateConfig:
    """Simulation lengths/counts (ref: p7_builder defaults)."""
    EmL: int = 200
    EmN: int = 200
    EvL: int = 200
    EvN: int = 200
    EfL: int = 100
    EfN: int = 200
    Eft: float = 0.04
    seed: int = 42
    fs: bool = False          # also calibrate frameshift taus
    do_reseeding: bool = True  # reset a passed RNG before calibrating
    #                            (ref: evalues.c:94 + p7_builder.c:131
    #                            — nonzero seeds make every model's
    #                            calibration order-independent)


def mean_match_relative_entropy(hmm: HMM, bg: Background) -> float:
    """Mean match-state relative entropy in bits
    (ref: modelstats.c p7_MeanMatchRelativeEntropy :80)."""
    p = hmm.mat[1:hmm.M + 1]          # [M, K]
    f = bg.f[None, :p.shape[1]]
    with np.errstate(divide="ignore", invalid="ignore"):
        terms = np.where(p > 0, p * np.log2(p / f), 0.0)
    return float(terms.sum(axis=1).mean())


def lambda_param(hmm: HMM, bg: Background) -> float:
    """Edge-corrected lambda (ref: evalues.c p7_Lambda :244)."""
    H = mean_match_relative_entropy(hmm, bg)
    return LOG2 + 1.44 / (hmm.M * H)


def msv_mu(r: Randomness, om: OProfile, bg: Background, L: int, N: int,
           lam: float) -> float:
    """Gumbel mu for MSV scores by simulation (ref: p7_MSVMu :298)."""
    from .ops.reference.filters import msv_filter

    om.reconfig_length(L)
    bg.set_length(L)
    maxsc = (255 - om.base_b) / om.scale_b
    xv = np.empty(N)
    for i in range(N):
        dsq = r.sample_iid(bg.f, L)
        nullsc = bg.null_one(L)
        sc = msv_filter(dsq, om)
        if not np.isfinite(sc):
            sc = maxsc
        xv[i] = (sc - nullsc) / LOG2
    return gumbel_fit_fixlambda(xv, lam)


def vit_mu(r: Randomness, om: OProfile, bg: Background, L: int, N: int,
           lam: float) -> float:
    """Gumbel mu for ViterbiFilter scores (ref: p7_ViterbiMu :367)."""
    from .ops.reference.filters import viterbi_filter

    om.reconfig_length(L)
    bg.set_length(L)
    maxsc = (32767.0 - om.base_w) / om.scale_w
    xv = np.empty(N)
    for i in range(N):
        dsq = r.sample_iid(bg.f, L)
        nullsc = bg.null_one(L)
        sc = viterbi_filter(dsq, om)
        if not np.isfinite(sc):
            sc = maxsc
        xv[i] = (sc - nullsc) / LOG2
    return gumbel_fit_fixlambda(xv, lam)


def fwd_tau(r: Randomness, om: OProfile, bg: Background, L: int, N: int,
            lam: float, tailp: float) -> float:
    """Forward exponential-tail tau by Gumbel-assisted simulation
    (ref: p7_Tau :537)."""
    from .ops.reference.fwdback import forward

    om.reconfig_length(L)
    bg.set_length(L)
    xv = np.empty(N)
    for i in range(N):
        dsq = r.sample_iid(bg.f, L)
        from .native import fwd_parser_score_native
        fsc = fwd_parser_score_native(dsq, om)
        if fsc is None:
            _, fsc = forward(dsq, om, fast=True)
        nullsc = bg.null_one(L)
        xv[i] = (fsc - nullsc) / LOG2
    gmu, glam = gumbel_fit_complete(xv)
    # x at which Gumbel tail mass = tailp, backed up to anchor the
    # exponential at P=1 (ref: evalues.c :594-600)
    return float(gumbel_invsurv(tailp, gmu, glam) + math.log(tailp) / lam)


def fs_tau(r: Randomness, om_fs, ct: CodonTable, bg: Background, L: int,
           N: int, lam: float, tailp: float) -> float:
    """Frameshift Forward tau: random aminos reverse-translated to DNA,
    scored with the fs Forward parser (ref: p7_fs_Tau_3codons :608,
    p7_fs_Tau_5codons).  Works for both 3- and 5-codon profiles."""
    from .ops.reference.fwdback_fs import (RangeError, forward_fs5,
                                           forward_parser_fs3)

    om_fs.reconfig_length(L)
    bg.set_length(L)
    xv = np.empty(N)
    i = 0
    from .native import sample_dna_native
    while i < N:
        dna = sample_dna_native(r, bg.f, ct, L)
        if dna is None:
            amino = r.sample_iid(bg.f, L)
            dna = ct.reverse_translate(r, amino)
        try:
            if om_fs.codon_lengths == 3:
                from .native import fs3_parser_score_native
                fsc = fs3_parser_score_native(dna, om_fs)
                if fsc is None:
                    _, fsc = forward_parser_fs3(dna, om_fs, fast=True)
            else:
                from .native import fs5_forward_score_native
                fsc = fs5_forward_score_native(dna, om_fs)
                if fsc is None:
                    _, fsc = forward_fs5(dna, om_fs, fast=True)
        except RangeError:
            continue                      # resample (ref: i--; continue)
        nullsc = bg.fs_null_one(L)
        xv[i] = (fsc - nullsc) / LOG2
        i += 1
    gmu, glam = gumbel_fit_complete(xv)
    return float(gumbel_invsurv(tailp, gmu, glam) + math.log(tailp) / lam)


def calibrate(hmm: HMM, cfg: CalibrateConfig | None = None,
              r: Randomness | None = None,
              bg: Background | None = None) -> None:
    """Calibrate all E-value parameters of <hmm> in place and set its
    STATS flag (ref: evalues.c p7_Calibrate :64)."""
    cfg = cfg or CalibrateConfig()
    if r is None:
        r = Randomness(cfg.seed)
    elif cfg.do_reseeding:
        # ref: evalues.c:94 esl_randomness_Init(r, GetSeed(r))
        r.reset()
    bg = bg or Background()

    gm = profile_config(hmm, bg, L=cfg.EvL)
    om = oprofile_convert(gm)

    lam = lambda_param(hmm, bg)
    mmu = msv_mu(r, om, bg, cfg.EmL, cfg.EmN, lam)
    vmu = vit_mu(r, om, bg, cfg.EvL, cfg.EvN, lam)
    tau = fwd_tau(r, om, bg, cfg.EfL, cfg.EfN, lam, cfg.Eft)

    hmm.evparam[C.EV_MLAMBDA] = lam
    hmm.evparam[C.EV_VLAMBDA] = lam
    hmm.evparam[C.EV_FLAMBDA] = lam
    hmm.evparam[C.EV_MMU] = mmu
    hmm.evparam[C.EV_VMU] = vmu
    hmm.evparam[C.EV_FTAU] = tau

    if cfg.fs:
        from .ops.reference.fwdback_fs import fs_oprofile_convert

        gcode = GeneticCode.create(hmm.ct if hmm.ct else 1)
        gcode.set_initiator_any()
        ct = CodonTable(gcode)
        gm3 = profile_config_fs(hmm, bg, gcode, 3, cfg.EvL)
        om3 = fs_oprofile_convert(gm3)
        gm5 = profile_config_fs(hmm, bg, gcode, 5, cfg.EvL)
        om5 = fs_oprofile_convert(gm5)
        hmm.evparam[C.EV_FTAUFS3] = fs_tau(r, om3, ct, bg, cfg.EfL,
                                           cfg.EfN, lam, cfg.Eft)
        hmm.evparam[C.EV_FTAUFS5] = fs_tau(r, om5, ct, bg, cfg.EfL,
                                           cfg.EfN, lam, cfg.Eft)
    from .hmm import H_STATS
    hmm.flags |= H_STATS
