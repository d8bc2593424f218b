"""Compact score data for SSV diagonal recovery and window sizing.

Re-provides P7_SCOREDATA (ref: src/p7_scoredata.c):
8-bit SSV emission costs plus the MAXL-based prefix/suffix fractional
lengths used to extend SSV diagonals into DNA windows.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import constants as C
from .oprofile import OProfile


@dataclass
class ScoreData:
    M: int
    ssv_scores: np.ndarray       # [(M+1) * Kp] uint8, index Kp*k + x
    prefix_lengths: np.ndarray   # [M+1] float32 (cumulative fractions)
    suffix_lengths: np.ndarray   # [M+1] float32
    fwd_scores: np.ndarray       # [(M+1) * Kp] float32 log-odds
    Kp: int = 0


def score_data_create(om: OProfile) -> ScoreData:
    """ref: p7_hmm_ScoreDataCreate + p7_hmm_ScoreDataComputeRest
    (p7_scoredata.c:176, :312)."""
    M, Kp = om.M, om.Kp
    ssv = np.zeros((M + 1) * Kp, dtype=np.uint8)
    # ssv_scores[Kp*k + x] = rbv byte cost (GetSSVEmissionScoreArray)
    for x in range(Kp):
        ssv[Kp * np.arange(1, M + 1) + x] = om.rbv[x, 1:]

    # fwd emission log-odds (GetFwdEmissionScoreArray: log of rfv)
    fwd = np.full((M + 1) * Kp, -np.inf, dtype=np.float32)
    with np.errstate(divide="ignore"):
        for x in range(Kp):
            fwd[Kp * np.arange(1, M + 1) + x] = np.log(om.rfv[x, 1:])

    # prefix/suffix lengths (ScoreDataComputeRest :357-380)
    t_mis = om.tfv[:, C.P_MI].astype(np.float64)   # [M+1], index by k
    t_iis = om.tfv[:, C.P_II].astype(np.float64)
    beta = C.DEFAULT_WINDOW_BETA
    pre = np.zeros(M + 1, dtype=np.float64)
    s = 0.0
    for k in range(1, M):
        if t_mis[k] == 0.0:
            pre[k] = 1.0
        else:
            pre[k] = 1.0 + int(np.log(beta / t_mis[k]) / np.log(t_iis[k]))
        s += pre[k]
    pre[0] = pre[M] = 0.0
    pre[1:M] /= s
    suf = np.zeros(M + 1, dtype=np.float64)
    suf[M] = pre[M - 1]
    for k in range(M - 1, 0, -1):
        suf[k] = suf[k + 1] + pre[k - 1]
    for k in range(2, M):
        pre[k] += pre[k - 1]
    return ScoreData(M=M, ssv_scores=ssv,
                     prefix_lengths=pre.astype(np.float32),
                     suffix_lengths=suf.astype(np.float32),
                     fwd_scores=fwd, Kp=Kp)
