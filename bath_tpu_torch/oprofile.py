"""Optimized profile: the quantized and probability-space score sets
used by the acceleration filters.

Re-provides P7_OPROFILE's three score systems (ref:
src/impl_sse/p7_oprofile.c) in dense k-contiguous
layout (the reference's striping is a CPU-SIMD artifact; the
quantization itself is what determines filter behavior and is
reproduced bit-for-bit):

  MSV (8-bit):  rbv[Kp, M+1] uint8 costs, scale_b=3/log2, base_b=190,
                bias_b; tbm_b/tec_b/tjb_b specials (mf_conversion :791)
  SSV (8-bit):  sbv[Kp, M+1] int8 = rbv - bias (sf_conversion :708)
  VF (16-bit):  rwv[Kp, M+1] int16, twv[M, 8] int16, xw[4][2],
                scale_w=500/log2, base_w=12000, ddbound_w
                (vf_conversion :826)
  FB (float):   rfv[Kp, M+1] float32 odds ratios, tfv[M, 8] float32,
                xf[4][2] (fb_conversion :926)
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import constants as C
from .profile import Profile


def _round_c(x: np.ndarray) -> np.ndarray:
    """C roundf: round half away from zero."""
    return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5))


@dataclass
class OProfile:
    M: int
    Kp: int
    # MSV part
    scale_b: float
    base_b: int
    bias_b: int
    rbv: np.ndarray            # [Kp, M+1] uint8 (column 0 = 255)
    sbv: np.ndarray            # [Kp, M+1] int8
    tbm_b: int = 0
    tec_b: int = 0
    tjb_b: int = 0
    # Viterbi filter part
    scale_w: float = 500.0 / C.CONST_LOG2
    base_w: int = 12000
    ddbound_w: int = -32768
    rwv: np.ndarray | None = None     # [Kp, M+1] int16
    twv: np.ndarray | None = None     # [M, 8] int16 (k-order, same slots as tsc)
    xw: np.ndarray | None = None      # [4, 2] int16
    # Forward/Backward part (prob space)
    rfv: np.ndarray | None = None     # [Kp, M+1] float32 odds ratios
    tfv: np.ndarray | None = None     # [M, 8] float32
    xf: np.ndarray | None = None      # [4, 2] float32
    # config
    mode: int = C.P7_LOCAL
    L: int = 0
    nj: float = 1.0
    max_length: int = -1
    name: str = ""
    compo: np.ndarray | None = None
    evparam: np.ndarray | None = None

    # ref: unbiased_byteify (p7_oprofile.c:683)
    def _unbiased_byteify(self, sc: float) -> int:
        cost = -float(_round_c(np.float32(self.scale_b) * np.float32(sc)))
        return 255 if cost > 255.0 else int(cost) & 0xFF

    # ref: p7_oprofile_ReconfigMSVLength
    def reconfig_msv_length(self, L: int):
        self.tjb_b = self._unbiased_byteify(np.log(3.0 / (L + 3.0)))

    # ref: p7_oprofile_ReconfigRestLength
    def reconfig_rest_length(self, L: int):
        pmove = (np.float32(2.0) + np.float32(self.nj)) / (
            np.float32(L) + np.float32(2.0) + np.float32(self.nj))
        ploop = np.float32(1.0) - pmove
        for s in (C.X_N, C.X_C, C.X_J):
            self.xf[s, C.LOOP] = ploop
            self.xf[s, C.MOVE] = pmove
            self.xw[s, C.MOVE] = _wordify(self.scale_w, np.log(pmove))
            # xw LOOP stays 0: the -3nat NN/CC/JJ approximation
        self.L = L

    def reconfig_length(self, L: int):
        # memoized: ORF lengths repeat heavily, and the per-call
        # quantization (roundf emulation) dominated the e2e profile
        key = (L, self.nj)
        cache = self.__dict__.setdefault("_len_cache", {})
        ent = cache.get(key)
        if ent is None:
            tjb = self._unbiased_byteify(np.log(3.0 / (L + 3.0)))
            pmove = (np.float32(2.0) + np.float32(self.nj)) / (
                np.float32(L) + np.float32(2.0) + np.float32(self.nj))
            ploop = np.float32(1.0) - pmove
            xw_move = _wordify(self.scale_w, np.log(pmove))
            ent = (tjb, pmove, ploop, xw_move)
            cache[key] = ent
        tjb, pmove, ploop, xw_move = ent
        self.tjb_b = tjb
        for s in (C.X_N, C.X_C, C.X_J):
            self.xf[s, C.LOOP] = ploop
            self.xf[s, C.MOVE] = pmove
            self.xw[s, C.MOVE] = xw_move
        self.L = L

    # ref: p7_oprofile_ReconfigUnihit / ReconfigMultihit
    def reconfig_unihit(self, L: int):
        self.xf[C.X_E, C.MOVE] = 1.0
        self.xf[C.X_E, C.LOOP] = 0.0
        if self.xw is not None:
            self.xw[C.X_E, C.MOVE] = 0
            self.xw[C.X_E, C.LOOP] = -32768
        self.nj = 0.0
        self.reconfig_length(L)

    def reconfig_multihit(self, L: int):
        self.xf[C.X_E, C.MOVE] = 0.5
        self.xf[C.X_E, C.LOOP] = 0.5
        if self.xw is not None:
            self.xw[C.X_E, C.MOVE] = _wordify(self.scale_w, np.log(0.5))
            self.xw[C.X_E, C.LOOP] = _wordify(self.scale_w, np.log(0.5))
        self.nj = 1.0
        self.reconfig_length(L)


def _wordify(scale_w: float, sc) -> int:
    sc = float(_round_c(np.float32(scale_w) * np.float32(sc)))
    if sc >= 32767.0:
        return 32767
    if sc <= -32768.0:
        return -32768
    return int(sc)


def oprofile_convert(gm: Profile) -> OProfile:
    """Convert a configured Profile to quantized + pspace score sets
    (ref: p7_oprofile_Convert -> mf/vf/fb_conversion)."""
    M, Kp = gm.M, gm.abc.Kp
    K = gm.abc.K
    msc = gm.msc            # [Kp, M+1] float32

    # ---- MSV bytes (mf_conversion) ----
    scale_b = 3.0 / C.CONST_LOG2
    base_b = 190
    # max over canonical residues and all k (incl. the 0-valued insert
    # slots the C scan covers, so floor at 0.0)
    mx = max(0.0, float(np.max(msc[:K, :])))
    bias_cost = -float(_round_c(np.float32(scale_b) * np.float32(-mx)))
    bias_b = 255 if bias_cost > 255.0 else int(bias_cost)

    with np.errstate(invalid="ignore"):
        cost = -_round_c(np.float64(scale_b) * msc.astype(np.float64))
    rbv = np.where(np.isnan(cost) | (cost > 255.0 - bias_b), 255.0,
                   cost + bias_b)
    rbv = np.where(np.isinf(msc), 255.0, rbv).astype(np.uint8)
    rbv[:, 0] = 255
    # non-canonical rows: gap(K), nonres(Kp-2), missing(Kp-1) are 255;
    # degenerates got real expected scores (biased_byteify'd above)
    rbv[K, :] = 255
    rbv[Kp - 2, :] = 255
    rbv[Kp - 1, :] = 255

    # ---- SSV signed bytes (sf_conversion: ((127+bias)-rbv)^127) ----
    t = np.maximum(0, (127 + bias_b) - rbv.astype(np.int32))  # subs_epu8
    sbv = (t.astype(np.uint8) ^ np.uint8(127)).astype(np.int8)

    om = OProfile(M=M, Kp=Kp, scale_b=scale_b, base_b=base_b, bias_b=bias_b,
                  rbv=rbv, sbv=sbv, mode=gm.mode, L=gm.L, nj=gm.nj,
                  max_length=gm.max_length, name=gm.name,
                  compo=None if gm.compo is None else gm.compo.copy(),
                  evparam=None if gm.evparam is None else gm.evparam.copy())
    om.tbm_b = om._unbiased_byteify(np.log(np.float32(2.0) / (np.float32(M) * np.float32(M + 1))))
    om.tec_b = om._unbiased_byteify(np.log(0.5))
    om.tjb_b = om._unbiased_byteify(np.log(3.0 / (gm.L + 3.0)))

    # ---- Viterbi filter words (vf_conversion) ----
    scale_w = om.scale_w
    with np.errstate(invalid="ignore"):
        w = _round_c(np.float64(scale_w) * msc.astype(np.float64))
    rwv = np.where(np.isinf(msc) | np.isnan(w), -32768.0,
                   np.clip(w, -32768, 32767)).astype(np.int16)
    rwv[:, 0] = -32768
    rwv[K, :] = -32768
    rwv[Kp - 2, :] = -32768
    rwv[Kp - 1, :] = -32768

    twv = np.full((M + 1, C.NTRANS), -32768, dtype=np.int16)
    tsc = gm.tsc
    # k-order transition words with the same per-slot saturation rules:
    # II capped at -1, everything else at 0 (vf_conversion maxval) —
    # vectorized with the same f32 round-half-away quantization
    with np.errstate(invalid="ignore"):
        wq = _round_c(np.float32(scale_w)
                      * tsc[:M].astype(np.float32)).astype(np.float64)
    vals = np.where(wq >= 32767.0, 32767, np.where(
        wq <= -32768.0, -32768, wq)).astype(np.int32)
    vals = np.where(np.isinf(tsc[:M]), -32768, vals)
    maxval = np.zeros(C.NTRANS, np.int32)
    maxval[C.P_II] = -1
    twv[:M] = np.minimum(vals, maxval[None, :]).astype(np.int16)
    om.rwv, om.twv = rwv, twv

    xw = np.zeros((4, 2), dtype=np.int16)
    xw[C.X_E, C.LOOP] = _wordify(scale_w, gm.xsc[C.X_E, C.LOOP]) \
        if np.isfinite(gm.xsc[C.X_E, C.LOOP]) else -32768
    xw[C.X_E, C.MOVE] = _wordify(scale_w, gm.xsc[C.X_E, C.MOVE])
    xw[C.X_N, C.MOVE] = _wordify(scale_w, gm.xsc[C.X_N, C.MOVE])
    xw[C.X_C, C.MOVE] = _wordify(scale_w, gm.xsc[C.X_C, C.MOVE])
    xw[C.X_J, C.MOVE] = _wordify(scale_w, gm.xsc[C.X_J, C.MOVE])
    # N/C/J LOOP = 0 (the -3 nat approximation, ref vf_conversion :897)
    om.xw = xw

    # ddbound (ref vf_conversion :915-921)
    ddb = -32768
    for k in range(2, M - 1):
        v = (_wordify(scale_w, tsc[k, C.P_DD])
             + _wordify(scale_w, tsc[k + 1, C.P_DM])
             - _wordify(scale_w, tsc[k + 1, C.P_BM]))
        ddb = max(ddb, v)
    om.ddbound_w = ddb

    # ---- Forward/Backward floats (fb_conversion: pspace odds) ----
    om.rfv = np.exp(msc.astype(np.float32))
    om.rfv[:, 0] = 0.0
    tfv = np.zeros((M + 1, C.NTRANS), dtype=np.float32)
    tfv[:M] = np.exp(tsc)
    om.tfv = tfv
    om.xf = np.exp(gm.xsc.astype(np.float32))
    om.reconfig_length(gm.L)
    return om
