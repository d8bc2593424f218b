"""The core profile HMM data model.

Re-provides the reference's P7_HMM (ref: src/hmmer.h:155-194,
p7_hmm.c) as plain numpy arrays.  Probabilities, not scores; node 0 is
the special B-node per Plan7 convention.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import constants as C
from .alphabet import Alphabet, amino


# flags (ref: hmmer.h p7H_*)
H_HASBITS = 1 << 0
H_DESC = 1 << 1
H_RF = 1 << 2
H_CS = 1 << 3
H_XRAY = 1 << 4
H_HASPROB = 1 << 5
H_HASDNA = 1 << 6
H_STATS = 1 << 7
H_MAP = 1 << 8
H_ACC = 1 << 9
H_GA = 1 << 10
H_TC = 1 << 11
H_NC = 1 << 12
H_CA = 1 << 13
H_COMPO = 1 << 14
H_CHKSUM = 1 << 15
H_CONS = 1 << 16
H_MMASK = 1 << 17


@dataclass
class HMM:
    """Core model.  t[k][7] transitions (MM,MI,MD,IM,II,DM,DD order as in
    constants.H_*), mat/ins[k][K] emissions, k=0..M with node-0
    conventions: mat[0]=[1,0..], t[0][MM/MI/MD] = B transitions."""
    M: int
    abc: Alphabet
    t: np.ndarray           # [M+1, 7] float32
    mat: np.ndarray         # [M+1, K] float32
    ins: np.ndarray         # [M+1, K] float32
    name: str = ""
    acc: str = ""
    desc: str = ""
    rf: str = ""            # 1..M reference annotation ('' if unused)
    mm: str = ""
    consensus: str = ""
    cs: str = ""
    ca: str = ""
    comlog: list = field(default_factory=list)
    nseq: int = -1
    eff_nseq: float = -1.0
    max_length: int = -1
    ctime: str = ""
    map: np.ndarray | None = None     # [M+1] int alignment map
    checksum: int = 0
    evparam: np.ndarray = field(
        default_factory=lambda: np.full(C.NEVPARAM, C.EVPARAM_UNSET,
                                        dtype=np.float32))
    cutoff: np.ndarray = field(
        default_factory=lambda: np.full(C.NCUTOFFS, C.CUTOFF_UNSET,
                                        dtype=np.float32))
    compo: np.ndarray | None = None   # [K] float32 model composition
    offset: int = -1
    flags: int = 0
    # BATH extensions (ref: hmmer.h:161-163)
    fs: bool = False
    fsprob: float = 0.0
    ct: int = 0              # NCBI codon translation table id

    @classmethod
    def zeros(cls, M: int, abc: Alphabet | None = None) -> "HMM":
        abc = abc or amino()
        return cls(M=M, abc=abc,
                   t=np.zeros((M + 1, 7), dtype=np.float32),
                   mat=np.zeros((M + 1, abc.K), dtype=np.float32),
                   ins=np.zeros((M + 1, abc.K), dtype=np.float32))

    # ref: p7_hmm.c p7_hmm_CalculateOccupancy
    def calculate_occupancy(self) -> tuple[np.ndarray, np.ndarray]:
        """Return (mocc[0..M], iocc[0..M]): match-state occupancy and
        expected insert-state use counts (float32 recurrence as in C)."""
        M, t = self.M, self.t.astype(np.float32)
        mocc = np.zeros(M + 1, dtype=np.float32)
        iocc = np.zeros(M + 1, dtype=np.float32)
        mocc[1] = t[0, C.H_MI] + t[0, C.H_MM]
        for k in range(2, M + 1):
            mocc[k] = (mocc[k - 1] * (t[k - 1, C.H_MM] + t[k - 1, C.H_MI])
                       + (np.float32(1.0) - mocc[k - 1]) * t[k - 1, C.H_DM])
        # C divides freely here (0/0 -> NaN, x/0 -> inf, silently);
        # match that without numpy's RuntimeWarning noise
        with np.errstate(divide="ignore", invalid="ignore"):
            iocc[0] = t[0, C.H_MI] / t[0, C.H_IM]
            for k in range(1, M + 1):
                iocc[k] = mocc[k] * t[k, C.H_MI] / t[k, C.H_IM]
        return mocc, iocc

    # ref: p7_hmm.c p7_hmm_SetComposition
    def set_composition(self):
        mocc, iocc = self.calculate_occupancy()
        compo = self.ins[0] * iocc[0]
        for k in range(1, self.M + 1):
            compo = compo + self.mat[k] * mocc[k] + self.ins[k] * iocc[k]
        self.compo = (compo / compo.sum()).astype(np.float32)
        self.flags |= H_COMPO

    # ref: p7_builder.c p7_Builder_MaxLength
    def set_max_length(self, emit_thresh: float = C.DEFAULT_WINDOW_BETA):
        """DP over emitted-length distribution of glocal paths; sets
        max_length to the smallest L with surviving mass < thresh."""
        M = self.M
        if M == 1:
            self.max_length = 1
            return
        t = self.t.astype(np.float64)
        bound = max(M, min(20 * M, 100000))
        from .native import hmm_max_length_native
        ml = hmm_max_length_native(t, M, bound, emit_thresh)
        if ml is not None:
            self.max_length = ml
            return
        self.max_length = bound
        Mv = np.zeros((M + 1, 2)); Iv = np.zeros((M + 1, 2)); Dv = np.zeros((M + 1, 2))
        # column 1
        Mv[1, 0] = 1.0
        Dv[2, 0] = t[1, C.H_MD]
        for k in range(3, M + 1):
            Dv[k, 0] = t[k - 1, C.H_DD] * Dv[k - 1, 0]
        # column 2
        Iv[1, 1] = t[1, C.H_MI] * Mv[1, 0]
        Mv[2, 1] = t[1, C.H_MM] * Mv[1, 0]
        for k in range(3, M + 1):
            Mv[k, 1] = t[k - 1, C.H_DM] * Dv[k - 1, 0]
            Dv[k, 1] = t[k - 1, C.H_MD] * Mv[k - 1, 1] + t[k - 1, C.H_DD] * Dv[k - 1, 1]
        p_sum = Mv[M, 0] + Mv[M, 1] + Dv[M, 0] + Dv[M, 1]
        cp = 0
        for col in range(3, bound + 1):
            pp = 1 - cp
            surv = 0.0
            Mv[1, cp] = Dv[1, cp] = 0.0
            Iv[1, cp] = t[1, C.H_II] * Iv[1, pp]
            surv += Iv[1, cp]
            for k in range(2, M + 1):
                Mv[k, cp] = (t[k - 1, C.H_MM] * Mv[k - 1, pp]
                             + t[k - 1, C.H_DM] * Dv[k - 1, pp]
                             + t[k - 1, C.H_IM] * Iv[k - 1, pp])
                Iv[k, cp] = t[k, C.H_MI] * Mv[k, pp] + t[k, C.H_II] * Iv[k, pp]
                Dv[k, cp] = t[k - 1, C.H_MD] * Mv[k - 1, cp] + t[k - 1, C.H_DD] * Dv[k - 1, cp]
                surv += (Iv[k, cp] + Mv[k, cp] * (1 - t[k, C.H_MD])
                         + Dv[k, cp] * (1 - t[k, C.H_DD]))
            surv += (Mv[M, cp] * t[M, C.H_MD] + Dv[M, cp] * t[M, C.H_DD]
                     - Iv[M, cp])
            p_sum += Mv[M, cp] + Dv[M, cp]
            surv /= surv + p_sum
            if surv < emit_thresh:
                self.max_length = col
                break
            cp = pp
