"""Sampling sequences from a model (ref: emit.c p7_CoreEmit :43,
p7_ProfileEmit :173; used by the reference's unit tests and the
hmmemit program).
"""

from __future__ import annotations

import numpy as np

from . import constants as C
from .hmm import HMM
from .rng import Randomness


def core_emit(r: Randomness, hmm: HMM) -> tuple[np.ndarray, list]:
    """Sample one sequence from the core model B->...->E.  Returns
    (digital seq, trace [(state, k)] with state in 'MID').

    Core-model semantics: node k's M/B state chooses t[k][MM,MI,MD];
    I chooses t[k][IM,II]; D chooses t[k][DM,DD]; advancing past node
    M reaches E (t[M][MD] = t[M][DD] = 0 by convention)."""
    seq: list[int] = []
    tr: list[tuple[str, int]] = []
    st, k = "M", 0              # node 0 == B
    while True:
        if st == "M":
            roll = r.f_choose(hmm.t[k, 0:3].astype(np.float64))
            nxt = ("M", "I", "D")[roll]
        elif st == "I":
            roll = r.f_choose(hmm.t[k, 3:5].astype(np.float64))
            nxt = ("M", "I")[roll]
        else:
            roll = r.f_choose(hmm.t[k, 5:7].astype(np.float64))
            nxt = ("M", "D")[roll]
        if nxt == "I":
            seq.append(r.f_choose(hmm.ins[k].astype(np.float64)))
            tr.append(("I", k))
            st = "I"
            continue
        k += 1
        if k > hmm.M:
            return np.array(seq, dtype=np.int32), tr      # reached E
        if nxt == "M":
            seq.append(r.f_choose(hmm.mat[k].astype(np.float64)))
            tr.append(("M", k))
            st = "M"
        else:
            tr.append(("D", k))
            st = "D"


def profile_emit(r: Randomness, hmm: HMM, bg, L: int = 0
                 ) -> np.ndarray:
    """Sample from the search profile: N-tail, one or more core
    passes (multihit via J), C-tail; N/C/J emit iid background
    residues with the L-length geometric model
    (ref: p7_ProfileEmit :173, simplified to multihit local)."""
    nj = 1.0
    pmove = (2.0 + nj) / (L + 2.0 + nj) if L > 0 else 0.5
    seq: list[int] = []

    def tail():
        while r.random() >= pmove:
            seq.append(r.f_choose(bg.f.astype(np.float64)))

    tail()                                  # N
    while True:
        core, _ = core_emit(r, hmm)
        seq.extend(int(x) for x in core)
        if r.random() < 0.5:                # E->C (multihit)
            break
        tail()                              # J
    tail()                                  # C
    return np.array(seq, dtype=np.int32)
