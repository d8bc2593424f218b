"""A profile's probability tables in local multihit mode, worked out
from its save file (HMMER's p7_ProfileConfig, then the odds of the
Forward/Backward profile).

Lane k - 1 of every table is model position k.  Rows of ``tr``:
transitions into position k (B->M, M->M, I->M, D->M, M->D, D->D) or
out of it (M->I, I->I); a transition the local model lacks is 0.
Insert states emit with odds 1, every M and D state exits to E with
probability 1, and the N, J, C loops and moves follow each item's
length (``dp.length_model``).

``AMINO_FREQS`` is a frozen copy of the null model's residue
frequencies, ``bath_tpu_torch/bg.py:19-24`` at commit 520fb61 (HMMER's
Swiss-Prot 50.8 background): copied, not imported, so that the
yardstick does not follow later changes.
"""

from __future__ import annotations

import numpy as np

from .hmmfile import DD, DM, II, IM, MD, MI, MM, Hmm

AMINO_FREQS = np.array([
    0.0787945, 0.0151600, 0.0535222, 0.0668298, 0.0397062,
    0.0695071, 0.0229198, 0.0590092, 0.0594422, 0.0963728,
    0.0237718, 0.0414386, 0.0482904, 0.0395639, 0.0540978,
    0.0683364, 0.0540687, 0.0673417, 0.0114135, 0.0304133,
], dtype=np.float32)

# rows of ``tr``
T_BM, T_MM, T_IM, T_DM, T_MD, T_DD, T_MI, T_II = range(8)
NRES = 32           # emission rows: 20 residues, the rest odds 0


def tables(h: Hmm) -> tuple[np.ndarray, np.ndarray]:
    """(odds [NRES, M], tr [8, M]) in float64."""
    M = h.M
    odds = np.zeros((NRES, M))
    odds[:20] = (h.mat[1:] / AMINO_FREQS.astype(np.float64)).T
    t = h.t
    # local entry: occupancy of M_k over sum_k occ_k (M - k + 1)
    occ = np.zeros(M + 1)
    occ[1] = t[0, MM] + t[0, MI]
    for k in range(2, M + 1):
        occ[k] = occ[k - 1] * (t[k - 1, MM] + t[k - 1, MI]) \
            + (1.0 - occ[k - 1]) * t[k - 1, DM]
    Z = float(np.sum(occ[1:] * (M - np.arange(1, M + 1) + 1)))
    tr = np.zeros((8, M))
    tr[T_BM] = occ[1:] / Z
    # position k (lane k - 1) from node k - 1, k >= 2; node M's own
    # transitions go nowhere in the profile
    tr[T_MM, 1:] = t[1:M, MM]
    tr[T_IM, 1:] = t[1:M, IM]
    tr[T_MD, 1:] = t[1:M, MD]
    tr[T_MI, :M - 1] = t[1:M, MI]
    tr[T_II, :M - 1] = t[1:M, II]
    # D_1 does not exist in a local profile
    tr[T_DM, 2:] = t[2:M, DM]
    tr[T_DD, 2:] = t[2:M, DD]
    return odds, tr
