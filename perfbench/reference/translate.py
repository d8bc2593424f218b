"""Six-frame translation of a genome (NCBI translation table 1, the
configurations' ``--ct 1``) and the check that an item the device
stages scored is a stretch of it."""

from __future__ import annotations

import numpy as np

# NCBI table 1 with the bases in the order T, C, A, G
_TCAG = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
AMINO = "ACDEFGHIKLMNPQRSTVWY"


def _codon_letters() -> np.ndarray:
    """[64] letter codes of the codon 16 a + 4 b + c, bases A, C, G, T
    numbered 0-3."""
    to_tcag = {0: 2, 1: 1, 2: 3, 3: 0}
    out = np.zeros(64, np.uint8)
    for a in range(4):
        for b in range(4):
            for c in range(4):
                i = 16 * to_tcag[a] + 4 * to_tcag[b] + to_tcag[c]
                out[16 * a + 4 * b + c] = ord(_TCAG[i])
    return out


def six_frames(dna: str) -> list[str]:
    """The translations of the three frames of each strand ('*' at a
    stop codon)."""
    lut = np.full(256, 255, np.uint8)
    for i, ch in enumerate("ACGT"):
        lut[ord(ch)] = i
    plus = lut[np.frombuffer(dna.encode(), np.uint8)]
    if (plus == 255).any():
        raise ValueError("the genome holds a letter other than ACGT")
    minus = (3 - plus)[::-1]
    letters = _codon_letters()
    out = []
    for s in (plus, minus):
        for f in range(3):
            n = (len(s) - f) // 3
            c = s[f:f + 3 * n].reshape(n, 3).astype(np.int64)
            out.append(letters[16 * c[:, 0] + 4 * c[:, 1] + c[:, 2]]
                       .tobytes().decode())
    return out


def letters(residues) -> str:
    """Digital residues 0-19 as letters; any other code as '?', which
    no frame holds."""
    return "".join(AMINO[r] if 0 <= r < 20 else "?" for r in residues)


def in_frames(residues, frames: list[str], minlen: int) -> bool:
    """Whether <residues> are a stop-free stretch of at least <minlen>
    residues of one of <frames>."""
    s = letters(residues)
    return len(s) >= minlen and any(s in f for f in frames)
