"""Reverse codon table: amino acid -> list of synonymous codons.

Used by calibration to reverse-translate random amino sequences into
DNA for the frameshift tau simulations (ref: hmmer.c
p7_codontable_Create :198, p7_codontable_GetCodon :258).
"""

from __future__ import annotations

import numpy as np

from .gencode import GeneticCode
from .rng import Randomness


class CodonTable:
    """amino (digital) -> codons (list of [3] nt arrays), in the
    reference's enumeration order x,y,z over the 4 nucleotides."""

    def __init__(self, gcode: GeneticCode):
        self.transl_table = gcode.transl_table
        K = gcode.aa_abc.K
        self.K = K
        self.codons: list[list[np.ndarray]] = [[] for _ in range(K)]
        for x in range(4):
            for y in range(4):
                for z in range(4):
                    a = int(gcode.basic[16 * x + 4 * y + z])
                    if a < K:
                        self.codons[a].append(
                            np.array([x, y, z], dtype=np.int32))

    def get_codon(self, r: Randomness, amino: int) -> np.ndarray:
        opts = self.codons[amino]
        if not opts:
            raise ValueError(f"amino {amino} has no codons")
        return opts[r.roll(len(opts))]

    def reverse_translate(self, r: Randomness,
                          amino_dsq: np.ndarray) -> np.ndarray:
        """Random synonymous reverse translation, [L] aminos -> [3L]
        nucleotides (ref: evalues.c p7_fs_Tau_* inner loop)."""
        out = np.empty(3 * len(amino_dsq), dtype=np.int32)
        for i, a in enumerate(amino_dsq):
            out[3 * i:3 * i + 3] = self.get_codon(r, int(a))
        return out
