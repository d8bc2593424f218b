"""Digital biosequence alphabets (amino, DNA).

Re-provides the subset of Easel's ESL_ALPHABET functionality that the
reference framework depends on (sequence digitization, degeneracy
maps, expected-score vectors).  Data layout follows Easel's
conventions so profile/score array indices line up with the
reference's `.bhmm` files and golden outputs:

  0..K-1      canonical residues
  K           gap '-'
  K+1..Kp-3   degenerate residues (last one, Kp-3, is the 'any' char)
  Kp-2        nonresidue ('*')
  Kp-1        missing data ('~')
"""

from __future__ import annotations

import numpy as np

AMINO = "amino"
DNA = "dna"


class Alphabet:
    def __init__(self, kind: str):
        self.kind = kind
        if kind == AMINO:
            # Easel eslAMINO: K=20, Kp=29.
            self.sym = "ACDEFGHIKLMNPQRSTVWY-BJZOUX*~"
            self.K, self.Kp = 20, 29
            degen = {
                "B": "DN", "J": "IL", "Z": "EQ",
                "O": "K", "U": "C",
                "X": "ACDEFGHIKLMNPQRSTVWY",
            }
        elif kind == DNA:
            # Easel eslDNA: K=4, Kp=18.
            self.sym = "ACGT-RYMKSWHBVDN*~"
            self.K, self.Kp = 4, 18
            degen = {
                "R": "AG", "Y": "CT", "M": "AC", "K": "GT",
                "S": "CG", "W": "AT", "H": "ACT", "B": "CGT",
                "V": "ACG", "D": "AGT", "N": "ACGT",
            }
        else:
            raise ValueError(kind)

        assert len(self.sym) == self.Kp
        self.index = {c: i for i, c in enumerate(self.sym)}
        # degeneracy membership matrix [Kp, K]
        self.degen = np.zeros((self.Kp, self.K), dtype=bool)
        for i in range(self.K):
            self.degen[i, i] = True
        for c, members in degen.items():
            for m in members:
                self.degen[self.index[c], self.index[m]] = True

        # input mapping for digitization (case-insensitive; a few synonyms)
        self.inmap = {}
        for c, i in self.index.items():
            self.inmap[c] = i
            self.inmap[c.lower()] = i
        self.inmap["_"] = self.index["-"]
        self.inmap["."] = self.index["-"]
        if kind == DNA:
            self.inmap["U"] = self.index["T"]
            self.inmap["u"] = self.index["T"]
            self.inmap["X"] = self.index["N"]
            self.inmap["x"] = self.index["N"]
        else:
            self.inmap["*"] = self.index["*"]

        # fast byte-level digitizer table (255 = invalid)
        self._dig = np.full(256, 255, dtype=np.uint8)
        for c, i in self.inmap.items():
            self._dig[ord(c)] = i

    # -- digitization ------------------------------------------------
    def digitize(self, seq: str) -> np.ndarray:
        """Text sequence -> digital codes (0-based numpy array, no sentinels)."""
        b = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
        d = self._dig[b]
        if (d == 255).any():
            bad = chr(b[int(np.argmax(d == 255))])
            raise ValueError(f"invalid {self.kind} residue {bad!r}")
        return d.astype(np.int32)

    def textize(self, dsq: np.ndarray) -> str:
        return "".join(self.sym[int(x)] for x in dsq)

    def is_canonical(self, x) -> bool:
        return 0 <= x < self.K

    @property
    def any_idx(self) -> int:
        """The 'fully ambiguous' residue (X for amino, N for DNA): Kp-3."""
        return self.Kp - 3

    # -- degenerate score expectation (ref: esl_abc_FExpectScVec) ----
    def expect_score_vec(self, sc: np.ndarray, p: np.ndarray) -> np.ndarray:
        """Fill scores for degenerate residues K+1..Kp-3 with the
        p-weighted average over their canonical members, matching
        Easel's esl_abc_FExpectScVec (float32 arithmetic).

        sc: [Kp] float array with canonical scores in 0..K-1.
        Returns a new array; gap/nonres/missing entries are untouched.
        """
        out = np.array(sc, dtype=np.float32, copy=True)
        for x in range(self.K + 1, self.Kp - 2):
            mem = self.degen[x, : self.K]
            denom = np.float32(p[: self.K][mem].astype(np.float32).sum())
            num = np.float32(
                (sc[: self.K][mem].astype(np.float32)
                 * p[: self.K][mem].astype(np.float32)).sum())
            out[x] = num / denom
        return out


_CACHE: dict[str, Alphabet] = {}


def get_alphabet(kind: str) -> Alphabet:
    if kind not in _CACHE:
        _CACHE[kind] = Alphabet(kind)
    return _CACHE[kind]


def amino() -> Alphabet:
    return get_alphabet(AMINO)


def dna() -> Alphabet:
    return get_alphabet(DNA)


# DNA complement in digital space (canonical A<->T, C<->G; degenerates map
# to their complementary degeneracy class; gap/nonres/missing unchanged).
def dna_complement_table() -> np.ndarray:
    a = dna()
    comp_sym = {"A": "T", "C": "G", "G": "C", "T": "A", "-": "-",
                "R": "Y", "Y": "R", "M": "K", "K": "M", "S": "S",
                "W": "W", "H": "D", "B": "V", "V": "B", "D": "H",
                "N": "N", "*": "*", "~": "~"}
    tbl = np.arange(a.Kp, dtype=np.int32)
    for c, cc in comp_sym.items():
        tbl[a.index[c]] = a.index[cc]
    return tbl


def revcomp(dsq: np.ndarray) -> np.ndarray:
    return dna_complement_table()[dsq][::-1].copy()
