"""Substitution score matrices and their probabilistic inversion
(ref: p7_builder.c p7_builder_SetScoreSystem :286; easel
esl_scorematrix ProbifyGivenBG / JointToConditionalOnQuery semantics).

Used by the single-sequence builder: BLOSUM62 scores are
back-calculated into conditional substitution probabilities
P(b | a) given background frequencies.  BLOSUM62 is public data
(Henikoff & Henikoff 1992).
"""

from __future__ import annotations

import numpy as np

# BLOSUM62, rows/cols in Easel amino order ACDEFGHIKLMNPQRSTVWY
_BLOSUM62 = """
 4  0 -2 -1 -2  0 -2 -1 -1 -1 -1 -2 -1 -1 -1  1  0  0 -3 -2
 0  9 -3 -4 -2 -3 -3 -1 -3 -1 -1 -3 -3 -3 -3 -1 -1 -1 -2 -2
-2 -3  6  2 -3 -1 -1 -3 -1 -4 -3  1 -1  0 -2  0 -1 -3 -4 -3
-1 -4  2  5 -3 -2  0 -3  1 -3 -2  0 -1  2  0  0 -1 -2 -3 -2
-2 -2 -3 -3  6 -3 -1  0 -3  0  0 -3 -4 -3 -3 -2 -2 -1  1  3
 0 -3 -1 -2 -3  6 -2 -4 -2 -4 -3  0 -2 -2 -2  0 -2 -3 -2 -3
-2 -3 -1  0 -1 -2  8 -3 -1 -3 -2  1 -2  0  0 -1 -2 -3 -2  2
-1 -1 -3 -3  0 -4 -3  4 -3  2  1 -3 -3 -3 -3 -2 -1  3 -3 -1
-1 -3 -1  1 -3 -2 -1 -3  5 -2 -1  0 -1  1  2  0 -1 -2 -3 -2
-1 -1 -4 -3  0 -4 -3  2 -2  4  2 -3 -3 -2 -2 -2 -1  1 -2 -1
-1 -1 -3 -2  0 -3 -2  1 -1  2  5 -2 -2  0 -1 -1 -1  1 -1 -1
-2 -3  1  0 -3  0  1 -3  0 -3 -2  6 -2  0  0  1  0 -3 -4 -2
-1 -3 -1 -1 -4 -2 -2 -3 -1 -3 -2 -2  7 -1 -2 -1 -1 -2 -4 -3
-1 -3  0  2 -3 -2  0 -3  1 -2  0  0 -1  5  1  0 -1 -2 -2 -1
-1 -3 -2  0 -3 -2  0 -3  2 -2 -1  0 -2  1  5 -1 -1 -3 -3 -2
 1 -1  0  0 -2  0 -1 -2  0 -2 -1  1 -1  0 -1  4  1 -2 -3 -2
 0 -1 -1 -1 -2 -2 -2 -1 -1 -1 -1  0 -1 -1 -1  1  5  0 -2 -2
 0 -1 -3 -2 -1 -3 -3  3 -2  1  1 -3 -2 -2 -3 -2  0  4 -3 -1
-3 -2 -4 -3  1 -2 -2 -3 -3 -2 -1 -4 -4 -2 -3 -3 -2 -3 11  2
-2 -2 -3 -2  3 -3  2 -1 -2 -1 -1 -2 -3 -1 -2 -2 -2 -1  2  7
"""


def blosum62() -> np.ndarray:
    """[20, 20] int scores in Easel amino order."""
    rows = [r.split() for r in _BLOSUM62.strip().split("\n")]
    return np.array(rows, dtype=np.float64)


def probify_given_bg(S: np.ndarray, f: np.ndarray
                     ) -> tuple[float, np.ndarray]:
    """Solve sum_ab f_a f_b exp(lambda s_ab) = 1 for lambda > 0, and
    return (lambda, joint q_ab) (ref: esl_scorematrix_ProbifyGivenBG
    semantics)."""
    f = np.asarray(f, dtype=np.float64)
    ff = np.outer(f, f)

    def g(lam):
        return (ff * np.exp(lam * S)).sum() - 1.0

    lo, hi = 1e-6, 1.0
    while g(hi) < 0:
        hi *= 2.0
        if hi > 100:
            raise ValueError("no lambda solution for score matrix")
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        if g(mid) > 0:
            hi = mid
        else:
            lo = mid
    lam = 0.5 * (lo + hi)
    q = ff * np.exp(lam * S)
    return lam, q / q.sum()


def blosum62_conditionals(f: np.ndarray) -> np.ndarray:
    """P(b | a) matrix [20, 20] from BLOSUM62 given background <f>
    (ref: esl_scorematrix_JointToConditionalOnQuery)."""
    return matrix_conditionals(blosum62(), f)


def matrix_conditionals(S: np.ndarray, f: np.ndarray) -> np.ndarray:
    """P(b | a) matrix [20, 20] from an arbitrary score matrix given
    background <f> (ref: esl_scorematrix_JointToConditionalOnQuery)."""
    _, q = probify_given_bg(S, f)            # lambda absorbs the
    return q / q.sum(axis=1, keepdims=True)  # half-bit score units


# Easel canonical amino order
AA_ORDER = "ACDEFGHIKLMNPQRSTVWY"


def read_matrix_file(path: str) -> np.ndarray:
    """Parse an NCBI/Easel-format substitution matrix file into a
    [20, 20] array in Easel amino order (ref: bathsearch --mxfile,
    esl_scorematrix_Read semantics).  Extra rows/columns (B, Z, X,
    '*') are ignored."""
    lines = [ln for ln in open(path)
             if ln.strip() and not ln.lstrip().startswith("#")]
    if not lines:
        raise ValueError(f"empty score matrix file {path}")
    cols = [c.upper() for c in lines[0].split()]
    scores: dict[tuple[str, str], float] = {}
    for ln in lines[1:]:
        parts = ln.split()
        row = parts[0].upper()
        for c, v in zip(cols, parts[1:]):
            scores[(row, c)] = float(v)
    S = np.zeros((20, 20), dtype=np.float64)
    for i, a in enumerate(AA_ORDER):
        for j, b in enumerate(AA_ORDER):
            if (a, b) not in scores:
                raise ValueError(
                    f"score matrix file {path} is missing {a}x{b}")
            S[i, j] = scores[(a, b)]
    return S


def named_matrix(name: str) -> np.ndarray:
    """Built-in matrix by name (ref: bathsearch --mx).  BLOSUM62 is
    bundled; other choices must come via --mxfile."""
    if name.upper() == "BLOSUM62":
        return blosum62()
    raise ValueError(
        f"substitution matrix '{name}' is not bundled; supply it "
        "with --mxfile instead")
