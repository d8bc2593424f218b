"""A plain reader of the profile files the benchmark searches with.

HMMER3/BATH3 save files: a header, then for every node k = 0..M a
line of match emissions (node 0: the COMPO line, optional), a line of
insert emissions and a line of transitions.  Values are negative
natural logs; ``*`` is probability zero.  Only what the reference's
dynamic programming needs is kept: the match emission probabilities,
the transition probabilities and, from the header, the frameshift
probability (``FRAMESHIFT PROB``, a profile that ``--fs`` searches) and
the genetic code (``CODON TABLE``), each None where the file has none.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

# transition columns of a node line, in file order (HMMER's p7H_*)
MM, MI, MD, IM, II, DM, DD = range(7)


@dataclass
class Hmm:
    name: str
    M: int
    mat: np.ndarray         # [M + 1, 20] f64, row k = match state k
    t: np.ndarray           # [M + 1, 7] f64, row k = out of node k
    fsprob: float | None = None
    ct: int | None = None


def _prob(field: str) -> float:
    return 0.0 if field == "*" else math.exp(-float(field))


def read_text(text: str) -> list[Hmm]:
    """Every profile of a save file's text, in file order."""
    out = []
    lines = iter(text.splitlines())
    for line in lines:
        if not line.strip():
            continue
        hdr = {}
        while not line.startswith("HMM "):
            tok = line.split(None, 1)
            if tok:
                hdr[tok[0]] = tok[1].strip() if len(tok) > 1 else ""
            line = next(lines)
        next(lines)                       # the transitions' header
        M = int(hdr["LENG"])
        mat = np.zeros((M + 1, 20))
        t = np.zeros((M + 1, 7))
        line = next(lines)
        if line.split()[0] == "COMPO":
            line = next(lines)            # node 0's insert emissions
        t[0] = [_prob(v) for v in next(lines).split()[:7]]
        for k in range(1, M + 1):
            tok = next(lines).split()
            if int(tok[0]) != k:
                raise ValueError(f"{hdr.get('NAME')}: node {tok[0]} "
                                 f"where {k} was due")
            mat[k] = [_prob(v) for v in tok[1:21]]
            next(lines)                   # insert emissions
            t[k] = [_prob(v) for v in next(lines).split()[:7]]
        if next(lines).strip() != "//":
            raise ValueError(f"{hdr.get('NAME')}: no '//' after node {M}")
        fs = hdr.get("FRAMESHIFT", "").split()
        ct = hdr.get("CODON", "").split()
        out.append(Hmm(hdr["NAME"], M, mat, t,
                       float(fs[1]) if fs[:1] == ["PROB"] else None,
                       int(ct[1]) if ct[:1] == ["TABLE"] else None))
    return out
