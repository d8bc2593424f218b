"""Trace-based MSA reconstruction: rebuild an annotated alignment
from the builder's (doctored) faux traces, for bathbuild -O
(ref: tracealign.c p7_tracealign_MSA, p7_builder.c make_post_msa
:371-378).

Column layout: [ins0][M1][ins1]...[MM][insM], where each insert block
is sized to the longest insertion any sequence makes at that node and
insertions are left-justified.  Match-state residues are uppercase,
insert-state residues lowercase; '-' marks deletions in match
columns, '.' fills unused insert slots.  The #=GC RF line marks
match columns with 'x'.
"""

from __future__ import annotations

import numpy as np

from .builder import ST_I, ST_M
from .msa import MSA


def tracealign_msa(msa: MSA, traces: list) -> tuple[list[str],
                                                    list[str], str]:
    """Returns (names, text rows, rf line) for the post alignment."""
    abc = msa.abc
    M = max((kk[z] for _, kk, _ in traces for z in range(len(kk))),
            default=0)
    maxins = np.zeros(M + 1, dtype=np.int64)
    for st, kk, ii in traces:
        run, runk = 0, 0
        for z in range(len(st)):
            if st[z] == ST_I:
                if run == 0:
                    runk = kk[z]
                run += 1
            else:
                if run:
                    maxins[runk] = max(maxins[runk], run)
                run = 0
        if run:
            maxins[runk] = max(maxins[runk], run)

    # column offsets
    matcol = np.zeros(M + 1, dtype=np.int64)   # 1-based node -> col
    inscol = np.zeros(M + 1, dtype=np.int64)   # node -> insert start
    pos = 0
    inscol[0] = 0
    pos += maxins[0]
    for k in range(1, M + 1):
        matcol[k] = pos
        pos += 1
        inscol[k] = pos
        pos += maxins[k]
    alen = pos

    rows = []
    for idx, (st, kk, ii) in enumerate(traces):
        buf = np.full(alen, ".", dtype="<U1")
        buf[matcol[1:M + 1]] = "-"
        nins = 0
        lastk = -1
        for z in range(len(st)):
            if st[z] == ST_M:
                x = int(msa.ax[idx][ii[z]])
                buf[matcol[kk[z]]] = abc.sym[x].upper()
                lastk, nins = -1, 0
            elif st[z] == ST_I:
                if kk[z] != lastk:
                    lastk, nins = kk[z], 0
                x = int(msa.ax[idx][ii[z]])
                buf[inscol[kk[z]] + nins] = abc.sym[x].lower()
                nins += 1
            else:
                lastk = -1
        rows.append("".join(buf))

    rf = np.full(alen, ".", dtype="<U1")
    rf[matcol[1:M + 1]] = "x"
    return list(msa.names), rows, "".join(rf)


def write_stockholm(path: str, names: list[str], rows: list[str],
                    rf: str | None = None, name: str | None = None,
                    wrap: int = 200) -> None:
    """Minimal interleaved Stockholm writer (ref: easel Stockholm
    output as produced for bathbuild -O)."""
    alen = len(rows[0]) if rows else 0
    width = max([len(n) for n in names] + [len("#=GC RF")]) + 2
    with open(path, "w") as fh:
        fh.write("# STOCKHOLM 1.0\n")
        if name:
            fh.write(f"#=GF ID {name}\n")
        fh.write("\n")
        for off in range(0, max(alen, 1), wrap):
            for n, r in zip(names, rows):
                fh.write(f"{n:<{width}}{r[off:off + wrap]}\n")
            if rf is not None:
                fh.write(f"{'#=GC RF':<{width}}{rf[off:off + wrap]}\n")
            fh.write("\n")
        fh.write("//\n")
