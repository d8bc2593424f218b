"""Alignment displays: BATH's codon-aware 3-row alignment rendering.

Re-provides P7_ALIDISPLAY creation and printing for the translated
(non-frameshift) and frameshift paths
(ref: src/p7_alidisplay.c p7_alidisplay_nonfs_Create
:937, p7_alidisplay_fs_Create :538, p7_alidisplay_Print_BATH :3757).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import constants as C
from .ops.reference.fwdback import Trace


@dataclass
class AliDisplay:
    rfline: str | None = None
    mmline: str | None = None
    csline: str | None = None
    model: str = ""
    mline: str = ""
    aseq: str = ""
    ntseq: str = ""          # 5 chars per position
    ppline: str | None = None
    codon: list = field(default_factory=list)
    N: int = 0
    hmmname: str = ""
    hmmacc: str = ""
    hmmdesc: str = ""
    sqname: str = ""
    sqacc: str = ""
    sqdesc: str = ""
    orfname: str = ""
    sqfrom: int = 0
    sqto: int = 0
    L: int = 0
    hmmfrom: int = 0
    hmmto: int = 0
    M: int = 0
    frameshifts: int = 0
    stops: int = 0
    exon_cnt: int = 0
    pid: float = 0.0
    cigar: str | None = None


def encode_postprob(p: float) -> str:
    """ref: p7_alidisplay_EncodePostProb :3689."""
    if p + 0.05 >= 1.0:
        return "*"
    return str(int((p + 0.05) * 10.0))


def nonfs_create(tr: Trace, which: int, om, gm, sq, orfsq, orf_pos: int,
                 abc_amino, abc_dna, show_cigar: bool = False
                 ) -> AliDisplay | None:
    """Alignment display for the standard translated branch
    (ref: p7_alidisplay_nonfs_Create :937).

    <sq> is the DNA subsequence (window starting at the ORF start);
    trace i coords are codon-end positions within <sq> (1-based);
    <orfsq> the amino ORF; <orf_pos> the 1-based amino start.
    """
    if tr.ndom > 0:
        z1 = tr.tfrom[which]
        while z1 < tr.N and tr.st[z1] != C.T_M:
            z1 += 1
        if z1 == tr.N:
            return None
        z2 = tr.tto[which]
        while z2 >= 0 and tr.st[z2] != C.T_M:
            z2 -= 1
        if z2 < 0:
            return None
    else:
        raise ValueError("trace must be indexed")

    ad = AliDisplay()
    ad.hmmname, ad.hmmacc, ad.hmmdesc = gm.name, gm.acc or "", gm.desc or ""
    ad.sqname, ad.sqacc, ad.sqdesc = sq.name, sq.acc or "", sq.desc or ""
    ad.hmmfrom, ad.hmmto, ad.M = tr.k[z1], tr.k[z2], gm.M
    if sq.start < sq.end:
        ad.sqfrom = tr.i[z1] - (tr.c[z1] - 1)
        ad.sqto = tr.i[z2]
    else:
        ad.sqto = tr.i[z1]
        ad.sqfrom = tr.i[z2]
    ad.L = sq.L

    model = []
    mline = []
    aseq = []
    ntseq = []
    ppl = []
    codon = []
    exact = 0
    opos = orf_pos
    dsq = sq.dsq
    rf = gm.rf
    cs = gm.cs
    rfl, csl = [], []
    amino_sym = abc_amino.sym
    dna_sym = abc_dna.sym
    for z in range(z1, z2 + 1):
        k, i, s, c = tr.k[z], tr.i[z], tr.st[z], tr.c[z]
        if rf:
            rfl.append("." if s == C.T_I else rf[k - 1])
        if cs:
            csl.append("." if s == C.T_I else cs[k - 1])
        ppl.append("." if s == C.T_D else encode_postprob(tr.pp[z]))
        if s == C.T_M:
            cons = gm.consensus[k - 1]
            model.append(cons)
            codon.append(c)
            a = int(orfsq.dsq[opos - 1])
            aseq.append(amino_sym[a].upper())
            ntseq.append(" %c%c%c " % (dna_sym[dsq[i - 3]].upper(),
                                       dna_sym[dsq[i - 2]].upper(),
                                       dna_sym[dsq[i - 1]].upper()))
            cons_digit = abc_amino.inmap.get(cons, -1)
            if a == cons_digit:
                mline.append(cons)
                exact += 1
            elif om.rfv[a, k] > 1.0:
                mline.append("+")
            else:
                mline.append(" ")
            opos += 1
        elif s == C.T_I:
            codon.append(3)
            model.append(".")
            a = int(orfsq.dsq[opos - 1])
            aseq.append(amino_sym[a].upper())
            ntseq.append(" %c%c%c " % (dna_sym[dsq[i - 3]].upper(),
                                       dna_sym[dsq[i - 2]].upper(),
                                       dna_sym[dsq[i - 1]].upper()))
            mline.append(" ")
            opos += 1
        elif s == C.T_D:
            codon.append(0)
            model.append(gm.consensus[k - 1])
            mline.append(" ")
            aseq.append("-")
            ntseq.append(" --- ")
        else:
            raise ValueError("invalid state in alidisplay trace")

    ad.model = "".join(model)
    ad.mline = "".join(mline)
    ad.aseq = "".join(aseq)
    ad.ntseq = "".join(ntseq)
    ad.ppline = "".join(ppl)
    ad.codon = codon
    ad.rfline = "".join(rfl) if rf else None
    ad.csline = "".join(csl) if cs else None
    ad.N = z2 - z1 + 1
    ad.pid = (exact / ad.N) * 100 if ad.N else 0.0
    ad.exon_cnt = 0
    if show_cigar:
        # run-length CIGAR in nt units (ref: nonfs_Create cigar blocks)
        parts = []
        n_count = 0
        for z in range(z1, z2 + 1):
            s = tr.st[z]
            op = {C.T_M: "M", C.T_I: "I", C.T_D: "D"}[s]
            n_count += 3
            if z == z2 or tr.st[z + 1] != s:
                parts.append("%d%s" % (n_count, op))
                n_count = 0
        ad.cigar = "".join(parts)
    return ad


def _int_width(n: int) -> int:
    return len(str(n))


def print_bath(ad: AliDisplay, max_namewidth: int, min_aliwidth: int,
               linewidth: int, pli) -> str:
    """Render the BATH 3-row codon alignment display
    (ref: p7_alidisplay_Print_BATH :3757)."""
    out = []
    # --acc: prefer accessions over names (ref: :3785-3786)
    show_acc = getattr(pli, "show_accessions", False)
    show_hmmname = ad.hmmacc if (show_acc and ad.hmmacc) else ad.hmmname
    show_seqname = ad.sqacc if (show_acc and ad.sqacc) else ad.sqname
    namewidth = max(len(show_hmmname), len(show_seqname))
    while namewidth > max_namewidth + 3:
        if len(show_hmmname) > len(show_seqname):
            show_hmmname = show_hmmname[:max_namewidth] + "..."
        else:
            show_seqname = show_seqname[:max_namewidth] + "..."
        namewidth = max(len(show_hmmname), len(show_seqname))
    namewidth = max(namewidth, 8)
    coordwidth = max(_int_width(ad.hmmfrom), _int_width(ad.hmmto),
                     _int_width(ad.sqfrom), _int_width(ad.sqto))
    max_aliwidth = (linewidth - namewidth - 2 * coordwidth - 5) \
        if linewidth > 0 else ad.N
    if max_aliwidth < ad.N and max_aliwidth < min_aliwidth:
        max_aliwidth = min_aliwidth
    max_aliwidth -= 4
    max_aliwidth //= 5

    show_frameline = getattr(pli, "show_frameline", False)

    i1 = ad.sqfrom
    i2 = i1 - 1 if ad.sqfrom < ad.sqto else i1 + 1
    k1 = ad.hmmfrom
    pos = 0
    while pos < ad.N:
        if pos > 0:
            out.append("\n")
        cur = max_aliwidth
        ni = nk = 0
        for z in range(pos, min(pos + cur, ad.N)):
            if ad.model[z] not in (".", " "):
                nk += 1
            if ad.aseq[z] != "-":
                ni += 1
        k2 = k1 + nk - 1

        blank = " " * (namewidth + coordwidth + 1)
        if ad.csline is not None:
            out.append("  %s " % blank + "  "
                       + "".join("  %c  " % c for c in ad.csline[pos:pos + cur])
                       + "  \n")
        if ad.rfline is not None:
            out.append("  %s " % blank + "  "
                       + "".join("  %c  " % c for c in ad.rfline[pos:pos + cur])
                       + "   RF\n")
        # model line
        out.append("  %*s %*d " % (namewidth, show_hmmname, coordwidth, k1)
                   + "  "
                   + "".join("  %c  " % c for c in ad.model[pos:pos + cur])
                   + "  " + " %-*d\n" % (coordwidth, k2))
        # match line
        out.append("  %s " % blank + "  "
                   + "".join("  %c  " % c for c in ad.mline[pos:pos + cur])
                   + "  \n")
        # translation line (suppressed by --notrans)
        if getattr(pli, "show_trans", True):
            out.append("  %s " % blank + "  "
                       + "".join("  %c  " % c
                                 for c in ad.aseq[pos:pos + cur])
                       + "  \n")
        # target nt line
        if ni > 0:
            out.append("  %*s %*d " % (namewidth, show_seqname,
                                       coordwidth, i1))
        else:
            out.append("  %*s %*s " % (namewidth, show_seqname,
                                       coordwidth, "-"))
        out.append("  ")
        frames = []
        nchunk = []
        j = pos
        while j < min(pos + cur, ad.N):
            nchunk.append(ad.ntseq[5 * j:5 * j + 5])
            cl = ad.codon[j]
            if ad.sqfrom < ad.sqto:
                c1 = i2
                i2 += 3 if cl == 6 else cl
            else:
                c1 = i2 - 1
                i2 -= 3 if cl == 6 else cl
            if show_frameline:
                if cl == 0 or cl == 6:
                    frames.append(0)
                else:
                    frames.append(_frame(c1, i2))
            j += 1
        out.append("".join(nchunk))
        out.append("  ")
        if ni > 0:
            out.append(" %-*d\n" % (coordwidth, i2))
        else:
            out.append(" %*s\n" % (coordwidth, "-"))
        if show_frameline:
            out.append("  %s " % blank + "  ")
            for jj, f in enumerate(frames):
                cl = ad.codon[pos + jj]
                if f > 0:
                    out.append("  %d  " % f)
                elif f < 0:
                    out.append(" %d  " % f)
                elif cl == 6:
                    out.append("  %d  " % f)
                else:
                    out.append("  .  ")
            out.append("  ")
            out.append(" FRAME\n")
        # PP line
        out.append("  %s " % blank + "  ")
        if ad.ppline is not None:
            out.append("".join("  %c  " % c
                               for c in ad.ppline[pos:pos + cur]))
        else:
            out.append("     " * min(cur, ad.N - pos))
        out.append("  ")
        out.append(" PP\n")
        k1 += nk
        i1 = i2 + 1 if ad.sqfrom < ad.sqto else i2 - 1
        pos += cur
    return "".join(out)


def _frame(nuc_from: int, nuc_to: int) -> int:
    """ref: p7_alidiplay_frame (p7_alidisplay.c:3719)."""
    if nuc_from < nuc_to:
        frame = (nuc_to + 1) % 3
        if frame == 0:
            frame = 3
    else:
        frame = -(nuc_to % 3)
        if frame == 0:
            frame = -3
    return frame


def print_splice(res, hmmname: str, sqname: str, linewidth: int = 120
                 ) -> str:
    """Render the spliced per-exon alignment blocks — a port of the
    reference's splice path through p7_alidisplay_Print_BATH
    (p7_alidisplay.c:3758): display lines break at '$' (P) columns,
    the donor signal prints at the broken line's end, the acceptor
    signal at the next line's start, and coords include the signals.

    <res> is a splice.align.SplicedHitResult with a flat SpliceAli.
    """
    ad = res.ali
    out = []
    show_hmmname = hmmname
    show_seqname = sqname
    max_namewidth = 30
    namewidth = max(len(show_hmmname), len(show_seqname))
    while namewidth > max_namewidth + 3:
        if len(show_hmmname) > len(show_seqname):
            show_hmmname = show_hmmname[:max_namewidth] + "..."
        else:
            show_seqname = show_seqname[:max_namewidth] + "..."
        namewidth = max(len(show_hmmname), len(show_seqname))
    namewidth = max(namewidth, 8)
    coordwidth = max(_int_width(ad.hmmfrom), _int_width(ad.hmmto),
                     _int_width(ad.sqfrom), _int_width(ad.sqto))
    max_aliwidth = (linewidth - namewidth - 2 * coordwidth - 5) \
        if linewidth > 0 else ad.N
    if max_aliwidth < ad.N and max_aliwidth < 40:
        max_aliwidth = 40
    max_aliwidth -= 4
    max_aliwidth //= 5

    fwd = ad.sqfrom < ad.sqto
    i1 = ad.sqfrom
    i2 = i1 - 1 if fwd else i1 + 1
    k1 = ad.hmmfrom
    exon_cnt = 1
    pos = 0
    was_splice = False
    blank = " " * (namewidth + coordwidth + 1)
    while pos < ad.N:
        if pos > 0:
            out.append("\n")
        cur = max_aliwidth
        is_splice = False
        for z in range(pos, min(pos + max_aliwidth + 1, ad.N)):
            if ad.ntseq[z * 5 + 2] == "$":
                is_splice = True
                cur = z - pos
                break
        ni = nk = 0
        for z in range(pos, min(pos + cur, ad.N)):
            if ad.model[z] not in (".", " "):
                nk += 1
            if ad.aseq[z] != "-":
                ni += 1
        k2 = k1 + nk - 1
        # model line
        out.append("  %*s %*d " % (namewidth, show_hmmname,
                                   coordwidth, k1)
                   + "  "
                   + "".join("  %c  " % c
                             for c in ad.model[pos:pos + cur])
                   + "  " + " %-*d\n" % (coordwidth, k2))
        # match line
        out.append("  %s " % blank + "  "
                   + "".join("  %c  " % c
                             for c in ad.mline[pos:pos + cur])
                   + "  \n")
        # translation line with exon label
        exlabel = "exon %d" % exon_cnt
        out.append("  %*s %*s " % (namewidth, exlabel, coordwidth, "")
                   + "  "
                   + "".join("  %c  " % c
                             for c in ad.aseq[pos:pos + cur])
                   + "  \n")
        # target nt line
        if ni > 0:
            out.append("  %*s %*d " % (namewidth, show_seqname,
                                       coordwidth, i1))
        else:
            out.append("  %*s %*s " % (namewidth, show_seqname,
                                       coordwidth, "-"))
        if was_splice:
            out.append(ad.ntseq[pos * 5 - 2:pos * 5])
            i2 = i2 + 2 if fwd else i2 - 2
        else:
            out.append("  ")
        for j in range(pos, min(pos + cur, ad.N)):
            out.append(ad.ntseq[5 * j:5 * j + 5])
            cl = ad.codon[j]
            if fwd:
                i2 += 3 if cl == 6 else cl
            else:
                i2 -= 3 if cl == 6 else cl
        if is_splice:
            out.append(ad.ntseq[5 * (pos + cur):5 * (pos + cur) + 2])
            i2 = i2 + 2 if fwd else i2 - 2
        else:
            out.append("  ")
        if ni > 0:
            out.append(" %-*d\n" % (coordwidth, i2))
        else:
            out.append(" %*s\n" % (coordwidth, "-"))
        # PP line
        out.append("  %s " % blank)
        out.append("||" if was_splice else "  ")
        out.append("".join("  %c  " % c
                           for c in ad.ppline[pos:pos + cur]))
        out.append("||" if is_splice else "  ")
        out.append(" PP\n")
        k1 += nk
        i1 = i2 + 1 if fwd else i2 - 1
        pos += cur
        if is_splice:
            pos += 1                    # pass over the '$' column
            if fwd:
                i1 = ad.exon_seq_starts[exon_cnt] - 2
                i2 = i1 - 1
            else:
                i1 = ad.exon_seq_starts[exon_cnt] + 2
                i2 = i1 + 1
            exon_cnt += 1
            out.append("\n")
        was_splice = is_splice
    return "".join(out)
