"""Top hits: collection, sorting, deduplication, thresholding, output.

Re-provides P7_TOPHITS (ref: src/p7_tophits.c): the
merge/sort/dedup semantics that make results worker-count invariant,
BATH E-value computation (E = P * nres/W), and the human-readable +
tabular output formats.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from . import constants as C
from .domaindef import Domain

# hit flags (ref: hmmer.h p7_IS_*)
IS_INCLUDED = 1 << 0
IS_REPORTED = 1 << 1
IS_NEW = 1 << 2
IS_DROPPED = 1 << 3
IS_DUPLICATE = 1 << 4


@dataclass
class Hit:
    name: str = ""
    acc: str = ""
    desc: str = ""
    sortkey: float = 0.0
    score: float = 0.0
    pre_score: float = 0.0
    sum_score: float = 0.0
    lnP: float = 0.0
    pre_lnP: float = 0.0
    sum_lnP: float = 0.0
    ndom: int = 0
    noverlaps: int = 0
    nenvelopes: int = 0
    flags: int = 0
    nreported: int = 0
    nincluded: int = 0
    best_domain: int = 0
    seqidx: int = -1
    subseq_start: int = 0
    window_length: int = 0
    target_len: int = 0
    frameshift: bool = False
    dcl: list = field(default_factory=list)


class TopHits:
    def __init__(self):
        self.unsrt: list[Hit] = []
        self.hit: list[Hit] = []
        self.nreported = 0
        self.nincluded = 0
        self.is_sorted_by_sortkey = False

    @property
    def N(self):
        return len(self.unsrt)

    def create_next_hit(self) -> Hit:
        h = Hit()
        self.unsrt.append(h)
        self.is_sorted_by_sortkey = False
        return h

    def merge(self, other: "TopHits"):
        self.unsrt.extend(other.unsrt)
        self.is_sorted_by_sortkey = False

    # ref: p7_tophits.c hit_sorter_by_sortkey :261
    def sort_by_sortkey(self):
        def key(h):
            if h.dcl:
                d = h.dcl[0]
                # positive strand before negative on ties, then
                # ascending start position
                strand = 0 if d.iali < d.jali else 1
                iali = d.iali
            else:
                strand = 0
                iali = 0
            return (-h.sortkey, h.name, strand, iali)
        self.hit = sorted(self.unsrt, key=key)
        self.is_sorted_by_sortkey = True

    # ref: p7_tophits.c hit_sorter_by_seqidx_aliposition :286
    def sort_by_seqidx_and_alipos(self):
        def key(h):
            d = h.dcl[0]
            rev = d.iali > d.jali
            s, e = (d.jali, d.iali) if rev else (d.iali, d.jali)
            # positive strand first; then smallest start; then
            # LONGEST hit first (end position descending)
            return (h.seqidx, 1 if rev else 0, s, -e)
        self.hit = sorted(self.unsrt, key=key)
        self.is_sorted_by_sortkey = False

    # ref: p7_tophits_ComputeEvalues_BATH :789
    def compute_evalues_bath(self, nres: int, W: int):
        for h in self.unsrt:
            h.lnP += math.log(float(nres) / float(W))
            if h.dcl:
                h.dcl[0].lnP = h.lnP
            h.sortkey = -1.0 * h.lnP

    # ref: p7_tophits_RemoveDuplicates :816
    def remove_duplicates(self, using_bit_cutoffs: bool = False):
        th = self.hit
        if len(th) < 2:
            return
        j = 0
        for i in range(1, len(th)):
            p_j = th[j].lnP
            s_j, e_j = th[j].dcl[0].iali, th[j].dcl[0].jali
            dir_j = 1 if s_j < e_j else -1
            if dir_j == -1:
                s_j, e_j = e_j, s_j
            len_j = e_j - s_j + 1
            p_i = th[i].lnP
            s_i, e_i = th[i].dcl[0].iali, th[i].dcl[0].jali
            dir_i = 1 if s_i < e_i else -1
            if dir_i == -1:
                s_i, e_i = e_i, s_i
            len_i = e_i - s_i + 1
            inter_s = max(s_i, s_j)
            inter_e = min(e_i, e_j)
            inter_len = inter_e - inter_s + 1
            hmm_s = max(th[i].dcl[0].ihmm, th[j].dcl[0].ihmm)
            hmm_e = min(th[i].dcl[0].jhmm, th[j].dcl[0].jhmm)
            hmm_len = hmm_e - hmm_s + 1
            if (th[i].name == th[i - 1].name
                    and th[i].seqidx == th[i - 1].seqidx
                    and dir_i == dir_j and hmm_len > 0
                    and ((s_j - 3 <= s_i <= s_j + 3)
                         or (e_j - 3 <= e_i <= e_j + 3)
                         or (inter_len >= len_i * 0.95)
                         or (inter_len >= len_j * 0.95))):
                remove = j if p_i < p_j else i
                th[remove].flags |= IS_DUPLICATE
                if using_bit_cutoffs:
                    th[remove].flags &= ~(IS_REPORTED | IS_INCLUDED)
                j = i if remove == j else j
            else:
                j = i

    # ref: p7_tophits_Threshold :913
    def threshold(self, pli):
        for h in self.hit:
            if not (h.flags & IS_DUPLICATE) and \
                    pli.target_reportable(h.score, h.lnP):
                h.flags |= IS_REPORTED
                if pli.target_includable(h.score, h.lnP):
                    h.flags |= IS_INCLUDED
                h.dcl[0].is_reported = bool(h.flags & IS_REPORTED)
                h.dcl[0].is_included = bool(h.flags & IS_INCLUDED)
        self.nreported = sum(1 for h in self.hit if h.flags & IS_REPORTED)
        self.nincluded = sum(1 for h in self.hit if h.flags & IS_INCLUDED)
        for h in self.hit:
            for d in h.dcl:
                if d.is_reported:
                    h.nreported += 1
                if d.is_included:
                    h.nincluded += 1

    # ---- output ----------------------------------------------------
    # widths are taken over ALL registered hits, not just reported
    # ones (the reference documents this as a deliberate side effect;
    # p7_tophits_GetMaxNameLength / GetMaxPositionLength)
    def _max_name_len(self):
        return max((len(h.name) for h in self.unsrt), default=0)

    def _max_pos_len(self):
        mx = 0
        for h in self.unsrt:
            if h.dcl:
                mx = max(mx, len(str(abs(h.dcl[0].iali))),
                         len(str(abs(h.dcl[0].jali))))
        return mx

    def _max_shown_len(self):
        """ref: p7_tophits_GetMaxShownLength :599 — accession when
        present, else name, over all registered hits."""
        return max((len(h.acc) if h.acc else len(h.name)
                    for h in self.unsrt), default=0)

    def _max_acc_len(self):
        return max((len(h.acc) for h in self.unsrt if h.acc),
                   default=0)

    @staticmethod
    def _showname(h, pli):
        """The --acc option: accession instead of name if possible."""
        if getattr(pli, "show_accessions", False) and h.acc:
            return h.acc
        return h.name

    # ref: p7_tophits_Targets :1072
    def targets_text(self, pli, textw: int) -> str:
        out = []
        if getattr(pli, "show_accessions", False):
            namew = max(8, self._max_shown_len())
        else:
            namew = max(8, self._max_name_len())
        posw = max(6, self._max_pos_len())
        descw = max(32, textw - namew - 2 * posw - 32) if textw > 0 else 0
        out.append("Scores for complete hits:\n")
        if getattr(pli, "spliced", False):
            out.append("  %9s %6s %5s  %-*s %*s %*s  %5s  %s\n" % (
                "E-value", " score", " bias", namew, "Sequence", posw,
                "start", posw, "end", "exons", "Description"))
            out.append("  %9s %6s %5s  %-*s %*s %*s  %5s  %s\n" % (
                "-------", "------", "-----", namew, "--------", posw,
                "-----", posw, "-----", "-----", "-----------"))
        elif pli.fs_pipe:
            out.append("  %9s %6s %5s  %-*s %*s %*s  %6s  %5s  %s\n" % (
                "E-value", " score", " bias", namew, "Sequence", posw,
                "start", posw, "end", "shifts", "stops", "Description"))
            out.append("  %9s %6s %5s  %-*s %*s %*s  %6s  %5s  %s\n" % (
                "-------", "------", "-----", namew, "--------", posw,
                "-----", posw, "-----", "------", "-----", "-----------"))
        else:
            out.append("  %9s %6s %5s  %-*s %*s %*s  %s\n" % (
                "E-value", " score", " bias", namew, "Sequence", posw,
                "start", posw, "end", "Description"))
            out.append("  %9s %6s %5s  %-*s %*s %*s  %s\n" % (
                "-------", "------", "-----", namew, "--------", posw,
                "-----", posw, "-----", "-----------"))
        have_printed_incthresh = False
        for h in self.hit:
            if not (h.flags & IS_REPORTED):
                continue
            d = h.dcl[h.best_domain]
            if not (h.flags & IS_INCLUDED) and not have_printed_incthresh:
                out.append("  ------ inclusion threshold ------\n")
                have_printed_incthresh = True
            newness = "+" if h.flags & IS_NEW else \
                ("-" if h.flags & IS_DROPPED else " ")
            line = "%c %9.2g %6.1f %5.1f  %-*s %*d %*d  " % (
                newness, math.exp(h.lnP), h.score,
                d.dombias / C.CONST_LOG2, namew, self._showname(h, pli),
                posw, d.iali, posw, d.jali)
            if getattr(pli, "spliced", False):
                nex = len(d.ad.exons) if hasattr(d.ad, "exons") else 1
                line += "%5d" % nex
            elif pli.fs_pipe:
                line += "%6d  %5d" % (d.ad.frameshifts, d.ad.stops)
            out.append(line)
            desc = h.desc or ""
            if textw > 0:
                out.append("  %s\n" % desc[:descw])
            else:
                out.append("  %s\n" % desc)
        if self.nreported == 0:
            out.append("\n   [No hits detected that satisfy reporting"
                       " thresholds]\n")
        return "".join(out)

    # ref: p7_tophits_Domains :1231
    def domains_text(self, pli, textw: int) -> str:
        from .alidisplay import print_bath
        out = []
        out.append("Annotation for each hit %s:\n" % (
            "(and alignments)" if pli.show_alignments else ""))
        for h in self.hit:
            if not (h.flags & IS_REPORTED):
                continue
            showname = self._showname(h, pli)
            namew = len(showname)
            desc = h.desc or ""
            if textw > 0:
                descw = max(32, textw - namew - 5)
                out.append(">> %s  %s\n" % (showname, desc[:descw]))
            else:
                out.append(">> %s  %s\n" % (showname, desc))
            d = h.dcl[0]
            if getattr(d.ad, "ali", None) is not None:  # spliced hit
                from .alidisplay import print_splice
                res = d.ad
                out.append("   %6s %5s %9s %10s %9s    %9s %9s    %5s  %9s   %4s\n" % (
                    "score", "bias", "   Evalue", "hmm-from",
                    " hmm-to", " ali-from", "   ali-to", "exons",
                    "   sq-len", "acc"))
                out.append("   %6s %5s %9s %10s %9s    %9s %9s    %5s  %9s   %4s\n" % (
                    "------", "-----", "---------", "--------",
                    "-------", "---------", "---------", "-----",
                    "---------", "----"))
                out.append(" %c %6.1f %5.1f %9.2g %10d %9d %c%c %9d %9d %c%c %5d  %9d   %4.2f\n" % (
                    "!" if d.is_included else "?", d.bitscore,
                    d.dombias / C.CONST_LOG2, math.exp(d.lnP),
                    res.ihmm, res.jhmm,
                    "[" if res.ihmm == 1 else ".",
                    "]" if res.jhmm == pli.nnodes else ".",
                    res.iali, res.jali,
                    "[" if res.iali == 1 else ".",
                    "]" if res.jali == h.target_len else ".",
                    len(res.exons), h.target_len,
                    d.oasc / (1.0 + abs(float(d.jenv - d.ienv) / 3))))
                if pli.show_alignments:
                    out.append("\n  Alignment:\n")
                    out.append("  score: %.1f bits\n" % d.bitscore)
                    out.append(print_splice(res, getattr(pli, "qname",
                                                         ""),
                                            h.name, textw))
                    out.append("\n")
                else:
                    out.append("\n")
                continue
            if pli.fs_pipe:
                out.append("   %6s %5s %9s %10s %9s    %9s %9s    %6s  %5s %9s   %4s\n" % (
                    "score", "bias", "   Evalue", "hmm-from", " hmm-to",
                    " ali-from", "   ali-to", "shifts", "stops",
                    "   sq-len", "acc"))
                out.append("   %6s %5s %9s %10s %9s    %9s %9s    %6s  %5s %9s   %4s\n" % (
                    "------", "-----", "---------", "--------", "-------",
                    "---------", "---------", "------", "-----",
                    "---------", "----"))
                out.append(" %c %6.1f %5.1f %9.2g %10d %9d %c%c %9d %9d %c%c %6d  %5d %9d   %4.2f\n" % (
                    "!" if d.is_included else "?", d.bitscore,
                    d.dombias / C.CONST_LOG2, math.exp(d.lnP),
                    d.ad.hmmfrom, d.ad.hmmto,
                    "[" if d.ad.hmmfrom == 1 else ".",
                    "]" if d.ad.hmmto == d.ad.M else ".",
                    d.ad.sqfrom, d.ad.sqto,
                    "[" if d.ad.sqfrom == 1 else ".",
                    "]" if d.ad.sqto == d.ad.L else ".",
                    d.ad.frameshifts, d.ad.stops, d.ad.L,
                    d.oasc / (1.0 + abs(float(d.jenv - d.ienv) / 3))))
            else:
                out.append("   %6s %5s %9s %10s %9s    %9s %9s    %9s   %4s\n" % (
                    "score", "bias", "   Evalue", "hmm-from", " hmm-to",
                    " ali-from", "   ali-to", "   sq-len", "acc"))
                out.append("   %6s %5s %9s %10s %9s    %9s %9s    %9s   %4s\n" % (
                    "------", "-----", "---------", "--------", "-------",
                    "---------", "---------", "---------", "----"))
                out.append(" %c %6.1f %5.1f %9.2g %10d %9d %c%c %9d %9d %c%c %9d   %4.2f\n" % (
                    "!" if d.is_included else "?", d.bitscore,
                    d.dombias / C.CONST_LOG2, math.exp(d.lnP),
                    d.ad.hmmfrom, d.ad.hmmto,
                    "[" if d.ad.hmmfrom == 1 else ".",
                    "]" if d.ad.hmmto == d.ad.M else ".",
                    d.ad.sqfrom, d.ad.sqto,
                    "[" if d.ad.sqfrom == 1 else ".",
                    "]" if d.ad.sqto == d.ad.L else ".",
                    d.ad.L,
                    d.oasc / (1.0 + abs(float(d.jenv - d.ienv) / 3))))
            if pli.show_alignments:
                out.append("\n  Alignment:\n")
                out.append("  score: %.1f bits" % d.bitscore)
                out.append("\n")
                out.append(print_bath(d.ad, 30, 40, textw, pli))
                out.append("\n")
            else:
                out.append("\n")
        if self.nreported == 0:
            out.append("\n   [No hits detected that satisfy reporting"
                       " thresholds]\n")
        return "".join(out)

    # ref: p7_tophits_TabularTargets :1602
    def tabular_targets_text(self, qname: str, qacc: str, pli,
                             show_header: bool) -> str:
        out = []
        qnamew = max(20, len(qname))
        tnamew = max(20, self._max_name_len())
        qaccw = max(10, len(qacc)) if qacc else 10
        taccw = max(10, max((len(h.acc) for h in self.unsrt
                             if h.flags & IS_REPORTED and h.acc),
                            default=0))
        posw = max(9, self._max_pos_len())
        if show_header:
            hdr = "#%7s %-*s %-*s %-*s %-*s %9s %9s %9s %9s %9s %9s" % (
                " hit ID", tnamew - 1, " target name", taccw, " accession",
                qnamew, " query name", qaccw, " accession", "  hmm len",
                " hmm from", "   hmm to", "  seq len", " ali from",
                "   ali to")
            if pli.spliced:
                hdr += " %9s" % " exon cnt"
            hdr += "  %9s %6s %5s %5s" % ("  E-value", " score", " bias",
                                          "  PID")
            if pli.fs_pipe:
                hdr += " %7s %6s" % (" shifts", " stops")
            hdr += " %s\n" % ("CIGAR" if pli.show_cigar
                               else " description of target")
            out.append(hdr)
            hdr = "#%7s %-*s %-*s %-*s %-*s %9s %9s %9s %9s %9s %9s" % (
                "-------", tnamew - 1, "-------------------", taccw,
                "----------", qnamew, "--------------------", qaccw,
                "----------", "---------", "---------", "---------",
                "---------", "---------", "---------")
            if pli.spliced:
                hdr += " %9s" % "---------"
            hdr += "  %9s %6s %5s %5s" % ("---------", "------", "-----",
                                          "-----")
            if pli.fs_pipe:
                hdr += " %7s %6s" % ("-------", "------")
            hdr += " %s\n" % "---------------------"
            out.append(hdr)
        hid = 0
        for h in self.hit:
            if not (h.flags & IS_REPORTED):
                continue
            hid += 1
            d = h.dcl[0]
            line = "%8d %-*s %-*s %-*s %-*s %8d  %8d  %8d  %*d %*d %*d" % (
                hid, tnamew, h.name, taccw, h.acc or "-", qnamew, qname,
                qaccw, qacc if qacc else "-", d.ad.M, d.ad.hmmfrom,
                d.ad.hmmto, posw, d.ad.L, posw, d.iali, posw, d.jali)
            if pli.spliced:
                line += " %8d " % d.ad.exon_cnt
            line += " %9.2g %6.1f %5.1f %5.2f" % (
                math.exp(h.lnP), h.score, d.dombias / C.CONST_LOG2,
                d.ad.pid)
            if pli.fs_pipe:
                line += " %7d %6d" % (d.ad.frameshifts, d.ad.stops)
            if pli.show_cigar:
                line += " %s\n" % (d.ad.cigar or "")
            else:
                line += " %s\n" % (h.desc or "-")
            out.append(line)
        return "".join(out)

    # ref: p7_tophits_TabularExons :1735
    def tabular_exons_text(self, qname: str, qacc: str, pli,
                           show_header: bool,
                           node_info: bool = False) -> str:
        out = []
        tnamew = max(20, self._max_name_len())
        qnamew = max(20, len(qname))
        qaccw = max(10, len(qacc)) if qacc else 10
        taccw = max(10, self._max_acc_len())
        posw = max(9, self._max_pos_len())
        if show_header:
            out.append("#%*s %22s %47s \n" % (
                tnamew + qnamew + 31 + taccw + qaccw, "",
                "------ full hit ------ ",
                "----------------------------- this exon "
                "------------------------------"))
            h1 = ("#%7s %-*s %-*s %-*s %-*s %9s %9s %9s %6s %5s %3s"
                  " %3s %9s %9s %9s %9s %9s %5s %7s" % (
                      " hit ID", tnamew, " target name",
                      taccw, " accession", qnamew, " query name",
                      qaccw, " accession", "  hmm len", "  seq len",
                      "  E-value", " score", " bias", "  #", " of",
                      " hmm from", "   hmm to", " ali from",
                      "   ali to", "  P-value", "  PID", " splice"))
            h2 = ("#%7s %-*s %-*s %-*s %-*s %9s %9s %9s %6s %5s %3s"
                  " %3s %9s %9s %9s %9s %9s %5s %7s" % (
                      "-------", tnamew, "-------------------",
                      taccw, "----------", qnamew,
                      "--------------------", qaccw, "----------",
                      "---------", "---------", "---------",
                      "------", "-----", "---", "---", "---------",
                      "---------", "---------", "---------",
                      "---------", "-----", "-------"))
            if node_info:
                # ref: p7_tophits_TabularExons :1757 (--nodeinfo)
                h1 += " %7s %7s" % (" anchor", " extend")
                h2 += " %7s %7s" % ("-------", "-------")
            out.append(h1 + "\n")
            out.append(h2 + "\n")
        hitid = 0
        for h in self.hit:
            if not (h.flags & IS_REPORTED):
                continue
            hitid += 1
            d = h.dcl[0]
            res = d.ad
            exons = getattr(res, "exons", None)
            nex = len(exons) if exons else 1
            for e in range(1, nex + 1):
                ln = ("%8d %-*s %-*s %-*s %-*s %9d %*d %9.2g"
                      " %6.1f %5.1f %3d %3d " % (
                          hitid, tnamew, h.name, taccw, h.acc or "-",
                          qnamew, qname, qaccw, qacc or "-",
                          pli.nnodes, posw,
                          h.target_len, math.exp(h.lnP), h.score,
                          d.dombias / C.CONST_LOG2, e, nex))
                if nex > 1:
                    x = exons[e - 1]
                    ln += ("%9d %9d %*d %*d %9.2g %5.2f %7s " % (
                        x.hmm_from, x.hmm_to, posw, x.seq_from,
                        posw, x.seq_to, math.exp(x.lnP), x.pid,
                        x.signal if e < nex else "----"))
                else:
                    # single exon: the reference prints the hit's
                    # alignment-display coordinates and sum_lnP
                    # (ref: p7_tophits_TabularExons else-branch)
                    ln += ("%9d %9d %*d %*d %9.2g %5.2f %7s " % (
                        res.hmmfrom, res.hmmto, posw, res.sqfrom,
                        posw, res.sqto, math.exp(h.sum_lnP),
                        res.pid, "----"))
                if node_info:
                    # ref: p7_tophits_TabularExons :1828 — no
                    # trailing space after the extend column
                    x_anchor = (nex == 1
                                or bool(exons[e - 1].anchor))
                    x_extend = (nex > 1
                                and bool(exons[e - 1].extend))
                    ln = ln[:-1] + " %7s %7s" % (
                        "True" if x_anchor else "False",
                        "True" if x_extend else "False")
                out.append(ln + "\n")
        return "".join(out)

    # ref: p7_tophits_TabularFrameshifts :1442
    def tabular_frameshifts_text(self, qname: str, qacc: str, pli,
                                 show_header: bool) -> str:
        out = []
        qnamew = max(20, len(qname))
        tnamew = max(20, self._max_name_len())
        qaccw = max(10, len(qacc)) if qacc else 10
        taccw = max(10, self._max_acc_len())
        posw = max(9, self._max_pos_len())
        if show_header and self.N > 0 and self.hit and self.hit[0].ndom > 0:
            out.append("#%-*s %-*s %-*s %-*s %-9s %-*s %-*s  %5s %6s %-*s %9s\n" % (
                tnamew - 1, " target name", taccw, " accession", qnamew,
                " query name", qaccw, " accession", " E-value", posw,
                " ali from", posw, " ali to", " I D S", " length", posw,
                " seq start", " ali start"))
            out.append("#%*s %*s %*s %*s %9s %-*s %-*s  %5s  %6s  %-*s  %9s\n" % (
                tnamew - 1, "-------------------", taccw, "-----------",
                qnamew, "--------------------", qaccw, "----------",
                "---------", posw, "---------", posw, "---------",
                "-----", "------", posw, "---------", "---------"))
        for h in self.hit:
            if not (h.flags & IS_REPORTED) or not h.frameshift:
                continue
            d = h.dcl[h.best_domain]
            tr, ad = d.tr, d.ad
            seq_from, seq_to = d.iali, d.jali
            z1 = 0
            while z1 < tr.N and tr.st[z1] != C.T_M:
                z1 += 1
            z2 = z1
            while z2 < tr.N and tr.st[z2] != C.T_E:
                z2 += 1
            while z2 >= 0 and tr.st[z2] != C.T_M:
                z2 -= 1
            ali_pos = 1
            for z in range(z1, z2 + 1):
                fs = False
                fs_type, fs_length, ali_start, seq_start = " ", 0, 0, 0
                if tr.st[z] == C.T_M:
                    c = tr.c[z]
                    if c in (1, 2):
                        fs, fs_type, fs_length = True, "D", 3 - c
                    elif c == 3 and ad.codon[z - z1] == 6:
                        fs, fs_type, fs_length = True, "S", 0
                    elif c in (4, 5):
                        fs, fs_type, fs_length = True, "I", c - 3
                    if fs:
                        ali_start = ali_pos
                        seq_start = (seq_from + ali_pos - 1
                                     if seq_from < seq_to
                                     else seq_from - ali_pos + 1)
                    ali_pos += c if fs else 3
                elif tr.st[z] == C.T_I:
                    ali_pos += 3
                if fs:
                    out.append(" %-*s %-*s %-*s %-*s %9.2g %-*d %-*d  %5c  %6d  %-*d  %9d\n" % (
                        tnamew, h.name, taccw, h.acc or "-", qnamew, qname,
                        qaccw, qacc if qacc else "-", math.exp(h.lnP),
                        posw, d.iali, posw, d.jali, fs_type, fs_length,
                        posw, seq_start, ali_start))
        return "".join(out)


# ref: p7_tophits_TabularTail
def tabular_tail(progname: str, qfile: str, tfile: str, cmdline: str) -> str:
    import os
    import time as _time
    return ("#\n# Program:         %s\n# Query file:      %s\n"
            "# Target file:     %s\n# Option settings: %s\n"
            "# Current dir:     %s\n# Date:            %s\n# [ok]\n" % (
                progname, qfile, tfile, cmdline, os.getcwd(),
                _time.ctime()))
