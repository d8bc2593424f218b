"""Final alignment of a spliced exon chain: build the spliced
nucleotide/amino sequence, align to the amino profile, segment the
alignment back into exons with genomic coordinates, and score exons
(ref: p7_splice.c p7_splice_CreateSplicedSequnce,
p7_splice_AlignSplicedSequence, p7_splice_ScoreExons,
p7_alidisplay.c p7_alidisplay_splice_Create).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from .. import constants as C
from ..ops.reference import fwdback as fb
from ..stats import exp_logsurv
from .splice import PathSeq, SpliceConfig
from .graph import SplicePath

LOG2 = math.log(2.0)


@dataclass
class ExonInfo:
    hmm_from: int = 0
    hmm_to: int = 0
    seq_from: int = 0       # genomic coords
    seq_to: int = 0
    score: float = 0.0
    lnP: float = 0.0
    pp: float = 0.0
    pid: float = 0.0
    signal: str = "----"    # splice signal of the FOLLOWING intron
    anchor: bool = False
    extend: bool = False


@dataclass
class SpliceAli:
    """Flat column-stream display of a spliced alignment, mirroring
    the reference's P7_ALIDISPLAY splice layout (5-char nt cells; R =
    donor partial column, P = 'dd$aa' signal column where display
    lines break, A = acceptor partial column)."""
    model: str = ""
    mline: str = ""
    aseq: str = ""
    ppline: str = ""
    ntseq: str = ""                 # 5 chars per column
    codon: list = field(default_factory=list)   # nts consumed per col
    N: int = 0
    hmmfrom: int = 0
    hmmto: int = 0
    sqfrom: int = 0                 # genomic display coords
    sqto: int = 0
    L: int = 0
    exon_seq_starts: list = field(default_factory=list)
    exon_seq_ends: list = field(default_factory=list)
    exon_hmm_starts: list = field(default_factory=list)
    exon_hmm_ends: list = field(default_factory=list)


@dataclass
class SplicedHitResult:
    envsc: float = 0.0
    oasc: float = 0.0
    domcorrection: float = 0.0
    ihmm: int = 0
    jhmm: int = 0
    iali: int = 0           # genomic
    jali: int = 0
    ienv: int = 0
    jenv: int = 0
    exons: list = field(default_factory=list)       # ExonInfo
    ali: SpliceAli | None = None
    # tabular-output fields (ref: P7_ALIDISPLAY members used by
    # p7_tophits_TabularTargets for spliced hits)
    M: int = 0
    hmmfrom: int = 0
    hmmto: int = 0
    L: int = 0
    exon_cnt: int = 0
    pid: float = 0.0
    cigar: str = ""
    amino_n: int = 0
    orf_from: int = 0
    orf_to: int = 0
    # decoding underflow recovery: the alignment came from the
    # Viterbi fallback, or an exon has zero posterior probability —
    # the caller must run fix_decoding_errors and realign
    # (ref: AlignSplicedSequence eslERANGE branch + zero-pp check)
    needs_fix: bool = False


def create_spliced_sequence(spliced_path: SplicePath, path_seq: PathSeq,
                            gcode):
    """Concatenate exon spans into one nucleotide sequence, extended
    up to ALIGNMENT_EXT nt beyond each path end in codon steps
    (stopping at the first stop codon), so the final alignment may
    begin/end outside the path; return (nuc_sub_idx [n],
    amino_dsq [n/3]) or None if not mod 3
    (ref: p7_splice_CreateSplicedSequnce, ALIGNMENT_EXT
    p7_splice.h:211)."""
    subs = []
    for s in range(spliced_path.path_len):
        a = path_seq.to_sub(spliced_path.iali[s])
        b = path_seq.to_sub(spliced_path.jali[s])
        if b < a:
            return None
        subs.extend(range(a, b + 1))
    if len(subs) % 3 != 0:
        spliced_path.frameshift = True
        return None

    # --- up/downstream extensions, in path_seq sub coords (both
    # strands reduce to the same arithmetic; the reference's revcomp
    # branch is to_sub applied to genomic steps of 3) ----------------
    EXT = 30
    dsq = path_seq.dsq
    n_sub = path_seq.n
    stop_aa = gcode.aa_abc.Kp - 2

    def _is_stop(s):
        return gcode.translate_codon(int(dsq[s - 1]), int(dsq[s]),
                                     int(dsq[s + 1])) == stop_aa

    p0 = subs[0]
    ext_start = p0 - EXT
    for s in range(p0 - 3, p0 - EXT - 1, -3):
        if s < 1:
            ext_start = s + 3
            break
        if _is_stop(s):
            ext_start = s + 3
            break
    p1 = subs[-1]
    ext_end = p1 + EXT
    for s in range(p1 + 1, p1 + EXT + 1, 3):
        if s > n_sub - 2:
            ext_end = s - 1
            break
        if _is_stop(s):
            ext_end = s - 1
            break
    subs = list(range(ext_start, p0)) + subs \
        + list(range(p1 + 1, ext_end + 1))
    nuc_idx = np.array(subs, dtype=np.int64)           # 1-based sub pos
    nts = path_seq.dsq[nuc_idx - 1]
    n_amino = len(subs) // 3
    amino = np.empty(n_amino, dtype=np.int32)
    for a in range(n_amino):
        amino[a] = gcode.translate_codon(int(nts[3 * a]),
                                         int(nts[3 * a + 1]),
                                         int(nts[3 * a + 2]))
    return nuc_idx, amino


def align_spliced_sequence(om, gm, bg, amino_dsq: np.ndarray,
                           nuc_idx: np.ndarray, path_seq: PathSeq,
                           cfg: SpliceConfig,
                           gcode=None) -> SplicedHitResult | None:
    """Unihit alignment of the spliced amino sequence + exon
    segmentation (ref: p7_splice_AlignSplicedSequence)."""
    n = len(amino_dsq)
    om.reconfig_unihit(n)
    bg.set_length(n)
    if cfg.do_biasfilter:
        filtersc = bg.filter_score(amino_dsq)
    else:
        filtersc = bg.null_one(n)

    try:
        oxf, envsc = fb.forward(amino_dsq, om, full=True)
        oxb, _ = fb.backward(amino_dsq, om, oxf, full=True)
    except fb.RangeError:
        return None
    fallback = False
    try:
        pp = fb.decoding(om, oxf, oxb)
    except fb.RangeError:
        # rare decoding underflow (a low-probability exon): align
        # with Viterbi instead so the caller can locate and cut the
        # weak exon, then realign the trimmed path (ref:
        # AlignSplicedSequence eslERANGE branch p7_splice.c:3262)
        fallback = True
        try:
            vmx, _ = fb.viterbi(amino_dsq, om)
            tr = fb.viterbi_trace(amino_dsq, om, vmx)
        except fb.RangeError:
            return None
    if not fallback:
        ox2, oasc = fb.optimal_accuracy(om, pp)
        tr = fb.oa_trace(om, pp, ox2)
    else:
        oasc = 0.0
    tr.index()
    if not tr.tfrom:
        return None

    domcorrection = 0.0
    if not fallback:
        seq_score = (envsc - filtersc) / LOG2
        P = math.exp(exp_logsurv(seq_score, om.evparam[C.EV_FTAU],
                                 om.evparam[C.EV_FLAMBDA]))
        if P > cfg.F3:
            return None

        null2 = fb.null2_by_expectation(om, pp, 20)
        null2 = fb.finish_null2(null2, gm.abc)
        for a in amino_dsq:
            domcorrection += math.log(max(float(null2[int(a)]), 1e-30))
        domcorrection = max(0.0, domcorrection)

    res = SplicedHitResult(envsc=envsc, oasc=oasc,
                           domcorrection=domcorrection, amino_n=n,
                           needs_fix=fallback)

    # alignment span (first/last M in the best = only domain)
    z1 = tr.tfrom[0]
    while z1 < tr.N and tr.st[z1] != C.T_M:
        z1 += 1
    z2 = tr.tto[0]
    while z2 >= 0 and tr.st[z2] != C.T_M:
        z2 -= 1
    if z1 >= tr.N or z2 < 0:
        return None
    res.ihmm, res.jhmm = tr.k[z1], tr.k[z2]
    res.orf_from, res.orf_to = tr.i[z1], tr.i[z2]
    res.iali = path_seq.to_global(int(nuc_idx[3 * (tr.i[z1] - 1)]))
    res.jali = path_seq.to_global(int(nuc_idx[3 * tr.i[z2] - 1]))
    res.ienv = path_seq.to_global(int(nuc_idx[0]))
    res.jenv = path_seq.to_global(int(nuc_idx[-1]))

    # --- flat display columns with R/P/A splice columns --------------
    # (ref: p7_alidisplay_splice_Create p7_alidisplay.c:1357-1780;
    #  split codons: R column carries the amino + donor partial at
    #  model position k in the upstream exon, P column holds the
    #  splice signals "dd$aa", A column the acceptor partial with the
    #  downstream exon starting at k+1)
    from ..alidisplay import encode_postprob
    amino_sym = gm.abc.sym
    dna_sym = "ACGT-RYMKSWHBVDN*~"

    def nt_char(subpos):
        return dna_sym[int(path_seq.dsq[subpos - 1])].upper()

    model = []
    mline = []
    aseq = []
    ppl = []
    ntcells = []
    codon = []
    exon_seq_starts = []        # global coords
    exon_seq_ends = []
    exon_hmm_starts = []
    exon_hmm_ends = []
    exon_sigs = []              # signal of the intron FOLLOWING exon x
    pid_num = [0]
    pid_den = [0]
    kinds = []                  # per-column state: M I D R RI P A
    prev_nt_sub = None

    def match_col(kk, aa):
        """(model, mline, aseq) chars for an M column."""
        cons = gm.consensus[kk - 1]
        ach = amino_sym[aa].upper()
        cons_digit = gm.abc.inmap.get(cons, -1)
        if aa == cons_digit:
            ml = cons
            pid_num[-1] += 1
        elif om.rfv[aa, kk] > 1.0:
            ml = "+"
        else:
            ml = " "
        return cons, ml, ach

    for z in range(z1, z2 + 1):
        k, i, s = tr.k[z], tr.i[z], tr.st[z]
        if s == C.T_D:
            model.append(gm.consensus[k - 1])
            mline.append(" ")
            aseq.append("-")
            ppl.append(".")
            ntcells.append(" --- ")
            codon.append(0)
            kinds.append("D")
            pid_den[-1] += 1
            continue
        # M or I consumes amino i -> nts 3i-2..3i of the spliced seq
        nt_subs = [int(nuc_idx[3 * (i - 1)]), int(nuc_idx[3 * i - 2]),
                   int(nuc_idx[3 * i - 1])]
        splits = []
        if prev_nt_sub is not None and nt_subs[0] != prev_nt_sub + 1:
            splits.append(0)
        if nt_subs[1] != nt_subs[0] + 1:
            splits.append(1)
        if nt_subs[2] != nt_subs[1] + 1:
            splits.append(2)
        a = int(amino_dsq[i - 1])
        sp = splits[0] if (splits and prev_nt_sub is not None) else None

        def p_column(don_sub, acc_sub):
            """Splice-signal column 'dd$aa' + exon bookkeeping."""
            d1, d2 = (nt_char(don_sub + 1).lower(),
                      nt_char(don_sub + 2).lower())
            a1_, a2_ = (nt_char(acc_sub - 2).lower(),
                        nt_char(acc_sub - 1).lower())
            model.append(" ")
            mline.append(" ")
            aseq.append(" ")
            ppl.append(" ")
            ntcells.append("%s%s$%s%s" % (d1, d2, a1_, a2_))
            codon.append(0)
            kinds.append("P")
            exon_seq_ends.append(path_seq.to_global(don_sub))
            exon_seq_starts.append(path_seq.to_global(acc_sub))
            exon_sigs.append(d1 + d2 + a1_ + a2_)
            pid_num.append(0)
            pid_den.append(0)

        if sp is not None and sp > 0:
            # R column: amino + donor-side partial, model position k
            if s == C.T_M:
                mc, ml, ac = match_col(k, a)
            else:
                mc, ml, ac = ".", " ", amino_sym[a].lower()
            model.append(mc)
            mline.append(ml)
            aseq.append(ac)
            ppl.append(encode_postprob(tr.pp[z]))
            part = "".join(nt_char(p) for p in nt_subs[:sp])
            ntcells.append(" %-4s" % part)
            codon.append(sp)
            kinds.append("R" if s == C.T_M else "RI")
            pid_den[-1] += 1
            exon_hmm_ends.append(k)
            exon_hmm_starts.append(k + 1)
            p_column(nt_subs[sp - 1], nt_subs[sp])
            # A column: acceptor partial, blank rows
            model.append(" ")
            mline.append(" ")
            aseq.append(" ")
            ppl.append(" ")
            rest = "".join(nt_char(p) for p in nt_subs[sp:])
            ntcells.append("%4s " % rest)
            codon.append(3 - sp)
            kinds.append("A")
            prev_nt_sub = nt_subs[2]
            continue
        if sp == 0:
            # intron falls between codons: P column only
            exon_hmm_ends.append(k - 1)
            exon_hmm_starts.append(k)
            p_column(prev_nt_sub, nt_subs[0])
        if s == C.T_M:
            mc, ml, ac = match_col(k, a)
        else:
            mc, ml, ac = ".", " ", amino_sym[a].lower()
        model.append(mc)
        mline.append(ml)
        aseq.append(ac)
        ppl.append(encode_postprob(tr.pp[z]))
        ntcells.append(" %c%c%c " % tuple(nt_char(p) for p in nt_subs))
        codon.append(3)
        kinds.append("M" if s == C.T_M else "I")
        pid_den[-1] += 1
        prev_nt_sub = nt_subs[2]

    if not model:
        return None
    # terminal exon bounds
    first_nt = int(nuc_idx[3 * (tr.i[z1] - 1)])
    exon_seq_starts.insert(0, res.iali)
    exon_seq_ends.append(res.jali)
    exon_hmm_starts.insert(0, res.ihmm)
    exon_hmm_ends.append(res.jhmm)
    exon_sigs.append("----")

    ali = SpliceAli(
        model="".join(model), mline="".join(mline),
        aseq="".join(aseq), ppline="".join(ppl),
        ntseq="".join(ntcells), codon=codon, N=len(model),
        hmmfrom=res.ihmm, hmmto=res.jhmm,
        sqfrom=res.iali, sqto=res.jali,
        exon_seq_starts=exon_seq_starts, exon_seq_ends=exon_seq_ends,
        exon_hmm_starts=exon_hmm_starts, exon_hmm_ends=exon_hmm_ends)
    res.ali = ali

    # --- spliced CIGAR in nt units: split codons flush M/I runs at
    # the R column, introns are N records, the acceptor partial joins
    # the next run (ref: show_cigar blocks of alidisplay_splice_Create)
    cg = []
    run = 0
    nc = len(kinds)
    px = 0                      # intron index for P columns
    for j, kd in enumerate(kinds):
        nxt = kinds[j + 1] if j + 1 < nc else None
        if kd in ("M", "I", "D"):
            run += 3
            ends = {"M": ("M", "R"), "I": ("I", "RI"),
                    "D": ("D",)}[kd]
            if nxt not in ends:
                cg.append("%d%s" % (run, kd))
                run = 0
        elif kd in ("R", "RI"):
            run += codon[j]
            cg.append("%d%s" % (run, "M" if kd == "R" else "I"))
            run = 0
        elif kd == "P":
            intron = abs(exon_seq_starts[px + 1] -
                         exon_seq_ends[px]) - 1
            cg.append("%dN" % intron)
            px += 1
        else:                   # A
            run += codon[j]
            if j >= 2 and kinds[j - 2] == "R" and nxt != "M":
                cg.append("%dM" % run)
                run = 0
            elif j >= 2 and kinds[j - 2] == "RI" and nxt != "I":
                cg.append("%dI" % run)
                run = 0
    res.cigar = "".join(cg)
    ali.cigar = res.cigar

    # --- per-exon info + scores (ref: p7_splice_ScoreExons) ----------
    exons: list[ExonInfo] = []
    start_i = tr.i[z1] - 1
    scale = float(np.log(np.maximum(oxf.scale[:start_i + 1],
                                    1e-300)).sum()) \
        if start_i >= 0 else 0.0
    if start_i == 0:
        start_score = 0.0
    else:
        start_score = math.log(max(float(oxf.xC[start_i]), 1e-300)) + scale
    remainder = 0
    end_i = start_i
    end_score = start_score
    n_exons = len(exon_seq_starts)
    for e in range(n_exons):
        gfrom, gto = exon_seq_starts[e], exon_seq_ends[e]
        exon_nuc_len = abs(gto - gfrom) + 1
        if e > 0:
            if remainder == 1:
                exon_nuc_len += 1
            elif remainder == 2:
                exon_nuc_len -= 1
        remainder = exon_nuc_len % 3
        if remainder == 1:
            exon_nuc_len -= 1
        elif remainder == 2:
            exon_nuc_len += 1
        exon_amino_len = max(1, exon_nuc_len // 3)
        start_i2, start_score2 = end_i, end_score
        end_i = min(start_i2 + exon_amino_len, n)
        for i in range(start_i2 + 1, end_i + 1):
            scale += math.log(max(float(oxf.scale[i]), 1e-300))
        end_score = math.log(max(float(oxf.xC[end_i]), 1e-300)) + scale
        exon_score = end_score - start_score2
        bg.set_length(exon_amino_len)
        nullsc = bg.null_one(exon_amino_len)
        exon_score -= math.log(2.0 / (n + 2.0))
        exon_score += 2 * math.log(2.0 / (exon_amino_len + 2.0))
        score_bits = (exon_score - nullsc) / LOG2
        lnP = exp_logsurv(score_bits, om.evparam[C.EV_FTAU],
                          om.evparam[C.EV_FLAMBDA])
        info = ExonInfo(hmm_from=exon_hmm_starts[e],
                        hmm_to=exon_hmm_ends[e],
                        seq_from=gfrom, seq_to=gto,
                        score=score_bits, lnP=lnP,
                        pid=100.0 * pid_num[e] / max(1, pid_den[e]),
                        signal=exon_sigs[e])
        # summed posterior over the exon's trace steps divided by the
        # exon's AMINO length (ref: p7_splice.c ScoreExons
        # `exon_pp / (float) exon_amino_len`, not the step count)
        pps = [tr.pp[z] for z in range(z1, z2 + 1)
               if tr.st[z] in (C.T_M, C.T_I)
               and start_i2 < tr.i[z] <= end_i]
        info.pp = float(sum(pps) / max(1, end_i - start_i2))
        exons.append(info)

    res.exons = exons
    if not fallback and any(e.pp == 0.0 for e in exons):
        # posterior underflow in some exon: cut the path there and
        # realign (ref: zero exon_pp check p7_splice.c:3337-3352)
        res.needs_fix = True
    res.M = om.M
    res.hmmfrom, res.hmmto = res.ihmm, res.jhmm
    res.exon_cnt = len(exons)
    res.pid = 100.0 * sum(pid_num) / max(1, sum(pid_den))
    return res
