"""Splicing orchestration: group hits into per-(sequence, strand)
splice graphs, find best paths, locate splice junctions with the
spliced Viterbi, realign the spliced exon chain, and replace the
original hits with spliced hits
(ref: p7_splice.c p7_splice_SpliceHits :59, serial_loop :134,
p7_splice_SpliceGraph :529, p7_splice_SpliceExons, p7_splice_AlignExons,
p7_splice_AlignSplicedPath, p7_splice_AlignSplicedSequence).

Design notes: the graph logic is host-side
(small, irregular); the spliced Viterbi is the compute kernel (numpy
reference and the native host library).  Internal exons are
discovered by the junction search itself (multiple introns per
pairwise alignment); terminal exons are recovered by the
seed-extension machinery in pipeline.extend_path /
splice_extensions.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from .. import constants as C
from ..ops.reference import fwdback as fb
from .graph import (ALIGNMENT_EXT, MAX_INTRON_EXT, NEG_INF, SpliceGraph,
                    SplicePath)
from .viterbi_spliced import (SIGNAL_SCORES, T_E, T_I, T_M, T_P,
                              viterbi_spliced, viterbi_spliced_trace)

LOG2 = math.log(2.0)


@dataclass
class SpliceConfig:
    """ref: p7_splicepipeline_Create defaults (:60-96)."""
    min_intron: int = 13
    max_intron: int = 200000
    E: float = 10.0
    T: float | None = None
    incE: float = 0.01
    F1: float = 0.02
    F2: float = 1e-3
    F3: float = 1e-5
    do_null2: bool = True
    do_biasfilter: bool = True
    signal_scores: np.ndarray = field(
        default_factory=lambda: SIGNAL_SCORES.copy())


@dataclass
class PathSeq:
    """Genomic subsequence, possibly reverse-complemented
    (ref: ESL_SQ window semantics in p7_splice_GetSubSequence :3720).
    start/end are 1-based genomic coords; for revcomp start > end and
    dsq holds the minus strand 5'->3'."""
    dsq: np.ndarray
    start: int
    end: int

    @property
    def n(self) -> int:
        return len(self.dsq)

    def to_sub(self, gpos: int) -> int:
        """Genomic -> 1-based subsequence position."""
        if self.start > self.end:       # revcomp
            return self.n - gpos + self.end
        return gpos - self.start + 1

    def to_global(self, sub: int) -> int:
        if self.start > self.end:
            return self.n - sub + self.end
        return self.start + sub - 1


def get_sub_sequence(full_dsq: np.ndarray, seq_min: int, seq_max: int,
                     revcomp: bool) -> PathSeq:
    """Fetch [seq_min..seq_max] of the (plus-strand) target, reverse
    complementing for minus-strand graphs."""
    from ..alphabet import revcomp as rc
    L = len(full_dsq)
    seq_min = max(1, seq_min)
    seq_max = min(L, seq_max)
    window = full_dsq[seq_min - 1:seq_max]
    if revcomp:
        return PathSeq(dsq=rc(window), start=seq_max, end=seq_min)
    return PathSeq(dsq=window.copy(), start=seq_min, end=seq_max)


# ---------------------------------------------------------------------
# Pairwise exon splicing (ref: p7_splice_AlignExons)
# ---------------------------------------------------------------------
def align_exons(graph: SpliceGraph, gm1, path_seq: PathSeq,
                i_sub_start: int, i_sub_end: int, k_start: int,
                k_end: int, cfg: SpliceConfig,
                global_start: bool = True, global_end: bool = True,
                require_intron: bool = False,
                check_P: bool = True):
    """Run the spliced Viterbi between a pair of path nodes and
    decompose the trace into exons.  Returns (ret_path, tmp_path)
    with genomic coordinates, or None on failure
    (ref: p7_splice_AlignExons; with local start/end this is
    p7_splice_AlignExtendUp/Down, which additionally require at
    least one intron in the trace)."""
    Lsub = i_sub_end - i_sub_start + 1
    gm1.reconfig_length(Lsub // 3)
    gx = viterbi_spliced(path_seq.dsq, gm1, i_sub_start, i_sub_end,
                         k_start, k_end, cfg.min_intron,
                         cfg.signal_scores, global_start, global_end)
    if gx.xC[gx.L] == -np.inf:
        return None
    try:
        tr = viterbi_spliced_trace(path_seq.dsq, gm1, gx, i_sub_start,
                                   i_sub_end, k_start, k_end,
                                   cfg.min_intron, cfg.signal_scores)
    except RuntimeError:
        return None
    if require_intron and not any(s == T_P for s in tr.st):
        return None

    # filter out low-quality splicings (ref: AlignExons P > F2 check;
    # the single-hit path skips it — "single exon split must be
    # better scoring than original exon", p7_splice_AlignSingle)
    if check_P:
        amino_len = sum(1 for s in tr.st if s in (T_M, T_P, T_I))
        from ..stats import gumbel_surv
        nullsc = amino_len * math.log(float(amino_len)
                                      / (amino_len + 1.0)) \
            + math.log(1.0 - float(amino_len) / (amino_len + 1.0))
        seqsc = (tr.vitsc - nullsc) / LOG2
        P = float(gumbel_surv(seqsc, gm1.evparam[C.EV_VMU],
                              gm1.evparam[C.EV_VLAMBDA]))
        if P > cfg.F2:
            return None

    # local (sub-seq) coords here; converted to genomic at the end
    # find first and last M
    idx_m = [z for z, s in enumerate(tr.st) if s == T_M]
    if not idx_m:
        return None
    z1, z2 = idx_m[0], idx_m[-1]

    ret = SplicePath(revcomp=(path_seq.start > path_seq.end))
    tmp = SplicePath(revcomp=ret.revcomp)

    def push(p, iali, ihmm):
        p.node_id.append(-1)
        p.extension.append(False)
        p.iali.append(iali)
        p.ihmm.append(ihmm)
        p.jali.append(0)
        p.jhmm.append(0)
        p.aliscore.append(0.0)

    z = z1
    start_new = True
    step = 0
    st, kk, ii, cc = tr.st, tr.k, tr.i, tr.c
    while z <= z2:
        if start_new:
            y = z
            while st[z] != T_P and st[z] != T_E:
                z += 1
            if st[z] == T_E:
                while st[z] != T_M:
                    z -= 1
            else:
                z -= 1
            # exon start coords (ref: AlignExons :~95-125)
            if step == 0:
                push(tmp, ii[y] - cc[y] + 1, kk[y])
                push(ret, ii[y] - cc[y] + 1, kk[y])
            else:
                pc = cc[y - 1]     # codon split of the preceding P
                if pc == 0:
                    push(ret, ii[y - 1] - 2, kk[y - 1])
                elif pc == 1:
                    push(ret, ii[y - 1] - 1, kk[y - 1])
                else:
                    push(ret, ii[y - 1], kk[y])
                    ret.jhmm[step - 1] = kk[y - 1]
                push(tmp, ii[y] - cc[y] + 1, kk[y])
            tmp.jhmm[step] = kk[z]
            ret.jhmm[step] = kk[z]
            # exon end coords
            is_last = all(s != T_M for s in st[z + 1:z2 + 1])
            if is_last:
                tmp.jali[step] = ii[z]
                ret.jali[step] = ii[z]
            else:
                nc = cc[z + 1]     # split of the following P
                if nc == 0:
                    ret.jali[step] = ii[z]
                elif nc == 1:
                    ret.jali[step] = ii[z] + 1
                else:
                    ret.jali[step] = ii[z] + 2
                tmp.jali[step] = ii[z]
            step += 1
            start_new = False
        z += 1
        if z <= z2 and st[z] == T_M:
            start_new = True

    # convert to genomic coordinates
    for p in (tmp, ret):
        p.iali = [path_seq.to_global(v) for v in p.iali]
        p.jali = [path_seq.to_global(v) for v in p.jali]
    return ret, tmp


def splice_single(graph: SpliceGraph, gm1, spliced_path,
                  path_seq: PathSeq, cfg: SpliceConfig) -> None:
    """Find internal splice sites in a single-node path: two exons
    separated by a short intron can align as one hit; the spliced
    Viterbi over the hit's own span splits it (ref:
    p7_splice_SpliceSingle :1510 / p7_splice_AlignSingle :2476).
    Extends <spliced_path> in place when introns are found."""
    i_start = path_seq.to_sub(spliced_path.iali[0])
    i_end = path_seq.to_sub(spliced_path.jali[0])
    k_start, k_end = spliced_path.ihmm[0], spliced_path.jhmm[0]
    if k_end <= k_start or i_end <= i_start:
        return
    res = align_exons(graph, gm1, path_seq, i_start, i_end, k_start,
                      k_end, cfg, require_intron=True, check_P=False)
    if res is None:
        return
    ret, _tmp = res
    spliced_path.jali[0] = ret.jali[0]
    spliced_path.jhmm[0] = ret.jhmm[0]
    for s in range(1, ret.path_len):
        spliced_path.node_id.append(spliced_path.node_id[0])
        spliced_path.extension.append(False)
        spliced_path.iali.append(ret.iali[s])
        spliced_path.jali.append(ret.jali[s])
        spliced_path.ihmm.append(ret.ihmm[s])
        spliced_path.jhmm.append(ret.jhmm[s])
        spliced_path.aliscore.append(0.0)


def splice_exons(graph: SpliceGraph, gm1, orig_path: SplicePath,
                 path_seq: PathSeq, cfg: SpliceConfig
                 ) -> SplicePath | None:
    """Splice each consecutive pair of path nodes
    (ref: p7_splice_SpliceExons)."""
    if orig_path.path_len == 1:
        return orig_path.clone()

    ret_path: SplicePath | None = None
    next_i_start = next_k_start = 0
    s = 1
    while s < orig_path.path_len:
        edge = graph.get_edge(orig_path.node_id[s - 1],
                              orig_path.node_id[s])
        k_start = orig_path.ihmm[s - 1] if next_k_start == 0 \
            else next_k_start
        i_start = orig_path.iali[s - 1] if next_i_start == 0 \
            else next_i_start
        k_end = orig_path.jhmm[s]
        i_end = orig_path.jali[s]

        if edge is not None and i_start == edge.i_start \
                and k_start == edge.k_start:
            # cached from a previous path (ref: SpliceExons :~39-68)
            if ret_path is None:
                ret_path = SplicePath(revcomp=orig_path.revcomp)
                ret_path.node_id.append(orig_path.node_id[s - 1])
                ret_path.extension.append(False)
                ret_path.iali.append(i_start)
                ret_path.ihmm.append(k_start)
                ret_path.jali.append(0)
                ret_path.jhmm.append(0)
                ret_path.aliscore.append(0.0)
            else:
                pass
            ret_path.jali[-1] = edge.upstream_nuc_end
            ret_path.jhmm[-1] = edge.upstream_amino_end
            ret_path.node_id.append(orig_path.node_id[s])
            ret_path.extension.append(False)
            ret_path.iali.append(edge.downstream_nuc_start)
            ret_path.ihmm.append(edge.downstream_amino_start)
            ret_path.jali.append(i_end)
            ret_path.jhmm.append(k_end)
            ret_path.aliscore.append(0.0)
            next_k_start = edge.next_k_start
            next_i_start = edge.next_i_start
            s += 1
            continue
        if edge is not None:
            edge.i_start = i_start
            edge.k_start = k_start

        i_sub_start = path_seq.to_sub(i_start)
        i_sub_end = path_seq.to_sub(i_end)
        if k_end <= k_start or i_sub_end <= i_sub_start:
            if edge is not None:
                edge.edge_score = NEG_INF
            return None

        res = align_exons(graph, gm1, path_seq, i_sub_start, i_sub_end,
                          k_start, k_end, cfg)
        if res is None:
            edge = graph.get_edge(orig_path.node_id[s - 1],
                                  orig_path.node_id[s])
            if edge is not None:
                edge.edge_score = NEG_INF
            return None
        tmp_ret, tmp = res

        # node assignments (ref: AlignExons :~184-205)
        up_id = orig_path.node_id[s - 1]
        down_id = orig_path.node_id[s]
        if tmp.path_len == 1:
            tmp.node_id[0] = up_id
            tmp_ret.node_id[0] = up_id
            e = graph.get_edge(up_id, down_id)
            if e is not None:
                e.edge_score = NEG_INF
        else:
            tmp.node_id[0] = tmp_ret.node_id[0] = up_id
            tmp.node_id[-1] = tmp_ret.node_id[-1] = down_id
        if tmp.path_len > 2:
            e = graph.get_edge(up_id, down_id)
            if e is not None:
                e.edge_score = NEG_INF

        # register new internal-exon nodes + cache edges
        from ..tophits import Hit
        from ..domaindef import Domain
        for t in range(tmp.path_len):
            if tmp.node_id[t] == -1:
                hit = Hit(name=graph.seqname, seqidx=graph.seqidx)
                d = Domain(iali=tmp.iali[t], jali=tmp.jali[t],
                           ihmm=tmp.ihmm[t], jhmm=tmp.jhmm[t],
                           aliscore=1.0)
                hit.dcl = [d]
                graph.add_node(hit, orig_idx=-1)
                nid = graph.num_nodes - 1
                tmp.node_id[t] = nid
                tmp_ret.node_id[t] = nid
            if t != 0:
                e = graph.get_edge(tmp.node_id[t - 1], tmp.node_id[t])
                if e is None:
                    e = graph.add_edge(tmp.node_id[t - 1],
                                       tmp.node_id[t])
                e.i_start = tmp.iali[t - 1]
                e.k_start = tmp.ihmm[t - 1]
                e.next_i_start = tmp.iali[t]
                e.next_k_start = tmp.ihmm[t]
                e.i_end = tmp.jali[t - 1]
                e.k_end = tmp.jhmm[t - 1]
                e.upstream_nuc_end = tmp_ret.jali[t - 1]
                e.upstream_amino_end = tmp_ret.jhmm[t - 1]
                e.downstream_nuc_start = tmp_ret.iali[t]
                e.downstream_amino_start = tmp_ret.ihmm[t]

        # merge into ret_path (ref: SpliceExons :~100-120)
        if ret_path is None:
            ret_path = tmp_ret.clone()
        else:
            ret_path.jali[-1] = tmp_ret.jali[0]
            ret_path.jhmm[-1] = tmp_ret.jhmm[0]
            for t in range(1, tmp_ret.path_len):
                ret_path.node_id.append(tmp_ret.node_id[t])
                ret_path.extension.append(False)
                ret_path.iali.append(tmp_ret.iali[t])
                ret_path.jali.append(tmp_ret.jali[t])
                ret_path.ihmm.append(tmp_ret.ihmm[t])
                ret_path.jhmm.append(tmp_ret.jhmm[t])
                ret_path.aliscore.append(0.0)

        next_k_start = tmp.ihmm[-1]
        next_i_start = tmp.iali[-1]

        if tmp.path_len == 1 and s != orig_path.path_len - 1:
            # hits merged: drop node s from the original path
            e = graph.get_edge(orig_path.node_id[s - 1],
                               orig_path.node_id[s])
            if e is not None:
                e.edge_score = NEG_INF
            if graph.get_edge(orig_path.node_id[s - 1],
                              orig_path.node_id[s + 1]) is None:
                return None
            for lst in (orig_path.node_id, orig_path.extension,
                        orig_path.ihmm, orig_path.jhmm,
                        orig_path.iali, orig_path.jali,
                        orig_path.aliscore):
                del lst[s]
            continue
        s += 1

    if ret_path is not None:
        ret_path.revcomp = orig_path.revcomp
        ret_path.frameshift = orig_path.frameshift
    return ret_path
