"""Top-level splicing pipeline: the --splice post-pass over tophits
(ref: p7_splice.c p7_splice_SpliceHits :59, serial_loop :134,
p7_splice_SpliceGraph :529, p7_splice_AlignSplicedPath).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from .. import constants as C
from ..domaindef import Domain
from ..stats import exp_logsurv
from ..logsum import flogsum
from ..tophits import IS_DUPLICATE, IS_INCLUDED, IS_REPORTED
from .align import align_spliced_sequence, create_spliced_sequence
from .graph import ALIGNMENT_EXT, NEG_INF, SpliceGraph
from .splice import (PathSeq, SpliceConfig, get_sub_sequence,
                     splice_exons, splice_single)

LOG2 = math.log(2.0)


def splice_hits(tophits, seeds, om, gm, gm1, bg, gcode, seq_lookup,
                db_nuc_cnt: int, cfg: SpliceConfig | None = None):
    """Run the splicing pipeline over reported hits.

    seq_lookup: dict name -> (full plus-strand dsq, seqidx, L).
    Modifies <tophits> in place: spliced hits replace their exons'
    original hits (ref: p7_splice_SpliceHits)."""
    cfg = cfg or SpliceConfig()

    # group hits into (seqidx, strand) graphs (ref: serial_loop :150)
    groups: dict[tuple, list[int]] = {}
    for h, hit in enumerate(tophits.hit):
        if not hit.dcl:
            continue
        d = hit.dcl[0]
        revcomp = d.iali > d.jali
        if hit.flags & IS_DUPLICATE:
            continue
        if not (hit.flags & IS_REPORTED) \
                and math.exp(hit.sum_lnP) >= cfg.F3:
            continue
        groups.setdefault((hit.seqidx, revcomp, hit.name), []).append(h)

    for (seqidx, revcomp, seqname), idxs in groups.items():
        if seqname not in seq_lookup:
            continue
        full_dsq, _, seqL = seq_lookup[seqname]
        graph = SpliceGraph(seqidx, revcomp, seqname, seqL)
        for h in idxs:
            graph.add_node(tophits.hit[h], orig_idx=h)
        graph.anchor_N = graph.num_nodes
        if seeds is not None:
            add_seeds(graph, seeds, cfg)
        splice_graph(graph, tophits, om, gm, gm1, bg, gcode, full_dsq,
                     db_nuc_cnt, cfg, seeds)


def _hit_upstream(up, down, revcomp: bool) -> bool:
    """ref: p7_splice_HitUpstream."""
    if revcomp:
        return up.iali > down.iali and up.jali > down.jali
    return up.iali < down.iali and up.jali < down.jali


def add_seeds(graph: SpliceGraph, seeds, cfg: SpliceConfig):
    """Add F3-passing seed hits that lie between two anchors
    (ref: p7_splice_AddSeeds :332)."""
    if graph.anchor_N < 2:
        return
    for hit in seeds.unsrt:
        d = hit.dcl[0]
        if not d.is_reported:           # didn't pass forward
            continue
        if hit.seqidx != graph.seqidx:
            continue
        revcomp = d.iali > d.jali
        if revcomp != graph.revcomp:
            continue
        placed = False
        for h1 in range(graph.anchor_N):
            a1 = graph.hits[h1].dcl[0]
            if not _hit_upstream(d, a1, graph.revcomp):
                continue
            gap = (d.jali - a1.iali - 1) if graph.revcomp \
                else (a1.iali - d.jali - 1)
            if gap > cfg.max_intron:
                continue
            for h2 in range(graph.anchor_N):
                if h2 == h1:
                    continue
                a2 = graph.hits[h2].dcl[0]
                if not _hit_upstream(a2, d, graph.revcomp):
                    continue
                gap2 = (a2.jali - d.iali - 1) if graph.revcomp \
                    else (d.iali - a2.jali - 1)
                if gap2 > cfg.max_intron:
                    continue
                d.is_included = True
                graph.add_node(hit, orig_idx=-1)
                placed = True
                break
            if placed:
                break


def splice_graph(graph: SpliceGraph, tophits, om, gm, gm1, bg, gcode,
                 full_dsq, db_nuc_cnt: int, cfg: SpliceConfig,
                 seeds=None):
    """Splice one per-(sequence,strand) graph
    (ref: p7_splice_SpliceGraph :529)."""
    graph.create_unspliced_edges(gm1.tsc[:, C.P_BM], cfg.max_intron)

    bounds: list[tuple[int, int]] = []
    path_seq: PathSeq | None = None
    orig_path = graph.get_best_path()
    # runaway backstop only: each iteration consumes at least one
    # graph node, so a graph can never yield more paths than nodes
    max_paths = max(100, 2 * graph.num_nodes)
    guard = 0
    while orig_path is not None and guard < max_paths:
        guard += 1
        path_min = min(orig_path.iali[0], orig_path.jali[-1]) \
            - ALIGNMENT_EXT
        path_max = max(orig_path.iali[0], orig_path.jali[-1]) \
            + ALIGNMENT_EXT
        if path_seq is None or \
                path_min < min(path_seq.start, path_seq.end) or \
                path_max > max(path_seq.start, path_seq.end):
            path_seq = get_sub_sequence(full_dsq, path_min, path_max,
                                        graph.revcomp)

        copy_path = orig_path.clone()
        spliced_path = splice_exons(graph, gm1, copy_path, path_seq,
                                    cfg)
        success = False
        if spliced_path is not None and spliced_path.path_len >= 1:
            # end extensions with seed hits (ref: ExtendPath +
            # SpliceExtensions)
            extend_path(graph, seeds, spliced_path, bounds, cfg)
            # re-fetch if the (possibly extended) path exceeds the
            # window
            path_min = min(spliced_path.iali[0], spliced_path.jali[-1]) \
                - ALIGNMENT_EXT
            path_max = max(spliced_path.iali[0], spliced_path.jali[-1]) \
                + ALIGNMENT_EXT
            if path_min < min(path_seq.start, path_seq.end) or \
                    path_max > max(path_seq.start, path_seq.end):
                path_seq = get_sub_sequence(full_dsq, path_min,
                                            path_max, graph.revcomp)
            if any(spliced_path.extension):
                splice_extensions(graph, gm1, spliced_path, path_seq,
                                  cfg)
            elif spliced_path.path_len == 1:
                # a single hit can contain a short intron (ref:
                # p7_splice.c:611 SpliceSingle)
                splice_single(graph, gm1, spliced_path, path_seq, cfg)
            if spliced_path.path_len > 1:
                hit_dom = align_spliced_path(
                    graph, tophits, om, gm, bg, gcode, spliced_path,
                    path_seq, db_nuc_cnt, cfg, full_dsq)
                success = hit_dom is not None

        if success:
            # bounds and knockout use the FINAL HIT's coordinates
            # (the alignment can extend past or trim the path) and
            # require BOTH sequence and hmm overlap before removing
            # a node (ref: p7_splice.c:623-648) — a node covering a
            # disjoint model region may seed another spliced gene
            hit_min = min(hit_dom.iali, hit_dom.jali)
            hit_max = max(hit_dom.iali, hit_dom.jali)
            hmm_min, hmm_max = hit_dom.ihmm, hit_dom.jhmm
            graph.enforce_bounds(hit_min, hit_max)
            bounds.append((hit_min, hit_max))
            for h in range(graph.num_nodes):
                d = graph.hits[h].dcl[0]
                n_min, n_max = min(d.iali, d.jali), max(d.iali, d.jali)
                if min(n_max, hit_max) - max(n_min, hit_min) + 1 > 0 \
                        and min(d.jhmm, hmm_max) \
                        - max(d.ihmm, hmm_min) + 1 > 0:
                    graph.node_in_graph[h] = False
        else:
            if spliced_path is not None and spliced_path.path_len > 1:
                pmin = min(orig_path.iali[0], orig_path.jali[-1])
                pmax = max(orig_path.iali[0], orig_path.jali[-1])
                graph.enforce_bounds(pmin, pmax)
                bounds.append((pmin, pmax))
            for nid in orig_path.node_id:
                graph.node_in_graph[nid] = False

        orig_path = graph.get_best_path()


def align_spliced_path(graph: SpliceGraph, tophits, om, gm, bg, gcode,
                       spliced_path, path_seq: PathSeq,
                       db_nuc_cnt: int, cfg: SpliceConfig,
                       full_dsq=None):
    """Create and align the spliced sequence; on success replace the
    path's hits with one spliced hit; returns the spliced Domain on
    success, else None (ref: p7_splice_AlignSplicedPath).  A decoding
    underflow trims the path at the weak exon and realigns (the
    reference recurses; we loop — ref: p7_splice.c:2736-2757)."""
    res = None
    for _ in range(max(2, spliced_path.path_len + 1)):
        seq = create_spliced_sequence(spliced_path, path_seq, gcode)
        if seq is None:
            return None
        nuc_idx, amino_dsq = seq
        res = align_spliced_sequence(om, gm, bg, amino_dsq, nuc_idx,
                                     path_seq, cfg, gcode)
        # restore multihit length model for any later users
        om.reconfig_multihit(max(om.max_length, 1))
        if res is None or len(res.exons) <= 1:
            return None
        if not res.needs_fix:
            break
        if not fix_decoding_errors(graph, spliced_path, res, path_seq):
            return None
        # refetch the window if the trimmed path (± ALIGNMENT_EXT)
        # no longer fits (ref: the refetch check in AlignSplicedPath)
        if full_dsq is not None:
            path_min = min(spliced_path.iali[0],
                           spliced_path.jali[-1]) - ALIGNMENT_EXT
            path_max = max(spliced_path.iali[0],
                           spliced_path.jali[-1]) + ALIGNMENT_EXT
            if path_min < min(path_seq.start, path_seq.end) or \
                    path_max > max(path_seq.start, path_seq.end):
                path_seq = get_sub_sequence(full_dsq, path_min,
                                            path_max, graph.revcomp)
    if res is None or res.needs_fix:
        return None

    # score adjustments (ref: AlignSplicedPath :~70-95)
    orf_len = res.orf_to - res.orf_from + 1
    n = res.amino_n
    dom_score = res.envsc
    dom_score -= 2 * math.log(2.0 / (n + 2.0))
    dom_score += 2 * math.log(2.0 / (om.max_length + 2.0))
    dom_score -= (n - orf_len) * math.log(n / (n + 2.0))
    dom_score += (om.max_length - orf_len) \
        * math.log(om.max_length / (om.max_length + 2.0))

    if cfg.do_null2:
        omega = 1.0 / 256.0
        dom_bias = flogsum(0.0, math.log(omega) + res.domcorrection)
    else:
        dom_bias = 0.0
    bg.set_length(om.max_length)
    nullsc = bg.null_one(om.max_length)
    dom_score = (dom_score - (nullsc + dom_bias)) / LOG2
    dom_lnP = exp_logsurv(dom_score, om.evparam[C.EV_FTAU],
                          om.evparam[C.EV_FLAMBDA])
    dom_lnP += math.log(db_nuc_cnt / max(om.max_length, 1))

    passes = (math.exp(dom_lnP) <= cfg.E) if cfg.T is None \
        else (dom_score >= cfg.T)
    if not passes:
        return None

    # --- map exons back to path nodes (ref: AlignSplicedPath) ------
    def node_overlap(i, s):
        nd = graph.hits[i].dcl[0]
        if min(nd.jhmm, spliced_path.jhmm[s]) \
                - max(nd.ihmm, spliced_path.ihmm[s]) + 1 <= 0:
            return False
        if graph.revcomp:
            ss = max(nd.jali, spliced_path.jali[s])
            se = min(nd.iali, spliced_path.iali[s])
        else:
            ss = max(nd.iali, spliced_path.iali[s])
            se = min(nd.jali, spliced_path.jali[s])
        return se - ss + 1 > 0

    exon_cnt = len(res.exons)
    if spliced_path.path_len > exon_cnt:
        # the alignment dropped leading/trailing exons: shift the
        # path to start at the first step inside the alignment, then
        # truncate to exon_cnt (ref: the `shift` block)
        if spliced_path.revcomp:
            shift = next((s for s in range(spliced_path.path_len)
                          if spliced_path.jali[s] <= res.iali),
                         spliced_path.path_len - 1)
        else:
            shift = next((s for s in range(spliced_path.path_len)
                          if spliced_path.jali[s] >= res.iali),
                         spliced_path.path_len - 1)
        for i in range(graph.anchor_N):
            if not graph.node_in_graph[i]:
                continue
            for s in range(spliced_path.path_len):
                if spliced_path.node_id[s] >= graph.anchor_N \
                        and node_overlap(i, s):
                    spliced_path.node_id[s] = i
        for attr in ("node_id", "extension", "iali", "jali",
                     "ihmm", "jhmm", "aliscore"):
            lst = getattr(spliced_path, attr)
            del lst[:shift]
            del lst[exon_cnt:]
        spliced_path.iali[0] = res.iali
        spliced_path.ihmm[0] = res.ihmm
        spliced_path.jali[-1] = res.jali
        spliced_path.jhmm[-1] = res.jhmm

    # reassign seed/unknown steps to overlapping anchor nodes; the
    # spliced hit must contain at least one anchor (ref: ibid)
    contains_anchor = False
    for i in range(graph.anchor_N):
        if not graph.node_in_graph[i]:
            continue
        if any(spliced_path.node_id[s] == i
               for s in range(spliced_path.path_len)):
            contains_anchor = True
            continue
        for s in range(spliced_path.path_len):
            nid = spliced_path.node_id[s]
            if (nid < 0 or nid >= graph.anchor_N) \
                    and node_overlap(i, s):
                spliced_path.node_id[s] = i
                contains_anchor = True
    if not contains_anchor:
        return None

    # anchor/extend flags follow the (now exon-aligned) path steps
    for e, info in enumerate(res.exons):
        if e < spliced_path.path_len:
            nid = spliced_path.node_id[e]
            info.anchor = (0 <= nid < graph.anchor_N)
            info.extend = bool(spliced_path.extension[e])

    # host = first anchor node of the trimmed path
    host = None
    for s, nid in enumerate(spliced_path.node_id):
        if 0 <= nid < graph.anchor_N and graph.orig_hit_idx[nid] >= 0:
            host = nid
            break
    if host is None:
        return None

    d = Domain()
    d.ihmm, d.jhmm = res.ihmm, res.jhmm
    d.iali, d.jali = res.iali, res.jali
    d.ienv, d.jenv = res.ienv, res.jenv
    d.envsc = res.envsc
    d.oasc = res.oasc
    d.domcorrection = res.domcorrection
    d.dombias = dom_bias
    d.bitscore = dom_score
    d.lnP = dom_lnP
    d.is_reported = True
    d.is_included = True
    d.ad = res               # carries exons + display segments

    replace_hit = tophits.hit[graph.orig_hit_idx[host]]
    res.L = replace_hit.target_len
    if res.ali is not None:
        res.ali.L = res.L
    replace_hit.dcl = [d]
    replace_hit.frameshift = False
    replace_hit.flags = IS_REPORTED | IS_INCLUDED
    replace_hit.nreported = 1
    replace_hit.nincluded = 1
    replace_hit.best_domain = 0
    replace_hit.ndom = 1
    replace_hit.score = replace_hit.sum_score = dom_score
    replace_hit.lnP = replace_hit.sum_lnP = dom_lnP
    replace_hit.pre_score = res.envsc / LOG2
    replace_hit.pre_lnP = exp_logsurv(
        replace_hit.pre_score, om.evparam[C.EV_FTAUFS5],
        om.evparam[C.EV_FLAMBDA])
    replace_hit.sortkey = -dom_lnP

    # unreport the other original hits covered by this spliced hit
    for s, nid in enumerate(spliced_path.node_id):
        if nid == host or nid < 0:
            continue
        oi = graph.orig_hit_idx[nid] if nid < len(graph.orig_hit_idx) \
            else -1
        if oi >= 0 and tophits.hit[oi] is not replace_hit:
            tophits.hit[oi].flags = IS_DUPLICATE
            tophits.hit[oi].nreported = 0
            tophits.hit[oi].nincluded = 0
    return d


_PATH_ATTRS = ("node_id", "extension", "iali", "jali", "ihmm", "jhmm",
               "aliscore")


def _path_remove(p, step: int):
    """Remove one step from a path (ref: p7_splicepath_Remove)."""
    for attr in _PATH_ATTRS:
        del getattr(p, attr)[step]


def _path_truncate(p, n: int):
    for attr in _PATH_ATTRS:
        del getattr(p, attr)[n:]


def fix_decoding_errors(graph: SpliceGraph, spliced_path, res,
                        path_seq: PathSeq) -> bool:
    """After a decoding underflow (or a zero-posterior exon), find
    the weakest place in the path and cut it there; returns True if
    the remaining path should be realigned, False if it is dead
    (ref: p7_splice_FixDecodingErrors p7_splice.c:3397).  Temporary
    (seed) nodes are node_id >= graph.anchor_N, matching the
    reference's tmp_node flags; extension steps are node_id < 0."""
    p = spliced_path
    anchor_N = graph.anchor_N

    def _is_anchor(nid):
        return 0 <= nid < anchor_N

    def _set_front_from_hit():
        d = graph.hits[p.node_id[0]].dcl[0]
        p.iali[0], p.ihmm[0] = d.iali, d.ihmm

    def _set_back_from_hit():
        d = graph.hits[p.node_id[-1]].dcl[0]
        p.jali[-1], p.jhmm[-1] = d.jali, d.jhmm

    exon_cnt = res.exon_cnt
    if p.path_len > exon_cnt:
        # the alignment dropped leading/trailing exons: shift the
        # path to the first step inside the alignment, then truncate
        # (res coords are already global, unlike the reference's
        # path-seq-local ad coords)
        if p.revcomp:
            shift = next((s for s in range(p.path_len)
                          if p.jali[s] <= res.iali), p.path_len - 1)
        else:
            shift = next((s for s in range(p.path_len)
                          if p.jali[s] >= res.iali), p.path_len - 1)
        shift = min(shift, p.path_len - 1)
        for _ in range(shift):
            _path_remove(p, 0)
        p.iali[0], p.ihmm[0] = res.iali, res.ihmm
        _path_truncate(p, exon_cnt)
        p.jali[-1], p.jhmm[-1] = res.jali, res.jhmm
        if p.path_len == 1:
            return False
        while not _is_anchor(p.node_id[0]):
            _path_remove(p, 0)
            if p.path_len == 1:
                return False
        _set_front_from_hit()
        while not _is_anchor(p.node_id[-1]):
            _path_truncate(p, p.path_len - 1)
            if p.path_len == 1:
                return False
        _set_back_from_hit()
    else:
        # use the exon scores to find the weakest place in the path
        min_idx, min_score = 0, res.exons[0].score
        for e, info in enumerate(res.exons):
            if math.isnan(info.score) or info.score == -math.inf:
                min_idx = e
                break
            if info.score < min_score:
                min_score, min_idx = info.score, e
        if min_idx == 0:
            _path_remove(p, 0)
            if p.path_len == 1:
                return False
            # move the start to the next non-temporary node
            while p.node_id[0] < 0 or p.node_id[0] >= anchor_N:
                _path_remove(p, 0)
                if p.path_len == 1:
                    return False
            _set_front_from_hit()
        else:
            _path_truncate(p, min(min_idx, p.path_len))
            if p.path_len == 1:
                return False
            while p.node_id[-1] < 0 or p.node_id[-1] >= anchor_N:
                _path_truncate(p, p.path_len - 1)
                if p.path_len == 1:
                    return False
            _set_back_from_hit()

    # drop terminal steps that now end before they start
    def _front_backwards():
        if p.revcomp:
            return p.iali[0] <= p.jali[0] or p.ihmm[0] >= p.jhmm[0]
        return p.iali[0] >= p.jali[0] or p.ihmm[0] >= p.jhmm[0]

    def _back_backwards():
        if p.revcomp:
            return p.iali[-1] <= p.jali[-1] or p.ihmm[-1] >= p.jhmm[-1]
        return p.iali[-1] >= p.jali[-1] or p.ihmm[-1] >= p.jhmm[-1]

    while _front_backwards():
        _path_remove(p, 0)
        if p.path_len == 1:
            return False
        _set_front_from_hit()
    while _back_backwards():
        _path_truncate(p, p.path_len - 1)
        if p.path_len == 1:
            return False
        _set_back_from_hit()

    # the trimmed path must still contain an anchor
    return any(_is_anchor(nid) for nid in p.node_id)


# ---------------------------------------------------------------------
# Path end-extension with seed hits
# (ref: p7_splice_ExtendPath :~770, p7_splice_SpliceExtensions)
# ---------------------------------------------------------------------
def extend_path(graph: SpliceGraph, seeds, spliced_path,
                bounds, cfg: SpliceConfig):
    """Add seed hits upstream of the first / downstream of the last
    path node as extension steps (marked extension=True); the spliced
    Viterbi in splice_extensions then decides whether real splice
    sites support them."""
    if seeds is None:
        return

    def candidates(term_dom, upstream: bool):
        out = []
        # unused graph seed nodes
        for nid in range(graph.anchor_N, graph.num_nodes):
            if not graph.node_in_graph[nid]:
                continue
            d = graph.hits[nid].dcl[0]
            if upstream and _hit_upstream(d, term_dom, graph.revcomp):
                out.append(("g", nid, d))
            if not upstream and _hit_upstream(term_dom, d,
                                              graph.revcomp):
                out.append(("g", nid, d))
        # unplaced seed hits
        for hit in seeds.unsrt:
            d = hit.dcl[0]
            if d.is_included or hit.seqidx != graph.seqidx:
                continue
            if (d.iali > d.jali) != graph.revcomp:
                continue
            if upstream and _hit_upstream(d, term_dom, graph.revcomp):
                out.append(("s", hit, d))
            if not upstream and _hit_upstream(term_dom, d,
                                              graph.revcomp):
                out.append(("s", hit, d))
        # keep those within max_intron and outside prior-hit bounds
        res = []
        for kind, ref_, d in out:
            if upstream:
                gap = (d.jali - term_dom.iali - 1) if graph.revcomp \
                    else (term_dom.iali - d.jali - 1)
            else:
                gap = (term_dom.jali - d.iali - 1) if graph.revcomp \
                    else (d.iali - term_dom.jali - 1)
            if gap < 0 or gap > cfg.max_intron:
                continue
            lo = min(d.iali, d.jali)
            hi = max(d.iali, d.jali)
            if any(lo <= bmax and hi >= bmin for (bmin, bmax) in
                   bounds):
                continue
            res.append((kind, ref_, d))
        return res

    # UP: prepend the closest compatible seed (chain of one; the
    # spliced Viterbi can still discover multiple introns)
    first = graph.hits[spliced_path.node_id[0]].dcl[0]
    ups = candidates(first, True)
    if ups:
        kind, ref_, d = max(
            ups, key=lambda t: (min(t[2].iali, t[2].jali)
                                if not graph.revcomp
                                else -min(t[2].iali, t[2].jali)))
        if d.ihmm < first.jhmm:
            if kind == "s":
                d.is_included = True
                graph.add_node(ref_, orig_idx=-1)
                nid = graph.num_nodes - 1
            else:
                nid = ref_
            for lst, val in ((spliced_path.node_id, nid),
                             (spliced_path.extension, True),
                             (spliced_path.ihmm, d.ihmm),
                             (spliced_path.jhmm, d.jhmm),
                             (spliced_path.iali, d.iali),
                             (spliced_path.jali, d.jali),
                             (spliced_path.aliscore, d.aliscore)):
                lst.insert(0, val)

    last = graph.hits[spliced_path.node_id[-1]].dcl[0]
    downs = candidates(last, False)
    if downs:
        kind, ref_, d = min(
            downs, key=lambda t: (min(t[2].iali, t[2].jali)
                                  if not graph.revcomp
                                  else -min(t[2].iali, t[2].jali)))
        if d.jhmm > last.ihmm:
            if kind == "s":
                d.is_included = True
                graph.add_node(ref_, orig_idx=-1)
                nid = graph.num_nodes - 1
            else:
                nid = ref_
            spliced_path.node_id.append(nid)
            spliced_path.extension.append(True)
            spliced_path.ihmm.append(d.ihmm)
            spliced_path.jhmm.append(d.jhmm)
            spliced_path.iali.append(d.iali)
            spliced_path.jali.append(d.jali)
            spliced_path.aliscore.append(d.aliscore)


def splice_extensions(graph: SpliceGraph, gm1, spliced_path,
                      path_seq: PathSeq, cfg: SpliceConfig):
    """Validate end extensions with the spliced Viterbi: the anchored
    side is global, the extension side local, and a real splice
    signal (intron) is required; unsupported extensions are dropped
    (ref: p7_splice_SpliceExtensions, AlignExtendUp/Down)."""
    from .splice import align_exons

    s_start = next(i for i in range(spliced_path.path_len)
                   if not spliced_path.extension[i])
    s_end = next(i for i in range(spliced_path.path_len - 1, -1, -1)
                 if not spliced_path.extension[i])

    next_i_end = next_k_end = 0
    # ---- downstream ----
    if s_end != spliced_path.path_len - 1:
        # the realignment window starts at the last anchor's
        # PRE-SPLICE (edge-cached) coords when it has an upstream
        # splice site (ref: p7_splice.c:1390-1399)
        if s_end == s_start:
            k_start = spliced_path.ihmm[s_end]
            i_start = spliced_path.iali[s_end]
        else:
            edge = graph.get_edge(spliced_path.node_id[s_end - 1],
                                  spliced_path.node_id[s_end])
            if edge is not None and edge.next_k_start:
                k_start = edge.next_k_start
                i_start = edge.next_i_start
            else:
                k_start = spliced_path.ihmm[s_end]
                i_start = spliced_path.iali[s_end]
        k_end = spliced_path.jhmm[-1]
        i_end = spliced_path.jali[-1]
        res = None
        iss = path_seq.to_sub(i_start)
        ise = path_seq.to_sub(i_end)
        if 0 < iss < ise and k_start < k_end:
            res = align_exons(graph, gm1, path_seq, iss, ise, k_start,
                              k_end, cfg, global_start=True,
                              global_end=False, require_intron=True)
        # drop the unspliced extension steps
        while spliced_path.path_len - 1 > s_end:
            for lst in (spliced_path.node_id, spliced_path.extension,
                        spliced_path.ihmm, spliced_path.jhmm,
                        spliced_path.iali, spliced_path.jali,
                        spliced_path.aliscore):
                lst.pop()
        if res is not None:
            ret, tmp = res
            next_i_end = tmp.jali[0]
            next_k_end = tmp.jhmm[0]
            spliced_path.jali[-1] = ret.jali[0]
            spliced_path.jhmm[-1] = ret.jhmm[0]
            for t in range(1, ret.path_len):
                spliced_path.node_id.append(-1)
                spliced_path.extension.append(True)
                spliced_path.iali.append(ret.iali[t])
                spliced_path.jali.append(ret.jali[t])
                spliced_path.ihmm.append(ret.ihmm[t])
                spliced_path.jhmm.append(ret.jhmm[t])
                spliced_path.aliscore.append(0.0)

    # ---- upstream ----
    if s_start != 0:
        k_start = spliced_path.ihmm[0]
        i_start = spliced_path.iali[0]
        # end coords: the first anchor's full-codon end — from the
        # downstream extension's anchor exon when it exists, from
        # the edge cache when more than one anchor remains, else the
        # path (ref: p7_splice.c:1445-1466)
        if s_start == spliced_path.path_len - 1:
            k_end = spliced_path.jhmm[s_start]
            i_end = spliced_path.jali[s_start]
        elif s_end == s_start and next_k_end:
            k_end = next_k_end
            i_end = next_i_end
        else:
            edge = graph.get_edge(spliced_path.node_id[s_start],
                                  spliced_path.node_id[s_start + 1])
            if edge is not None and edge.k_end:
                k_end = edge.k_end
                i_end = edge.i_end
            else:
                k_end = spliced_path.jhmm[s_start]
                i_end = spliced_path.jali[s_start]
        res = None
        iss = path_seq.to_sub(i_start)
        ise = path_seq.to_sub(i_end)
        if 0 < iss < ise and k_start < k_end:
            res = align_exons(graph, gm1, path_seq, iss, ise, k_start,
                              k_end, cfg, global_start=False,
                              global_end=True, require_intron=True)
        ndrop = s_start
        for _ in range(ndrop):
            for lst in (spliced_path.node_id, spliced_path.extension,
                        spliced_path.ihmm, spliced_path.jhmm,
                        spliced_path.iali, spliced_path.jali,
                        spliced_path.aliscore):
                lst.pop(0)
        if res is not None:
            ret, _tmp = res
            spliced_path.iali[0] = ret.iali[-1]
            spliced_path.ihmm[0] = ret.ihmm[-1]
            for t in range(ret.path_len - 2, -1, -1):
                spliced_path.node_id.insert(0, -1)
                spliced_path.extension.insert(0, True)
                spliced_path.iali.insert(0, ret.iali[t])
                spliced_path.jali.insert(0, ret.jali[t])
                spliced_path.ihmm.insert(0, ret.ihmm[t])
                spliced_path.jhmm.insert(0, ret.jhmm[t])
                spliced_path.aliscore.insert(0, 0.0)
