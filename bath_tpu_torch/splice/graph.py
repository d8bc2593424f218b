"""Splice graph: hits as nodes, up/downstream-compatible pairs as
edges, best-path extraction by topological DP
(ref: p7_splicegraph.c, p7_splicepath.c longest_path :394,
p7_splice.c p7_splice_CreateUnsplicedEdges :692).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

NEG_INF = float("-inf")

MAX_AMINO_GAP = 1500        # ref: p7_splice.h
MAX_INTRON_EXT = 10000
ALIGNMENT_EXT = 30
LOG2 = math.log(2.0)


@dataclass
class SpliceEdge:
    up: int
    down: int
    jump_edge: bool = False
    edge_score: float = 0.0
    # spliced coordinates discovered by SpliceExons (cached)
    upstream_amino_end: int = 0
    downstream_amino_start: int = 0
    upstream_nuc_end: int = 0
    downstream_nuc_start: int = 0
    i_start: int = -1
    k_start: int = -1
    next_i_start: int = 0
    next_k_start: int = 0
    # full-codon (tmp) end of the upstream exon — the upstream
    # extension realignment window end (ref: p7_splice.c:1829)
    i_end: int = 0
    k_end: int = 0


@dataclass
class SplicePath:
    revcomp: bool = False
    frameshift: bool = False
    node_id: list = field(default_factory=list)
    extension: list = field(default_factory=list)
    ihmm: list = field(default_factory=list)
    jhmm: list = field(default_factory=list)
    iali: list = field(default_factory=list)
    jali: list = field(default_factory=list)
    aliscore: list = field(default_factory=list)

    @property
    def path_len(self):
        return len(self.node_id)

    def clone(self) -> "SplicePath":
        return SplicePath(
            revcomp=self.revcomp, frameshift=self.frameshift,
            node_id=list(self.node_id), extension=list(self.extension),
            ihmm=list(self.ihmm), jhmm=list(self.jhmm),
            iali=list(self.iali), jali=list(self.jali),
            aliscore=list(self.aliscore))


class SpliceGraph:
    """Nodes are hits (each holding one Domain); edges spliceable
    adjacencies (ref: SPLICE_GRAPH)."""

    def __init__(self, seqidx: int, revcomp: bool, seqname: str = "",
                 seqL: int = 0):
        self.seqidx = seqidx
        self.revcomp = revcomp
        self.seqname = seqname
        self.seqL = seqL
        self.hits: list = []            # Hit objects
        self.node_in_graph: list[bool] = []
        self.orig_hit_idx: list[int] = []
        self.anchor_N = 0
        self.edges: dict[tuple[int, int], SpliceEdge] = {}
        self.path_scores: list[float] = []
        self.best_out_edge: list[int] = []

    @property
    def num_nodes(self):
        return len(self.hits)

    def add_node(self, hit, orig_idx: int = -1):
        self.hits.append(hit)
        self.node_in_graph.append(True)
        self.orig_hit_idx.append(orig_idx)

    def add_edge(self, up: int, down: int) -> SpliceEdge:
        e = SpliceEdge(up=up, down=down)
        self.edges[(up, down)] = e
        return e

    def get_edge(self, up: int, down: int) -> SpliceEdge | None:
        return self.edges.get((up, down))

    def in_nodes(self, down: int):
        return [u for (u, d) in self.edges if d == down]

    # -- edge creation (ref: p7_splice_CreateUnsplicedEdges :692) ----
    def create_unspliced_edges(self, gm_tsc_bm, max_intron: int):
        """<gm_tsc_bm>: [M] B->Mk entry log scores of the 1-codon
        profile (tsc[:, P_BM]), used for the keep-edge test."""
        for up in range(self.num_nodes):
            dup = self.hits[up].dcl[0]
            for down in range(self.num_nodes):
                if up == down:
                    continue
                ddn = self.hits[down].dcl[0]
                if ((self.revcomp and dup.iali <= ddn.iali)
                        or (not self.revcomp and dup.iali >= ddn.iali)):
                    continue
                if ((self.revcomp and dup.jali <= ddn.jali)
                        or (not self.revcomp and dup.jali >= ddn.jali)):
                    continue
                if self.revcomp:
                    seq_gap = dup.jali - ddn.iali - 1
                else:
                    seq_gap = ddn.iali - dup.jali - 1
                if seq_gap > max_intron:
                    continue
                amino_gap = ddn.ihmm - dup.jhmm - 1
                if amino_gap > MAX_AMINO_GAP:
                    continue
                if amino_gap > 10 and seq_gap < amino_gap:
                    continue
                if dup.ihmm >= ddn.jhmm:
                    # backwards on the model: jump edge between anchors
                    if up < self.anchor_N and down < self.anchor_N:
                        e = self.add_edge(up, down)
                        e.edge_score = -(dup.aliscore + ddn.aliscore)
                        e.jump_edge = True
                        e.upstream_amino_end = dup.jhmm
                        e.downstream_amino_start = ddn.ihmm
                        e.upstream_nuc_end = dup.jali
                        e.downstream_nuc_start = ddn.iali
                elif dup.ihmm < ddn.ihmm or dup.jhmm < ddn.jhmm:
                    e = self.add_edge(up, down)
                    e.edge_score = ali_score_edge(dup, ddn)
                    e.upstream_amino_end = dup.jhmm
                    e.downstream_amino_start = ddn.ihmm
                    e.upstream_nuc_end = dup.jali
                    e.downstream_nuc_start = ddn.iali
                    # drop edge if the overlap cost beats a fresh
                    # entry (ref: p7_splice.c:759 — tsc[k-1][BM] is
                    # the B->M_ihmm entry, slot ihmm-1 here)
                    bm = gm_tsc_bm[ddn.ihmm - 1]
                    if e.edge_score < -LOG2 + bm:
                        del self.edges[(up, down)]

    # -- best path (ref: p7_splicepath.c longest_path :394) ----------
    def _topo_order(self) -> list[int]:
        visited = [False] * self.num_nodes
        stack: list[int] = []
        in_lists: dict[int, list[int]] = {}
        for (u, d) in self.edges:
            in_lists.setdefault(d, []).append(u)

        def visit(node):
            todo = [(node, False)]
            while todo:
                n, processed = todo.pop()
                if processed:
                    stack.append(n)
                    continue
                if visited[n]:
                    continue
                visited[n] = True
                todo.append((n, True))
                for u in in_lists.get(n, []):
                    if self.node_in_graph[u] and not visited[u]:
                        todo.append((u, False))
        for i in range(self.num_nodes):
            if self.node_in_graph[i] and not visited[i]:
                visit(i)
        return stack

    def longest_path(self, extend_down: bool = False):
        n = self.num_nodes
        self.path_scores = [
            self.hits[i].dcl[0].aliscore if self.node_in_graph[i]
            else NEG_INF for i in range(n)]
        self.best_out_edge = [-1] * n
        in_lists: dict[int, list[int]] = {}
        for (u, d) in self.edges:
            in_lists.setdefault(d, []).append(u)
        reaches_anchor = [False] * n
        stack = self._topo_order()
        while stack:
            down = stack.pop()
            for up in in_lists.get(down, []):
                if not self.node_in_graph[up]:
                    continue
                e = self.edges.get((up, down))
                if e is None or e.edge_score == NEG_INF:
                    continue
                step = (self.hits[up].dcl[0].aliscore + e.edge_score
                        + self.path_scores[down])
                if self.path_scores[up] <= step:
                    if not extend_down:
                        if down < self.anchor_N or reaches_anchor[down]:
                            reaches_anchor[up] = True
                            self.path_scores[up] = step
                            self.best_out_edge[up] = down
                    else:
                        self.path_scores[up] = step
                        self.best_out_edge[up] = down

    def get_best_path(self, extend_up: bool = False,
                      extend_down: bool = False) -> SplicePath | None:
        """ref: p7_splicepath_GetBestPath :277."""
        self.longest_path(extend_down)
        contains_anchor = False
        while not contains_anchor:
            best, start = NEG_INF, -1
            N = self.num_nodes if extend_up else self.anchor_N
            for i in range(N):
                if self.path_scores[i] > best:
                    best = self.path_scores[i]
                    start = i
            if start < 0 or best == NEG_INF:
                return None
            cur = start
            nodes = [cur]
            while self.best_out_edge[cur] >= 0:
                if cur < self.anchor_N:
                    contains_anchor = True
                nxt = self.best_out_edge[cur]
                e = self.edges.get((cur, nxt))
                if e is None or e.edge_score == NEG_INF:
                    raise RuntimeError("edge does not exist")
                if e.jump_edge:
                    break
                cur = nxt
                nodes.append(cur)
            if cur < self.anchor_N:
                contains_anchor = True
            if not contains_anchor:
                self.path_scores[start] = NEG_INF

        p = SplicePath(revcomp=self.revcomp)
        for s, nid in enumerate(nodes):
            d = self.hits[nid].dcl[0]
            p.node_id.append(nid)
            p.extension.append(False)
            p.ihmm.append(d.ihmm)
            p.jhmm.append(d.jhmm)
            p.iali.append(d.iali)
            p.jali.append(d.jali)
            p.aliscore.append(d.aliscore)
            if d.tr is not None and getattr(d.tr, "fs", 0):
                p.frameshift = True
        return p

    def enforce_bounds(self, bound_min: int, bound_max: int):
        """Kill edges crossing a previously reported hit's span
        (ref: p7_splice_EnforceBounds)."""
        for (u, d), e in list(self.edges.items()):
            lo = min(e.upstream_nuc_end, e.downstream_nuc_start)
            hi = max(e.upstream_nuc_end, e.downstream_nuc_start)
            if lo <= bound_max and hi >= bound_min:
                e.edge_score = NEG_INF


def ali_score_edge(dup, ddn) -> float:
    """Minimum lost alignment score to remove any model overlap
    between an upstream and downstream domain
    (ref: p7_splicegraph.c p7_splicegraph_AliScoreEdge :425)."""
    if ddn.ihmm > dup.jhmm:
        return 0.0
    overlap_start = max(dup.ihmm, ddn.ihmm)
    overlap_end = min(dup.jhmm, ddn.jhmm)
    overlap_len = overlap_end - overlap_start + 1
    if overlap_len < 1:
        return NEG_INF
    if dup.scores_per_pos is None or ddn.scores_per_pos is None:
        return 0.0

    up_suffix = np.zeros(overlap_len)
    dn_prefix = np.zeros(overlap_len)
    spp, kpp = dup.scores_per_pos, dup.k_per_pos
    p = len(kpp) - 1
    while p >= 0 and kpp[p] != overlap_end:
        p -= 1
    if p < 0:
        return 0.0
    last_k = overlap_end
    s = overlap_len - 1
    up_suffix[s] += spp[p]
    p -= 1
    while p >= 0 and kpp[p] >= overlap_start:
        if kpp[p] != last_k:
            s -= 1
        last_k = kpp[p]
        if s >= 0:
            up_suffix[s] += spp[p]
        p -= 1
    for s in range(overlap_len - 2, -1, -1):
        up_suffix[s] += up_suffix[s + 1]
    upstream_lost = 0.0
    if dup.jhmm > overlap_end:
        p = len(kpp) - 1
        while p >= 0 and kpp[p] > overlap_end:
            upstream_lost += spp[p]
            p -= 1

    spp, kpp = ddn.scores_per_pos, ddn.k_per_pos
    p = 0
    while p < len(kpp) and kpp[p] != overlap_start:
        p += 1
    if p >= len(kpp):
        return 0.0
    last_k = overlap_start
    s = 0
    dn_prefix[s] += spp[p]
    p += 1
    while p < len(kpp) and kpp[p] <= overlap_end:
        if kpp[p] != last_k:
            s += 1
        last_k = kpp[p]
        if s < overlap_len:
            dn_prefix[s] += spp[p]
        p += 1
    for s in range(1, overlap_len):
        dn_prefix[s] += dn_prefix[s - 1]
    downstream_lost = 0.0
    if ddn.ihmm < overlap_start:
        p = 0
        while p < len(kpp) and kpp[p] < overlap_start:
            downstream_lost += spp[p]
            p += 1

    # choose the split point with minimum lost score: upstream keeps
    # positions < split, downstream keeps >= split
    # (ref: p7_splicegraph.c :538-549 including endpoint rules)
    min_lost = (math.inf if dup.ihmm == overlap_start
                else up_suffix[0])
    for s in range(1, overlap_len):
        min_lost = min(min_lost, up_suffix[s] + dn_prefix[s - 1])
    if ddn.jhmm > overlap_end:
        min_lost = min(min_lost, dn_prefix[overlap_len - 1])
    return -(min_lost + upstream_lost + downstream_lost)
