"""Seed-hit recovery for splicing: SSV/Viterbi diagonal windows near
reported hits become pseudo-hits usable as splice-graph nodes
(ref: p7_hmmwindow.c p7_hmmwindow_RemoveDuplicates :256,
p7_hmmwindow_GetSeedHits :373).
"""

from __future__ import annotations

import math

from ..domaindef import Domain, compute_ali_scores_bath
from ..ops.reference.fwdback import Trace
from ..sequence import Sequence
from ..tophits import IS_DUPLICATE, IS_REPORTED, Hit, TopHits
from .. import constants as C


def remove_duplicate_windows(windows, tophits, F3: float):
    """Mark overlapping windows (and windows overlapping reported
    hits) as duplicates (ref: p7_hmmwindow_RemoveDuplicates :256).
    Windows must be sorted by (id, complementarity, position)."""
    for w in windows:
        if not hasattr(w, "duplicate"):
            w.duplicate = False
        w.is_seed = False
    ws = sorted(windows, key=lambda w: (w.id, w.complementarity, w.n))
    j = 0
    for i in range(1, len(ws)):
        wi, wj = ws[i], ws[j]
        if wj.id != wi.id or wj.complementarity != wi.complementarity:
            j = i
            continue
        s_j, e_j = wj.n, wj.n + wj.length - 1
        if wj.complementarity:
            s_j, e_j = e_j, s_j
        len_j = e_j - s_j + 1
        s_i, e_i = wi.n, wi.n + wi.length - 1
        len_i = e_i - s_i + 1
        inter = min(e_i, e_j) - max(s_i, s_j) + 1
        hmm_s = min(wj.k - wj.length // 3 + 1, wi.k - wi.length // 3 + 1)
        hmm_e = max(wj.k, wi.k)
        if (hmm_e - hmm_s + 1 > 0
                and ((s_j - 3 <= s_i <= s_j + 3)
                     or (e_j - 3 <= e_i <= e_j + 3)
                     or inter >= len_i * 0.95
                     or inter >= len_j * 0.95)):
            (wj if len_i > len_j else wi).duplicate = True
        else:
            j = i
    # windows overlapping reported hits are duplicates too
    for h in tophits.hit:
        if h.flags & IS_DUPLICATE:
            continue
        if not (h.flags & IS_REPORTED) and math.exp(h.sum_lnP) >= F3:
            continue
        if not h.dcl:
            continue
        d = h.dcl[0]
        strand = 1 if d.iali > d.jali else 0
        h_min, h_max = min(d.iali, d.jali), max(d.iali, d.jali)
        len_i = h_max - h_min + 1
        for w in ws:
            if w.id != h.seqidx or w.complementarity != strand:
                continue
            if w.duplicate or not w.pass_forward:
                continue
            w_min = min(w.n, w.n + w.length - 1)
            w_max = max(w.n, w.n + w.length - 1)
            len_j = w_max - w_min + 1
            inter = min(w_max, h_max) - max(w_min, h_min) + 1
            # hmm-coordinate overlap + (near-flush edge OR >=90%
            # coverage of either span) — ref: p7_hmmwindow.c:345-350.
            # The reference reads hw->windows[i] (the HIT loop index)
            # for the window's hmm span — an out-of-bounds indexing
            # bug; we use this window's own coordinates as intended.
            hmm_s = max(d.ihmm, w.k - w.length // 3 + 1)
            hmm_e = min(d.jhmm, w.k)
            if (hmm_e - hmm_s + 1 > 0
                    and ((w_min - 3 <= h_min <= w_min + 3)
                         or (w_max - 3 <= h_max <= w_max + 3)
                         or inter >= len_i * 0.9
                         or inter >= len_j * 0.9)):
                w.duplicate = True
    return ws


def get_seed_hits(windows, tophits, gm_fs5, seq_lookup, F3: float,
                  max_intron: int) -> TopHits:
    """Windows within max_intron of a reported hit on the same
    sequence/strand become seed hits with naive 3nt/M traces and
    per-position ali scores (ref: p7_hmmwindow_GetSeedHits :373)."""
    from ..alphabet import revcomp

    for h in tophits.hit:
        if h.flags & IS_DUPLICATE or not h.dcl:
            continue
        if not (h.flags & IS_REPORTED) and math.exp(h.sum_lnP) >= F3:
            continue
        d = h.dcl[0]
        strand = 1 if d.iali > d.jali else 0
        h_min, h_max = min(d.iali, d.jali), max(d.iali, d.jali)
        for w in windows:
            if w.id != h.seqidx or w.complementarity != strand:
                continue
            if w.duplicate or w.is_seed:
                continue
            w_min = w.n
            w_max = w.n + w.length - 1
            if h_min - w_max > max_intron or w_min - h_max > max_intron:
                continue
            hmm_s = w.k - w.length // 3 + 1
            hmm_e = w.k
            upstream = (hmm_s <= d.ihmm or hmm_e <= d.jhmm) and \
                ((strand and w_min > d.iali)
                 or (not strand and w_max < d.iali))
            downstream = (d.ihmm <= hmm_s or d.jhmm <= hmm_e) and \
                ((strand and d.iali > w_min)
                 or (not strand and d.iali < w_max))
            if upstream or downstream:
                w.is_seed = True

    seeds = TopHits()
    name_by_idx = {h.seqidx: h.name for h in tophits.hit}
    rc_cache: dict[str, np.ndarray] = {}   # one revcomp per sequence
    for w in windows:
        if not w.is_seed:
            continue
        name = name_by_idx.get(w.id)
        if name is None or name not in seq_lookup:
            continue
        full_dsq, _, seqL = seq_lookup[name]
        hit = seeds.create_next_hit()
        hit.seqidx = w.id
        hit.name = name
        d = Domain()
        d.is_reported = bool(getattr(w, "pass_forward", False))
        d.ihmm = w.k - w.length // 3 + 1
        d.jhmm = w.k
        if w.complementarity:
            d.iali = w.n + w.length - 1
            d.jali = w.n
            sub = rc_cache.get(name)         # minus strand 5'->3'
            if sub is None:
                sub = rc_cache[name] = revcomp(full_dsq)
            # window nt position of the hit start on the minus strand
            start_sub = seqL - d.iali + 1
        else:
            d.iali = w.n
            d.jali = w.n + w.length - 1
            sub = full_dsq
            start_sub = d.iali
        # naive trace: one 3nt codon per model position
        tr = Trace()
        y = start_sub + 2                    # codon END positions
        for z in range(d.ihmm, d.jhmm + 1):
            tr.append(C.T_M, z, y, 1.0, c=3)
            y += 3
        windowsq = Sequence(name=name, dsq=sub, start=1, end=len(sub),
                            L=len(sub))
        compute_ali_scores_bath(d, tr, windowsq, gm_fs5)
        d.tr = tr
        hit.dcl = [d]
    return seeds
