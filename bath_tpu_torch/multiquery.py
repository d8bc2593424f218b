"""Multi-query (Pfam-scale) drive: one pass over the target, device
gate batches across models.

The reference re-enters its serial per-query loop for every HMM in
the query file (ref: src/bathsearch.c:737-988), re-reading and
re-translating the whole target each time and running each model's
filter cascade in isolation.  At a few hundred models per query file
that leaves every model with a handful of gate survivors per target
chunk -- far too few to fill a device on their own.  The restructure,
as in the JAX package's ``multiquery.py`` (whose ``QState``,
``MQEntry``, ``_combine_*``, ``_dd_server``, ``_entry_views`` and
``flush_multi`` are copied here):

* the target window stream, digitization, and ORF extraction run
  ONCE and are shared by every query (ORF lists are query-independent:
  they depend only on the genetic code and minlen);
* the host filter family (MSV/bias/Viterbi, the native batch) runs per
  query over the shared ORFs, exactly as the numpy backend does;
* every f32 device stage (Forward F3 gate, fused domain decoding,
  fs3-Forward gate, fused fs domain decoding) batches its survivors
  across ALL queries with the model as a batch coordinate -- the
  multi-model kernels of ``ops/multimodel.py``;
* output is buffered per query and written in query order, so bytes
  match the serial per-query loop (``tests/test_torch_multiquery.py``
  asserts it against the numpy backends of both packages).

``--cpu N`` (N > 1) runs the JAX package's query-sharded pool (its
``_mq_pool_init``, ``_mq_pool_task`` and ``_balance_slices`` are copied
too): the queries are cut into N contiguous slices balanced by M, each
slice is one worker's for the whole drive, and every flush's chunk goes
to every worker, which runs ``flush_multi`` on the host for its slice.
The workers keep every stage off the device, as the JAX package's do,
and start from a fresh server process (``parallel/pool.py``), never by
forking this one.

``--mesh N`` deals every packed stage's items round N devices
(``PackedGates``); the pool's workers keep every stage on the host.

Not carried over from the JAX package: its lane packs and size classes
(a model of any length and an item of any length go to the device), its
watchdog and surrender path (a CUDA error propagates, as in
``TorchCascade``) and the compile cache.

Window-boundary note: the serial loop reads windows with per-query
overlap (om->max_length*3, bathsearch.c:1099); the shared stream uses
the maximum over the query set.  A larger overlap only widens window
context; duplicate hits from overlap regions are removed by the same
RemoveDuplicates discipline either way, and each query is handed its
serial ORF set (``gencode.reslice_orfs``), so its filter-count
statistics match the serial run too.  One consequence at database
scale: a query whose serial overlap is smaller than the shared maximum
can see a boundary ORF its serial stream would split, so its per-query
FILTER-COUNT statistics lines may differ by that ORF's residues; hits,
scores, and alignments remain byte-identical.  ``BATH_WINDOW_CONTEXT``
pins one overlap for every drive.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from . import constants as C
from . import phasestats, stats
from .bg import Background
from .device_pipeline import (DOMDEC_CELLS, FS3DOMDEC_CELLS, StageTally,
                              _perturb, batches)
from .gencode import extract_orfs
from .oprofile import oprofile_convert
from .ops import multimodel as mm
from .ops.fs3 import DNA_PAD, fs3_params
from .ops.fwd import PAD_RESIDUE, fwd_params
from .parallel.mesh import Shares
from .parallel.pool import ready, worker_pool
from .pipeline import (DEVICE_GATE_BAND, pipeline_fwd_stage,
                       pipeline_gate_plan, pipeline_gates,
                       statistics_text)
from .profile import profile_config, profile_config_fs
from .scoredata import score_data_create
from .sequence import read_windows
from .tophits import IS_INCLUDED, IS_REPORTED, TopHits

F32 = np.float32

# Device engagement: a stage goes to the device when its pending DP
# volume (cells) reaches its threshold, else the bit-exact host path
# finishes it (identical bytes by the DEVICE_GATE_BAND contract).  The
# default of 0 sends every stage with items to the device, as the
# single-query torch drive does; PackedGates records each stage's
# items, cells and host wall per flush, from which the card's own
# crossover is read (PERF.md).  The variables are read at every flush.
_DEV_MIN_ENV = {
    "fwd": "BATH_MQ_FWD_MIN_CELLS",
    "domdec": "BATH_MQ_DD_MIN_CELLS",
    "fs3": "BATH_MQ_FS3_MIN_CELLS",
    "fs3dd": "BATH_MQ_FSDD_MIN_CELLS",
}


def _dev_min(stage: str) -> float:
    return float(os.environ.get(_DEV_MIN_ENV[stage], 0))


def _stage_cells(items):
    return sum(ln * qs.hmm.M for qs, _d, ln in items)


class QState:
    """Per-query pipeline state for the multi-query drive."""

    def __init__(self, hmm, args, gcode, qi):
        self.hmm = hmm
        self.qi = qi
        self._gcode = gcode
        self.bg = Background()
        self.gm = profile_config(hmm, self.bg, L=100, mode=C.P7_LOCAL)
        self.om = oprofile_convert(self.gm)
        self._gm_fs5 = None      # lazy: only hit display/fs need it
        self.gm_fs3 = None       # fs-gate profile: only built in --fs
        self.om_fs3 = self.om_fs5 = None
        if args.fs or args.fsonly:
            from .ops.reference.fwdback_fs import fs_oprofile_convert
            self.gm_fs3 = profile_config_fs(hmm, self.bg, gcode, 3,
                                            100, C.P7_LOCAL)
            self.om_fs3 = fs_oprofile_convert(self.gm_fs3)
            self.om_fs5 = fs_oprofile_convert(self.gm_fs5)
        self.data = score_data_create(self.om)
        from .cli.bathsearch import make_pipeline
        self.pli = make_pipeline(args)
        self.pli.nmodels = 1
        self.pli.nnodes = hmm.M
        self.pli.W = self.om.max_length
        if self.pli.do_biasfilter:
            self.bg.set_filter(self.om.M, self.om.compo)
        self.th = TopHits()
        self.hit_windows: list = []
        # packed domain-decoding caches, reset per flush
        self.dd_cache: dict = {}
        self.fsdd_cache: dict = {}

    @property
    def gm_fs5(self):
        """Built on first use: only queries with F3 survivors (hit
        display) or --fs mode ever read the 5-codon profile."""
        if self._gm_fs5 is None:
            self._gm_fs5 = profile_config_fs(
                self.hmm, self.bg, self._gcode, 5, 100, C.P7_LOCAL)
        return self._gm_fs5


class PackedGates:
    """The multi-model packs of a query set and the batched device
    calls over them.

    Every query is a slot of one pack per kernel family (Forward gate
    and decoding; the fs3 pair under ``--fs``), built on first use and
    resident on the device, so a flush costs its batch transfers and
    one fetch per stage.  Items are ``(QState, dsq, length)``; results
    align with the items.  Batching is ``device_pipeline.batches``:
    items sorted by length, at most ``BATCH`` to a batch and, for the
    decoding stages, a cap on a batch's padded residues.

    <devices>: the mesh of ``--mesh N``, as ``TorchCascade`` takes it:
    each stage deals its items sorted by length round the devices
    (``parallel/mesh.py`` ``Shares``), every share's batches go out
    before any share is fetched, one fetch a share, and the packs are
    built on each device on first use there.

    <stats>: optional dict the stages add their counts to, under
    ``TorchCascade``'s keys (``fwd_items``, ``fwd_s``, ``domdec_items``,
    ``domdec_ok``, ``domdec_s``, ``fs3_items``, ``fs3_s``,
    ``fs3domdec_items``, ``fs3domdec_ok``, ``fs3domdec_s``, over a mesh
    ``mesh_items``, and the rest of ``device_pipeline.StageTally``'s
    counters: ``fwd_cells``, ``fwd_padded_cells``, ``fwd_batches``,
    ``fwd_dev_s``, ...) plus ``mq_stages``, one ``(stage, items, cells,
    seconds)`` per stage call.  Each public stage is a ``phasestats``
    span ``stage.<name>``."""

    def __init__(self, queries: list[QState], device="cuda", stats=None,
                 devices=None):
        self.queries = queries
        self.devices = [torch.device(d) for d in devices] if devices \
            else [torch.device(device)]
        self.device = self.devices[0]
        self.slot = {q.qi: g for g, q in enumerate(queries)}
        self._M = np.array([q.hmm.M for q in queries], np.int64)
        self._packs: dict = {}
        self.stats = stats if stats is not None else {}
        for key in ("fwd", "domdec", "fs3", "fs3domdec"):
            for k in ("items", "cells", "s"):
                self.stats.setdefault(f"{key}_{k}", 0)
        self.stats.setdefault("domdec_ok", 0)
        self.stats.setdefault("fs3domdec_ok", 0)
        self.stats.setdefault("mq_stages", [])
        self._shares = Shares(self.devices, self.stats)

    def _pack(self, family, dev):
        """The Forward/decoding pack ("std") or the fs3 one ("fs") on
        <dev>."""
        if (family, dev) not in self._packs:
            if family == "std":
                self._packs[(family, dev)] = mm.build_fwd_pack(
                    [fwd_params(q.om, dev) for q in self.queries])
            else:
                self._packs[(family, dev)] = mm.build_fs3_pack(
                    [fs3_params(q.om_fs3, dev) for q in self.queries])
        return self._packs[(family, dev)]

    def _batches(self, items, pad, dev, max_cells=None):
        slot = np.array([self.slot[qs.qi] for qs, _, _ in items], np.int64)
        for idx, dsq, blens in batches(
                [d[:ln] for _, d, ln in items], [ln for _, _, ln in items],
                dev, max_cells=max_cells, pad=pad):
            yield idx, dsq, blens, slot[idx]

    def _split(self, key, items):
        """[(device, the share's items, their indices into <items>)]."""
        return [(dev, items, np.arange(len(items))) if sel is None
                else (dev, [items[i] for i in sel], sel)
                for dev, sel in self._shares(key, [ln for _, _, ln in items])]

    def _count(self, key, items, tally):
        cells = _stage_cells(items)
        dt = tally.close(len(items), cells)
        self.stats["mq_stages"].append((key, len(items), cells // tally.div,
                                        dt))

    def _scores(self, items, call, family, pad, key, cells_div=1):
        """Gate scores (nats) per item: every batch of every share
        launched, then one concatenation and one fetch a share."""
        tally = StageTally(self.stats, key, cells_div)
        shares = []
        for dev, sub, sel in self._split(key, items):
            pack = self._pack(family, dev)
            shares.append([(sel[idx], tally.launch(
                dev, dsq.shape[1] * int(self._M[slot].sum()), call, pack,
                dsq, blens, slot, nj=1.0))
                for idx, dsq, blens, slot in self._batches(sub, pad, dev)])
        out = np.empty(len(items), F32)
        for parts in shares:
            if parts:
                out[np.concatenate([idx for idx, _ in parts])] = \
                    torch.cat([sc for _, sc in parts]).cpu().numpy()
        self._count(key, items, tally)
        return [float(v) for v in _perturb(out)]

    def _decode(self, items, call, family, pad, max_cells, key,
                cells_div=1):
        """(btot, etot, mocc, ok) per item: every batch of every share
        launched, then one flat concatenation and one fetch a share."""
        tally = StageTally(self.stats, key, cells_div)
        shares = []
        for dev, sub, sel in self._split(key, items):
            pack = self._pack(family, dev)
            parts = []
            for idx, dsq, blens, slot in self._batches(sub, pad, dev,
                                                       max_cells):
                bt, et, mo, ok = tally.launch(
                    dev, dsq.shape[1] * int(self._M[slot].sum()), call,
                    pack, dsq, blens, slot)
                parts.append((sel[idx], bt.shape, torch.cat(
                    [bt.reshape(-1), et.reshape(-1), mo.reshape(-1),
                     ok.to(bt.dtype)])))
            shares.append(parts)
        out = [None] * len(items)
        for parts in shares:
            if not parts:
                continue
            flat = torch.cat([f for _, _, f in parts]).cpu().numpy()
            at = 0
            for idx, (b, w), _ in parts:
                post = flat[at:at + 3 * b * w].reshape(3, b, w)
                oks = flat[at + 3 * b * w:at + 3 * b * w + b] != 0
                at += 3 * b * w + b
                for r, i in enumerate(idx):
                    out[i] = (post[0, r], post[1, r], post[2, r],
                              bool(oks[r]))
        self._count(key, items, tally)
        self.stats[f"{key}_ok"] += sum(v[3] for v in out)
        return out

    @phasestats.spanned("stage.fwd_scores")
    def fwd_scores(self, items):
        return self._scores(items, mm.fwd_pack_scores, "std", PAD_RESIDUE,
                            "fwd")

    @phasestats.spanned("stage.domdec")
    def domdec(self, items):
        return self._decode(
            items, lambda p, d, l, s: mm.domdec_pack_batch(p, d, l, s,
                                                           nj=1.0),
            "std", PAD_RESIDUE, DOMDEC_CELLS, "domdec")

    @phasestats.spanned("stage.fs3_scores")
    def fs3_scores(self, items):
        return self._scores(items, mm.fs3_pack_scores, "fs", DNA_PAD, "fs3",
                            cells_div=3)

    @phasestats.spanned("stage.fs3_domdec")
    def fs3_domdec(self, items, dec_loop):
        return self._decode(
            items, lambda p, d, l, s: mm.fs3_domdec_pack_batch(
                p, d, l, s, dec_loop, nj=1.0),
            "fs", DNA_PAD, FS3DOMDEC_CELLS, "fs3domdec", cells_div=3)


class MQEntry:
    __slots__ = ("window", "seqid", "complementarity", "orfs", "tid",
                 "nres_at", "orfs_d")

    def __init__(self, window, seqid, complementarity, orfs, tid,
                 nres_at):
        self.window = window
        self.seqid = seqid
        self.complementarity = complementarity
        self.orfs = orfs
        # {d (nt of extra shared context) -> resliced ORF view}:
        # queries whose serial overlap is smaller than the shared
        # stream's see the serial ORF set (gencode.reslice_orfs);
        # same-overlap queries share one view
        self.orfs_d = {}
        self.tid = tid
        # residue count as of this window in the serial stream: the
        # early domain keep-filter reads pli.Z = nres/max_length at
        # domain-definition time (ref p7_pipeline.c:1230-1249 via
        # _postdomaindef_bath), so each entry must see the serial
        # value, not 0 and not the final total
        self.nres_at = nres_at


class _CombinedOrfs:
    """Flat/offs/lens view spanning every entry of a chunk: the
    native MSV/Viterbi batch interfaces take any object with these
    three arrays, so the host filter family runs ONCE per query per
    flush instead of once per (query, window), saving the per-call
    OpenMP spawn and ctypes marshalling."""
    __slots__ = ("flat", "offs", "lens")

    def __init__(self, flat, offs, lens):
        self.flat = flat
        self.offs = offs
        self.lens = lens

    def __len__(self):
        return len(self.lens)


def _combine_flat(chunk, skip):
    """One concatenated amino stream + per-entry base offsets for the
    whole chunk.  Every overlap group's ORF views share each entry's
    flat buffer (reslice_orfs only rewrites offs/lens), so the
    expensive concat happens ONCE per flush and groups differ only in
    their metadata arrays.  Returns None when any live entry lacks
    the flat layout (pure-Python extractor)."""
    flats, bases = [], []
    base = 0
    for e, sk in zip(chunk, skip):
        if sk or getattr(e.orfs, "flat", None) is None:
            if not sk and e.orfs is not None and len(e.orfs):
                return None
            bases.append(0)
            continue
        f = np.asarray(e.orfs.flat)     # keep the extractor's dtype
        flats.append(f)
        bases.append(base)
        base += len(f)
    if not flats:
        return None
    return (flats[0] if len(flats) == 1 else np.concatenate(flats),
            bases)


def _combine_orfs(orf_lists, skip, shared):
    """Chunk-wide ORF metadata over one overlap group's per-entry ORF
    lists, against the flush-wide flat stream from _combine_flat;
    returns (combined, spans) with spans[k] = (lo, hi) into the
    combined arrays, or (None, _) when the flat layout is absent."""
    if shared is None:
        return None, None
    flat_all, bases = shared
    offs, lens, spans = [], [], []
    cnt = 0
    for ol, sk, base in zip(orf_lists, skip, bases):
        if sk or getattr(ol, "flat", None) is None:
            spans.append((cnt, cnt))
            continue
        offs.append(np.asarray(ol.offs, np.int64) + base)
        lens.append(np.asarray(ol.lens, np.int32))
        spans.append((cnt, cnt + len(ol)))
        cnt += len(ol)
    if not offs:
        return None, None
    return _CombinedOrfs(flat_all, np.concatenate(offs),
                         np.concatenate(lens)), spans


def _dd_server(cache):
    """domdec_fn facade: serve device posteriors precomputed for the
    predicted survivor set; unknown items report ok=False (host
    Backward fallback — correctness never depends on the cache)."""
    def fn(orfseqs, dec_loop=None):
        btot, etot, mocc, ok = [], [], [], []
        for sq in orfseqs:
            v = cache.get(id(sq))
            if v is None:
                btot.append(None)
                etot.append(None)
                mocc.append(None)
                ok.append(False)
            else:
                btot.append(v[0])
                etot.append(v[1])
                mocc.append(v[2])
                ok.append(bool(v[3]))
        return btot, etot, mocc, ok
    return fn


def _phase_clock(stats: dict):
    """mark(name) adds the host wall since the previous mark to
    ``stats["mq_phase_s"][name]``: where a flush's time goes (host
    gates, the device stages with their waits, the host Forward stage
    and domain definition, the fs branch)."""
    phases = stats.setdefault("mq_phase_s", {})
    last = [time.perf_counter()]

    def mark(name):
        now = time.perf_counter()
        phases[name] = phases.get(name, 0.0) + now - last[0]
        last[0] = now
    return mark


def _entry_views(chunk, skip, ctx_q, gcode, minlen, require_init):
    """Per-entry (orfs, d) for one window-overlap group: d is the
    extra shared context beyond the group's serial overlap <ctx_q>,
    and orfs is the serial ORF set (gencode.reslice_orfs) when d > 0.
    ctx_q < 0 means the shared list verbatim (the largest query, or
    a pinned configuration)."""
    from .gencode import reslice_orfs
    out = []
    for e, sk in zip(chunk, skip):
        d = 0
        if not sk and ctx_q >= 0:
            d = max(0, (e.window.n - e.window.W) - ctx_q)
        if d <= 0 or d % 3:
            # d % 3 != 0 only under exotic --block_length < overlap
            # configs; keep the shared list there (the pre-r5
            # documented divergence) rather than mis-slice
            out.append((e.orfs, 0))
            continue
        v = e.orfs_d.get(d)
        if v is None:
            v = reslice_orfs(
                e.orfs, d, L=e.window.n,
                is_revcomp=bool(e.complementarity), minlen=minlen,
                require_initiator=require_init, gcode=gcode,
                dsq=e.window.dsq)
            e.orfs_d[d] = v
        out.append((v, d))
    return out


def flush_multi(chunk: list[MQEntry], queries: list[QState],
                pg: PackedGates, gcode, fs_mode: bool,
                minlen: int = 20, require_init: bool = False,
                ctx_pinned: bool = False) -> None:
    """One chunk through the multi-query staged cascade.  Entries are
    processed in stream order within each query at every phase, so
    each query's hit ordering (and output bytes) match its serial
    per-query run.

    Byte parity includes the per-query statistics block: each
    window-overlap group sees its SERIAL ORF set via reslice_orfs
    (+ serial fs-window clamp bounds), so filter-stage residue
    counters match the serial per-query stream exactly (VERDICT r4
    item 7; ref bathsearch.c:1099, p7_pipeline.c:1835).
    <ctx_pinned>: BATH_WINDOW_CONTEXT pinned the overlap for every
    backend — no reslicing."""
    from .pipeline_fs import fs_gate_and_define, fs_prepare
    mark = _phase_clock(pg.stats)

    nq = len(queries)
    ne = len(chunk)
    skip = [e.orfs is None or len(e.orfs) == 0 or e.window.n < 15
            for e in chunk]

    # Phase A: host gates (native MSV/bias/Vit + captures) per (q, e)
    gates: dict = {}
    hits_qe = [[TopHits() for _ in range(ne)] for _ in range(nq)]
    wspan = [[None] * ne for _ in range(nq)]
    qgroups: dict = {}
    for qi, qs in enumerate(queries):
        # group key = the query's own serial overlap; _entry_views
        # derives d per entry from the window's ACTUAL carried
        # context (n - W), so the stream-wide max query naturally
        # gets d=0 — no shortcut keyed on a local max, which would
        # be wrong for a sub-list of the query set
        key = -1 if ctx_pinned else qs.om.max_length * 3
        qgroups.setdefault(key, []).append(qi)
    views = [None] * nq                 # per-query per-entry (orfs, d)
    comb_of = [None] * nq
    shared_flat = _combine_flat(chunk, skip)
    for key, qis in qgroups.items():
        ov = _entry_views(chunk, skip, key, gcode, minlen,
                          require_init)
        cg = _combine_orfs([o for o, _ in ov], skip, shared_flat)
        for qi in qis:
            views[qi] = ov
            comb_of[qi] = cg
    from .native import msv_filter_native_batch, vit_filter_score_batch
    for qi, qs in enumerate(queries):
        combined, cspans = comb_of[qi]
        # ONE native MSV call per query over the whole chunk's ORFs
        usc_all = msv_filter_native_batch(combined, qs.om) \
            if combined is not None else None
        plans = [None] * ne
        for k, e in enumerate(chunk):
            if skip[k]:
                continue
            lo, hi = cspans[k] if usc_all is not None else (0, 0)
            plans[k] = pipeline_gate_plan(
                qs.pli, qs.om, qs.bg, e.window, views[qi][k][0],
                usc_pre=None if usc_all is None else usc_all[lo:hi])
        # ONE native ViterbiFilter call per query over the chunk's
        # bias survivors (bit-identical to the per-window batch)
        vslices = [None] * ne
        if combined is not None:
            vidx = []
            for k in range(ne):
                p = plans[k]
                if p is not None and p.vit_idx is not None \
                        and len(p.vit_idx):
                    vidx.append(cspans[k][0] + p.vit_idx)
            if vidx:
                gidx = np.concatenate(vidx)
                vsc = vit_filter_score_batch(combined, gidx, qs.om)
                if vsc is not None:
                    pos = 0
                    for k in range(ne):
                        p = plans[k]
                        nv = len(p.vit_idx) if p is not None and \
                            p.vit_idx is not None else 0
                        if nv:
                            vslices[k] = vsc[pos:pos + nv]
                            pos += nv
        for k, e in enumerate(chunk):
            if skip[k]:
                gates[(qi, k)] = ([], [], [], [])
                wspan[qi][k] = (len(qs.hit_windows),
                                len(qs.hit_windows))
                continue
            lo = len(qs.hit_windows)
            res = pipeline_gates(qs.pli, qs.om, qs.data, qs.bg,
                                 e.window, views[qi][k][0],
                                 qs.hit_windows,
                                 e.seqid, e.complementarity,
                                 plan=plans[k], vitsc=vslices[k])
            gates[(qi, k)] = res
            wspan[qi][k] = (lo, len(qs.hit_windows))

    mark("gates")
    # Phase B: packed Forward gate over every candidate of every query
    items = []
    spans: dict = {}
    for qi, qs in enumerate(queries):
        for k in range(ne):
            cands = gates[(qi, k)][0]
            lo = len(items)
            items.extend((qs, c.orfsq.dsq, c.orfsq.n) for c in cands)
            spans[(qi, k)] = (lo, len(items))
    use_fwd = items and _stage_cells(items) >= _dev_min("fwd")
    fwd_all = pg.fwd_scores(items) if use_fwd else [None] * len(items)
    mark("fwd")

    # Phase C (std): predicted F3 survivors -> packed domain decoding
    if not fs_mode:
        dd_items = []
        dd_keys = []
        for qi, qs in enumerate(queries):
            qs.dd_cache = {}
            tau = qs.om.evparam[C.EV_FTAU]
            lam = qs.om.evparam[C.EV_FLAMBDA]
            thr = qs.pli.F3 * DEVICE_GATE_BAND
            for k in range(ne):
                lo, hi = spans[(qi, k)]
                cands = gates[(qi, k)][0]
                for ci, cand in enumerate(cands):
                    sc = fwd_all[lo + ci]
                    if sc is None:
                        continue
                    P = float(stats.exp_surv(
                        (sc - cand.filtersc) / C.CONST_LOG2, tau, lam))
                    if not (P > thr):
                        dd_items.append((qs, cand.orfsq.dsq,
                                         cand.orfsq.n))
                        dd_keys.append((qs, id(cand.orfsq)))
        if dd_items and _stage_cells(dd_items) >= _dev_min("domdec"):
            for (qs, key), post in zip(dd_keys, pg.domdec(dd_items)):
                qs.dd_cache[key] = post

    mark("domdec")
    # Phase D: host F3/F4 stage + domain definition per (q, e)
    for qi, qs in enumerate(queries):
        dd_fn = _dd_server(qs.dd_cache) \
            if not fs_mode and qs.dd_cache else None
        for k, e in enumerate(chunk):
            if skip[k]:
                continue
            cands, P_orf, fwdsc_arr, oxf_holder = gates[(qi, k)]
            lo, hi = spans[(qi, k)]
            fwd_dev = None
            if use_fwd and hi > lo:
                fwd_dev = np.array(fwd_all[lo:hi], F32)
            qs.pli.nres = e.nres_at
            pipeline_fwd_stage(qs.pli, qs.om, qs.gm, qs.gm_fs5, qs.bg,
                               hits_qe[qi][k], e.seqid, e.window,
                               qs.hit_windows, e.complementarity,
                               cands, P_orf, fwdsc_arr, oxf_holder,
                               fwd_dev=fwd_dev, domdec_fn=dd_fn)

    mark("fwd_stage")
    # Phase E (fs): window prep per (q, e), then the packed fs3 gate
    if fs_mode:
        fs_cands: dict = {}
        fs_widx: dict = {}
        fs_items = []
        fs_spans: dict = {}
        for qi, qs in enumerate(queries):
            for k, e in enumerate(chunk):
                if skip[k]:
                    fs_cands[(qi, k)] = []
                    fs_spans[(qi, k)] = (len(fs_items), len(fs_items))
                    continue
                _, P_orf, fwdsc_arr, _ = gates[(qi, k)]
                widx: dict = {}
                lo0, _hi0 = wspan[qi][k]
                ol, d = views[qi][k]
                # serial fs-window clamp bounds: the serial window is
                # d nt shorter at its context edge (left for forward,
                # right for revcomp — revcomp(x[d:]) is a prefix)
                bnd = None
                if d:
                    bnd = (1, e.window.n - d) if e.complementarity \
                        else (d + 1, e.window.n)
                cs = fs_prepare(qs.pli, qs.om, qs.data, qs.bg, ol,
                                e.window, gcode, P_orf, fwdsc_arr,
                                qs.hit_windows[lo0:],
                                e.complementarity, widx=widx,
                                bounds=bnd)
                fs_cands[(qi, k)] = cs
                fs_widx[(qi, k)] = widx
                lo = len(fs_items)
                fs_items.extend((qs, c.tmpseq.dsq, c.wlen)
                                for c in cs)
                fs_spans[(qi, k)] = (lo, len(fs_items))
        use_fs3 = fs_items and \
            _stage_cells(fs_items) / 3 >= _dev_min("fs3")
        fs3_all = pg.fs3_scores(fs_items) if use_fs3 \
            else [None] * len(fs_items)
        mark("fs3")

        # Phase F: predicted fs survivors -> packed fs domain decoding
        fsdd_items = []
        fsdd_keys = []
        for qi, qs in enumerate(queries):
            qs.fsdd_cache = {}
            tau = qs.om_fs3.evparam[C.EV_FTAUFS3]
            lam = qs.om_fs3.evparam[C.EV_FLAMBDA]
            thr = qs.pli.F3 * DEVICE_GATE_BAND
            for k in range(ne):
                lo, hi = fs_spans[(qi, k)]
                for ci, cand in enumerate(fs_cands[(qi, k)]):
                    sc = fs3_all[lo + ci]
                    if sc is None:
                        continue
                    P = float(stats.exp_surv(
                        (sc - cand.filtersc) / C.CONST_LOG2, tau, lam))
                    if not (P > thr):
                        fsdd_items.append((qs, cand.tmpseq.dsq,
                                           cand.wlen))
                        fsdd_keys.append((qs, id(cand.tmpseq)))
        if fsdd_items and \
                _stage_cells(fsdd_items) / 3 >= _dev_min("fs3dd"):
            for (qs, key), post in zip(
                    fsdd_keys,
                    pg.fs3_domdec(fsdd_items, 100.0 / 103.0)):
                qs.fsdd_cache[key] = post
        mark("fs3domdec")

        # Phase G: arbitration + fs domain definition per (q, e)
        for qi, qs in enumerate(queries):
            fsdd_fn = _dd_server(qs.fsdd_cache) \
                if qs.fsdd_cache else None
            for k, e in enumerate(chunk):
                if skip[k]:
                    continue
                _, P_orf, _fw, oxf_holder = gates[(qi, k)]
                lo, hi = fs_spans[(qi, k)]
                fs3_dev = None
                if use_fs3 and hi > lo:
                    fs3_dev = np.array(fs3_all[lo:hi], F32)

                def _fsdd(seqs, dec_loop, _fn=fsdd_fn):
                    return _fn(seqs)
                if fsdd_fn is None:
                    _fsdd = None
                qs.pli.nres = e.nres_at
                fs_gate_and_define(
                    qs.pli, qs.om, qs.gm, qs.om_fs3, qs.om_fs5,
                    qs.gm_fs5, qs.bg, hits_qe[qi][k], e.seqid,
                    views[qi][k][0], e.window, gcode, P_orf,
                    oxf_holder, e.complementarity, fs_cands[(qi, k)],
                    fs3_dev=fs3_dev, fs_domdec_fn=_fsdd,
                    widx=fs_widx[(qi, k)])

    mark("fs_define" if fs_mode else "tail")
    # hits flow into each query's global list in entry (stream) order
    for qi, qs in enumerate(queries):
        for k in range(ne):
            qs.th.unsrt.extend(hits_qe[qi][k].unsrt)
    chunk.clear()


# ---------------------------------------------------------------------
# Query-sharded pool (bathsearch --cpu N on a multi-HMM query file).
# The per-query work of a flush — host gates, Forward stage, fs branch —
# is independent across queries, so N workers each take a contiguous
# query slice (balanced by sum-of-M) and run flush_multi for the SAME
# chunk on their own QStates; hits and counter deltas return to the
# canonical QStates in query order, so bytes equal the serial drive.
# The shared window stream and ORF extraction still happen ONCE.
# Device stages are disabled inside workers (the packed batching is
# cross-query, which a query-sharded pool forgoes).  Slice i is worker
# i's for the whole drive: a worker holds its slice's QStates alone.
# ---------------------------------------------------------------------
_MQCTX = None

_MQ_COUNTERS = ("n_past_msv", "n_past_bias", "n_past_vit",
                "n_past_fwd", "n_output", "pos_past_msv",
                "pos_past_bias", "pos_past_vit", "pos_past_fwd",
                "pos_output")


def _mq_pool_init(wthreads):
    from .native import set_native_threads
    set_native_threads(wthreads)
    for k in _DEV_MIN_ENV:             # never device-dispatch in a worker
        os.environ[_DEV_MIN_ENV[k]] = "inf"


def _mq_pool_task(task):
    chunk, lo, hi = task
    c = _MQCTX
    queries = c["queries"][lo:hi]
    before_n = [len(q.th.unsrt) for q in queries]
    before_c = [{f: getattr(q.pli, f) for f in _MQ_COUNTERS}
                for q in queries]
    flush_multi(list(chunk), queries, c["pg"], c["gcode"],
                c["fs_mode"], minlen=c["minlen"],
                require_init=c["require_init"],
                ctx_pinned=c["ctx_pinned"])
    out = []
    for q, bn, cb in zip(queries, before_n, before_c):
        out.append((q.qi, q.th.unsrt[bn:],
                    {f: getattr(q.pli, f) - cb[f]
                     for f in _MQ_COUNTERS}))
    return out


def _balance_slices(weights, n):
    """Contiguous [lo, hi) query slices with ~equal total weight."""
    total = float(sum(weights)) or 1.0
    bounds = [0]
    acc = 0.0
    target = total / n
    for i, w in enumerate(weights):
        acc += w
        if acc >= target * len(bounds) and len(bounds) < n:
            bounds.append(i + 1)
    while len(bounds) < n + 1:
        bounds.append(len(weights))
    bounds[-1] = len(weights)
    return [(bounds[i], bounds[i + 1]) for i in range(n)
            if bounds[i] < bounds[i + 1]]


def run_multiquery(args, hmms, gcode, require_init, ofp, tblfp,
                   fstblfp, device="cuda", stats=None,
                   devices=None) -> None:
    """The multi-query drive: shared window stream + packed device
    gates; per-query output buffered and written in query order.
    <device>, <stats>, <devices>: as PackedGates takes them.  With
    ``args.cpu`` > 1 every flush runs in the query-sharded pool; <stats>
    then gets its start and its workers' reports (``parallel/pool.py``)
    and no device stage."""
    t_start = time.time()
    queries = [QState(h, args, gcode, qi)
               for qi, h in enumerate(hmms)]
    pg = PackedGates(queries, device=device, stats=stats, devices=devices)
    fs_mode = bool(args.fs or args.fsonly)

    ctx_pinned = bool(int(os.environ.get("BATH_WINDOW_CONTEXT", 0)))
    context = int(os.environ.get("BATH_WINDOW_CONTEXT", 0)) \
        or max(q.om.max_length for q in queries) * 3
    id_lengths: dict = {}
    nres = 0
    nseqs = 0
    seqidx = 0
    db_started = args.restrictdb_stkey is None
    db_seqs_done = 0
    strands = queries[0].pli.strands
    block_length = queries[0].pli.block_length

    CHUNK_ORFS = int(os.environ.get("BATH_CHUNK_ORFS", 1 << 20))
    chunk: list = []
    pending = 0
    tid = 0

    ncpu = max(0, int(getattr(args, "cpu", 0) or 0))
    pools: list = []
    slices = _balance_slices([q.hmm.M for q in queries], ncpu) \
        if ncpu > 1 else []
    wthreads = max(1, (os.cpu_count() or 1) // max(1, ncpu))

    def _flush():
        if pools:
            tasks = [pool.submit(_mq_pool_task, (chunk, 0, hi - lo))
                     for pool, (lo, hi) in zip(pools, slices)]
            for t in tasks:
                for qi, hits, deltas in t.result():
                    queries[qi].th.unsrt.extend(hits)
                    qp = queries[qi].pli
                    for f, v in deltas.items():
                        setattr(qp, f, getattr(qp, f) + v)
            chunk.clear()
            return
        flush_multi(chunk, queries, pg, gcode, fs_mode,
                    minlen=args.minlen, require_init=require_init,
                    ctx_pinned=ctx_pinned)

    with contextlib.ExitStack() as stack:
        # one single-worker pool a slice: slice i goes to the same
        # worker at every flush, which holds its slice's QStates alone
        # (a worker's context is pickled once, when it starts)
        for lo, hi in slices:
            part = queries[lo:hi]
            pools.append(stack.enter_context(worker_pool(
                1, __name__, "_MQCTX",
                dict(queries=part, pg=PackedGates(part, device=device),
                     gcode=gcode, fs_mode=fs_mode, minlen=args.minlen,
                     require_init=require_init, ctx_pinned=ctx_pinned),
                initializer=_mq_pool_init, initargs=(wthreads,),
                stats=stats)))
        ready(pools, pg.stats)
        for window, is_last in read_windows(args.dbfile, context=context,
                                            block_length=block_length):
            if not db_started:
                if window.name == args.restrictdb_stkey:
                    db_started = True
                else:
                    continue
            if args.restrictdb_n > 0 and db_seqs_done >= args.restrictdb_n:
                break
            if is_last:
                db_seqs_done += 1
            if window.n < 15:
                if is_last:
                    id_lengths[window.idx] = window.start + window.n - 1
                    nseqs += 1
                    seqidx += 1
                continue
            window.L = window.n
            seqid_for_hits = nseqs
            # serial nres semantics: both strands counted BEFORE the
            # window is processed (cli window_specs increments then
            # yields), so both entries carry the post-increment value
            if strands != C.STRAND_BOTTOMONLY:
                nres += window.W
            if strands != C.STRAND_TOPONLY:
                nres += window.W
            if strands != C.STRAND_BOTTOMONLY:
                orfs = extract_orfs(gcode, window.dsq, minlen=args.minlen,
                                    require_initiator=require_init)
                chunk.append(MQEntry(window, seqid_for_hits,
                                     C.NOCOMPLEMENT, orfs, tid, nres))
                pending += len(orfs)
            if strands != C.STRAND_TOPONLY:
                rc = window.reverse_complement()
                orfs = extract_orfs(gcode, rc.dsq, minlen=args.minlen,
                                    is_revcomp=True,
                                    require_initiator=require_init)
                chunk.append(MQEntry(rc, seqid_for_hits, C.COMPLEMENT,
                                     orfs, tid, nres))
                pending += len(orfs)
            tid += 1
            if is_last:
                id_lengths[window.idx] = window.start + window.n - 1
                nseqs += 1
                seqidx += 1
            if pending >= CHUNK_ORFS:
                _flush()
                pending = 0
        if chunk:
            _flush()

    # per-query E-values / merge / output, in query order
    # (ref: bathsearch.c:869-921 + output block :960-968)
    for nquery, qs in enumerate(queries, 1):
        pli, th, om, hmm = qs.pli, qs.th, qs.om, qs.hmm
        pli.nres = nres
        pli.nseqs = nseqs
        if args.Z is not None:
            res_cnt = int(1000000 * args.Z)
            if pli.strands == C.STRAND_BOTH:
                res_cnt *= 2
        else:
            res_cnt = pli.nres
        th.compute_evalues_bath(res_cnt, om.max_length * 3)
        th.sort_by_seqidx_and_alipos()
        for h in th.unsrt:
            if h.seqidx in id_lengths:
                h.target_len = id_lengths[h.seqidx]
                if h.dcl and h.dcl[0].ad is not None:
                    h.dcl[0].ad.L = id_lengths[h.seqidx]
        th.remove_duplicates(pli.use_bit_cutoffs)
        th.sort_by_sortkey()
        pli.Z = 1.0
        th.threshold(pli)

        pli.n_output = pli.pos_output = 0
        for h in th.hit:
            if h.flags & (IS_REPORTED | IS_INCLUDED):
                pli.n_output += 1
                for d in h.dcl:
                    pli.pos_output += 1 + abs(d.jali - d.iali)

        textw = 0 if args.notextw else args.textw
        ofp.write("Query:       %s  [M=%d]\n" % (hmm.name, hmm.M))
        if hmm.acc:
            ofp.write("Accession:   %s\n" % hmm.acc)
        if hmm.desc:
            ofp.write("Description: %s\n" % hmm.desc)
        ofp.write(th.targets_text(pli, textw))
        ofp.write("\n\n")
        ofp.write(th.domains_text(pli, textw))
        ofp.write("\n\n")
        if tblfp:
            tblfp.write(th.tabular_targets_text(
                hmm.name, hmm.acc, pli, nquery == 1))
        if fstblfp:
            fstblfp.write(th.tabular_frameshifts_text(
                hmm.name, hmm.acc, pli, nquery == 1))
        ofp.write(statistics_text(pli, time.time() - t_start))
        ofp.write("//\n")
        if stats is not None:
            # the host fills of this process (a pool's workers keep
            # their own)
            stats["rescore_host_items"] = \
                stats.get("rescore_host_items", 0) + pli.ddef.host_fills
