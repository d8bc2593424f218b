"""The device stages of the chunked bathsearch cascade, on a GPU.

``TorchCascade`` has the surface of the JAX package's
``DeviceCascade``, and the host orchestration below it (``ChunkEntry``,
``flush_gates``, ``flush_downstream``) is that package's own, copied
with its imports.  The f32 stages run on the device:

- ``fwd_scores``: the Forward-parser gate (F3) over every Viterbi
  survivor of a flush (``ops/fwd.py``);
- ``domdec``: fused Forward + Backward + domain decoding over every F3
  survivor (``ops/domdec.py``);
- ``fs3_scores``: the fs3-Forward gate (F4) over every merged DNA
  window of a flush (``ops/fs3.py``);
- ``fs3_domdec``: fused fs3 Forward + Backward + frameshift domain
  decoding over the windows that pass the gate and arbitration
  (``ops/fs3_domdec.py``);
- ``rescore``: the standard branch's envelope fills (the unihit Forward
  and Backward, posterior decoding and the optimal-accuracy fill, bit
  for bit the native host fills) of every envelope of a flush
  (``ops/rescore.py``); the host keeps the OA trace, null2 and the rest
  of rescoring.

The integer filters run on the device when ``flush_gates`` selects
them, as in the JAX package: ``BATH_MSV_DEVICE=1`` and
``BATH_VIT_DEVICE=1`` (by default they stay in the native host
library, the bias filter always does):

- ``msv_scores``: MSV/SSV (F1) over every ORF of a flush, read in
  place from the flush's one residue stream (``ops/ssv.py``);
- ``ssv_captures``: the SSV_BATH window capture over the bias
  survivors already under F2 (``ops/ssv.py``);
- ``vit_scores``: the ViterbiFilter (F2) over every bias survivor
  (``ops/vit.py``);
- ``vit_captures``: the ViterbiFilter_BATH capture over the F2
  survivors (``ops/vit.py``).

There is no watchdog and no host fallback: a CUDA error propagates to
the caller.  The only host rescans are the reference's own: items whose
SSV capture overflows its 16 slots.

Batching: the f32 stages sort items by length and cut them into
batches of at most ``BATCH`` items, each padded to its own longest
item; the decoding stages also cap a batch's padded residues.  The
integer filters take every item of a stage in one launch, each read at
its offset in one residue stream.  The envelope fills take one block an
envelope, unpadded, in launches whose outputs fit ``RESCORE_BYTES``.  A
GPU needs no fixed shape buckets, so there is no length cap either.
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from . import constants as C
from . import phasestats
from .ops.domdec import domdec as domdec_kernel
from .ops.fs3 import DNA_PAD, fs3_params, fs3_score
from .ops.fs3_domdec import fs3_domdec as fs3_domdec_kernel
from .ops.fwd import PAD_RESIDUE, fwd_params, fwd_score
from .ops.kernels.loader import Launch
from .ops.rescore import batch_plan as rescore_plan
from .ops.rescore import launch as rescore_launch
from .ops.rescore import rescore_params
from .ops.ssv import (SSVB_NCAP, msv_params, msv_post, msv_ssv,
                      pack_stream, ssv_capture)
from .ops.vit import vit_capture, vit_ints, vit_params
from .parallel.mesh import Shares
from .stats import gumbel_invsurv

F32 = np.float32

BATCH = 4096
# decoding keeps f64 forward specials and three f32 increment rows per
# residue: at most this many padded residues to a batch (~1 GB)
DOMDEC_CELLS = 1 << 24
# fs3 decoding keeps twelve f64 specials per nucleotide, and the
# combine as many f64 rows again: at most this many padded nucleotides
# to a batch (~1 GB)
FS3DOMDEC_CELLS = 1 << 22


def batches(seqs, lens, device, batch: int = BATCH,
            max_cells: int | None = None, pad: int = PAD_RESIDUE):
    """Yields (indices, dsq [b, Lb] int8, lens [b] int32) on <device>:
    items sorted by length, at most <batch> to a batch and, with
    <max_cells>, at most that many padded residues (one item at
    least), each batch padded with the missing-data residue <pad> to
    its longest item."""
    lens = np.asarray(lens, np.int64)
    order = np.argsort(lens, kind="stable")
    c0 = 0
    while c0 < len(order):
        end = min(len(order), c0 + batch)
        c1 = end
        if max_cells is not None:
            # sorted ascending: the padded size is count * last length
            c1 = c0 + 1
            while c1 < end and (c1 + 1 - c0) * lens[order[c1]] <= max_cells:
                c1 += 1
        idx = order[c0:c1]
        c0 = c1
        Lb = max(1, int(lens[idx].max()))
        dsq = np.full((len(idx), Lb), pad, np.int8)
        for r, i in enumerate(idx):
            dsq[r, :lens[i]] = np.asarray(seqs[i], np.int8)
        yield (idx, torch.from_numpy(dsq).to(device),
               torch.from_numpy(lens[idx].astype(np.int32)).to(device))


class StageTally:
    """The counters of one call of a device stage, added to <stats>
    under <key> by ``close``, after the stage's read-back:
    ``<key>_items``; ``<key>_cells``, the items' residues x M;
    ``<key>_padded_cells``, each batch's rows x padded width x M (the
    integer filters read their items in place: their cells);
    ``<key>_batches``, the launch calls; ``<key>_s``, the host wall
    from the tally's making to ``close``; and, with ``phasestats`` on
    and on a card, ``<key>_dev_s``: the card's time for the stage's
    kernels, a pair of CUDA events round each bare launch that a
    batch's launch call makes (``loader.Launch``), read after the
    read-back has synchronised.  The events leave out the wrapper's
    check, its read-back and its plan, which the host makes while the
    card waits, and the small PyTorch ops round the kernel.  <div>
    divides the cells (3: the fs3 stages count nucleotides / 3)."""

    def __init__(self, stats: dict, key: str, div: int = 1):
        self.stats, self.key, self.div = stats, key, div
        self.t0 = time.perf_counter()
        self.padded = self.batches = 0
        self.events: list = []

    def launch(self, dev, padded: int, call, *args, **kwargs):
        """<call>(*args, **kwargs): one batch of <padded> cells on
        <dev>."""
        self.batches += 1
        self.padded += padded
        if not (phasestats.on() and dev.type == "cuda"):
            return call(*args, **kwargs)
        Launch.timing = (dev, self.events)
        try:
            return call(*args, **kwargs)
        finally:
            Launch.timing = None

    def close(self, items: int, cells: int) -> float:
        """Adds the call's counters; returns its host wall."""
        st, k = self.stats, self.key
        for name, v in (("items", items), ("cells", cells // self.div),
                        ("padded_cells", self.padded // self.div),
                        ("batches", self.batches)):
            st[f"{k}_{name}"] = st.get(f"{k}_{name}", 0) + v
        if self.events:
            st[f"{k}_dev_s"] = st.get(f"{k}_dev_s", 0.0) + sum(
                a.elapsed_time(b) for a, b in self.events) / 1e3
        dt = time.perf_counter() - self.t0
        st[f"{k}_s"] = st.get(f"{k}_s", 0) + dt
        return dt


def _perturb(scores: np.ndarray) -> np.ndarray:
    """Test hook (BATH_DEVICE_PERTURB=<nats>): inject alternating-sign
    error into the device gate scores.  tests/test_device_pipeline.py
    drives this up to the DEVICE_GATE_BAND bound to prove output bytes
    are invariant to device-score error within the band."""
    eps = float(os.environ.get("BATH_DEVICE_PERTURB", 0) or 0)
    if not eps:
        return scores
    if eps < 0:                  # uniform downward error (worst case)
        signs = np.ones(len(scores))
    else:                        # alternating-sign error
        signs = np.where(np.arange(len(scores)) % 2 == 0, 1.0, -1.0)
    return np.where(np.isfinite(scores),
                    scores + np.float32(eps) * signs,
                    scores).astype(np.float32)



class TorchCascade:
    """Per-query device stages for the chunked cascade.

    <om_fs3>: the fs3 profile (``FSOProfile``) of ``--fs``/``--fsonly``.
    <devices>: the mesh of ``--mesh N`` (``parallel/mesh.py``
    ``mesh_devices``), a list of torch devices that may repeat one;
    without it the one <device>.  Over a mesh every stage splits its
    items into one share a device (the items sorted by length and dealt
    round the shares; the integer filters pack each share's items into
    a residue stream of its own), goes out to every share before any
    share is read back, and scatters the results to item order; a
    share's items give what they give alone,
    so the results do not depend on the mesh.  The profile tables go to
    each device once.
    <stats>: optional dict the cascade adds its counts to: F3
    candidates scored (``fwd_items``), F3 survivors decoded
    (``domdec_items``), those whose device posteriors were valid
    (``domdec_ok``), the same for the fs3 gate's DNA windows
    (``fs3_items``) and the fs-branch windows decoded
    (``fs3domdec_items``, ``fs3domdec_ok``), the envelopes filled
    (``rescore_items``), the integer filters' items
    (``msv_items``, ``vit_items``, ``ssvcap_items``, ``vitcap_items``)
    and the SSV captures with more than 16 events, which the host
    rescans (``ssvcap_overflow``), and the host wall inside each stage,
    transfers and the wait for the device included (``fwd_s``,
    ``domdec_s``, ``fs3_s``, ``fs3domdec_s``, ``rescore_s``, ``msv_s``,
    ``vit_s``, ``ssvcap_s``, ``vitcap_s``); each stage's ``StageTally``
    counters besides (``fwd_cells``, ``fwd_padded_cells``, ``fwd_batches`` and,
    with ``phasestats`` on and on a card, ``fwd_dev_s``; the same for
    each key); over a mesh also ``mesh_items``: {stage key: [items of
    share 0, share 1, ...]}.  Each public stage is a ``phasestats``
    span ``stage.<name>``."""

    def __init__(self, om, om_fs3=None, device="cuda", stats=None,
                 devices=None):
        self.om = om
        self.devices = [torch.device(d) for d in devices] if devices \
            else [torch.device(device)]
        self.device = self.devices[0]
        once = list(dict.fromkeys(self.devices))
        self._fwd = {d: fwd_params(om, d) for d in once}
        self._fs3 = None if om_fs3 is None else {d: fs3_params(om_fs3, d)
                                                 for d in once}
        self._int: dict = {}
        self._resc: dict = {}
        self.stats = stats if stats is not None else {}
        self._shares = Shares(self.devices, self.stats)
        for k in ("fwd_items", "domdec_items", "domdec_ok", "fwd_s",
                  "domdec_s", "fs3_items", "fs3domdec_items",
                  "fs3domdec_ok", "fs3_s", "fs3domdec_s", "msv_items",
                  "msv_s", "vit_items", "vit_s", "ssvcap_items",
                  "ssvcap_overflow", "ssvcap_s", "vitcap_items",
                  "vitcap_s", "rescore_items", "rescore_s"):
            self.stats.setdefault(k, 0)

    def _scores(self, score, params, seqs, lens, pad, key,
                div=1) -> np.ndarray:
        """Gate scores (nats, f32) per item through <score> with the
        device's <params>: sorted batches of every share launched, then
        scattered back; counted by a ``StageTally`` under <key>."""
        tally = StageTally(self.stats, key, div)
        n, M = len(lens), self.om.M
        out = np.empty(n, np.float32)
        parts = []
        for dev, items in self._shares(key, lens):
            sq, ln = (seqs, lens) if items is None else \
                ([seqs[i] for i in items], np.asarray(lens)[items])
            parts += [(idx if items is None else items[idx],
                       tally.launch(dev, dsq.numel() * M, score, dsq, blens,
                                    params[dev], nj=1.0))
                      for idx, dsq, blens in batches(sq, ln, dev, pad=pad)]
        for idx, sc in parts:
            out[idx] = sc.cpu().numpy()
        tally.close(n, int(np.sum(lens)) * M)
        return _perturb(out)

    def _decode(self, decode, seqs, max_cells, pad, key, div=1):
        """(btot, etot, mocc, ok) per item through <decode>(dsq, lens,
        device): rows sliceable to n+1, and ok=False where the caller
        must run the host parsers; the shares' batches go out a round at
        a time, a batch of every share, before the round is read back;
        counts ``<key>_ok`` and, by a ``StageTally``, the rest."""
        tally = StageTally(self.stats, key, div)
        n, M = len(seqs), self.om.M
        btot, etot, mocc = [None] * n, [None] * n, [None] * n
        ok = np.zeros(n, bool)
        lens = np.asarray([s.n for s in seqs], np.int64)
        runs = []
        for dev, items in self._shares(key, lens):
            sq = seqs if items is None else [seqs[i] for i in items]
            runs.append((dev, items, batches(
                [s.dsq for s in sq], lens if items is None else lens[items],
                dev, max_cells=max_cells, pad=pad)))
        while runs:
            launched, going = [], []
            for dev, items, gen in runs:
                b = next(gen, None)
                if b is None:
                    continue
                going.append((dev, items, gen))
                idx, dsq, blens = b
                launched.append((idx if items is None else items[idx],
                                 tally.launch(dev, dsq.numel() * M, decode,
                                              dsq, blens, dev)))
            runs = going
            for idx, res in launched:
                bt, et, mo, okv = (t.cpu().numpy() for t in res)
                for r, i in enumerate(idx):
                    btot[i], etot[i], mocc[i] = bt[r], et[r], mo[r]
                ok[idx] = okv
        self.stats[f"{key}_ok"] += int(ok.sum())
        tally.close(n, int(lens.sum()) * M)
        return btot, etot, mocc, ok

    # -- Forward (F3): Viterbi survivors ----------------------------
    @phasestats.spanned("stage.fwd_scores")
    def fwd_scores(self, seqs, lens) -> np.ndarray:
        """Forward-gate scores (nats, f32) per item."""
        return self._scores(fwd_score, self._fwd, seqs, lens,
                            PAD_RESIDUE, "fwd")

    # -- fused Backward parser + domain decoding (F3 survivors) ------
    @phasestats.spanned("stage.domdec")
    def domdec(self, orfseqs):
        """Posteriors of the F3 survivors (ORFs)."""
        return self._decode(
            lambda dsq, lens, dev: domdec_kernel(dsq, lens, self._fwd[dev],
                                                 nj=1.0),
            orfseqs, DOMDEC_CELLS, PAD_RESIDUE, "domdec")

    # -- envelope rescoring: the standard branch's envelope fills -----
    @phasestats.spanned("stage.rescore")
    def rescore(self, envs) -> list:
        """The fills of the envelopes <envs> [(residues, length model)]
        (``ops/rescore.py`` ``Fills``, in order), bit for bit the native
        host fills: the launches of each share's ``batch_plan``, a round
        at a time, each round read back before the next."""
        tally = StageTally(self.stats, "rescore")
        M = self.om.M
        lens = np.array([len(d) for d, _ in envs], np.int64)
        out = [None] * len(envs)
        runs = []
        for dev, items in self._shares("rescore", lens):
            idx = np.arange(len(envs)) if items is None else items
            runs.append((dev, idx, iter(rescore_plan(lens[idx], M))))
        while runs:
            launched, going = [], []
            for dev, idx, plan in runs:
                b = next(plan, None)
                if b is None:
                    continue
                going.append((dev, idx, plan))
                sel = idx[b]
                launched.append((sel, tally.launch(
                    dev, int(lens[sel].sum()) * M, rescore_launch,
                    self._rescore_params(dev), [envs[i][0] for i in sel],
                    np.array([envs[i][1] for i in sel], F32))))
            runs = going
            for sel, pending in launched:
                for i, f in zip(sel, pending.fills()):
                    out[i] = f
        tally.close(len(envs), int(lens.sum()) * M)
        return out

    def _rescore_params(self, dev):
        if dev not in self._resc:
            self._resc[dev] = rescore_params(self.om, dev)
        return self._resc[dev]

    # -- fs3 Forward (F4): merged DNA windows of --fs ----------------
    @phasestats.spanned("stage.fs3_scores")
    def fs3_scores(self, seqs, lens) -> np.ndarray:
        """fs3-Forward gate scores (nats, f32) per DNA window."""
        return self._scores(fs3_score, self._fs3, seqs, lens, DNA_PAD,
                            "fs3", div=3)

    # -- fused fs3 Backward parser + frameshift decoding ---------------
    @phasestats.spanned("stage.fs3_domdec")
    def fs3_domdec(self, winseqs, dec_loop: float):
        """Posteriors of the fs-branch DNA windows.  <dec_loop>: the
        N/J/C loop probability of the host decoder's profile."""
        return self._decode(
            lambda dsq, lens, dev: fs3_domdec_kernel(
                dsq, lens, self._fs3[dev], dec_loop, nj=1.0),
            winseqs, FS3DOMDEC_CELLS, DNA_PAD, "fs3domdec", div=3)

    # -- the integer filters (BATH_MSV_DEVICE=1 / BATH_VIT_DEVICE=1) ---
    # their tables are built on first use, once a device: the default
    # path runs these filters in the native host library and never
    # reads them
    def _tables(self, kind, dev):
        if (kind, dev) not in self._int:
            make = msv_params if kind == "msv" else vit_params
            self._int[(kind, dev)] = make(self.om, dev)
        return self._int[(kind, dev)]

    @property
    def msv(self):
        return self._tables("msv", self.device)

    @property
    def vit(self):
        return self._tables("vit", self.device)

    @staticmethod
    def _stream(dev, flat, offs, lens):
        """The stream (flat int8, offs int64, lens int32) on <dev>."""
        return tuple(torch.from_numpy(np.ascontiguousarray(a, t)).to(dev)
                     for a, t in ((flat, np.int8), (offs, np.int64),
                                  (lens, np.int32)))

    @staticmethod
    def _ints(values, dev) -> torch.Tensor:
        return torch.from_numpy(np.asarray(values, np.int32)).to(dev)

    def _picks(self, key, lens):
        """[(device, item indices)] of the integer stage's non-empty
        shares (every item on one device); each share packs its own
        items' stream."""
        return [(dev, np.arange(len(lens)) if items is None else items)
                for dev, items in self._shares(key, lens)]

    @phasestats.spanned("stage.msv_scores")
    def msv_scores(self, seqs, lens, flat=None, offs=None) -> np.ndarray:
        """MSV (F1) scores (nats, f32; inf on overflow) of every item,
        bit-identical to ``ops.reference.filters.msv_filter``: either
        <seqs> or one int8 stream <flat> with per-item <offs>, read in
        place by one launch a share."""
        tally = StageTally(self.stats, "msv")
        n, M = len(lens), self.om.M
        p = self.msv
        if flat is None:
            flat, offs, lens = pack_stream(seqs)
        offs, lens = np.asarray(offs), np.asarray(lens)
        parts = []
        for dev, sel in self._picks("msv", lens):
            pd = self._tables("msv", dev)
            stream = (flat, offs, lens) if len(sel) == n else \
                repack(flat, offs[sel], lens[sel])
            tjb = self._ints(pd.tjb_for(stream[2]), dev)
            parts.append((sel, tally.launch(
                dev, int(stream[2].sum()) * M, lambda: msv_post(*msv_ssv(
                    *self._stream(dev, *stream), tjb, pd), tjb, pd))))
        ints = np.empty(n, np.float64)
        inf = np.zeros(n, bool)
        for sel, (out_int, out_inf) in parts:
            ints[sel] = out_int.cpu().numpy()
            inf[sel] = out_inf.cpu().numpy()
        sc = np.float32((ints - float(p.base)) / p.scale - 3.0)
        sc = np.where(inf, np.float32(np.inf), sc).astype(np.float32)
        tally.close(n, int(lens.sum()) * M)
        return sc

    def ssv_thresholds(self, lens, nulls, F1):
        """([B] tjb bytes, [B] sc_thresh) of the SSV_BATH capture: the
        op order of ``_ssv_captures_impl`` in f64 (ref: msvfilter.c
        :250); -2^30 (capture every row) where F1 = 1."""
        om = self.om
        invP = float(gumbel_invsurv(F1, om.evparam[C.EV_MMU],
                                    om.evparam[C.EV_MLAMBDA]))
        tjb = self.msv.tjb_for(lens)
        val = ((np.asarray(nulls, np.float64) + invP * C.CONST_LOG2
                + 3.0) * om.scale_b + om.base_b + om.tec_b + tjb)
        thr = np.where(np.isfinite(val),
                       np.ceil(val), -(1 << 30)).astype(np.int64)
        if not math.isfinite(invP):
            thr[:] = -(1 << 30)
        return tjb, thr

    @phasestats.spanned("stage.ssv_captures")
    def ssv_captures(self, seqs, lens, nulls, F1):
        """SSV_BATH capture events of the bias survivors under F2:
        {i: (nwin, [(row, k, score), ...])} for every item, as
        ``DeviceCascade.ssv_captures``.  Items with more than 16 events
        (nwin > len(events)) are rescanned by the host, by the
        reference's contract; ``ssvcap_overflow`` counts them."""
        tally = StageTally(self.stats, "ssvcap")
        M = self.om.M
        tjb, thr = self.ssv_thresholds(lens, nulls, F1)
        parts = [(sel, tally.launch(
            dev, int(np.asarray(lens)[sel].sum()) * M, ssv_capture,
            *self._stream(dev, *pack_stream([seqs[i] for i in sel])),
            self._ints(tjb[sel], dev), self._ints(thr[sel], dev),
            self._tables("msv", dev)))
            for dev, sel in self._picks("ssvcap", lens)]
        caps = {}
        for sel, res in parts:
            nwin, wi, wk, wsc = (t.cpu().numpy() for t in res)
            for i, nv in enumerate(nwin.tolist()):
                caps[int(sel[i])] = (nv, list(zip(wi[i, :nv], wk[i, :nv],
                                                  wsc[i, :nv])))
            self.stats["ssvcap_overflow"] += int((nwin > SSVB_NCAP).sum())
        tally.close(len(lens), int(np.sum(lens)) * M)
        return caps

    @phasestats.spanned("stage.vit_scores")
    def vit_scores(self, seqs, lens) -> np.ndarray:
        """ViterbiFilter (F2) scores (nats, f32; -inf with no result,
        inf on int16 overflow) of every item, bit-identical to
        ``ops.reference.filters.viterbi_filter``."""
        tally = StageTally(self.stats, "vit")
        n, M = len(lens), self.om.M
        p = self.vit
        lens = np.asarray(lens)
        parts = []
        for dev, sel in self._picks("vit", lens):
            pd = self._tables("vit", dev)
            parts.append((sel, tally.launch(
                dev, int(lens[sel].sum()) * M, vit_ints,
                *self._stream(dev, *pack_stream([seqs[i] for i in sel])),
                self._ints(pd.move_for(lens[sel]), dev), pd)))
        score = np.empty(n, np.int64)
        has, ovf = np.zeros(n, bool), np.zeros(n, bool)
        for sel, res in parts:
            score[sel], has[sel], ovf[sel] = (t.cpu().numpy() for t in res)
        sc = np.float32((score.astype(np.float64) - float(p.base))
                        / p.scale - 3.0)
        sc = np.where(has, sc, np.float32(-np.inf))
        sc = np.where(ovf, np.float32(np.inf), sc).astype(np.float32)
        if np.isnan(sc).any():
            # pipeline_gates would route the item to the host scan
            raise RuntimeError("NaN ViterbiFilter score from the device")
        tally.close(n, int(lens.sum()) * M)
        return sc

    def vit_thresholds(self, lens, filterscs, F2):
        """([B] move words, [B] sc_thresh) of the ViterbiFilter_BATH
        capture: the op order of ``vit_thresh_bath`` in f64, the C move
        word per length (ref: vitfilter.c :286); -2^30 where F2 = 1."""
        om = self.om
        invP = float(gumbel_invsurv(F2, om.evparam[C.EV_VMU],
                                    om.evparam[C.EV_VLAMBDA]))
        move = self.vit.move_for(lens)
        val = (np.asarray(filterscs, np.float64)
               + C.CONST_LOG2 * invP + 3.0) * om.scale_w \
            - float(self.vit.emove) - move.astype(np.float64) \
            + float(om.base_w)
        thr = np.where(np.isfinite(val), np.ceil(val),
                       -(1 << 30)).astype(np.int64)
        if not math.isfinite(invP):
            thr[:] = -(1 << 30)
        return move, thr

    @phasestats.spanned("stage.vit_captures")
    def vit_captures(self, seqs, lens, filterscs, F2):
        """ViterbiFilter_BATH capture events of the F2 survivors:
        {i: (rows, ks)} for every item, the ascending 1-based crossing
        rows before the first int16-saturated row and their
        striped-order k_start, as ``DeviceCascade.vit_captures``.  A
        share's row array covers its own items' residues."""
        tally = StageTally(self.stats, "vitcap")
        M = self.om.M
        move, thr = self.vit_thresholds(lens, filterscs, F2)
        parts = []
        for dev, sel in self._picks("vitcap", lens):
            flat, offs, ln = pack_stream([seqs[i] for i in sel])
            parts.append((sel, offs, ln, tally.launch(
                dev, int(np.sum(ln)) * M, vit_capture,
                *self._stream(dev, flat, offs, ln),
                self._ints(move[sel], dev), self._ints(thr[sel], dev),
                self._tables("vit", dev))))
        caps = {}
        for sel, offs, ln, res in parts:
            karr, ovfrow = (t.cpu().numpy() for t in res)
            for i, (o, L) in enumerate(zip(offs.tolist(), ln.tolist())):
                ks = karr[o:o + L]
                rows = np.nonzero(ks)[0]
                if ovfrow[i] > 0:
                    rows = rows[rows + 1 < ovfrow[i]]
                caps[int(sel[i])] = (rows + 1, ks[rows])
        tally.close(len(lens), int(np.sum(lens)) * M)
        return caps


def repack(flat, offs, lens):
    """(flat, offs, lens) of the items <offs>, <lens> of the stream
    <flat> as a stream of their own, offsets rebased to it."""
    offs = np.asarray(offs, np.int64)
    lens = np.asarray(lens, np.int64)
    new = np.zeros(len(lens), np.int64)
    np.cumsum(lens[:-1], out=new[1:])
    src = np.repeat(offs - new, lens) + np.arange(int(lens.sum()))
    return np.asarray(flat)[src], new, lens.astype(np.int32)


class ChunkEntry:
    """One (window, strand) unit of a chunk: inputs plus the staged
    pipeline state between phases."""
    __slots__ = ("window", "seqid", "complementarity", "orfs", "tid",
                 "win_start", "win_end", "cands", "P_orf", "fwdsc_arr",
                 "oxf_holder", "fs_cands", "hits", "nres_at")

    def __init__(self, window, seqid, complementarity, orfs, tid=0,
                 nres_at=0):
        self.window = window
        self.seqid = seqid
        self.complementarity = complementarity
        self.orfs = orfs
        self.tid = tid
        self.win_start = 0
        self.win_end = 0
        self.cands = None
        self.P_orf = None
        self.fwdsc_arr = None
        self.oxf_holder = None
        self.fs_cands = None
        self.hits = None
        self.nres_at = nres_at


def flush_chunk(chunk: list[ChunkEntry], cascade: TorchCascade, pli,
                om, gm, om_fs3, om_fs5, gm_fs5, data, bg, hitlist,
                gcode, hit_windows) -> None:
    """Run one chunk through the staged cascade (gates + downstream).
    Entries are processed in stream order at every phase, so
    hit/window ordering (and output bytes) match the serial
    per-window pipeline."""
    staged = flush_gates(chunk, cascade, pli, om, data, bg,
                         hit_windows)
    flush_downstream(staged, cascade, pli, om, gm, om_fs3, om_fs5,
                     gm_fs5, data, bg, hitlist, gcode, hit_windows)
    return staged


def flush_gates(chunk: list[ChunkEntry], cascade: TorchCascade, pli,
                om, data, bg, hit_windows) -> list[ChunkEntry]:
    """Phase 1 of the chunked cascade: the filter family
    (MSV/bias/Viterbi + window captures) over every entry — host
    native in the hybrid default, device otherwise.  Leaves each
    entry's cands/P_orf/fwdsc_arr/oxf_holder staged for
    flush_downstream and clears the input list."""
    from .pipeline import pipeline_gate_plan, pipeline_gates

    # Phase 1a: MSV (F1) over every ORF of the chunk, then the
    # vectorized F1 + bias plan per entry.
    #
    # Engine choice (BATH_MSV_DEVICE, default auto): auto keeps the
    # u8 max-plus MSV/SSV DP on the host native batch when it is
    # available and sends everything downstream to the device; the
    # integer family is a few percent of a drive's wall on either
    # engine (PERF.md).  BATH_MSV_DEVICE=1 forces the device MSV
    # (bit-identical either way, proven by the backend byte-parity
    # tests).
    sizes = [len(e.orfs) if e.orfs is not None else 0 for e in chunk]
    skip = [e.orfs is None or len(e.orfs) == 0 or e.window.n < 15
            for e in chunk]
    msv_dev = os.environ.get("BATH_MSV_DEVICE", "auto")
    vit_dev = os.environ.get("BATH_VIT_DEVICE", "auto")
    if "auto" in (msv_dev, vit_dev):
        from .native import get_lib
        have_native = get_lib() is not None
        if msv_dev == "auto":
            msv_dev = "0" if have_native else "1"
        # ViterbiFilter follows MSV: host native when available,
        # device otherwise; BATH_VIT_DEVICE=1 forces the device
        # scores + capture path (tests pin it)
        if vit_dev == "auto":
            vit_dev = "0" if have_native else "1"
    # one concatenated int8 residue stream for the whole chunk: the
    # MSV packer gathers rows vectorized instead of a per-ORF loop.
    # Only built when the device MSV gate is selected — the hybrid
    # default runs the native host batch and never reads it
    flats: list = []
    offs_parts: list = []
    lens_parts: list = []
    base = 0
    if msv_dev != "0":
        for e, sk in zip(chunk, skip):
            if sk:
                continue
            if getattr(e.orfs, "flat", None) is not None:
                f = np.asarray(e.orfs.flat, np.int8)
                flats.append(f)
                offs_parts.append(
                    np.asarray(e.orfs.offs, np.int64) + base)
                lens_parts.append(
                    np.asarray(e.orfs.lens, np.int64))
                base += len(f)
            else:
                for o in e.orfs:
                    f = np.asarray(o.dsq, np.int8)
                    flats.append(f)
                    offs_parts.append(np.asarray([base], np.int64))
                    lens_parts.append(np.asarray([o.n], np.int64))
                    base += len(f)
    if lens_parts:
        flat_all = (flats[0] if len(flats) == 1
                    else np.concatenate(flats))
        usc_all = cascade.msv_scores(
            None, np.concatenate(lens_parts), flat=flat_all,
            offs=np.concatenate(offs_parts))
    else:
        # hybrid cascade: usc_pre=None makes pipeline_gate_plan run
        # the per-window native OpenMP MSV batch (bit-identical)
        usc_all = None if msv_dev == "0" else np.empty(0, F32)
    pos = 0
    plans = [None] * len(chunk)
    for k, (e, sz, sk) in enumerate(zip(chunk, sizes, skip)):
        if sk:
            continue
        plans[k] = pipeline_gate_plan(
            pli, om, bg, e.window, e.orfs,
            usc_pre=None if usc_all is None
            else usc_all[pos:pos + sz])
        pos += sz

    # Phase 1b: device ViterbiFilter over every bias survivor of the
    # chunk, then the host gates (capture + compo rescue) per entry.
    # (vit_dev == "0": vitsc=None routes pipeline_gates to the native
    # OpenMP score batch + native capture — the numpy backend's own
    # path, byte-identical.)
    vit_seqs: list = []
    vit_lens: list = []
    vit_cuts = []
    for k, (e, p) in enumerate(zip(chunk, plans)):
        lo = len(vit_seqs)
        if vit_dev != "0" and p is not None \
                and p.vit_idx is not None:
            for i in p.vit_idx:
                o = e.orfs[int(i)]
                vit_seqs.append(o.dsq)
                vit_lens.append(o.n)
        vit_cuts.append((lo, len(vit_seqs)))
    vsc_all = cascade.vit_scores(vit_seqs, np.asarray(vit_lens,
                                                      np.int64)) \
        if vit_lens else np.empty(0, F32)
    if vsc_all is None:
        # no device scores: route every entry through the host
        # Viterbi path (vitsc=None), byte-identical
        vsc_all = np.empty(0, F32)
        vit_dev = "0"

    # ViterbiFilter_BATH window capture for the F2 survivors among
    # the scored lanes: batched device crossing-event scan; the host
    # replays events (skip_until + O(window) diagonal extensions)
    from . import constants as C
    from . import stats
    vcap_seqs: list = []
    vcap_lens: list = []
    vcap_flt: list = []
    vcap_keys: list = []                 # (entry k, orf idx)
    for k, (e, p) in enumerate(zip(chunk, plans)):
        if vit_dev == "0" or p is None or p.vit_idx is None \
                or not len(p.vit_idx) or p.filtersc is None:
            continue
        lo, hi = vit_cuts[k]
        vsc = vsc_all[lo:hi]
        fltv = p.filtersc[p.vit_idx]
        seqv = (vsc - fltv) / C.CONST_LOG2
        Pv = stats.gumbel_surv(seqv, om.evparam[C.EV_VMU],
                               om.evparam[C.EV_VLAMBDA])
        for r in np.nonzero(~(Pv > pli.F2))[0]:
            i = int(p.vit_idx[r])
            o = e.orfs[i]
            vcap_seqs.append(o.dsq)
            vcap_lens.append(o.n)
            vcap_flt.append(float(fltv[r]))
            vcap_keys.append((k, i))
    vcaps_all = cascade.vit_captures(
        vcap_seqs, np.asarray(vcap_lens, np.int64),
        np.asarray(vcap_flt), pli.F2) if vcap_lens else {}
    vcaps_by_entry: list[dict | None] = [None] * len(chunk)
    for g, (k, i) in enumerate(vcap_keys):
        if g in vcaps_all:
            d = vcaps_by_entry[k]
            if d is None:
                d = vcaps_by_entry[k] = {}
            d[i] = vcaps_all[g]

    # SSV_BATH window capture for bias survivors already under F2
    # (they skip Viterbi): batched device capture events; the host
    # keeps only the O(window) diagonal walks
    ssv_seqs: list = []
    ssv_lens: list = []
    ssv_nulls: list = []
    ssv_cuts = []
    for k, (e, p) in enumerate(zip(chunk, plans)):
        lo = len(ssv_seqs)
        if msv_dev != "0" and p is not None \
                and p.ssv_idx is not None:
            for i in p.ssv_idx:
                o = e.orfs[int(i)]
                ssv_seqs.append(o.dsq)
                ssv_lens.append(o.n)
                ssv_nulls.append(float(p.null[int(i)]))
        ssv_cuts.append((lo, len(ssv_seqs)))
    # (msv_dev == "0": SSV capture stays with its filter family on
    # the host — ssvcaps=None routes pipeline_gates to the native
    # scalar capture, the numpy backend's own path)
    caps_all = cascade.ssv_captures(
        ssv_seqs, np.asarray(ssv_lens, np.int64),
        np.asarray(ssv_nulls), pli.F1) \
        if ssv_lens and msv_dev != "0" else {}

    for k, (e, p, sk) in enumerate(zip(chunk, plans, skip)):
        from .tophits import TopHits
        e.hits = TopHits()
        if sk:
            e.cands, e.P_orf, e.fwdsc_arr, e.oxf_holder = [], [], [], []
            e.win_start = e.win_end = len(hit_windows)
            continue
        lo, hi = vit_cuts[k]
        vitsc = vsc_all[lo:hi] if vit_dev != "0" and p is not None \
            and p.vit_idx is not None else None
        slo, _shi = ssv_cuts[k]
        ssvcaps = None
        if p is not None and p.ssv_idx is not None and caps_all:
            ssvcaps = {int(i): caps_all[slo + r]
                       for r, i in enumerate(p.ssv_idx)
                       if (slo + r) in caps_all}
        e.win_start = len(hit_windows)
        e.cands, e.P_orf, e.fwdsc_arr, e.oxf_holder = pipeline_gates(
            pli, om, data, bg, e.window, e.orfs, hit_windows,
            e.seqid, e.complementarity, plan=p, vitsc=vitsc,
            ssvcaps=ssvcaps, vitcaps=vcaps_by_entry[k])
        e.win_end = len(hit_windows)

    # staged entries may accumulate across the whole drive (the
    # adaptive cascade defers downstream until the DP volume
    # amortizes the device); drop what downstream never reads (a
    # long drive otherwise retains every window + revcomp + ORF
    # array to the end).  The fs branch rebuilds merged DNA windows from the ORF
    # list + window sequence (fs_prepare), so only the standard
    # pipeline can shed them.
    if not pli.fs_pipe:
        for e in chunk:
            e.orfs = None
            if not e.cands:
                e.window = None

    done = list(chunk)
    chunk.clear()
    return done


def flush_downstream(staged: list[ChunkEntry], cascade: TorchCascade,
                     pli, om, gm, om_fs3, om_fs5, gm_fs5, data, bg,
                     hitlist, gcode, hit_windows,
                     use_device: bool = True) -> None:
    """Phases 2-3 of the chunked cascade over gate-staged entries:
    Forward F3/F4 gate + domain definition, then the --fs branch.
    <use_device>=False runs the bit-exact host path for every stage
    (the adaptive cascade's surrender: identical bytes by the
    DEVICE_GATE_BAND contract).  On the device the standard branch's
    envelopes are planned entry by entry, filled by one call of
    ``TorchCascade.rescore`` and finished in the entries' order."""
    from .pipeline import finish_survivors, pipeline_fwd_stage

    # Phase 2: device Forward over every Vit survivor of the chunk,
    # then the host F3/F4 stage (+ domaindef for F3 survivors).
    cand_seqs = [c.orfsq.dsq for e in staged for c in e.cands]
    cand_lens = [c.orfsq.n for e in staged for c in e.cands]
    fwd_all = cascade.fwd_scores(cand_seqs, np.asarray(cand_lens,
                                                       np.int64)) \
        if cand_lens and use_device else None
    nres_now = pli.nres
    deferred = [] if use_device else None
    pos = 0
    for e in staged:
        # the early domain keep-filter uses pli.Z = nres/max_length
        # with nres AS OF THIS WINDOW in the serial stream
        # (_postdomaindef_bath; ref p7_pipeline.c:1230-1249) — restore
        # each entry's value so deferred downstream work keeps the
        # serial path's bytes
        if e.nres_at:
            pli.nres = e.nres_at
        ncand = len(e.cands)
        pipeline_fwd_stage(pli, om, gm, gm_fs5, bg, e.hits, e.seqid,
                           e.window, hit_windows, e.complementarity,
                           e.cands, e.P_orf, e.fwdsc_arr, e.oxf_holder,
                           fwd_dev=None if fwd_all is None
                           else fwd_all[pos:pos + ncand],
                           domdec_fn=cascade.domdec if use_device
                           else None, deferred=deferred)
        pos += ncand
    if deferred:
        finish_survivors(pli, om, gm, gm_fs5, bg, deferred, cascade.rescore)

    # Phase 3 (--fs): build merged DNA windows per entry, gate them
    # through the device fs3-Forward, then arbitration + domaindef.
    if pli.fs_pipe and om_fs3 is not None:
        from .pipeline_fs import fs_gate_and_define, fs_prepare
        for e in staged:
            e.fs_cands = fs_prepare(
                pli, om, data, bg, e.orfs, e.window, gcode, e.P_orf,
                e.fwdsc_arr, hit_windows[e.win_start:],
                e.complementarity) \
                if e.orfs is not None and len(e.orfs) else []
        fs_seqs = [c.tmpseq.dsq for e in staged for c in e.fs_cands]
        fs_lens = [c.wlen for e in staged for c in e.fs_cands]
        fs3_all = cascade.fs3_scores(fs_seqs, np.asarray(fs_lens,
                                                         np.int64)) \
            if fs_lens and use_device else None
        pos = 0
        for e in staged:
            if e.nres_at:
                pli.nres = e.nres_at
            nfs = len(e.fs_cands)
            fs_gate_and_define(pli, om, gm, om_fs3, om_fs5, gm_fs5,
                               bg, e.hits, e.seqid, e.orfs, e.window,
                               gcode, e.P_orf, e.oxf_holder,
                               e.complementarity, e.fs_cands,
                               fs3_dev=None if fs3_all is None
                               else fs3_all[pos:pos + nfs],
                               fs_domdec_fn=cascade.fs3_domdec
                               if use_device else None)
            pos += nfs

    pli.nres = nres_now
    # hits flow into the global list per entry, in stream order —
    # exactly the serial path's (window, strand)-major hit ordering,
    # which the stable downstream sorts rely on for tie cases
    for e in staged:
        hitlist.unsrt.extend(e.hits.unsrt)
