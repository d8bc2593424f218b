"""The device stages of the chunked bathsearch cascade, on a GPU.

``TorchCascade`` has the surface of ``bath_tpu.device_pipeline.
DeviceCascade``, so the JAX package's own host orchestration
(``flush_gates``, ``flush_downstream``, which import no JAX) drives it
unchanged.  The f32 stages run on the device:

- ``fwd_scores``: the Forward-parser gate (F3) over every Viterbi
  survivor of a flush (``ops/fwd.py``);
- ``domdec``: fused Forward + Backward + domain decoding over every F3
  survivor (``ops/domdec.py``);
- ``fs3_scores``: the fs3-Forward gate (F4) over every merged DNA
  window of a flush (``ops/fs3.py``);
- ``fs3_domdec``: fused fs3 Forward + Backward + frameshift domain
  decoding over the windows that pass the gate and arbitration
  (``ops/fs3_domdec.py``).

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
its offset in one residue stream.  A GPU needs no fixed shape buckets,
so there is no length cap either.
"""

from __future__ import annotations

import functools
import math
import time

import numpy as np
import torch

from bath_tpu import constants as C
from bath_tpu.device_pipeline import _perturb
from bath_tpu.stats import gumbel_invsurv

from .ops.domdec import domdec as domdec_kernel
from .ops.fs3 import DNA_PAD, fs3_params, fs3_score
from .ops.fs3_domdec import fs3_domdec as fs3_domdec_kernel
from .ops.fwd import PAD_RESIDUE, fwd_params, fwd_score
from .ops.ssv import (SSVB_NCAP, msv_params, msv_post, msv_ssv,
                      pack_stream, ssv_capture)
from .ops.vit import vit_capture, vit_ints, vit_params

BATCH = 4096
# decoding keeps f64 forward specials and three f32 increment rows per
# residue: at most this many padded residues to a batch (~1 GB)
DOMDEC_CELLS = 1 << 24
# fs3 decoding keeps twelve f64 specials per nucleotide, and the
# combine as many f64 rows again: at most this many padded nucleotides
# to a batch (~1 GB)
FS3DOMDEC_CELLS = 1 << 22


def not_ported(what: str, item: int) -> str:
    """The refusal of a stage or mode that a later slice ports."""
    return (f"{what} is not ported to bath_tpu_torch yet (ROADMAP.md, "
            f"'Still to port', item {item})")


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


class TorchCascade:
    """Per-query device stages for the chunked cascade.

    <om_fs3>: the fs3 profile (``FSOProfile``) of ``--fs``/``--fsonly``.
    <stats>: optional dict the cascade adds its counts to: F3
    candidates scored (``fwd_items``), F3 survivors decoded
    (``domdec_items``), those whose device posteriors were valid
    (``domdec_ok``), the same for the fs3 gate's DNA windows
    (``fs3_items``) and the fs-branch windows decoded
    (``fs3domdec_items``, ``fs3domdec_ok``), the integer filters' items
    (``msv_items``, ``vit_items``, ``ssvcap_items``, ``vitcap_items``)
    and the SSV captures with more than 16 events, which the host
    rescans (``ssvcap_overflow``), and the host wall inside each stage,
    transfers and the wait for the device included (``fwd_s``,
    ``domdec_s``, ``fs3_s``, ``fs3domdec_s``, ``msv_s``, ``vit_s``,
    ``ssvcap_s``, ``vitcap_s``)."""

    def __init__(self, om, om_fs3=None, device="cuda", stats=None):
        self.om = om
        self.device = torch.device(device)
        self.params = fwd_params(om, self.device)
        self.fs3 = None if om_fs3 is None else fs3_params(om_fs3,
                                                          self.device)
        self.stats = stats if stats is not None else {}
        for k in ("fwd_items", "domdec_items", "domdec_ok", "fwd_s",
                  "domdec_s", "fs3_items", "fs3domdec_items",
                  "fs3domdec_ok", "fs3_s", "fs3domdec_s", "msv_items",
                  "msv_s", "vit_items", "vit_s", "ssvcap_items",
                  "ssvcap_overflow", "ssvcap_s", "vitcap_items",
                  "vitcap_s"):
            self.stats.setdefault(k, 0)

    def _scores(self, score, params, seqs, lens, pad, key) -> np.ndarray:
        """Gate scores (nats, f32) per item through <score>: sorted
        batches, scattered back; counts ``<key>_items`` and
        ``<key>_s``."""
        t0 = time.perf_counter()
        n = len(lens)
        out = np.empty(n, np.float32)
        parts = [(idx, score(dsq, blens, params, nj=1.0))
                 for idx, dsq, blens in batches(seqs, lens, self.device,
                                                pad=pad)]
        for idx, sc in parts:
            out[idx] = sc.cpu().numpy()
        self.stats[f"{key}_items"] += n
        self.stats[f"{key}_s"] += time.perf_counter() - t0
        return _perturb(out)

    def _decode(self, decode, seqs, max_cells, pad, key):
        """(btot, etot, mocc, ok) per item through <decode>(dsq, lens):
        rows sliceable to n+1, and ok=False where the caller must run
        the host parsers; counts ``<key>_items``, ``<key>_ok`` and
        ``<key>_s``."""
        t0 = time.perf_counter()
        n = len(seqs)
        btot, etot, mocc = [None] * n, [None] * n, [None] * n
        ok = np.zeros(n, bool)
        lens = np.asarray([s.n for s in seqs], np.int64)
        for idx, dsq, blens in batches([s.dsq for s in seqs], lens,
                                       self.device, max_cells=max_cells,
                                       pad=pad):
            bt, et, mo, okv = (t.cpu().numpy() for t in decode(dsq, blens))
            for r, i in enumerate(idx):
                btot[i], etot[i], mocc[i] = bt[r], et[r], mo[r]
            ok[idx] = okv
        self.stats[f"{key}_items"] += n
        self.stats[f"{key}_ok"] += int(ok.sum())
        self.stats[f"{key}_s"] += time.perf_counter() - t0
        return btot, etot, mocc, ok

    # -- Forward (F3): Viterbi survivors ----------------------------
    def fwd_scores(self, seqs, lens) -> np.ndarray:
        """Forward-gate scores (nats, f32) per item."""
        return self._scores(fwd_score, self.params, seqs, lens,
                            PAD_RESIDUE, "fwd")

    # -- fused Backward parser + domain decoding (F3 survivors) ------
    def domdec(self, orfseqs):
        """Posteriors of the F3 survivors (ORFs)."""
        return self._decode(
            lambda dsq, lens: domdec_kernel(dsq, lens, self.params, nj=1.0),
            orfseqs, DOMDEC_CELLS, PAD_RESIDUE, "domdec")

    # -- fs3 Forward (F4): merged DNA windows of --fs ----------------
    def fs3_scores(self, seqs, lens) -> np.ndarray:
        """fs3-Forward gate scores (nats, f32) per DNA window."""
        return self._scores(fs3_score, self.fs3, seqs, lens, DNA_PAD, "fs3")

    # -- fused fs3 Backward parser + frameshift decoding ---------------
    def fs3_domdec(self, winseqs, dec_loop: float):
        """Posteriors of the fs-branch DNA windows.  <dec_loop>: the
        N/J/C loop probability of the host decoder's profile."""
        return self._decode(
            lambda dsq, lens: fs3_domdec_kernel(dsq, lens, self.fs3,
                                                dec_loop, nj=1.0),
            winseqs, FS3DOMDEC_CELLS, DNA_PAD, "fs3domdec")

    # -- the integer filters (BATH_MSV_DEVICE=1 / BATH_VIT_DEVICE=1) ---
    # their tables are built on first use: the default path runs these
    # filters in the native host library and never reads them
    @functools.cached_property
    def msv(self):
        return msv_params(self.om, self.device)

    @functools.cached_property
    def vit(self):
        return vit_params(self.om, self.device)

    def _stream(self, seqs, lens, flat=None, offs=None):
        """(flat int8, offs int64, lens int32) on the device: <flat>
        and <offs> as given, or <seqs> concatenated."""
        if flat is None:
            flat, offs, lens = pack_stream(seqs)
        return tuple(torch.from_numpy(np.ascontiguousarray(a, t))
                     .to(self.device) for a, t in ((flat, np.int8),
                                                   (offs, np.int64),
                                                   (lens, np.int32)))

    def _ints(self, values) -> torch.Tensor:
        return torch.from_numpy(np.asarray(values, np.int32)).to(self.device)

    def msv_scores(self, seqs, lens, flat=None, offs=None) -> np.ndarray:
        """MSV (F1) scores (nats, f32; inf on overflow) of every item,
        bit-identical to ``ops.reference.filters.msv_filter``: either
        <seqs> or one int8 stream <flat> with per-item <offs>, read in
        place by one launch."""
        t0 = time.perf_counter()
        n = len(lens)
        p = self.msv
        tjb = self._ints(p.tjb_for(lens))
        stream = self._stream(seqs, lens, flat, offs)
        out_int, out_inf = msv_post(*msv_ssv(*stream, tjb, p), tjb, p)
        ints = out_int.cpu().numpy().astype(np.float64)
        sc = np.float32((ints - float(p.base)) / p.scale - 3.0)
        sc = np.where(out_inf.cpu().numpy(), np.float32(np.inf), sc) \
            .astype(np.float32)
        self.stats["msv_items"] += n
        self.stats["msv_s"] += time.perf_counter() - t0
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

    def ssv_captures(self, seqs, lens, nulls, F1):
        """SSV_BATH capture events of the bias survivors under F2:
        {i: (nwin, [(row, k, score), ...])} for every item, as
        ``DeviceCascade.ssv_captures``.  Items with more than 16 events
        (nwin > len(events)) are rescanned by the host, by the
        reference's contract; ``ssvcap_overflow`` counts them."""
        t0 = time.perf_counter()
        tjb, thr = self.ssv_thresholds(lens, nulls, F1)
        nwin, wi, wk, wsc = (t.cpu().numpy() for t in ssv_capture(
            *self._stream(seqs, lens), self._ints(tjb), self._ints(thr),
            self.msv))
        caps = {}
        for i, nv in enumerate(nwin.tolist()):
            caps[i] = (nv, list(zip(wi[i, :nv], wk[i, :nv], wsc[i, :nv])))
        self.stats["ssvcap_items"] += len(lens)
        self.stats["ssvcap_overflow"] += int((nwin > SSVB_NCAP).sum())
        self.stats["ssvcap_s"] += time.perf_counter() - t0
        return caps

    def vit_scores(self, seqs, lens) -> np.ndarray:
        """ViterbiFilter (F2) scores (nats, f32; -inf with no result,
        inf on int16 overflow) of every item, bit-identical to
        ``ops.reference.filters.viterbi_filter``."""
        t0 = time.perf_counter()
        p = self.vit
        score, has, ovf = (t.cpu().numpy() for t in vit_ints(
            *self._stream(seqs, lens), self._ints(p.move_for(lens)), p))
        sc = np.float32((score.astype(np.float64) - float(p.base))
                        / p.scale - 3.0)
        sc = np.where(has, sc, np.float32(-np.inf))
        sc = np.where(ovf, np.float32(np.inf), sc).astype(np.float32)
        if np.isnan(sc).any():
            # pipeline_gates would route the item to the host scan
            raise RuntimeError("NaN ViterbiFilter score from the device")
        self.stats["vit_items"] += len(lens)
        self.stats["vit_s"] += time.perf_counter() - t0
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

    def vit_captures(self, seqs, lens, filterscs, F2):
        """ViterbiFilter_BATH capture events of the F2 survivors:
        {i: (rows, ks)} for every item, the ascending 1-based crossing
        rows before the first int16-saturated row and their
        striped-order k_start, as ``DeviceCascade.vit_captures``."""
        t0 = time.perf_counter()
        move, thr = self.vit_thresholds(lens, filterscs, F2)
        flat, offs, lens = pack_stream(seqs)
        karr, ovfrow = (t.cpu().numpy() for t in vit_capture(
            *self._stream(None, lens, flat, offs), self._ints(move),
            self._ints(thr), self.vit))
        caps = {}
        for i, (o, L) in enumerate(zip(offs.tolist(), lens.tolist())):
            ks = karr[o:o + L]
            rows = np.nonzero(ks)[0]
            if ovfrow[i] > 0:
                rows = rows[rows + 1 < ovfrow[i]]
            caps[i] = (rows + 1, ks[rows])
        self.stats["vitcap_items"] += len(lens)
        self.stats["vitcap_s"] += time.perf_counter() - t0
        return caps
