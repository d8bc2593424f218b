"""The device stages of the chunked bathsearch cascade, on a GPU.

``TorchCascade`` has the surface of ``bath_tpu.device_pipeline.
DeviceCascade``, so the JAX package's own host orchestration
(``flush_gates``, ``flush_downstream``, which import no JAX) drives it
unchanged.  This slice runs the two f32 stages of the standard
pipeline and the two of ``--fs``/``--fsonly`` on the device:

- ``fwd_scores``: the Forward-parser gate (F3) over every Viterbi
  survivor of a flush (``ops/fwd.py``);
- ``domdec``: fused Forward + Backward + domain decoding over every F3
  survivor (``ops/domdec.py``);
- ``fs3_scores``: the fs3-Forward gate (F4) over every merged DNA
  window of a flush (``ops/fs3.py``);
- ``fs3_domdec``: fused fs3 Forward + Backward + frameshift domain
  decoding over the windows that pass the gate and arbitration
  (``ops/fs3_domdec.py``).

The integer filters (MSV/SSV F1, bias, Viterbi F2) stay in the native
host library, as in the JAX package's production default; the other
stages raise ``NotImplementedError`` naming the ROADMAP.md item that
ports them.  There is no watchdog and no host fallback: a CUDA error
propagates to the caller.

Batching: items are sorted by length and cut into batches of at most
``BATCH`` items, each padded to its own longest item; the decoding
stages also cap a batch's padded residues.  A GPU needs no fixed shape
buckets, so there is no length cap either.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bath_tpu.device_pipeline import _perturb

from .ops.domdec import domdec as domdec_kernel
from .ops.fs3 import DNA_PAD, fs3_params, fs3_score
from .ops.fs3_domdec import fs3_domdec as fs3_domdec_kernel
from .ops.fwd import PAD_RESIDUE, fwd_params, fwd_score

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
    (``fs3domdec_items``, ``fs3domdec_ok``), and the host wall inside
    each stage, transfers and the wait for the device included
    (``fwd_s``, ``domdec_s``, ``fs3_s``, ``fs3domdec_s``)."""

    def __init__(self, om, om_fs3=None, device="cuda", stats=None):
        self.om = om
        self.device = torch.device(device)
        self.params = fwd_params(om, self.device)
        self.fs3 = None if om_fs3 is None else fs3_params(om_fs3,
                                                          self.device)
        self.stats = stats if stats is not None else {}
        for k in ("fwd_items", "domdec_items", "domdec_ok", "fwd_s",
                  "domdec_s", "fs3_items", "fs3domdec_items",
                  "fs3domdec_ok", "fs3_s", "fs3domdec_s"):
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

    # -- stages of later slices ---------------------------------------
    def msv_scores(self, seqs, lens, flat=None, offs=None):
        raise NotImplementedError(
            not_ported("the device MSV/SSV filter (F1)", 2))

    def ssv_captures(self, seqs, lens, nulls, F1):
        raise NotImplementedError(
            not_ported("the device SSV window capture", 2))

    def vit_scores(self, seqs, lens):
        raise NotImplementedError(
            not_ported("the device ViterbiFilter (F2)", 2))

    def vit_captures(self, seqs, lens, filterscs, F2):
        raise NotImplementedError(
            not_ported("the device Viterbi window capture", 2))
