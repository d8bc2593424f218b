"""Device-batched E-value calibration.

The reference calibrates every model with four/six independent
N~=200-sequence simulations run serially through its SIMD filters
(ref: evalues.c p7_Calibrate :64, p7_MSVMu :298, p7_ViterbiMu :367,
p7_Tau :537, p7_fs_Tau_3codons :608).  Each simulation is a batch of
random sequences of one length, and the per-model RNG reset makes every
model draw the same ones.  So the whole model set is calibrated in one
pass: item b = (model ``b // N``, sequence ``b % N``), one launch per
stage for every padded model width.

* MSV mu / Viterbi mu: the bit-exact u8/int16 filter kernels with a
  model slot per item (``ops.multimodel.msv_ssv_multi``,
  ``vit_ints_multi``; ``csrc/msv_filter.cu``, ``csrc/vit_filter.cu``).
  The models read one copy of the simulated batch (every item names its
  offset in the stream, and offsets repeat).  The fitted mus are
  identical to the host path's.
* Forward tau / fs3 tau: the f32 gate kernels with a model slot per item
  (``fwd_pack_scores``, ``fs3_pack_scores``), each item under its own
  length model.  Scores agree with the host parsers to ~1e-4 nats, far
  inside the reference's own +/-0.1-0.2-bit simulation noise.
* fs5 tau: host native (no device fs5 kernel exists: its production
  role is per-envelope rescoring, not bulk batches), overlapped with
  the device stages via a thread pool (the ctypes call releases the
  GIL).

Counterpart of ``bath_tpu/evalues_device.py`` (``calibrate_many_device``,
``convert_fs_taus_device``; its ``_dyn_kernels`` vmap the filter and gate
kernels over a padded model axis per 128-lane class).  None of that
shape is carried over: no model-axis padding, no lane classes, no
narrowed upload types, no single concatenated fetch, no compile cache
and no stall deadline: a CUDA error propagates.

RNG discipline: the reference re-seeds each model's calibration RNG
(evalues.c:94), so every model draws the SAME simulated sequences.
They are sampled once on the host with the MT19937-exact stream
(msv batch, then vit, then fwd, then the fs3/fs5 codon DNA: the
exact draw order of the serial path) and shared across all models.
The serial path resamples a sequence whose fs parser over/underflows
(evalues.c: i--, continue); a model whose shared-batch scores hit
that condition falls back to the serial host fs_tau from a cloned
RNG snapshot, preserving the per-model draw sequence exactly.
"""

from __future__ import annotations

import math
import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from . import constants as C
from .bg import Background
from .codontable import CodonTable
from .evalues import CalibrateConfig, lambda_param
from .gencode import GeneticCode
from .oprofile import oprofile_convert
from .profile import profile_config, profile_config_fs
from .rng import Randomness
from .stats import (gumbel_fit_complete, gumbel_fit_fixlambda,
                    gumbel_invsurv)

LOG2 = math.log(2.0)


def _clone_rng(r: Randomness) -> Randomness:
    c = Randomness(r.seed_value or 42)
    c.seed_value = r.seed_value
    c._mt = r._mt.copy()
    c._mti = r._mti
    return c


@dataclass
class _SharedDraws:
    """Simulated sequences shared by every model's calibration (the
    per-model RNG reset makes all models draw identical batches)."""
    msv: np.ndarray          # [EmN, EmL] int8 aminos
    vit: np.ndarray          # [EvN, EvL] int8
    fwd: np.ndarray          # [EfN, EfL] int8
    fs_start: Randomness     # state entering the fs3 sampling
    # per genetic-code table: (dna3 [EfN, 3*EfL] int8,
    #                          fs5_start state, dna5 [EfN, 3*EfL])
    fs: dict


def _sample_batch(r: Randomness, f: np.ndarray, N: int, L: int
                  ) -> np.ndarray:
    return np.stack([r.sample_iid(f, L) for _ in range(N)]) \
        .astype(np.int8)


def _sample_dna_batch(r: Randomness, f: np.ndarray, ct: CodonTable,
                      N: int, L: int) -> np.ndarray:
    from .native import sample_dna_native
    out = np.empty((N, 3 * L), np.int8)
    for i in range(N):
        dna = sample_dna_native(r, f, ct, L)
        if dna is None:
            amino = r.sample_iid(f, L)
            dna = ct.reverse_translate(r, amino)
        out[i] = dna
    return out


def shared_draws(cfg: CalibrateConfig, bg: Background,
                 cts: dict[int, CodonTable] | None = None
                 ) -> _SharedDraws:
    r = Randomness(cfg.seed)
    msv = _sample_batch(r, bg.f, cfg.EmN, cfg.EmL)
    vit = _sample_batch(r, bg.f, cfg.EvN, cfg.EvL)
    fwd = _sample_batch(r, bg.f, cfg.EfN, cfg.EfL)
    fs_start = _clone_rng(r)
    fs = {}
    for ctid, ct in (cts or {}).items():
        rc = _clone_rng(fs_start)
        dna3 = _sample_dna_batch(rc, bg.f, ct, cfg.EfN, cfg.EfL)
        fs5_start = _clone_rng(rc)
        dna5 = _sample_dna_batch(rc, bg.f, ct, cfg.EfN, cfg.EfL)
        fs[ctid] = (dna3, fs5_start, dna5)
    return _SharedDraws(msv=msv, vit=vit, fwd=fwd, fs_start=fs_start,
                        fs=fs)


def _exp_tau(xv: np.ndarray, lam: float, tailp: float) -> float:
    """Gumbel-assisted exponential-tail anchor (ref: evalues.c
    :594-600)."""
    gmu, glam = gumbel_fit_complete(xv)
    return float(gumbel_invsurv(tailp, gmu, glam)
                 + math.log(tailp) / lam)


def _fs5_xv_host(dna5: np.ndarray, om5, nullsc: float, L: int
                 ) -> np.ndarray | None:
    """Score the shared fs5 DNA batch with the host parsers; None if
    any sequence over/underflows (-> serial resampling fallback)."""
    from .native import fs5_forward_score_native
    from .ops.reference.fwdback_fs import RangeError, forward_fs5
    om5.reconfig_length(L)
    xv = np.empty(len(dna5))
    for i, dna in enumerate(dna5):
        try:
            fsc = fs5_forward_score_native(
                np.asarray(dna, np.int32), om5)
            if fsc is None:
                _, fsc = forward_fs5(
                    np.asarray(dna, np.int32), om5, fast=True)
        except RangeError:
            return None
        if not np.isfinite(fsc):
            return None
        xv[i] = (fsc - nullsc) / LOG2
    return xv


def codon_tables(ctids):
    """({ct id: GeneticCode}, {ct id: CodonTable}) with any-codon
    initiators, as the calibration samples DNA."""
    gcodes: dict[int, GeneticCode] = {}
    cts: dict[int, CodonTable] = {}
    for ctid in ctids:
        if ctid not in cts:
            gc = GeneticCode.create(ctid)
            gc.set_initiator_any()
            gcodes[ctid] = gc
            cts[ctid] = CodonTable(gc)
    return gcodes, cts


def _resolve_device(device) -> torch.device:
    """The card unless the caller names another device; no CUDA device
    raises (nothing falls back to the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device calibration needs an NVIDIA GPU: no CUDA device is "
            "available (--device cpu runs the kernels' plain versions, "
            "--backend numpy the host calibration)")
    return dev


def _fs5_workers() -> int:
    return max(1, min(8, (os.cpu_count() or 2) - 1))


class _Clock:
    """Counts and the host wall per stage into <stats>, where the caller
    gave one (each stage ends in a copy to the host, so its wall
    includes the device's work)."""

    def __init__(self, stats: dict | None):
        self.stats = stats
        self.t = time.perf_counter()

    def add(self, key: str, value) -> None:
        if self.stats is not None:
            self.stats[key] = self.stats.get(key, 0) + value

    def mark(self, stage: str) -> None:
        now = time.perf_counter()
        self.add(f"cal_{stage}_s", now - self.t)
        self.t = now


def shared_stream(batch: np.ndarray, G: int, dev):
    """One [N, L] batch as the stream every model reads: (flat int8,
    offs [G*N] int64, lens [G*N] int32, slot [G*N]), item b = (model
    b // N, sequence b % N) at offset (b % N) * L."""
    N, L = batch.shape
    flat = torch.from_numpy(np.ascontiguousarray(batch, np.int8)
                            .reshape(-1)).to(dev)
    offs = torch.from_numpy(np.tile(np.arange(N, dtype=np.int64) * L, G)) \
        .to(dev)
    lens = torch.full((G * N,), L, dtype=torch.int32, device=dev)
    return flat, offs, lens, np.repeat(np.arange(G), N)


def per_model_words(values, N: int, dev) -> torch.Tensor:
    """[G] per-model ints as the [G*N] int32 per-item tensor."""
    return torch.from_numpy(np.repeat(np.asarray(values, np.int32), N)) \
        .to(dev)


def fs3_scores(om3s, dnas, L: int, dev) -> np.ndarray:
    """[G, N] f64 fs3-Forward scores (nats): model g's profile over its
    own [N, 3L] DNA batch ``dnas[g]``, every window under the length
    model of its own L/3 codons."""
    from .ops import multimodel as mm
    from .ops.fs3 import fs3_params
    G, N = len(om3s), len(dnas[0])
    pack = mm.build_fs3_pack([fs3_params(om, dev) for om in om3s])
    dsq = torch.from_numpy(np.ascontiguousarray(
        np.concatenate(dnas), np.int8)).to(dev)
    lens = torch.full((G * N,), 3 * L, dtype=torch.int32, device=dev)
    sc = mm.fs3_pack_scores(pack, dsq, lens, np.repeat(np.arange(G), N))
    return sc.cpu().numpy().astype(np.float64).reshape(G, N)


def calibrate_many_device(hmms, cfg: CalibrateConfig | None = None,
                          progress=None, device=None,
                          stats: dict | None = None) -> None:
    """Calibrate <hmms> in place with device-batched simulations (see
    module docstring for the batching structure).  <device>: the card
    unless given ("cpu" runs the kernels' plain versions); <stats>
    receives the host wall of each stage (``cal_*_s``) and the item
    counts."""
    from .ops import multimodel as mm
    from .ops.fwd import fwd_params
    from .ops.ssv import msv_params, msv_post
    from .ops.vit import vit_params

    hmms = list(hmms)
    if not hmms:
        return
    dev = _resolve_device(device)
    clock = _Clock(stats)
    cfg = cfg or CalibrateConfig()
    bg = Background()
    gcodes, cts = codon_tables(
        [h.ct if h.ct else 1 for h in hmms] if cfg.fs else [])
    draws = shared_draws(cfg, bg, cts)
    clock.mark("draws")

    # null scores with the host stage ordering: null_one reads the p1
    # set by the latest set_length (evalues.c sets bg length per sim)
    nbg = Background()
    nbg.set_length(cfg.EmL)
    null_m = nbg.null_one(cfg.EmL)
    nbg.set_length(cfg.EvL)
    null_v = nbg.null_one(cfg.EvL)
    nbg.set_length(cfg.EfL)
    null_f = nbg.null_one(cfg.EfL)
    null_fs = nbg.fs_null_one(cfg.EfL) if cfg.fs else 0.0

    # ---- per-model host config ------------------------------------
    from .ops.reference.fwdback_fs import fs_oprofile_convert
    G = len(hmms)
    oms, lams, om3s, om5s, ctids = [], [], [], [], []
    for hmm in hmms:
        oms.append(oprofile_convert(profile_config(hmm, bg, L=cfg.EvL)))
        lams.append(lambda_param(hmm, bg))
        if cfg.fs:
            ctid = hmm.ct if hmm.ct else 1
            ctids.append(ctid)
            om3s.append(fs_oprofile_convert(
                profile_config_fs(hmm, bg, gcodes[ctid], 3, cfg.EvL)))
            om5s.append(fs_oprofile_convert(
                profile_config_fs(hmm, bg, gcodes[ctid], 5, cfg.EvL)))
    clock.mark("config")

    fs5pool = ThreadPoolExecutor(max_workers=_fs5_workers())
    try:
        # fs5 host-native scoring starts now, on its own pool, so it
        # overlaps the device stages: nothing before the submits waits
        # on the device.  (Submitted earlier, beside the configuration
        # loop, the threads slowed that loop by more than they saved.)
        fs5_futures = [
            fs5pool.submit(_fs5_xv_host, draws.fs[ctid][2], om5, null_fs,
                           cfg.EfL)
            for ctid, om5 in zip(ctids, om5s)]

        # ---- MSV: item (g, n) under model g, one shared batch -----
        mp = [msv_params(om, dev) for om in oms]
        flat, offs, lens, slot = shared_stream(draws.msv, G, dev)
        tjb = per_model_words([p.tjb_for([cfg.EmL])[0] for p in mp],
                               cfg.EmN, dev)
        pack = mm.build_msv_pack(mp)
        m_int, m_inf = msv_post(
            *mm.msv_ssv_multi(pack, flat, offs, lens, tjb, slot), tjb,
            pack.per_item(slot))
        m_int = m_int.cpu().numpy().reshape(G, cfg.EmN)
        m_inf = m_inf.cpu().numpy().reshape(G, cfg.EmN)
        clock.mark("msv")

        # ---- ViterbiFilter ----------------------------------------
        vp = [vit_params(om, dev) for om in oms]
        flat, offs, lens, slot = shared_stream(draws.vit, G, dev)
        move = per_model_words([p.move_for([cfg.EvL])[0] for p in vp],
                                cfg.EvN, dev)
        v_int, v_has, v_ovf = (
            t.cpu().numpy().reshape(G, cfg.EvN)
            for t in mm.vit_ints_multi(mm.build_vit_pack(vp), flat, offs,
                                       lens, move, slot))
        clock.mark("vit")

        # ---- Forward gate: each item under the length model of EfL -
        fpack = mm.build_fwd_pack([fwd_params(om, dev) for om in oms])
        dsq = torch.from_numpy(np.ascontiguousarray(draws.fwd, np.int8)) \
            .to(dev).repeat(G, 1)
        f_lens = torch.full((G * cfg.EfN,), cfg.EfL, dtype=torch.int32,
                            device=dev)
        fwd_sc = mm.fwd_pack_scores(
            fpack, dsq, f_lens, np.repeat(np.arange(G), cfg.EfN)) \
            .cpu().numpy().astype(np.float64).reshape(G, cfg.EfN)
        clock.mark("fwd")

        # ---- fs3 gate ---------------------------------------------
        if cfg.fs:
            fs3_sc = fs3_scores(om3s, [draws.fs[c][0] for c in ctids],
                                 cfg.EfL, dev)
            clock.mark("fs3")
        clock.add("cal_models", G)
        clock.add("cal_items", G * (cfg.EmN + cfg.EvN
                                    + cfg.EfN * (2 if cfg.fs else 1)))

        # ---- fits ---------------------------------------------------
        # Scores leave the integer kernels as the host filters return
        # them (f32-rounded nats, maxsc where a filter has no finite
        # score) and are fitted in f64, the host's arithmetic, so the
        # mus are the host's bit for bit.
        from .hmm import H_STATS
        for g, hmm in enumerate(hmms):
            om, lam = oms[g], lams[g]
            sc = np.float32((m_int[g].astype(np.float64)
                             - float(om.base_b)) / float(om.scale_b) - 3.0)
            maxsc = (255 - om.base_b) / om.scale_b
            sc = np.where(m_inf[g], maxsc, sc.astype(np.float64))
            mmu = gumbel_fit_fixlambda((sc - null_m) / LOG2, lam)

            sc = np.float32((v_int[g].astype(np.float64)
                             - float(om.base_w)) / float(om.scale_w) - 3.0)
            maxsc = (32767.0 - om.base_w) / om.scale_w
            sc = np.where(~v_has[g] | v_ovf[g], maxsc,
                          sc.astype(np.float64))
            vmu = gumbel_fit_fixlambda((sc - null_v) / LOG2, lam)

            tau = _exp_tau((fwd_sc[g] - null_f) / LOG2, lam, cfg.Eft)

            hmm.evparam[C.EV_MLAMBDA] = lam
            hmm.evparam[C.EV_VLAMBDA] = lam
            hmm.evparam[C.EV_FLAMBDA] = lam
            hmm.evparam[C.EV_MMU] = mmu
            hmm.evparam[C.EV_VMU] = vmu
            hmm.evparam[C.EV_FTAU] = tau

            if cfg.fs:
                f3 = fs3_sc[g]
                t_wait = time.perf_counter()
                xv5 = fs5_futures[g].result()
                clock.add("cal_fs5_wait_s", time.perf_counter() - t_wait)
                if np.all(np.isfinite(f3)) and xv5 is not None:
                    hmm.evparam[C.EV_FTAUFS3] = _exp_tau(
                        (f3 - null_fs) / LOG2, lam, cfg.Eft)
                    hmm.evparam[C.EV_FTAUFS5] = _exp_tau(
                        xv5, lam, cfg.Eft)
                else:
                    _fs_taus_serial(hmm, cfg, bg, draws, lam,
                                    gcodes[ctids[g]], cts[ctids[g]])
                    clock.add("cal_fs_serial", 1)
            hmm.flags |= H_STATS
            if progress is not None:
                progress(hmm)
        clock.mark("fits")
    finally:
        fs5pool.shutdown(wait=True, cancel_futures=True)


def convert_fs_taus_device(items, r: Randomness, bg: Background,
                           EvL: int = 100, L: int = 100, N: int = 200,
                           tailp: float = 0.04, device=None,
                           stats: dict | None = None) -> None:
    """Device-batched frameshift taus for bathconvert.

    bathconvert shares ONE RNG stream across the converted models (no
    per-model reseed; ref: bathconvert.c main), so unlike
    calibrate_many_device the simulated DNA differs per model: it is
    pre-drawn sequentially in the exact serial order (model 1 fs3
    batch, model 1 fs5 batch, model 2 fs3, ...), then scored with the
    fs3 gate under a model slot per window (every window names its own
    row, so per-model DNA costs nothing extra) + one pooled host fs5
    pass.  A model whose batch scores over/underflow falls back to the
    serial fs_tau from a cloned snapshot of its stream position (the
    rare resampling case then consumes extra draws only inside the
    clone; later models keep the pre-drawn stream, which stays
    deterministic run-to-run).

    items: list of (hmm, ct_id) needing fs calibration; taus are
    written into hmm.evparam in place.  <device>, <stats>: as
    ``calibrate_many_device``.
    """
    from .ops.reference.fwdback_fs import fs_oprofile_convert

    items = list(items)
    if not items:
        return
    dev = _resolve_device(device)
    clock = _Clock(stats)
    gcodes, cts = codon_tables([ctid for _h, ctid in items])

    nbg = Background()
    nbg.set_length(L)
    null_fs = nbg.fs_null_one(L)

    pool = ThreadPoolExecutor(max_workers=_fs5_workers())
    try:
        # sample first (the shared-stream order), the fs5 batches going
        # to the host pool as they are drawn
        work = []
        for hmm, ctid in items:
            ct = cts[ctid]
            snap = _clone_rng(r)
            dna3 = _sample_dna_batch(r, bg.f, ct, N, L)
            dna5 = _sample_dna_batch(r, bg.f, ct, N, L)
            lam = float(hmm.evparam[C.EV_FLAMBDA])
            gm3 = profile_config_fs(hmm, bg, gcodes[ctid], 3, EvL)
            om3 = fs_oprofile_convert(gm3)
            gm5 = profile_config_fs(hmm, bg, gcodes[ctid], 5, EvL)
            om5 = fs_oprofile_convert(gm5)
            fut5 = pool.submit(_fs5_xv_host, dna5, om5, null_fs, L)
            work.append((hmm, ctid, snap, lam, dna3, om3, fut5))
        clock.mark("draws")
        f3s = fs3_scores([w[5] for w in work], [w[4] for w in work], L, dev)
        clock.mark("fs3")
        clock.add("cal_models", len(work))
        clock.add("cal_items", len(work) * N)
        for f3, (hmm, ctid, snap, lam, _dna3, _om3, fut5) in zip(f3s, work):
            _finish_convert_model(
                hmm, ctid, snap, lam, f3, fut5, null_fs,
                tailp, bg, gcodes, cts, EvL, L, N)
        clock.mark("fits")
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def _finish_convert_model(hmm, ctid, snap, lam, f3, fut5, null_fs,
                          tailp, bg, gcodes, cts, EvL, L, N):
    from .evalues import fs_tau
    from .ops.reference.fwdback_fs import fs_oprofile_convert
    xv5 = fut5.result()
    if np.all(np.isfinite(f3)) and xv5 is not None:
        hmm.evparam[C.EV_FTAUFS3] = _exp_tau(
            (f3 - null_fs) / LOG2, lam, tailp)
        hmm.evparam[C.EV_FTAUFS5] = _exp_tau(xv5, lam, tailp)
    else:
        rc = snap
        gm3 = profile_config_fs(hmm, bg, gcodes[ctid], 3, EvL)
        om3 = fs_oprofile_convert(gm3)
        hmm.evparam[C.EV_FTAUFS3] = fs_tau(
            rc, om3, cts[ctid], bg, L, N, lam, tailp)
        gm5 = profile_config_fs(hmm, bg, gcodes[ctid], 5, EvL)
        om5 = fs_oprofile_convert(gm5)
        hmm.evparam[C.EV_FTAUFS5] = fs_tau(
            rc, om5, cts[ctid], bg, L, N, lam, tailp)


def _fs_taus_serial(hmm, cfg, bg, draws: _SharedDraws, lam, gcode,
                    ct) -> None:
    """Serial-host fallback for a model whose shared-batch fs scores
    over/underflowed: replays the reference's sample->score->resample
    loop from the exact RNG snapshot (evalues.c: i--, continue)."""
    from .evalues import fs_tau
    from .ops.reference.fwdback_fs import fs_oprofile_convert
    r = _clone_rng(draws.fs_start)
    gm3 = profile_config_fs(hmm, bg, gcode, 3, cfg.EvL)
    om3 = fs_oprofile_convert(gm3)
    hmm.evparam[C.EV_FTAUFS3] = fs_tau(
        r, om3, ct, bg, cfg.EfL, cfg.EfN, lam, cfg.Eft)
    gm5 = profile_config_fs(hmm, bg, gcode, 5, cfg.EvL)
    om5 = fs_oprofile_convert(gm5)
    hmm.evparam[C.EV_FTAUFS5] = fs_tau(
        r, om5, ct, bg, cfg.EfL, cfg.EfN, lam, cfg.Eft)
