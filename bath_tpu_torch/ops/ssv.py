"""The MSV filter (F1) with its SSV pre-pass, and the SSV_BATH window
capture: byte-exact integer DPs over ORFs.

Counterpart of the TPU kernel ``bath_tpu/ops/pallas/ssv.py``
(``ssv_xe_pallas``, ``_ssv_kernel``) and of the SSV/MSV half of its
production jnp twins in ``bath_tpu/ops/jaxk/filters_mb.py``
(``MSVExactMB``, ``_ssv_msv_mb_impl``, ``_ssv_msv_stream_impl``,
``ssv_msv_post_np``, ``SSVBathMB``, ``_ssv_bath_mb_impl``); the host
semantics are ``ops/reference/filters.py`` ``ssv_filter``,
``msv_filter`` and ``ssv_filter_bath`` (ref: impl_sse/ssvfilter.c
:875, msvfilter.c :76, :250).

Items travel as one int8 residue stream ``flat`` with per-item offsets
``offs`` [B] int64 and lengths ``lens`` [B] int32: item b is
``flat[offs[b]:offs[b] + lens[b]]``.  ``msv_ssv`` and ``ssv_capture``
launch the hand-written CUDA kernels ``ops/kernels/csrc/msv_filter.cu``
and ``ssv_capture.cu`` for CUDA tensors and run ``msv_ssv_ref`` and
``ssv_capture_ref``, the plain PyTorch versions, for CPU tensors.
Everything is integer arithmetic: kernel, plain version, JAX package
and host reference agree bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

SSVB_NCAP = 16              # capture slots per item (filters_mb.SSVB_NCAP)


class MSVParams:
    """The MSV/SSV byte tables and scalar bytes of one ``OProfile``.

    ``sbv [Kp, M]`` (SSV signed bytes) and ``rbv [Kp, M]`` (MSV
    unsigned costs), int32, lane k = model position k+1; ``base``,
    ``tec``, ``tbm``, ``bias`` and ``scale`` as ``om.*_b``.  The
    per-length ``tjb`` byte comes from ``tjb_for``."""

    def __init__(self, om, device="cpu"):
        M = om.M
        self._set(om.sbv[:, 1:M + 1], om.rbv[:, 1:M + 1], om.base_b,
                  om.tec_b, om.tbm_b, om.bias_b, om.scale_b, device)
        self._om = om

    def _set(self, sbv, rbv, base, tec, tbm, bias, scale, device):
        # the kernels' table holds each lane's two bytes in an int16 word
        for name, words, lo, hi in (("SSV", sbv, -128, 127),
                                    ("MSV", rbv, 0, 255)):
            if np.size(words) and (np.min(words) < lo
                                   or np.max(words) > hi):
                raise ValueError(f"an {name} byte outside [{lo}, {hi}]: "
                                 f"the MSV kernels' table holds int16 "
                                 f"words of two bytes")
        self.Kp, self.M = sbv.shape
        self.sbv = torch.from_numpy(
            np.ascontiguousarray(sbv, np.int32)).to(device)
        self.rbv = torch.from_numpy(
            np.ascontiguousarray(rbv, np.int32)).to(device)
        self.base, self.tec = int(base), int(tec)
        self.tbm, self.bias = int(tbm), int(bias)
        self.scale = float(scale)
        self._om = None
        self._tjb: dict[int, int] = {}
        self._table: dict = {}
        self._pack = None

    @classmethod
    def from_arrays(cls, sbv, rbv, base, tec, tbm, bias, scale=1.0,
                    device="cpu") -> "MSVParams":
        """From the tables themselves (``sbv``, ``rbv`` [Kp, M]) and the
        scalar bytes, without an ``OProfile``: ``tjb_for`` then raises
        (the caller brings its own J->B bytes)."""
        p = cls.__new__(cls)
        p._set(np.asarray(sbv), np.asarray(rbv), base, tec, tbm, bias, scale,
               device)
        return p

    @property
    def device(self) -> torch.device:
        return self.sbv.device

    def to(self, device) -> "MSVParams":
        """A copy of these parameters on <device> (itself when they lie
        there already), with the profile that gives ``tjb_for``."""
        if torch.device(device) == self.device:
            return self
        q = MSVParams.from_arrays(self.sbv.cpu().numpy(),
                                  self.rbv.cpu().numpy(), self.base,
                                  self.tec, self.tbm, self.bias, self.scale,
                                  device)
        q._om = self._om
        return q

    def tjb_for(self, lens) -> np.ndarray:
        """[B] int32: the length-dependent J->B byte of each item, as
        ``MSVExactMB.tjb_for`` (``om._unbiased_byteify``), cached per
        length."""
        if self._om is None:
            raise ValueError("parameters made from arrays carry no profile "
                             "to take the J->B byte from")
        lens = np.asarray(lens, np.int64)
        ulens, inv = np.unique(lens, return_inverse=True)
        vals = np.empty(len(ulens), np.int32)
        for j, L in enumerate(ulens.tolist()):
            v = self._tjb.get(L)
            if v is None:
                v = self._tjb[L] = self._om._unbiased_byteify(
                    np.log(3.0 / (L + 3.0)))
            vals[j] = v
        return vals[inv.reshape(-1)]

    def table(self, Mp: int) -> torch.Tensor:
        """[Kp, Mp] int16 words: the SSV byte in bits 0-7 (signed) and
        the MSV cost in bits 8-15 (the word's bit pattern, read as
        uint16); past the model the dead costs 127 and 255
        (``MSVExactMB``'s padding)."""
        key = (Mp, self.device)
        if key not in self._table:
            s = torch.full((self.Kp, Mp), 127, dtype=torch.int32,
                           device=self.device)
            r = torch.full_like(s, 255)
            s[:, :self.M] = self.sbv
            r[:, :self.M] = self.rbv
            w = (s & 0xFF) | (r << 8)
            self._table[key] = torch.where(w >= 1 << 15, w - (1 << 16), w) \
                .to(torch.int16).contiguous()
        return self._table[key]

    def kernel_table(self, Mp: int, P: int) -> torch.Tensor:
        """``table(Mp)`` with each row warp-transposed for P lanes a
        thread (``ops.multimodel.warp_lanes``): what the MSV and SSV
        capture kernels read."""
        key = (Mp, P, self.device)
        if key not in self._table:
            from .multimodel import warp_lanes
            lanes = torch.from_numpy(warp_lanes(Mp, P)).to(self.device)
            self._table[key] = self.table(Mp)[:, lanes].contiguous()
        return self._table[key]

    def as_pack(self):
        """This model alone as an MSV pack (``ops.multimodel.
        build_msv_pack``), what a single-model call's plan reads; built
        once."""
        if self._pack is None:
            from .multimodel import build_msv_pack
            self._pack = build_msv_pack([self])
        return self._pack


def msv_params(om, device="cpu") -> MSVParams:
    """Parameters of an ``OProfile`` for the MSV/SSV kernels."""
    return MSVParams(om, device)


def pack_stream(seqs) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(flat [N] int8, offs [B] int64, lens [B] int32): the residue
    arrays <seqs> as one stream."""
    lens = np.array([len(s) for s in seqs], np.int32)
    offs = np.zeros(len(seqs), np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    flat = np.concatenate([np.asarray(s, np.int8) for s in seqs]) \
        if len(seqs) else np.zeros(0, np.int8)
    return flat, offs, lens


# ---------------------------------------------------------------------
# Plain PyTorch versions: [n, M] integer rows, a Python loop over rows.
# Items run longest first, so row i computes only the items still
# active (a prefix).  The tests hold them against the JAX package and
# the host reference, and chip_smoke.py holds the CUDA kernels against
# them on the card.
# ---------------------------------------------------------------------
def shift_in(x: torch.Tensor, fill: int) -> torch.Tensor:
    """Lane k reads lane k-1 (the model's k-1 access); lane 0 gets
    <fill>."""
    return torch.cat([x.new_full((x.shape[0], 1), fill), x[:, :-1]], 1)


def by_length(offs: torch.Tensor, lens: torch.Tensor):
    """(order, offs, lens, active) with items sorted longest first and
    active[i] the number of items longer than i."""
    order = torch.argsort(lens.to(torch.int64), descending=True,
                          stable=True)
    sl = lens[order].to(torch.int64)
    L = int(sl[0]) if len(sl) else 0
    asc = torch.flip(sl, [0])
    active = len(sl) - torch.searchsorted(
        asc, torch.arange(L, device=sl.device), right=True)
    return order, offs[order].to(torch.int64), sl, active.tolist()


def striped_order(M: int, width: int, device) -> torch.Tensor:
    """[M] the position of lane k in the SSE reference's striped scan
    (q-major over Q stripes of <width> lanes, Q = max(2, ceil(M /
    width))): ((k % Q) * width + k // Q)."""
    Q = max(2, -(-M // width))
    k = torch.arange(M, device=device)
    return (k % Q) * width + k // Q


def striped_lane(order: torch.Tensor, M: int, width: int) -> torch.Tensor:
    """The 1-based model position of a striped-order index."""
    Q = max(2, -(-M // width))
    return (order % width) * Q + order // width + 1


def msv_ssv_ref(flat: torch.Tensor, offs: torch.Tensor, lens: torch.Tensor,
                tjb: torch.Tensor, p: MSVParams):
    """(xEu, xJm, movf) [B] int32 per item: the SSV pass's running
    unsigned byte max, and the MSV pass's J state and overflow flag
    (``_ssv_msv_mb_impl``'s scan, before its post-processing)."""
    dev = flat.device
    B, M = lens.numel(), p.M
    order, o, sl, active = by_length(offs, lens)
    tjbm = (tjb[order].to(torch.int64) + p.tbm) & 0xFF
    d = torch.full((B, M), -128, dtype=torch.int32, device=dev)
    dp = torch.zeros((B, M), dtype=torch.int32, device=dev)
    xEu = torch.zeros(B, dtype=torch.int32, device=dev)
    xJm = torch.zeros(B, dtype=torch.int64, device=dev)
    xBm = torch.clamp(p.base - tjbm, min=0)
    movf = torch.zeros(B, dtype=torch.bool, device=dev)
    for i, n in enumerate(active):
        res = flat[o[:n] + i].to(torch.int64)
        # SSV (ref: ssvfilter.c :875): int8 saturating diagonals
        d2 = torch.clamp(shift_in(d[:n], -128) - p.sbv[res], -128, 127)
        d[:n] = d2
        xEu[:n] = torch.maximum(xEu[:n], (d2 & 0xFF).amax(1))
        # MSV (ref: msvfilter.c :76): uint8 with xB/xJ specials
        sv = torch.maximum(shift_in(dp[:n], 0), xBm[:n, None])
        sv = torch.clamp(torch.clamp(sv + p.bias, max=255) - p.rbv[res],
                         min=0)
        dp[:n] = sv
        xE = sv.amax(1).to(torch.int64)
        movf[:n] |= xE + p.bias >= 255
        xJm[:n] = torch.maximum(xJm[:n], torch.clamp(xE - p.tec, min=0))
        xBm[:n] = torch.clamp(torch.clamp(xJm[:n], min=p.base) - tjbm[:n],
                              min=0)
    out = torch.empty(3, B, dtype=torch.int32, device=dev)
    out[:, order] = torch.stack([xEu, xJm.to(torch.int32),
                                 movf.to(torch.int32)])
    return out[0], out[1], out[2]


def msv_post(xEu: torch.Tensor, xJm: torch.Tensor, movf: torch.Tensor,
             tjb: torch.Tensor, p: MSVParams):
    """(out_int [B] int64, out_inf [B] bool): the SSV score with its
    uint16 wraparound and the fall back to the MSV score where SSV has
    no result (``ssv_msv_post_np``, ref: ssvfilter.c :875 tail).  The
    score in nats is ``(out_int - base) / scale - 3`` in f64, inf where
    ``out_inf``.  <p> gives ``base``, ``tbm``, ``tec`` and ``bias``: the
    ints of one model's ``MSVParams``, or [B] int64 tensors with each
    item's own model's (``IntPack.per_item``), so one call serves the
    items of many models."""
    xEu, xJm, tjb = (t.to(torch.int64) for t in (xEu, xJm, tjb))
    base, tbm, tec, bias = p.base, p.tbm, p.tec, p.bias
    no_ssv = (tjb + tbm + tec + bias) >= 127
    ovf1 = xEu >= 255 - bias
    none1 = base - tjb - tbm < 128
    xE2 = (xEu + base - tjb - tbm) & 0xFFFF
    xE2 = (xE2 - 128) & 0xFFFF
    ovf2 = xE2 >= 255 - bias
    xJ = (xE2 - tec) & 0xFFFF
    none2 = xJ > base
    ssv_none = no_ssv | (ovf1 & none1) | none2
    ssv_inf = ~ssv_none & ((ovf1 & ~none1) | ovf2)
    out_int = torch.where(ssv_none, xJm - tjb, xJ - tjb)
    out_inf = torch.where(ssv_none, movf != 0, ssv_inf)
    return out_int, out_inf


def ssv_capture_ref(flat: torch.Tensor, offs: torch.Tensor,
                    lens: torch.Tensor, tjb: torch.Tensor,
                    thresh: torch.Tensor, p: MSVParams):
    """(nwin [B], wi, wk, wsc [B, SSVB_NCAP]) int32: the capture events
    of p7_SSVFilter_BATH (``_ssv_bath_mb_impl``).  Per row, when the
    row's best cell reaches the item's threshold: the 1-based row, the
    first best position in the reference's striped order (stripes of
    16) and the score, into slot nwin; then the whole row resets to 0.
    nwin counts past the slots (the host rescans those items)."""
    dev = flat.device
    B, M = lens.numel(), p.M
    order, o, sl, active = by_length(offs, lens)
    xB = torch.clamp(p.base - (tjb[order].to(torch.int32) + p.tbm),
                     min=0)
    th = thresh[order].to(torch.int32)
    sord = striped_order(M, 16, dev)
    big = 16 * max(2, -(-M // 16))
    dp = torch.zeros((B, M), dtype=torch.int32, device=dev)
    nwin = torch.zeros(B, dtype=torch.int32, device=dev)
    caps = torch.zeros(3, B, SSVB_NCAP, dtype=torch.int32, device=dev)
    for i, n in enumerate(active):
        res = flat[o[:n] + i].to(torch.int64)
        sv = torch.maximum(shift_in(dp[:n], 0), xB[:n, None])
        sv = torch.clamp(torch.clamp(sv + p.bias, max=255) - p.rbv[res],
                         min=0)
        msc = sv.amax(1)
        crossed = msc >= th[:n]
        first = torch.where(sv == msc[:, None], sord, big).amin(1)
        rec = torch.nonzero(crossed & (nwin[:n] < SSVB_NCAP))[:, 0]
        if len(rec):
            slot = nwin[rec].to(torch.int64)
            caps[0, rec, slot] = i + 1
            caps[1, rec, slot] = striped_lane(first[rec], M, 16) \
                .to(torch.int32)
            caps[2, rec, slot] = msc[rec]
        nwin[:n] += crossed.to(torch.int32)
        dp[:n] = torch.where(crossed[:, None], 0, sv)
    out_n = torch.empty_like(nwin)
    out_n[order] = nwin
    out = torch.empty_like(caps)
    out[:, order] = caps
    return out_n, out[0], out[1], out[2]


# ---------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------
def check_stream(flat: torch.Tensor, offs: torch.Tensor, lens: torch.Tensor,
                 *per_item: torch.Tensor) -> None:
    """Shapes, types and devices the integer-filter kernels take:
    ``flat`` [N] int8, ``offs`` [B] int64, ``lens`` and each of
    <per_item> [B] int32, on one device; raises otherwise."""
    if flat.dim() != 1 or flat.dtype != torch.int8:
        raise ValueError(f"flat must be [N] int8, got {tuple(flat.shape)} "
                         f"{flat.dtype}")
    B = lens.shape[0] if lens.dim() == 1 else -1
    if lens.dim() != 1 or lens.dtype != torch.int32:
        raise ValueError(f"lens must be [B] int32, got "
                         f"{tuple(lens.shape)} {lens.dtype}")
    if offs.shape != (B,) or offs.dtype != torch.int64:
        raise ValueError(f"offs must be [B] int64, got "
                         f"{tuple(offs.shape)} {offs.dtype}")
    for t in per_item:
        if t.shape != (B,) or t.dtype != torch.int32:
            raise ValueError(f"per-item values must be [B] int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if len({t.device for t in (flat, offs, lens, *per_item)}) != 1:
        raise ValueError("flat, offs, lens and the per-item values must "
                         "share a device")


def msv_ssv(flat: torch.Tensor, offs: torch.Tensor, lens: torch.Tensor,
            tjb: torch.Tensor, p: MSVParams):
    """(xEu, xJm, movf) [B] int32.  CUDA tensors launch the CUDA kernel
    (or raise); CPU tensors run the plain version."""
    check_stream(flat, offs, lens, tjb)
    if flat.device.type == "cpu":
        return msv_ssv_ref(flat, offs, lens, tjb, p)
    from .kernels import loader
    out = loader.prepare_msv(flat, offs, lens, tjb, None, p)()
    msv_ssv.launches += 1
    return out[0], out[1], out[2]


msv_ssv.launches = 0        # CUDA launches through this wrapper


def ssv_capture(flat: torch.Tensor, offs: torch.Tensor, lens: torch.Tensor,
                tjb: torch.Tensor, thresh: torch.Tensor, p: MSVParams):
    """(nwin, wi, wk, wsc) of ``ssv_capture_ref``.  CUDA tensors launch
    the CUDA kernel (or raise); CPU tensors run the plain version."""
    check_stream(flat, offs, lens, tjb, thresh)
    if flat.device.type == "cpu":
        return ssv_capture_ref(flat, offs, lens, tjb, thresh, p)
    from .kernels import loader
    run = loader.prepare_ssv_capture(flat, offs, lens, tjb, thresh, p)
    out = run()
    ssv_capture.launches += run.launches
    return out


ssv_capture.launches = 0    # CUDA launches through this wrapper
