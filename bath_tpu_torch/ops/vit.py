"""The ViterbiFilter (F2) and the ViterbiFilter_BATH window capture:
int16-saturated max-plus DPs over ORFs.

Counterpart of the TPU kernel ``bath_tpu/ops/pallas/vit.py``
(``vit_ints_pallas``, ``_vit_kernel``, ``vit_params_pallas``) and of its
production jnp twins in ``bath_tpu/ops/jaxk/filters_mb.py``
(``VitExactMB``, ``_vit_mb_impl``, ``VitBathMB``, ``_vit_bath_mb_impl``);
the host semantics are ``ops/reference/filters.py`` ``viterbi_filter``
(ref: impl_sse/vitfilter.c :39, :286).  Items travel as in
``ops/ssv.py``: one int8 stream with per-item offsets and lengths.
``vit_ints`` and ``vit_capture`` launch the hand-written CUDA kernel
``ops/kernels/csrc/vit_filter.cu`` for CUDA tensors and run
``vit_ints_ref`` and ``vit_capture_ref``, the plain PyTorch versions,
for CPU tensors.

The D->D chain ``D[k] = max(part[k], sat(D[k-1] + tDD[k]))`` is closed
exactly on every row.  The plain version takes it as a log-depth
(max, +) scan of maps (A, B): y -> max(B, sat(y + A)).  Because every
tDD is <= 0, saturation only clamps from below and two maps compose to
(A1 + A2, max(B2, sat(B1 + A2))) exactly, as long as A is summed
unsaturated (it is clamped at ``A_FLOOR``, far below where the clamp
could matter).  The JAX kernels saturate A itself to int16, which can
overestimate D values that lie tens of thousands below the row's B->M
entry; on every case the tests hold them to, both give the same
results.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as C

from .ssv import by_length, check_stream, shift_in, striped_lane, \
    striped_order

NEG = -32768
A_FLOOR = -(1 << 20)        # any clamp <= -65536 keeps the scan exact
# transition rows of VitParams.tr (the order of vit_params_pallas)
R_BM, R_MM, R_IM, R_DM, R_MDS, R_DDS, R_MI, R_II = range(8)


class VitParams:
    """The ViterbiFilter words of one ``OProfile``.

    ``rwv [Kp, M]`` int32 match emission words, lane k = model position
    k+1; ``tr [8, M]`` int32 transition rows in ``R_*`` order, packed as
    ``VitExactMB.__init__`` packs them: lane k holds the transitions
    into position k+1 (BM, MM, IM, DM), tMD and tDD shifted so lane k
    holds the move into D at k+1 (-32768 at lane 0), and MI/II out of
    position k+1.  ``base``, ``scale``, ``emove``, ``eloop`` as
    ``VitExactMB``; the per-length N/J/C move word comes from
    ``move_for``."""

    def __init__(self, om, device="cpu"):
        M = om.M
        twv = om.twv.astype(np.int32)
        tr = np.full((8, M), NEG, np.int32)
        tr[R_BM] = twv[:M, C.P_BM]
        tr[R_MM] = twv[:M, C.P_MM]
        tr[R_IM] = twv[:M, C.P_IM]
        tr[R_DM] = twv[:M, C.P_DM]
        tr[R_MDS, 1:] = twv[1:M, C.P_MD]
        tr[R_DDS, 1:] = twv[1:M, C.P_DD]
        tr[R_MI] = twv[1:M + 1, C.P_MI]
        tr[R_II] = twv[1:M + 1, C.P_II]
        self._set(om.rwv[:, 1:M + 1], tr, om.base_w, om.scale_w,
                  om.xw[C.X_E, C.MOVE], om.xw[C.X_E, C.LOOP], device)

    def _set(self, rwv, tr, base, scale, emove, eloop, device):
        # the (max, +) closure composes exactly only for tDD <= 0
        if (tr[R_DDS] > 0).any():
            raise ValueError("a positive D->D transition word: the "
                             "Viterbi kernels' D->D scan needs tDD <= 0")
        # the kernel's table holds int16 words
        for name, words in (("match", rwv), ("transition", tr)):
            if np.size(words) and (np.min(words) < NEG
                                   or np.max(words) > 32767):
                raise ValueError(f"a {name} word out of int16 range: the "
                                 f"ViterbiFilter's table holds int16 words")
        self.Kp, self.M = rwv.shape
        self.rwv = torch.from_numpy(
            np.ascontiguousarray(rwv, np.int32)).to(device)
        self.tr = torch.from_numpy(
            np.ascontiguousarray(tr, np.int32)).to(device)
        self.base = int(base)
        self.scale = float(scale)
        self.emove = int(emove)
        self.eloop = int(eloop)
        self._move: dict[int, int] = {}
        self._table: dict = {}
        self._pack = None

    @classmethod
    def from_arrays(cls, rwv, tr, base, emove, eloop, scale=1.0,
                    device="cpu") -> "VitParams":
        """From the words themselves (``rwv`` [Kp, M], ``tr`` [8, M] in
        ``R_*`` order and lane convention) and the scalar words, without
        an ``OProfile``; <scale> is what ``move_for`` words with."""
        p = cls.__new__(cls)
        p._set(np.asarray(rwv), np.asarray(tr), base, scale, emove, eloop,
               device)
        return p

    @property
    def device(self) -> torch.device:
        return self.rwv.device

    def move_for(self, lens) -> np.ndarray:
        """[B] int32: the N/J/C move word of each item's length model,
        as ``VitExactMB.move_for`` (``oprofile._wordify``), cached per
        length."""
        from ..oprofile import _wordify
        lens = np.asarray(lens, np.int64)
        ulens, inv = np.unique(lens, return_inverse=True)
        vals = np.empty(len(ulens), np.int32)
        for j, L in enumerate(ulens.tolist()):
            v = self._move.get(L)
            if v is None:
                pmove = (np.float32(2.0) + np.float32(1.0)) / (
                    np.float32(L) + np.float32(2.0) + np.float32(1.0))
                v = self._move[L] = _wordify(self.scale, np.log(pmove))
            vals[j] = v
        return vals[inv.reshape(-1)]

    def table(self, Mp: int) -> torch.Tensor:
        """[Kp + 8, Mp] int16 kernel table: the match words, then the
        transition rows; -32768 past the model."""
        key = (Mp, self.device)
        if key not in self._table:
            t = torch.full((self.Kp + 8, Mp), NEG, dtype=torch.int16,
                           device=self.device)
            t[:self.Kp, :self.M] = self.rwv.to(torch.int16)
            t[self.Kp:, :self.M] = self.tr.to(torch.int16)
            self._table[key] = t
        return self._table[key]

    def kernel_table(self, Mp: int, P: int) -> torch.Tensor:
        """What a ViterbiFilter pack stacks: ``table(Mp)`` (the kernel
        warp-transposes it as it stages it, for any P)."""
        return self.table(Mp)

    def as_pack(self):
        """This model alone as a ViterbiFilter pack (``ops.multimodel.
        build_vit_pack``), what the kernel's plan reads; built once."""
        if self._pack is None:
            from .multimodel import build_vit_pack
            self._pack = build_vit_pack([self])
        return self._pack


def vit_params(om, device="cpu") -> VitParams:
    """Parameters of an ``OProfile`` for the Viterbi kernels."""
    return VitParams(om, device)


# ---------------------------------------------------------------------
# Plain PyTorch versions (the row loop of ops/ssv.py)
# ---------------------------------------------------------------------
def sat(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, NEG, 32767)


def scan_levels(add: torch.Tensor) -> list[tuple[int, torch.Tensor]]:
    """The row-independent half of ``maxplus_scan``: for each doubling
    step s, the summed adds of the maps that end at lanes k >= s."""
    out = []
    s = 1
    while s < add.shape[0]:
        out.append((s, add[s:]))
        add = torch.cat([add[:s], torch.clamp(add[:-s] + add[s:],
                                              min=A_FLOOR)])
        s *= 2
    return out


def maxplus_scan(part: torch.Tensor, add: torch.Tensor,
                 levels=None) -> torch.Tensor:
    """D[k] = max(part[k], sat(D[k-1] + add[k])) along the last axis
    (D[-1] = -32768), as a log-depth Hillis-Steele scan of (max, +)
    maps; <add> [M] must be <= 0.  <levels>: ``scan_levels(add)``."""
    b = part.clone()
    for s, a in levels if levels is not None else scan_levels(add):
        b[:, s:] = torch.maximum(b[:, s:], sat(b[:, :-s] + a))
    return b


def _vit_rows(flat, offs, lens, move, p: VitParams, thresh=None):
    """The Viterbi filter's rows over every item; with <thresh>, also
    the capture events.  Returns (score, has, ovf) and, with
    <thresh>, (karr [N] int16 on the layout of <flat>, ovfrow [B])."""
    dev = flat.device
    B, M = lens.numel(), p.M
    order, o, sl, active = by_length(offs, lens)
    mv = move[order].to(torch.int32)
    tBM, tMM, tIM, tDM, tMDs, tDDs, tMI, tII = p.tr
    levels = scan_levels(tDDs)
    dm, di, dd = (torch.full((B, M), NEG, dtype=torch.int32, device=dev)
                  for _ in range(3))
    xJ = torch.full((B,), NEG, dtype=torch.int32, device=dev)
    xC = xJ.clone()
    xB = p.base + mv
    ovf = torch.zeros(B, dtype=torch.bool, device=dev)
    score = torch.zeros(B, dtype=torch.int32, device=dev)
    has = torch.zeros(B, dtype=torch.bool, device=dev)
    if thresh is not None:
        th = thresh[order].to(torch.int32)
        word = striped_order(M, 8, dev)
        big = 8 * max(2, -(-M // 8))
        karr = torch.zeros(flat.numel(), dtype=torch.int16, device=dev)
        ovfrow = torch.zeros(B, dtype=torch.int32, device=dev)
    for i, n in enumerate(active):
        res = flat[o[:n] + i].to(torch.int64)
        sv = sat(xB[:n, None] + tBM)
        sv = torch.maximum(sv, sat(shift_in(dm[:n], NEG) + tMM))
        sv = torch.maximum(sv, sat(shift_in(di[:n], NEG) + tIM))
        sv = torch.maximum(sv, sat(shift_in(dd[:n], NEG) + tDM))
        sv = sat(sv + p.rwv[res])
        xE = sv.amax(1)
        ovf2 = xE >= 32767
        di[:n] = torch.maximum(sat(dm[:n] + tMI), sat(di[:n] + tII))
        dd[:n] = maxplus_scan(sat(shift_in(sv, NEG) + tMDs), tDDs, levels)
        dm[:n] = sv
        xC[:n] = torch.maximum(xC[:n], xE + p.emove)
        xJ[:n] = torch.maximum(xJ[:n], xE + p.eloop)
        xB[:n] = sat(xJ[:n].clamp(min=p.base) + mv[:n])
        ovf[:n] |= ovf2
        done = sl[:n] == i + 1
        score[:n] = torch.where(done, xC[:n] + mv[:n], score[:n])
        has[:n] = torch.where(done, xC[:n] > NEG, has[:n])
        if thresh is not None:
            first = torch.where(sv == xE[:, None], word, big).amin(1)
            crossed = (xE >= th[:n]) & ~ovf2
            karr[o[:n] + i] = torch.where(
                crossed, striped_lane(first, M, 8), 0).to(torch.int16)
            ovfrow[:n] = torch.where(ovf2 & (ovfrow[:n] == 0), i + 1,
                                     ovfrow[:n])
    out = torch.empty(3, B, dtype=torch.int32, device=dev)
    out[:, order] = torch.stack([score, has.to(torch.int32),
                                 ovf.to(torch.int32)])
    ints = (out[0], out[1] != 0, out[2] != 0)
    if thresh is None:
        return ints
    orow = torch.empty_like(ovfrow)
    orow[order] = ovfrow
    return karr, orow


def vit_ints_ref(flat: torch.Tensor, offs: torch.Tensor, lens: torch.Tensor,
                 move: torch.Tensor, p: VitParams):
    """(score_int [B] int32, has [B] bool, ovf [B] bool): the final C
    state plus the move word at each item's last row, whether C was
    reached, and whether any row's xE saturated int16
    (``_vit_mb_impl``).  The score in nats is ``(score_int - base) /
    scale - 3`` in f64, -inf without ``has`` and inf on ``ovf``."""
    return _vit_rows(flat, offs, lens, move, p)


def vit_capture_ref(flat: torch.Tensor, offs: torch.Tensor,
                    lens: torch.Tensor, move: torch.Tensor,
                    thresh: torch.Tensor, p: VitParams):
    """(karr [N] int16, ovfrow [B] int32): the capture events of
    p7_ViterbiFilter_BATH (``_vit_bath_mb_impl``), in the layout of
    <flat>: at item b's row i (``karr[offs[b] + i]``) the first model
    position, in the SSE reference's striped order (stripes of 8), whose
    M cell equals the row's xE, where xE reaches the item's threshold
    and does not saturate, else 0; ``ovfrow`` the first 1-based row
    whose xE saturates int16 (0 if none).  Events at rows >= ovfrow
    are not the reference's."""
    return _vit_rows(flat, offs, lens, move, p, thresh)


# ---------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------
def vit_ints(flat: torch.Tensor, offs: torch.Tensor, lens: torch.Tensor,
             move: torch.Tensor, p: VitParams):
    """(score_int, has, ovf) of ``vit_ints_ref``.  CUDA tensors launch
    the CUDA kernel (or raise); CPU tensors run the plain version."""
    check_stream(flat, offs, lens, move)
    if flat.device.type == "cpu":
        return vit_ints_ref(flat, offs, lens, move, p)
    from .kernels import loader
    out = loader.prepare_vit(flat, offs, lens, move, None, p)()
    vit_ints.launches += 1
    return out[0], out[1] != 0, out[2] != 0


vit_ints.launches = 0       # CUDA launches through this wrapper


def vit_capture(flat: torch.Tensor, offs: torch.Tensor, lens: torch.Tensor,
                move: torch.Tensor, thresh: torch.Tensor, p: VitParams):
    """(karr, ovfrow) of ``vit_capture_ref``.  CUDA tensors launch the
    CUDA kernel (or raise); CPU tensors run the plain version."""
    check_stream(flat, offs, lens, move, thresh)
    if flat.device.type == "cpu":
        return vit_capture_ref(flat, offs, lens, move, thresh, p)
    from .kernels import loader
    out = loader.prepare_vit(flat, offs, lens, move, None, p, thresh)()
    vit_capture.launches += 1
    return out


vit_capture.launches = 0    # CUDA launches through this wrapper
