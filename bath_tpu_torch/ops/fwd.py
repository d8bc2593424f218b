"""The Forward-parser gate (F3): score-only amino Forward with a
per-item length model.

Counterpart of ``bath_tpu/ops/pallas/fwd.py`` (``fwd_score_pallas``,
``_fwd_kernel``, ``fwd_params_pallas``) and of its production jnp twin
``bath_tpu/ops/jaxk/kernels.py`` (``fwd_mb_params``, ``_fwd_mb_impl``,
``fwd_mb_score_batch``).  ``fwd_score`` launches the hand-written CUDA
kernel ``ops/kernels/csrc/fwd_parser.cu`` for CUDA tensors and runs
``fwd_score_ref``, the plain PyTorch version, for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import constants as C

PAD_RESIDUE = 28            # amino missing-data residue: zero odds


class ProfileTensors(nn.Module):
    """Prob-space Forward/Backward parameters of one OProfile.

    ``rfv [Kp, M]``: match emission odds, lane k = model position k+1.
    ``tr [8, M]``: transition rows in ``constants.P_*`` order, in the
    lane convention of ``fwd_params_pallas``: lane k holds the
    transitions INTO position k+1 (BM, MM, IM, DM, MD, DD) or out of
    it (MI, II).  Lanes that no recurrence reads (DM and DD at lanes
    0-1, MD at lane 0: the model has no D_1) are zero, so two sources
    of the same profile give identical tensors."""

    def __init__(self, rfv: torch.Tensor, tr: torch.Tensor):
        super().__init__()
        self.register_buffer("rfv", rfv.to(torch.float32).contiguous())
        self.register_buffer("tr", tr.to(torch.float32).contiguous())
        self._padded: dict = {}

    def padded(self, Mp: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(rfv, tr) zero-padded to Mp lanes, the kernels' tables;
        cached per width and device."""
        key = (Mp, self.rfv.device)
        if key not in self._padded:
            pad = (0, Mp - self.M)
            self._padded[key] = (F.pad(self.rfv, pad).contiguous(),
                                 F.pad(self.tr, pad).contiguous())
        return self._padded[key]

    @property
    def device(self) -> torch.device:
        return self.rfv.device

    @property
    def M(self) -> int:
        return int(self.tr.shape[1])

    @property
    def Kp(self) -> int:
        return int(self.rfv.shape[0])


def _canonical_tr(tr: np.ndarray) -> np.ndarray:
    tr = np.array(tr, np.float32)
    tr[C.P_DM, :2] = 0.0
    tr[C.P_DD, :2] = 0.0
    tr[C.P_MD, 0] = 0.0
    return tr


def transition_rows(tfv: np.ndarray, M: int) -> np.ndarray:
    """``tr [8, M]`` in the lane convention above, from a profile's
    ``tfv [M+1, 8]`` (slot k = transitions out of position k)."""
    tr = np.zeros((8, M), np.float32)
    for r in (C.P_BM, C.P_MM, C.P_IM, C.P_DM):
        tr[r] = tfv[:M, r]
    for r in (C.P_MI, C.P_II):
        tr[r] = tfv[1:M + 1, r]
    for r in (C.P_MD, C.P_DD):
        tr[r, 1:M] = tfv[1:M, r]
    return _canonical_tr(tr)


def fwd_params(om, device="cpu") -> ProfileTensors:
    """Parameters of an ``OProfile`` for the gate and domain-decoding
    kernels."""
    M = om.M
    rfv = np.ascontiguousarray(om.rfv[:, 1:M + 1], np.float32)
    return ProfileTensors(
        torch.from_numpy(rfv),
        torch.from_numpy(transition_rows(om.tfv, M))).to(device)


def fwd_params_from_jax(rfv, tr, M: int, device="cpu") -> ProfileTensors:
    """The same tensors from the JAX gate's parameter set, as numpy:
    ``(rfv [Kp, Mp], tr [8, Mp])`` of ``fwd_params_pallas``.

    (The production ``FwdMBParams`` folds tMD, tDD and tDM into the
    products of its closure operator ``W3`` and weight vector ``u``;
    those leave one free scale between the three rows, so they cannot
    be recovered from it.  ``domdec_params_from_jax`` carries the
    ``FwdMBParams`` inside ``DomDecParams`` exactly.)"""
    rfv = np.asarray(rfv, np.float32)[:, :M]
    tr = np.asarray(tr, np.float32)[:, :M]
    return ProfileTensors(torch.from_numpy(np.ascontiguousarray(rfv)),
                          torch.from_numpy(_canonical_tr(tr))).to(device)


# ---------------------------------------------------------------------
# Plain PyTorch version: vectorised over the batch and model lanes, a
# Python loop over rows.  The tests hold it against the JAX kernels,
# and chip_smoke.py holds the CUDA kernel against it on the card.
# ---------------------------------------------------------------------
def shift_right(x: torch.Tensor) -> torch.Tensor:
    """Lane k reads lane k-1 (the model's k-1 access); lane 0 gets 0."""
    return F.pad(x[:, :-1], (1, 0))


def shift_left(x: torch.Tensor) -> torch.Tensor:
    """Lane k reads lane k+1; the last lane gets 0."""
    return F.pad(x[:, 1:], (0, 1))


def linear_scan(b: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """y[k] = b[k] + a[k] * y[k-1] along the last axis (y[-1] = 0), as a
    log-depth Hillis-Steele scan of affine maps: the D->D chain."""
    a = a.expand_as(b)
    n = b.shape[-1]
    s = 1
    while s < n:
        b = b + a * F.pad(b[:, :-s], (s, 0))
        a = a * F.pad(a[:, :-s], (s, 0), value=1.0)
        s *= 2
    return b


def length_model(lens: torch.Tensor, nj: float):
    """Per-item (pmove, ploop, emove, eloop); ref
    p7_oprofile_ReconfigLength, with nj=1 multihit."""
    pmove = (2.0 + nj) / (lens.to(torch.float32) + 2.0 + nj)
    return pmove, 1.0 - pmove, (0.5 if nj > 0 else 1.0), \
        (0.5 if nj > 0 else 0.0)


def fwd_score_ref(dsq: torch.Tensor, lens: torch.Tensor,
                  p: ProfileTensors, nj: float = 1.0) -> torch.Tensor:
    """Forward-parser scores [B] (nats) of a padded amino batch
    ``dsq [B, L]`` (pad 28), each item under its own length model.
    Prob space, every row rescaled by ``max(xE, 1)``."""
    B, L = dsq.shape
    dev = dsq.device
    emis = p.rfv                                 # [Kp, M]
    tr = p.tr
    tBM, tMM, tIM, tDM = tr[C.P_BM], tr[C.P_MM], tr[C.P_IM], tr[C.P_DM]
    tMI, tII, tMD, tDD = tr[C.P_MI], tr[C.P_II], tr[C.P_MD], tr[C.P_DD]
    lens = lens.to(dev)
    pmove, ploop, emove, eloop = length_model(lens, nj)
    z = torch.zeros(B, p.M, dtype=torch.float32, device=dev)
    m, i_row, d = z, z, z
    xN = torch.ones(B, device=dev)
    xJ = torch.zeros(B, device=dev)
    xC = torch.zeros(B, device=dev)
    xB = pmove.clone()
    # the log scale is summed in f64, as the kernel does
    logacc = torch.zeros(B, dtype=torch.float64, device=dev)
    score = torch.full((B,), float("-inf"), dtype=torch.float64,
                       device=dev)
    res = dsq.to(torch.long)
    for i in range(L):
        active = i < lens
        E = emis[res[:, i]]                      # [B, M]
        sv = (xB[:, None] * tBM + shift_right(m) * tMM
              + shift_right(i_row) * tIM + shift_right(d) * tDM) * E
        new_i = m * tMI + i_row * tII
        new_d = linear_scan(shift_right(sv) * tMD, tDD)
        xE = sv.sum(1) + new_d.sum(1)
        xN2 = xN * ploop
        xC2 = xC * ploop + xE * emove
        xJ2 = xJ * ploop + xE * eloop
        xB2 = xJ2 * pmove + xN2 * pmove
        s = torch.clamp(xE, min=1.0)
        sinv = 1.0 / s
        rows = active[:, None]
        m = torch.where(rows, sv * sinv[:, None], m)
        i_row = torch.where(rows, new_i * sinv[:, None], i_row)
        d = torch.where(rows, new_d * sinv[:, None], d)
        xN = torch.where(active, xN2 * sinv, xN)
        xJ = torch.where(active, xJ2 * sinv, xJ)
        xC = torch.where(active, xC2 * sinv, xC)
        xB = torch.where(active, xB2 * sinv, xB)
        logacc = torch.where(active, logacc + torch.log(s).double(),
                             logacc)
        score = torch.where(
            lens == i + 1,
            logacc + torch.log(xC2 * sinv * pmove).double(), score)
    return score.float()


# ---------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------
def check_batch(dsq: torch.Tensor, lens: torch.Tensor,
                p: ProfileTensors) -> None:
    """Shapes, types and devices the kernels take; raises otherwise."""
    if dsq.dim() != 2 or dsq.dtype != torch.int8:
        raise ValueError(f"dsq must be [B, L] int8, got "
                         f"{tuple(dsq.shape)} {dsq.dtype}")
    if lens.shape != (dsq.shape[0],) or lens.dtype != torch.int32:
        raise ValueError(f"lens must be [B] int32, got "
                         f"{tuple(lens.shape)} {lens.dtype}")
    if not (dsq.device == lens.device == p.rfv.device):
        raise ValueError(f"dsq, lens and the profile must share a "
                         f"device: {dsq.device}, {lens.device}, "
                         f"{p.rfv.device}")


def fwd_score(dsq: torch.Tensor, lens: torch.Tensor, p: ProfileTensors,
              nj: float = 1.0) -> torch.Tensor:
    """Forward-gate scores [B] (nats).  CUDA tensors launch the CUDA
    kernel (or raise); CPU tensors run the plain version."""
    check_batch(dsq, lens, p)
    if dsq.device.type == "cpu":
        return fwd_score_ref(dsq, lens, p, nj)
    from .kernels import loader
    out = loader.prepare_fwd(dsq, lens, None, p)(nj)
    fwd_score.launches += 1
    return out


fwd_score.launches = 0      # CUDA launches through this wrapper
