"""Forward + Backward parser + domain decoding for F3 survivors.

Counterpart of ``bath_tpu/ops/jaxk/kernels.py`` ``DomDecParams``,
``domdec_params``, ``_domdec_mb_impl`` and ``domdec_mb_batch`` (ref:
impl_sse/fwdback.c backward_engine + decoding.c p7_DomainDecoding).
Output is ``(btot, etot, mocc)`` ``[B, L+1]`` f32 and ``ok [B]`` bool
in the JAX kernel's convention: row j of btot/etot is the cumulative
expected number of domain begins/ends up to residue j, mocc the
posterior that residue j is in the core model, and ``ok=False`` sends
the item to the host Backward.

``domdec`` launches ``ops/kernels/csrc/domdec.cu`` for CUDA tensors: the
kernel runs an ORF's Forward and Backward at once, each storing its six
specials of every row, and ``finish_passes`` combines them into the
normalised per-row increments, then the cumsum and the ``ok`` test
(``finish``), as tensor ops.  ``domdec_passes_ref`` is the plain PyTorch
version of the kernel's outputs; ``domdec_ref``, the plain version of
the whole (the increments formed inside the backward loop), is what CPU
tensors run.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as C

from .fwd import (ProfileTensors, _canonical_tr, check_batch,
                  fwd_params, length_model, linear_scan, shift_left,
                  shift_right)

# device forward logZ minus log(total forward scale) below this means
# the host backward (borrowed-scale stored values, f32) is at or near
# its xN underflow RangeError; the item takes the host path, which
# decides that case (kernels.py _DD_UNDERFLOW_LOG)
DD_UNDERFLOW_LOG = -85.0

# forward rows are rescaled only when xE exceeds this (the host
# kernel's sparse cadence); backward rows when xB leaves [1e-4, 1e4]
FWD_RESCALE = 1.0e4
BWD_HI, BWD_LO = 1.0e4, 1.0e-4


def domdec_params(om, device="cpu") -> ProfileTensors:
    """The gate's parameter set serves decoding too: the backward
    recurrences read the same transition rows one lane over."""
    return fwd_params(om, device)


def domdec_params_from_jax(p, device="cpu") -> ProfileTensors:
    """The port's tensors from the JAX ``DomDecParams`` (numpy, as
    ``domdec_params`` builds it with jnp arrays converted): the match
    odds and five rows come from its ``FwdMBParams``, tDM and tMD from
    the backward vectors, tDD from the superdiagonal of the suffix
    closure ``UB``."""
    f = p.fwd
    M = int(f.M)
    tr = np.zeros((8, M), np.float32)
    tr[C.P_BM] = np.asarray(f.tBM)[:M]
    tr[C.P_MM] = np.asarray(f.tMM)[:M]
    tr[C.P_IM] = np.asarray(f.tIM)[:M]
    tr[C.P_MI] = np.asarray(f.tMI)[:M]
    tr[C.P_II] = np.asarray(f.tII)[:M]
    tr[C.P_DM, 1:M] = np.asarray(p.tDM_next)[:M - 1]
    tr[C.P_MD, 1:M] = np.asarray(p.vMD)[1:M]
    UB = np.asarray(p.UB)
    tr[C.P_DD, 1:M] = np.diagonal(UB, offset=1)[:M - 1]
    rfv = np.ascontiguousarray(np.asarray(f.rfvT, np.float32)[:M].T)
    return ProfileTensors(torch.from_numpy(rfv),
                          torch.from_numpy(_canonical_tr(tr))).to(device)


def finish(inc_b, inc_e, njr, lens, logz, log_xc):
    """The normalised increments of rows 1..L ``[B, L]`` -> (btot, etot,
    mocc) ``[B, L+1]`` and ``ok`` (kernels.py:1149-1172).  ``log_xc`` is
    logZ minus the total forward log scale."""
    B, L = inc_b.shape
    valid = (torch.arange(L, device=lens.device)[None, :]
             < lens[:, None]).to(torch.float32)
    z1 = torch.zeros(B, 1, device=inc_b.device)
    btot = torch.cat([z1, torch.cumsum(inc_b * valid, 1)], 1)
    etot = torch.cat([z1, torch.cumsum(inc_e * valid, 1)], 1)
    mocc = torch.cat([z1, (1.0 - njr) * valid], 1)
    ok = (torch.isfinite(logz)
          & (log_xc > DD_UNDERFLOW_LOG)
          & torch.isfinite(btot).all(1)
          & torch.isfinite(etot).all(1)
          & torch.isfinite(mocc).all(1))
    return btot, etot, mocc, ok


def _forward_specials(dsq, lens, p: ProfileTensors, nj: float):
    """The forward pass of decoding: the six specials of every row
    [6, L+1, B] f64 (xB, xN, xJ, xC, xE after the row's rescale, and the
    log scale through the row; rows past an item's length go on
    unscaled) and logZ [B] f64."""
    B, L = dsq.shape
    dev = dsq.device
    emis = p.rfv
    tr = p.tr
    tBM, tMM, tIM, tDM = tr[C.P_BM], tr[C.P_MM], tr[C.P_IM], tr[C.P_DM]
    tMI, tII, tMD, tDD = tr[C.P_MI], tr[C.P_II], tr[C.P_MD], tr[C.P_DD]
    pmove, ploop, emove, eloop = length_model(lens, nj)
    res = dsq.to(torch.long)
    z = torch.zeros(B, p.M, device=dev)
    m, i_row, d = z, z, z
    xN = torch.ones(B, device=dev)
    xJ = torch.zeros(B, device=dev)
    xC = torch.zeros(B, device=dev)
    xB = pmove.clone()
    # log scales in f64, as the kernel keeps them
    f64 = torch.float64
    lsf = torch.zeros(B, dtype=f64, device=dev)
    logz = torch.full((B,), float("-inf"), dtype=f64, device=dev)
    spec = torch.zeros(6, L + 1, B, dtype=f64, device=dev)
    spec[0, 0] = pmove
    spec[1, 0] = 1.0
    for i in range(L):
        active = i < lens
        E = emis[res[:, i]]
        sv = (xB[:, None] * tBM + shift_right(m) * tMM
              + shift_right(i_row) * tIM + shift_right(d) * tDM) * E
        new_i = m * tMI + i_row * tII
        new_d = linear_scan(shift_right(sv) * tMD, tDD)
        xE = sv.sum(1) + new_d.sum(1)
        xN2 = xN * ploop
        xC2 = xC * ploop + xE * emove
        xJ2 = xJ * ploop + xE * eloop
        xB2 = xJ2 * pmove + xN2 * pmove
        s = torch.where(active & (xE > FWD_RESCALE), xE,
                        torch.ones_like(xE))
        sinv = 1.0 / s
        m, i_row, d = (sv * sinv[:, None], new_i * sinv[:, None],
                       new_d * sinv[:, None])
        xN, xJ, xC, xB = xN2 * sinv, xJ2 * sinv, xC2 * sinv, xB2 * sinv
        lsf = lsf + torch.log(s).double()
        logz = torch.where(lens == i + 1,
                           lsf + torch.log(xC * pmove).double(), logz)
        for q, v in enumerate((xB, xN, xJ, xC, xE * sinv, lsf)):
            spec[q, i + 1] = v
    return spec, logz


def _backward_specials(dsq, lens, p: ProfileTensors, nj: float):
    """The backward pass of decoding: the six specials of every row
    [B, 6, L+1] f64 (xB, xN, xJ, xC, xE after the row's rescale, and the
    log scale through the row), what csrc/domdec.cu's backward pass
    stores; rows past an item's length are zero.  Row j's xB reads the
    emission of residue j+1; row L holds xC = pmove, xE = pmove*emove."""
    B, L = dsq.shape
    dev = dsq.device
    emis = p.rfv
    tr = p.tr
    tBM, tMI, tII, tMD = tr[C.P_BM], tr[C.P_MI], tr[C.P_II], tr[C.P_MD]
    tn = shift_left(tr)
    tIMn, tMMn, tDMn, tDDn = tn[C.P_IM], tn[C.P_MM], tn[C.P_DM], tn[C.P_DD]
    pmove, ploop, emove, eloop = length_model(lens, nj)
    res = dsq.to(torch.long)
    bidx = torch.arange(B, device=dev)
    xE_L = pmove * emove
    init = xE_L[:, None].expand(B, p.M)
    d0 = linear_scan(init.flip(1), tDDn.flip(0)).flip(1)
    mc = init + shift_left(d0 * tMD)
    ic = torch.zeros(B, p.M, device=dev)
    xNb = torch.zeros(B, device=dev)
    xJb = torch.zeros(B, device=dev)
    xCb = pmove
    lsb = torch.zeros(B, dtype=torch.float64, device=dev)
    spec = torch.zeros(B, 6, L + 1, dtype=torch.float64, device=dev)
    spec[bidx, 3, lens] = pmove.double()
    spec[bidx, 4, lens] = xE_L.double()
    for q in range(L):
        active = q < lens
        jrow = (lens - q).clamp(min=1)            # the row after this one
        E = emis[res[bidx, (jrow - 1).clamp(max=L - 1)]]
        mstar = mc * E
        xBn = (mstar * tBM).sum(1)
        ms1 = shift_left(mstar)
        new_i = ic * tII + ms1 * tIMn
        nm = ic * tMI + ms1 * tMMn
        xCn = xCb * ploop
        xJn = xBn * pmove + xJb * ploop
        xNn = xBn * pmove + xNb * ploop
        xEn = xCn * emove + xJn * eloop
        nd_pre = ms1 * tDMn + xEn[:, None]
        new_d = linear_scan(nd_pre.flip(1), tDDn.flip(0)).flip(1)
        new_m = nm + xEn[:, None] + shift_left(new_d * tMD)
        sb = torch.where(active & (xBn > 0)
                         & ((xBn > BWD_HI) | (xBn < BWD_LO)), xBn,
                         torch.ones_like(xBn))
        sbi = 1.0 / sb
        mc, ic = new_m * sbi[:, None], new_i * sbi[:, None]
        xNb, xJb, xCb = xNn * sbi, xJn * sbi, xCn * sbi
        lsb = lsb + torch.log(sb).double()
        items, rows = bidx[active], (jrow - 1)[active]
        for k, v in enumerate((xBn * sbi, xNb, xJb, xCb, xEn * sbi)):
            spec[items, k, rows] = v.double()[active]
        spec[items, 5, rows] = lsb[active]
    return spec


def domdec_passes_ref(dsq: torch.Tensor, lens: torch.Tensor,
                      p: ProfileTensors, nj: float = 1.0):
    """Plain PyTorch version of the decoding kernel's outputs: the
    forward and the backward specials [B, 6, L+1] f64 of every row (rows
    past an item's length zero) and (logZ, total forward log scale)
    [B, 2] f64; ``finish_passes`` takes them."""
    L = dsq.shape[1]
    dev = dsq.device
    lens = lens.to(dev).to(torch.long)
    spec, logz = _forward_specials(dsq, lens, p, nj)
    bidx = torch.arange(dsq.shape[0], device=dev)
    lsf_total = spec[5, lens, bidx]
    rows = torch.arange(L + 1, device=dev)[:, None] <= lens[None, :]
    fspec = torch.where(rows, spec, 0.0).permute(2, 0, 1).contiguous()
    return (fspec, _backward_specials(dsq, lens, p, nj),
            torch.stack([logz, lsf_total], 1))


def finish_passes(fspec, bspec, lens, logz2, nj: float = 1.0):
    """The decoding kernel's outputs (``domdec_passes_ref``'s) ->
    (btot, etot, mocc) [B, L+1] and ok [B]: for row j = 1..len, the
    begin increment pairs forward and backward xB at row j-1, the end
    increment xE at row j, and N/J/C occupancy the forward N/J/C of row
    j-1 with the backward's of row j, times ploop; each weighted by
    exp(forward log scale + backward log scale - logZ), in f64; then
    ``finish``."""
    L1 = fspec.shape[2]
    dev = fspec.device
    lens = lens.to(dev).to(torch.long)
    fB, fN, fJ, fC, fE, fL = fspec.unbind(1)
    bB, bN, bJ, bC, bE, bL = bspec.unbind(1)
    logz, lsf_total = logz2[:, 0], logz2[:, 1]
    lz = logz[:, None]
    ploop = length_model(lens, nj)[1].double()[:, None]
    head, tail = slice(None, L1 - 1), slice(1, None)
    inc_b = fB[:, head] * bB[:, head] * torch.exp(fL[:, head] + bL[:, head]
                                                  - lz)
    inc_e = fE[:, tail] * bE[:, tail] * torch.exp(fL[:, tail] + bL[:, tail]
                                                  - lz)
    njr = (fN[:, head] * bN[:, tail] + fJ[:, head] * bJ[:, tail]
           + fC[:, head] * bC[:, tail]) * ploop \
        * torch.exp(fL[:, head] + bL[:, tail] - lz)
    valid = torch.arange(1, L1, device=dev)[None, :] <= lens[:, None]
    inc = [torch.where(valid, t, 0.0).float() for t in (inc_b, inc_e, njr)]
    return finish(*inc, lens, logz.float(), (logz - lsf_total).float())


def domdec_ref(dsq: torch.Tensor, lens: torch.Tensor, p: ProfileTensors,
               nj: float = 1.0):
    """Plain PyTorch version: (btot, etot, mocc) [B, L+1], ok [B]."""
    B, L = dsq.shape
    dev = dsq.device
    emis = p.rfv
    tr = p.tr
    tBM, tMI, tII, tMD = tr[C.P_BM], tr[C.P_MI], tr[C.P_II], tr[C.P_MD]
    # the backward recurrences read the transition rows one lane over
    tn = shift_left(tr)
    tIMn, tMMn, tDMn, tDDn = tn[C.P_IM], tn[C.P_MM], tn[C.P_DM], tn[C.P_DD]
    lens = lens.to(dev).to(torch.long)
    pmove, ploop, emove, eloop = length_model(lens, nj)
    res = dsq.to(torch.long)

    spec, logz = _forward_specials(dsq, lens, p, nj)
    bidx = torch.arange(B, device=dev)
    lsf_total = spec[5, lens, bidx]

    # ---- backward, combined into posterior increments on the fly ----
    xC_L = pmove.clone()
    xE_L = xC_L * emove
    init = xE_L[:, None].expand(B, p.M)
    d0 = linear_scan(init.flip(1), tDDn.flip(0)).flip(1)
    mc = init + shift_left(d0 * tMD)
    ic = torch.zeros(B, p.M, device=dev)
    xNb = torch.zeros(B, device=dev)
    xJb = torch.zeros(B, device=dev)
    xCb, xEb = xC_L, xE_L
    lsb = torch.zeros(B, dtype=torch.float64, device=dev)
    inc_b = torch.zeros(B, L, device=dev)
    inc_e = torch.zeros(B, L, device=dev)
    njr = torch.zeros(B, L, device=dev)
    for q in range(L):
        active = q < lens
        jrow = (lens - q).clamp(min=1)            # output row, 1-based
        E = emis[res[bidx, (jrow - 1).clamp(max=L - 1)]]
        mstar = mc * E
        xBn = (mstar * tBM).sum(1)
        gj = spec[:, jrow, bidx]                  # forward row jrow
        gm = spec[:, jrow - 1, bidx]              # forward row jrow-1
        w_e = (gj[5] + lsb - logz).float()
        w_m = (gm[5] + lsb - logz).float()
        gj, gm = gj.float(), gm.float()
        term_e = gj[4] * xEb
        njcp = (gm[1] * xNb + gm[2] * xJb + gm[3] * xCb) * ploop
        term_b = gm[0] * xBn
        ms1 = shift_left(mstar)
        new_i = ic * tII + ms1 * tIMn
        nm = ic * tMI + ms1 * tMMn
        xCn = xCb * ploop
        xJn = xBn * pmove + xJb * ploop
        xNn = xBn * pmove + xNb * ploop
        xEn = xCn * emove + xJn * eloop
        nd_pre = ms1 * tDMn + xEn[:, None]
        new_d = linear_scan(nd_pre.flip(1), tDDn.flip(0)).flip(1)
        new_m = nm + xEn[:, None] + shift_left(new_d * tMD)
        sb = torch.where(active & (xBn > 0)
                         & ((xBn > BWD_HI) | (xBn < BWD_LO)), xBn,
                         torch.ones_like(xBn))
        sbi = 1.0 / sb
        mc, ic = new_m * sbi[:, None], new_i * sbi[:, None]
        xNb, xJb, xCb, xEb = xNn * sbi, xJn * sbi, xCn * sbi, xEn * sbi
        lsb = lsb + torch.log(sb).double()
        rows = (jrow - 1)[active]
        items = bidx[active]
        inc_e[items, rows] = (term_e * torch.exp(w_e))[active]
        inc_b[items, rows] = (term_b * torch.exp(w_m))[active]
        njr[items, rows] = (njcp * torch.exp(w_m))[active]
    return finish(inc_b, inc_e, njr, lens, logz.float(),
                  (logz - lsf_total).float())


def domdec(dsq: torch.Tensor, lens: torch.Tensor, p: ProfileTensors,
           nj: float = 1.0):
    """(btot, etot, mocc) [B, L+1] and ok [B].  CUDA tensors launch the
    CUDA kernel (or raise); CPU tensors run the plain version."""
    check_batch(dsq, lens, p)
    if dsq.device.type == "cpu":
        return domdec_ref(dsq, lens, p, nj)
    from .kernels import loader
    fspec, bspec, logz2 = loader.prepare_domdec(dsq, lens, None, p)(nj)
    domdec.launches += 1
    return finish_passes(fspec, bspec, lens, logz2, nj)


domdec.launches = 0         # CUDA launches through this wrapper
