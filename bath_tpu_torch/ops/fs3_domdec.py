"""Fused fs3 Forward + Backward parser + frameshift domain decoding for
the DNA windows that pass the fs3 gate and arbitration.

Counterpart of ``bath_tpu/ops/jaxk/kernels.py`` ``FS3DomDecParams``,
``fs3_domdec_params``, ``_fs3_domdec_impl`` and ``fs3_domdec_mb_batch``
(ref: impl_sse/fwdback_fs.c p7_BackwardParser_Frameshift_3Codons :565 +
decoding_fs.c p7_DomainDecoding_Frameshift :242; host
``ops/reference/fwdback_fs.py`` ``backward_parser_fs3``,
``domain_decoding_fs``).  Output is ``(btot, etot, mocc)`` ``[B, L+1]``
f32 and ``ok [B]`` bool in the JAX kernel's convention: btot/etot are
stride-3 cumulative sums (row i adds to row i-3) of the expected
domain begins/ends, mocc the posterior that nucleotide i lies in the
core model, rows 0-2 and rows past the window are zero, and
``ok=False`` sends the window to the host parsers.

Both passes keep the host's sparse rescale cadence: forward rows are
rescaled when xE > 1e4, backward rows when xB leaves [1e-4, 1e4]
(``kernels.py:1359-1361``).  Each pass returns the six specials of
every row ``[B, 6, L+1]`` f64 (xB, xN, xJ, xC, xE after the row's
rescale, and the log scale through the row), and ``finish`` combines
them with tensor ops shared by the plain version and the CUDA kernel
``ops/kernels/csrc/fs3_domdec.cu``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import constants as C

from .domdec import BWD_HI, BWD_LO, DD_UNDERFLOW_LOG
from .fs3 import codon_index_streams, fs3_forward, fs3_length_model
from .fwd import ProfileTensors, check_batch, linear_scan, shift_left


def fs3_backward(dsq: torch.Tensor, lens: torch.Tensor, p: ProfileTensors,
                 nj: float = 1.0) -> torch.Tensor:
    """The fs3 Backward parser's specials ``[B, 6, L+1]`` f64, row i of
    each window from its last nucleotide down to 0.

    Row i reads the M rows of i+2, i+3, i+4 through the emission of the
    2-, 3- and 4-nt codon that ends there (the IVX sum ivxb), and the I
    row and N/J/C of i+3; the D chain is a suffix scan along k.  xJ and
    xC are zero at rows 0-2 (the host's termination rows) and every
    row past a window's length is zero."""
    B, L = dsq.shape
    dev = dsq.device
    cc = codon_index_streams(dsq)
    emis = p.rfv
    tr = p.tr
    tBM, tMI, tII, tMD = tr[C.P_BM], tr[C.P_MI], tr[C.P_II], tr[C.P_MD]
    # the backward recurrences read the transition rows one lane over
    tn = shift_left(tr)
    tIMn, tMMn, tDMn, tDDn = tn[C.P_IM], tn[C.P_MM], tn[C.P_DM], tn[C.P_DD]
    lens = lens.to(dev).to(torch.long)
    pmove, ploop, emove, eloop = fs3_length_model(lens, nj)
    bidx = torch.arange(B, device=dev)
    z = torch.zeros(B, p.M, device=dev)
    zero = torch.zeros(B, device=dev)
    mr, ir = [z] * 4, [z] * 3           # M rows i+1..i+4, I rows i+1..i+3
    xNr, xJr, xCr = [zero] * 3, [zero] * 3, [zero] * 3
    lsb = torch.zeros(B, dtype=torch.float64, device=dev)
    spec = torch.zeros(B, 6, L + 1, dtype=torch.float64, device=dev)
    for q in range(L + 1):
        i = lens - q                    # the row of this step, per window
        active = i >= 0
        # the codon of c nt ending at row i+c, read at column i+c-1; a
        # slot of a row past the window's end is still zero
        ivxb = z
        for c, cs in zip((2, 3, 4), cc):
            col = (i + c - 1).clamp(0, L - 1)
            ivxb = ivxb + mr[(q - c) % 4] * emis[cs[bidx, col]]
        xB = (ivxb * tBM).sum(1)
        r3 = q % 3                      # the slot of row i+3
        xC = pmove if q == 0 else ploop * (pmove if q < 3 else xCr[r3])
        xJ = xB * pmove + ploop * xJr[r3]
        xN = xB * pmove + ploop * xNr[r3]
        xE = xC * emove + xJ * eloop
        iv1 = shift_left(ivxb)
        bI3 = ir[r3]
        new_i = tIMn * iv1 + tII * bI3
        pre_d = tDMn * iv1 + xE[:, None]
        new_d = linear_scan(pre_d.flip(1), tDDn.flip(0)).flip(1)
        new_m = tMMn * iv1 + tMI * bI3 + xE[:, None] \
            + shift_left(new_d * tMD)
        sb = torch.where(active & (xB > 0) & ((xB > BWD_HI) | (xB < BWD_LO)),
                         xB, torch.ones_like(xB))
        sbi = 1.0 / sb
        rows = sbi[:, None]
        mr = [r * rows for r in mr]
        ir = [r * rows for r in ir]
        mr[q % 4], ir[r3] = new_m * rows, new_i * rows
        xNr = [x * sbi for x in xNr]
        xJr = [x * sbi for x in xJr]
        xCr = [x * sbi for x in xCr]
        xNr[r3], xJr[r3], xCr[r3] = xN * sbi, xJ * sbi, xC * sbi
        lsb = lsb + torch.log(sb).double()
        head = i >= 3
        vals = (xB, xN, torch.where(head, xJ, zero),
                torch.where(head, xC, zero), xE)
        at = i.clamp(min=0)
        for k, v in enumerate(vals):
            spec[bidx[active], k, at[active]] = (v * sbi).double()[active]
        spec[bidx[active], 5, at[active]] = lsb[active]
    return spec


def finish(fspec: torch.Tensor, bspec: torch.Tensor, lens: torch.Tensor,
           logz: torch.Tensor, lsf_total: torch.Tensor, dec_loop):
    """The stride-3 combine (decoding_fs.c :242, ``kernels.py:1409-
    1459``) of the forward and backward specials ``[B, 6, L+1]`` ->
    (btot, etot, mocc) ``[B, L+1]`` f32 and ``ok [B]``.

    For row i >= 3: the begin increment pairs forward and backward xB
    at row i-3, the end increment xE at row i, and N/J/C occupancy sums
    the three frame pairs (i-3, i), (i-2, i+1), (i-1, i+2) with
    backward rows past the window dropped; every pair is weighted by
    exp(forward log scale + backward log scale - logZ), in f64.
    <dec_loop>: the N/J/C loop probability of the decoding profile, a
    scalar or one per window."""
    B, _, L1 = fspec.shape
    dev = fspec.device
    lens = lens.to(dev).to(torch.long)
    r = torch.arange(L1, device=dev)[None, :]
    valid = r <= lens[:, None]
    logz = logz.to(torch.float64)
    dec = torch.as_tensor(dec_loop, dtype=torch.float64,
                          device=dev).expand(B)[:, None]
    fB, fN, fJ, fC, fE, fL = fspec.unbind(1)
    bB, bN, bJ, bC, bE, bL = bspec.unbind(1)
    lz = logz[:, None]

    def pair(f, b, lf, lb, ok):
        t = f * b * torch.exp(lf + lb - lz)
        return torch.where(ok, t, torch.zeros_like(t))

    def back(x, s):             # value at row i-s, zero for i < s
        return F.pad(x[:, :L1 - s], (s, 0))

    def ahead(x, s):            # value at row i+s, zero past the end
        return F.pad(x[:, s:], (0, s))

    inc_b = pair(back(fB, 3), back(bB, 3), back(fL, 3), back(bL, 3),
                 valid & (r >= 3))
    inc_e = pair(fE, bE, fL, bL, valid & (r >= 3))
    # T(h): the frame pair (h-3, h); njcp(i) = T(i) + T(i+1) + T(i+2)
    t = (back(fN, 3) * bN + back(fJ, 3) * bJ + back(fC, 3) * bC) \
        * torch.exp(back(fL, 3) + bL - lz)
    t = torch.where(valid & (r >= 3), t, torch.zeros_like(t))
    njcp = (t + ahead(t, 1) + ahead(t, 2)) * dec
    mask3 = (valid & (r >= 3)).to(torch.float64)

    def cum3(inc):
        n3 = -(L1 // -3) * 3
        a = F.pad(inc, (0, n3 - L1)).reshape(B, n3 // 3, 3)
        return torch.cumsum(a, 1).reshape(B, n3)[:, :L1]

    btot = cum3(inc_b).float()
    etot = cum3(inc_e).float()
    mocc = ((1.0 - njcp) * mask3).float()
    ok = (torch.isfinite(logz)
          & (logz - lsf_total.to(torch.float64) > DD_UNDERFLOW_LOG)
          & torch.isfinite(btot).all(1)
          & torch.isfinite(etot).all(1)
          & torch.isfinite(mocc).all(1))
    return btot, etot, mocc, ok


def fs3_domdec_ref(dsq: torch.Tensor, lens: torch.Tensor, p: ProfileTensors,
                   dec_loop, nj: float = 1.0):
    """Plain PyTorch version: (btot, etot, mocc) [B, L+1], ok [B]."""
    logz, fspec = fs3_forward(dsq, lens, p, nj, decoding=True)
    bspec = fs3_backward(dsq, lens, p, nj)
    lens_l = lens.to(dsq.device).to(torch.long)
    lsf_total = fspec[torch.arange(dsq.shape[0], device=dsq.device), 5,
                      lens_l]
    return finish(fspec, bspec, lens_l, logz, lsf_total, dec_loop)


def fs3_domdec(dsq: torch.Tensor, lens: torch.Tensor, p: ProfileTensors,
               dec_loop, nj: float = 1.0):
    """(btot, etot, mocc) [B, L+1] and ok [B] of the DNA windows ``dsq
    [B, L]`` (pad 17).  CUDA tensors launch the CUDA kernel (or raise);
    CPU tensors run the plain version."""
    check_batch(dsq, lens, p)
    if dsq.device.type == "cpu":
        return fs3_domdec_ref(dsq, lens, p, dec_loop, nj)
    from .kernels import loader
    fspec, bspec, logz2 = loader.prepare_fs3(dsq, lens, None, p, True)(nj)
    fs3_domdec.launches += 1
    return finish(fspec, bspec, lens, logz2[:, 0], logz2[:, 1], dec_loop)


fs3_domdec.launches = 0     # CUDA launches through this wrapper
