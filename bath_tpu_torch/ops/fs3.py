"""The fs3-Forward gate (F4): score-only frameshift Forward parser over
DNA windows, codons of 2, 3 and 4 nt, with a per-window length model
on L/3 (ref: impl_sse/fwdback_fs.c p7_ForwardParser_Frameshift_3Codons).

Counterpart of the three Pallas kernels ``bath_tpu/ops/pallas/fs3.py``
(``fs3_score_pallas``), ``fs3v2.py`` (``fs3_score_v2``) and
``fs3_sub.py`` (``fs3_score_sub``), of the production jnp gate
``bath_tpu/ops/jaxk/fs3_v4.py`` (``_fs3_v4_impl``) and of
``ops/jaxk/kernels.py`` ``FS3Params``/``fs3_params``/``_fs3_score_impl``;
the host semantics are ``ops/reference/fwdback_fs.py``
``codon_indices`` and ``forward_parser_fs3``.  ``fs3_score`` launches
the hand-written CUDA kernel ``ops/kernels/csrc/fs3_parser.cu`` for
CUDA tensors and runs ``fs3_score_ref``, the plain PyTorch version,
for CPU tensors.

The emission table is the packed one of ``fs3_params_pallas``: row c
of ``rfv [338, M]`` holds the odds of packed codon index c
(``constants.codon{2,3,4}_fs3``, degenerate codons at rows 336-337),
the index space of the host's ``codon_indices(dsq, 3)``.  The kernel
computes the three indices of a row from the row's nucleotide and the
three before it, so the window travels as int8 nucleotides.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import constants as C

from .fwd import (ProfileTensors, _canonical_tr, check_batch, linear_scan,
                  shift_right, transition_rows)

DNA_PAD = 17                # missing-data nucleotide: degenerate codons
DNA_CODES = 18              # DNA residue codes 0..17 (ACGT first)
N_CODONS = C.MAXCODONS3     # packed codon rows 0..337


def fs3_params(om_fs3, device="cpu") -> ProfileTensors:
    """Parameters of an ``FSOProfile`` (codon_lengths 3) for the fs3
    gate and fs3 decoding kernels: the packed codon odds and the eight
    transition rows in the lane convention of ``ops/fwd.py``."""
    M = om_fs3.M
    rfv = np.ascontiguousarray(om_fs3.rfv[:N_CODONS, 1:M + 1], np.float32)
    return ProfileTensors(
        torch.from_numpy(rfv),
        torch.from_numpy(transition_rows(om_fs3.tfv, M))).to(device)


def compact_rows() -> tuple[list, list, list]:
    """Packed codon rows of the columns of the JAX package's compact
    tables ``T2 [M, 17]``, ``T3 [M, 65]``, ``T4 [M, 257]``
    (``kernels.py fs3_params``)."""
    dig = range(C.MAXNUC)
    o2 = [C.codon2_fs3(b, a) for a in dig for b in dig] + [C.DEGEN3_QC1]
    o3 = [C.codon3_fs3(c, b, a) for a in dig for b in dig
          for c in dig] + [C.DEGEN3_C]
    o4 = [C.codon4_fs3(d, c, b, a) for a in dig for b in dig
          for c in dig for d in dig] + [C.DEGEN3_QC1]
    return o2, o3, o4


def fs3_params_from_jax(p, device="cpu") -> ProfileTensors:
    """The port's tensors from the JAX ``FS3DomDecParams``
    (``kernels.py fs3_domdec_params``, jnp arrays as numpy), the exact
    source: the packed odds from the compact tables of its
    ``FS3Params``, five transition rows from the same, tDM from
    ``tDM_next``, tMD from ``vMD`` and tDD from the superdiagonal of
    the suffix closure ``UB``.

    (``FS3Params.UT`` folds tMD, tDD and the next lane's tDM into one
    closure operator; like ``FwdMBParams.W3`` it leaves a free scale
    between the three rows, so they cannot be recovered from it.
    ``fs3_params_from_pallas`` takes the second source.)"""
    f = p.fs3
    M = int(f.M)
    rfv = np.zeros((N_CODONS, M), np.float32)
    for tab, rows in zip((f.T2, f.T3, f.T4), compact_rows()):
        rfv[rows] = np.asarray(tab, np.float32)[:M].T
    tr = np.zeros((8, M), np.float32)
    tr[C.P_BM] = np.asarray(f.tBM)[:M]
    tr[C.P_MM] = np.asarray(f.tMM)[:M]
    tr[C.P_IM] = np.asarray(f.tIM)[:M]
    tr[C.P_MI] = np.asarray(f.tMI)[:M]
    tr[C.P_II] = np.asarray(f.tII)[:M]
    tr[C.P_DM, 1:M] = np.asarray(p.tDM_next)[:M - 1]
    tr[C.P_MD, 1:M] = np.asarray(p.vMD)[1:M]
    tr[C.P_DD, 1:M] = np.diagonal(np.asarray(p.UB), offset=1)[:M - 1]
    return ProfileTensors(torch.from_numpy(rfv),
                          torch.from_numpy(_canonical_tr(tr))).to(device)


def fs3_params_from_pallas(rfv, tr, M: int, device="cpu") -> ProfileTensors:
    """The same tensors from ``fs3_params_pallas``'s ``(rfv [R, Mp],
    tr [8+Mp, Mp])``, whose first eight rows of ``tr`` are the
    transition rows themselves (the closure operator follows them)."""
    rfv = np.asarray(rfv, np.float32)[:N_CODONS, :M]
    tr = _canonical_tr(np.asarray(tr, np.float32)[:8, :M])
    return ProfileTensors(torch.from_numpy(np.ascontiguousarray(rfv)),
                          torch.from_numpy(tr)).to(device)


def codon_index_streams(dsq: torch.Tensor):
    """(c2, c3, c4) ``[B, L]`` long: the packed index of the 2-, 3- and
    4-nt codon ending at each nucleotide of ``dsq [B, L]``, with the
    degeneracy routing of ``codon_indices(dsq, 3)``: a nucleotide code
    >= 4, and every position before the window's first, reads as the
    placeholder 338, which sends the codon to a degenerate row."""
    place = C.MAXCODONS3
    x = torch.where(dsq < C.MAXNUC, dsq.to(torch.long),
                    torch.full_like(dsq, place, dtype=torch.long))
    xm1 = F.pad(x, (1, 0), value=place)[:, :-1]
    xm2 = F.pad(x, (2, 0), value=place)[:, :-2]
    xm3 = F.pad(x, (3, 0), value=place)[:, :-3]
    c2 = x * C.NUC1_FS3 + xm1 * C.NUC2_FS3
    c3 = c2 + xm2 * C.NUC3_FS3 + C.C2
    c4 = c2 + xm2 * C.NUC3_FS3 + xm3 + C.C3
    return (c2.clamp(max=C.DEGEN3_QC1), c3.clamp(max=C.DEGEN3_C),
            c4.clamp(max=C.DEGEN3_QC1))


def fs3_length_model(lens: torch.Tensor, nj: float):
    """Per-window (pmove, ploop, emove, eloop) on the amino length
    L // 3 (ref: p7_fs_oprofile_ReconfigLength(wlen / 3))."""
    Lf = torch.div(lens, 3, rounding_mode="floor").to(torch.float32)
    pmove = (2.0 + nj) / (Lf + 2.0 + nj)
    return pmove, 1.0 - pmove, (0.5 if nj > 0 else 1.0), \
        (0.5 if nj > 0 else 0.0)


# ---------------------------------------------------------------------
# Plain PyTorch version: vectorised over windows and model lanes, a
# Python loop over nucleotide rows.
# ---------------------------------------------------------------------
def fs3_forward(dsq: torch.Tensor, lens: torch.Tensor, p: ProfileTensors,
                nj: float = 1.0, decoding: bool = False):
    """The fs3 Forward recurrence over rows 2..L of ``dsq [B, L]``.

    Rings as the host parser keeps them: M, I, D rows of i-1..i-3 (the
    2-nt codon leaves from row i-2, the I state from row i-3), and the
    IVX entry rows sv of i-1 and i-2, which the 3- and 4-nt codons
    leave from; N/J/C loop every 3 nt.  The gate (<decoding> False)
    rescales every row by max(xE, 1); decoding keeps the host's sparse
    cadence (rescale only when xE > 1e4).  Log scales are summed in
    f64.  Returns (score [B] f64 nats, -inf where L < 2) and, with
    <decoding>, the specials ``[B, 6, L+1]`` f64 of every row: xB, xN,
    xJ, xC, xE after the row's rescale and the log scale through the
    row (rows 0 and 1 are the initial ones)."""
    B, L = dsq.shape
    dev = dsq.device
    c2, c3, c4 = codon_index_streams(dsq)
    emis = p.rfv
    tr = p.tr
    tBM, tMM, tIM, tDM = tr[C.P_BM], tr[C.P_MM], tr[C.P_IM], tr[C.P_DM]
    tMI, tII, tMD, tDD = tr[C.P_MI], tr[C.P_II], tr[C.P_MD], tr[C.P_DD]
    lens = lens.to(dev).to(torch.long)
    pmove, ploop, emove, eloop = fs3_length_model(lens, nj)
    z = torch.zeros(B, p.M, device=dev)
    one = torch.ones(B, device=dev)
    zero = torch.zeros(B, device=dev)
    mr, ir, dr, ivx = [z] * 4, [z] * 4, [z] * 4, [z] * 3
    xN, xB = [one, one, zero, zero], [pmove, pmove, zero, zero]
    xJ, xC = [zero] * 4, [zero] * 4
    f64 = torch.float64
    lsf = torch.zeros(B, dtype=f64, device=dev)
    score = torch.full((B,), float("-inf"), dtype=f64, device=dev)
    spec = None
    if decoding:
        spec = torch.zeros(B, 6, L + 1, dtype=f64, device=dev)
        spec[:, 0, :2] = pmove[:, None].double()
        spec[:, 1, :2] = 1.0
    for i in range(2, L + 1):
        cur, p2, p3 = i % 4, (i - 2) % 4, (i - 3) % 4
        sv = (xB[p2][:, None] * tBM + shift_right(mr[p2]) * tMM
              + shift_right(ir[p2]) * tIM + shift_right(dr[p2]) * tDM)
        msv = sv * emis[c2[:, i - 1]]
        if i >= 3:
            msv = (msv + ivx[(i - 1) % 3] * emis[c3[:, i - 1]]
                   + ivx[(i - 2) % 3] * emis[c4[:, i - 1]])
            new_i = mr[p3] * tMI + ir[p3] * tII
            xN2 = xN[p3] * ploop
            xJ2, xC2 = xJ[p3] * ploop, xC[p3] * ploop
        else:
            new_i = z
            xN2, xJ2, xC2 = one, zero, zero
        ivx[i % 3] = sv
        new_d = linear_scan(shift_right(msv) * tMD, tDD)
        xE = msv.sum(1) + new_d.sum(1)
        xJ2 = xJ2 + xE * eloop
        xC2 = xC2 + xE * emove
        xB2 = (xN2 + xJ2) * pmove
        if decoding:
            s = torch.where(xE > 1.0e4, xE, torch.ones_like(xE))
        else:
            s = torch.clamp(xE, min=1.0)
        sinv = 1.0 / s
        mr[cur], ir[cur], dr[cur] = msv, new_i, new_d
        xN[cur], xJ[cur], xC[cur], xB[cur] = xN2, xJ2, xC2, xB2
        rows = sinv[:, None]
        mr, ir, dr = ([r * rows for r in mr], [r * rows for r in ir],
                      [r * rows for r in dr])
        ivx = [r * rows for r in ivx]
        xN, xJ = [x * sinv for x in xN], [x * sinv for x in xJ]
        xC, xB = [x * sinv for x in xC], [x * sinv for x in xB]
        lsf = lsf + torch.log(s).double()
        cl = xC[cur] + (xC[(i - 1) % 4] + xC[(i - 2) % 4]) * ploop
        score = torch.where(lens == i, lsf + torch.log(cl * pmove).double(),
                            score)
        if decoding:
            for q, v in enumerate((xB[cur], xN[cur], xJ[cur], xC[cur],
                                   xE * sinv)):
                spec[:, q, i] = v.double()
            spec[:, 5, i] = lsf
    return score, spec


def fs3_score_ref(dsq: torch.Tensor, lens: torch.Tensor, p: ProfileTensors,
                  nj: float = 1.0) -> torch.Tensor:
    """fs3-Forward gate scores [B] (nats, f32) of a padded DNA batch
    ``dsq [B, L]`` (pad 17), each window under its own length model;
    -inf for windows shorter than 2 nt."""
    return fs3_forward(dsq, lens, p, nj)[0].float()


# ---------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------
def fs3_score(dsq: torch.Tensor, lens: torch.Tensor, p: ProfileTensors,
              nj: float = 1.0) -> torch.Tensor:
    """fs3-Forward gate scores [B] (nats).  CUDA tensors launch the CUDA
    kernel (or raise); CPU tensors run the plain version."""
    check_batch(dsq, lens, p)
    if dsq.device.type == "cpu":
        return fs3_score_ref(dsq, lens, p, nj)
    from .kernels import loader
    out = loader.prepare_fs3(dsq, lens, None, p, False)(nj)
    fs3_score.launches += 1
    return out


fs3_score.launches = 0      # CUDA launches through this wrapper
