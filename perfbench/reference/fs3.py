"""The frameshift Forward score and domain decoding, plain PyTorch.

The reference of the program's two fs3 device stages: the fs3-Forward
gate, a score in nats per DNA window, and fs3 decoding, per nucleotide
row i the stride-3 running sums of the expected domain begins
(``btot``) and ends (``etot``) and the posterior that row i lies in the
core model (``mocc``).  The model is BATH's 3-codon frameshift profile
(``modelconfig.c`` ``p7_ProfileConfig_fs``) in local multihit mode,
under each window's own length model on L = nt // 3 with nj = 1:

- a match state consumes a quasicodon of 2, 3 or 4 nucleotides, scored
  by the best amino acid it can stand for: a 3-nt codon its own amino
  at 1 - 3 fsprob, a stop codon the best amino one substitution away
  at fsprob; a 2-nt codon any codon with one base deleted, a 4-nt
  codon any codon left by dropping its first, second or third base,
  each at fsprob; a codon holding a base other than ACGT scores as X,
  the background's mean log-odds;
- an insert state consumes 3 nt at odds 1;
- N, J and C loop 3 nt at a time, so each runs in three phases: N is 1
  at rows 0, 1 and 2, and C may end at row L, or at L - 1 or L - 2
  through one more loop.

Decoding is the stage's quantity as the program defines it
(``decoding_fs.c`` ``p7_DomainDecoding_Frameshift``): a begin is
counted at row i from the B state of row i - 3, an end at row i, and
the N/J/C occupancy of row i sums the frame pairs (h - 3, h) for
h = i, i + 1, i + 2 with the loop probability of the host decoder's
profile (``dec_loop``) in place of the window's own.

Rows are nucleotides: row r follows r of them.  Items are batched with
their own profiles, zero-padded to the widest; a codon that runs past
an item's end has odds 0.  Both passes scale each row and carry the
logs of the scales in float64, so a pass is exact up to the rounding of
<dtype>: float64 for the reference, a lower precision for the control.
"""

from __future__ import annotations

import numpy as np
import torch

from .dp import _rscan, _scan, _sl, _sr
from .profile import AMINO_FREQS, T_BM, T_DD, T_DM, T_IM, T_II, T_MD, \
    T_MI, T_MM, tables as std_tables
from .translate import AMINO, _codon_letters

F64 = torch.float64

# rows of the emission table: the 2-, 3- and 4-nt codons (bases A, C,
# G, T numbered 0-3, the first base most significant), a 3-nt and a 2-
# or 4-nt codon holding another base, and no codon at all
ROW2, ROW3, ROW4 = 0, 16, 80
DEG3, DEGQ, NONE = 336, 337, 338
NROWS = 339


def _codon_aminos() -> np.ndarray:
    """[64] the amino (0-19) of codon 16 a + 4 b + c, -1 for a stop."""
    return np.array([AMINO.index(chr(c)) if chr(c) in AMINO else -1
                     for c in _codon_letters()], np.int64)


def _candidates() -> list:
    """[(aminos, indel)] for rows 0-335: the aminos a codon can stand
    for and whether reading it so takes an indel (or a substitution)."""
    aa = _codon_aminos()

    def cod(a, b, c):
        return int(aa[16 * a + 4 * b + c])

    out = []
    for p in range(4):
        for q in range(4):
            out.append(({cod(n, p, q) for n in range(4)}
                        | {cod(p, n, q) for n in range(4)}
                        | {cod(p, q, n) for n in range(4)}, True))
    for p in range(4):
        for q in range(4):
            for r in range(4):
                if cod(p, q, r) >= 0:
                    out.append(({cod(p, q, r)}, False))
                else:
                    out.append(({cod(n, q, r) for n in range(4)}
                                | {cod(p, n, r) for n in range(4)}
                                | {cod(p, q, n) for n in range(4)}, True))
    for p in range(4):
        for q in range(4):
            for r in range(4):
                for s in range(4):
                    out.append(({cod(p, q, s), cod(p, r, s),
                                 cod(q, r, s)}, True))
    return [({a for a in aminos if a >= 0}, indel)
            for aminos, indel in out]


def tables(h) -> tuple[np.ndarray, np.ndarray]:
    """(odds [NROWS, M], tr [8, M]) in float64 of a frameshift profile
    (``hmmfile.Hmm`` with ``fsprob``); its transitions are the standard
    profile's (``profile.tables``)."""
    if h.fsprob is None:
        raise ValueError(f"{h.name}: no FRAMESHIFT PROB, not a frameshift "
                         "profile")
    if h.ct not in (None, 1):
        raise ValueError(f"{h.name}: codon table {h.ct}; the reference "
                         "knows NCBI table 1 only")
    f = AMINO_FREQS.astype(np.float64)
    with np.errstate(divide="ignore"):
        aodds = h.mat[1:] / f                          # [M, 20]
        xodds = np.exp((np.log(aodds) * f).sum(1) / f.sum())
    clean, shift = 1.0 - 3.0 * h.fsprob, h.fsprob
    odds = np.zeros((NROWS, h.M))
    for row, (aminos, indel) in enumerate(_candidates()):
        odds[row] = aodds[:, sorted(aminos)].max(1) * (shift if indel
                                                       else clean)
    odds[DEG3] = xodds * clean
    odds[DEGQ] = xodds * shift
    return odds, std_tables(h)[1]


def codon_rows(nt: np.ndarray, L: int) -> np.ndarray:
    """[3, L + 1] the table row of the 2-, 3- and 4-nt codon that ends
    at each row 0..L of the nucleotides <nt> (codes 0-3 ACGT, any other
    code a base other than these): ``NONE`` where the codon starts
    before the first nucleotide or ends past the last."""
    nt = np.asarray(nt, np.int64)
    x = np.full(L + 4, -1, np.int64)       # -1 before the start, -2 past
    x[4:4 + len(nt)] = nt
    x[4 + len(nt):] = -2
    out = []
    for c, base in ((2, ROW2), (3, ROW3), (4, ROW4)):
        cod = np.lib.stride_tricks.sliding_window_view(x, c)[4 - c:4 - c
                                                             + L + 1]
        row = base + cod @ 4 ** np.arange(c - 1, -1, -1)
        row = np.where((cod >= 4).any(1), DEG3 if c == 3 else DEGQ, row)
        out.append(np.where((cod < 0).any(1), NONE, row))
    return np.stack(out)


class Batch:
    """Windows ``(profile index, nucleotides)`` on <device> in <dtype>,
    with <profiles> a list of ``tables`` results and <dec_loop> the
    N/J/C loop probability decoding reads, one a window (or None)."""

    def __init__(self, items, profiles, device, dtype=F64, dec_loop=None):
        self.dtype = dtype
        lens = [len(r) for _, r in items]
        B, L = len(items), max(lens)
        used = sorted({p for p, _ in items})
        slot = {p: i for i, p in enumerate(used)}
        Mm = max(profiles[p][1].shape[1] for p in used)
        emis = torch.zeros(len(used), NROWS, Mm, dtype=F64)
        trs = torch.zeros(len(used), 8, Mm, dtype=F64)
        for p in used:
            odds, tr = profiles[p]
            emis[slot[p], :, :tr.shape[1]] = torch.from_numpy(odds)
            trs[slot[p], :, :tr.shape[1]] = torch.from_numpy(tr)
        rows = np.stack([codon_rows(r, L) for _, r in items], 1)
        pid = torch.tensor([slot[p] for p, _ in items])
        self.emis = emis.to(device, dtype)
        self.tr = trs[pid].to(device, dtype)             # [B, 8, Mm]
        self.valid = (self.tr[:, T_BM] > 0).to(dtype)    # lanes < M
        self.pid = pid.to(device)
        self.rows = torch.from_numpy(rows).to(device)    # [3, B, L + 1]
        self.lens = torch.tensor(lens, device=device)
        amino = torch.div(self.lens, 3, rounding_mode="floor").to(F64)
        pmove = 3.0 / (amino + 3.0)
        self.pmove = pmove.to(dtype)
        self.ploop = (1.0 - pmove).to(dtype)
        self.dec = None if dec_loop is None else torch.tensor(
            dec_loop, dtype=F64, device=device)

    def emission(self, c, i):
        """[B, Mm] the odds of the <c>-nt codon ending at row <i>."""
        return self.emis[self.pid, self.rows[c - 2, :, i]]


def forward(bt: Batch, keep: bool = False):
    """(scores [B] f64 in nats, -inf under 2 nt; specials or None):
    the fs3 Forward parser; with <keep>, [6, L + 1, B] f64 of every
    row's scaled xB, xN, xJ, xC, xE and the log of the scale through
    that row."""
    B, L = bt.rows.shape[1], bt.rows.shape[2] - 1
    dt, dev = bt.dtype, bt.rows.device
    tBM, tMM, tIM, tDM = (bt.tr[:, r] for r in (T_BM, T_MM, T_IM, T_DM))
    tMD, tDD, tMI, tII = (bt.tr[:, r] for r in (T_MD, T_DD, T_MI, T_II))
    pm, pl = bt.pmove, bt.ploop
    Mm = tBM.shape[1]
    # rows i-4..i-1 of the entry P (slot r % 4): B, M, I, D of row r
    # times their moves into the next position, what a codon leaving
    # row r starts from; rows i-3..i-1 of M and I (slot r % 3)
    P = torch.zeros(4, B, Mm, dtype=dt, device=dev)
    Mr = torch.zeros(3, B, Mm, dtype=dt, device=dev)
    Ir = torch.zeros(3, B, Mm, dtype=dt, device=dev)
    # N, J, C of rows i-3..i-1 (slot r % 3)
    X = torch.zeros(3, 3, B, dtype=dt, device=dev)
    X[0] = 1.0
    P[0] = P[1] = pm[:, None] * tBM
    lsc = torch.zeros(B, dtype=F64, device=dev)
    score = torch.full((B,), float("-inf"), dtype=F64, device=dev)
    spec = None
    if keep:
        spec = torch.zeros(6, L + 1, B, dtype=F64, device=dev)
        spec[0, :2] = pm.to(F64)
        spec[1, :2] = 1.0
    for i in range(2, L + 1):
        m = sum(P[(i - c) % 4] * bt.emission(c, i) for c in (2, 3, 4))
        ins = Mr[i % 3] * tMI + Ir[i % 3] * tII
        d = _scan(_sr(m) * tMD, tDD)
        xE = m.sum(1) + d.sum(1)
        back = X[:, i % 3] * pl if i >= 3 else torch.stack(
            [torch.ones_like(pm), torch.zeros_like(pm),
             torch.zeros_like(pm)])
        xN = back[0]
        xJ = back[1] + xE * 0.5
        xC = back[2] + xE * 0.5
        s = torch.clamp(xE, min=1.0)
        inv = 1.0 / s
        lanes = inv[None, :, None]
        P *= lanes
        Mr *= lanes
        Ir *= lanes
        X *= inv
        m, ins, d = (v * inv[:, None] for v in (m, ins, d))
        xN, xJ, xC, xE = (v * inv for v in (xN, xJ, xC, xE))
        xB = (xN + xJ) * pm
        lsc = lsc + torch.log(s.to(F64))
        P[i % 4] = (xB[:, None] * tBM + _sr(m) * tMM + _sr(ins) * tIM
                    + _sr(d) * tDM)
        Mr[i % 3], Ir[i % 3] = m, ins
        X[:, i % 3] = torch.stack([xN, xJ, xC])
        end = (xC + (X[2, (i - 1) % 3] + X[2, (i - 2) % 3]) * pl) * pm
        score = torch.where(bt.lens == i, lsc + torch.log(end.to(F64)),
                            score)
        if keep:
            spec[:, i] = torch.stack(
                [v.to(F64) for v in (xB, xN, xJ, xC, xE)] + [lsc])
    return score, spec


def backward(bt: Batch):
    """[6, L + 1, B] f64: every row's scaled bB, bN, bJ, bC, bE and the
    log of the scale from the window's last row down to that row; rows
    past a window's end are 0."""
    B, L = bt.rows.shape[1], bt.rows.shape[2] - 1
    dt, dev = bt.dtype, bt.rows.device
    tBM, tMI, tII = (bt.tr[:, r] for r in (T_BM, T_MI, T_II))
    sMM, sIM, sDM, sMD, sDD = (_sl(bt.tr[:, r])
                               for r in (T_MM, T_IM, T_DM, T_MD, T_DD))
    valid = bt.valid
    pm, pl = bt.pmove, bt.ploop
    Mm = tBM.shape[1]
    # M of rows r+1..r+4 (slot r % 4), I of rows r+1..r+3 (slot r % 3)
    Mr = torch.zeros(4, B, Mm, dtype=dt, device=dev)
    Ir = torch.zeros(3, B, Mm, dtype=dt, device=dev)
    X = torch.zeros(3, 3, B, dtype=dt, device=dev)     # N, J, C
    zero = torch.zeros(B, dtype=dt, device=dev)
    lsc = torch.zeros(B, dtype=F64, device=dev)
    spec = torch.zeros(6, L + 1, B, dtype=F64, device=dev)
    for r in range(L, -1, -1):
        act = bt.lens >= r
        q = sum(Mr[(r + c) % 4] * bt.emission(c, min(r + c, L))
                * (r + c <= L) for c in (2, 3, 4))
        xB = (tBM * q).sum(1)
        xN = xB * pm + X[0, r % 3] * pl
        xJ = xB * pm + X[1, r % 3] * pl
        tail = bt.lens - r
        xC = torch.where(tail == 0, pm,
                         torch.where(tail <= 2, pl * pm, X[2, r % 3] * pl))
        xE = (xC + xJ) * 0.5
        q1 = _sl(q)
        i3 = Ir[r % 3]
        ins = sIM * q1 + tII * i3
        d = _rscan(xE[:, None] * valid + sDM * q1, sDD)
        m = xE[:, None] * valid + sMM * q1 + tMI * i3 + sMD * _sl(d)
        vals = [torch.where(act[:, None], v, 0.0) for v in (m, ins, d)]
        xs = [torch.where(act, v, zero) for v in (xB, xN, xJ, xC, xE)]
        top = torch.stack([v.amax(1) for v in vals] + xs).amax(0)
        s = torch.where(act, torch.clamp(top, min=1.0), torch.ones_like(top))
        inv = 1.0 / s
        lanes = inv[None, :, None]
        Mr *= lanes
        Ir *= lanes
        X *= inv
        m, ins, _ = (v * inv[:, None] for v in vals)
        xB, xN, xJ, xC, xE = (v * inv for v in xs)
        lsc = lsc + torch.log(s.to(F64))
        Mr[r % 4], Ir[r % 3] = m, ins
        X[:, r % 3] = torch.stack([xN, xJ, xC])
        spec[:, r] = torch.stack(
            [v.to(F64) for v in (xB, xN, xJ, xC, xE)] + [lsc])
    return spec


def _stride3_cumsum(x):
    """Along dim 0 of [L + 1, B]: row i plus rows i - 3, i - 6, ..."""
    n = x.shape[0]
    n3 = -(n // -3) * 3
    pad = torch.cat([x, x.new_zeros(n3 - n, x.shape[1])])
    return torch.cumsum(pad.reshape(n3 // 3, 3, -1), 0).reshape(n3, -1)[:n]


def decode(bt: Batch):
    """(scores [B], [(btot, etot, mocc)] as float64 NumPy arrays of
    L_b + 1 rows a window)."""
    score, fs = forward(bt, keep=True)
    bs = backward(bt)
    L = bt.rows.shape[2] - 1
    lf, lb = fs[5], bs[5]                          # [L + 1, B]
    r = torch.arange(L + 1, device=score.device)[:, None]
    rows = (r >= 3) & (r <= bt.lens[None, :])

    def back3(x):                                  # row i - 3
        return torch.cat([x.new_zeros(3, x.shape[1]), x[:-3]])

    def ahead(x, s):                               # row i + s
        return torch.cat([x[s:], x.new_zeros(s, x.shape[1])])

    pb = back3(fs[0] * bs[0] * torch.exp(lf + lb - score))
    pe = fs[4] * bs[4] * torch.exp(lf + lb - score)
    t = (back3(fs[1]) * bs[1] + back3(fs[2]) * bs[2]
         + back3(fs[3]) * bs[3]) * torch.exp(back3(lf) + lb - score)
    t = torch.where(rows, t, 0.0)
    njc = (t + ahead(t, 1) + ahead(t, 2)) * bt.dec[None, :]
    btot = _stride3_cumsum(torch.where(rows, pb, 0.0))
    etot = _stride3_cumsum(torch.where(rows, pe, 0.0))
    mocc = torch.where(rows, 1.0 - njc, 0.0)
    out = [a.T.cpu().numpy() for a in (btot, etot, mocc)]
    lens = bt.lens.tolist()
    return score.cpu().numpy(), [
        tuple(a[b, :n + 1] for a in out) for b, n in enumerate(lens)]
