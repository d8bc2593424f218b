"""Forward-parser scores and domain decoding, plain PyTorch.

The reference of the program's two f32 device stages: the Forward gate
(F3), a score in nats per amino-acid item, and domain decoding, per
residue j the expected number of domain begins (``btot``) and ends
(``etot``) up to j and the posterior that j lies in the core model
(``mocc``).  The model is the local multihit profile of
``profile.tables`` under each item's own length model (HMMER's
p7_ReconfigLength with nj = 1).

Items are batched with their own profiles: tables are zero-padded to
the widest profile, which leaves every recurrence exact, and rows past
an item's length leave its state alone.  Both passes keep their values
near 1 by a scale a row and carry the logs of the scales in float64,
so a pass is exact up to the rounding of <dtype>: float64 for the
reference, a lower precision for the control (``--control``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .profile import NRES, T_BM, T_DD, T_DM, T_IM, T_II, T_MD, T_MI, T_MM

F64 = torch.float64


def _sr(x):
    """Lane k reads lane k - 1; lane 0 reads 0."""
    return F.pad(x[:, :-1], (1, 0))


def _sl(x):
    """Lane k reads lane k + 1; the last lane reads 0."""
    return F.pad(x[:, 1:], (0, 1))


def _scan(b, a):
    """y[k] = b[k] + a[k] y[k - 1] along lanes (a log-depth scan)."""
    n, s = b.shape[-1], 1
    while s < n:
        b = b + a * F.pad(b[:, :-s], (s, 0))
        a = a * F.pad(a[:, :-s], (s, 0), value=1.0)
        s *= 2
    return b


def _rscan(b, a):
    """y[k] = b[k] + a[k] y[k + 1] along lanes."""
    return _scan(b.flip(-1), a.flip(-1)).flip(-1)


class Batch:
    """Items ``(profile index, residues)`` on <device> in <dtype>, with
    <profiles> a list of ``profile.tables`` results."""

    def __init__(self, items, profiles, device, dtype=F64):
        self.dtype = dtype
        lens = [len(r) for _, r in items]
        B, L = len(items), max(lens)
        used = sorted({p for p, _ in items})
        slot = {p: i for i, p in enumerate(used)}
        Mm = max(profiles[p][1].shape[1] for p in used)
        emis = torch.zeros(len(used), NRES, Mm, dtype=F64)
        trs = torch.zeros(len(used), 8, Mm, dtype=F64)
        for p in used:
            odds, tr = profiles[p]
            emis[slot[p], :, :tr.shape[1]] = torch.from_numpy(odds)
            trs[slot[p], :, :tr.shape[1]] = torch.from_numpy(tr)
        res = np.full((B, L), NRES - 1, np.int64)       # odds 0
        for b, (_, r) in enumerate(items):
            res[b, :len(r)] = r
        pid = torch.tensor([slot[p] for p, _ in items])
        self.emis = emis.to(device, dtype)
        self.tr = trs[pid].to(device, dtype)             # [B, 8, Mm]
        self.valid = (self.tr[:, T_BM] > 0).to(dtype)    # lanes < M
        self.pid = pid.to(device)
        self.res = torch.from_numpy(res).to(device)
        self.lens = torch.tensor(lens, device=device)
        pmove = 3.0 / (self.lens.to(F64) + 3.0)
        self.pmove = pmove.to(dtype)
        self.ploop = (1.0 - pmove).to(dtype)
        self.logpmove = torch.log(pmove)

    def emission(self, i):
        return self.emis[self.pid, self.res[:, i]]


def forward(bt: Batch, keep: bool = False):
    """(scores [B] f64 in nats, specials or None): the Forward parser;
    with <keep>, [6, L + 1, B] f64 of every row's scaled xB, xN, xJ,
    xC, xE and the log of the scale through that row."""
    B, L = bt.res.shape
    dt = bt.dtype
    tBM, tMM, tIM, tDM = (bt.tr[:, r] for r in (T_BM, T_MM, T_IM, T_DM))
    tMD, tDD, tMI, tII = (bt.tr[:, r] for r in (T_MD, T_DD, T_MI, T_II))
    pm, pl = bt.pmove, bt.ploop
    dev = bt.res.device
    m = ins = d = torch.zeros(B, tBM.shape[1], dtype=dt, device=dev)
    xN = torch.ones(B, dtype=dt, device=dev)
    xJ = torch.zeros(B, dtype=dt, device=dev)
    xC = torch.zeros(B, dtype=dt, device=dev)
    xB = pm.clone()
    lsc = torch.zeros(B, dtype=F64, device=dev)
    score = torch.full((B,), float("-inf"), dtype=F64, device=dev)
    spec = None
    if keep:
        spec = torch.zeros(6, L + 1, B, dtype=F64, device=dev)
        spec[0, 0] = pm.to(F64)
        spec[1, 0] = 1.0
    for i in range(L):
        act = i < bt.lens
        sv = (xB[:, None] * tBM + _sr(m) * tMM + _sr(ins) * tIM
              + _sr(d) * tDM) * bt.emission(i)
        ni = m * tMI + ins * tII
        nd = _scan(_sr(sv) * tMD, tDD)
        xE = sv.sum(1) + nd.sum(1)
        xN2 = xN * pl
        xC2 = xC * pl + xE * 0.5
        xJ2 = xJ * pl + xE * 0.5
        xB2 = (xN2 + xJ2) * pm
        s = torch.clamp(xE, min=1.0)
        inv = 1.0 / s
        rows = act[:, None]
        m = torch.where(rows, sv * inv[:, None], m)
        ins = torch.where(rows, ni * inv[:, None], ins)
        d = torch.where(rows, nd * inv[:, None], d)
        xN = torch.where(act, xN2 * inv, xN)
        xJ = torch.where(act, xJ2 * inv, xJ)
        xC = torch.where(act, xC2 * inv, xC)
        xB = torch.where(act, xB2 * inv, xB)
        lsc = torch.where(act, lsc + torch.log(s.to(F64)), lsc)
        score = torch.where(bt.lens == i + 1,
                            lsc + torch.log(xC.to(F64)) + bt.logpmove,
                            score)
        if keep:
            spec[:, i + 1] = torch.stack(
                [v.to(F64) for v in (xB, xN, xJ, xC, xE * inv)] + [lsc])
    return score, spec


def backward(bt: Batch):
    """[6, L + 1, B] f64: every row's scaled bB, bN, bJ, bC, bE and the
    log of the scale from the item's last row down to that row."""
    B, L = bt.res.shape
    dt = bt.dtype
    tBM, tMI, tII = (bt.tr[:, r] for r in (T_BM, T_MI, T_II))
    sMM, sIM, sDM, sMD, sDD = (_sl(bt.tr[:, r])
                               for r in (T_MM, T_IM, T_DM, T_MD, T_DD))
    valid = bt.valid
    pm, pl = bt.pmove, bt.ploop
    dev = bt.res.device
    m = ins = d = torch.zeros(B, tBM.shape[1], dtype=dt, device=dev)
    zero = torch.zeros(B, dtype=dt, device=dev)
    xB = xN = xJ = xC = xE = zero
    lsc = torch.zeros(B, dtype=F64, device=dev)
    spec = torch.zeros(6, L + 1, B, dtype=F64, device=dev)
    # the last row of an item: C moves out, every M and D may exit
    iC = pm
    iE = iC * 0.5
    iD = _rscan(iE[:, None] * valid, sDD)
    iM = iE[:, None] * valid + sMD * _sl(iD)
    for r in range(L, -1, -1):
        start = (bt.lens == r)[:, None]
        if r < L:
            mstar = m * bt.emission(r)           # M(r+1) e(x_{r+1})
            rB = (tBM * mstar).sum(1)
            rC = xC * pl
            rJ = rB * pm + xJ * pl
            rN = rB * pm + xN * pl
            rE = (rC + rJ) * 0.5
            ms1 = _sl(mstar)
            rI = ins * tII + ms1 * sIM
            rD = _rscan(ms1 * sDM + rE[:, None] * valid, sDD)
            rM = ins * tMI + ms1 * sMM + rE[:, None] * valid + sMD * _sl(rD)
        else:
            rB = rC = rJ = rN = rE = zero
            rI = rD = rM = m
        go = (bt.lens > r)[:, None]
        vals = [torch.where(start, a, torch.where(go, b, c))
                for a, b, c in ((iM, rM, m), (zero[:, None], rI, ins),
                                (iD, rD, d))]
        xs = [torch.where(start[:, 0], a, torch.where(go[:, 0], b, c))
              for a, b, c in ((zero, rB, xB), (zero, rN, xN),
                              (zero, rJ, xJ), (iC, rC, xC), (iE, rE, xE))]
        act = (start | go)[:, 0]
        top = torch.stack([v.amax(1) for v in vals] + xs).amax(0)
        s = torch.where(act, torch.clamp(top, min=1.0),
                        torch.ones_like(top))
        inv = 1.0 / s
        m, ins, d = (v * inv[:, None] for v in vals)
        xB, xN, xJ, xC, xE = (v * inv for v in xs)
        lsc = lsc + torch.log(s.to(F64))
        spec[:, r] = torch.stack(
            [v.to(F64) for v in (xB, xN, xJ, xC, xE)] + [lsc])
    return spec


def decode(bt: Batch):
    """(scores [B], [(btot, etot, mocc)] as float64 NumPy arrays of
    L_b + 1 rows an item)."""
    score, fs = forward(bt, keep=True)
    bs = backward(bt)
    L = bt.res.shape[1]
    lf, lb = fs[5], bs[5]                        # [L + 1, B]
    pl = bt.ploop.to(F64)
    rows = (torch.arange(1, L + 1, device=score.device)[:, None]
            <= bt.lens[None, :])
    pb = fs[0, :-1] * bs[0, :-1] * torch.exp(lf[:-1] + lb[:-1] - score)
    pe = fs[4, 1:] * bs[4, 1:] * torch.exp(lf[1:] + lb[1:] - score)
    njc = (fs[1, :-1] * bs[1, 1:] + fs[2, :-1] * bs[2, 1:]
           + fs[3, :-1] * bs[3, 1:]) * pl * torch.exp(lf[:-1] + lb[1:]
                                                      - score)
    z = torch.zeros(1, score.shape[0], dtype=F64, device=score.device)
    btot = torch.cat([z, torch.cumsum(torch.where(rows, pb, 0.0), 0)])
    etot = torch.cat([z, torch.cumsum(torch.where(rows, pe, 0.0), 0)])
    mocc = torch.cat([z, torch.where(rows, 1.0 - njc, 0.0)])
    out = [t.T.cpu().numpy() for t in (btot, etot, mocc)]
    lens = bt.lens.tolist()
    return score.cpu().numpy(), [
        tuple(a[b, :n + 1] for a in out) for b, n in enumerate(lens)]
