"""Envelope rescoring of the standard branch, every envelope of a batch
at once: the unihit Forward with its full matrix, the Backward on the
Forward's scales, posterior decoding and the optimal-accuracy fill, bit
for bit the native host fills (``native/src/bathio.cpp``
``bio_fwd_fill``, ``bio_bwd_fill``, ``bio_decoding``, ``bio_oa_fill``)
that ``domaindef.rescore_isolated_domain_bath`` runs one envelope at a
time.

``launch`` takes the envelopes' residues and length models (``xff``: the
eight floats of ``native._xff_of`` under the envelope's unihit length)
and gives a ``Pending``, whose ``fills()`` are one ``Fills`` an envelope.
On a CUDA device it launches ``ops/kernels/csrc/rescore.cu`` (one block
an envelope) and copies the outputs into pinned host memory; on the CPU
the plain version is the host's own fills (``domaindef.envelope_fills``
and the optimal-accuracy fill), envelope by envelope, copied into the
same layout.  ``batch_plan`` cuts a call's envelopes into launches whose
outputs fit ``RESCORE_BYTES``: the cut depends on the envelopes' lengths
and the model's alone.

An envelope's output region: five (L+1) x (M+1) matrices (posterior M
and I, OA M, I and D), then the ``SPEC`` rows of L+1 specials; its
status is 0, or 1-3 where the Forward's xC is NaN, underflows or
overflows, 4-6 the same for the Backward's xN(0), 7 where decoding's
scale product overflows: where the host fills raise ``RangeError``
(``STATUS``).  The region of a failed fill is not read: the card leaves
there what its passes wrote, the plain version zeros.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from .. import constants as C
from .reference.fwdback import PMatrix

F32 = np.float32

# bytes of one launch's outputs (and of its blocks' global scratch, past
# a block's shared memory); one envelope alone may exceed it
RESCORE_BYTES = 1 << 30
NMAT = 5
SPEC = ("fxE", "fxN", "fxJ", "fxB", "fxC", "fscale", "bxE", "bxN", "bxJ",
        "bxB", "bxC", "bscale", "pxN", "pxJ", "pxC", "oxE", "oxN", "oxJ",
        "oxB", "oxC")
ROW = {name: r for r, name in enumerate(SPEC)}
NSPEC = len(SPEC)
# the kernel's working vectors a block, in global memory where they do
# not fit its shared memory (csrc/rescore.cu NVEC)
NVEC = 8
# a failed fill's status, by the host's RangeError
STATUS = {**{f"{p} score {k}": b + n for p, b in (("forward", 1),
                                                  ("backward", 4))
             for n, k in enumerate(("is NaN", "underflow", "overflow"))},
          "decoding scaleproduct overflow": 7}
# the length model's eight floats in om.xf (``native._xff_of``)
XFF = ((C.X_N, C.LOOP), (C.X_N, C.MOVE), (C.X_J, C.LOOP), (C.X_J, C.MOVE),
       (C.X_C, C.LOOP), (C.X_C, C.MOVE), (C.X_E, C.LOOP), (C.X_E, C.MOVE))


def region_floats(L: int, M: int) -> int:
    """Floats of an envelope's output region."""
    return (NMAT * (M + 1) + NSPEC) * (L + 1)


def pairwise_plan(n: int) -> np.ndarray:
    """numpy's pairwise summation of n f32 values (the host's
    ``np_pairwise_f32``) as the kernel reads it: [nleaf, nops, leaf
    offsets, leaf lengths, the ops' left operands, their right operands],
    int32.  A leaf is a run of at most 128 values summed in place (value
    i, i < nleaf); op m, in postorder, adds two values into value
    nleaf + m; the last is the sum."""
    leaves, ops = [], []

    def rec(o, m):
        if m <= 128:
            leaves.append((o, m))
            return ("leaf", len(leaves) - 1)
        h = m // 2
        h -= h % 8
        a, b = rec(o, h), rec(o + h, m - h)
        ops.append((a, b))
        return ("op", len(ops) - 1)

    rec(0, n)
    nleaf = len(leaves)

    def index(v):
        return v[1] if v[0] == "leaf" else nleaf + v[1]
    off, ln = zip(*leaves)
    lhs = [index(a) for a, _ in ops]
    rhs = [index(b) for _, b in ops]
    return np.array([nleaf, len(ops), *off, *ln, *lhs, *rhs], np.int32)


class RescoreParams:
    """One profile's tables as the fills read them: ``tv [8, M+1]``, the
    transitions in ``fwdback._trans_views`` order, ``rfv [Kp, M+1]``, the
    match odds, and ``pw``, the pairwise plan of an M-value row sum; on
    the CPU ``om``, a copy of the profile for the plain version."""

    def __init__(self, om, device="cpu"):
        from .reference.fwdback import _trans_views
        self.tv_np = np.ascontiguousarray(
            np.stack([np.asarray(v, F32) for v in _trans_views(om)]))
        self.rfv_np = np.ascontiguousarray(om.rfv, F32)
        self.M = int(self.tv_np.shape[1]) - 1
        self.Kp = int(self.rfv_np.shape[0])
        self.pw_np = pairwise_plan(self.M)
        self.nleaf = int(self.pw_np[0])
        self.device = torch.device(device)
        if self.device.type == "cuda":
            self.tv, self.rfv, self.pw = (
                torch.from_numpy(a).to(self.device)
                for a in (self.tv_np, self.rfv_np, self.pw_np))
        else:
            self.om = copy.deepcopy(om)


rescore_params = RescoreParams


class Fills:
    """One envelope's fills: ``status`` (0 where the host fills raise
    nothing), ``region`` (its output region, a view of the call's host
    buffer) and the buffer that holds it."""

    __slots__ = ("status", "L", "M", "region", "owner")

    def __init__(self, status, L, M, region, owner):
        self.status, self.L, self.M = int(status), L, M
        self.region, self.owner = region, owner

    def mat(self, q: int) -> np.ndarray:
        n = (self.L + 1) * (self.M + 1)
        return self.region[q * n:(q + 1) * n].reshape(self.L + 1,
                                                      self.M + 1)

    def spec(self, name: str) -> np.ndarray:
        base = NMAT * (self.L + 1) * (self.M + 1)
        r = ROW[name]
        return self.region[base + r * (self.L + 1):
                           base + (r + 1) * (self.L + 1)]

    def host(self, om):
        """(envsc, pp, ox, oasc) as the host fills give them under <om>
        reconfigured to the envelope, or None where they raise
        ``RangeError``.  envsc, from the Forward's scales and xC, repeats
        ``native.fwd_fill_native``'s arithmetic (the CPU tests hold it to
        ``domaindef.host_fills``'s envsc)."""
        if self.status:
            return None
        L, M = self.L, self.M
        scale = self.spec("fscale")
        totscale = 0.0
        for s in scale[scale != F32(1.0)]:
            totscale += float(np.log(s))
        envsc = totscale + float(np.log(self.spec("fxC")[L]
                                        * om.xf[C.X_C, C.MOVE]))
        zero = np.zeros(L + 1, F32)
        pp = PMatrix(L=L, M=M, xE=zero, xN=self.spec("pxN"),
                     xJ=self.spec("pxJ"), xB=zero, xC=self.spec("pxC"),
                     scale=np.ones(L + 1, F32), mm=self.mat(0),
                     im=self.mat(1))
        ox = PMatrix(L=L, M=M, xE=self.spec("oxE"), xN=self.spec("oxN"),
                     xJ=self.spec("oxJ"), xB=self.spec("oxB"),
                     xC=self.spec("oxC"), scale=np.ones(L + 1, F32),
                     mm=self.mat(2), im=self.mat(3), dm=self.mat(4))
        return envsc, pp, ox, float(ox.xC[L])


def same_fills(got, want) -> bool:
    """Whether two calls' fills agree: every envelope's status, and the
    region of each that did not fail bit for bit."""
    return len(got) == len(want) and all(
        g.status == w.status and (w.status or np.array_equal(
            g.region.view(np.int32), w.region.view(np.int32)))
        for g, w in zip(got, want))


def batch_plan(lens, M: int, budget: int = RESCORE_BYTES) -> list:
    """The launches of a call: consecutive runs of envelope indices whose
    outputs (and, past a block's shared memory, scratch) fit <budget>
    bytes, at least one envelope a launch."""
    scratch = 4 * NVEC * (M + 1) if _scratch_floats(M) else 0
    out, run, used = [], [], 0
    for i, L in enumerate(lens):
        b = 4 * region_floats(int(L), M) + scratch
        if run and used + b > budget:
            out.append(np.asarray(run, np.int64))
            run, used = [], 0
        run.append(i)
        used += b
    if run:
        out.append(np.asarray(run, np.int64))
    return out


def _scratch_floats(M: int) -> int:
    """Floats of global scratch a block of the kernel needs (0: the
    shared-memory instance): the kernel's own rule
    (``bt_rescore_scratch_floats``), mirrored here so that the CPU plans
    the same launches."""
    nleaf = int(pairwise_plan(M)[0])
    vals = (2 * nleaf + 31) & ~31
    plan = (2 + 2 * nleaf + 2 * (nleaf - 1) + 31) & ~31
    shared = 4 * (32 + 2 * vals + plan + (8 + NVEC) * (M + 1))
    return 0 if shared <= 227 * 1024 else NVEC * (M + 1)


class Pending:
    """One launch's outputs on their way to the host: ``fills()`` waits
    for them (on a card, for the copy into pinned memory, which the
    ``Fills`` keep alive)."""

    def __init__(self, lens, M, host, status, event=None):
        self.lens, self.M = lens, M
        self.host, self.status, self.event = host, status, event

    def fills(self) -> list:
        owner = self.host
        if self.event is not None:
            self.event.synchronize()
            self.event = None
        host = np.asarray(self.host.numpy() if torch.is_tensor(self.host)
                          else self.host)
        status = np.asarray(self.status.numpy()
                            if torch.is_tensor(self.status) else self.status)
        out, o = [], 0
        for L, st in zip(self.lens, status):
            n = region_floats(int(L), self.M)
            out.append(Fills(st, int(L), self.M, host[o:o + n], owner))
            o += n
        return out


def _check(p: RescoreParams, dsqs, xffs) -> np.ndarray:
    lens = np.array([len(d) for d in dsqs], np.int64)
    if np.shape(xffs) != (len(dsqs), 8):
        raise ValueError("one length model of eight floats an envelope")
    if len(lens) and lens.min() < 1:
        raise ValueError("an envelope holds one residue at least")
    for d in dsqs:
        d = np.asarray(d)
        if d.size and (d.min() < 0 or d.max() >= p.Kp):
            raise ValueError(f"residue codes must lie in [0, {p.Kp})")
    return lens


def prepare(p: RescoreParams, dsqs, xffs, lens):
    """(the bare launch, ``loader.prepare_rescore``, of the checked
    envelopes on <p>'s card, the floats of each one's region)."""
    from .kernels import loader
    M = p.M
    sizes = np.array([region_floats(int(L), M) for L in lens], np.int64)
    ooff = np.zeros(len(lens), np.int64)
    np.cumsum(sizes[:-1], out=ooff[1:])
    doff = np.zeros(len(lens), np.int64)
    np.cumsum(lens[:-1], out=doff[1:])
    flat = np.concatenate([np.asarray(d, np.int8) for d in dsqs])
    dev = p.device
    ints = torch.from_numpy(np.concatenate([doff, ooff])).to(dev)
    return loader.prepare_rescore(
        torch.from_numpy(flat).to(dev), ints[:len(lens)],
        torch.from_numpy(np.asarray(lens, np.int32)).to(dev),
        torch.from_numpy(np.ascontiguousarray(xffs, F32)).to(dev),
        ints[len(lens):], int(sizes.sum()), p), sizes


def launch(p: RescoreParams, dsqs, xffs) -> Pending:
    """The fills of the envelopes <dsqs> (residue codes) under their
    length models <xffs> ([n, 8] f32), in one launch on <p>'s device
    (``launch.launches`` counts those on a card)."""
    lens = _check(p, dsqs, xffs)
    if p.device.type != "cuda":
        return rescore_plain(p, dsqs, xffs, lens)
    run, _ = prepare(p, dsqs, xffs, lens)
    out, status = run()
    launch.launches += 1
    host = torch.empty(out.shape, dtype=torch.float32, pin_memory=True)
    st = torch.empty(status.shape, dtype=torch.int32, pin_memory=True)
    with torch.cuda.device(p.device):
        host.copy_(out, non_blocking=True)
        st.copy_(status, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
    return Pending(lens, p.M, host, st, event)


launch.launches = 0         # CUDA launches through this wrapper


def rescore(p: RescoreParams, dsqs, xffs,
            budget: int = RESCORE_BYTES) -> list:
    """``Fills`` of every envelope, in order, through ``batch_plan``'s
    launches (each read back before the next starts)."""
    lens = [len(d) for d in dsqs]
    xffs = np.asarray(xffs, F32).reshape(len(dsqs), 8)
    out = []
    for idx in batch_plan(lens, p.M, budget):
        out += launch(p, [dsqs[i] for i in idx], xffs[idx]).fills()
    return out


# ---------------------------------------------------------------------
# the plain version: the host's fills, envelope by envelope
# ---------------------------------------------------------------------
def rescore_plain(p: RescoreParams, dsqs, xffs, lens=None) -> Pending:
    """The host fills of every envelope (``domaindef.envelope_fills``
    and ``fwdback.optimal_accuracy``, under <p>'s profile given each
    envelope's length model) copied into the kernel's layout; a failed
    fill gives its ``STATUS`` and leaves its region zero."""
    from ..domaindef import envelope_fills
    from .reference.fwdback import RangeError, optimal_accuracy
    if lens is None:
        lens = np.array([len(d) for d in dsqs], np.int64)
    om, M, W = p.om, p.M, p.M + 1
    sizes = [region_floats(int(L), M) for L in lens]
    host = np.zeros(int(sum(sizes)), F32)
    status = np.zeros(len(lens), np.int32)
    o = 0
    for e, (d, xff) in enumerate(zip(dsqs, np.asarray(xffs, F32))):
        L = int(lens[e])
        reg = host[o:o + sizes[e]]
        o += sizes[e]
        for (s, c), v in zip(XFF, xff):
            om.xf[s, c] = v
        try:
            oxf, _, oxb, pp = envelope_fills(om, np.asarray(d))
        except RangeError as err:
            status[e] = STATUS[str(err)]
            continue
        ox, _ = optimal_accuracy(om, pp)
        n = (L + 1) * W
        for q, a in enumerate((pp.mm, pp.im, ox.mm, ox.im, ox.dm)):
            reg[q * n:(q + 1) * n] = np.asarray(a, F32).ravel()
        mats = {"f": oxf, "b": oxb, "p": pp, "o": ox}
        for r, name in enumerate(SPEC):
            reg[NMAT * n + r * (L + 1):NMAT * n + (r + 1) * (L + 1)] = \
                getattr(mats[name[0]], name[1:])
    return Pending(lens, M, host, status)
