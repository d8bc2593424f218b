"""Multi-model device stages: the four f32 stages of the multi-query
drive and the two integer filters of the device calibration, with a
model slot per item.

Counterpart of ``bath_tpu/ops/jaxk/multimodel.py`` (``build_fwd_pack``/
``fwd_pack_scores``, ``build_domdec_pack``/``domdec_pack_batch``,
``build_fs3_pack``/``fs3_pack_scores``, ``build_fs3_domdec_pack``/
``fs3_domdec_pack_batch``).  What each computes is: item b scored (or
decoded) under model ``slot[b]``.  The JAX kernels get there by packing
G models side by side on the lane axis in blocks of Mg lanes, with a
block-diagonal emission table and stacked ``[G, Mg, Mg]`` closure
operators; none of that is carried over.  Here a pack is the list of
the models' own ``ProfileTensors`` and, for the CUDA kernels, their
zero-padded tables stacked per padded width Mp (``ModelPack.classes``).
There is no limit on the item length or on the number of models, and no
batch ladder.

One launch plan.  Every kernel takes every padded width of a call in
one launch (``fwd_plan``, ``domdec_plan``, ``fs3_plan``, ``msv_plan``,
``vit_plan``, on ``_plan``): each block row names its class (P, W, Mp
and where the class's stacks lie), its model and its items, the kernel
runs that class's P, and the blocks go out heaviest first, so a call
takes about the time of its longest chain rather than the sum over its
widths; the two decoders give each item two, one for its Forward and
one for its Backward, which run at the same time.  A block holds items
of one model only and shares one copy of that model's tables.  A
single-model call of the Forward gate or MSV takes a plan of its one
class and no block rows (``single_plan``): its blocks take the items in
batch order, so the host builds no per-item table.

Each packed call launches its kernel's one C entry
(``ops/kernels/csrc/{fwd_parser,domdec,fs3_parser,fs3_domdec}.cu``, the
entry and ``__global__`` kernel of the single-model calls too, so the
same arithmetic item for item) for CUDA tensors, and runs its plain
PyTorch version (``*_ref``: the single-model plain version over each
model's items) for CPU tensors.

The integer filters with a model axis (``build_msv_pack``/
``msv_ssv_multi``, ``build_vit_pack``/``vit_ints_multi``) are the
counterpart of ``bath_tpu/evalues_device.py`` ``_dyn_kernels``: the
[model, batch] MSV and ViterbiFilter kernels vmapped over models with
each model's quantisation scalars as traced values.  Here they are the
entries of ``csrc/msv_filter.cu`` and ``csrc/vit_filter.cu``
(``msv_plan``, ``vit_plan``), the models' scalars in a small int array
beside the stacked tables (``IntPack``).  Items travel as in
``ops/ssv.py``, one int8 stream read at per-item offsets, so the models
of a calibration share one copy of the simulated batch: offsets
repeat.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch

from .domdec import domdec_params_from_jax, domdec_ref, finish_passes
from .fs3 import fs3_params_from_jax, fs3_score_ref
from .fs3_domdec import finish as fs3_domdec_finish
from .fs3_domdec import fs3_domdec_ref
from .fwd import check_batch, fwd_params_from_jax, fwd_score_ref
from .ssv import MSVParams, check_stream, msv_ssv_ref
from .vit import NEG, R_DDS, R_MDS, VitParams, vit_ints_ref


@dataclass
class SizeClass:
    """The models of one padded width Mp, stacked for one launch."""
    P: int                      # lanes per thread
    W: int                      # warps per item
    Mp: int
    models: list                # pack slots, in stack order
    etab: torch.Tensor          # [g, Kp, Mp] emission odds
    ttab: torch.Tensor          # [g, 8, Mp] transition rows
    Ms: torch.Tensor            # [g] int32 model lengths


class ModelPack:
    """G models for the multi-model kernels: ``params[g]`` is the
    ``ProfileTensors`` of slot g (``ops.fwd.fwd_params`` for the Forward
    gate and domain decoding, ``ops.fs3.fs3_params`` for the fs3 pair).
    <layout> maps a model length to (P, W, Mp), the kernels' own
    (``loader.layout`` or ``loader.fs3_layout``)."""

    def __init__(self, params: list, layout):
        if not params:
            raise ValueError("a pack needs at least one model")
        self.layout = layout
        self._relaid: dict = {}
        self.params = list(params)
        self.device = params[0].device
        self.Kp = params[0].Kp
        for p in params:
            if p.device != self.device or p.Kp != self.Kp:
                raise ValueError("the models of a pack share a device and "
                                 "an alphabet")
        self.M = [p.M for p in params]
        self.geometry = [layout(M) for M in self.M]

    def __len__(self) -> int:
        return len(self.params)

    @functools.cached_property
    def classes(self) -> dict:
        """{Mp: SizeClass}: the padded tables stacked per width, built
        on first use (the plain versions never read them)."""
        by_mp: dict = {}
        for g, (_, _, Mp) in enumerate(self.geometry):
            by_mp.setdefault(Mp, []).append(g)
        return {Mp: self._stack(*self.geometry[models[0]][:2], Mp, models)
                for Mp, models in sorted(by_mp.items())}

    def _stack(self, P: int, W: int, Mp: int, models: list):
        tabs = [self.params[g].padded(Mp) for g in models]
        return SizeClass(
            P, W, Mp, models,
            torch.stack([e for e, _ in tabs]).contiguous(),
            torch.stack([t for _, t in tabs]).contiguous(),
            torch.tensor([self.M[g] for g in models], dtype=torch.int32,
                         device=self.device))

    def with_layout(self, layout) -> "ModelPack":
        """These models under another (P, W, Mp) ladder, with stacks of
        their own, made once a ladder (the Forward gate's
        ``loader.fwd_layout`` on decoding's pack, a launch's beside a
        segmented class: ``_beside_segmented``); itself for its own."""
        if layout is self.layout:
            return self
        if layout not in self._relaid:
            self._relaid[layout] = self._relay(layout)
        return self._relaid[layout]

    def _relay(self, layout) -> "ModelPack":
        return ModelPack(self.params, layout)

    @functools.cached_property
    def slot_class(self) -> tuple[np.ndarray, np.ndarray]:
        """([G] Mp of each slot, [G] its index in that class's stack)."""
        mp = np.array([g[2] for g in self.geometry], np.int64)
        local = np.zeros(len(self), np.int64)
        for c in self.classes.values():
            local[c.models] = np.arange(len(c.models))
        return mp, local


@dataclass
class IntClass:
    """The models of one padded width Mp of an integer filter, stacked
    for one launch."""
    P: int
    W: int
    Mp: int
    models: list
    tab: torch.Tensor           # [g, rows, Mp] int16 kernel tables
                                # (``kernel_table``)
    scal: torch.Tensor          # [g, k] int32: M, then the pack's scalars
    glob: torch.Tensor = None   # the ViterbiFilter's tables in its kernel's
                                # layout, for a class read from global
                                # memory (``vit_global_tables``)


class IntPack(ModelPack):
    """G models for a multi-model integer filter: ``params[g]`` is the
    ``MSVParams`` or ``VitParams`` of slot g, <scalars> the names of the
    per-model scalar bytes or words the kernel reads beside M, <layout>
    the kernel's (P, W, Mp) of a model length."""

    def __init__(self, params: list, scalars: tuple, layout):
        super().__init__(params, layout)
        self.scalars = tuple(scalars)

    def _relay(self, layout) -> "IntPack":
        return IntPack(self.params, self.scalars, layout)

    def _stack(self, P: int, W: int, Mp: int, models: list):
        return IntClass(
            P, W, Mp, models,
            torch.stack([self.params[g].kernel_table(Mp, P) for g in models])
            .contiguous(),
            torch.tensor([[getattr(self.params[g], k)
                           for k in ("M",) + self.scalars] for g in models],
                         dtype=torch.int32, device=self.device))

    def per_item(self, slot) -> SimpleNamespace:
        """Each scalar as a [B] int64 tensor, item b's from model
        ``slot[b]`` (what ``ops.ssv.msv_post`` takes for <p>)."""
        slot = torch.as_tensor(np.asarray(slot, np.int64), device=self.device)
        return SimpleNamespace(**{
            k: torch.tensor([getattr(p, k) for p in self.params],
                            dtype=torch.int64, device=self.device)[slot]
            for k in self.scalars})


# ---------------------------------------------------------------------
# One launch for every padded width (csrc/plan.cuh): the plans of every
# kernel
# ---------------------------------------------------------------------
PLAN_CLS, PLAN_BLK = 10, 5  # int64 words of a class row and a block row
SMEM_BYTES = 232448         # shared memory a block may take on the H100
FS3_ROWS = 338              # packed codon rows of a model's odds
FS3_RING = 2                # emission-row ring slots a group
FS3_RING_WARPS = 8          # a ring block's warps at most: the ring
                            # instances take up to 255 registers a thread
FS3_DIRECT_P = 5            # a launch of classes of at most this many
                            # lanes a thread takes the direct loads
                            # (PERF.md, the fs3 loads' sweep)


def fs3_group_bytes(Mp: int, W: int, direct: bool = False) -> int:
    """Shared bytes a group of W warps takes past its block's transition
    table (``csrc/fs3_common.cuh`` ``fs3_group_bytes``), 128-byte
    aligned: its emission ring (FS3_RING slots of three codon rows of
    Mp floats), the slots' mbarriers and the W > 1 exchange scratch;
    with the direct loads, the scratch alone."""
    ring = 0 if direct else 12 * FS3_RING * Mp + -(-8 * FS3_RING // 16) * 16
    return -(-(ring + 32 * W) // 128) * 128


def fs3_block_warps(Ws) -> int:
    """Warps of every block of a launch whose classes take W warps a
    group: at least four, and six when the widest class takes three, so
    that groups of 1, 2 and 3 warps fill a block."""
    w = max(Ws)
    return 4 if w <= 2 else 6 if w == 3 else w


def dd_block_warps(Ws) -> int:
    """Warps of every block of a Forward-gate or decoding launch: eight,
    six when the widest class takes three warps a group, else the widest
    W (at most a block's 32: a longer model is segmented)."""
    w = max(Ws)
    return 8 if 8 % w == 0 else 6 if w == 3 else w


# where a block of a Forward-gate or decoding class keeps its model's f32
# tables (csrc/dp_common.cuh Stage): neither, both, the transitions only
STAGE_NONE, STAGE_ALL, STAGE_TRANS = 0, 1, 2
# the Forward gate's class whose tables do not fit a block: its
# transitions staged, its odds read from L2 (PERF.md, the wide-layout sweep)
FWD_WIDE_STAGE = STAGE_TRANS


def dd_table_bytes(Kp: int, Mp: int) -> int:
    """A gate or decoding model's f32 tables (``csrc/dp_common.cuh``)."""
    return (Kp + 8) * Mp * 4


def staged_bytes(Kp: int, Mp: int, stage: int) -> int:
    """Shared bytes of a block's staged f32 tables (``csrc/dp_common.cuh``
    ``staged_bytes``)."""
    return {STAGE_NONE: 0, STAGE_ALL: dd_table_bytes(Kp, Mp),
            STAGE_TRANS: 8 * Mp * 4}[stage]


DD_GROUP_BYTES = 32         # a gate or decoding group's exchange scratch
                            # a warp


def f32_class_row(c, G: int, Kp: int, wide: int) -> list:
    """The class row of the Forward gate and decoding (``csrc/
    dp_common.cuh``): the stacks' addresses, P, W, Mp, G, Kp and where a
    block keeps its tables: both in shared memory where they fit, else
    <wide> (STAGE_TRANS or STAGE_NONE; STAGE_NONE where even the
    transitions do not fit).  Groups of several warps take at most 15
    a block (one named barrier each)."""
    if c.W > 1:
        G = min(G, 15)
    scratch = G * DD_GROUP_BYTES * c.W
    stage = next(st for st in (STAGE_ALL, wide, STAGE_NONE)
                 if staged_bytes(Kp, c.Mp, st) + scratch <= SMEM_BYTES)
    return [c.etab.data_ptr(), c.ttab.data_ptr(), c.P, c.W, c.Mp, G, Kp,
            stage]


def vit_block_warps(Ps, Ws=(), Ss=()) -> int:
    """Warps of every block of a ViterbiFilter launch: fixed by the
    kernel's instance, the largest P of the launch (``csrc/
    vit_filter.cu`` ``vit_warps``), or 16 (the instance of the
    segmented group) for a launch with a segmented class or a group of
    more warps than that instance's blocks (a model of 13-16 warps of 17
    lanes beside one of a warp of 33)."""
    p = max(Ps)
    warps = 8 if p <= 13 else 16 if p <= 17 else 12
    if max(Ss, default=1) > 1 or max(Ws, default=0) > warps:
        return 16
    return warps


def vit_smem_bytes(Kp: int, Mp: int, G: int, W: int) -> int:
    """Shared bytes of a ViterbiFilter block (``csrc/vit_filter.cu``
    ``vit_smem_bytes``): the model's int16 table (the transitions as
    pairs in one int) 16-byte aligned, and each group's scratch."""
    return vit_table_bytes(Kp, Mp) + 16 * G * W


def vit_table_bytes(Kp: int, Mp: int) -> int:
    return -(-(16 * Mp + 2 * Kp * Mp) // 16) * 16


def msv_block_warps(Ps, Ws, Ss=()) -> int:
    """Warps of every block of an MSV launch: fixed by the kernel's
    instance (``csrc/msv_filter.cu`` ``msv_warps``): eight up to 13
    lanes a thread, else twelve, or 32 for a model of more than twelve
    warps an ORF; with a segmented class (S > 1), the segmented group's
    16 (no class beside it takes more: ``_beside_segmented``)."""
    if max(Ss, default=1) > 1:
        return 16
    return 8 if max(Ps) <= 13 else 12 if max(Ws) <= 12 else 32


def warp_lanes(Mp: int, P: int) -> np.ndarray:
    """[Mp] the model lane at each position of a warp-transposed table
    row (``csrc/int_common.cuh`` ``lane_at``): a warp's 32P lanes as P
    rows of 32, so that thread t's lane j lies at 32j + t."""
    x = np.arange(Mp)
    span = 32 * P
    r = x % span
    return x - r + (r & 31) * P + (r >> 5)


def vit_global_tables(c, Kp: int) -> torch.Tensor:
    """The ViterbiFilter class <c>'s tables in the layout its kernel
    stages (``csrc/vit_filter.cu``): per model vit_table_bytes, the four
    transition pairs [4][Mp] int32 (the even row in the low half), then
    the match words [Kp][Mp] int16, each row warp-transposed; built once
    a class, for a class whose blocks read them from global memory."""
    if c.glob is None:
        perm = torch.from_numpy(warp_lanes(c.Mp, c.P)).to(c.tab.device)
        t = c.tab[:, :, perm]
        u = t[:, Kp:].to(torch.int64) & 0xFFFF
        pairs = u[:, 0::2] | (u[:, 1::2] << 16)
        pairs = torch.where(pairs >= 1 << 31, pairs - (1 << 32), pairs)
        g = len(c.models)
        out = torch.zeros(g, vit_table_bytes(Kp, c.Mp), dtype=torch.uint8,
                          device=c.tab.device)
        n = 16 * c.Mp
        out[:, :n] = pairs.to(torch.int32).contiguous().view(torch.uint8) \
            .reshape(g, n)
        out[:, n:n + 2 * Kp * c.Mp] = t[:, :Kp].contiguous() \
            .view(torch.uint8).reshape(g, -1)
        c.glob = out
    return c.glob


@dataclass
class LaunchPlan:
    """One launch of a kernel that takes every padded width of a call
    (``csrc/plan.cuh``): ``table`` holds ``ncls`` class rows (the
    addresses of the class's stacked tables, P, W, Mp, G groups a block,
    two words of the kernel's own, the segments S a group walks a row
    in and the address of a segmented class's scratch), ``nblk`` block
    rows (class, model in the class's stacks, M, first item, count),
    then the items (rows b, or passes * b + pass).  ``warps``: a
    block's.  ``classes``: (P, W, Mp, G, longest item) of each class.
    ``scratch``: (class, its blocks, or None for a single-model plan) of
    each segmented class, whose scratch the loader sizes and allocates
    (``loader._planned``)."""
    table: np.ndarray
    ncls: int
    nblk: int
    warps: int
    classes: list
    scratch: list = ()          # (class, blocks) of each segmented class
    buffers: list = ()          # its scratch on the device (the loader's)

    @property
    def blocks(self) -> np.ndarray:
        at = PLAN_CLS * self.ncls
        return self.table[at:at + PLAN_BLK * self.nblk].reshape(-1, PLAN_BLK)

    @property
    def items(self) -> np.ndarray:
        return self.table[PLAN_CLS * self.ncls + PLAN_BLK * self.nblk:]


class OneModel:
    """One model as a plan reads a pack (``M``, ``Kp``, ``slot_class``,
    ``classes``), on its own padded tables: no stacked copy.  <layout>:
    the kernels' (P, W, Mp) of a model length, the fs3 pair's
    (``loader.fs3_layout``) unless given (decoding: ``loader.layout``)."""

    def __init__(self, p, layout=None):
        from .kernels import loader
        P, W, Mp = (layout or loader.fs3_layout)(p.M)
        etab, ttab = p.padded(Mp)
        self.device = p.device
        self.M = [p.M]
        self.Kp = p.Kp
        self.slot_class = (np.array([Mp]), np.array([0]))
        self.classes = {Mp: SimpleNamespace(P=P, W=W, Mp=Mp, models=[0],
                                            etab=etab, ttab=ttab)}


def _beside_segmented(pack, slot, lanes):
    """<pack> as a launch of the models ``slot`` names takes it: where
    one of them is segmented, on a ladder that segments any model past
    the segmented group's SEG_WARPS warps too, on <lanes>
    (``loader.segmented_beside``): the segmented instance's blocks hold
    no wider group."""
    from .kernels import loader
    if not isinstance(pack, ModelPack) or not len(slot):
        return pack
    geo = [pack.geometry[g] for g in np.unique(slot)]
    if all(loader.segments(*x) == 1 for x in geo) or \
            all(x[1] <= loader.SEG_WARPS for x in geo):
        return pack
    return pack.with_layout(loader.segmented_beside(pack.layout, lanes))


def _plan(lens, slot, pack, passes: int, warps_of, class_row,
          by_cells: bool = False, sms: int = 0) -> LaunchPlan:
    """The plan of one launch over a batch whose item b (length
    ``lens[b]``) belongs to model ``slot[b]`` of <pack>; <passes> items
    an entry of the batch.  ``warps_of(classes)`` gives a block's warps,
    ``class_row(class, warps)`` a class's first eight words, G at word
    5; word 8 is the class's segments S (``loader.segments``) and word 9
    the address of its scratch, which the loader fills (``_planned``).
    Each model's items go longest first (ties by row) into blocks of G;
    the blocks of all classes go heaviest first: segmented classes
    first, then by their longest item, or with <by_cells> by Mp x their
    longest item (ties: wider class, model, position), so the plan's
    order does not depend on the batch's.  With <sms> (the card's SMs),
    a batch of fewer items than four an SM gets blocks of at most
    ceil(items / sms) groups, so that its groups spread over the card,
    each warp with a scheduler to itself.  Each segmented class's blocks
    are counted in ``LaunchPlan.scratch``."""
    lens = np.asarray(lens, np.int64)
    slot = np.asarray(slot, np.int64)
    if not len(slot):
        return LaunchPlan(np.zeros(0, np.int64), 0, 0, 1, [])
    mp_of, local_of = pack.slot_class
    present = np.array([Mp for Mp in pack.classes
                        if (mp_of[slot] == Mp).any()], np.int64)
    cls = [pack.classes[Mp] for Mp in present]
    warps = warps_of(cls)
    rows_cls = [list(class_row(c, warps))
                + [c.Mp // (32 * c.P * c.W), 0] for c in cls]
    for r in rows_cls:
        if r[8] > 1:            # a segmented group is a block's only one
            r[5] = 1
    if sms and passes * len(slot) < 4 * sms:
        cap = -(-passes * len(slot) // sms)
        for r in rows_cls:
            r[5] = min(r[5], cap)
        warps = max(r[5] * c.W for r, c in zip(rows_cls, cls))
    Gs = [r[5] for r in rows_cls]
    classes = [(c.P, c.W, c.Mp, G, int(lens[mp_of[slot] == c.Mp].max()))
               for c, G in zip(cls, Gs)]
    if slot.min() == slot.max():
        return _one_model_plan(lens, int(slot[0]), pack, passes, rows_cls[0],
                               warps, classes)
    Mtab = [[pack.M[g] for g in c.models] for c in cls]
    # the items, grouped by class and model, each model's longest first
    b = np.repeat(np.arange(len(slot)), passes)
    pas = np.tile(np.arange(passes), len(slot))
    ci = np.searchsorted(present, mp_of[slot])[b]
    m = local_of[slot][b]
    ln = lens[b]
    order = np.lexsort((pas, b, -ln, m, ci))
    ci, m, ln = ci[order], m[order], ln[order]
    item = (b * passes + pas)[order]
    # each run of one model cut into blocks of its class's G
    run = np.r_[True, (ci[1:] != ci[:-1]) | (m[1:] != m[:-1])]
    q = np.arange(len(item)) - np.nonzero(run)[0][np.cumsum(run) - 1]
    starts = np.nonzero(q % np.asarray(Gs)[ci] == 0)[0]
    count = np.diff(np.r_[starts, len(item)])
    bc, bm = ci[starts], m[starts]
    weight = ln[starts] * (present[bc] if by_cells else 1)
    seg = np.asarray([r[8] > 1 for r in rows_cls])[bc]
    by = np.lexsort((q[starts], bm, -present[bc], -weight, ~seg))
    first = np.cumsum(count[by]) - count[by]
    at = np.repeat(starts[by] - first, count[by]) + np.arange(len(item))
    off = np.cumsum([0] + [len(t) for t in Mtab])
    Ms = np.asarray(sum(Mtab, []))[off[bc[by]] + bm[by]]
    brows = np.stack([bc[by], bm[by], Ms, first, count[by]], 1)
    table = np.concatenate([np.asarray(rows_cls, np.int64).reshape(-1),
                            brows.reshape(-1), item[at]]).astype(np.int64)
    scratch = [(c, int((brows[:, 0] == c).sum()))
               for c, row in enumerate(rows_cls) if row[8] > 1]
    return LaunchPlan(table, len(rows_cls), len(brows), warps, classes,
                      scratch)


def _one_model_plan(lens, g, pack, passes: int, row: list, warps: int,
                    classes: list) -> LaunchPlan:
    """_plan's plan of a batch whose items all belong to model <g> (of
    class row <row>): the same table, the items longest first (ties by
    row) in blocks of G, which is heaviest first, without the sorts
    over classes and models (a single-model call's plan, made at every
    call from the host lengths)."""
    order = np.argsort(-lens, kind="stable")
    item = (order[:, None] * passes + np.arange(passes)).reshape(-1)
    first = np.arange(0, len(item), row[5])
    count = np.diff(np.r_[first, len(item)])
    brows = np.stack([np.zeros_like(first),
                      np.full_like(first, pack.slot_class[1][g]),
                      np.full_like(first, pack.M[g]), first, count], 1)
    table = np.concatenate([np.asarray(row, np.int64), brows.reshape(-1),
                            item]).astype(np.int64)
    scratch = [(0, len(brows))] if row[8] > 1 else []
    return LaunchPlan(table, 1, len(brows), warps, classes, scratch)


def single_plan(pack, warps_of, class_row) -> LaunchPlan:
    """The plan of a single-model call of the Forward gate, MSV or the
    SSV capture: the one class of <pack> (a ``OneModel`` or a pack of one
    model) and no block rows, so that the host builds no per-item table:
    the gate's and MSV's blocks take the items in batch order (a
    segmented model takes a per-item plan there), the SSV capture's in
    an order sorted on the card (``ssv_order``; a segmented model's
    scratch then has a slot for each block the card holds at once)."""
    (c,) = pack.classes.values()
    warps = warps_of([c])
    row = list(class_row(c, warps)) + [c.Mp // (32 * c.P * c.W), 0]
    return LaunchPlan(np.asarray(row, np.int64), 1, 0, warps,
                      [(c.P, c.W, c.Mp, row[5], None)],
                      [(0, None)] if row[8] > 1 else [])


def fs3_plan(lens, slot, pack, passes: int) -> LaunchPlan:
    """The plan of one fs3 launch (``csrc/fs3_common.cuh``) over a batch
    whose window b belongs to model ``slot[b]`` of <pack> (a
    ``ModelPack`` of ``build_fs3_pack`` or a ``OneModel``); <passes>
    items a window (1 the gate, 2 decoding: the Forward, then the
    Backward).  A block holds the most groups of W warps that fit its
    warps and shared memory; blocks go longest window first.  A class
    of more than FS3_RING_WARPS warps a window (past M = 3328) takes the
    direct loads (the codon rows read from global memory by every
    thread, class row word 6) in a kernel instance whose registers are
    capped, and one whose group's emission ring does not fit a block
    either (past M = 3744) leaves its transitions in global memory too
    (word 7).  A launch whose classes all take at most FS3_DIRECT_P
    lanes a thread takes the direct loads too: the ring's handshake
    costs more there than the loads it hides.  The kernel runs one load
    path a launch, so a launch with one class on the direct loads has
    every class on them (word 6).  A model past 32 warps of 13 lanes is
    segmented (the direct loads, its transitions in global memory), and
    so, in a launch with it, is a model past 16 warps
    (``_beside_segmented``)."""

    def class_row(c, warps):
        if c.etab.shape[-2] != FS3_ROWS:
            raise ValueError(f"fs3 tables have {FS3_ROWS} codon rows, got "
                             f"{c.etab.shape[-2]}")
        G = min(warps // c.W, (SMEM_BYTES - 32 * c.Mp)
                // fs3_group_bytes(c.Mp, c.W))
        if c.W > 1:
            G = min(G, 15)
        if G >= 1 and c.W <= FS3_RING_WARPS:
            return [c.etab.data_ptr(), c.ttab.data_ptr(), c.P, c.W, c.Mp, G,
                    0, 0]
        return [c.etab.data_ptr(), c.ttab.data_ptr(), c.P, c.W, c.Mp,
                min(warps // c.W, 15), 1, int(G < 1)]

    from .kernels.loader import FS3_SEG_LANES
    plan = _plan(lens, slot, _beside_segmented(pack, slot, FS3_SEG_LANES),
                 passes, lambda cls: fs3_block_warps([c.W for c in cls]),
                 class_row)
    rows = plan.table[:PLAN_CLS * plan.ncls].reshape(-1, PLAN_CLS)
    narrow = rows[:, 2].max(initial=0) <= FS3_DIRECT_P
    if plan.ncls and (rows[:, 6].any() or narrow):
        rows[:, 6] = 1
    return plan


def domdec_plan(lens, slot, pack, sms: int = 0) -> LaunchPlan:
    """The plan of one decoding launch (``csrc/domdec.cu``) over a batch
    whose ORF b belongs to model ``slot[b]`` of <pack> (a ``ModelPack``
    of ``build_domdec_pack`` or a ``OneModel``): two items an ORF, its
    Forward and its Backward, blocks longest ORF first, a small batch
    spread over <sms> SMs.  A block stages its model's tables in shared
    memory where they fit (the class row's last word), else neither."""
    from .kernels.loader import SEG_LANES
    return _plan(lens, slot, _beside_segmented(pack, slot, SEG_LANES), 2,
                 lambda cls: dd_block_warps([c.W for c in cls]),
                 lambda c, warps: f32_class_row(c, warps // c.W, pack.Kp,
                                                STAGE_NONE),
                 sms=sms)


def fwd_plan(lens, slot, pack, sms: int = 0) -> LaunchPlan:
    """The plan of one Forward-gate launch (``csrc/fwd_parser.cu``) over
    a batch whose ORF b belongs to model ``slot[b]`` of <pack> (a
    ``ModelPack`` of ``build_fwd_pack``): decoding's plan with one item
    an ORF, blocks heaviest first (Mp x longest ORF), a small batch
    spread over <sms> SMs.  A block stages its model's tables in shared
    memory where they fit, else FWD_WIDE_STAGE; lens None gives a
    single-model call's plan (``single_plan``)."""

    def warps_of(cls):
        return dd_block_warps([c.W for c in cls])

    def class_row(c, warps):
        return f32_class_row(c, warps // c.W, pack.Kp, FWD_WIDE_STAGE)

    if lens is None:
        return single_plan(pack, warps_of, class_row)
    from .kernels.loader import SEG_LANES
    return _plan(lens, slot, _beside_segmented(pack, slot, SEG_LANES), 1,
                 warps_of, class_row, by_cells=True, sms=sms)


def msv_plan(lens, slot, pack, sms: int = 0) -> LaunchPlan:
    """The plan of one MSV launch (``csrc/msv_filter.cu``) over a stream
    whose item b belongs to model ``slot[b]`` of <pack> (an ``IntPack``
    of ``build_msv_pack``): blocks heaviest first (Mp x longest item), a
    small batch spread over <sms> SMs.  A block stages its model's int16
    table in shared memory where it fits (the class row's word 7), else
    reads it from global memory; lens None gives a single-model call's
    plan (``single_plan``), which the SSV capture takes too
    (``ssv_plan``)."""

    def warps_of(cls):
        return msv_block_warps([c.P for c in cls], [c.W for c in cls],
                               [c.Mp // (32 * c.P * c.W) for c in cls])

    def class_row(c, warps):
        G = warps // c.W if c.W == 1 else min(warps // c.W, 15)
        fits = 2 * pack.Kp * c.Mp + 16 * G * c.W <= SMEM_BYTES
        return [c.tab.data_ptr(), c.scal.data_ptr(), c.P, c.W, c.Mp, G,
                pack.Kp, int(fits)]

    if lens is None:
        return single_plan(pack, warps_of, class_row)
    from .kernels.loader import SEG_LANES
    return _plan(lens, slot, _beside_segmented(pack, slot, SEG_LANES), 1,
                 warps_of, class_row, by_cells=True, sms=sms)


def ssv_plan(pack) -> LaunchPlan:
    """The plan of an SSV capture launch (``csrc/ssv_capture.cu``) under
    the one model of <pack>, its MSV pack (``MSVParams.as_pack``): MSV's
    class row alone, made once a parameter set.  The ORFs go longest
    first (``ssv_order``, sorted on the card), dealt round the blocks
    (``ssv_blocks``)."""
    return msv_plan(None, None, pack)


def ssv_order(lens: torch.Tensor) -> torch.Tensor:
    """The ORFs longest first, ties by row: what the SSV capture's
    blocks take, one sort on the lengths' device (no read-back)."""
    return torch.argsort(lens, descending=True, stable=True)


def ssv_blocks(B: int, G: int, sms: int = 0) -> tuple[int, int]:
    """(groups a block, blocks) of an SSV capture launch over B ORFs:
    the class row's G, or for fewer ORFs than four an SM, ceil(B / sms)
    so that they spread over the card.  Block k's group g takes the ORF
    of rank g * blocks + k: the ranks dealt round the blocks, so that
    each of the longest ORFs starts on a block and an SM of its own,
    where the shorter ORFs beside it end early; block k's first ORF is
    the k-th longest, so the blocks go heaviest first (PERF.md, the J6
    sweep)."""
    if sms and B < 4 * sms:
        G = min(G, -(-B // sms))
    return G, -(-B // G)


def vit_plan(lens, slot, pack, sms: int = 0) -> LaunchPlan:
    """The plan of one ViterbiFilter launch (``csrc/vit_filter.cu``) over
    a stream whose item b belongs to model ``slot[b]`` of <pack> (an
    ``IntPack`` of ``build_vit_pack``): blocks heaviest first (Mp x
    longest item), a small batch spread over <sms> SMs.  A block holds
    its model's int16 table in shared memory where it fits; a class
    whose table does not (past M = 2720) reads a copy in the kernel's
    layout from global memory (``vit_global_tables``; the class row's
    word 7 holds its address).  A model past 16 warps of 17 lanes takes
    the segmented group of 16 warps (``loader.vit_layout``)."""

    def class_row(c, warps):
        G = warps // c.W if c.W == 1 else min(warps // c.W, 15)
        glob = 0
        if vit_smem_bytes(pack.Kp, c.Mp, G, c.W) > SMEM_BYTES:
            glob = vit_global_tables(c, pack.Kp).data_ptr()
        return [c.tab.data_ptr(), c.scal.data_ptr(), c.P, c.W, c.Mp, G,
                pack.Kp, glob]

    return _plan(lens, slot, pack, 1,
                 lambda cls: vit_block_warps(
                     [c.P for c in cls], [c.W for c in cls],
                     [c.Mp // (32 * c.P * c.W) for c in cls]), class_row,
                 by_cells=True, sms=sms)


def _check(pack: ModelPack, dsq, lens, slot) -> np.ndarray:
    """The packed calls' input check; returns the slots as numpy."""
    check_batch(dsq, lens, pack.params[0])
    slot = np.asarray(slot.cpu() if isinstance(slot, torch.Tensor)
                      else slot).astype(np.int64)
    if slot.shape != (dsq.shape[0],):
        raise ValueError(f"slot must be [B], got {slot.shape}")
    if slot.size and (slot.min() < 0 or slot.max() >= len(pack)):
        raise ValueError(f"model slots must lie in [0, {len(pack)})")
    return slot


def _check_stream_slots(pack: IntPack, flat, offs, lens, per_item,
                        slot) -> np.ndarray:
    """The integer packed calls' input check; returns the slots as
    numpy."""
    check_stream(flat, offs, lens, per_item)
    if flat.device != pack.device:
        raise ValueError(f"pack on {pack.device}, input on {flat.device}")
    slot = np.asarray(slot.cpu() if isinstance(slot, torch.Tensor)
                      else slot).astype(np.int64)
    if slot.shape != (lens.shape[0],):
        raise ValueError(f"slot must be [B], got {slot.shape}")
    if slot.size and (slot.min() < 0 or slot.max() >= len(pack)):
        raise ValueError(f"model slots must lie in [0, {len(pack)})")
    return slot


def _per_model(slot: np.ndarray):
    """[(model, rows of its items)] of a batch."""
    return [(int(g), np.nonzero(slot == g)[0]) for g in np.unique(slot)]


# ---------------------------------------------------------------------
# The four packs
# ---------------------------------------------------------------------
def build_fwd_pack(params: list) -> ModelPack:
    """<params>: ``ops.fwd.fwd_params`` of each model, slot order.  The
    pack's own ladder is decoding's (``loader.layout``); the Forward
    gate takes it under ``loader.fwd_layout`` (``with_layout``)."""
    from .kernels.loader import layout
    return ModelPack(params, layout)


def build_domdec_pack(params: list) -> ModelPack:
    """Decoding reads the gate's tensors (``ops.domdec.domdec_params``),
    so the pack is the gate's."""
    return build_fwd_pack(params)


def build_fs3_pack(params: list) -> ModelPack:
    """<params>: ``ops.fs3.fs3_params`` of each model, slot order."""
    from .kernels.loader import fs3_layout
    return ModelPack(params, fs3_layout)


def build_fs3_domdec_pack(params: list) -> ModelPack:
    """fs3 decoding reads the fs3 gate's tensors, so the pack is the
    gate's."""
    return build_fs3_pack(params)


MSV_SCALARS = ("base", "tec", "tbm", "bias")
VIT_SCALARS = ("base", "emove", "eloop")


def build_msv_pack(params: list) -> IntPack:
    """<params>: ``ops.ssv.msv_params`` of each model, slot order."""
    from .kernels.loader import msv_layout
    return IntPack(params, MSV_SCALARS, msv_layout)


def build_vit_pack(params: list) -> IntPack:
    """<params>: ``ops.vit.vit_params`` of each model, slot order."""
    from .kernels.loader import vit_layout
    return IntPack(params, VIT_SCALARS, vit_layout)


# ---------------------------------------------------------------------
# Packs from the JAX package's packs (numpy arrays), for the tests
# ---------------------------------------------------------------------
def _slot_view(arrays: dict, g: int, Mg: int, names) -> dict:
    return {k: np.asarray(arrays[k])[g * Mg:(g + 1) * Mg] for k in names}


def _backward_view(arrays: dict, g: int, Mg: int) -> dict:
    v = _slot_view(arrays, g, Mg, ("tDM_next", "vMD"))
    v["UB"] = np.asarray(arrays["UB"])[g]
    return v


def _models_of(arrays: dict, G: int, Mg: int) -> list:
    """(slot, M) of the filled slots: M from the real-lane mask."""
    mask = np.asarray(arrays["mask"]).reshape(G, Mg)
    return [(g, int(m.sum())) for g, m in enumerate(mask) if m.any()]


def fwd_pack_from_jax(models: list, G: int, Mg: int,
                      device="cpu") -> ModelPack:
    """The Forward-gate pack from the per-model Pallas parameter sets
    ``(rfv, tr, M)`` of ``fwd_params_pallas``, in the slot order of the
    JAX ``FwdPack`` they were packed into.  (``FwdPack.arrays`` holds
    only the ``W3``/``u`` products, from which tMD and tDD cannot be
    recovered at the last positions; see ``fwd_params_from_jax``.)
    <G>, <Mg>: the JAX pack's geometry, checked against the models."""
    if len(models) > G or any(M > Mg - 1 for _, _, M in models):
        raise ValueError(f"{len(models)} models do not fit a pack of "
                         f"G={G}, Mg={Mg}")
    return build_fwd_pack([fwd_params_from_jax(rfv, tr, M, device)
                           for rfv, tr, M in models])


def domdec_pack_from_jax(arrays: dict, G: int, Mg: int, Kp: int,
                         device="cpu") -> ModelPack:
    """The decoding pack from ``DomDecPack.arrays`` (exact: the match
    odds and five rows as packed, tDM and tMD from the backward
    vectors, tDD from the superdiagonal of each ``UB``)."""
    rfvT = np.asarray(arrays["rfvT"])
    params = []
    for g, M in _models_of(arrays, G, Mg):
        f = _slot_view(arrays, g, Mg, ("tBM", "tMM", "tIM", "tMI", "tII"))
        f["rfvT"] = rfvT[g * Mg:(g + 1) * Mg, g * Kp:(g + 1) * Kp]
        params.append(domdec_params_from_jax(
            SimpleNamespace(fwd=SimpleNamespace(M=M, **f),
                            **_backward_view(arrays, g, Mg)), device))
    return build_domdec_pack(params)


def fs3_pack_from_jax(arrays: dict, G: int, Mg: int,
                      device="cpu") -> ModelPack:
    """The fs3 pack (gate and decoding) from ``FS3DomDecPack.arrays``
    (exact, as ``fs3_params_from_jax``).  ``FS3Pack.arrays`` alone is
    not enough: its ``UT`` folds tDD with tMD and the next lane's tDM,
    which leaves tDD unrecoverable where tDM is zero, so the gate's
    pack is carried from the decoding pack of the same models."""
    T = {k: np.asarray(arrays[k]) for k in ("T2", "T3", "T4")}
    params = []
    for g, M in _models_of(arrays, G, Mg):
        f = _slot_view(arrays, g, Mg, ("tBM", "tMM", "tIM", "tMI", "tII"))
        for k, t in T.items():
            n = t.shape[1] // G
            f[k] = t[g * Mg:(g + 1) * Mg, g * n:(g + 1) * n]
        params.append(fs3_params_from_jax(
            SimpleNamespace(fs3=SimpleNamespace(M=M, **f),
                            **_backward_view(arrays, g, Mg)), device))
    return build_fs3_pack(params)


def msv_pack_from_jax(sbvT, rbvT, Ms, base, tec, tbm, bias,
                      device="cpu") -> IntPack:
    """The MSV pack from the stacked arrays the JAX calibration hands
    its vmapped kernel: ``sbvT`` [G, Mt, Kp] int8 and ``rbvT``
    [G, Mt, Kp] uint8 (rows past a model's M are padding) and the [G]
    scalar bytes; <Ms> the model lengths."""
    return build_msv_pack([
        MSVParams.from_arrays(
            np.asarray(sbvT[g], np.int32)[:M].T,
            np.asarray(rbvT[g], np.int32)[:M].T,
            base[g], tec[g], tbm[g], bias[g], device=device)
        for g, M in enumerate(Ms)])


def vit_pack_from_jax(rwvT, tvs, Ms, base, emove, eloop,
                      device="cpu") -> IntPack:
    """The ViterbiFilter pack from the JAX calibration's stacked arrays:
    ``rwvT`` [G, Mt, Kp] int16, <tvs> the eight [G, Mt] int16 transition
    rows (tBM, tMM, tIM, tDM, tMD, tDD, tMI, tII; tMD and tDD there hold
    at lane k the move out of position k+1, here the move into D at
    k+1), and the [G] scalar words."""
    params = []
    for g, M in enumerate(Ms):
        tr = np.stack([np.asarray(t[g], np.int32)[:M] for t in tvs])
        for r in (R_MDS, R_DDS):
            tr[r] = np.r_[NEG, tr[r, :M - 1]]
        params.append(VitParams.from_arrays(
            np.asarray(rwvT[g], np.int32)[:M].T, tr, base[g], emove[g],
            eloop[g], device=device))
    return build_vit_pack(params)


# ---------------------------------------------------------------------
# Plain PyTorch versions: the single-model plain version over each
# model's items, scattered back
# ---------------------------------------------------------------------
def _ints_ref(ref, pack, flat, offs, lens, per_item, slot):
    """<ref> (a single-model integer filter) over each model's items;
    [3, B] int32."""
    out = torch.empty(3, lens.numel(), dtype=torch.int32, device=flat.device)
    for g, rows in _per_model(slot):
        r = torch.from_numpy(rows).to(flat.device)
        out[:, r] = torch.stack([
            t.to(torch.int32) for t in ref(flat, offs[r], lens[r],
                                           per_item[r], pack.params[g])])
    return out


def msv_ssv_multi_ref(pack: IntPack, flat, offs, lens, tjb, slot):
    """(xEu, xJm, movf) [B] int32 of ``ops.ssv.msv_ssv_ref``, item b
    under model slot[b]."""
    slot = _check_stream_slots(pack, flat, offs, lens, tjb, slot)
    out = _ints_ref(msv_ssv_ref, pack, flat, offs, lens, tjb, slot)
    return out[0], out[1], out[2]


def vit_ints_multi_ref(pack: IntPack, flat, offs, lens, move, slot):
    """(score_int [B] int32, has [B] bool, ovf [B] bool) of
    ``ops.vit.vit_ints_ref``, item b under model slot[b]."""
    slot = _check_stream_slots(pack, flat, offs, lens, move, slot)
    out = _ints_ref(vit_ints_ref, pack, flat, offs, lens, move, slot)
    return out[0], out[1] != 0, out[2] != 0


def _scores_ref(score, pack, dsq, lens, slot, nj):
    """<score> over each model's items, each group cut to its longest
    item (rows past an item's length change nothing in a score)."""
    out = torch.empty(dsq.shape[0], dtype=torch.float32, device=dsq.device)
    for g, rows in _per_model(slot):
        Lg = max(1, int(lens[rows].max()))
        out[rows] = score(dsq[rows][:, :Lg], lens[rows], pack.params[g], nj)
    return out


def fwd_pack_scores_ref(pack: ModelPack, dsq, lens, slot,
                        nj: float = 1.0) -> torch.Tensor:
    """Forward-gate scores [B] (nats), item b under model slot[b]."""
    slot = _check(pack, dsq, lens, slot)
    return _scores_ref(fwd_score_ref, pack, dsq, lens, slot, nj)


def _decode_ref(decode, pack, dsq, lens, slot, period: int):
    """<decode>(model, rows, dsq, lens) over each model's items, each group
    cut to its longest item and its rows extended to the batch's L + 1
    as the uncut computation leaves them: the increments past an item
    are zero, so btot and etot repeat with <period> (1, or 3 for the
    stride-3 sums of the fs3 decoder) and mocc is zero."""
    slot = _check(pack, dsq, lens, slot)
    B, L = dsq.shape
    post = [torch.zeros(B, L + 1, dtype=torch.float32, device=dsq.device)
            for _ in range(3)]
    ok = torch.zeros(B, dtype=torch.bool, device=dsq.device)
    for g, rows in _per_model(slot):
        Lg = min(L, max(period, int(lens[rows].max())))
        bt, et, mo, rows_ok = decode(g, rows, dsq[rows][:, :Lg], lens[rows])
        n = L - Lg
        for t, r in zip(post[:2], (bt, et)):
            tail = r[:, Lg + 1 - period:].repeat(1, -(-n // period))[:, :n]
            t[rows] = torch.cat([r, tail], 1)
        post[2][rows, :Lg + 1] = mo
        ok[rows] = rows_ok
    return (*post, ok)


def domdec_pack_batch_ref(pack: ModelPack, dsq, lens, slot,
                          nj: float = 1.0):
    """(btot, etot, mocc) [B, L+1] and ok [B], item b under model
    slot[b]."""
    return _decode_ref(
        lambda g, rows, d, ln: domdec_ref(d, ln, pack.params[g], nj),
        pack, dsq, lens, slot, 1)


def fs3_pack_scores_ref(pack: ModelPack, dsq, lens, slot,
                        nj: float = 1.0) -> torch.Tensor:
    """fs3-Forward gate scores [B] (nats), window b under model
    slot[b]."""
    slot = _check(pack, dsq, lens, slot)
    return _scores_ref(fs3_score_ref, pack, dsq, lens, slot, nj)


def _dec_loops(dec_loop, B: int, device) -> torch.Tensor:
    return torch.as_tensor(dec_loop, dtype=torch.float64,
                           device=device).expand(B)


def fs3_domdec_pack_batch_ref(pack: ModelPack, dsq, lens, slot, dec_loop,
                              nj: float = 1.0):
    """(btot, etot, mocc) [B, L+1] and ok [B], window b under model
    slot[b] and N/J/C loop probability ``dec_loop[b]`` (a scalar
    serves every window)."""
    dec = _dec_loops(dec_loop, dsq.shape[0], dsq.device)
    return _decode_ref(
        lambda g, rows, d, ln: fs3_domdec_ref(d, ln, pack.params[g],
                                              dec[rows], nj),
        pack, dsq, lens, slot, 3)


# ---------------------------------------------------------------------
# The packed calls.  CUDA tensors launch the kernel entries (or raise);
# CPU tensors run the plain versions.  <slot>: [B] model slots, a numpy
# array or a tensor on any device: the launch plan is built from it on
# the host.  Each wrapper counts its launches: one a call.
# ---------------------------------------------------------------------
def fwd_pack_scores(pack: ModelPack, dsq, lens, slot,
                    nj: float = 1.0) -> torch.Tensor:
    """Forward-gate scores [B] (nats), item b under model slot[b]."""
    if dsq.device.type == "cpu":
        return fwd_pack_scores_ref(pack, dsq, lens, slot, nj)
    slot = _check(pack, dsq, lens, slot)
    from .kernels import loader
    run = loader.prepare_fwd(dsq, lens, slot, pack)
    out = run(nj)
    fwd_pack_scores.launches += run.launches
    return out


def domdec_pack_batch(pack: ModelPack, dsq, lens, slot, nj: float = 1.0):
    """(btot, etot, mocc) [B, L+1] and ok [B], item b under model
    slot[b]."""
    if dsq.device.type == "cpu":
        return domdec_pack_batch_ref(pack, dsq, lens, slot, nj)
    slot = _check(pack, dsq, lens, slot)
    from .kernels import loader
    run = loader.prepare_domdec(dsq, lens, slot, pack)
    fspec, bspec, logz2 = run(nj)
    domdec_pack_batch.launches += run.launches
    return finish_passes(fspec, bspec, lens, logz2, nj)


def fs3_pack_scores(pack: ModelPack, dsq, lens, slot,
                    nj: float = 1.0) -> torch.Tensor:
    """fs3-Forward gate scores [B] (nats), window b under model
    slot[b]."""
    if dsq.device.type == "cpu":
        return fs3_pack_scores_ref(pack, dsq, lens, slot, nj)
    slot = _check(pack, dsq, lens, slot)
    from .kernels import loader
    run = loader.prepare_fs3(dsq, lens, slot, pack, False)
    out = run(nj)
    fs3_pack_scores.launches += run.launches
    return out


def fs3_domdec_pack_batch(pack: ModelPack, dsq, lens, slot, dec_loop,
                          nj: float = 1.0):
    """(btot, etot, mocc) [B, L+1] and ok [B], window b under model
    slot[b] and N/J/C loop probability ``dec_loop[b]``."""
    if dsq.device.type == "cpu":
        return fs3_domdec_pack_batch_ref(pack, dsq, lens, slot, dec_loop,
                                         nj)
    slot = _check(pack, dsq, lens, slot)
    from .kernels import loader
    run = loader.prepare_fs3(dsq, lens, slot, pack, True)
    fspec, bspec, logz2 = run(nj)
    fs3_domdec_pack_batch.launches += run.launches
    return fs3_domdec_finish(fspec, bspec, lens, logz2[:, 0], logz2[:, 1],
                             _dec_loops(dec_loop, dsq.shape[0], dsq.device))


def msv_ssv_multi(pack: IntPack, flat, offs, lens, tjb, slot):
    """(xEu, xJm, movf) [B] int32 of the fused SSV+MSV filter, item b
    (``flat[offs[b]:offs[b] + lens[b]]``, J->B byte ``tjb[b]``) under
    model slot[b]; ``ops.ssv.msv_post`` with ``pack.per_item(slot)``
    turns them into scores."""
    if flat.device.type == "cpu":
        return msv_ssv_multi_ref(pack, flat, offs, lens, tjb, slot)
    slot = _check_stream_slots(pack, flat, offs, lens, tjb, slot)
    from .kernels import loader
    run = loader.prepare_msv(flat, offs, lens, tjb, slot, pack)
    out = run()
    msv_ssv_multi.launches += run.launches
    return out[0], out[1], out[2]


def vit_ints_multi(pack: IntPack, flat, offs, lens, move, slot):
    """(score_int [B] int32, has [B] bool, ovf [B] bool) of the
    ViterbiFilter, item b (N/J/C move word ``move[b]``) under model
    slot[b]."""
    if flat.device.type == "cpu":
        return vit_ints_multi_ref(pack, flat, offs, lens, move, slot)
    slot = _check_stream_slots(pack, flat, offs, lens, move, slot)
    from .kernels import loader
    run = loader.prepare_vit(flat, offs, lens, move, slot, pack)
    out = run()
    vit_ints_multi.launches += run.launches
    return out[0], out[1] != 0, out[2] != 0


# CUDA launches through each wrapper
msv_ssv_multi.launches = 0
vit_ints_multi.launches = 0
fwd_pack_scores.launches = 0
domdec_pack_batch.launches = 0
fs3_pack_scores.launches = 0
fs3_domdec_pack_batch.launches = 0
