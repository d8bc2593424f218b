"""Models past a block's warps (a ViterbiFilter group of 16 warps of 17
lanes, M = 8704; the fs3 pair's 32 warps of 13, M = 13312; the gate,
decoding and MSV's 32 warps of 33, M = 33792): a group of 16 warps
walks each row in S segments (``loader.segmented``), which the plans
put in word 8 of the class row and whose scratch the loader allocates
(word 9).

Held here on the CPU, where the kernels do not run: every plan takes a
model of M = 40000 (a pack of it and an M = 400 model, from
``fixtures.make_query``), its segmented class covering the model's
lanes; below the old ceilings every plan gives the class rows the
plans gave before segments (the table below, made by the parent
commit's plans on the same packs), with S = 1; and the plain versions
that ``chip_smoke.py`` holds the segmented kernels to agree with the
JAX package at those lengths: the integer filters (MSV, the
ViterbiFilter, both captures) bit for bit with
``bath_tpu/ops/reference/filters.py`` at M = 9000 and 23000, the
Forward gate within 1e-3 nats of ``ops/reference/fwdback.py`` at
M = 40000.  The kernels themselves are held on the card
(``tests/test_torch_cuda.py`` ``test_long_models_past_a_block_of_
registers``, ``chip_smoke.py`` ``parity``).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax_native
from bath_tpu.ops.reference import filters as flt
from bath_tpu.ops.reference import fwdback
from bath_tpu_torch import constants as C
from bath_tpu_torch import fixtures
from bath_tpu_torch.ops import fs3 as t3
from bath_tpu_torch.ops import fwd as tf
from bath_tpu_torch.ops import multimodel as mm
from bath_tpu_torch.ops import ssv as ts
from bath_tpu_torch.ops import vit as tv
from bath_tpu_torch.ops.kernels import loader
from torch_threads import one_torch_thread  # noqa: F401

LONG = 40_000
KP = 29
KINDS = ("fwd", "domdec", "fs3", "fs3_domdec", "msv", "ssv", "vit")

# (kind, M, one model or with an M = 400 one): (a block's warps, the class
# rows' words 2-7: P, W, Mp, G, Kp and the kernel's word; the
# ViterbiFilter's word 7, an address, as whether it is set), made by
# the parent commit's plans on the packs of random_model
PARENT_ROWS = {
    ("fwd", 60, "one"): (8, [[3, 1, 96, 8, 29, 1]]),
    ("fwd", 60, "mixed"): (8, [[3, 1, 96, 8, 29, 1], [13, 1, 416, 8, 29, 1]]),
    ("fwd", 400, "one"): (8, [[13, 1, 416, 8, 29, 1]]),
    ("fwd", 400, "mixed"): (8, [[13, 1, 416, 8, 29, 1]]),
    ("fwd", 1100, "one"): (6, [[17, 3, 1632, 2, 29, 2]]),
    ("fwd", 1100, "mixed"): (6, [
        [13, 1, 416, 6, 29, 1],
        [17, 3, 1632, 2, 29, 2],
    ]),
    ("fwd", 4200, "one"): (8, [[17, 8, 4352, 1, 29, 2]]),
    ("fwd", 4200, "mixed"): (8, [
        [13, 1, 416, 8, 29, 1],
        [17, 8, 4352, 1, 29, 2],
    ]),
    ("fwd", 7500, "one"): (14, [[17, 14, 7616, 1, 29, 0]]),
    ("fwd", 7500, "mixed"): (14, [
        [13, 1, 416, 14, 29, 1],
        [17, 14, 7616, 1, 29, 0],
    ]),
    ("fwd", 12000, "one"): (23, [[17, 23, 12512, 1, 29, 0]]),
    ("fwd", 12000, "mixed"): (23, [
        [13, 1, 416, 23, 29, 1],
        [17, 23, 12512, 1, 29, 0],
    ]),
    ("fwd", 20000, "one"): (19, [[33, 19, 20064, 1, 29, 0]]),
    ("fwd", 20000, "mixed"): (19, [
        [13, 1, 416, 19, 29, 1],
        [33, 19, 20064, 1, 29, 0],
    ]),
    ("fwd", 33792, "one"): (32, [[33, 32, 33792, 1, 29, 0]]),
    ("fwd", 33792, "mixed"): (32, [
        [13, 1, 416, 32, 29, 1],
        [33, 32, 33792, 1, 29, 0],
    ]),
    ("domdec", 60, "one"): (8, [[3, 1, 96, 8, 29, 1]]),
    ("domdec", 60, "mixed"): (8, [
        [3, 1, 96, 8, 29, 1],
        [13, 1, 416, 8, 29, 1],
    ]),
    ("domdec", 400, "one"): (8, [[13, 1, 416, 8, 29, 1]]),
    ("domdec", 400, "mixed"): (8, [[13, 1, 416, 8, 29, 1]]),
    ("domdec", 1100, "one"): (8, [[33, 2, 2112, 4, 29, 0]]),
    ("domdec", 1100, "mixed"): (8, [
        [13, 1, 416, 8, 29, 1],
        [33, 2, 2112, 4, 29, 0],
    ]),
    ("domdec", 4200, "one"): (8, [[33, 4, 4224, 2, 29, 0]]),
    ("domdec", 4200, "mixed"): (8, [
        [13, 1, 416, 8, 29, 1],
        [33, 4, 4224, 2, 29, 0],
    ]),
    ("domdec", 7500, "one"): (8, [[33, 8, 8448, 1, 29, 0]]),
    ("domdec", 7500, "mixed"): (8, [
        [13, 1, 416, 8, 29, 1],
        [33, 8, 8448, 1, 29, 0],
    ]),
    ("domdec", 12000, "one"): (12, [[33, 12, 12672, 1, 29, 0]]),
    ("domdec", 12000, "mixed"): (12, [
        [13, 1, 416, 12, 29, 1],
        [33, 12, 12672, 1, 29, 0],
    ]),
    ("domdec", 20000, "one"): (19, [[33, 19, 20064, 1, 29, 0]]),
    ("domdec", 20000, "mixed"): (19, [
        [13, 1, 416, 19, 29, 1],
        [33, 19, 20064, 1, 29, 0],
    ]),
    ("domdec", 33792, "one"): (32, [[33, 32, 33792, 1, 29, 0]]),
    ("domdec", 33792, "mixed"): (32, [
        [13, 1, 416, 32, 29, 1],
        [33, 32, 33792, 1, 29, 0],
    ]),
    ("msv", 60, "one"): (8, [[3, 1, 96, 8, 29, 1]]),
    ("msv", 60, "mixed"): (8, [[3, 1, 96, 8, 29, 1], [13, 1, 416, 8, 29, 1]]),
    ("msv", 400, "one"): (8, [[13, 1, 416, 8, 29, 1]]),
    ("msv", 400, "mixed"): (8, [[13, 1, 416, 8, 29, 1]]),
    ("msv", 1100, "one"): (12, [[17, 3, 1632, 4, 29, 1]]),
    ("msv", 1100, "mixed"): (12, [
        [13, 1, 416, 12, 29, 1],
        [17, 3, 1632, 4, 29, 1],
    ]),
    ("msv", 4200, "one"): (12, [[17, 8, 4352, 1, 29, 0]]),
    ("msv", 4200, "mixed"): (12, [
        [13, 1, 416, 12, 29, 1],
        [17, 8, 4352, 1, 29, 0],
    ]),
    ("msv", 7500, "one"): (32, [[17, 14, 7616, 2, 29, 0]]),
    ("msv", 7500, "mixed"): (32, [
        [13, 1, 416, 32, 29, 1],
        [17, 14, 7616, 2, 29, 0],
    ]),
    ("msv", 12000, "one"): (32, [[17, 23, 12512, 1, 29, 0]]),
    ("msv", 12000, "mixed"): (32, [
        [13, 1, 416, 32, 29, 1],
        [17, 23, 12512, 1, 29, 0],
    ]),
    ("msv", 20000, "one"): (32, [[33, 19, 20064, 1, 29, 0]]),
    ("msv", 20000, "mixed"): (32, [
        [13, 1, 416, 32, 29, 1],
        [33, 19, 20064, 1, 29, 0],
    ]),
    ("msv", 33792, "one"): (32, [[33, 32, 33792, 1, 29, 0]]),
    ("msv", 33792, "mixed"): (32, [
        [13, 1, 416, 32, 29, 1],
        [33, 32, 33792, 1, 29, 0],
    ]),
    ("vit", 60, "one"): (8, [[3, 1, 96, 8, 29, 0]]),
    ("vit", 60, "mixed"): (8, [[3, 1, 96, 8, 29, 0], [13, 1, 416, 8, 29, 0]]),
    ("vit", 400, "one"): (8, [[13, 1, 416, 8, 29, 0]]),
    ("vit", 400, "mixed"): (8, [[13, 1, 416, 8, 29, 0]]),
    ("vit", 1100, "one"): (16, [[17, 3, 1632, 5, 29, 0]]),
    ("vit", 1100, "mixed"): (16, [
        [13, 1, 416, 16, 29, 0],
        [17, 3, 1632, 5, 29, 0],
    ]),
    ("vit", 2720, "one"): (16, [[17, 5, 2720, 3, 29, 0]]),
    ("vit", 2720, "mixed"): (16, [
        [13, 1, 416, 16, 29, 0],
        [17, 5, 2720, 3, 29, 0],
    ]),
    ("vit", 3000, "one"): (16, [[17, 6, 3264, 2, 29, 1]]),
    ("vit", 3000, "mixed"): (16, [
        [13, 1, 416, 16, 29, 0],
        [17, 6, 3264, 2, 29, 1],
    ]),
    ("vit", 8704, "one"): (16, [[17, 16, 8704, 1, 29, 1]]),
    ("vit", 8704, "mixed"): (16, [
        [13, 1, 416, 16, 29, 0],
        [17, 16, 8704, 1, 29, 1],
    ]),
    ("fs3", 60, "one"): (4, [[3, 1, 96, 4, 1, 0]]),
    ("fs3", 60, "mixed"): (4, [[3, 1, 96, 4, 0, 0], [13, 1, 416, 4, 0, 0]]),
    ("fs3", 400, "one"): (4, [[13, 1, 416, 4, 0, 0]]),
    ("fs3", 400, "mixed"): (4, [[13, 1, 416, 4, 0, 0]]),
    ("fs3", 1500, "one"): (4, [[13, 4, 1664, 1, 0, 0]]),
    ("fs3", 1500, "mixed"): (4, [
        [13, 1, 416, 4, 0, 0],
        [13, 4, 1664, 1, 0, 0],
    ]),
    ("fs3", 3000, "one"): (8, [[13, 8, 3328, 1, 0, 0]]),
    ("fs3", 3000, "mixed"): (8, [
        [13, 1, 416, 8, 0, 0],
        [13, 8, 3328, 1, 0, 0],
    ]),
    ("fs3", 4000, "one"): (10, [[13, 10, 4160, 1, 1, 1]]),
    ("fs3", 4000, "mixed"): (10, [
        [13, 1, 416, 10, 1, 0],
        [13, 10, 4160, 1, 1, 1],
    ]),
    ("fs3", 8000, "one"): (20, [[13, 20, 8320, 1, 1, 1]]),
    ("fs3", 8000, "mixed"): (20, [
        [13, 1, 416, 20, 1, 0],
        [13, 20, 8320, 1, 1, 1],
    ]),
    ("fs3", 13312, "one"): (32, [[13, 32, 13312, 1, 1, 1]]),
    ("fs3", 13312, "mixed"): (32, [
        [13, 1, 416, 21, 1, 0],
        [13, 32, 13312, 1, 1, 1],
    ]),
    ("fs3_domdec", 60, "one"): (4, [[3, 1, 96, 4, 1, 0]]),
    ("fs3_domdec", 60, "mixed"): (4, [
        [3, 1, 96, 4, 0, 0],
        [13, 1, 416, 4, 0, 0],
    ]),
    ("fs3_domdec", 400, "one"): (4, [[13, 1, 416, 4, 0, 0]]),
    ("fs3_domdec", 400, "mixed"): (4, [[13, 1, 416, 4, 0, 0]]),
    ("fs3_domdec", 1500, "one"): (4, [[13, 4, 1664, 1, 0, 0]]),
    ("fs3_domdec", 1500, "mixed"): (4, [
        [13, 1, 416, 4, 0, 0],
        [13, 4, 1664, 1, 0, 0],
    ]),
    ("fs3_domdec", 3000, "one"): (8, [[13, 8, 3328, 1, 0, 0]]),
    ("fs3_domdec", 3000, "mixed"): (8, [
        [13, 1, 416, 8, 0, 0],
        [13, 8, 3328, 1, 0, 0],
    ]),
    ("fs3_domdec", 4000, "one"): (10, [[13, 10, 4160, 1, 1, 1]]),
    ("fs3_domdec", 4000, "mixed"): (10, [
        [13, 1, 416, 10, 1, 0],
        [13, 10, 4160, 1, 1, 1],
    ]),
    ("fs3_domdec", 8000, "one"): (20, [[13, 20, 8320, 1, 1, 1]]),
    ("fs3_domdec", 8000, "mixed"): (20, [
        [13, 1, 416, 20, 1, 0],
        [13, 20, 8320, 1, 1, 1],
    ]),
    ("fs3_domdec", 13312, "one"): (32, [[13, 32, 13312, 1, 1, 1]]),
    ("fs3_domdec", 13312, "mixed"): (32, [
        [13, 1, 416, 21, 1, 0],
        [13, 32, 13312, 1, 1, 1],
    ]),
}


def random_model(kind, M, rng):
    """Parameters of random words of one model: the plans read only the
    shapes."""
    if kind in ("fwd", "domdec"):
        return tf.ProfileTensors(torch.rand(KP, M), torch.rand(8, M))
    if kind.startswith("fs3"):
        return tf.ProfileTensors(torch.rand(mm.FS3_ROWS, M),
                                 torch.rand(8, M))
    if kind in ("msv", "ssv"):
        return ts.MSVParams.from_arrays(rng.integers(-128, 128, (KP, M)),
                                        rng.integers(0, 256, (KP, M)),
                                        190, 30, 10, 20)
    return tv.VitParams.from_arrays(rng.integers(-3000, 200, (KP, M)),
                                    rng.integers(-3000, 0, (8, M)),
                                    195, -300, -300)


def plan_of(kind, params, lens, slot):
    """<kind>'s plan of a batch over a pack of <params>."""
    if kind in ("fwd", "domdec"):
        pack = mm.build_fwd_pack(params)
        if kind == "fwd":
            return mm.fwd_plan(lens, slot, pack.with_layout(loader.fwd_layout))
        return mm.domdec_plan(lens, slot, pack)
    if kind.startswith("fs3"):
        return mm.fs3_plan(lens, slot, mm.build_fs3_pack(params),
                           2 if kind == "fs3_domdec" else 1)
    if kind == "msv":
        return mm.msv_plan(lens, slot, mm.build_msv_pack(params))
    if kind == "ssv":
        return mm.ssv_plan(params[0].as_pack())
    return mm.vit_plan(lens, slot, mm.build_vit_pack(params))


def rows_of(plan):
    return plan.table[:mm.PLAN_CLS * plan.ncls].reshape(-1, mm.PLAN_CLS)


@pytest.mark.parametrize("kind", sorted({k for k, _, _ in PARENT_ROWS}))
def test_plans_below_the_old_ceilings_keep_the_parent_rows(kind):
    rng = np.random.default_rng(0)
    small = random_model(kind, 400, rng)
    for (k, M, tag), (warps, want) in PARENT_ROWS.items():
        if k != kind:
            continue
        p = random_model(kind, M, rng)
        params, lens, slot = (([p], [50], [0]) if tag == "one" else
                              ([p, small], [50, 40], [0, 1]))
        plan = plan_of(kind, params, np.array(lens), np.array(slot))
        rows = rows_of(plan)
        got = [r[2:8].tolist() for r in rows]
        if kind == "vit":
            got = [r[:5] + [int(r[5] != 0)] for r in got]
        assert (plan.warps, got) == (warps, want), (kind, M, tag)
        assert (rows[:, 8:] == [1, 0]).all() and not plan.scratch


@pytest.fixture(scope="module")
def long_models():
    """The M = 40000 model (built for --fs, so that it has an fs3
    profile too) and an M = 400 one, as the kernels' parameters."""
    out = {}
    for M in (LONG, 400):
        hmm, q = fixtures.make_query(M, np.random.default_rng(M),
                                     calibrate=False, fs=True)
        om = fixtures.search_profile(hmm)
        out[M] = SimpleNamespace(om=om, q=q, fwd=tf.fwd_params(om),
                                 msv=ts.msv_params(om),
                                 vit=tv.vit_params(om),
                                 fs3=t3.fs3_params(
                                     fixtures.fs_search_profile(hmm)))
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_every_plan_takes_a_model_of_40000(kind, long_models):
    """The model's class walks its rows in S > 1 segments of a group of
    16 warps that cover its lanes (S 32 W P = Mp >= M), one item a
    block, its blocks first and counted for the loader's scratch (a
    slot for each block the card holds at once); the M = 400 model's
    class keeps one segment."""
    attr = {"fwd": "fwd", "domdec": "fwd", "msv": "msv", "ssv": "msv",
            "vit": "vit"}.get(kind, "fs3")
    params = [getattr(long_models[M], attr) for M in (LONG, 400)]
    lens = np.array([30, 90, 60, 20, 45])
    slot = np.array([1, 0, 1, 0, 0])
    if kind == "ssv":
        params, slot = params[:1], np.zeros(len(lens), int)
    plan = plan_of(kind, params, lens, slot)
    rows = rows_of(plan)
    seg = [r for r in rows if r[8] > 1]
    assert len(seg) == 1 and plan.warps == loader.SEG_WARPS
    P, W, Mp, G, S = (int(seg[0][i]) for i in (2, 3, 4, 5, 8))
    assert W == loader.SEG_WARPS and G == 1 and S >= 2
    assert 32 * W * P * S == Mp >= LONG > 32 * W * P
    assert all(r[8] == 1 for r in rows if r[8] <= 1)
    if kind == "ssv":
        # the capture's class row alone, made once a parameter set: its
        # scratch has a slot for each block the card holds at once
        assert plan.nblk == 0 and plan.scratch == [(0, None)]
        return
    c = int(np.nonzero(rows[:, 8] > 1)[0][0])
    per = 2 if kind.endswith("domdec") else 1
    n = per * int((slot == 0).sum())
    blocks = plan.blocks
    assert (blocks[:n, 0] == c).all() and (blocks[n:, 0] != c).all()
    assert (blocks[:n, 4] == 1).all()
    assert plan.scratch == [(c, n)]


# a model past 16 warps (and inside 32) under each family's ladder
WIDE_M = {"fwd": 12000, "domdec": 20000, "fs3": 8000, "fs3_domdec": 8000,
          "msv": 20000}


@pytest.mark.parametrize("kind", sorted(WIDE_M))
def test_a_wide_model_beside_a_segmented_one_is_segmented_too(kind):
    """A launch with a segmented class runs blocks of the segmented
    group's 16 warps, so a model past 16 warps beside it is segmented
    too (``_beside_segmented``), on the family's segment lanes; an
    M = 400 model keeps its one warp.  Alone, the wide model keeps its
    one segment (the parent's row)."""
    rng = np.random.default_rng(7)
    wide = random_model(kind, WIDE_M[kind], rng)
    params = [random_model(kind, LONG, rng), wide,
              random_model(kind, 400, rng)]
    lens = np.array([30, 90, 60, 20, 45, 70])
    slot = np.array([1, 0, 2, 1, 0, 2])
    plan = plan_of(kind, params, lens, slot)
    rows = rows_of(plan)
    assert plan.warps == loader.SEG_WARPS
    assert (rows[:, 3] <= loader.SEG_WARPS).all()
    lanes = loader.FS3_SEG_LANES if kind.startswith("fs3") \
        else loader.SEG_LANES
    seg = sorted(tuple(int(x) for x in r[2:6]) + (int(r[8]),)
                 for r in rows if r[8] > 1)
    assert len(seg) == 2
    for (P, W, Mp, G, S), M in zip(seg, sorted((WIDE_M[kind], LONG))):
        assert (P, W, Mp) == loader.segmented(M, lanes)
        assert W == loader.SEG_WARPS and G == 1 and S >= 2
        assert 32 * W * P * S == Mp >= M > 32 * W * P
        assert P in lanes
    assert [tuple(r[2:4]) for r in rows if r[8] == 1] == [(13, 1)]
    per = 2 if kind.endswith("domdec") else 1
    assert sorted(n for _, n in plan.scratch) == [2 * per, 2 * per]
    alone = rows_of(plan_of(kind, [wide], lens[:2], np.zeros(2, int)))
    assert alone[0, 3] > loader.SEG_WARPS and alone[0, 8] == 1


@pytest.fixture(scope="module")
def host_native():
    """bath_tpu's native library, which the host reference filters run
    in."""
    jax_native.load()


def homolog_orfs(q, rng, n=6, length=320):
    """ORFs of <length> random residues, every second one carrying a
    mutated 250-residue piece of the query <q> (a local homolog: the
    captures' thresholds are crossed), and one of 2 residues."""
    f = fixtures.Background().f[:20].astype(np.float64)
    orfs = []
    for b in range(n):
        o = rng.choice(20, size=length, p=f / f.sum()).astype(np.int8)
        if b % 2 == 0:
            at = int(rng.integers(0, len(q) - 250))
            o[30:280] = fixtures._mutate(q[at:at + 250], rng)
        orfs.append(o)
    return orfs + [o[:2] for o in orfs[:1]]


def stream(orfs):
    return tuple(torch.from_numpy(a) for a in ts.pack_stream(orfs))


@pytest.mark.parametrize("M", [9000, 23000])
def test_integer_plain_versions_match_the_host_reference(M, host_native):
    """MSV, the ViterbiFilter and the windows of both captures, replayed
    on the host from the plain versions' events, equal
    ``ops/reference/filters.py`` at a model past the ViterbiFilter's 16
    warps of 17 lanes and the SSV capture's 21 of 33."""
    from bath_tpu.bg import Background
    from bath_tpu.scoredata import score_data_create
    rng = np.random.default_rng(M)
    hmm, q = fixtures.make_query(M, rng, calibrate=False)
    om = fixtures.search_profile(hmm)
    # the capture thresholds read the MSV and Viterbi Gumbel parameters,
    # which an uncalibrated model lacks: typical ones, the same for the
    # reference and the plain versions' thresholds
    om.evparam[[C.EV_MMU, C.EV_MLAMBDA, C.EV_VMU, C.EV_VLAMBDA]] = \
        (-9.0, 0.693, -9.5, 0.693)
    orfs = homolog_orfs(q, rng)
    flat, offs, lens = stream(orfs)
    pm, pv = ts.msv_params(om), tv.vit_params(om)
    tjb = torch.from_numpy(pm.tjb_for(lens.numpy()))
    move = torch.from_numpy(pv.move_for(lens.numpy()))
    msv_int, msv_inf = ts.msv_post(*ts.msv_ssv(flat, offs, lens, tjb, pm),
                                   tjb, pm)
    msv = np.where(msv_inf.numpy(), np.float32(np.inf), np.float32(
        (msv_int.numpy() - pm.base) / pm.scale - 3.0))
    vsc, vhas, vovf = tv.vit_ints(flat, offs, lens, move, pv)
    data = score_data_create(om)
    bg = Background()
    crossed = {"ssv": 0, "vit": 0}
    for r, o in enumerate(orfs):
        d = np.asarray(o, np.int32)
        om.reconfig_length(len(d))
        bg.set_length(len(d))
        null = bg.null_one(len(d))
        assert flt.msv_filter(d, om) == msv[r], r
        want = flt.viterbi_filter(d, om)
        got = (np.inf if vovf[r] else -np.inf if not vhas[r] else
               np.float32((int(vsc[r]) - pv.base) / pv.scale - 3.0))
        assert want == got, r
        one = (flat, offs[r:r + 1], lens[r:r + 1])
        # the SSV capture at F1 = 0.02, its windows replayed on the host
        thr = torch.tensor([flt.ssv_thresh_bath(om, null, 0.02)],
                           dtype=torch.int32)
        nwin, wi, wk, wsc = (a.numpy()[0] for a in ts.ssv_capture(
            *one, tjb[r:r + 1], thr, pm))
        w2: list = []
        assert flt.ssv_windows_from_captures(
            d, om, data, (int(nwin), list(zip(wi, wk, wsc))[:int(nwin)]),
            w2)
        w1: list = []
        flt.ssv_filter_bath(d, om, data, null, 0.02, w1)
        assert [(w.n, w.k, w.length, w.score) for w in w1] == \
            [(w.n, w.k, w.length, w.score) for w in w2], r
        crossed["ssv"] += int(nwin) > 0
        # the ViterbiFilter's capture at F2 = 0.001
        a, ext = flt.vit_thresh_bath(om, null, 0.001)
        karr, ovfrow = (t.numpy() for t in tv.vit_capture(
            *one, move[r:r + 1], torch.tensor([a], dtype=torch.int32), pv))
        karr = karr[offs[r]:offs[r] + len(d)]
        rows = np.nonzero(karr)[0]
        if ovfrow[0] > 0:
            rows = rows[rows + 1 < ovfrow[0]]
        w2 = []
        flt.vit_windows_from_captures(d, om, data, rows + 1, karr[rows], w2,
                                      int(ext))
        w1 = []
        flt.viterbi_filter(d, om, data, null, 0.001, w1)
        assert [(w.n, w.k, w.length) for w in w1] == \
            [(w.n, w.k, w.length) for w in w2], r
        crossed["vit"] += len(rows) > 0
    assert crossed["ssv"] > 0 and crossed["vit"] > 0


def test_plain_gate_matches_the_host_forward(long_models):
    """The plain Forward gate at M = 40000 (past the gate's 32 warps of
    33 lanes, M = 33792) against ``ops/reference/fwdback.py`` ``forward``,
    within 1e-3 nats, on ORFs with and without a piece of the query."""
    om, q = long_models[LONG].om, long_models[LONG].q
    orfs = homolog_orfs(q, np.random.default_rng(7), n=3, length=300)
    lens = np.array([len(o) for o in orfs], np.int32)
    dsq = np.full((len(orfs), lens.max()), 28, np.int8)
    for b, o in enumerate(orfs):
        dsq[b, :len(o)] = o
    got = tf.fwd_score_ref(torch.from_numpy(dsq), torch.from_numpy(lens),
                           long_models[LONG].fwd).numpy()
    for b, o in enumerate(orfs):
        om.reconfig_length(len(o))
        _, want = fwdback.forward(np.asarray(o, np.int32), om)
        assert abs(got[b] - want) <= 1e-3, (b, got[b], want)


def test_a_vit_launch_of_many_warps_beside_one_of_33_lanes():
    """A ViterbiFilter class of 14 warps of 17 lanes (M = 7500) beside
    one of one warp of 33 (M = 900): more warps than the 33-lane
    instance's blocks of 12 hold, so the launch takes the 16-warp
    instance of the segmented group, its classes one segment each."""
    rng = np.random.default_rng(9)
    plan = plan_of("vit", [random_model("vit", M, rng) for M in (7500, 900)],
                   np.array([40, 30, 20]), np.array([0, 1, 0]))
    rows = rows_of(plan)
    assert plan.warps == 16
    assert sorted(r[[2, 3, 5, 8]].tolist() for r in rows) == \
        [[17, 14, 1, 1], [33, 1, 16, 1]]

