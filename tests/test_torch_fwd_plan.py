"""The Forward gate's launch plan (bath_tpu_torch/ops/multimodel.py
fwd_plan): every padded width of a call in one launch, each model's ORFs
longest first in blocks of its class's G, the blocks heaviest first
(Mp x longest ORF), every model's f32 tables in shared memory where they
fit a block's 227 KB and, past that, its transitions only.

The plan is host code, so it is held here on the CPU, on packs of random
tables (the plan reads only their shapes and addresses) with models of
eight padded widths, one to three warps an ORF; the kernel that reads it
is held on the card in test_torch_cuda.py.  The plain gate run block by
block in the plan's order is held to fwd_pack_scores_ref, and that to
the JAX package's packed gate.
"""

import numpy as np
import pytest
import torch

from bath_tpu.ops.jaxk import multimodel as jmm
from bath_tpu_torch import fixtures
from bath_tpu_torch.ops import fwd as tf
from bath_tpu_torch.ops import multimodel as mm
from bath_tpu_torch.ops.kernels import loader
from torch_threads import one_torch_thread  # noqa: F401

KP = 29
# padded widths 96, 160, 288, 416, 800, 1056 (one warp of 3 .. 33
# lanes), 2112 and 3168 (two and three warps of 33 lanes)
MS = (60, 150, 250, 400, 700, 1000, 1100, 2500, 90)


def profile(M, rng):
    return tf.ProfileTensors(
        torch.from_numpy(rng.random((KP, M), np.float32)),
        torch.from_numpy(rng.random((8, M), np.float32)))


@pytest.fixture(scope="module")
def pack():
    rng = np.random.default_rng(3)
    return mm.build_fwd_pack([profile(M, rng) for M in MS])


def batch(rng, n=97):
    slot = rng.integers(0, len(MS), n)
    slot[:30] = 6                    # one model's run spans blocks
    lens = rng.integers(0, 700, n)
    lens[30:36] = 321                # ties
    return lens, slot


def rows_of(plan):
    """The class rows of a plan, [ncls, 8]."""
    return plan.table[:mm.PLAN_CLS * plan.ncls].reshape(-1, mm.PLAN_CLS)


def test_every_item_once_each_block_one_model(pack):
    lens, slot = batch(np.random.default_rng(1))
    plan = mm.fwd_plan(lens, slot, pack)
    assert np.array_equal(np.sort(plan.items), np.arange(len(slot)))
    assert np.array_equal(plan.blocks[:, 3],
                          np.r_[0, np.cumsum(plan.blocks[:-1, 4])])
    rows = rows_of(plan)
    for c, m, M, first, count in plan.blocks:
        P, W, Mp, G = rows[c][2:6]
        cls = pack.classes[Mp]
        assert (P, W, Mp) == (cls.P, cls.W, cls.Mp)
        assert 1 <= count <= G
        items = plan.items[first:first + count]
        assert {cls.models[m]} == set(slot[items])
        assert M == MS[cls.models[m]]
        assert rows[c][0] == cls.etab.data_ptr()
        assert rows[c][1] == cls.ttab.data_ptr()
    # one launch: a block's warps hold every class's groups
    assert all(G * W <= plan.warps for _, _, _, W, _, G, _, _, _, _ in rows)
    assert plan.warps == mm.dd_block_warps([cls.W for cls in
                                            pack.classes.values()])


def test_longest_first_and_heaviest_blocks_first(pack):
    lens, slot = batch(np.random.default_rng(2))
    plan = mm.fwd_plan(lens, slot, pack)
    mp = np.array([rows_of(plan)[c][4] for c in plan.blocks[:, 0]])
    heads = []
    for (c, m, M, first, count), Mp in zip(plan.blocks, mp):
        items = plan.items[first:first + count]
        assert list(lens[items]) == sorted(lens[items], reverse=True)
        heads.append(Mp * lens[items[0]])
    assert heads == sorted(heads, reverse=True)
    # each model's run is longest first across its blocks too
    for g in set(slot.tolist()):
        seq = [lens[i] for i in plan.items if slot[i] == g]
        assert seq == sorted(seq, reverse=True)


def test_plan_does_not_depend_on_batch_order(pack):
    rng = np.random.default_rng(4)
    lens, slot = batch(rng)
    plan = mm.fwd_plan(lens, slot, pack)
    perm = rng.permutation(len(slot))
    moved = mm.fwd_plan(lens[perm], slot[perm], pack)
    assert np.array_equal(plan.blocks[:, [0, 1, 2, 4]],
                          moved.blocks[:, [0, 1, 2, 4]])
    key = list(zip(slot[plan.items], lens[plan.items]))
    assert key == list(zip(slot[perm][moved.items],
                           lens[perm][moved.items]))


def test_tables_staged_up_to_227_kb(pack, monkeypatch):
    """Every class up to Mp = 1056 stages both tables (156 KB at 1056);
    the 2112 and 3168 classes (305 and 458 KB) their transitions only,
    or neither under FWD_WIDE_STAGE = STAGE_NONE (the A/B script's
    sweep); a class whose transitions do not fit either (Mp 8448:
    264 KB) stages neither."""
    lens, slot = batch(np.random.default_rng(5), 300)
    slot[:len(MS)] = np.arange(len(MS))
    for wide in (mm.STAGE_TRANS, mm.STAGE_NONE):
        monkeypatch.setattr(mm, "FWD_WIDE_STAGE", wide)
        plan = mm.fwd_plan(lens, slot, pack)
        for _, _, P, W, Mp, G, Kp, stage, _, _ in rows_of(plan):
            need = mm.dd_table_bytes(Kp, Mp) + G * 32 * W
            if Mp <= 1056:
                assert stage == mm.STAGE_ALL and need <= mm.SMEM_BYTES
            else:
                assert stage == wide and need > mm.SMEM_BYTES
    monkeypatch.undo()
    assert mm.FWD_WIDE_STAGE in (mm.STAGE_TRANS, mm.STAGE_NONE)
    rng = np.random.default_rng(6)
    huge = mm.build_fwd_pack([profile(7500, rng)])
    plan = mm.fwd_plan(np.array([5, 9]), np.zeros(2, int), huge)
    assert rows_of(plan)[0][[4, 7]].tolist() == [8448, mm.STAGE_NONE]


def test_a_small_batch_spreads_over_the_card(pack):
    slot = np.full(300, 3)
    rng = np.random.default_rng(11)
    plan = mm.fwd_plan(rng.integers(1, 500, 300), slot, pack, sms=132)
    assert plan.classes[0][3] == 3 and plan.warps == 3 and plan.nblk == 100
    big = mm.fwd_plan(rng.integers(1, 500, 600), np.full(600, 3), pack,
                      sms=132)
    assert big.classes[0][3] == 8 and big.warps == 8


def test_one_model_and_empty_plans():
    """A single-model call's plan is its class row alone (no block rows,
    no items: the kernel's blocks take the batch in order); an empty
    batch plans nothing."""
    rng = np.random.default_rng(8)
    p = profile(4200, rng)
    one = mm.OneModel(p, loader.fwd_layout)
    plan = mm.fwd_plan(None, None, one)
    P, W, Mp = loader.fwd_layout(4200)
    assert (P, W, Mp) == (17, 8, 4352)
    assert (plan.ncls, plan.nblk, plan.warps) == (1, 0, 8)
    assert list(plan.table) == [p.padded(Mp)[0].data_ptr(),
                                p.padded(Mp)[1].data_ptr(), P, W, Mp, 1, KP,
                                mm.FWD_WIDE_STAGE, 1, 0]
    empty = mm.fwd_plan(np.zeros(0, int), np.zeros(0, int), one)
    assert (empty.ncls, empty.nblk, len(empty.table)) == (0, 0, 0)


def test_the_gate_takes_its_own_ladder(pack):
    """The gate's ladder (one warp up to 33 lanes, warps of 17 beyond
    1056: the sweep in PERF.md) is not decoding's (warps of 33): the wrappers
    take the pack under loader.fwd_layout, stacked once, with the same
    models; below 1057 lanes the two ladders agree."""
    gate = pack.with_layout(loader.fwd_layout)
    assert gate is pack.with_layout(loader.fwd_layout)
    assert pack.with_layout(loader.layout) is pack
    assert gate.params == pack.params
    for g, M in enumerate(MS):
        want = loader.layout(M) if M <= 1056 else \
            loader.layout(M, (loader.VIT_WIDE_LANES,))
        assert gate.geometry[g] == want
        assert (gate.geometry[g] == pack.geometry[g]) == (M <= 1056)
    assert gate.geometry[MS.index(1100)] == (17, 3, 1632)
    assert pack.geometry[MS.index(1100)] == (33, 2, 2112)


def amino(rng, n, L):
    lens = rng.integers(1, L + 1, n).astype(np.int32)
    lens[0], lens[-1] = 1, L
    dsq = np.full((n, L), 28, np.int8)
    for b, ln in enumerate(lens):
        dsq[b, :ln] = rng.integers(0, 20, ln)
    return dsq, lens


def test_plain_gate_in_plan_order_equals_the_packed_plain_and_jax():
    """The plain gate over each block of the plan, under the block's
    model, gives fwd_pack_scores_ref bit for bit; that is within 0.05
    nats (the JAX gate rounds its emissions to bf16) of the JAX
    package's packed gate (jaxk/multimodel.py fwd_pack_scores) on the
    same models, packed in its size classes."""
    rng = np.random.default_rng(17)
    Ms = (40, 100, 120, 63)
    oms = [fixtures.search_profile(fixtures.make_query(
        M, rng, calibrate=False)[0]) for M in Ms]
    pack = mm.build_fwd_pack([tf.fwd_params(om) for om in oms])
    dsq, lens = amino(rng, 24, 110)
    slot = np.resize(np.arange(len(Ms)), 24)
    rng.shuffle(slot)
    want = mm.fwd_pack_scores_ref(pack, torch.from_numpy(dsq),
                                  torch.from_numpy(lens), slot)
    plan = mm.fwd_plan(lens, slot, pack)
    rows = rows_of(plan)
    got = torch.full((len(slot),), float("nan"))
    for c, m, _, first, count in plan.blocks:
        items = plan.items[first:first + count]
        g = pack.classes[rows[c][4]].models[m]
        Lb = max(1, int(lens[items].max()))
        got[items] = tf.fwd_score_ref(
            torch.from_numpy(np.ascontiguousarray(dsq[items, :Lb])),
            torch.from_numpy(lens[items]), pack.params[g])
    assert torch.equal(got, want)
    jax = np.zeros(len(slot), np.float32)
    for Mg, G, members in ((64, 2, [0, 3]), (128, 2, [1, 2])):
        jpack = jmm.build_fwd_pack([jmm.fwd_components(oms[g])
                                    for g in members], G, Mg)
        sel = np.nonzero(np.isin(slot, members))[0]
        local = np.array([members.index(s) for s in slot[sel]], np.int32)
        jax[sel] = np.asarray(jmm.fwd_pack_scores(jpack, dsq[sel],
                                                  lens[sel], local))
    assert np.abs(want.numpy() - jax).max() < 0.05


@pytest.mark.parametrize("M, want", [(7500, (17, 14, 7616)),
                                     (12000, (17, 23, 12512)),
                                     (20000, (33, 19, 20064))])
def test_a_long_model_takes_one_block_of_its_warps(M, want):
    """Past the transitions' 227 KB a class stages nothing; its group is
    one block of its W warps (the kernel launches it on the wide
    instance where the registers ask for it), up to 32 warps: the
    ladder's warps of 17 lanes, then of 33 past M = 17408.  A model past
    32 warps of 33 lanes takes a segmented group of 16 warps."""
    rng = np.random.default_rng(M)
    pack = mm.build_fwd_pack([profile(M, rng), profile(900, rng)])
    gate = pack.with_layout(loader.fwd_layout)
    assert gate.geometry[0] == want
    plan = mm.fwd_plan(np.array([40, 30, 20]), np.array([0, 1, 0]), gate)
    assert plan.warps == want[1] and plan.ncls == 2
    rows = {r[4]: r for r in rows_of(plan)}
    assert rows[want[2]][[2, 3, 5, 7]].tolist() == \
        [want[0], want[1], 1, mm.STAGE_NONE]
    assert rows[1056][[2, 3, 5, 7]].tolist() == \
        [33, 1, want[1], mm.STAGE_ALL]
    if M == 20000:
        huge = mm.build_fwd_pack([profile(33793, rng)])
        plan = mm.fwd_plan(np.array([5]), np.zeros(1, int),
                           huge.with_layout(loader.fwd_layout))
        assert plan.warps == 16
        assert rows_of(plan)[0][[2, 3, 4, 5, 7, 8]].tolist() == \
            [13, 16, 39936, 1, mm.STAGE_NONE, 6]
