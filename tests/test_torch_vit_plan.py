"""The ViterbiFilter's launch plan (bath_tpu_torch/ops/multimodel.py
vit_plan) and its int16 tables: every padded width of a call in one
launch, blocks heaviest first (Mp x longest ORF), every model's table in
shared memory where it fits and read from global memory past it.

The plan is host code, so it is held here on the CPU, on packs of random
words (the plan reads only their shapes and addresses) with models of
seven padded widths, one to three warps an ORF; the kernel that reads it
is held on the card in test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from bath_tpu_torch.ops import multimodel as mm
from bath_tpu_torch.ops import vit as tv
from bath_tpu_torch.ops.kernels import loader
from torch_threads import one_torch_thread  # noqa: F401

KP = 29
# padded widths 96, 160, 288, 416, 800 (one warp of 3 .. 25 lanes), 1088
# and 1632 (two and three warps of 17 lanes)
MS = (60, 150, 250, 400, 700, 1080, 1100, 90)


def vit_model(M, rng, lo=-3000):
    rwv = rng.integers(lo, 200, (KP, M))
    tr = rng.integers(lo, 0, (8, M))
    return tv.VitParams.from_arrays(rwv, tr, base=195, emove=-300,
                                    eloop=-300)


@pytest.fixture(scope="module")
def pack():
    rng = np.random.default_rng(3)
    return mm.build_vit_pack([vit_model(M, rng) for M in MS])


def batch(rng, n=97):
    slot = rng.integers(0, len(MS), n)
    slot[:30] = 6                    # one model's run spans blocks
    lens = rng.integers(0, 700, n)
    lens[30:36] = 321                # ties
    return lens, slot


def blocks_of(plan):
    """[(class row, block row, items)] in launch order."""
    return [(plan.table[mm.PLAN_CLS * c:mm.PLAN_CLS * (c + 1)], (c, m, M, f, n),
             plan.items[f:f + n]) for c, m, M, f, n in plan.blocks]


def test_every_item_once(pack):
    lens, slot = batch(np.random.default_rng(1))
    plan = mm.vit_plan(lens, slot, pack)
    assert np.array_equal(np.sort(plan.items), np.arange(len(slot)))
    assert plan.blocks[:, 4].sum() == len(slot)
    assert np.array_equal(plan.blocks[:, 3],
                          np.r_[0, np.cumsum(plan.blocks[:-1, 4])])


def test_every_group_holds_one_model_of_one_class(pack):
    lens, slot = batch(np.random.default_rng(2))
    plan = mm.vit_plan(lens, slot, pack)
    mp_of, local_of = pack.slot_class
    for crow, (c, m, M, _, n), its in blocks_of(plan):
        P, W, Mp, G, Kp = (int(v) for v in crow[2:7])
        cls = pack.classes[Mp]
        assert 1 <= n <= G and G * W <= plan.warps and Kp == KP
        assert crow[0] == cls.tab.data_ptr() and crow[1] == cls.scal.data_ptr()
        assert cls.tab.dtype == torch.int16
        assert M == MS[cls.models[m]] == int(cls.scal[m, 0])
        assert set(slot[its]) == {cls.models[m]}
        assert set(mp_of[slot[its]]) == {Mp} and set(local_of[slot[its]]) == {m}


def test_blocks_go_heaviest_first(pack):
    """By Mp x the block's longest ORF, each block's ORFs longest
    first."""
    lens, slot = batch(np.random.default_rng(4))
    plan = mm.vit_plan(lens, slot, pack)
    heads = [int(crow[4]) * lens[its[0]] for crow, _, its in blocks_of(plan)]
    assert heads == sorted(heads, reverse=True)
    for _, _, its in blocks_of(plan):
        assert list(lens[its]) == sorted(lens[its], reverse=True)


def test_class_descriptors_follow_the_ladder(pack):
    """One warp of up to 33 lanes, W warps of 17 beyond; the block warps
    those of the kernel instance of the launch's largest P (here 25:
    the instance of P <= 33, 12 warps); every table in shared memory."""
    lens, slot = batch(np.random.default_rng(5))
    slot[-len(MS):] = np.arange(len(MS))        # every model present
    plan = mm.vit_plan(lens, slot, pack)
    assert plan.ncls == 7 and plan.warps == 12
    for c, (P, W, Mp, G, longest) in enumerate(plan.classes):
        assert (P, W, Mp) == loader.vit_layout(
            MS[pack.classes[Mp].models[0]])
        assert (W == 1 or P == 17) and G == 12 // W
        assert longest == lens[pack.slot_class[0][slot] == Mp].max()
        assert mm.vit_smem_bytes(KP, Mp, G, W) <= mm.SMEM_BYTES
    assert {W for _, W, _, _, _ in plan.classes} == {1, 2, 3}


def test_plan_does_not_depend_on_batch_order(pack):
    lens, slot = batch(np.random.default_rng(6))
    rng = np.random.default_rng(7)

    def shape(perm):
        plan = mm.vit_plan(lens[perm], slot[perm], pack)
        return [((c, m, M, n), tuple(lens[perm][its]))
                for _, (c, m, M, _, n), its in blocks_of(plan)]

    want = shape(np.arange(len(lens)))
    for perm in (np.argsort(lens, kind="stable"),
                 np.argsort(-lens, kind="stable"),
                 rng.permutation(len(lens))):
        assert shape(perm) == want


def plan_by_loops(lens, slot, pack, sms=0):
    """vit_plan written as loops over classes, models and blocks: the
    reference the numpy version is held to."""
    mp_of, local_of = pack.slot_class
    item_mp, item_local = mp_of[slot], local_of[slot]
    present = [Mp for Mp in pack.classes if (item_mp == Mp).any()]
    warps = mm.vit_block_warps([pack.classes[Mp].P for Mp in present])
    Gs = {Mp: warps // pack.classes[Mp].W for Mp in present}
    if sms and len(slot) < 4 * sms:
        Gs = {Mp: min(G, -(-len(slot) // sms)) for Mp, G in Gs.items()}
    rows_cls, blocks = [], []
    for ci, Mp in enumerate(present):
        c = pack.classes[Mp]
        rows_cls.append([c.tab.data_ptr(), c.scal.data_ptr(), c.P, c.W, Mp,
                         Gs[Mp], pack.Kp, 0, 1, 0])
        rows = np.nonzero(item_mp == Mp)[0]
        for m in np.unique(item_local[rows]):
            r = rows[item_local[rows] == m]
            r = r[np.lexsort((r, -lens[r]))]
            for f in range(0, len(r), Gs[Mp]):
                part = r[f:f + Gs[Mp]]
                blocks.append(((-Mp * lens[part[0]], -Mp, m, f),
                               (ci, m, pack.M[c.models[m]]), part))
    blocks.sort(key=lambda x: x[0])
    brows, items, at = [], [], 0
    for _, (ci, m, M), part in blocks:
        brows.append((ci, m, M, at, len(part)))
        items.append(part)
        at += len(part)
    return np.concatenate([np.asarray(rows_cls, np.int64).reshape(-1),
                           np.asarray(brows, np.int64).reshape(-1),
                           np.concatenate(items).astype(np.int64)])


@pytest.mark.parametrize("sms", [0, 132])
def test_plan_equals_the_loop_version(pack, sms):
    rng = np.random.default_rng(10)
    one = vit_model(409, rng).as_pack()
    for trial in range(40):
        n = int(rng.integers(1, 700))
        lens = rng.integers(0, 30 if trial % 3 == 0 else 900, n)  # ties
        for pk, slot in ((pack, rng.integers(0, len(MS), n)),
                         (pack, rng.integers(0, 2, n)),
                         (one, np.zeros(n, int))):
            want = plan_by_loops(lens, slot, pk, sms)
            assert np.array_equal(mm.vit_plan(lens, slot, pk, sms).table,
                                  want)


def test_a_small_batch_spreads_over_the_card(pack):
    """Fewer ORFs than four an SM: at most ceil(n / sms) a block."""
    rng = np.random.default_rng(11)
    slot = np.full(300, 3)
    plan = mm.vit_plan(rng.integers(1, 500, 300), slot, pack, sms=132)
    assert plan.classes[0][3] == 3 and plan.warps == 3
    assert plan.nblk == 100
    big = mm.vit_plan(rng.integers(1, 500, 600), np.full(600, 3), pack,
                      sms=132)
    assert big.classes[0][3] == 8 and big.warps == 8


def test_one_model_and_empty_plans():
    rng = np.random.default_rng(8)
    p = vit_model(1100, rng)
    lens = rng.integers(0, 3000, 9)
    plan = mm.vit_plan(lens, np.zeros(9, int), p.as_pack())
    P, W, Mp = loader.vit_layout(1100)
    assert (P, W, Mp) == (17, 3, 1632)
    assert plan.classes == [(P, W, Mp, 5, lens.max())]
    assert plan.table[0] == p.as_pack().classes[Mp].tab.data_ptr()
    assert p.as_pack() is p.as_pack()
    assert list(lens[plan.items]) == sorted(lens)[::-1]
    empty = mm.vit_plan(np.zeros(0, int), np.zeros(0, int), p.as_pack())
    assert (empty.ncls, empty.nblk, len(empty.table)) == (0, 0, 0)


def test_a_model_past_shared_memory_is_refused():
    """No model length is refused (the name is from when M > 2720 was):
    a block holds its model's table as int16 words up to M = 2720 (five
    warps of 17 lanes, 201 KB); past it (six: 241 KB) the class reads a
    copy of the table in the kernel's layout from global memory, whose
    address is the class row's word 7."""
    rng = np.random.default_rng(9)
    p = vit_model(2720, rng)
    plan = mm.vit_plan(np.array([10]), np.zeros(1, int), p.as_pack())
    assert plan.classes[0][:4] == (17, 5, 2720, 3)
    assert plan.table[7] == 0
    for M in (2721, 3000):
        pk = vit_model(M, rng).as_pack()
        plan = mm.vit_plan(np.array([10, 30]), np.zeros(2, int), pk)
        (c,) = pk.classes.values()
        assert plan.classes[0][:4] == (17, 6, 3264, 2)
        assert mm.vit_smem_bytes(KP, 3264, 2, 6) > mm.SMEM_BYTES
        assert plan.table[7] == c.glob.data_ptr() != 0
        assert c.glob.shape == (1, mm.vit_table_bytes(KP, 3264))
    # the copy is the layout the kernel stages: transition pairs, then
    # the match words, each row warp-transposed
    tab = c.tab[0].to(torch.int64).numpy() & 0xFFFF
    lanes = mm.warp_lanes(3264, 17)
    words = c.glob[0].numpy()
    pairs = words[:16 * 3264].view(np.uint32).reshape(4, 3264)
    for q in range(4):
        assert np.array_equal(pairs[q] & 0xFFFF, tab[KP + 2 * q, lanes])
        assert np.array_equal(pairs[q] >> 16, tab[KP + 2 * q + 1, lanes])
    match = words[16 * 3264:16 * 3264 + 2 * KP * 3264].view(np.uint16)
    assert np.array_equal(match.reshape(KP, 3264), tab[:KP, lanes])


def int32_table(p, Mp):
    t = np.full((p.Kp + 8, Mp), tv.NEG, np.int32)
    t[:p.Kp, :p.M] = p.rwv.numpy()
    t[p.Kp:, :p.M] = p.tr.numpy()
    return t


@pytest.mark.parametrize("M", [60, 400, 1100])
def test_int16_table_equals_the_int32_words(M):
    rng = np.random.default_rng(M)
    p = vit_model(M, rng, lo=-32768)
    Mp = loader.vit_layout(M)[2]
    tab = p.table(Mp)
    assert tab.dtype == torch.int16 and tab.shape == (KP + 8, Mp)
    assert np.array_equal(tab.numpy().astype(np.int32), int32_table(p, Mp))


@pytest.mark.parametrize("where", ["match", "transition"])
def test_a_word_out_of_int16_range_is_refused(where):
    rng = np.random.default_rng(12)
    rwv = rng.integers(-100, 100, (KP, 50))
    tr = rng.integers(-100, 0, (8, 50))
    if where == "match":
        rwv[3, 7] = 32768
    else:
        tr[tv.R_MI, 9] = -32769
    with pytest.raises(ValueError, match="int16"):
        tv.VitParams.from_arrays(rwv, tr, 195, -300, -300)
