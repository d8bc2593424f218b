"""MSV's int16 tables and its launch plan (bath_tpu_torch/ops/ssv.py
MSVParams.table and kernel_table; ops/multimodel.py msv_plan): each
lane's SSV byte and MSV cost in one int16 word, stored warp-transposed
for the kernel; every padded width of a call in one launch, blocks
heaviest first (Mp x longest item), each model's table in shared memory
where it fits and read from global memory past it (M = 4200: eight
warps of 17 lanes, 252 KB); a
single-model call planned as its class row alone.

Host code, held here on the CPU on random bytes; the kernel that reads
the plan is held on the card in test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from bath_tpu_torch.ops import multimodel as mm
from bath_tpu_torch.ops import ssv as ts
from bath_tpu_torch.ops.kernels import loader
from torch_threads import one_torch_thread  # noqa: F401

KP = 29
# padded widths 96, 160, 288, 416, 800, 1056 (one warp of 3 .. 33
# lanes), 1632 (three warps of 17) and 4352 (eight: past shared memory)
MS = (60, 150, 250, 400, 700, 1000, 1100, 4200, 90)


def msv_model(M, rng):
    return ts.MSVParams.from_arrays(rng.integers(-128, 128, (KP, M)),
                                    rng.integers(0, 256, (KP, M)),
                                    base=190, tec=3, tbm=12, bias=19)


@pytest.fixture(scope="module")
def pack():
    rng = np.random.default_rng(3)
    return mm.build_msv_pack([msv_model(M, rng) for M in MS])


def int32_words(p, Mp):
    """The int32 word a lane held before (SSV byte in bits 0-7, MSV cost
    in bits 8-15; 127 and 255 past the model)."""
    s = np.full((KP, Mp), 127, np.int32)
    r = np.full((KP, Mp), 255, np.int32)
    s[:, :p.M] = p.sbv.numpy()
    r[:, :p.M] = p.rbv.numpy()
    return (s & 0xFF) | (r << 8)


@pytest.mark.parametrize("M", [60, 400, 1100, 4200])
def test_int16_table_equals_the_int32_words(M):
    rng = np.random.default_rng(M)
    p = msv_model(M, rng)
    P, _, Mp = loader.msv_layout(M)
    tab = p.table(Mp)
    assert tab.dtype == torch.int16 and tab.shape == (KP, Mp)
    words = int32_words(p, Mp)
    assert np.array_equal(tab.numpy().view(np.uint16).astype(np.int32),
                          words)
    # the kernel's copy: each row warp-transposed, thread t's lane j at
    # 32j + t of its warp's span
    kt = p.kernel_table(Mp, P).numpy().view(np.uint16)
    lanes = mm.warp_lanes(Mp, P)
    assert sorted(lanes) == list(range(Mp))
    assert np.array_equal(kt, words[:, lanes])
    for x in {0, 1, 31, 32, 32 * P - 1, min(32 * P, Mp - 1), Mp - 1}:
        w, r = divmod(x, 32 * P)
        assert lanes[x] == w * 32 * P + (r % 32) * P + r // 32
    assert p.kernel_table(Mp, P) is p.kernel_table(Mp, P)


@pytest.mark.parametrize("where", ["ssv", "msv"])
def test_a_word_out_of_range_is_refused(where):
    rng = np.random.default_rng(12)
    sbv = rng.integers(-128, 128, (KP, 50))
    rbv = rng.integers(0, 256, (KP, 50))
    if where == "ssv":
        sbv[3, 7] = 128
    else:
        rbv[9, 2] = 256
    with pytest.raises(ValueError, match="int16"):
        ts.MSVParams.from_arrays(sbv, rbv, 190, 3, 12, 19)
    rbv[9, 2] = -1
    sbv[3, 7] = 0
    with pytest.raises(ValueError, match="int16"):
        ts.MSVParams.from_arrays(sbv, rbv, 190, 3, 12, 19)


def rows_of(plan):
    return plan.table[:mm.PLAN_CLS * plan.ncls].reshape(-1, mm.PLAN_CLS)


def test_plan_invariants(pack):
    """Every item once; each block one model of one class, at most G
    items, longest first; blocks heaviest first; the plan does not
    depend on the batch's order; every class's table in shared memory
    but M = 4200's (4352 lanes: 252 KB), read from global memory."""
    rng = np.random.default_rng(1)
    n = 300
    slot = rng.integers(0, len(MS), n)
    slot[:len(MS)] = np.arange(len(MS))
    lens = rng.integers(0, 400, n)
    lens[40:50] = 200                  # ties
    plan = mm.msv_plan(lens, slot, pack)
    assert np.array_equal(np.sort(plan.items), np.arange(n))
    rows = rows_of(plan)
    assert plan.ncls == len(MS) - 1 and plan.warps == 12
    heads = []
    for c, m, M, first, count in plan.blocks:
        _, _, P, W, Mp, G, Kp, staged, S, scratch = rows[c]
        assert (S, scratch) == (1, 0)
        cls = pack.classes[Mp]
        assert rows[c][0] == cls.tab.data_ptr()
        assert rows[c][1] == cls.scal.data_ptr()
        assert 1 <= count <= G and G * W <= plan.warps
        items = plan.items[first:first + count]
        assert {cls.models[m]} == set(slot[items]) and M == MS[cls.models[m]]
        assert list(lens[items]) == sorted(lens[items], reverse=True)
        heads.append(Mp * lens[items[0]])
        fits = 2 * Kp * Mp + 16 * G * W <= mm.SMEM_BYTES
        assert staged == int(fits) == int(Mp != 4352)
    assert heads == sorted(heads, reverse=True)
    perm = rng.permutation(n)
    moved = mm.msv_plan(lens[perm], slot[perm], pack)
    assert list(zip(slot[plan.items], lens[plan.items])) == \
        list(zip(slot[perm][moved.items], lens[perm][moved.items]))
    # the stacks: each class's kernel tables, each model's scalars
    for Mp, cls in pack.classes.items():
        assert cls.tab.shape == (len(cls.models), KP, Mp)
        assert cls.tab.dtype == torch.int16
        for i, g in enumerate(cls.models):
            assert torch.equal(cls.tab[i], pack.params[g].kernel_table(
                Mp, cls.P))
            assert cls.scal[i].tolist() == [MS[g], 190, 3, 12, 19]


def test_narrow_calls_take_the_small_instance(pack):
    """A launch of models up to 13 lanes a thread takes the 8-warp
    instance; one past 12 warps an item the 32-warp one."""
    slot = np.array([0, 1, 2, 3, 8])
    plan = mm.msv_plan(np.full(5, 50), slot, pack)
    assert plan.warps == 8 and all(r[5] == 8 for r in rows_of(plan))
    assert mm.msv_block_warps([33], [13]) == 32
    rng = np.random.default_rng(2)
    wide = mm.build_msv_pack([msv_model(14000, rng)])
    plan = mm.msv_plan(np.array([3]), np.zeros(1, int), wide)
    assert plan.warps == 32 and rows_of(plan)[0][[2, 3, 5, 7]].tolist() \
        == [17, 26, 1, 0]


def test_a_single_model_call_builds_no_per_item_table():
    """A flush of 65 536 ORFs under one model: its plan is the class row
    alone, made once per parameter set (the kernel's blocks stride over
    the items in batch order), so the host builds nothing per item."""
    rng = np.random.default_rng(4)
    p = msv_model(400, rng)
    plan = mm.msv_plan(None, None, p.as_pack())
    assert (plan.ncls, plan.nblk, len(plan.table)) == (1, 0, mm.PLAN_CLS)
    assert plan.table.tolist()[2:] == [13, 1, 416, 8, KP, 1, 1, 0]
    assert plan.table[0] == p.as_pack().classes[416].tab.data_ptr()
    assert p.as_pack() is p.as_pack()
    # loader caches it on the parameters: one upload, none per call
    made = []
    cached = [loader._single(p, ("msv", "cpu"),
                             lambda: made.append(1) or plan)
              for _ in range(3)]
    assert len(made) == 1 and cached[0] is cached[2]
    assert cached[0][1][2:] == (1, 0, 8)
    empty = mm.msv_plan(np.zeros(0, int), np.zeros(0, int), p.as_pack())
    assert (empty.ncls, empty.nblk) == (0, 0)


@pytest.mark.parametrize("M, want", [(17408, (17, 32, 17408)),
                                     (17409, (33, 17, 17952)),
                                     (33792, (33, 32, 33792))])
def test_the_ladder_runs_to_a_block_of_32_warps(M, want):
    """Warps of 17 lanes up to a block of 32 (M = 17408), warps of 33
    beyond, up to 32 again (M = 33792); one model past that takes a
    segmented group of 16 warps (six segments of 13 lanes a thread),
    neither a ValueError nor a failed launch."""
    assert loader.msv_layout(M) == want
    assert loader.fwd_layout(M) == want
    rng = np.random.default_rng(M)
    plan = mm.msv_plan(np.array([7]), np.zeros(1, int),
                       mm.build_msv_pack([msv_model(M, rng)]))
    assert plan.warps == 32
    assert rows_of(plan)[0][[2, 3, 4, 5, 7]].tolist() == [*want, 1, 0]
    if M == 33792:
        assert loader.msv_layout(M + 1) == (13, 16, 39936)
        plan = mm.msv_plan(np.array([7]), np.zeros(1, int),
                           mm.build_msv_pack([msv_model(M + 1, rng)]))
        assert plan.warps == 16
        assert rows_of(plan)[0][[2, 3, 4, 5, 7, 8]].tolist() == \
            [13, 16, 39936, 1, 0, 6]
