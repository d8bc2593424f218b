"""The SSV capture's launch plan (bath_tpu_torch/ops/multimodel.py
ssv_plan, ssv_order, ssv_blocks): MSV's class row of the one model, the
ORFs longest first by a sort on the lengths' device, dealt round the
blocks so that block k starts with the k-th longest (blocks heaviest
first); the kernel, csrc/ssv_capture.cu, reads MSV's table.

The plan is host code, so it is held here on the CPU, on MSV parameters
of random bytes (the plan reads only their shapes and addresses); the
kernel that reads it is held on the card in test_torch_cuda.py and
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from bath_tpu_torch.ops import multimodel as mm
from bath_tpu_torch.ops import ssv as ts
from bath_tpu_torch.ops.kernels import loader
from torch_threads import one_torch_thread  # noqa: F401

KP = 29


def msv_model(M, rng):
    return ts.MSVParams.from_arrays(rng.integers(-128, 128, (KP, M)),
                                    rng.integers(0, 256, (KP, M)),
                                    190, 30, 10, 20)


def blocks_of(plan):
    """[(class, model, M, items)] in launch order."""
    return [(c, m, M, plan.items[f:f + n]) for c, m, M, f, n in plan.blocks]


def dealt_blocks(order, groups, blocks):
    """[ORFs of block k] as the kernel deals the ranks: block k's group g
    takes the ORF of rank g * blocks + k (csrc/ssv_capture.cu)."""
    return [[int(order[g * blocks + k]) for g in range(groups)
             if g * blocks + k < len(order)] for k in range(blocks)]


@pytest.mark.parametrize("sms", [0, 132])
def test_orfs_longest_first_and_blocks_heaviest_first(sms):
    rng = np.random.default_rng(1)
    p = msv_model(400, rng)
    lens = rng.integers(0, 900, 4096)
    lens[100:140] = 321                  # ties
    plan = mm.ssv_plan(p.as_pack())
    G, blocks = mm.ssv_blocks(len(lens), int(plan.table[5]), sms)
    assert (G, blocks, plan.warps) == (8, 512, 8)
    order = mm.ssv_order(torch.from_numpy(lens)).numpy()
    # every ORF longest first over the whole batch, ties by row
    assert np.array_equal(order, np.lexsort((np.arange(len(lens)), -lens)))
    got = dealt_blocks(order, G, blocks)
    assert sorted(sum(got, [])) == list(range(len(lens)))
    heads = []
    for items in got:
        assert 1 <= len(items) <= G
        assert list(lens[items]) == sorted(lens[items], reverse=True)
        heads.append(lens[items[0]])
    assert heads == sorted(heads, reverse=True)
    # the 512 longest ORFs head a block each
    assert sorted(o for items in got for o in items[:1]) == \
        sorted(order[:blocks].tolist())


def test_a_single_model_call_has_a_plan_of_one_class():
    """MSV's class row alone (no block rows), of MSV's layout
    (msv_layout), the table staged in shared memory where it fits; S = 1
    up to a block of 32 warps of 33 lanes, segments past it."""
    rng = np.random.default_rng(2)
    for M in (100, 400, 1500, 4200, 20000, 40000):
        p = msv_model(M, rng)
        plan = mm.ssv_plan(p.as_pack())
        assert (plan.ncls, plan.nblk, len(plan.table)) == (1, 0, mm.PLAN_CLS)
        row = plan.table
        P, W, Mp = loader.msv_layout(M)
        assert tuple(row[2:5]) == (P, W, Mp)
        assert row[0] == p.as_pack().classes[Mp].tab.data_ptr()
        assert row[8] == loader.segments(P, W, Mp) == (1 if M < 33792 else
                                                        row[8]) >= 1
        assert (row[8] > 1) == (M == 40000)
        # MSV's table fits a block's shared memory to M ~ 3900
        assert row[7] == int(M < 4200)
        if M < 33792:
            assert np.array_equal(row, mm.msv_plan(None, None,
                                                   p.as_pack()).table)


def test_a_small_batch_spreads_over_the_sms():
    """Fewer ORFs than four an SM: blocks of ceil(ORFs / SMs) groups, so
    that each ORF's warp has a scheduler to itself; more: the class
    row's G, as many blocks as that takes."""
    assert mm.ssv_blocks(50, 8, 132) == (1, 50)
    assert mm.ssv_blocks(300, 8, 132) == (3, 100)
    assert mm.ssv_blocks(4096, 8, 132) == (8, 512)
    assert mm.ssv_blocks(50, 8) == (8, 7)
    assert mm.ssv_blocks(50, 1, 132) == (1, 50)


def family_plan(kind, pack, lens, slot):
    """<kind>'s plan of a batch over <pack>."""
    if kind == "fwd":
        return mm.fwd_plan(lens, slot, pack)
    if kind == "domdec":
        return mm.domdec_plan(lens, slot, pack)
    if kind.startswith("fs3"):
        return mm.fs3_plan(lens, slot, pack, 2 if kind == "fs3_domdec" else 1)
    return {"msv": mm.msv_plan, "vit": mm.vit_plan}[kind](lens, slot, pack)


def family_pack(kind, Ms, rng):
    """A pack of models of lengths <Ms> for <kind>'s plan, of random
    words (the plans read only the shapes)."""
    from bath_tpu_torch.ops import fwd as tf
    from bath_tpu_torch.ops import vit as tv
    if kind in ("fwd", "domdec"):
        pack = mm.build_fwd_pack([tf.ProfileTensors(
            torch.rand(KP, M), torch.rand(8, M)) for M in Ms])
        return pack.with_layout(loader.fwd_layout) if kind == "fwd" else pack
    if kind.startswith("fs3"):
        return mm.build_fs3_pack([tf.ProfileTensors(
            torch.rand(mm.FS3_ROWS, M), torch.rand(8, M)) for M in Ms])
    if kind == "msv":
        return mm.build_msv_pack([msv_model(M, rng) for M in Ms])
    return mm.build_vit_pack([tv.VitParams.from_arrays(
        rng.integers(-3000, 200, (KP, M)), rng.integers(-3000, 0, (8, M)),
        195, -300, -300) for M in Ms])


@pytest.mark.parametrize("kind", ["msv", "vit", "fwd", "domdec", "fs3",
                                  "fs3_domdec"])
def test_the_one_model_plan_equals_the_general_one(kind):
    """_plan's one-model table (no sorts over classes and models) equals
    its general one, in every family that takes it: a batch of the
    second model of a pack against the same batch with one item of the
    first model (of the same class) added, whose blocks, the second
    model's in order, hold the same items."""
    rng = np.random.default_rng(4)
    pack = family_pack(kind, (300, 400), rng)
    for trial in range(20):
        n = int(rng.integers(1, 500))
        lens = rng.integers(0, 30 if trial % 2 else 900, n)
        one = family_plan(kind, pack, lens, np.ones(n, int))
        mixed = family_plan(kind, pack, np.r_[lens, 5],
                            np.r_[np.ones(n, int), 0])
        assert np.array_equal(one.table[:mm.PLAN_CLS],
                              mixed.table[:mm.PLAN_CLS])
        theirs = [(m, M, it) for c, m, M, it in blocks_of(mixed) if M == 400]
        assert [(m, M, list(it)) for c, m, M, it in blocks_of(one)] == \
            [(m, M, list(it)) for m, M, it in theirs]


def test_the_capture_launch_raises_on_a_cpu_tensor():
    """The card's entry takes CUDA tensors only; a CPU tensor runs the
    plain version through the wrapper (ops/ssv.py ssv_capture)."""
    rng = np.random.default_rng(5)
    p = msv_model(60, rng)
    flat, offs, lens = (torch.from_numpy(a) for a in ts.pack_stream(
        [rng.integers(0, 20, 40).astype(np.int8)]))
    tjb = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        loader.prepare_ssv_capture(flat, offs, lens, tjb, tjb, p)
    before = ts.ssv_capture.launches
    got = ts.ssv_capture(flat, offs, lens, tjb, tjb, p)
    assert ts.ssv_capture.launches == before
    want = ts.ssv_capture_ref(flat, offs, lens, tjb, tjb, p)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
