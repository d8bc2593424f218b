"""Decoding as two passes at once (bath_tpu_torch/ops/domdec.py
domdec_passes_ref, finish_passes) and its launch plan
(ops/multimodel.py domdec_plan): an ORF's Forward and Backward in two
groups of their own, every padded width of a call in one launch, blocks
longest ORF first, a small batch spread over the card.

The combine of the two passes' specials is held against the fused plain
version (domdec_ref) and against the JAX package's jnp kernel
(_domdec_mb_impl through domdec_mb_batch) on the CPU; the plan, host
code, on packs of random tables with models of seven padded widths, one
to three warps an ORF.  The kernel that reads both is held on the card
in test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from bath_tpu.ops.jaxk import kernels as jk
from bath_tpu_torch import fixtures
from bath_tpu_torch.ops import domdec as td
from bath_tpu_torch.ops import multimodel as mm
from bath_tpu_torch.ops.fwd import ProfileTensors
from bath_tpu_torch.ops.kernels import loader
from torch_threads import one_torch_thread  # noqa: F401

TOL = 5e-4                  # tests/test_torch_domdec.py's, against the JAX kernel
SPLIT_TOL = 1e-5            # the split against the fused plain version


def decode_case(M, B=6, Lmax=300, seed=5):
    hmm, q = fixtures.make_query(M, np.random.default_rng(seed),
                                 calibrate=False)
    om = fixtures.search_profile(hmm)
    dsq, lens = fixtures.kernel_batch(q, B, Lmax,
                                      np.random.default_rng(seed + 1))
    return om, dsq, lens


@pytest.mark.parametrize("M", [60, 400, 1100])
def test_finish_of_the_passes_equals_the_fused_plain_version(M):
    """M = 1100 takes two warps an ORF on the card."""
    om, dsq, lens = decode_case(M)
    p = td.domdec_params(om)
    d, ln = torch.from_numpy(dsq), torch.from_numpy(lens)
    want = td.domdec_ref(d, ln, p)
    fspec, bspec, logz2 = td.domdec_passes_ref(d, ln, p)
    got = td.finish_passes(fspec, bspec, ln, logz2)
    assert torch.equal(got[3], want[3]) and bool(want[3].all())
    for a, b in zip(got[:3], want[:3]):
        assert float((a - b).abs().max()) <= SPLIT_TOL
    assert 1 in lens


def test_the_passes_specials_have_the_kernels_layout():
    """Rows past an item's length are zero in both passes; row len of
    the backward is its start (xC = pmove, xE = pmove/2), row 0 of the
    forward N = 1, B = pmove; logZ the fused version's."""
    om, dsq, lens = decode_case(120, B=5, Lmax=90, seed=9)
    p = td.domdec_params(om)
    d, ln = torch.from_numpy(dsq), torch.from_numpy(lens)
    fspec, bspec, logz2 = td.domdec_passes_ref(d, ln, p)
    L = dsq.shape[1]
    assert fspec.shape == bspec.shape == (5, 6, L + 1)
    pmove = td.length_model(ln, 1.0)[0].numpy()
    for b, n in enumerate(lens):
        assert not fspec[b, :, n + 1:].any() and not bspec[b, :, n + 1:].any()
        assert float(bspec[b, 3, n]) == float(pmove[b])
        assert float(bspec[b, 4, n]) == float(pmove[b]) * 0.5
        assert float(fspec[b, 1, 0]) == 1.0
        assert float(fspec[b, 0, 0]) == float(pmove[b])
        assert float(logz2[b, 1]) == float(fspec[b, 5, n])
    assert torch.isfinite(logz2).all()


@pytest.mark.parametrize("M", [60, 400])
def test_finish_of_the_passes_vs_jnp_kernel(M):
    om, dsq, lens = decode_case(M, B=6, Lmax=420, seed=M)
    d, ln = torch.from_numpy(dsq), torch.from_numpy(lens)
    fspec, bspec, logz2 = td.domdec_passes_ref(d, ln, td.domdec_params(om))
    got = td.finish_passes(fspec, bspec, ln, logz2)
    bt, et, mo, ok = (x.numpy() for x in got)
    jbt, jet, jmo, jok = (np.asarray(x) for x in jk.domdec_mb_batch(
        dsq.astype(np.int32), lens, jk.domdec_params(om), nj=1.0))
    assert ok.all() and np.array_equal(ok, jok)
    for b, L in enumerate(lens):
        n = int(L) + 1
        assert np.abs(bt[b, :n] - jbt[b, :n]).max() < TOL
        assert np.abs(et[b, :n] - jet[b, :n]).max() < TOL
        assert np.abs(mo[b, :n] - jmo[b, :n]).max() < TOL


# ---------------------------------------------------------------------
# domdec_plan: padded widths 96, 160, 288, 416, 544, 800, 1056 (one warp)
# and 2112, 3168 (two and three warps of 33 lanes)
# ---------------------------------------------------------------------
MS = (60, 150, 250, 400, 520, 700, 1000, 1100, 2500, 90)


def profile(M, rng):
    return ProfileTensors(torch.from_numpy(rng.random((29, M), np.float32)),
                          torch.from_numpy(rng.random((8, M), np.float32)))


@pytest.fixture(scope="module")
def pack():
    rng = np.random.default_rng(3)
    return mm.build_domdec_pack([profile(M, rng) for M in MS])


def batch(rng, n=71):
    slot = rng.integers(0, len(MS), n)
    slot[:20] = 7                    # one model's run spans blocks
    lens = rng.integers(0, 900, n)
    lens[20:26] = 432                # ties
    return lens, slot


def blocks_of(plan):
    return [(plan.table[mm.PLAN_CLS * c:mm.PLAN_CLS * (c + 1)], (c, m, M, f, n),
             plan.items[f:f + n]) for c, m, M, f, n in plan.blocks]


def test_every_orf_once_a_pass(pack):
    lens, slot = batch(np.random.default_rng(1))
    plan = mm.domdec_plan(lens, slot, pack)
    assert np.array_equal(np.sort(plan.items), np.arange(2 * len(slot)))
    assert plan.blocks[:, 4].sum() == 2 * len(slot)
    assert np.array_equal(plan.blocks[:, 3],
                          np.r_[0, np.cumsum(plan.blocks[:-1, 4])])


def test_every_group_holds_one_model_of_one_class(pack):
    lens, slot = batch(np.random.default_rng(2))
    plan = mm.domdec_plan(lens, slot, pack)
    mp_of, local_of = pack.slot_class
    for crow, (c, m, M, _, n), its in blocks_of(plan):
        P, W, Mp, G, Kp, fits = (int(v) for v in crow[2:8])
        cls = pack.classes[Mp]
        assert 1 <= n <= G and G * W <= plan.warps and Kp == 29
        assert crow[0] == cls.etab.data_ptr() and \
            crow[1] == cls.ttab.data_ptr()
        assert M == MS[cls.models[m]]
        assert fits == (mm.dd_table_bytes(29, Mp) + G * 32 * W
                        <= mm.SMEM_BYTES)
        b = its // 2
        assert set(slot[b]) == {cls.models[m]}
        assert set(mp_of[slot[b]]) == {Mp} and set(local_of[slot[b]]) == {m}


def test_blocks_go_longest_orf_first(pack):
    lens, slot = batch(np.random.default_rng(4))
    plan = mm.domdec_plan(lens, slot, pack)
    heads = [lens[its[0] // 2] for _, _, its in blocks_of(plan)]
    assert heads == sorted(heads, reverse=True)
    pos = np.empty(len(plan.items), int)
    pos[plan.items] = np.arange(len(plan.items))
    assert (pos[1::2] > pos[0::2]).all()     # an ORF's Backward after its Forward


def test_class_descriptors_match_the_layout(pack):
    lens, slot = batch(np.random.default_rng(5))
    slot[-len(MS):] = np.arange(len(MS))
    plan = mm.domdec_plan(lens, slot, pack)
    assert plan.ncls == 9 and plan.warps == 6
    fits = []
    for c, (P, W, Mp, G, _) in enumerate(plan.classes):
        assert (P, W, Mp) == loader.layout(MS[pack.classes[Mp].models[0]])
        assert G == 6 // W
        fits.append(int(plan.table[mm.PLAN_CLS * c + 7]))
    # the tables of one warp's models fit a block; past it they are read
    # from global memory
    assert fits == [1] * 7 + [0, 0]


def test_plan_does_not_depend_on_batch_order(pack):
    lens, slot = batch(np.random.default_rng(6))
    rng = np.random.default_rng(7)

    def shape(perm):
        plan = mm.domdec_plan(lens[perm], slot[perm], pack, sms=132)
        return [((c, m, M, n), tuple(lens[perm][its // 2]), tuple(its % 2))
                for _, (c, m, M, _, n), its in blocks_of(plan)]

    want = shape(np.arange(len(lens)))
    for perm in (np.argsort(lens, kind="stable"),
                 np.argsort(-lens, kind="stable"),
                 rng.permutation(len(lens))):
        assert shape(perm) == want


def plan_by_loops(lens, slot, pack, sms):
    """domdec_plan written as loops: the reference the numpy version is
    held to."""
    mp_of, local_of = pack.slot_class
    item_mp, item_local = mp_of[slot], local_of[slot]
    present = [Mp for Mp in pack.classes if (item_mp == Mp).any()]
    warps = mm.dd_block_warps([pack.classes[Mp].W for Mp in present])
    rows_cls, blocks = [], []
    for ci, Mp in enumerate(present):
        c = pack.classes[Mp]
        G = warps // c.W
        fits = mm.dd_table_bytes(pack.Kp, Mp) + G * 32 * c.W <= mm.SMEM_BYTES
        if sms and 2 * len(slot) < 4 * sms:
            G = min(G, -(-2 * len(slot) // sms))
        rows_cls.append([c.etab.data_ptr(), c.ttab.data_ptr(), c.P, c.W, Mp,
                         G, pack.Kp, int(fits), 1, 0])
        rows = np.nonzero(item_mp == Mp)[0]
        for m in np.unique(item_local[rows]):
            r = rows[item_local[rows] == m]
            r = r[np.lexsort((r, -lens[r]))]
            its = (r[:, None] * 2 + np.arange(2)).ravel()
            for f in range(0, len(its), G):
                part = its[f:f + G]
                blocks.append(((-lens[part[0] // 2], -Mp, m, f),
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
    one = mm.OneModel(profile(409, rng), loader.layout)
    for trial in range(40):
        n = int(rng.integers(1, 400))
        lens = rng.integers(0, 40 if trial % 3 == 0 else 2000, n)  # ties
        for pk, slot in ((pack, rng.integers(0, len(MS), n)),
                         (pack, rng.integers(0, 2, n)),
                         (one, np.zeros(n, int))):
            want = plan_by_loops(lens, slot, pk, sms)
            assert np.array_equal(mm.domdec_plan(lens, slot, pk, sms).table,
                                  want)


def test_a_small_batch_spreads_over_the_card():
    """128 ORFs (256 groups) on 132 SMs: two groups a block, 128 blocks;
    500 ORFs keep eight a block."""
    rng = np.random.default_rng(8)
    one = mm.OneModel(profile(400, rng), loader.layout)
    lens = rng.integers(100, 600, 128)
    plan = mm.domdec_plan(lens, np.zeros(128, int), one, sms=132)
    assert plan.classes[0][3] == 2 and plan.warps == 2 and plan.nblk == 128
    assert [sorted(its % 2) for _, _, its in blocks_of(plan)] == \
        [[0, 1]] * 128                      # an ORF's two passes a block
    big = mm.domdec_plan(rng.integers(100, 600, 500), np.zeros(500, int),
                         one, sms=132)
    assert big.classes[0][3] == 8 and big.warps == 8


def test_one_model_and_empty_plans():
    rng = np.random.default_rng(12)
    p = profile(1100, rng)
    lens = rng.integers(0, 3000, 9)
    plan = mm.domdec_plan(lens, np.zeros(9, int),
                          mm.OneModel(p, loader.layout))
    P, W, Mp = loader.layout(1100)
    assert plan.classes == [(P, W, Mp, 4, lens.max())]
    assert plan.table[0] == p.padded(Mp)[0].data_ptr()
    assert [lens[i // 2] for i in plan.items[::2]] == sorted(lens)[::-1]
    empty = mm.domdec_plan(np.zeros(0, int), np.zeros(0, int),
                           mm.OneModel(p, loader.layout))
    assert (empty.ncls, empty.nblk, len(empty.table)) == (0, 0, 0)
