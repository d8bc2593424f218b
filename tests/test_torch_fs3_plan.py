"""The fs3 pair's launch plan (bath_tpu_torch/ops/multimodel.py
fs3_plan): every padded width of a call in one launch, the blocks
longest window first, decoding's two passes as items of their own.

The plan is host code, so it is held here on the CPU, on packs of
random tables (the plan reads only their shapes and addresses) with
models of six padded widths, one to three warps a window; the kernels
that read it are held on the card in test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from bath_tpu_torch.ops import multimodel as mm
from bath_tpu_torch.ops.fwd import ProfileTensors
from bath_tpu_torch.ops.kernels import loader
from torch_threads import one_torch_thread  # noqa: F401

# padded widths 96, 160, 288, 416, 832 and 1248: W = 1, 2 and 3
MS = (60, 150, 250, 400, 700, 1100, 90, 1000)
PASSES = {"gate": 1, "decoding": 2}


def profile(M, rng):
    return ProfileTensors(torch.from_numpy(rng.random((338, M), np.float32)),
                          torch.from_numpy(rng.random((8, M), np.float32)))


@pytest.fixture(scope="module")
def pack():
    rng = np.random.default_rng(3)
    return mm.build_fs3_pack([profile(M, rng) for M in MS])


def batch(rng, n=61):
    slot = rng.integers(0, len(MS), n)
    slot[:20] = 5                    # one model's run spans blocks
    lens = rng.integers(0, 4000, n)
    lens[20:26] = 1234               # ties
    return lens, slot


def blocks_of(plan):
    """[(class row, block row, items)] in launch order."""
    items = plan.items
    return [(plan.table[mm.PLAN_CLS * c:mm.PLAN_CLS * (c + 1)], (c, m, M, f, n),
             items[f:f + n]) for c, m, M, f, n in plan.blocks]


@pytest.mark.parametrize("kind", ["gate", "decoding"])
def test_every_window_once_per_pass(pack, kind):
    lens, slot = batch(np.random.default_rng(1))
    passes = PASSES[kind]
    plan = mm.fs3_plan(lens, slot, pack, passes)
    items = np.sort(plan.items)
    assert np.array_equal(items, np.arange(passes * len(slot)))
    assert plan.blocks[:, 4].sum() == len(items)
    assert np.array_equal(plan.blocks[:, 3],
                          np.r_[0, np.cumsum(plan.blocks[:-1, 4])])


@pytest.mark.parametrize("kind", ["gate", "decoding"])
def test_every_group_holds_one_model_of_one_class(pack, kind):
    lens, slot = batch(np.random.default_rng(2))
    passes = PASSES[kind]
    plan = mm.fs3_plan(lens, slot, pack, passes)
    mp_of, local_of = pack.slot_class
    for crow, (c, m, M, _, n), its in blocks_of(plan):
        P, W, Mp, G = (int(v) for v in crow[2:6])
        cls = pack.classes[Mp]
        assert 1 <= n <= G and G * W <= plan.warps
        assert crow[0] == cls.etab.data_ptr() and \
            crow[1] == cls.ttab.data_ptr()
        assert M == MS[cls.models[m]]
        b = its // passes
        assert set(slot[b]) == {cls.models[m]}
        assert set(mp_of[slot[b]]) == {Mp} and set(local_of[slot[b]]) == {m}


def test_blocks_go_longest_window_first(pack):
    lens, slot = batch(np.random.default_rng(4))
    for passes in (1, 2):
        plan = mm.fs3_plan(lens, slot, pack, passes)
        heads = [lens[its[0] // passes] for _, _, its in blocks_of(plan)]
        assert heads == sorted(heads, reverse=True)
        for _, _, its in blocks_of(plan):
            ln = lens[its // passes]
            assert list(ln) == sorted(ln, reverse=True)
        if passes == 2:         # a window's Backward after its Forward
            pos = np.empty(len(plan.items), int)
            pos[plan.items] = np.arange(len(plan.items))
            assert (pos[1::2] > pos[0::2]).all()


def test_class_descriptors_match_fs3_layout(pack):
    lens, slot = batch(np.random.default_rng(5))
    plan = mm.fs3_plan(lens, slot, pack, 1)
    present = sorted({loader.fs3_layout(MS[g])[2] for g in slot})
    assert [Mp for _, _, Mp, _, _ in plan.classes] == present
    assert plan.ncls == len(present) == 6
    for c, (P, W, Mp, G, longest) in enumerate(plan.classes):
        assert (P, W, Mp) == loader.fs3_layout(
            MS[pack.classes[Mp].models[0]])
        row = plan.table[mm.PLAN_CLS * c:mm.PLAN_CLS * (c + 1)]
        assert list(row[2:6]) == [P, W, Mp, G]
        assert longest == lens[mp_rows(pack, slot, Mp)].max()
        need = 32 * Mp + G * mm.fs3_group_bytes(Mp, W)
        assert need <= mm.SMEM_BYTES
    assert plan.warps == 6      # groups of 1, 2 and 3 warps fill a block


def mp_rows(pack, slot, Mp):
    return np.nonzero(pack.slot_class[0][slot] == Mp)[0]


@pytest.mark.parametrize("kind", ["gate", "decoding"])
def test_plan_does_not_depend_on_batch_order(pack, kind):
    """The blocks (class, model, M, sizes, their windows' lengths) come
    out in the same order whatever the order of the batch."""
    lens, slot = batch(np.random.default_rng(6))
    passes = PASSES[kind]
    rng = np.random.default_rng(7)

    def shape(perm):
        plan = mm.fs3_plan(lens[perm], slot[perm], pack, passes)
        return [((c, m, M, n), tuple(lens[perm][its // passes]),
                 tuple(its % passes)) for _, (c, m, M, _, n), its
                in blocks_of(plan)]

    want = shape(np.arange(len(lens)))
    for perm in (np.argsort(lens, kind="stable"),
                 np.argsort(-lens, kind="stable"),
                 rng.permutation(len(lens))):
        assert shape(perm) == want


def plan_by_loops(lens, slot, pack, passes):
    """fs3_plan written as loops over classes, models and blocks: the
    reference the numpy version is held to."""
    mp_of, local_of = pack.slot_class
    item_mp, item_local = mp_of[slot], local_of[slot]
    present = [Mp for Mp in pack.classes if (item_mp == Mp).any()]
    warps = mm.fs3_block_warps([pack.classes[Mp].W for Mp in present])
    rows_cls, blocks = [], []
    for ci, Mp in enumerate(present):
        c = pack.classes[Mp]
        G = min(warps // c.W, (mm.SMEM_BYTES - 32 * Mp)
                // mm.fs3_group_bytes(Mp, c.W))
        rows_cls.append([c.etab.data_ptr(), c.ttab.data_ptr(), c.P, c.W, Mp,
                         G, 0, 0, 1, 0])
        # a launch of narrow classes only takes the direct loads
        if max(pack.classes[m].P for m in present) <= mm.FS3_DIRECT_P:
            rows_cls[-1][6] = 1
        rows = np.nonzero(item_mp == Mp)[0]
        for m in np.unique(item_local[rows]):
            r = rows[item_local[rows] == m]
            r = r[np.lexsort((r, -lens[r]))]
            its = (r[:, None] * passes + np.arange(passes)).ravel()
            for f in range(0, len(its), G):
                part = its[f:f + G]
                blocks.append(((-lens[part[0] // passes], -Mp, m, f),
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


@pytest.mark.parametrize("kind", ["gate", "decoding"])
def test_plan_equals_the_loop_version(pack, kind):
    rng = np.random.default_rng(10)
    one = mm.OneModel(profile(409, rng))
    for trial in range(40):
        n = int(rng.integers(1, 200))
        lens = rng.integers(0, 50 if trial % 3 == 0 else 5000, n)  # ties
        for pk, slot in ((pack, rng.integers(0, len(MS), n)),
                         (pack, rng.integers(0, 2, n)),
                         (one, np.zeros(n, int))):
            want = plan_by_loops(lens, slot, pk, PASSES[kind])
            assert np.array_equal(mm.fs3_plan(lens, slot, pk,
                                              PASSES[kind]).table, want)


def test_one_model_and_empty_plans():
    rng = np.random.default_rng(8)
    p = profile(1100, rng)
    lens = rng.integers(0, 3000, 9)
    plan = mm.fs3_plan(lens, np.zeros(9, int), mm.OneModel(p), 2)
    P, W, Mp = loader.fs3_layout(1100)
    assert plan.classes == [(P, W, Mp, 2, lens.max())]
    assert plan.table[0] == p.padded(Mp)[0].data_ptr()
    assert [lens[i // 2] for i in plan.items[::2]] == sorted(lens)[::-1]
    empty = mm.fs3_plan(np.zeros(0, int), np.zeros(0, int), mm.OneModel(p),
                        1)
    assert (empty.ncls, empty.nblk, len(empty.table)) == (0, 0, 0)


def test_a_model_past_shared_memory_is_refused(monkeypatch):
    """No model length is refused (the name is from when M > 3744 was):
    a block holds the model's transitions and one group's ring, and a
    ring instance takes up to eight warps of 255 registers (M = 3328);
    past that the class takes the direct loads (the class row's word 6)
    in an instance whose registers are capped, with its transitions
    staged up to M = 3744 (nine warps) and in global memory past it
    (word 7), where the ring does not fit; a group then needs only its
    exchange scratch."""
    rng = np.random.default_rng(9)
    for M, W, words in ((3328, 8, [0, 0]), (3744, 9, [1, 0]),
                        (3745, 10, [1, 1]), (4000, 10, [1, 1])):
        plan = mm.fs3_plan(np.array([10, 20]), np.zeros(2, int),
                           mm.OneModel(profile(M, rng)), 2)
        assert plan.classes[0][:4] == (13, W, 416 * W, 1)
        assert plan.warps == W and list(plan.table[6:8]) == words
        ring = 32 * 416 * W + mm.fs3_group_bytes(416 * W, W)
        assert (ring > mm.SMEM_BYTES) == bool(words[1])
    assert mm.fs3_group_bytes(4160, 10, direct=True) == 384
    # the A/B script's comparison: the direct loads with the
    # transitions staged, in a class that fits (FS3_DIRECT_P raised)
    monkeypatch.setattr(mm, "FS3_DIRECT_P", 13)
    plan = mm.fs3_plan(np.array([10]), np.zeros(1, int),
                       mm.OneModel(profile(409, rng)), 1)
    monkeypatch.undo()
    assert plan.classes[0][:4] == (13, 1, 416, 4)
    assert list(plan.table[6:8]) == [1, 0]
    # one load path a launch: with a long model, every class direct
    mixed = mm.build_fs3_pack([profile(409, rng), profile(4000, rng)])
    plan = mm.fs3_plan(np.array([10, 20]), np.array([0, 1]), mixed, 1)
    rows = plan.table[:2 * mm.PLAN_CLS].reshape(2, mm.PLAN_CLS)
    assert rows[:, 6].tolist() == [1, 1] and rows[:, 7].tolist() == [0, 1]


def test_narrow_launches_take_the_direct_loads(pack, monkeypatch):
    """A launch whose classes all take at most five lanes a thread reads
    its codon rows directly (the ring's handshake costs more there: the
    sweep in PERF.md), unless FS3_DIRECT_P is lowered (the A/B script's
    forced ring); one class of more lanes puts the launch on the ring."""
    rng = np.random.default_rng(12)
    for M, word in ((60, 1), (134, 1), (161, 0), (409, 0)):
        one = mm.OneModel(profile(M, rng))
        plan = mm.fs3_plan(np.array([30]), np.zeros(1, int), one, 1)
        assert plan.table[6] == word, M
        with monkeypatch.context() as m:
            m.setattr(mm, "FS3_DIRECT_P", 0)
            forced = mm.fs3_plan(np.array([30]), np.zeros(1, int), one, 1)
        assert forced.table[6] == 0
    narrow = [g for g, M in enumerate(MS) if M <= 160]
    wide = [g for g, M in enumerate(MS) if M > 160]
    plan = mm.fs3_plan(np.full(4, 30), np.array(narrow[:2] * 2), pack, 1)
    assert plan.ncls == 2
    assert all(plan.table[mm.PLAN_CLS * c + 6] == 1 for c in range(2))
    plan = mm.fs3_plan(np.full(2, 30), np.array([narrow[0], wide[0]]), pack,
                       1)
    assert all(plan.table[mm.PLAN_CLS * c + 6] == 0 for c in range(plan.ncls))
