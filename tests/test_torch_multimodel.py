"""bath_tpu_torch multi-model gates (ops/multimodel.py) against the JAX
package's lane-packed kernels (bath_tpu/ops/jaxk/multimodel.py) and
against the port's own single-model plain versions.

Five seeded models with M in {24, 57, 63, 100, 126} are packed into the
reference's ``build_*_pack`` at Mg = 64 and Mg = 128 (two size classes, scaled
down from its 256/512), batches mix the models' items in one call, and
the port's packs are carried across from the reference's packs as numpy
arrays.  Tolerances:

- Forward gate and fs3 gate: the packed jnp gates round emissions to
  bf16, so 0.05 nats on random inputs (the bound test_torch_fs3.py
  holds the single-model bf16 gates to); with the port fed the same
  bf16-rounded emissions the fs3 gate agrees within 0.01.
- decoding: 1e-3 on btot, etot and mocc (inside pipeline.DOMDEC_MARGIN
  = 2e-3), 5e-4 measured bound of the single-model twins; `ok`
  identical.
- the multi-model plain version equals the single-model plain version
  item by item, exactly.

The CUDA entries are held against the plain versions, and bit for bit
against the single-model entries, on the card in test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from bath_tpu.ops.jaxk import multimodel as jmm
from bath_tpu.ops.pallas.fwd import fwd_params_pallas
from bath_tpu_torch import fixtures
from bath_tpu_torch.ops import domdec as td
from bath_tpu_torch.ops import fs3 as t3
from bath_tpu_torch.ops import fs3_domdec as td3
from bath_tpu_torch.ops import fwd as tf
from bath_tpu_torch.ops import multimodel as mm
from bath_tpu_torch.ops.fwd import ProfileTensors
from torch_threads import one_torch_thread  # noqa: F401

MS = (24, 57, 63, 100, 126)
# the reference's size classes, scaled: M <= Mg - 1
CLASSES = ((64, 4), (128, 4))
BF16_TOL = 0.05
DEC_TOL = 1e-3


def class_of(M):
    return next(ci for ci, (Mg, _) in enumerate(CLASSES) if M <= Mg - 1)


@pytest.fixture(scope="module")
def models():
    """[(om, om_fs3)] of the seeded models, uncalibrated."""
    rng = np.random.default_rng(17)
    out = []
    for M in MS:
        hmm, _ = fixtures.make_query(M, rng, calibrate=False, fs=True)
        out.append((fixtures.search_profile(hmm),
                    fixtures.fs_search_profile(hmm)))
    return out


def amino_batch(rng, n, L):
    lens = rng.integers(1, L + 1, n).astype(np.int32)
    lens[0], lens[-1] = 1, L
    dsq = np.full((n, L), 28, np.int8)
    for b, ln in enumerate(lens):
        dsq[b, :ln] = rng.integers(0, 20, ln)
    return dsq, lens


def nt_batch(rng, n, L):
    lens = rng.integers(5, L + 1, n).astype(np.int32)
    lens[:5] = (0, 2, 3, 4, L)
    dsq = np.full((n, L), 17, np.int8)
    for b, ln in enumerate(lens):
        dsq[b, :ln] = rng.integers(0, 4, ln)
    dsq[5, 10:20] = 15                   # a run of N
    return dsq, lens


def mixed_slots(rng, n):
    slot = np.resize(np.arange(len(MS), dtype=np.int32), n)
    rng.shuffle(slot)
    return slot


def jax_packed(models, which, comp, build, call, dsq, lens, slot, *extra):
    """The reference's packed call per size class, scattered back:
    (results per output, the packs built, by class)."""
    outs, packs = None, {}
    for ci, (Mg, G) in enumerate(CLASSES):
        members = [g for g, M in enumerate(MS) if class_of(M) == ci]
        pack = build([comp(models[g][which]) for g in members], G, Mg)
        packs[ci] = (pack, members)
        rows = np.nonzero(np.isin(slot, members))[0]
        local = np.array([members.index(s) for s in slot[rows]], np.int32)
        res = call(pack, dsq[rows], lens[rows], local,
                   *[e[rows] for e in extra])
        res = [np.asarray(r) for r in
               (res if isinstance(res, tuple) else (res,))]
        if outs is None:
            outs = [np.zeros((len(slot),) + r.shape[1:], r.dtype)
                    for r in res]
        for o, r in zip(outs, res):
            o[rows] = r
    return outs, packs


def tensors(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def assert_packs_equal(got, own):
    assert len(got) == len(own)
    for g, o in zip(got.params, own.params):
        assert torch.equal(g.rfv, o.rfv) and torch.equal(g.tr, o.tr)


def test_fwd_pack_vs_jax_packed_gate(models):
    """The Forward gate: the pack carried across from the per-model
    Pallas parameter sets in the reference pack's slot order."""
    rng = np.random.default_rng(3)
    dsq, lens = amino_batch(rng, 20, 120)
    slot = mixed_slots(rng, 20)
    (want,), packs = jax_packed(models, 0, jmm.fwd_components,
                                jmm.build_fwd_pack, jmm.fwd_pack_scores,
                                dsq, lens, slot)
    got = np.zeros(len(slot), np.float32)
    for ci, (jpack, members) in packs.items():
        per_model = []
        for g in members:
            rfv, tr, _, _ = fwd_params_pallas(models[g][0])
            per_model.append((np.asarray(rfv), np.asarray(tr), MS[g]))
        pack = mm.fwd_pack_from_jax(per_model, jpack.G, jpack.Mg)
        assert_packs_equal(pack, mm.build_fwd_pack(
            [tf.fwd_params(models[g][0]) for g in members]))
        rows = np.nonzero(np.isin(slot, members))[0]
        local = np.array([members.index(s) for s in slot[rows]])
        got[rows] = mm.fwd_pack_scores(
            pack, *tensors(dsq[rows], lens[rows]), local).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() < BF16_TOL, (got, want)
    with pytest.raises(ValueError, match="do not fit"):
        mm.fwd_pack_from_jax(per_model, 1, 64)


def test_domdec_pack_vs_jax_packed_decoding(models):
    rng = np.random.default_rng(5)
    dsq, lens = amino_batch(rng, 15, 120)
    slot = mixed_slots(rng, 15)
    want, packs = jax_packed(models, 0, jmm.domdec_components,
                             jmm.build_domdec_pack, jmm.domdec_pack_batch,
                             dsq, lens, slot)
    got = [np.zeros_like(w) for w in want]
    for ci, (jpack, members) in packs.items():
        pack = mm.domdec_pack_from_jax(
            {k: np.asarray(v) for k, v in jpack.arrays.items()},
            jpack.G, jpack.Mg, jpack.Kp)
        assert_packs_equal(pack, mm.build_domdec_pack(
            [td.domdec_params(models[g][0]) for g in members]))
        rows = np.nonzero(np.isin(slot, members))[0]
        local = np.array([members.index(s) for s in slot[rows]])
        res = mm.domdec_pack_batch(pack, *tensors(dsq[rows], lens[rows]),
                                   local)
        for o, r in zip(got, res):
            o[rows] = r.numpy()
    assert np.array_equal(got[3], want[3]) and got[3].all()
    for b, L in enumerate(lens):
        for g, w in zip(got[:3], want[:3]):
            assert np.abs(g[b, :L + 1] - w[b, :L + 1]).max() < DEC_TOL


def fs_packs(models, packs):
    """The port's fs3 packs carried across from the reference's
    decoding packs (``FS3DomDecPack.arrays``), by class."""
    out = {}
    for ci, (jpack, members) in packs.items():
        pack = mm.fs3_pack_from_jax(
            {k: np.asarray(v) for k, v in jpack.arrays.items()},
            jpack.G, jpack.Mg)
        assert_packs_equal(pack, mm.build_fs3_pack(
            [t3.fs3_params(models[g][1]) for g in members]))
        out[ci] = (pack, members)
    return out


def test_fs3_pack_vs_jax_packed_gate(models):
    """The fs3 gate against ``fs3_pack_scores`` (the reference's v1
    gate, bf16 emissions): 0.05 nats on random windows, 0.01 with the
    port fed the same bf16-rounded emissions."""
    rng = np.random.default_rng(7)
    dsq, lens = nt_batch(rng, 15, 360)
    slot = mixed_slots(rng, 15)
    (want,), _ = jax_packed(models, 1, jmm.fs3_components,
                            jmm.build_fs3_pack, jmm.fs3_pack_scores,
                            dsq, lens, slot)
    _, dd_packs = jax_packed(
        models, 1, jmm.fs3_domdec_components, jmm.build_fs3_domdec_pack,
        lambda *a: np.zeros(len(a[1])), dsq, lens, slot)
    got = np.zeros(len(slot), np.float32)
    gotb = np.zeros(len(slot), np.float32)
    for ci, (pack, members) in fs_packs(models, dd_packs).items():
        rows = np.nonzero(np.isin(slot, members))[0]
        local = np.array([members.index(s) for s in slot[rows]])
        got[rows] = mm.fs3_pack_scores(
            pack, *tensors(dsq[rows], lens[rows]), local).numpy()
        rounded = mm.build_fs3_pack(
            [ProfileTensors(p.rfv.to(torch.bfloat16).float(), p.tr)
             for p in pack.params])
        gotb[rows] = mm.fs3_pack_scores(
            rounded, *tensors(dsq[rows], lens[rows]), local).numpy()
    fin = np.isfinite(got)
    assert list(fin) == [L >= 2 for L in lens]
    assert np.array_equal(fin, want > -1e29)
    assert np.abs(got[fin] - want[fin]).max() < BF16_TOL, (got, want)
    assert np.abs(gotb[fin] - want[fin]).max() < 0.01, (gotb, want)


def test_fs3_domdec_pack_vs_jax_packed_decoding(models):
    """fs3 decoding with a dec_loop per window."""
    rng = np.random.default_rng(11)
    dsq, lens = nt_batch(rng, 10, 300)
    slot = mixed_slots(rng, 10)
    dec = ((lens // 3) / ((lens // 3) + 3.0)).astype(np.float32)
    want, packs = jax_packed(
        models, 1, jmm.fs3_domdec_components, jmm.build_fs3_domdec_pack,
        jmm.fs3_domdec_pack_batch, dsq, lens, slot, dec)
    got = [np.zeros_like(w) for w in want]
    for ci, (pack, members) in fs_packs(models, packs).items():
        rows = np.nonzero(np.isin(slot, members))[0]
        local = np.array([members.index(s) for s in slot[rows]])
        res = mm.fs3_domdec_pack_batch(
            pack, *tensors(dsq[rows], lens[rows]), local,
            torch.from_numpy(dec[rows]))
        for o, r in zip(got, res):
            if r.dim() == 2:         # the reference pads its rows
                o[rows[:, None], np.arange(r.shape[1])] = r.numpy()
            else:
                o[rows] = r.numpy()
    assert np.array_equal(got[3], want[3])
    assert list(got[3]) == [L >= 2 for L in lens]
    for b, L in enumerate(lens):
        if got[3][b]:
            for g, w in zip(got[:3], want[:3]):
                assert np.abs(g[b, :L + 1] - w[b, :L + 1]).max() < DEC_TOL


@pytest.fixture(scope="module")
def own_packs(models):
    return (mm.build_fwd_pack([tf.fwd_params(om) for om, _ in models]),
            mm.build_fs3_pack([t3.fs3_params(o3) for _, o3 in models]))


def test_fwd_pack_plain_equals_single_model_plain(own_packs):
    rng = np.random.default_rng(21)
    dsq, lens = amino_batch(rng, 12, 90)
    slot = mixed_slots(rng, 12)
    pack = own_packs[0]
    got = mm.fwd_pack_scores(pack, *tensors(dsq, lens), slot)
    for b in range(len(slot)):
        one = tf.fwd_score_ref(*tensors(dsq[b:b + 1, :max(1, lens[b])],
                                        lens[b:b + 1]),
                               pack.params[slot[b]])
        assert float(one[0]) == float(got[b])


def test_domdec_pack_plain_equals_single_model_plain(own_packs):
    rng = np.random.default_rng(22)
    dsq, lens = amino_batch(rng, 10, 90)
    slot = mixed_slots(rng, 10)
    pack = own_packs[0]
    got = mm.domdec_pack_batch(pack, *tensors(dsq, lens), slot)
    for b in range(len(slot)):
        one = td.domdec_ref(*tensors(dsq[b:b + 1], lens[b:b + 1]),
                            pack.params[slot[b]])
        for g, o in zip(got, one):
            assert torch.equal(g[b], o[0])


def test_fs3_pack_plain_equals_single_model_plain(own_packs):
    rng = np.random.default_rng(23)
    dsq, lens = nt_batch(rng, 10, 240)
    slot = mixed_slots(rng, 10)
    pack = own_packs[1]
    got = mm.fs3_pack_scores(pack, *tensors(dsq, lens), slot)
    for b in range(len(slot)):
        one = t3.fs3_score_ref(*tensors(dsq[b:b + 1], lens[b:b + 1]),
                               pack.params[slot[b]])
        assert float(one[0]) == float(got[b]) or \
            (np.isinf(float(one[0])) and np.isinf(float(got[b])))


def test_fs3_domdec_pack_plain_equals_single_model_plain(own_packs):
    """Also: dec_loop is per window (a batch under one scalar differs
    from the same batch under per-window values)."""
    rng = np.random.default_rng(24)
    dsq, lens = nt_batch(rng, 8, 210)
    slot = mixed_slots(rng, 8)
    dec = ((lens // 3) / ((lens // 3) + 3.0)).astype(np.float32)
    pack = own_packs[1]
    got = mm.fs3_domdec_pack_batch(pack, *tensors(dsq, lens), slot,
                                   torch.from_numpy(dec))
    for b in range(len(slot)):
        one = td3.fs3_domdec_ref(*tensors(dsq[b:b + 1], lens[b:b + 1]),
                                 pack.params[slot[b]], float(dec[b]))
        for g, o in zip(got, one):
            assert torch.equal(g[b], o[0])
    flat = mm.fs3_domdec_pack_batch(pack, *tensors(dsq, lens), slot,
                                    100.0 / 103.0)
    assert not torch.equal(flat[2], got[2])


@pytest.mark.parametrize("kind", ["std", "fs"])
def test_block_plan_gives_each_block_one_model(own_packs, kind):
    """Every item appears once, in one launch for every padded width
    (the Forward gate's fwd_plan, the fs3 pair's fs3_plan); each block's
    items share one model and number at most its class's G.
    tests/test_torch_fwd_plan.py and test_torch_fs3_plan.py hold the
    rest."""
    pack = own_packs[kind == "fs"]
    rng = np.random.default_rng(31)
    slot = rng.integers(0, len(MS), 77)
    slot[:30] = 3                        # one model's run spans blocks
    lens = rng.integers(0, 900, 77)
    plan = (mm.fs3_plan(lens, slot, pack, 1) if kind == "fs"
            else mm.fwd_plan(lens, slot, pack))
    assert plan.ncls == len({pack.geometry[g][2] for g in set(slot)})
    seen = []
    for c, model, M, first, count in plan.blocks:
        P, W, Mp, G = plan.classes[c][:4]
        cls = pack.classes[Mp]
        assert 1 <= count <= G
        rows = plan.items[first:first + count]
        assert {cls.models[model]} == set(slot[rows])
        assert M == MS[cls.models[model]]
        seen += list(rows)
    assert sorted(seen) == list(range(len(slot)))


def test_packed_wrappers_check_inputs(own_packs):
    rng = np.random.default_rng(41)
    dsq, lens = amino_batch(rng, 4, 30)
    pack = own_packs[0]
    with pytest.raises(ValueError, match="slots"):
        mm.fwd_pack_scores(pack, *tensors(dsq, lens),
                           np.array([0, 1, 2, len(MS)]))
    with pytest.raises(ValueError, match=r"\[B\]"):
        mm.fwd_pack_scores(pack, *tensors(dsq, lens), np.array([0, 1]))
    with pytest.raises(ValueError):
        mm.domdec_pack_batch(pack, torch.from_numpy(dsq.astype(np.int32)),
                             torch.from_numpy(lens), np.zeros(4, int))
    with pytest.raises(ValueError, match="at least one"):
        mm.build_fwd_pack([])
