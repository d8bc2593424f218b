"""bath_tpu_torch/ops/vit.py, the ViterbiFilter (F2) and the
ViterbiFilter_BATH window capture, against the JAX package and the host
reference, on the CPU through the plain PyTorch versions.

Everything is integer arithmetic, so every comparison is exact.  The
cases are those of test_torch_ssv.py (``fixtures.filter_cases``): the
hot ORFs saturate int16, the empty ORF has no Viterbi result, and a
1200-residue ORF carries the hot ones (test_torch_ssv.py and
``chip_smoke.py`` add one of 16 500 residues).  Each
test asserts that its cases reach the branches it is about: no result
(-inf), int16 overflow (inf) and an overflow row that cuts the capture
events.
"""

import numpy as np
import pytest
import torch

from bath_tpu.hmmfile import read_hmm
from bath_tpu.ops.reference import filters as flt
from bath_tpu_torch import fixtures
from bath_tpu_torch.ops import ssv as ts
from bath_tpu_torch.ops import vit as tv
from torch_threads import one_torch_thread  # noqa: F401

NEG = -(1 << 30)


def stream(orfs):
    return tuple(torch.from_numpy(a) for a in ts.pack_stream(orfs))


def dense(orfs, B=None):
    """[B, Lmax] int8 padded with the missing-data residue, lens."""
    B = B or len(orfs)
    lens = np.zeros(B, np.int32)
    lens[:len(orfs)] = [len(o) for o in orfs]
    dsq = np.full((B, max(lens)), 28, np.int8)
    for b, o in enumerate(orfs):
        dsq[b, :len(o)] = o
    return dsq, lens


@pytest.fixture(scope="module", params=[120, 133, 400])
def case(request, tmp_path_factory):
    """(om, cases) at M = <param>, as in test_torch_ssv.py."""
    M = request.param
    fx = fixtures.write_fixture(M, 30_000, 4, M, calibrate=False,
                                directory=tmp_path_factory.mktemp("vit"))
    om = fixtures.search_profile(read_hmm(fx.hmm_path))
    return om, fixtures.filter_cases(fx, 24, M, long_len=1200)


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    return fixtures.write_fixture(120, 300_000, 8, 11,
                                  directory=tmp_path_factory.mktemp("fx"))


def plain_ints(om, orfs):
    p = tv.vit_params(om)
    flat, offs, lens = stream(orfs)
    move = torch.from_numpy(p.move_for(lens.numpy()))
    return tv.vit_ints(flat, offs, lens, move, p), p


def test_vit_plain_matches_jax_pallas_and_host(case):
    import jax.numpy as jnp

    from bath_tpu.ops.jaxk.filters_mb import VitExactMB
    from bath_tpu.ops.pallas.vit import vit_ints_pallas, vit_params_pallas
    om, orfs = case
    (score, has, ovf), p = plain_ints(om, orfs)
    want = [np.asarray(a) for a in VitExactMB(om).ints(*dense(orfs))]
    for w, g in zip(want, (score, has, ovf)):
        assert np.array_equal(w, g.numpy())
    n = len(orfs)
    dsq, lens = dense(orfs, -(-n // 8) * 8)
    rwv, tr, Mp, base, emove, eloop = vit_params_pallas(om)
    pal = vit_ints_pallas(jnp.asarray(dsq.T.astype(np.int32)),
                          jnp.asarray(lens), jnp.asarray(p.move_for(lens)),
                          rwv, tr, Mp, base, emove, eloop, interpret=True,
                          btile=8, lblk=64)
    for w, g in zip(pal, (score, has, ovf)):
        assert np.array_equal(np.asarray(w)[:n], g.numpy()[:n])
    sc = np.float32((score.numpy().astype(np.float64) - p.base)
                    / p.scale - 3.0)
    sc = np.where(has.numpy(), sc, np.float32(-np.inf))
    sc = np.where(ovf.numpy(), np.float32(np.inf), sc)
    host = []
    for o in orfs:
        om.reconfig_length(len(o))
        host.append(flt.viterbi_filter(np.asarray(o, np.int32), om))
    assert np.array_equal(np.asarray(host, np.float32), sc)
    assert ovf.any() and (~has).any() and np.isfinite(sc).any()


def test_vit_capture_plain_matches_jax(case):
    from bath_tpu.ops.jaxk.filters_mb import VitBathMB, VitExactMB
    om, orfs = case
    p = tv.vit_params(om)
    flat, offs, lens = stream(orfs)
    move = torch.from_numpy(p.move_for(lens.numpy()))
    vitb = VitBathMB(om, VitExactMB(om))
    dsq, dl = dense(orfs)
    # a threshold the hot ORFs cross (some rows only), then P = 1
    for t in (16_000, NEG):
        thr = np.full(len(orfs), t, np.int32)
        karr, ovfrow = tv.vit_capture(flat, offs, lens, move,
                                      torch.from_numpy(thr), p)
        jk, jo = (np.asarray(a) for a in vitb.captures(dsq, dl, thr))
        assert np.array_equal(jo, ovfrow.numpy())
        mine = np.zeros_like(jk)
        for b, (o, n) in enumerate(zip(offs.tolist(), dl.tolist())):
            mine[:n, b] = karr.numpy()[o:o + n]
        assert np.array_equal(jk, mine)
        assert (ovfrow > 0).any()
        crossed = [(karr.numpy()[o:o + n] != 0).sum()
                   for o, n in zip(offs.tolist(), dl.tolist())]
        if t > 0:
            assert 0 < sum(c > 0 for c in crossed) < len(orfs)


def test_vit_capture_windows_match_host(fx):
    """Host windows replayed from the plain version's events equal the
    scalar p7_ViterbiFilter_BATH scan's (native hook off), window for
    window, at F2 = 0.02 and at P = 1; events at and past the overflow
    row are the reference's eslERANGE return and are dropped."""
    import bath_tpu.native as nat
    from bath_tpu.bg import Background
    from bath_tpu.scoredata import score_data_create
    om = fixtures.search_profile(read_hmm(fx.hmm_path))
    data = score_data_create(om)
    orfs = fixtures.filter_cases(fx, 16, 5)
    p = tv.vit_params(om)
    flat, offs, lens = stream(orfs)
    move = torch.from_numpy(p.move_for(lens.numpy()))
    bg = Background()
    nulls = []
    for o in orfs:
        bg.set_length(len(o))
        nulls.append(bg.null_one(len(o)))
    for P in (0.02, 1.0):
        thr, ext = [], []
        for o, nl in zip(orfs, nulls):
            om.reconfig_length(len(o))
            a, b = flt.vit_thresh_bath(om, nl, P)
            thr.append(a)
            ext.append(b)
        karr, ovfrow = (a.numpy() for a in tv.vit_capture(
            flat, offs, lens, move, torch.from_numpy(np.int32(thr)), p))
        cut = 0
        for r, o in enumerate(orfs):
            d = np.asarray(o, np.int32)
            om.reconfig_length(len(d))
            ks = karr[offs[r]:offs[r] + len(d)]
            rows = np.nonzero(ks)[0]
            if ovfrow[r] > 0:
                cut += 1
                rows = rows[rows + 1 < ovfrow[r]]
            w2: list = []
            flt.vit_windows_from_captures(d, om, data, rows + 1, ks[rows],
                                          w2, int(ext[r]))
            w1: list = []
            orig = nat.vit_filter_bath_native
            nat.vit_filter_bath_native = lambda *a: None
            try:
                sc = flt.viterbi_filter(d, om, data, nulls[r], P, w1)
            finally:
                nat.vit_filter_bath_native = orig
            assert (sc == np.inf) == (ovfrow[r] > 0)
            assert [(w.n, w.k, w.length) for w in w1] == \
                [(w.n, w.k, w.length) for w in w2], r
        assert cut > 0 and karr.any()


def test_cascade_vit_scores_and_captures_match_device_cascade(fx):
    """TorchCascade.vit_scores and vit_captures on the CPU equal
    bath_tpu's DeviceCascade on JAX's CPU backend."""
    from bath_tpu.device_pipeline import DeviceCascade
    from bath_tpu_torch.device_pipeline import TorchCascade
    om = fixtures.search_profile(read_hmm(fx.hmm_path))
    orfs = fixtures.filter_cases(fx, 40, 6, long_len=1200)
    lens = np.array([len(o) for o in orfs], np.int64)
    stats = {}
    cas = TorchCascade(om, device="cpu", stats=stats)
    dev = DeviceCascade(om)
    got = cas.vit_scores(orfs, lens)
    want = dev.vit_scores(orfs, lens)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    assert np.isposinf(got).any() and np.isneginf(got).any()
    flts = np.zeros(len(orfs))
    for F2 in (1e-3, 1.0):
        g = cas.vit_captures(orfs, lens, flts, F2)
        w = dev.vit_captures(orfs, lens, flts, F2)
        assert sorted(g) == sorted(w) == list(range(len(orfs)))
        for i in w:
            assert np.array_equal(g[i][0], w[i][0])
            assert np.array_equal(g[i][1], w[i][1])
    assert stats["vit_items"] == len(orfs)
    assert stats["vitcap_items"] == 2 * len(orfs)


def test_maxplus_scan_is_the_sequential_chain():
    """The log-depth (max, +) scan equals D[k] = max(part[k],
    sat(D[k-1] + add[k])) taken one k at a time, saturation included."""
    rng = np.random.default_rng(4)
    for M in (1, 2, 7, 33, 133):
        part = rng.integers(-32768, 32768, (6, M)).astype(np.int32)
        part[0] = -32768
        part[1, :M // 2] = 32767
        add = -rng.integers(0, 40_000, M).astype(np.int32)
        add[rng.random(M) < 0.3] = -32768
        want = part.copy()
        for k in range(1, M):
            want[:, k] = np.maximum(part[:, k], np.clip(
                want[:, k - 1] + add[k], -32768, 32767))
        got = tv.maxplus_scan(torch.from_numpy(part), torch.from_numpy(add))
        assert np.array_equal(got.numpy(), want)


def test_vit_params_refuse_a_positive_dd_word():
    """The (max, +) D->D scan is exact only for tDD <= 0."""
    from bath_tpu import constants as C
    hmm, _ = fixtures.make_query(30, np.random.default_rng(2),
                                 calibrate=False)
    om = fixtures.search_profile(hmm)
    tv.vit_params(om)
    om.twv[5, C.P_DD] = 1
    with pytest.raises(ValueError, match="D->D"):
        tv.vit_params(om)
