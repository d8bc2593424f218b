"""bath_tpu_torch/ops/ssv.py, the MSV filter (F1) with its SSV pre-pass
and the SSV_BATH window capture, against the JAX package and the host
reference, on the CPU through the plain PyTorch versions.

Everything is integer arithmetic, so every comparison is exact.  The
cases (``fixtures.filter_cases``) are ORFs of a seeded genome, the hot
ORFs of its embedded homologs, random residues of 1, 2, 19, 20 and 21,
missing-data residues, an empty ORF and a 1200-residue ORF carrying
the hot ones; the MSV score and cascade tests add one of 16 500
residues.  M = 133 is no multiple of 8 or 32.  Each test asserts that
its cases reach the branches it is about: MSV overflow (inf), SSV without a result
(the MSV score stands), and captures past the 16 slots.
"""

import numpy as np
import pytest
import torch

from bath_tpu.hmmfile import read_hmm
from bath_tpu.ops.reference import filters as flt
from bath_tpu_torch import fixtures
from bath_tpu_torch.ops import ssv as ts
from torch_threads import one_torch_thread  # noqa: F401

LONG = 16_500


def stream(orfs):
    return tuple(torch.from_numpy(a) for a in ts.pack_stream(orfs))


def dense(orfs):
    """[B, Lmax] int8 padded with the missing-data residue, lens."""
    lens = np.array([len(o) for o in orfs], np.int32)
    dsq = np.full((len(orfs), max(lens)), 28, np.int8)
    for b, o in enumerate(orfs):
        dsq[b, :len(o)] = o
    return dsq, lens


@pytest.fixture(scope="module", params=[120, 133, 400])
def case(request, tmp_path_factory):
    """(om, cases, [the long ORF at M = 120]) at M = <param>: a small
    seeded genome with 4 embedded homologs (uncalibrated query)."""
    M = request.param
    fx = fixtures.write_fixture(M, 30_000, 4, M, calibrate=False,
                                directory=tmp_path_factory.mktemp("ssv"))
    om = fixtures.search_profile(read_hmm(fx.hmm_path))
    cases = fixtures.filter_cases(fx, 24, M, long_len=1200)
    long = fixtures.filter_cases(fx, 0, M, long_len=LONG)[-1:] \
        if M == 120 else []
    return om, cases, long


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    return fixtures.write_fixture(120, 300_000, 8, 11,
                                  directory=tmp_path_factory.mktemp("fx"))


def plain_scores(om, orfs):
    p = ts.msv_params(om)
    flat, offs, lens = stream(orfs)
    tjb = torch.from_numpy(p.tjb_for(lens.numpy()))
    raw = ts.msv_ssv(flat, offs, lens, tjb, p)
    return raw, ts.msv_post(*raw, tjb, p), p


def test_msv_plain_matches_jax_and_host(case):
    from bath_tpu.ops.jaxk.filters_mb import MSVExactMB
    om, orfs, long = case
    orfs = orfs + long
    _, (out_int, out_inf), p = plain_scores(om, orfs)
    ji, jf = (np.asarray(a) for a in MSVExactMB(om).ints(*dense(orfs)))
    assert np.array_equal(ji, out_int.numpy())
    assert np.array_equal(jf, out_inf.numpy())
    sc = np.float32((out_int.numpy().astype(np.float64) - p.base)
                    / p.scale - 3.0)
    sc = np.where(out_inf.numpy(), np.float32(np.inf), sc)
    host, ssv_none = [], 0
    for o in orfs:
        d = np.asarray(o, np.int32)
        om.reconfig_length(len(d))
        host.append(flt.msv_filter(d, om))
        ssv_none += flt.ssv_filter(d, om) is None
    assert np.array_equal(np.asarray(host, np.float32), sc)
    assert out_inf.any() and not out_inf.all()
    assert 0 < ssv_none < len(orfs)


def test_ssv_xeu_matches_pallas(case):
    """xEu against Pallas #2 in interpret mode over the model's own M
    lanes (at its default 128-lane padding, Pallas #2 also takes the
    dead lanes into its max, where the host reference has none)."""
    import jax.numpy as jnp

    from bath_tpu.ops.pallas.ssv import ssv_params_pallas, ssv_xe_pallas
    om, orfs, _ = case
    (xEu, _, _), _, _ = plain_scores(om, orfs)
    dsq, lens = dense(orfs)
    B = -(-len(orfs) // 8) * 8
    dsq = np.pad(dsq, ((0, B - len(orfs)), (0, 0)), constant_values=28)
    lens = np.pad(lens, (0, B - len(orfs)))
    sbv, Mp = ssv_params_pallas(om, lane_multiple=1)
    xe = ssv_xe_pallas(jnp.asarray(dsq.T.astype(np.int32)), jnp.asarray(lens),
                       sbv, Mp, interpret=True, btile=8, lblk=64)
    assert np.array_equal(np.asarray(xe)[:len(orfs)], xEu.numpy())


def thresholds(om, orfs, P):
    """ssv_thresh_bath of every ORF at F1 = <P>, on its null score."""
    from bath_tpu.bg import Background
    bg = Background()
    thr, nulls = [], []
    for o in orfs:
        om.reconfig_length(len(o))
        bg.set_length(len(o))
        nulls.append(bg.null_one(len(o)))
        thr.append(flt.ssv_thresh_bath(om, nulls[-1], P))
    return np.asarray(thr, np.int32), np.asarray(nulls)


def test_ssv_capture_plain_matches_jax(case):
    from bath_tpu.ops.jaxk.filters_mb import MSVExactMB, SSVBathMB
    om, orfs, _ = case
    p = ts.msv_params(om)
    flat, offs, lens = stream(orfs)
    tjb = torch.from_numpy(p.tjb_for(lens.numpy()))
    ssvb = SSVBathMB(om, MSVExactMB(om))
    # a threshold the hot ORFs cross and most random ones do not, then
    # P = 1, where every row captures
    for t in (180, -(1 << 30)):
        thr = np.full(len(orfs), t, np.int32)
        got = ts.ssv_capture(flat, offs, lens, tjb, torch.from_numpy(thr), p)
        dsq, dl = dense(orfs)
        want = [np.asarray(a) for a in ssvb.captures(dsq, dl, thr)]
        assert np.array_equal(want[0], got[0].numpy())
        for w, g in zip(want[1:], got[1:]):
            assert np.array_equal(w.T, g.numpy())
        nwin = got[0].numpy()
        if t > 0:
            assert (nwin == 0).any() and (nwin > ts.SSVB_NCAP).any()
            assert ((nwin > 0) & (nwin <= ts.SSVB_NCAP)).any()
        else:
            assert np.array_equal(nwin, lens.numpy())


def test_ssv_capture_windows_match_host(fx):
    """Host windows replayed from the plain version's events equal the
    scalar p7_SSVFilter_BATH scan's (native hook off), window for
    window; at P = 1 the slots overflow and the replay refuses."""
    import bath_tpu.native as nat
    from bath_tpu.scoredata import score_data_create
    om = fixtures.search_profile(read_hmm(fx.hmm_path))
    data = score_data_create(om)
    orfs = fixtures.filter_cases(fx, 16, 5)
    p = ts.msv_params(om)
    flat, offs, lens = stream(orfs)
    tjb = torch.from_numpy(p.tjb_for(lens.numpy()))
    for P in (0.02, 1.0):
        thr, nulls = thresholds(om, orfs, P)
        nwin, wi, wk, wsc = (a.numpy() for a in ts.ssv_capture(
            flat, offs, lens, tjb, torch.from_numpy(thr), p))
        refused = 0
        for r, o in enumerate(orfs):
            d = np.asarray(o, np.int32)
            om.reconfig_length(len(d))
            caps = (int(nwin[r]), list(zip(wi[r], wk[r], wsc[r]))
                    [:int(nwin[r])])
            w2: list = []
            if not flt.ssv_windows_from_captures(d, om, data, caps, w2):
                refused += 1
                assert nwin[r] > ts.SSVB_NCAP
                continue
            w1: list = []
            orig = nat.ssv_filter_bath_native
            nat.ssv_filter_bath_native = lambda *a: None
            try:
                flt.ssv_filter_bath(d, om, data, nulls[r], P, w1)
            finally:
                nat.ssv_filter_bath_native = orig
            assert [(w.n, w.k, w.length, w.score) for w in w1] == \
                [(w.n, w.k, w.length, w.score) for w in w2], r
        assert (refused > 0) == (P == 1.0)
        assert (nwin > 0).any()


def test_cascade_msv_and_ssv_captures_match_device_cascade(fx):
    """TorchCascade.msv_scores (flat/offs) and ssv_captures on the CPU
    equal bath_tpu's DeviceCascade on JAX's CPU backend."""
    from bath_tpu.device_pipeline import DeviceCascade
    from bath_tpu_torch.device_pipeline import TorchCascade
    om = fixtures.search_profile(read_hmm(fx.hmm_path))
    orfs = fixtures.filter_cases(fx, 40, 6, long_len=LONG)
    flat, offs, lens = ts.pack_stream(orfs)
    stats = {}
    cas = TorchCascade(om, device="cpu", stats=stats)
    # the byte tables are built on first use, not for the default path
    assert "msv" not in vars(cas) and "vit" not in vars(cas)
    dev = DeviceCascade(om)
    got = cas.msv_scores(None, lens, flat=flat, offs=offs)
    want = dev.msv_scores(None, lens, flat=flat, offs=offs)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    assert np.isinf(got).any() and np.isfinite(got).any()
    short = [o for o in orfs if len(o) < LONG]
    _, nulls = thresholds(om, short, 0.02)
    sl = np.array([len(o) for o in short], np.int64)
    def plain(caps):
        return {i: (n, [tuple(map(int, e)) for e in ev])
                for i, (n, ev) in caps.items()}
    for F1 in (0.02, 1.0):
        got = cas.ssv_captures(short, sl, nulls, F1)
        want = dev.ssv_captures(short, sl, nulls, F1)
        assert sorted(got) == sorted(want) == list(range(len(short)))
        assert plain(got) == plain(want)
    assert stats["msv_items"] == len(orfs)
    assert stats["ssvcap_items"] == 2 * len(short)
    assert 0 < stats["ssvcap_overflow"] < stats["ssvcap_items"]


def test_wrappers_check_inputs():
    rng = np.random.default_rng(3)
    hmm, q = fixtures.make_query(40, rng, calibrate=False)
    p = ts.msv_params(fixtures.search_profile(hmm))
    flat, offs, lens = stream([q.astype(np.int8), q[:7].astype(np.int8)])
    tjb = torch.from_numpy(p.tjb_for(lens.numpy()))
    with pytest.raises(ValueError, match="int8"):
        ts.msv_ssv(flat.to(torch.int32), offs, lens, tjb, p)
    with pytest.raises(ValueError, match="offs"):
        ts.msv_ssv(flat, offs.to(torch.int32), lens, tjb, p)
    before = ts.msv_ssv.launches
    ts.msv_ssv(flat, offs, lens, tjb, p)
    assert ts.msv_ssv.launches == before      # CPU: the plain version
