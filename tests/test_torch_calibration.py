"""bath_tpu_torch's device-batched calibration (``evalues_device.py``)
and the integer filters with a model slot per item
(``ops/multimodel.py`` ``msv_ssv_multi``, ``vit_ints_multi``), on the CPU
through the kernels' plain PyTorch versions, against the JAX package and
the host calibration.

Inputs come from a seed with numpy (``fixtures.make_query``): three
single-sequence models of M = 40, 90 and 130, two padded widths (96 and
160 lanes).  Integer outputs and everything fitted from them (the MSV
and Viterbi mus), and the fs5 tau, which both sides score with the same
host parser, are held with ``==``.  The Forward and fs3 taus come from
f32 gates on the port's side, from the host's f64-log-space parsers on
the host's, and from bf16 tables on the JAX side: 0.02 against the host
(measured: <= 5e-7), 0.05 against the JAX package (its own test's bound;
measured there: up to 0.008).
"""

import copy

import numpy as np
import pytest
import torch

from bath_tpu_torch import constants as C
from bath_tpu_torch import evalues_device as ted
from bath_tpu_torch import fixtures
from bath_tpu_torch.bg import Background
from bath_tpu_torch.evalues import CalibrateConfig, calibrate, fs_tau
from bath_tpu_torch.ops import multimodel as mm
from bath_tpu_torch.ops import ssv as ts
from bath_tpu_torch.ops import vit as tv
from bath_tpu_torch.ops.reference import filters as flt
from bath_tpu_torch.oprofile import oprofile_convert
from bath_tpu_torch.profile import profile_config
from bath_tpu_torch.rng import Randomness
from torch_threads import one_torch_thread  # noqa: F401

MS = (40, 90, 130)
SMALL = dict(EmL=60, EvL=60, EmN=24, EvN=24, EfN=24, EfL=40)
MUS = (C.EV_MMU, C.EV_VMU, C.EV_FTAUFS5)
TAUS = (C.EV_FTAU, C.EV_FTAUFS3)
LAMBDAS = (C.EV_MLAMBDA, C.EV_VLAMBDA, C.EV_FLAMBDA)


def models(seed=5, Ms=MS):
    rng = np.random.default_rng(seed)
    return [fixtures.make_query(M, rng, calibrate=False, fs=True)[0]
            for M in Ms]


@pytest.fixture(scope="module")
def host_default():
    """The three models and their host calibration at the defaults."""
    hmms = models()
    host = copy.deepcopy(hmms)
    for h in host:
        calibrate(h, CalibrateConfig(fs=True))
    return hmms, host


def shared_items(batch, G):
    """A [N, L] batch as the stream all <G> models read (offsets
    repeat), with model slots."""
    N, L = batch.shape
    flat = torch.from_numpy(np.ascontiguousarray(batch, np.int8).reshape(-1))
    offs = torch.from_numpy(np.tile(np.arange(N, dtype=np.int64) * L, G))
    lens = torch.full((G * N,), L, dtype=torch.int32)
    return flat, offs, lens, np.repeat(np.arange(G), N)


@pytest.fixture(scope="module")
def int_case():
    """(oms, MSV batch, Viterbi batch): the profiles as the calibration
    configures them and two small shared batches, the second with a
    homolog of each model so that scores leave the noise."""
    hmms = models()
    bg = Background()
    oms = [oprofile_convert(profile_config(h, bg, L=60)) for h in hmms]
    rng = np.random.default_rng(9)
    f = bg.f[:20].astype(np.float64)
    batch = rng.choice(20, size=(10, 150), p=f / f.sum()).astype(np.int8)
    for g, M in enumerate(MS):
        q = fixtures.make_query(M, np.random.default_rng(5), False)[1]
        batch[g, 3:3 + min(M, 140)] = q[:140]
    return oms, batch[:, :60].copy(), batch


def per_item(values, N):
    return torch.from_numpy(np.repeat(np.asarray(values, np.int32), N))


# ---------------------------------------------------------------------
# (a) the plain multi-model integer filters
# ---------------------------------------------------------------------
def test_msv_multi_plain_equals_single_host_and_jax(int_case):
    from bath_tpu.evalues_device import _dyn_kernels, _msv_np_params
    oms, short, long = int_case
    for batch in (short, long):
        N, L = batch.shape
        params = [ts.msv_params(om) for om in oms]
        pack = mm.build_msv_pack(params)
        assert sorted(pack.classes) == [96, 160]
        flat, offs, lens, slot = shared_items(batch, len(oms))
        tjb = per_item([p.tjb_for([L])[0] for p in params], N)
        raw = mm.msv_ssv_multi(pack, flat, offs, lens, tjb, slot)
        out_int, out_inf = ts.msv_post(*raw, tjb, pack.per_item(slot))
        # the single-model plain version, model by model
        for g, p in enumerate(params):
            r = torch.arange(g * N, (g + 1) * N)
            one = ts.msv_ssv_ref(flat, offs[r], lens[r], tjb[r], p)
            for a, b in zip(one, raw):
                assert torch.equal(a, b[r])
            oi, of = ts.msv_post(*one, tjb[r], p)
            assert torch.equal(oi, out_int[r]) and torch.equal(of, out_inf[r])
        # the host filter on every (model, sequence)
        for g, (om, p) in enumerate(zip(oms, params)):
            om.reconfig_length(L)
            host = np.asarray([flt.msv_filter(np.asarray(s, np.int32), om)
                               for s in batch], np.float32)
            oi = out_int[g * N:(g + 1) * N].numpy().astype(np.float64)
            sc = np.float32((oi - p.base) / p.scale - 3.0)
            sc = np.where(out_inf[g * N:(g + 1) * N].numpy(),
                          np.float32(np.inf), sc)
            assert np.array_equal(host, sc)
        # the JAX calibration's vmapped kernel on its own stacked arrays,
        # and the port's pack made from those arrays
        Mt, G = 256, len(oms)
        sbvT = np.stack([_msv_np_params(om, Mt)[0] for om in oms])
        rbvT = np.stack([_msv_np_params(om, Mt)[1] for om in oms])
        tj = np.stack([np.full(N, p.tjb_for([L])[0], np.int16)
                       for p in params])
        sc_b = [np.array([getattr(om, k) for om in oms], np.int32)
                for k in ("base_b", "tec_b", "tbm_b", "bias_b")]
        ji, jf = (np.asarray(a) for a in _dyn_kernels()["msv"](
            batch, np.full(N, L, np.int32), tj, sbvT, rbvT, Mt, *sc_b))
        assert np.array_equal(ji.reshape(-1), out_int.numpy())
        assert np.array_equal(jf.reshape(-1) != 0, out_inf.numpy())
        twin = mm.msv_pack_from_jax(sbvT, rbvT, MS, *sc_b)
        for a, b in zip(mm.msv_ssv_multi(twin, flat, offs, lens, tjb, slot),
                        raw):
            assert torch.equal(a, b)
    assert out_int.max() > 60          # the homologs left the noise


def test_vit_multi_plain_equals_single_host_and_jax(int_case):
    from bath_tpu.evalues_device import _dyn_kernels, _vit_np_params
    oms, short, long = int_case
    for batch in (short, long):
        N, L = batch.shape
        params = [tv.vit_params(om) for om in oms]
        pack = mm.build_vit_pack(params)
        flat, offs, lens, slot = shared_items(batch, len(oms))
        move = per_item([p.move_for([L])[0] for p in params], N)
        got = mm.vit_ints_multi(pack, flat, offs, lens, move, slot)
        for g, p in enumerate(params):
            r = torch.arange(g * N, (g + 1) * N)
            one = tv.vit_ints_ref(flat, offs[r], lens[r], move[r], p)
            for a, b in zip(one, got):
                assert torch.equal(a, b[r])
        score, has, ovf = (t.numpy() for t in got)
        for g, (om, p) in enumerate(zip(oms, params)):
            om.reconfig_length(L)
            host = np.asarray([flt.viterbi_filter(np.asarray(s, np.int32), om)
                               for s in batch], np.float32)
            r = slice(g * N, (g + 1) * N)
            sc = np.float32((score[r].astype(np.float64) - p.base)
                            / p.scale - 3.0)
            sc = np.where(has[r], sc, np.float32(-np.inf))
            sc = np.where(ovf[r], np.float32(np.inf), sc)
            assert np.array_equal(host, sc)
        Mt = 256
        stacked = [_vit_np_params(om, Mt) for om in oms]
        rwvT = np.stack([s[0] for s in stacked])
        tvs = [np.stack([s[1][q] for s in stacked]) for q in range(8)]
        mw = np.stack([np.full(N, p.move_for([L])[0], np.int16)
                       for p in params])
        sc_w = [np.array([getattr(p, k) for p in params], np.int32)
                for k in ("base", "emove", "eloop")]
        ji, jh, jo = (np.asarray(a) for a in _dyn_kernels()["vit"](
            batch, np.full(N, L, np.int32), rwvT, *tvs, mw, Mt, *sc_w))
        assert np.array_equal(jh.reshape(-1) != 0, has)
        assert np.array_equal(jo.reshape(-1) != 0, ovf)
        assert np.array_equal(ji.reshape(-1)[has], score[has])
        twin = mm.vit_pack_from_jax(rwvT, tvs, MS, *sc_w)
        for a, b in zip(mm.vit_ints_multi(twin, flat, offs, lens, move, slot),
                        got):
            assert torch.equal(a, b)
    assert has.all() and score.max() > 0


def test_int_multi_serves_mixed_items_and_rejects_bad_slots(int_case):
    """Items of the models in any order, each at its own offset and
    length, equal the single-model plain version item by item; a slot
    past the pack raises."""
    oms, _, long = int_case
    rng = np.random.default_rng(2)
    seqs = [long[i % len(long), :n] for i, n in
            enumerate(rng.integers(1, 150, 17))]
    flat, offs, lens = (torch.from_numpy(a) for a in ts.pack_stream(seqs))
    slot = rng.integers(0, len(oms), len(seqs))
    mp = [ts.msv_params(om) for om in oms]
    vp = [tv.vit_params(om) for om in oms]
    tjb = torch.from_numpy(np.array(
        [mp[g].tjb_for([n])[0] for g, n in zip(slot, lens.tolist())],
        np.int32))
    move = torch.from_numpy(np.array(
        [vp[g].move_for([n])[0] for g, n in zip(slot, lens.tolist())],
        np.int32))
    m = mm.msv_ssv_multi(mm.build_msv_pack(mp), flat, offs, lens, tjb, slot)
    v = mm.vit_ints_multi(mm.build_vit_pack(vp), flat, offs, lens, move, slot)
    for b, g in enumerate(slot):
        r = slice(b, b + 1)
        for a, c in zip(ts.msv_ssv_ref(flat, offs[r], lens[r], tjb[r], mp[g]),
                        m):
            assert torch.equal(a, c[r])
        for a, c in zip(tv.vit_ints_ref(flat, offs[r], lens[r], move[r],
                                        vp[g]), v):
            assert torch.equal(a, c[r])
    with pytest.raises(ValueError):
        mm.msv_ssv_multi(mm.build_msv_pack(mp), flat, offs, lens, tjb,
                         np.full(len(seqs), len(oms)))


# ---------------------------------------------------------------------
# (b) the port's device calibration against its host calibration
# ---------------------------------------------------------------------
def check_against(got, want, tau_tol):
    for d, h in zip(got, want):
        for k in MUS:
            assert d.evparam[k] == h.evparam[k], (d.M, k)
        for k in TAUS:
            assert abs(d.evparam[k] - h.evparam[k]) <= tau_tol, (d.M, k)
        for k in LAMBDAS:
            assert abs(float(d.evparam[k]) - float(h.evparam[k])) < 1e-12
        assert d.flags == h.flags


def test_device_calibration_matches_host_at_the_defaults(host_default):
    hmms, host = host_default
    dev = copy.deepcopy(hmms)
    stats, seen = {}, []
    ted.calibrate_many_device(dev, CalibrateConfig(fs=True), device="cpu",
                              stats=stats, progress=seen.append)
    check_against(dev, host, 0.02)
    assert seen == dev
    assert stats["cal_models"] == 3 and stats["cal_items"] == 3 * 800
    assert "cal_fs_serial" not in stats
    assert all(stats[f"cal_{k}_s"] > 0
               for k in ("draws", "config", "msv", "vit", "fwd", "fs3"))


def test_device_calibration_without_fs(host_default):
    hmms, host = host_default
    dev = copy.deepcopy(hmms[:2])
    ted.calibrate_many_device(dev, CalibrateConfig(fs=False), device="cpu")
    for d, h in zip(dev, host):
        for k in (C.EV_MMU, C.EV_VMU):
            assert d.evparam[k] == h.evparam[k]
        assert abs(d.evparam[C.EV_FTAU] - h.evparam[C.EV_FTAU]) <= 0.02
        assert d.evparam[C.EV_FTAUFS3] == C.EVPARAM_UNSET


@pytest.mark.parametrize("seed", [1, 5])
def test_mus_equal_the_host_at_a_cut_down_config(seed):
    """At these seeds and this config the JAX package's device path
    gives a mu one f32 digit from its host's (it forms the Gumbel
    sample in f32; ROADMAP section 3): the port fits in f64, as the
    host does, and gives the host's mus."""
    hmms = models(seed, (40, 90))
    cfg = CalibrateConfig(fs=True, **SMALL)
    host = copy.deepcopy(hmms)
    for h in host:
        calibrate(h, cfg)
    ted.calibrate_many_device(hmms, cfg, device="cpu")
    check_against(hmms, host, 0.02)


def test_gate_scores_see_each_stage_own_length(host_default):
    """Every model's profile is configured at EvL, the Forward batch is
    EfL long and the fs3 batch 3 EfL nt: the f32 gates take each item's
    own length model, and agree item by item with the host parsers
    reconfigured per stage (<= 1e-4 nats)."""
    from bath_tpu_torch.native import (fs3_parser_score_native,
                                       fwd_parser_score_native)
    from bath_tpu_torch.gencode import GeneticCode
    from bath_tpu_torch.ops.fwd import fwd_params
    from bath_tpu_torch.ops.reference.fwdback_fs import fs_oprofile_convert
    from bath_tpu_torch.profile import profile_config_fs
    hmms, _ = host_default
    cfg = CalibrateConfig(fs=True, EfN=6)
    bg = Background()
    gcodes, cts = ted.codon_tables([1])
    draws = ted.shared_draws(cfg, bg, cts)
    assert isinstance(gcodes[1], GeneticCode)
    oms = [oprofile_convert(profile_config(h, bg, L=cfg.EvL)) for h in hmms]
    om3s = [fs_oprofile_convert(profile_config_fs(h, bg, gcodes[1], 3,
                                                  cfg.EvL)) for h in hmms]
    G, N = len(hmms), cfg.EfN
    pack = mm.build_fwd_pack([fwd_params(om) for om in oms])
    got = mm.fwd_pack_scores(
        pack, torch.from_numpy(draws.fwd).repeat(G, 1),
        torch.full((G * N,), cfg.EfL, dtype=torch.int32),
        np.repeat(np.arange(G), N)).numpy().reshape(G, N)
    f3 = ted.fs3_scores(om3s, [draws.fs[1][0]] * G, cfg.EfL, "cpu")
    for g in range(G):
        oms[g].reconfig_length(cfg.EfL)
        om3s[g].reconfig_length(cfg.EfL)
        for n in range(N):
            want = fwd_parser_score_native(
                np.asarray(draws.fwd[n], np.int32), oms[g])
            assert abs(got[g, n] - want) <= 1e-4
            want = fs3_parser_score_native(
                np.asarray(draws.fs[1][0][n], np.int32), om3s[g])
            assert abs(f3[g, n] - want) <= 1e-4


# ---------------------------------------------------------------------
# (c) against the JAX package's device calibration
# ---------------------------------------------------------------------
def test_device_calibration_matches_the_jax_package(host_default):
    from bath_tpu.builder import BuilderConfig, single_build
    from bath_tpu.evalues import CalibrateConfig as JaxConfig
    from bath_tpu.evalues_device import calibrate_many_device as jax_cal
    hmms, host = host_default
    # the same residues through the JAX package's own builder
    rng = np.random.default_rng(5)
    ref = []
    for M in MS[:2]:
        q = fixtures.make_query(M, rng, calibrate=False, fs=True)[1]
        ref.append(single_build(q, f"synth{M}", BuilderConfig(fs=True),
                                do_calibrate=False))
    for h, j in zip(hmms, ref):
        assert np.array_equal(h.mat, j.mat) and np.array_equal(h.t, j.t)
    jax_cal(ref, JaxConfig(fs=True))
    dev = copy.deepcopy(hmms[:2])
    ted.calibrate_many_device(dev, CalibrateConfig(fs=True), device="cpu")
    check_against(dev, ref, 0.05)
    # the port's f32 gates sit closer to the host than the bf16 tables
    for d, j, h in zip(dev, ref, host):
        for k in TAUS:
            assert abs(d.evparam[k] - h.evparam[k]) \
                <= abs(j.evparam[k] - h.evparam[k]) + 1e-6


# ---------------------------------------------------------------------
# (d) bathconvert's frameshift taus on one shared RNG stream
# ---------------------------------------------------------------------
def serial_convert(hmms, r, bg):
    """The serial loop of cli/bathconvert.py."""
    from bath_tpu_torch.codontable import CodonTable
    from bath_tpu_torch.gencode import GeneticCode
    from bath_tpu_torch.ops.reference.fwdback_fs import fs_oprofile_convert
    from bath_tpu_torch.profile import profile_config_fs
    for hmm in hmms:
        gcode = GeneticCode.create(1)
        gcode.set_initiator_any()
        tbl = CodonTable(gcode)
        lam = float(hmm.evparam[C.EV_FLAMBDA])
        for n, key in ((3, C.EV_FTAUFS3), (5, C.EV_FTAUFS5)):
            om = fs_oprofile_convert(profile_config_fs(hmm, bg, gcode, n,
                                                       100))
            hmm.evparam[key] = fs_tau(r, om, tbl, bg, 100, 200, lam, 0.04)


def test_convert_fs_taus_match_the_serial_loop(host_default):
    _, host = host_default
    a, b = copy.deepcopy(host), copy.deepcopy(host)
    for h in a + b:
        h.evparam[C.EV_FTAUFS3] = h.evparam[C.EV_FTAUFS5] = C.EVPARAM_UNSET
    ra, rb = Randomness(42), Randomness(42)
    bg = Background()
    serial_convert(a, ra, bg)
    stats = {}
    ted.convert_fs_taus_device([(h, 1) for h in b], rb, bg, device="cpu",
                               stats=stats)
    taus = set()
    for s, d in zip(a, b):
        assert d.evparam[C.EV_FTAUFS5] == s.evparam[C.EV_FTAUFS5]
        assert abs(d.evparam[C.EV_FTAUFS3] - s.evparam[C.EV_FTAUFS3]) <= 0.02
        taus.add(float(s.evparam[C.EV_FTAUFS3]))
    assert len(taus) == 3
    # one shared stream: the models drew different DNA, and both ways
    # leave the generator in the same state
    assert ra._mti == rb._mti and np.array_equal(ra._mt, rb._mt)
    assert stats["cal_models"] == 3 and stats["cal_items"] == 600


# ---------------------------------------------------------------------
# (e) the over/underflow fallback
# ---------------------------------------------------------------------
def test_overflow_falls_back_to_the_serial_host_taus(host_default,
                                                     monkeypatch):
    """A model whose shared-batch fs5 scores over/underflow (here: the
    second model's are made to) takes the serial fs_tau from the cloned
    RNG snapshot and gets the host's taus exactly; the others keep the
    batched path."""
    hmms, host = host_default
    dev = copy.deepcopy(hmms)
    real = ted._fs5_xv_host

    def fs5(dna5, om5, nullsc, L):
        return None if om5.M == MS[1] else real(dna5, om5, nullsc, L)
    monkeypatch.setattr(ted, "_fs5_xv_host", fs5)
    stats = {}
    ted.calibrate_many_device(dev, CalibrateConfig(fs=True), device="cpu",
                              stats=stats)
    assert stats["cal_fs_serial"] == 1
    check_against(dev, host, 0.02)
    for k in TAUS[1:] + MUS:
        assert dev[1].evparam[k] == host[1].evparam[k]

    # bathconvert's twin: the snapshot is the model's own place in the
    # shared stream
    a, b = copy.deepcopy(host), copy.deepcopy(host)
    ra, rb = Randomness(42), Randomness(42)
    bg = Background()
    serial_convert(a, ra, bg)
    ted.convert_fs_taus_device([(h, 1) for h in b], rb, bg, device="cpu")
    assert b[1].evparam[C.EV_FTAUFS3] == a[1].evparam[C.EV_FTAUFS3]
    assert b[1].evparam[C.EV_FTAUFS5] == a[1].evparam[C.EV_FTAUFS5]
    assert b[2].evparam[C.EV_FTAUFS5] == a[2].evparam[C.EV_FTAUFS5]


def test_cuda_device_is_required_unless_cpu_is_asked_for(host_default):
    """No CUDA device and no --device cpu: the calibration raises, it
    does not carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    hmms, _ = host_default
    with pytest.raises(RuntimeError, match="CUDA"):
        ted.calibrate_many_device(copy.deepcopy(hmms[:1]),
                                  CalibrateConfig(fs=False))
    with pytest.raises(RuntimeError, match="CUDA"):
        ted.convert_fs_taus_device([(copy.deepcopy(hmms[0]), 1)],
                                   Randomness(42), Background())
