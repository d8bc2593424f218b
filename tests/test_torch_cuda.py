"""bath_tpu_torch's CUDA kernels on the card (marked ``cuda``; they
skip without one).  Run them where there is a card:

    python -m pytest -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it also runs where JAX is not installed.
Each kernel is held against its plain PyTorch version on the same
inputs: the gates within 1e-3 nats, decoding within 1e-4 with
identical `ok` flags, the integer filters (MSV/SSV, the SSV capture,
the ViterbiFilter and its capture) exactly.  M = 1500 takes the layouts
with several warps per ORF or DNA window.  The four multi-model entries
(ops/multimodel.py) are held to their plain versions at the same bounds
and, item for item, bit for bit to the single-model entries, on one
batch that mixes seven models of five padded widths; the fs3 pair also
on six widths (one to three warps a window) in its one launch, and with
the batch in ascending, descending and shuffled order, and so are the
ViterbiFilter (eight widths) and decoding (nine) in theirs, and the
Forward gate (nine) and MSV (eight) in theirs.  The two integer
multi-model entries (MSV/SSV and the ViterbiFilter with a model slot per
item) are held exactly to their plain versions and to the single-model
entries, and the device calibration built on them to the host's.  The
classes past shared memory (the ViterbiFilter and its capture at
M = 3000, the fs3 pair at M = 4000, MSV and the Forward gate at
M = 4200) are held to their plain versions, and the choices that change
no arithmetic (the gate's wide classes with or without their
transitions staged, the fs3 pair's direct loads against its ring) bit
for bit to each other.  The sanitizer tier's cases
(``bath_tpu_torch.sanitize``) hold on the card with no tool, and the
self-check entry points (``bath_tpu_torch.selfcheck``) pass there.  The
envelope fills (``ops/rescore.py``) equal the host fills bit for bit:
every envelope's status and every float of the region of each that did
not fail, at M = 40, 400, 2000 and 4000 (past a block's shared memory),
envelopes of 1 to 1200 residues, with a NaN, an underflow and an
overflow of the Forward and the Backward, and over launches that the
byte budget cuts; the CPU's launch plan reads the kernel's scratch rule.
"""

import functools
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from bath_tpu_torch import fixtures, sanitize, selfcheck
from bath_tpu_torch.cli import bathsearch
from bath_tpu_torch.ops import domdec as td
from bath_tpu_torch.ops import fs3 as t3
from bath_tpu_torch.ops import fs3_domdec as td3
from bath_tpu_torch.ops import fwd as tf
from bath_tpu_torch.ops import multimodel as mm
from bath_tpu_torch.ops import rescore as rr
from bath_tpu_torch.ops import ssv as ts
from bath_tpu_torch.ops import vit as tv

pytestmark = pytest.mark.cuda


def card_batch(M, B, Lmax):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(M)
    hmm, q = fixtures.make_query(M, rng, calibrate=False)
    p = tf.fwd_params(fixtures.search_profile(hmm), "cuda")
    dsq, lens = fixtures.kernel_batch(q, B, Lmax, rng)
    return p, torch.from_numpy(dsq).cuda(), torch.from_numpy(lens).cuda()


@pytest.mark.parametrize("M", [100, 400, 1500])
def test_fwd_kernel_vs_plain(M):
    p, dsq, lens = card_batch(M, 32, 1200)
    before = tf.fwd_score.launches
    got = tf.fwd_score(dsq, lens, p)
    torch.cuda.synchronize()
    assert tf.fwd_score.launches == before + 1
    want = tf.fwd_score_ref(dsq, lens, p)
    assert float((got - want).abs().max()) <= 1e-3


@pytest.mark.parametrize("M", [100, 400, 1500])
def test_domdec_kernel_vs_plain(M):
    p, dsq, lens = card_batch(M, 8, 1600)
    before = td.domdec.launches
    got = td.domdec(dsq, lens, p)
    torch.cuda.synchronize()
    assert td.domdec.launches == before + 1
    want = td.domdec_ref(dsq, lens, p)
    assert torch.equal(got[3], want[3])
    for a, b in zip(got[:3], want[:3]):
        assert float((a - b).abs().max()) <= 1e-4


def fs_card_batch(M, B, Lmax):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(M)
    hmm, q = fixtures.make_query(M, rng, calibrate=False, fs=True)
    p = t3.fs3_params(fixtures.fs_search_profile(hmm), "cuda")
    dsq, lens = fixtures.fs_window_batch(q, B, Lmax, rng)
    return p, torch.from_numpy(dsq).cuda(), torch.from_numpy(lens).cuda()


@pytest.mark.parametrize("M", [100, 400, 1500])
def test_fs3_kernel_vs_plain(M):
    p, dsq, lens = fs_card_batch(M, 16, 3 * M + 400)
    before = t3.fs3_score.launches
    got = t3.fs3_score(dsq, lens, p)
    torch.cuda.synchronize()
    assert t3.fs3_score.launches == before + 1
    want = t3.fs3_score_ref(dsq, lens, p)
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    assert float((got - want)[fin].abs().max()) <= 1e-3


@pytest.mark.parametrize("M", [100, 400, 1500])
def test_fs3_domdec_kernel_vs_plain(M):
    p, dsq, lens = fs_card_batch(M, 6, 3 * M + 400)
    before = td3.fs3_domdec.launches
    got = td3.fs3_domdec(dsq, lens, p, 100.0 / 103.0)
    torch.cuda.synchronize()
    assert td3.fs3_domdec.launches == before + 1
    want = td3.fs3_domdec_ref(dsq, lens, p, 100.0 / 103.0)
    assert torch.equal(got[3], want[3])
    for a, b in zip(got[:3], want[:3]):
        assert float((a - b).abs().max()) <= 1e-4


def int_case(M, tmp_path):
    """(om, cases on the card as flat, offs, lens): genome, hot, short,
    empty and one 16 500-residue ORF of a small seeded genome."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bath_tpu_torch.hmmfile import read_hmm
    fx = fixtures.write_fixture(M, 30_000, 4, M, calibrate=False,
                                directory=tmp_path)
    om = fixtures.search_profile(read_hmm(fx.hmm_path))
    orfs = fixtures.filter_cases(fx, 64, M, long_len=16_500)
    return om, [torch.from_numpy(a).cuda() for a in ts.pack_stream(orfs)]


@pytest.mark.parametrize("M", [100, 400, 1500])
def test_msv_and_ssv_capture_kernels_vs_plain(M, tmp_path):
    om, (flat, offs, lens) = int_case(M, tmp_path)
    p = ts.msv_params(om, "cuda")
    tjb = torch.from_numpy(p.tjb_for(lens.cpu().numpy())).cuda()
    before = ts.msv_ssv.launches
    got = ts.msv_ssv(flat, offs, lens, tjb, p)
    torch.cuda.synchronize()
    assert ts.msv_ssv.launches == before + 1
    want = ts.msv_ssv_ref(flat, offs, lens, tjb, p)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    for t in (180, -(1 << 30)):
        thr = torch.full_like(tjb, t)
        before = ts.ssv_capture.launches
        got = ts.ssv_capture(flat, offs, lens, tjb, thr, p)
        torch.cuda.synchronize()
        assert ts.ssv_capture.launches == before + 1
        want = ts.ssv_capture_ref(flat, offs, lens, tjb, thr, p)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert bool((got[0] > ts.SSVB_NCAP).any())


@pytest.mark.parametrize("M", [100, 400, 1500])
def test_vit_and_vit_capture_kernels_vs_plain(M, tmp_path):
    om, (flat, offs, lens) = int_case(M, tmp_path)
    p = tv.vit_params(om, "cuda")
    move = torch.from_numpy(p.move_for(lens.cpu().numpy())).cuda()
    before = tv.vit_ints.launches
    got = tv.vit_ints(flat, offs, lens, move, p)
    torch.cuda.synchronize()
    assert tv.vit_ints.launches == before + 1
    want = tv.vit_ints_ref(flat, offs, lens, move, p)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert bool(got[2].any()) and not bool(got[1].all())
    for t in (16_000, -(1 << 30)):
        thr = torch.full_like(move, t)
        before = tv.vit_capture.launches
        got = tv.vit_capture(flat, offs, lens, move, thr, p)
        torch.cuda.synchronize()
        assert tv.vit_capture.launches == before + 1
        want = tv.vit_capture_ref(flat, offs, lens, move, thr, p)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert bool((got[1] > 0).any())


def test_search_on_card_matches_host(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setenv("BATH_MSV_DEVICE", "0")
    monkeypatch.setenv("BATH_VIT_DEVICE", "0")
    fx = fixtures.write_fixture(120, 300_000, 8, 11, directory=tmp_path)
    outs = {}
    for backend, device in (("numpy", "cpu"), ("torch", "cuda")):
        out = tmp_path / f"{backend}.out"
        stats = {}
        assert bathsearch.run(["--backend", backend, "--device", device,
                               "-o", str(out), fx.hmm_path, fx.fasta_path],
                              stats=stats) == 0
        outs[backend] = re.sub(r"# (CPU time|Mc/sec):.*", "",
                               out.read_text())
    assert outs["torch"] == outs["numpy"]
    assert stats["fwd_items"] > 0 and stats["domdec_items"] > 0


@pytest.mark.parametrize("mode", ["--fs", "--fsonly"])
def test_fs_search_on_card_matches_host(tmp_path, monkeypatch, mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setenv("BATH_MSV_DEVICE", "0")
    monkeypatch.setenv("BATH_VIT_DEVICE", "0")
    fx = fixtures.write_fixture(120, 300_000, 8, 11, directory=tmp_path,
                                fs=True, n_frameshift=4)
    outs = {}
    for backend, device in (("numpy", "cpu"), ("torch", "cuda")):
        out, fst = tmp_path / f"{backend}.out", tmp_path / f"{backend}.fst"
        stats = {}
        assert bathsearch.run(["--backend", backend, "--device", device,
                               mode, "--fstblout", str(fst), "-o", str(out),
                               fx.hmm_path, fx.fasta_path],
                              stats=stats) == 0
        outs[backend] = (re.sub(r"# (CPU time|Mc/sec):.*", "",
                                out.read_text()),
                         [ln for ln in fst.read_text().splitlines()
                          if not ln.startswith("#")])
    assert outs["torch"] == outs["numpy"]
    assert stats["fs3_items"] > 0 and stats["fs3domdec_items"] > 0


def test_all_device_search_on_card_matches_host(tmp_path, monkeypatch):
    """BATH_MSV_DEVICE=1 BATH_VIT_DEVICE=1 on the card: byte-identical to
    the host path, every integer-filter kernel launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fx = fixtures.write_fixture(120, 300_000, 8, 11, directory=tmp_path)
    loose = ["--F1", "0.1", "--F2", "0.05"]
    outs = {}
    for backend, device in (("numpy", "cpu"), ("torch", "cuda")):
        monkeypatch.setenv("BATH_MSV_DEVICE", "1")
        monkeypatch.setenv("BATH_VIT_DEVICE", "1")
        out = tmp_path / f"{backend}.out"
        launches = [f.launches for f in (ts.msv_ssv, ts.ssv_capture,
                                         tv.vit_ints, tv.vit_capture)]
        assert bathsearch.run(["--backend", backend, "--device", device,
                               *loose, "-o", str(out), fx.hmm_path,
                               fx.fasta_path]) == 0
        outs[backend] = re.sub(r"# (CPU time|Mc/sec):.*", "",
                               out.read_text())
    assert outs["torch"] == outs["numpy"]
    assert all(f.launches > n for f, n in zip(
        (ts.msv_ssv, ts.ssv_capture, tv.vit_ints, tv.vit_capture), launches))


# models of five padded widths, two of them with several warps per item
MULTI_MS = (60, 100, 300, 400, 600, 1100, 1500)


def multi_case(fs, per_model, Lmax):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    oms, dsq, lens, slot = fixtures.multi_kernel_batch(
        MULTI_MS, per_model, Lmax, 77, fs=fs)
    params = [(t3.fs3_params if fs else tf.fwd_params)(om, "cuda")
              for om in oms]
    pack = (mm.build_fs3_pack if fs else mm.build_fwd_pack)(params)
    return (pack, torch.from_numpy(dsq).cuda(),
            torch.from_numpy(lens).cuda(), slot)


def per_model_rows(slot):
    return [(g, torch.from_numpy(np.nonzero(slot == g)[0]).cuda())
            for g in np.unique(slot).tolist()]


@pytest.mark.parametrize("kind", ["fwd", "fs3"])
def test_multi_gate_vs_plain_and_single(kind):
    fs = kind == "fs3"
    pack, dsq, lens, slot = multi_case(fs, 9, 1500 if fs else 700)
    call, ref, single = (
        (mm.fs3_pack_scores, mm.fs3_pack_scores_ref, t3.fs3_score) if fs
        else (mm.fwd_pack_scores, mm.fwd_pack_scores_ref, tf.fwd_score))
    before = call.launches
    got = call(pack, dsq, lens, slot)
    torch.cuda.synchronize()
    assert call.launches == before + 1
    want = ref(pack, dsq, lens, slot)
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got))
    assert float((got - want)[fin].abs().max()) <= 1e-3
    for g, rows in per_model_rows(slot):
        one = single(dsq[rows].contiguous(), lens[rows].contiguous(),
                     pack.params[g])
        assert torch.equal(one, got[rows]), MULTI_MS[g]


@pytest.mark.parametrize("kind", ["domdec", "fs3_domdec"])
def test_multi_decoding_vs_plain_and_single(kind):
    """The kernel entries' own outputs (normalised increments, or the
    two passes' specials, and logZ) are bit for bit the single-model
    entries'.  The posteriors after ``finish`` agree within 1e-6 only:
    ``torch.cumsum`` on the card sums in an order that depends on the
    batch's shape (1-3 ulp measured on the same values)."""
    from bath_tpu_torch.ops.kernels import loader
    fs = kind == "fs3_domdec"
    pack, dsq, lens, slot = multi_case(fs, 4, 1200 if fs else 700)
    n3 = lens.cpu().numpy() // 3
    dec = torch.from_numpy((n3 / (n3 + 3.0)).astype(np.float32)).cuda()
    if fs:
        call, extra = mm.fs3_domdec_pack_batch, (dec,)
        ref, single = mm.fs3_domdec_pack_batch_ref, td3.fs3_domdec
        prepare = lambda d, ln, sl, pk: loader.prepare_fs3(  # noqa: E731
            d, ln, sl, pk, True)
    else:
        call, extra = mm.domdec_pack_batch, ()
        ref, single = mm.domdec_pack_batch_ref, td.domdec
        prepare = loader.prepare_domdec
    raw = prepare(dsq, lens, slot, pack)(1.0)
    before = call.launches
    got = call(pack, dsq, lens, slot, *extra)
    torch.cuda.synchronize()
    assert call.launches == before + 1
    want = ref(pack, dsq, lens, slot, *extra)
    assert torch.equal(got[3], want[3])
    for a, b in zip(got[:3], want[:3]):
        assert float((a - b).abs().max()) <= 1e-4
    for g, rows in per_model_rows(slot):
        args = (dsq[rows].contiguous(), lens[rows].contiguous(),
                pack.params[g])
        for a, b in zip(prepare(args[0], args[1], None, args[2])(1.0), raw):
            assert torch.equal(a, b[rows]), MULTI_MS[g]
        one = single(*args, *[e[rows] for e in extra])
        assert torch.equal(one[3], got[3][rows])
        for a, b in zip(one[:3], got[:3]):
            assert float((a - b[rows]).abs().max()) <= 1e-6, MULTI_MS[g]


# fs3 models of six padded widths (96, 160, 288, 416, 832, 1248 lanes),
# one, two and three warps a window among them
FS3_CLASS_MS = (60, 150, 250, 400, 700, 1100)


def fs3_class_case(per_model, Lmax):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    oms, dsq, lens, slot = fixtures.multi_kernel_batch(
        FS3_CLASS_MS, per_model, Lmax, 91, fs=True)
    pack = mm.build_fs3_pack([t3.fs3_params(om, "cuda") for om in oms])
    assert len(pack.classes) == 6
    assert {c.W for c in pack.classes.values()} == {1, 2, 3}
    return (pack, torch.from_numpy(dsq).cuda(),
            torch.from_numpy(lens).cuda(), slot)


@pytest.mark.parametrize("kind", ["gate", "decoding"])
def test_fs3_six_widths_in_one_launch(kind):
    """One launch takes all six widths: against the plain version, and
    its kernel outputs bit for bit the single-model entry's, model by
    model.  Decoding runs each window's two passes in groups of their
    own."""
    from bath_tpu_torch.ops.kernels import loader
    pack, dsq, lens, slot = fs3_class_case(3, 1800)
    dec = kind == "decoding"
    run = loader.prepare_fs3(dsq, lens, slot, pack, dec)
    assert run.launches == 1 and run.plan.ncls == 6
    assert len(run.plan.items) == (2 if dec else 1) * len(slot)
    raw = run(1.0)
    raw = raw if dec else (raw,)
    torch.cuda.synchronize()
    if dec:
        n3 = lens.cpu().numpy() // 3
        dl = torch.from_numpy((n3 / (n3 + 3.0)).astype(np.float32)).cuda()
        got = mm.fs3_domdec_pack_batch(pack, dsq, lens, slot, dl)
        want = mm.fs3_domdec_pack_batch_ref(pack, dsq, lens, slot, dl)
        assert torch.equal(got[3], want[3])
        for a, b in zip(got[:3], want[:3]):
            assert float((a - b).abs().max()) <= 1e-4
    else:
        got = mm.fs3_pack_scores(pack, dsq, lens, slot)
        want = mm.fs3_pack_scores_ref(pack, dsq, lens, slot)
        fin = torch.isfinite(want)
        assert torch.equal(fin, torch.isfinite(got))
        assert float((got - want)[fin].abs().max()) <= 1e-3
    for g in range(len(FS3_CLASS_MS)):
        rows = torch.from_numpy(np.nonzero(slot == g)[0]).cuda()
        one = loader.prepare_fs3(dsq[rows].contiguous(),
                                 lens[rows].contiguous(), None,
                                 pack.params[g], dec)(1.0)
        for a, b in zip(one if dec else (one,), raw):
            assert torch.equal(a, b[rows]), FS3_CLASS_MS[g]


@pytest.mark.parametrize("kind", ["gate", "decoding"])
def test_fs3_batch_order_changes_no_bit(kind):
    """The same windows in ascending, descending and shuffled order give
    the same bits, window by window."""
    from bath_tpu_torch.ops.kernels import loader
    pack, dsq, lens, slot = fs3_class_case(2, 2600)
    dec = kind == "decoding"
    ln = lens.cpu().numpy()
    rng = np.random.default_rng(5)
    outs = []
    for perm in (np.argsort(ln, kind="stable"),
                 np.argsort(-ln, kind="stable"), rng.permutation(len(ln))):
        p = torch.from_numpy(perm).cuda()
        r = loader.prepare_fs3(dsq[p].contiguous(), lens[p].contiguous(),
                               slot[perm], pack, dec)(1.0)
        inv = torch.from_numpy(np.argsort(perm)).cuda()
        outs.append([t[inv] for t in (r if dec else (r,))])
    torch.cuda.synchronize()
    for o in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs[0], o))


# the ViterbiFilter's eight padded widths (96 .. 800 lanes in one warp,
# then two and three warps of 17 lanes) and decoding's nine (96 .. 1056
# in one warp, then two and three warps of 33 lanes, read from global
# memory), each in one launch
VIT_CLASS_MS = (60, 150, 250, 400, 520, 700, 1080, 1100)
DD_CLASS_MS = (60, 150, 250, 400, 520, 700, 1000, 1100, 2500)
ORDERS = ("ascending", "descending", "shuffled")


def permuted(lens, how):
    rng = np.random.default_rng(5)
    return {"ascending": np.argsort(lens, kind="stable"),
            "descending": np.argsort(-lens, kind="stable"),
            "shuffled": rng.permutation(len(lens))}[how]


@pytest.mark.parametrize("order", ORDERS)
def test_vit_all_widths_in_one_launch(order):
    """One launch takes every width: exactly the plain version and,
    model by model, the single-model entry, in any order of the
    batch."""
    from bath_tpu_torch.ops.kernels import loader
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    oms, dsq, lens, slot = fixtures.multi_kernel_batch(VIT_CLASS_MS, 5, 600,
                                                       19)
    perm = permuted(lens, order)
    flat, offs, ln = ts.pack_stream([dsq[b, :lens[b]] for b in perm])
    slot = slot[perm]
    params = [tv.vit_params(om, "cuda") for om in oms]
    pack = mm.build_vit_pack(params)
    assert len(pack.classes) == 8
    word = torch.from_numpy(np.array([params[g].move_for([n])[0]
                                      for g, n in zip(slot, ln)],
                                     np.int32)).cuda()
    flat, offs, ln_t = (torch.from_numpy(a).cuda() for a in (flat, offs, ln))
    run = loader.prepare_vit(flat, offs, ln_t, word, slot, pack)
    assert run.launches == 1 and run.plan.ncls == 8
    got = run()
    torch.cuda.synchronize()
    want = mm.vit_ints_multi_ref(pack, flat, offs, ln_t, word, slot)
    assert torch.equal(got, torch.stack([t.to(torch.int32) for t in want]))
    for g, rows in per_model_rows(slot):
        one = tv.vit_ints(flat, offs[rows].contiguous(),
                          ln_t[rows].contiguous(), word[rows].contiguous(),
                          params[g])
        for a, b in zip(one, (got[0], got[1] != 0, got[2] != 0)):
            assert torch.equal(a, b[rows]), VIT_CLASS_MS[g]


@pytest.mark.parametrize("order", ORDERS)
def test_domdec_all_widths_in_one_launch(order):
    """One launch takes every width, each ORF's Forward and Backward in
    groups of their own: within 1e-4 of the plain version with the same
    `ok`, its kernel outputs bit for bit the single-model entry's, model
    by model, in any order of the batch."""
    from bath_tpu_torch.ops.kernels import loader
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    oms, dsq, lens, slot = fixtures.multi_kernel_batch(DD_CLASS_MS, 2, 900,
                                                       23)
    perm = permuted(lens, order)
    dsq, lens, slot = dsq[perm], lens[perm], slot[perm]
    pack = mm.build_domdec_pack([tf.fwd_params(om, "cuda") for om in oms])
    assert len(pack.classes) == 9
    d, ln = torch.from_numpy(dsq).cuda(), torch.from_numpy(lens).cuda()
    run = loader.prepare_domdec(d, ln, slot, pack)
    assert run.launches == 1 and run.plan.ncls == 9
    raw = run(1.0)
    got = td.finish_passes(*raw[:2], ln, raw[2])
    torch.cuda.synchronize()
    want = mm.domdec_pack_batch_ref(pack, d, ln, slot)
    assert torch.equal(got[3], want[3])
    for a, b in zip(got[:3], want[:3]):
        assert float((a - b).abs().max()) <= 1e-4
    for g, rows in per_model_rows(slot):
        one = loader.prepare_domdec(d[rows].contiguous(),
                                    ln[rows].contiguous(), None,
                                    pack.params[g])(1.0)
        for a, b in zip(one, raw):
            assert torch.equal(a, b[rows]), DD_CLASS_MS[g]


def test_multi_entry_refuses_a_cpu_pack():
    """A CUDA batch never reaches a plain version: a pack on the CPU
    raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    oms, dsq, lens, slot = fixtures.multi_kernel_batch((60, 100), 2, 90, 5)
    pack = mm.build_fwd_pack([tf.fwd_params(om) for om in oms])
    with pytest.raises(ValueError):
        mm.fwd_pack_scores(pack, torch.from_numpy(dsq).cuda(),
                           torch.from_numpy(lens).cuda(), slot)


@pytest.mark.parametrize("mode", [[], ["--fs"]], ids=["standard", "fs"])
def test_multiquery_on_card_matches_host(tmp_path, monkeypatch, mode):
    """A 6-model query file (M up to 700: three padded widths, one past
    the reference's 511 limit) through the multi-query drive on the
    card against the port's host drive."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setenv("BATH_MSV_DEVICE", "0")
    monkeypatch.setenv("BATH_VIT_DEVICE", "0")
    fx = fixtures.write_multi_fixture([120, 45, 700, 64, 300, 90], 400_000,
                                      [0, 2, 4], 2, 5, directory=tmp_path,
                                      fs=bool(mode))
    outs = {}
    for backend, device in (("numpy", "cpu"), ("torch", "cuda")):
        out = tmp_path / f"{backend}.out"
        stats = {}
        for f in (mm.fwd_pack_scores, mm.domdec_pack_batch,
                  mm.fs3_pack_scores, mm.fs3_domdec_pack_batch):
            f.launches = 0
        assert bathsearch.run(["--backend", backend, "--device", device,
                               *mode, "-o", str(out), fx.hmm_path,
                               fx.fasta_path], stats=stats) == 0
        outs[backend] = re.sub(r"# (CPU time|Mc/sec):.*", "",
                               out.read_text())
    assert outs["torch"] == outs["numpy"]
    assert mm.fwd_pack_scores.launches > 0
    if mode:
        assert mm.fs3_pack_scores.launches > 0
        assert mm.fs3_domdec_pack_batch.launches > 0
        assert stats["fs3domdec_ok"] == stats["fs3domdec_items"] > 0
    else:
        assert mm.domdec_pack_batch.launches > 0
        assert stats["domdec_ok"] == stats["domdec_items"] > 0


@pytest.mark.parametrize("kind", ["msv", "vit"])
def test_int_multi_vs_plain_and_single(kind):
    """The integer multi-model entries, seven models of five padded
    widths (one to two warps an item): random and homolog-bearing items
    of each model's own, and one shared batch that every model reads at
    repeated offsets, exactly equal to the plain version and, model by
    model, to the single-model entry."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    oms, dsq, lens, slot = fixtures.multi_kernel_batch(MULTI_MS, 6, 300, 11)
    own = [row[:n] for row, n in zip(dsq, lens)]
    shared = own[:5]
    flat, offs, ln = ts.pack_stream(own)
    # the shared items: every model over the first five rows again
    offs = np.r_[offs, np.tile(offs[:5], len(MULTI_MS))]
    ln = np.r_[ln, np.tile(ln[:5], len(MULTI_MS))].astype(np.int32)
    slot = np.r_[slot, np.repeat(np.arange(len(MULTI_MS)), len(shared))]
    flat, offs, ln_t = (torch.from_numpy(a).cuda() for a in (flat, offs, ln))
    if kind == "msv":
        params = [ts.msv_params(om, "cuda") for om in oms]
        pack, call = mm.build_msv_pack(params), mm.msv_ssv_multi
        ref, single = mm.msv_ssv_multi_ref, ts.msv_ssv
        word = np.array([params[g].tjb_for([n])[0]
                         for g, n in zip(slot, ln)], np.int32)
    else:
        params = [tv.vit_params(om, "cuda") for om in oms]
        pack, call = mm.build_vit_pack(params), mm.vit_ints_multi
        ref, single = mm.vit_ints_multi_ref, tv.vit_ints
        word = np.array([params[g].move_for([n])[0]
                         for g, n in zip(slot, ln)], np.int32)
    word = torch.from_numpy(word).cuda()
    before = call.launches
    got = call(pack, flat, offs, ln_t, word, slot)
    torch.cuda.synchronize()
    # one launch a call for every padded width
    assert len(pack.classes) == 5
    assert call.launches == before + 1
    for a, b in zip(got, ref(pack, flat, offs, ln_t, word, slot)):
        assert torch.equal(a, b)
    for g, rows in per_model_rows(slot):
        one = single(flat, offs[rows].contiguous(), ln_t[rows].contiguous(),
                     word[rows].contiguous(), params[g])
        for a, b in zip(one, got):
            assert torch.equal(a, b[rows]), MULTI_MS[g]


def test_device_calibration_on_card_matches_host():
    """calibrate_many_device on the card against the host calibrate:
    mus and the fs5 tau equal, the f32 gates' taus within 0.02."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import copy

    from bath_tpu_torch import constants as C
    from bath_tpu_torch.evalues import CalibrateConfig, calibrate
    from bath_tpu_torch.evalues_device import calibrate_many_device
    rng = np.random.default_rng(3)
    hmms = [fixtures.make_query(M, rng, calibrate=False, fs=True)[0]
            for M in (45, 300, 1100)]
    cfg = CalibrateConfig(fs=True)
    host = copy.deepcopy(hmms)
    for h in host:
        calibrate(h, cfg)
    counters = (mm.msv_ssv_multi, mm.vit_ints_multi, mm.fwd_pack_scores,
                mm.fs3_pack_scores)
    for f in counters:
        f.launches = 0
    calibrate_many_device(hmms, cfg, device="cuda")
    assert all(f.launches > 0 for f in counters)
    for a, b in zip(host, hmms):
        for k in (C.EV_MMU, C.EV_VMU, C.EV_FTAUFS5, C.EV_MLAMBDA):
            assert a.evparam[k] == b.evparam[k], (a.M, k)
        for k in (C.EV_FTAU, C.EV_FTAUFS3):
            assert abs(a.evparam[k] - b.evparam[k]) <= 0.02, (a.M, k)


# the Forward gate's and MSV's widths: one warp of 3 .. 33 lanes, two
# warps of 33 (Mp 2112: the gate's transitions staged, its odds from L2)
GATE_CLASS_MS = (60, 150, 250, 400, 520, 700, 1000, 1100, 1500)


@pytest.mark.parametrize("order", ORDERS)
def test_fwd_all_widths_in_one_launch(order, monkeypatch):
    """One launch takes every width: within 1e-3 nats of the plain
    version and, model by model, bit for bit the single-model entry, in
    any order of the batch; the wide classes read their odds from L2
    with or without their transitions staged, bit for bit alike."""
    from bath_tpu_torch.ops.kernels import loader
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    oms, dsq, lens, slot = fixtures.multi_kernel_batch(GATE_CLASS_MS, 5, 700,
                                                       29)
    perm = permuted(lens, order)
    dsq, lens, slot = dsq[perm], lens[perm], slot[perm]
    pack = mm.build_fwd_pack([tf.fwd_params(om, "cuda") for om in oms])
    assert len(pack.classes) == 8
    d, ln = torch.from_numpy(dsq).cuda(), torch.from_numpy(lens).cuda()
    run = loader.prepare_fwd(d, ln, slot, pack)
    assert run.launches == 1 and run.plan.ncls == 8
    got = run(1.0)
    monkeypatch.setattr(mm, "FWD_WIDE_STAGE", mm.STAGE_NONE)
    none = loader.prepare_fwd(d, ln, slot, pack)(1.0)
    monkeypatch.undo()
    torch.cuda.synchronize()
    assert torch.equal(got, none)
    want = mm.fwd_pack_scores_ref(pack, d, ln, slot)
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got))
    assert float((got - want)[fin].abs().max()) <= 1e-3
    for g, rows in per_model_rows(slot):
        one = tf.fwd_score(d[rows].contiguous(), ln[rows].contiguous(),
                           pack.params[g])
        assert torch.equal(one, got[rows]), GATE_CLASS_MS[g]


@pytest.mark.parametrize("order", ORDERS)
def test_msv_all_widths_in_one_launch(order):
    """One launch takes every width, exactly the plain version and,
    model by model, the single-model entry, in any order of the batch."""
    from bath_tpu_torch.ops.kernels import loader
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    oms, dsq, lens, slot = fixtures.multi_kernel_batch(GATE_CLASS_MS, 5, 600,
                                                       31)
    perm = permuted(lens, order)
    flat, offs, ln = ts.pack_stream([dsq[b, :lens[b]] for b in perm])
    slot = slot[perm]
    params = [ts.msv_params(om, "cuda") for om in oms]
    pack = mm.build_msv_pack(params)
    assert len(pack.classes) == 8
    word = torch.from_numpy(np.array([params[g].tjb_for([n])[0]
                                      for g, n in zip(slot, ln)],
                                     np.int32)).cuda()
    flat, offs, ln_t = (torch.from_numpy(a).cuda() for a in (flat, offs, ln))
    run = loader.prepare_msv(flat, offs, ln_t, word, slot, pack)
    assert run.launches == 1 and run.plan.ncls == 8
    got = run()
    torch.cuda.synchronize()
    want = mm.msv_ssv_multi_ref(pack, flat, offs, ln_t, word, slot)
    assert torch.equal(got, torch.stack(want))
    for g, rows in per_model_rows(slot):
        one = ts.msv_ssv(flat, offs[rows].contiguous(),
                         ln_t[rows].contiguous(), word[rows].contiguous(),
                         params[g])
        for a, b in zip(one, got):
            assert torch.equal(a, b[rows]), GATE_CLASS_MS[g]


LONG_MS = {"vit": 3000, "fs3": 4000, "msv": 4200, "fwd": 4200}


@pytest.mark.parametrize("kind", ["vit", "fs3", "msv", "fwd"])
def test_models_past_shared_memory_vs_plain(kind):
    """The classes whose tables do not fit a block's shared memory:
    the ViterbiFilter and its capture (M = 3000), the fs3 gate and fs3
    decoding (4000), MSV and the Forward gate (4200), through the
    single-model wrappers and a pack of the long model with a short one,
    against their plain versions: the integer filters exactly, the gates
    within 1e-3 nats, decoding within 1e-4."""
    from bath_tpu_torch.ops.kernels import loader
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    M = LONG_MS[kind]
    rng = np.random.default_rng(M)
    hmm, q = fixtures.make_query(M, rng, calibrate=False, fs=kind == "fs3")
    if kind == "fs3":
        p = t3.fs3_params(fixtures.fs_search_profile(hmm), "cuda")
        dsq, lens = (torch.from_numpy(a).cuda()
                     for a in fixtures.fs_window_batch(q, 6, 900, rng))
        plan = loader.prepare_fs3(dsq, lens, None, p, False).plan
        assert list(plan.table[6:8]) == [1, 1]
        got = t3.fs3_score(dsq, lens, p)
        want = t3.fs3_score_ref(dsq, lens, p)
        fin = torch.isfinite(want)
        assert torch.equal(fin, torch.isfinite(got))
        assert float((got - want)[fin].abs().max()) <= 1e-3
        got = td3.fs3_domdec(dsq, lens, p, 100.0 / 103.0)
        want = td3.fs3_domdec_ref(dsq, lens, p, 100.0 / 103.0)
        assert torch.equal(got[3], want[3])
        for a, b in zip(got[:3], want[:3]):
            assert float((a - b).abs().max()) <= 1e-4
        return
    om = fixtures.search_profile(hmm)
    dsq, lens = fixtures.kernel_batch(q, 6, 700, rng)
    if kind == "fwd":
        p = tf.fwd_params(om, "cuda")
        d, ln = torch.from_numpy(dsq).cuda(), torch.from_numpy(lens).cuda()
        assert loader.prepare_fwd(d, ln, None, p).plan.table[7] == \
            mm.FWD_WIDE_STAGE
        got = tf.fwd_score(d, ln, p)
        assert float((got - tf.fwd_score_ref(d, ln, p)).abs().max()) <= 1e-3
        short = tf.fwd_params(fixtures.search_profile(
            fixtures.make_query(90, rng, calibrate=False)[0]), "cuda")
        pack = mm.build_fwd_pack([p, short])
        slot = np.array([0, 1, 0, 1, 0, 0])
        both = mm.fwd_pack_scores(pack, d, ln, slot)
        assert torch.equal(both[torch.from_numpy(slot == 0).cuda()],
                           got[torch.from_numpy(slot == 0).cuda()])
        return
    flat, offs, ln = (torch.from_numpy(a).cuda() for a in ts.pack_stream(
        [row[:n] for row, n in zip(dsq, lens)]))
    if kind == "msv":
        p = ts.msv_params(om, "cuda")
        tjb = torch.from_numpy(p.tjb_for(ln.cpu().numpy())).cuda()
        assert loader.prepare_msv(flat, offs, ln, tjb, None,
                                  p).plan.table[7] == 0
        got = ts.msv_ssv(flat, offs, ln, tjb, p)
        for a, b in zip(got, ts.msv_ssv_ref(flat, offs, ln, tjb, p)):
            assert torch.equal(a, b)
        return
    p = tv.vit_params(om, "cuda")
    move = torch.from_numpy(p.move_for(ln.cpu().numpy())).cuda()
    run = loader.prepare_vit(flat, offs, ln, move, None, p)
    assert run.plan.table[7] != 0
    got = tv.vit_ints(flat, offs, ln, move, p)
    for a, b in zip(got, tv.vit_ints_ref(flat, offs, ln, move, p)):
        assert torch.equal(a, b)
    for t in (1000, -(1 << 30)):
        thr = torch.full_like(move, t)
        got = tv.vit_capture(flat, offs, ln, move, thr, p)
        for a, b in zip(got, tv.vit_capture_ref(flat, offs, ln, move, thr,
                                                p)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["gate", "decoding"])
def test_fs3_direct_loads_equal_the_ring(kind, monkeypatch):
    """The fs3 pair's direct loads (each thread reads its codon rows from
    global memory) give the ring's outputs bit for bit: the same
    arithmetic on the same values, on six widths."""
    from bath_tpu_torch.ops.kernels import loader
    pack, dsq, lens, slot = fs3_class_case(3, 1200)
    runs = []
    for most in (0, 13):      # no class direct, every class direct
        monkeypatch.setattr(mm, "FS3_DIRECT_P", most)
        runs.append(loader.prepare_fs3(dsq, lens, slot, pack,
                                       kind == "decoding"))
    monkeypatch.undo()
    ring, direct = runs
    for run, word in ((ring, 0), (direct, 1)):
        rows = run.plan.table[:mm.PLAN_CLS * run.plan.ncls]
        assert (rows.reshape(-1, mm.PLAN_CLS)[:, 6] == word).all()
    a, b = ring(1.0), direct(1.0)
    torch.cuda.synchronize()
    for x, y in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,)):
        assert torch.equal(x, y)


@functools.lru_cache(maxsize=None)
def long_model(M, fs=False):
    """(profile, query residues) of an uncalibrated model of M positions
    (the fs3 profile with <fs>), made once."""
    hmm, q = fixtures.make_query(M, np.random.default_rng(M + fs),
                                 calibrate=False, fs=fs)
    return (fixtures.fs_search_profile(hmm) if fs
            else fixtures.search_profile(hmm)), q


LONG_KINDS = ["fwd", "msv", "domdec", "vit", "ssv", "fs3"]


@pytest.mark.parametrize("kind", LONG_KINDS)
@pytest.mark.parametrize("M", [7500, 12000, 20000, 40000])
def test_long_models_past_a_block_of_registers(kind, M):
    """Every kernel family on models past a narrow instance's block of
    registers and past a block's warps: the Forward gate and MSV on 14,
    23 (warps of 17 lanes) and 19 warps of 33 lanes an ORF
    (loader.fwd_layout, msv_layout), decoding on 8, 12 and 19 warps of
    33 (loader.layout), the ViterbiFilter on 14 warps of 17 and then two
    and three segments of 16 warps (loader.vit_layout), the SSV capture
    on MSV's, the fs3 pair on 19 and 29 warps of 13 and five segments
    (loader.fs3_layout); at M = 40000 each family walks its rows in five
    to nine segments of 16 warps (loader.segmented).  The gate, MSV and the
    ViterbiFilter through the single-model wrapper and in one launch with
    a model of one warp of 33 lanes (M = 900), against the plain
    versions (the integer filters exactly, the gates within 1e-3 nats),
    the packed call bit for bit the single-model one; decoding and the
    fs3 pair through their wrappers, within 1e-4 and 1e-3 and with the
    same `ok`; the SSV capture and the ViterbiFilter's capture at a
    threshold and at P = 1 (every row crosses: more than 16 events)."""
    from bath_tpu_torch.ops.kernels import loader
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(M + 1)
    if kind == "fs3":
        om, q = long_model(M, fs=True)
        p = t3.fs3_params(om, "cuda")
        d, ln = (torch.from_numpy(a).cuda()
                 for a in fixtures.fs_window_batch(q, 4, 600, rng))
        got = t3.fs3_score(d, ln, p)
        want = t3.fs3_score_ref(d, ln, p)
        fin = torch.isfinite(want)
        assert torch.equal(fin, torch.isfinite(got))
        assert float((got[fin] - want[fin]).abs().max()) <= 1e-3
        got = td3.fs3_domdec(d, ln, p, 100.0 / 103.0)
        want = td3.fs3_domdec_ref(d, ln, p, 100.0 / 103.0)
        assert torch.equal(got[3], want[3])
        for a, b in zip(got[:3], want[:3]):
            assert float((a - b).abs().max()) <= 1e-4
        return
    om, q = long_model(M)
    oms = [om, long_model(900)[0]]
    dsq, lens = fixtures.kernel_batch(q, 6, 300, rng)
    slot = np.array([0, 1, 0, 1, 0, 0])
    if kind == "domdec":
        p = tf.fwd_params(oms[0], "cuda")
        d, ln = torch.from_numpy(dsq).cuda(), torch.from_numpy(lens).cuda()
        got = td.domdec(d, ln, p)
        want = td.domdec_ref(d, ln, p)
        assert torch.equal(got[3], want[3])
        for a, b in zip(got[:3], want[:3]):
            assert float((a - b).abs().max()) <= 1e-4
        return
    if kind == "fwd":
        ps = [tf.fwd_params(om, "cuda") for om in oms]
        d, ln = torch.from_numpy(dsq).cuda(), torch.from_numpy(lens).cuda()
        assert loader.prepare_fwd(d, ln, None, ps[0]).plan.warps == \
            loader.fwd_layout(M)[1]
        got = tf.fwd_score(d, ln, ps[0])
        assert float((got - tf.fwd_score_ref(d, ln, ps[0])).abs().max()) \
            <= 1e-3
        pack = mm.build_fwd_pack(ps)
        both = mm.fwd_pack_scores(pack, d, ln, slot)
        want = mm.fwd_pack_scores_ref(pack, d, ln, slot)
        assert float((both - want).abs().max()) <= 1e-3
        on0 = torch.from_numpy(slot == 0).cuda()
        assert torch.equal(both[on0], got[on0])
        return
    flat, offs, ln = (torch.from_numpy(a).cuda() for a in ts.pack_stream(
        [row[:n] for row, n in zip(dsq, lens)]))
    on0 = torch.from_numpy(slot == 0).cuda()
    if kind == "ssv":
        p = ts.msv_params(oms[0], "cuda")
        tjb = torch.from_numpy(p.tjb_for(ln.cpu().numpy())).cuda()
        for t in (150, -(1 << 30)):
            thr = torch.full_like(tjb, t)
            got = ts.ssv_capture(flat, offs, ln, tjb, thr, p)
            want = ts.ssv_capture_ref(flat, offs, ln, tjb, thr, p)
            for a, b in zip(got, want):
                assert torch.equal(a, b)
        assert bool((got[0] > ts.SSVB_NCAP).any())
        return
    if kind == "vit":
        ps = [tv.vit_params(om, "cuda") for om in oms]
        move = torch.from_numpy(ps[0].move_for(ln.cpu().numpy())).cuda()
        got = tv.vit_ints(flat, offs, ln, move, ps[0])
        for a, b in zip(got, tv.vit_ints_ref(flat, offs, ln, move, ps[0])):
            assert torch.equal(a, b)
        for t in (1000, -(1 << 30)):
            thr = torch.full_like(move, t)
            cap = tv.vit_capture(flat, offs, ln, move, thr, ps[0])
            for a, b in zip(cap, tv.vit_capture_ref(flat, offs, ln, move, thr,
                                                    ps[0])):
                assert torch.equal(a, b)
        pack = mm.build_vit_pack(ps)
        word = torch.from_numpy(np.array([ps[g].move_for([int(n)])[0]
                                          for g, n in zip(slot, lens)],
                                         np.int32)).cuda()
        both = mm.vit_ints_multi(pack, flat, offs, ln, word, slot)
        for a, b in zip(both, mm.vit_ints_multi_ref(pack, flat, offs, ln,
                                                    word, slot)):
            assert torch.equal(a, b)
        for a, b in zip(both, got):
            assert torch.equal(a[on0], b[on0])
        return
    ps = [ts.msv_params(om, "cuda") for om in oms]
    tjb = torch.from_numpy(ps[0].tjb_for(ln.cpu().numpy())).cuda()
    got = ts.msv_ssv(flat, offs, ln, tjb, ps[0])
    for a, b in zip(got, ts.msv_ssv_ref(flat, offs, ln, tjb, ps[0])):
        assert torch.equal(a, b)
    pack = mm.build_msv_pack(ps)
    word = torch.from_numpy(np.array([ps[g].tjb_for([int(n)])[0]
                                      for g, n in zip(slot, lens)],
                                     np.int32)).cuda()
    both = mm.msv_ssv_multi(pack, flat, offs, ln, word, slot)
    for a, b in zip(both, mm.msv_ssv_multi_ref(pack, flat, offs, ln, word,
                                               slot)):
        assert torch.equal(a, b)
    for a, b in zip(both, got):
        assert torch.equal(a[on0], b[on0])


# a model past 16 warps (and inside 32) under each family's ladder
WIDE_M = {"fwd": 12000, "domdec": 20000, "msv": 20000, "fs3": 8000}


@pytest.mark.parametrize("kind", sorted(WIDE_M))
def test_a_wide_model_beside_a_segmented_one(kind):
    """One launch of an M = 40000 model, a model past 16 warps (which the
    plan segments too: the segmented instance's blocks hold 16 warps)
    and an M = 900 one, against the plain versions: MSV bit for bit, the
    gates within 1e-3 nats, decoding within 1e-4 with the same `ok`."""
    from bath_tpu_torch.ops.kernels import loader
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(11)
    fs = kind == "fs3"
    oms = [long_model(M, fs=fs)[0] for M in (40000, WIDE_M[kind], 900)]
    q = long_model(WIDE_M[kind], fs=fs)[1]
    slot = np.array([0, 1, 2, 1, 0, 2, 1])
    if fs:
        pack = mm.build_fs3_pack([t3.fs3_params(om, "cuda") for om in oms])
        d, ln = (torch.from_numpy(a).cuda()
                 for a in fixtures.fs_window_batch(q, len(slot), 600, rng))
        run = loader.prepare_fs3(d, ln, slot, pack, False)
        assert run.plan.warps == loader.SEG_WARPS
        got = mm.fs3_pack_scores(pack, d, ln, slot)
        want = mm.fs3_pack_scores_ref(pack, d, ln, slot)
        fin = torch.isfinite(want)
        assert torch.equal(fin, torch.isfinite(got))
        assert float((got[fin] - want[fin]).abs().max()) <= 1e-3
        got = mm.fs3_domdec_pack_batch(pack, d, ln, slot, 100.0 / 103.0)
        want = mm.fs3_domdec_pack_batch_ref(pack, d, ln, slot,
                                            100.0 / 103.0)
        assert torch.equal(got[3], want[3])
        for a, b in zip(got[:3], want[:3]):
            assert float((a - b).abs().max()) <= 1e-4
        return
    dsq, lens = fixtures.kernel_batch(q, len(slot), 300, rng)
    if kind in ("fwd", "domdec"):
        pack = mm.build_fwd_pack([tf.fwd_params(om, "cuda") for om in oms])
        d, ln = torch.from_numpy(dsq).cuda(), torch.from_numpy(lens).cuda()
        if kind == "fwd":
            gate = pack.with_layout(loader.fwd_layout)
            assert loader.prepare_fwd(d, ln, slot, gate).plan.warps == \
                loader.SEG_WARPS
            got = mm.fwd_pack_scores(gate, d, ln, slot)
            want = mm.fwd_pack_scores_ref(gate, d, ln, slot)
            assert float((got - want).abs().max()) <= 1e-3
            return
        assert loader.prepare_domdec(d, ln, slot, pack).plan.warps == \
            loader.SEG_WARPS
        got = mm.domdec_pack_batch(pack, d, ln, slot)
        want = mm.domdec_pack_batch_ref(pack, d, ln, slot)
        assert torch.equal(got[3], want[3])
        for a, b in zip(got[:3], want[:3]):
            assert float((a - b).abs().max()) <= 1e-4
        return
    ps = [ts.msv_params(om, "cuda") for om in oms]
    flat, offs, ln = (torch.from_numpy(a).cuda() for a in ts.pack_stream(
        [row[:n] for row, n in zip(dsq, lens)]))
    pack = mm.build_msv_pack(ps)
    word = torch.from_numpy(np.array([ps[g].tjb_for([int(n)])[0]
                                      for g, n in zip(slot, lens)],
                                     np.int32)).cuda()
    assert loader.prepare_msv(flat, offs, ln, word, slot, pack).plan.warps \
        == loader.SEG_WARPS
    both = mm.msv_ssv_multi(pack, flat, offs, ln, word, slot)
    for a, b in zip(both, mm.msv_ssv_multi_ref(pack, flat, offs, ln, word,
                                               slot)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["msv", "ssv"])
def test_segmented_blocks_take_turns_at_the_slots(kind):
    """More segmented blocks than the card holds at once (1200 ORFs of an
    M = 40000 model, one block each): the scratch has a slot for each
    block the card holds (loader._planned), which the blocks take and
    free in turn; MSV and the SSV capture (at P = 1: every row crosses)
    equal their plain versions bit for bit."""
    from bath_tpu_torch.ops.kernels import loader
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(12)
    om, q = long_model(40000)
    p = ts.msv_params(om, "cuda")
    dsq, lens = fixtures.kernel_batch(q, 1200, 40, rng)
    flat, offs, ln = (torch.from_numpy(a).cuda() for a in ts.pack_stream(
        [row[:n] for row, n in zip(dsq, lens)]))
    tjb = torch.from_numpy(p.tjb_for(ln.cpu().numpy())).cuda()
    if kind == "msv":
        run = loader.prepare_msv(flat, offs, ln, tjb, None, p)
        got = run()
        want = ts.msv_ssv_ref(flat, offs, ln, tjb, p)
    else:
        thr = torch.full_like(tjb, -(1 << 30))
        run = loader.prepare_ssv_capture(flat, offs, ln, tjb, thr, p)
        got = run()
        want = ts.ssv_capture_ref(flat, offs, ln, tjb, thr, p)
    (buf,) = run.plan.buffers
    n = int(buf[:4].view(torch.int32)[0])
    assert n == loader.sms(flat.device) * (
        loader.SM_THREADS // (32 * loader.SEG_WARPS)) < 1200
    assert int(buf[4:4 * (n + 1)].view(torch.int32).abs().sum()) == 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)



# the sanitizer tier's cases and the self-check entry points on the card
SANITIZE_CASES = [c.name for c in sanitize.cuda_cases()]


@pytest.mark.parametrize("name", SANITIZE_CASES)
def test_sanitizer_case_on_the_card(name):
    """Each case of ``bath_tpu_torch.sanitize`` (every kernel entry in
    each plan family at tiny shapes) against its plain version, with no
    tool: what memcheck and the other tools run under them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    case = next(c for c in sanitize.cuda_cases() if c.name == name)
    assert set(sanitize.run_case(case, "cuda")) == set(case.entries)


def test_selfcheck_on_the_card():
    """``selfcheck.entry`` launches bt_fs3_parser once, within 1e-3 nats
    of its plain version; ``dryrun_multichip(2)`` passes on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fn, args = selfcheck.entry()
    before = t3.fs3_score.launches
    got = fn(*args)
    assert t3.fs3_score.launches == before + 1
    want = t3.fs3_score_ref(*args, t3.fs3_params(selfcheck.flagship()[1],
                                                 "cuda"), 1.0)
    assert float((got - want).abs().max()) <= 1e-3
    rep = selfcheck.dryrun_multichip(2)
    assert len(rep["devices"]) == 2 and set(rep["mesh_items"]) == set(
        selfcheck.MODES)


STAGE_SECONDS = """
import json
import numpy as np
from types import SimpleNamespace
from bath_tpu_torch import fixtures
from bath_tpu_torch.device_pipeline import TorchCascade
rng = np.random.default_rng(400)
hmm, q = fixtures.make_query(400, rng, calibrate=False)
dsq, lens = fixtures.kernel_batch(q, 64, 600, rng)
seqs = [d[:n].copy() for d, n in zip(dsq, lens)]
stats = {}
tc = TorchCascade(fixtures.search_profile(hmm), device="cuda", stats=stats)
for _ in range(2):
    tc.fwd_scores(seqs, lens)
    tc.domdec([SimpleNamespace(dsq=s, n=len(s)) for s in seqs])
print("STATS", json.dumps({k: v for k, v in stats.items()
                           if isinstance(v, (int, float))}))
"""


@pytest.mark.parametrize("tracing", [False, True], ids=["off", "on"])
def test_stage_device_seconds(tracing):
    """``<key>_dev_s``: 0 < it <= ``<key>_s`` with tracing on, absent with
    it off; the cells counted either way."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    env = dict(os.environ)
    env.pop("BATH_PHASE_STATS", None)
    if tracing:
        env["BATH_PHASE_STATS"] = "1"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", STAGE_SECONDS],
                       capture_output=True, text=True, timeout=600,
                       cwd=root, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    stats = json.loads(r.stdout.split("STATS ", 1)[1])
    for key in ("fwd", "domdec"):
        assert stats[f"{key}_padded_cells"] >= stats[f"{key}_cells"] > 0
        if tracing:
            assert 0 < stats[f"{key}_dev_s"] <= stats[f"{key}_s"]
        else:
            assert f"{key}_dev_s" not in stats


RESCORE_LENS = [1, 2, 7, 8, 9, 63, 64, 65, 127, 128, 129, 300, 401, 777, 1200]


def hold_fills(got, want):
    """Each envelope's status equal, the region of each that did not
    fail equal bit for bit."""
    assert len(got) == len(want)
    for e, (g, w) in enumerate(zip(got, want)):
        assert g.status == w.status, e
        if w.status == 0:
            assert torch.equal(torch.from_numpy(g.region).view(torch.int32),
                               torch.from_numpy(w.region).view(torch.int32)), e


def rescore_case(M, lens, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(seed)
    hmm, q = fixtures.make_query(M, rng, calibrate=False)
    om = fixtures.search_profile(hmm)
    dsqs, xffs = fixtures.envelope_batch(om, q, lens, rng)
    return om, dsqs, xffs


@pytest.mark.parametrize("M", [40, 400, 2000, 4000])
def test_rescore_kernel_equals_the_native_fills(M):
    """Every envelope of one launch, lengths 1-1200 (M = 4000: the
    working vectors in global memory), bit for bit the native fills."""
    lens = RESCORE_LENS if M < 4000 else [1, 8, 129, 300]
    om, dsqs, xffs = rescore_case(M, lens, M + 7)
    got = rr.rescore(rr.rescore_params(om, "cuda"), dsqs, xffs)
    want = rr.rescore(rr.rescore_params(om), dsqs, xffs)
    hold_fills(got, want)
    # a long background envelope may fail on the host too (its status)
    assert 2 * sum(f.status == 0 for f in want) > len(want)
    if M >= 400:
        assert any((f.spec("fscale") != 1).any() for f in want)


def test_rescore_kernel_statuses():
    """A NaN, an underflow and an overflow of the Forward, a NaN and an
    underflow of the Backward: the statuses of the host fills, the other
    regions bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    om, dsqs, xffs = fixtures.failing_envelopes(100, 7, 5)
    want = rr.rescore(rr.rescore_params(om), dsqs, xffs)
    got = rr.rescore(rr.rescore_params(om, "cuda"), dsqs, xffs)
    assert [f.status for f in want] == [1, 2, 3, 4, 5, 0, 0]
    hold_fills(got, want)


@pytest.mark.parametrize("M", [1, 40, 400, 2000, 3300, 3500, 4000, 9000])
def test_rescore_scratch_rule_is_the_kernels(M):
    """``rescore._scratch_floats``, which plans the launches on the CPU
    too, is the kernel's own rule (``bt_rescore_scratch_floats``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bath_tpu_torch.ops.kernels import loader
    nleaf = int(rr.pairwise_plan(M)[0])
    assert rr._scratch_floats(M) == \
        int(loader.lib().bt_rescore_scratch_floats(M, nleaf))


def test_rescore_kernel_over_budget_launches():
    """24 envelopes of 1200 residues at M = 2000 hold 1.16 GB of outputs:
    two launches under RESCORE_BYTES (1 GiB), and twelve under a budget
    of two and a half envelopes' bytes; every envelope bit for bit the
    native fills."""
    om, dsqs, xffs = rescore_case(2000, [1200] * 24, 11)
    lens = [len(d) for d in dsqs]
    assert len(rr.batch_plan(lens, 2000)) == 2
    small = 5 * 4 * rr.region_floats(1200, 2000) // 2
    assert len(rr.batch_plan(lens, 2000, small)) == 12
    want = rr.rescore(rr.rescore_params(om), dsqs, xffs)
    pc = rr.rescore_params(om, "cuda")
    hold_fills(rr.rescore(pc, dsqs, xffs), want)
    hold_fills(rr.rescore(pc, dsqs, xffs, small), want)
