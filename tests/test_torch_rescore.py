"""Envelope rescoring split into plan, fills and finish, on the CPU.

The device cascade (``device_pipeline.flush_downstream``) plans the
domains of every F3 survivor of a flush (``domaindef.plan_domains_bath``:
the region scan and the ensemble), fills every envelope in one call of
``TorchCascade.rescore`` and finishes the survivors in order
(``pipeline.finish_survivors``).  On the CPU the stage's plain version is
the native host fills, called through the batched interface
(``ops/rescore.py`` ``rescore_plain``), so these tests drive the new
plumbing:

- the plain version's regions give the host fills' scores and matrices
  bit for bit, and numpy's pairwise sums follow the kernel's plan;
- ``--backend torch --device cpu`` and the port's ``--backend numpy``
  write the bytes (``-o`` and ``--tblout``, the statistics included) of
  the JAX package's ``--backend numpy`` on a genome of tandem copies,
  where regions are multidomain (the ensemble's envelopes, whose null2 it
  set) and envelopes overlap, with every envelope filled by the stage
  and none by the host; where an envelope's Forward fails (a
  ``RangeError`` on the host, a status from the stage), the port's two
  backends still write the same bytes;
- the three paths that keep the host fills (the serial numpy drive, the
  multi-query drive, the standard branch inside ``--fs``) count them in
  ``rescore_host_items`` and never call the stage.
"""

import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from bath_tpu_torch import domaindef, fixtures, native, pipeline
from bath_tpu_torch.cli import bathsearch
from bath_tpu_torch.device_pipeline import TorchCascade
from bath_tpu_torch.hmmfile import write_hmm
from bath_tpu_torch.ops import rescore as rr
from torch_threads import one_torch_thread  # noqa: F401

F32 = np.float32
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pairwise_by_plan(a: np.ndarray) -> F32:
    """The kernel's pairwise sum of <a> (f32) through ``pairwise_plan``:
    each leaf in eight strided accumulators, combined as
    ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)) plus its tail, then the ops in
    order."""
    pw = rr.pairwise_plan(len(a))
    nleaf, nops = int(pw[0]), int(pw[1])
    assert nops == nleaf - 1 and len(pw) == 2 + 2 * nleaf + 2 * nops
    off, ln = pw[2:2 + nleaf], pw[2 + nleaf:2 + 2 * nleaf]
    ops = pw[2 + 2 * nleaf:]
    lhs, rhs = ops[:nops], ops[nops:]
    val = []
    for o, n in zip(off, ln):
        x = a[o:o + n]
        if n < 8:
            s = F32(0)
            for v in x:
                s = F32(s + v)
        else:
            full = n - n % 8
            r = x[:8].copy()
            for i in range(8, full, 8):
                r = (r + x[i:i + 8]).astype(F32)
            s = F32(F32(F32(r[0] + r[1]) + F32(r[2] + r[3]))
                    + F32(F32(r[4] + r[5]) + F32(r[6] + r[7])))
            for v in x[full:]:
                s = F32(s + v)
        val.append(s)
    for lo, hi in zip(lhs, rhs):
        assert lo < len(val) and hi < len(val)
        val.append(F32(val[lo] + val[hi]))
    return val[-1]


@pytest.mark.parametrize("n", [1, 5, 8, 13, 64, 128, 129, 255, 400, 401,
                               1000, 2000, 4096, 9999])
def test_pairwise_plan_is_numpys_sum(n):
    a = np.random.default_rng(n).random(n).astype(F32) * F32(3.0)
    assert pairwise_by_plan(a).view(np.int32) == a.sum().view(np.int32)


def test_batch_plan_cuts_by_bytes():
    M = 400
    one = 4 * rr.region_floats(300, M)
    lens = [300] * 7
    assert [len(b) for b in rr.batch_plan(lens, M)] == [7]
    assert [b.tolist() for b in rr.batch_plan(lens, M, 3 * one)] == \
        [[0, 1, 2], [3, 4, 5], [6]]
    # an envelope past the budget takes a launch alone
    assert [b.tolist() for b in rr.batch_plan([10, 5000, 10], M, one)] \
        == [[0], [1], [2]]
    # past a block's shared memory each envelope also holds its scratch
    assert rr._scratch_floats(400) == 0 and rr._scratch_floats(4000) > 0


def test_plain_version_is_the_host_fills():
    """Every envelope's score, posterior and OA matrices and trace from
    the batched plain version equal ``domaindef.host_fills`` bit for bit,
    over launches that the byte budget cuts."""
    from bath_tpu_torch.ops.reference import fwdback as fb
    rng = np.random.default_rng(3)
    hmm, q = fixtures.make_query(60, rng, calibrate=False)
    om = fixtures.search_profile(hmm)
    lens = [1, 2, 9, 60, 61, 130, 300]
    dsqs, xffs = fixtures.envelope_batch(om, q, lens, rng)
    p = rr.rescore_params(om)
    budget = 2 * 4 * rr.region_floats(130, 60)
    assert len(rr.batch_plan(lens, 60, budget)) > 1
    for d, f in zip(dsqs, rr.rescore(p, dsqs, xffs, budget)):
        om.reconfig_unihit(len(d))
        want = domaindef.host_fills(om, d)
        got = f.host(om)
        assert got is not None and f.status == 0
        assert got[0] == want[0] and got[3] == want[3]
        for a, b in ((want[1].mm, got[1].mm), (want[1].im, got[1].im),
                     (want[1].xN, got[1].xN), (want[1].xJ, got[1].xJ),
                     (want[1].xC, got[1].xC), (want[2].mm, got[2].mm),
                     (want[2].im, got[2].im), (want[2].dm, got[2].dm),
                     (want[2].xE, got[2].xE), (want[2].xN, got[2].xN),
                     (want[2].xJ, got[2].xJ), (want[2].xB, got[2].xB),
                     (want[2].xC, got[2].xC)):
            assert np.array_equal(np.asarray(a, F32).view(np.int32),
                                  np.ascontiguousarray(b).view(np.int32))
        t1, t2 = fb.oa_trace(om, want[1], want[2]), fb.oa_trace(om, *got[1:3])
        assert (t1.st, t1.k, t1.i, t1.pp) == (t2.st, t2.k, t2.i, t2.pp)


def test_same_fills_reads_statuses_and_bits():
    rng = np.random.default_rng(6)
    hmm, q = fixtures.make_query(40, rng, calibrate=False)
    om = fixtures.search_profile(hmm)
    dsqs, xffs = fixtures.envelope_batch(om, q, [30, 50], rng)
    p = rr.rescore_params(om)
    a, b = rr.rescore(p, dsqs, xffs), rr.rescore(p, dsqs, xffs)
    assert rr.same_fills(a, b) and not rr.same_fills(a, b[:1])
    b[1].region[7] = np.nextafter(b[1].region[7], F32(np.inf))
    assert not rr.same_fills(a, b)
    # a failed fill: its status must agree, its region is not read
    a[1].status = b[1].status = 2
    assert rr.same_fills(a, b)
    b[1].status = 1
    assert not rr.same_fills(a, b)


def test_plain_version_statuses():
    """The host's RangeErrors as statuses (``rescore.STATUS``): a NaN,
    an underflow and an overflow of the Forward, a NaN and an underflow
    of the Backward."""
    om, dsqs, xffs = fixtures.failing_envelopes(100, 6, 5)
    fills = rr.rescore(rr.rescore_params(om), dsqs, xffs)
    assert [f.status for f in fills] == [1, 2, 3, 4, 5, 0]
    assert [f.host(om) is None for f in fills] == [True] * 5 + [False]
    assert sorted(rr.STATUS.values()) == list(range(1, 8))


def tandem_fixture(directory, seed=5, M=80, G=40_000):
    """A query and a genome of four sites of two or three tandem mutated
    copies (the second cut to its last two thirds), no linker: regions
    the scan finds multidomain, whose ensemble envelopes overlap."""
    rng = np.random.default_rng(seed)
    hmm, q = fixtures.make_query(M, rng)
    codons = fixtures._codons()
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, G)]
    pos = 1000
    for ncopy in (2, 3, 2, 3):
        parts = []
        for c in range(ncopy):
            aa = fixtures._mutate(q, rng)
            parts.append(aa[len(aa) // 3:] if c == 1 else aa)
        dna = "".join(codons[int(a)][rng.integers(len(codons[int(a)]))]
                      for a in np.concatenate(parts))
        seq[pos:pos + len(dna)] = np.frombuffer(dna.encode(), np.uint8)
        pos += len(dna) + 5000
    buf = io.StringIO()
    write_hmm(buf, hmm)
    hmm_path, fa_path = directory / "tandem.bhmm", directory / "tandem.fa"
    hmm_path.write_text(buf.getvalue())
    s = seq.tobytes().decode()
    fa_path.write_text(">tandem\n" + "\n".join(
        s[i:i + 80] for i in range(0, len(s), 80)) + "\n")
    return str(hmm_path), str(fa_path)


KEEP = re.compile(r"# (CPU time|Mc/sec|Date|Current dir|Option settings)")


def read_out(out, tbl):
    """The lines of -o and --tblout, without those that name the run's
    time, date or directory, their runs of spaces as one."""
    return [re.sub(r"\s+", " ", ln) for f in (out, tbl)
            for ln in f.read_text().splitlines() if not KEEP.match(ln)]


def run(tmp_path, args, hmm, fa, tag):
    stats = {}
    out, tbl = tmp_path / f"{tag}.out", tmp_path / f"{tag}.tbl"
    assert bathsearch.run([*args, "-o", str(out), "--tblout", str(tbl),
                           hmm, fa], stats=stats) == 0
    return read_out(out, tbl), stats


def reference_out(tmp_path, hmm, fa):
    """-o and --tblout of the JAX package's ``--backend numpy`` search
    (``bath_tpu.cli.bathsearch``, in a subprocess on the CPU)."""
    out, tbl = tmp_path / "reference.out", tmp_path / "reference.tbl"
    env = dict(os.environ, BATH_MSV_DEVICE="0", BATH_VIT_DEVICE="0",
               JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-m", "bath_tpu.cli.bathsearch", "--backend",
         "numpy", "-o", str(out), "--tblout", str(tbl), hmm, fa],
        capture_output=True, text=True, timeout=600, cwd=ROOT, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    return read_out(out, tbl)


@pytest.fixture()
def host_paths(monkeypatch):
    monkeypatch.setenv("BATH_MSV_DEVICE", "0")
    monkeypatch.setenv("BATH_VIT_DEVICE", "0")


def test_split_is_byte_identical_to_the_serial_drive(tmp_path, monkeypatch,
                                                    host_paths):
    """The port's two backends write the JAX package's ``--backend
    numpy`` bytes on the tandem genome, every envelope of the torch
    backend filled by the stage; with one Forward made to fail (on the
    port alone: the JAX package runs in its own process), the torch
    backend still writes the numpy backend's bytes."""
    hmm, fa = tandem_fixture(tmp_path)
    ref = reference_out(tmp_path, hmm, fa)
    plans = []
    plan = domaindef.plan_domains_bath

    def spy(*a, **k):
        plans.append(plan(*a, **k))
        return plans[-1]
    monkeypatch.setattr(domaindef, "plan_domains_bath", spy)
    want, st_n = run(tmp_path, ["--backend", "numpy"], hmm, fa, "numpy")
    multi = [envs for p in plans for m, envs in p.regions if m]
    single = [envs for p in plans for m, envs in p.regions if not m]
    overlaps = sum(b[0] <= a[1] for envs in multi
                   for a, b in zip(envs, envs[1:]))
    # the fixture's regions: multidomain ones (the ensemble), overlapping
    # envelopes, and single ones
    assert len(multi) >= 2 and overlaps >= 1 and single
    n_env = sum(len(p.envelopes()) for p in plans)
    assert st_n == {"rescore_host_items": n_env}
    assert want == ref
    calls = []
    stage = TorchCascade.rescore

    def counted(self, envs):
        calls.append(len(envs))
        return stage(self, envs)
    monkeypatch.setattr(TorchCascade, "rescore", counted)
    got, st_t = run(tmp_path, ["--backend", "torch", "--device", "cpu"],
                    hmm, fa, "torch")
    assert got == ref
    assert sum(calls) == st_t["rescore_items"] == n_env
    assert st_t["rescore_host_items"] == 0

    # one single-region envelope's Forward fails, on either path
    fail_L = single[0][0][1] - single[0][0][0] + 1
    lib = native._fs5_lib()
    native._bind_fwdfill(lib)
    real = lib.bio_fwd_fill
    failed = []

    def fwd_fill(dsq, L, *rest):
        st = real(dsq, L, *rest)
        if rest[2] == 1 and L == fail_L:
            failed.append(L)
            return 2
        return st
    monkeypatch.setattr(lib, "bio_fwd_fill", fwd_fill)
    calls.clear()
    want2, st_n2 = run(tmp_path, ["--backend", "numpy"], hmm, fa, "numpy2")
    assert failed and want2 != want and not calls
    n_host = len(failed)
    failed.clear()
    got, st_t = run(tmp_path, ["--backend", "torch", "--device", "cpu"],
                    hmm, fa, "torch2")
    assert got == want2
    assert len(failed) == n_host
    assert sum(calls) == st_t["rescore_items"] == n_env
    assert st_t["rescore_host_items"] == 0
    assert st_t["rescore_cells"] == st_t["rescore_padded_cells"] > 0
    assert st_t["rescore_batches"] == len(calls)


def test_unhooked_paths_keep_the_host_fills(tmp_path, monkeypatch,
                                            host_paths):
    """The serial numpy drive, the multi-query drive and the standard
    branch inside --fs fill on the host, count it, and never call the
    stage."""
    def refuse(self, envs):
        raise AssertionError("the stage was called")
    monkeypatch.setattr(TorchCascade, "rescore", refuse)
    hmm, fa = tandem_fixture(tmp_path, seed=7, G=20_000)
    _, st = run(tmp_path, ["--backend", "numpy"], hmm, fa, "serial")
    assert st["rescore_host_items"] > 0 and "rescore_items" not in st

    mq = fixtures.write_multi_fixture([50, 70], 60_000, [0, 1], 2, 5,
                                      directory=tmp_path)
    _, st = run(tmp_path, ["--backend", "torch", "--device", "cpu"],
                mq.hmm_path, mq.fasta_path, "mq")
    assert len(st["mq_stages"]) > 0
    assert st["rescore_host_items"] > 0 and not st.get("rescore_items")

    fx = fixtures.write_fixture(60, 60_000, 4, 3, fs=True, n_frameshift=1,
                                directory=tmp_path)
    _, st = run(tmp_path, ["--backend", "torch", "--device", "cpu", "--fs"],
                fx.hmm_path, fx.fasta_path, "fs")
    assert st["fs3_items"] > 0
    assert st["rescore_host_items"] > 0 and not st.get("rescore_items")


def test_serial_pipeline_counts_host_fills(tmp_path, host_paths):
    """``pipeline_bath`` (no stage, no stats dict) counts its fills in
    its DomainDef, which ``run`` adds to ``stats``."""
    hmm, fa = tandem_fixture(tmp_path, seed=9, G=20_000)
    counts = []
    finish = pipeline._finish_survivor

    def spy(pli, *a, **k):
        before = pli.ddef.host_fills
        finish(pli, *a, **k)
        counts.append(pli.ddef.host_fills - before)
    pipeline._finish_survivor = spy
    try:
        _, st = run(tmp_path, ["--backend", "numpy"], hmm, fa, "serial")
    finally:
        pipeline._finish_survivor = finish
    assert counts and all(c > 0 for c in counts)
    assert st["rescore_host_items"] == sum(counts)
