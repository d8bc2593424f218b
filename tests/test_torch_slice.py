"""The bath_tpu_torch slice end to end: ``bath_tpu_torch.cli.bathsearch
--backend torch`` against ``bath_tpu --backend numpy`` on a seeded
fixture (M = 120, 300 kb, 8 embeds), and with ``--fs``/``--fsonly`` on
its frameshift twin (the query calibrated for frameshift search, 4 of
the 8 embeds carrying a 1-nt deletion or insertion), on the CPU through
the kernels' plain versions.

Byte identity alone is weak evidence (the gate band and the per-item
`ok` fallback absorb device error), so the BATH_DEVICE_PERTURB twin of
tests/test_device_pipeline.py shows the gate scores reach the output,
and the kernel modules are held to the JAX package numerically in
test_torch_fwd.py, test_torch_domdec.py, test_torch_fs3.py and
test_torch_fs3_domdec.py (the integer filters, exactly, in
test_torch_ssv.py and test_torch_vit.py).  The searches pin
BATH_MSV_DEVICE/BATH_VIT_DEVICE to 0, the production default of a host
with the native library (conftest.py sets 1 for the JAX package's
tests); the all-device cascade's searches, which set both to 1 and run
the integer filters through the port too, are in
test_torch_slice_all_device.py (the longest of these searches, apart so
that the test workers share them).
"""

import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from bath_tpu import constants as C
from bath_tpu.hmmfile import read_hmm
from bath_tpu.ops.reference.filters import msv_filter, viterbi_filter
from bath_tpu.pipeline import DEVICE_GATE_BAND
from bath_tpu_torch import fixtures
from bath_tpu_torch.cli import bathsearch
from bath_tpu_torch.device_pipeline import TorchCascade, batches
from bath_tpu_torch.ops import fwd as tf
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    return fixtures.write_fixture(120, 300_000, 8, 11,
                                  directory=tmp_path_factory.mktemp("fx"))


@pytest.fixture(scope="module")
def fs_fx(tmp_path_factory):
    return fixtures.write_fixture(120, 300_000, 8, 11, fs=True,
                                  n_frameshift=4,
                                  directory=tmp_path_factory.mktemp("fsfx"))


def search(fx, tmp_path, module, args, env_extra=None, hmm=None):
    env = dict(os.environ, BATH_MSV_DEVICE="0", BATH_VIT_DEVICE="0",
               JAX_PLATFORMS="cpu")
    env.update(env_extra or {})
    tbl = tmp_path / f"{module}-{len(os.listdir(tmp_path))}.tbl"
    r = subprocess.run(
        [sys.executable, "-m", module, *args, "--tblout", str(tbl),
         hmm or fx.hmm_path, fx.fasta_path],
        capture_output=True, text=True, timeout=600, cwd=ROOT, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    return re.sub(r"# (CPU time|Mc/sec):.*", "", r.stdout), str(tbl)


def fs_search(fx, tmp_path, backend, mode, env_extra=None):
    """(output, --fstblout without its '#' lines, its path, the
    --tblout path) of a <mode> search (--fs or --fsonly) with
    <backend>."""
    fst = tmp_path / f"{backend}-{len(os.listdir(tmp_path))}.fst"
    args = ["--backend", "numpy"] if backend == "numpy" else \
        ["--backend", "torch", "--device", "cpu"]
    module = "bath_tpu.cli.bathsearch" if backend == "numpy" \
        else "bath_tpu_torch.cli.bathsearch"
    out, tbl = search(fx, tmp_path, module,
                      [*args, mode, "--fstblout", str(fst)], env_extra)
    rows = "".join(line for line in fst.read_text().splitlines(True)
                   if not line.startswith("#"))
    return out, rows, str(fst), tbl


def numpy_out(fx, tmp_path, hmm=None):
    return search(fx, tmp_path, "bath_tpu.cli.bathsearch",
                  ["--backend", "numpy"], hmm=hmm)


def torch_out(fx, tmp_path, env_extra=None, hmm=None):
    return search(fx, tmp_path, "bath_tpu_torch.cli.bathsearch",
                  ["--backend", "torch", "--device", "cpu"], env_extra, hmm)


def test_torch_backend_byte_identical_to_numpy(fx, tmp_path):
    want, tbl_n = numpy_out(fx, tmp_path)
    got, tbl_t = torch_out(fx, tmp_path)
    assert got == want
    assert fixtures.embeds_found(tbl_t, fx) == len(fx.embeds) == 8
    assert fixtures.embeds_found(tbl_n, fx) == 8


def test_two_query_file_runs_the_serial_loop(fx, tmp_path):
    """BATH_MULTIQUERY=0 keeps a multi-HMM file on the serial per-query
    loop (one TorchCascade per query); without it the file takes the
    multi-query drive (tests/test_torch_multiquery.py)."""
    other = fixtures.write_fixture(90, 200_000, 4, 12, directory=tmp_path)
    two = tmp_path / "two.bhmm"
    two.write_text(open(fx.hmm_path).read() + open(other.hmm_path).read())
    want, _ = numpy_out(fx, tmp_path, hmm=str(two))
    got, _ = torch_out(fx, tmp_path, {"BATH_MULTIQUERY": "0"}, hmm=str(two))
    assert got == want and got.count("Query:") == 2
    packed, _ = torch_out(fx, tmp_path, hmm=str(two))
    assert packed == want


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_gate_band_perturbation_byte_invariant(fx, tmp_path, sign):
    """0.9 of the band's worth of gate-score error leaves the bytes."""
    flambda = float(read_hmm(fx.hmm_path).evparam[C.EV_FLAMBDA])
    eps = sign * 0.9 * math.log(DEVICE_GATE_BAND) / flambda * math.log(2)
    assert abs(eps) > 1.0
    want, _ = numpy_out(fx, tmp_path)
    got, _ = torch_out(fx, tmp_path, {"BATH_DEVICE_PERTURB": f"{eps:.6f}"})
    assert got == want


def test_gate_band_overdrive_changes_output(fx, tmp_path):
    """-60 nats on every gate score rejects the true hits: the gate
    scores do reach the output."""
    want, _ = numpy_out(fx, tmp_path)
    got, _ = torch_out(fx, tmp_path, {"BATH_DEVICE_PERTURB": "-60.0"})
    assert got != want


@pytest.mark.parametrize("mode", ["--fs", "--fsonly"])
def test_fs_modes_byte_identical_to_numpy(fs_fx, tmp_path, mode):
    """-o and --fstblout (its '#' lines masked) equal the host path's,
    every embed is reported and every frameshifted one is covered by a
    listed frameshift."""
    want, want_fs, _, _ = fs_search(fs_fx, tmp_path, "numpy", mode)
    got, got_fs, fst, tbl = fs_search(fs_fx, tmp_path, "torch", mode)
    assert got == want
    assert got_fs == want_fs and got_fs
    assert fixtures.frameshifts_found(fst, fs_fx) == 4
    assert fixtures.embeds_found(tbl, fs_fx) == 8


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_fs_gate_band_perturbation_byte_invariant(fs_fx, tmp_path, sign):
    """0.9 of the band's worth of error on every gate score, the fs3
    gate's included, leaves the --fs bytes."""
    flambda = float(read_hmm(fs_fx.hmm_path).evparam[C.EV_FLAMBDA])
    eps = sign * 0.9 * math.log(DEVICE_GATE_BAND) / flambda * math.log(2)
    want = fs_search(fs_fx, tmp_path, "numpy", "--fs")[:2]
    got = fs_search(fs_fx, tmp_path, "torch", "--fs",
                    {"BATH_DEVICE_PERTURB": f"{eps:.6f}"})[:2]
    assert got == want


def test_fs_gate_band_overdrive_changes_output(fs_fx, tmp_path):
    """-60 nats on every gate score changes the --fs output."""
    want = fs_search(fs_fx, tmp_path, "numpy", "--fs")[:2]
    got = fs_search(fs_fx, tmp_path, "torch", "--fs",
                    {"BATH_DEVICE_PERTURB": "-60.0"})[:2]
    assert got != want


# the expression a search's subprocess prints: did it load JAX or any
# module of the JAX package?
LOADED = ("any(m.split('.')[0] in ('jax', 'jaxlib', 'bath_tpu') "
          "for m in sys.modules)")


def test_search_imports_no_jax(fx, tmp_path):
    """Neither JAX nor any module of ``bath_tpu``."""
    code = ("import sys\n"
            "from bath_tpu_torch.cli.bathsearch import run\n"
            f"rc = run(['--device', 'cpu', '-o', {str(tmp_path / 'o')!r},"
            f" {fx.hmm_path!r}, {fx.fasta_path!r}])\n"
            f"print(rc, {LOADED})\n")
    env = dict(os.environ, BATH_MSV_DEVICE="0", BATH_VIT_DEVICE="0")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=ROOT, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == ["0", "False"]


def test_fs_search_imports_no_jax(fs_fx, tmp_path):
    code = ("import sys\n"
            "from bath_tpu_torch.cli.bathsearch import run\n"
            f"rc = run(['--device', 'cpu', '--fs', '-o', "
            f"{str(tmp_path / 'o')!r}, {fs_fx.hmm_path!r}, "
            f"{fs_fx.fasta_path!r}])\n"
            f"print(rc, {LOADED})\n")
    env = dict(os.environ, BATH_MSV_DEVICE="0", BATH_VIT_DEVICE="0")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=ROOT, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == ["0", "False"]


def test_fs_needs_a_frameshift_model(fx, monkeypatch):
    """--fs with a query built without the frameshift fields stops, as
    the JAX CLI does."""
    monkeypatch.setenv("BATH_MSV_DEVICE", "0")
    monkeypatch.setenv("BATH_VIT_DEVICE", "0")
    with pytest.raises(SystemExit, match="not formatted for frameshift"):
        bathsearch.run(["--device", "cpu", "--fs", "-o", os.devnull,
                        fx.hmm_path, fx.fasta_path])


def test_torch_backend_refuses_cpu_without_flag(fx, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setenv("BATH_MSV_DEVICE", "0")
    monkeypatch.setenv("BATH_VIT_DEVICE", "0")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        bathsearch.run([fx.hmm_path, fx.fasta_path])


@pytest.mark.parametrize("extra,item", [
    pytest.param(["--backend", "jax"], None, id="backend-jax")])
def test_unported_modes_name_their_roadmap_item(fx, monkeypatch, extra,
                                                item):
    """--backend jax is refused by name too: it is the JAX package's."""
    monkeypatch.setenv("BATH_MSV_DEVICE", "0")
    monkeypatch.setenv("BATH_VIT_DEVICE", "0")
    match = f"item {item}" if item else "--backend jax is the JAX package"
    with pytest.raises(NotImplementedError, match=match):
        bathsearch.run(["--device", "cpu", *extra, fx.hmm_path,
                        fx.fasta_path])


def test_cascade_batches_and_scatter(fx):
    """fwd_scores sorts, batches and scatters back: each item's score
    is its own plain-version score; msv_scores and vit_scores of the
    same items are the host filters' scores."""
    om = fixtures.search_profile(read_hmm(fx.hmm_path))
    rng = np.random.default_rng(9)
    seqs = [rng.integers(0, 20, n).astype(np.int8)
            for n in (5, 300, 1, 47, 120, 47)]
    lens = np.array([len(s) for s in seqs])
    seen = np.concatenate([i for i, _, _ in batches(seqs, lens, "cpu", 4)])
    assert sorted(seen) == list(range(len(seqs)))
    capped = [(i, d) for i, d, _ in batches(seqs, lens, "cpu",
                                            max_cells=150)]
    assert sorted(np.concatenate([i for i, _ in capped])) == \
        list(range(len(seqs)))
    assert all(d.numel() <= 150 or len(i) == 1 for i, d in capped)
    stats = {}
    cas = TorchCascade(om, device="cpu", stats=stats)
    got = cas.fwd_scores(seqs, lens)
    p = tf.fwd_params(om)
    for s, g in zip(seqs, got):
        want = tf.fwd_score_ref(torch.from_numpy(s)[None],
                                torch.tensor([len(s)], dtype=torch.int32), p)
        assert abs(float(want[0]) - float(g)) < 1e-5
    assert stats["fwd_items"] == len(seqs)
    msv, vit = cas.msv_scores(seqs, lens), cas.vit_scores(seqs, lens)
    for s, m, v in zip(seqs, msv, vit):
        om.reconfig_length(len(s))
        assert m == np.float32(msv_filter(s.astype(np.int32), om))
        assert v == np.float32(viterbi_filter(s.astype(np.int32), om))
    assert stats["msv_items"] == stats["vit_items"] == len(seqs)


def test_fs3_cascade_batches_and_scatter(fs_fx):
    """fs3_scores and fs3_domdec sort, batch (pad 17) and scatter back:
    each window's result is its own plain-version result."""
    from bath_tpu.sequence import Sequence
    from bath_tpu_torch.ops import fs3 as t3
    from bath_tpu_torch.ops import fs3_domdec as td3
    hmm = read_hmm(fs_fx.hmm_path)
    om3 = fixtures.fs_search_profile(hmm)
    rng = np.random.default_rng(10)
    seqs = [rng.integers(0, 4, n).astype(np.int8)
            for n in (5, 700, 2, 131, 360, 131)]
    lens = np.array([len(s) for s in seqs])
    stats = {}
    cas = TorchCascade(fixtures.search_profile(hmm), om3, device="cpu",
                       stats=stats)
    got = cas.fs3_scores(seqs, lens)
    bt, et, mo, ok = cas.fs3_domdec([Sequence(name="w", dsq=s)
                                     for s in seqs], 100.0 / 103.0)
    p = t3.fs3_params(om3)
    for s, g, b, k in zip(seqs, got, bt, ok):
        one = (torch.from_numpy(s)[None],
               torch.tensor([len(s)], dtype=torch.int32))
        assert float(t3.fs3_score_ref(*one, p)[0]) == float(g)
        want = td3.fs3_domdec_ref(*one, p, 100.0 / 103.0)
        assert bool(want[3][0]) == bool(k)
        assert np.abs(want[0][0].numpy() - b[:len(s) + 1]).max() < 1e-6
    assert stats["fs3_items"] == stats["fs3domdec_items"] == len(seqs)
    assert stats["fs3domdec_ok"] == int(ok.sum()) == len(seqs)
