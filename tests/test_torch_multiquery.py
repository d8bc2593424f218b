"""The multi-query drive of bath_tpu_torch end to end, on the CPU
through the kernels' plain versions: a 4-model query file (M = 120, 45,
90, 64; three of the models have two copies each in the genome, one of
them across a window boundary) against a 300 kb genome, standard and
``--fs``.

``bathsearch --backend torch --device cpu`` with a multi-HMM file runs
``multiquery.run_multiquery``; its ``-o`` (CPU-time lines masked),
``--tblout`` and ``--fstblout`` ('#' lines masked) are held byte for
byte, query by query, to ``bath_tpu.cli.bathsearch --backend numpy``
(the JAX package's host drive), to the port's own ``--backend numpy``
and to the port's serial per-query loop (``BATH_MULTIQUERY=0``).  The
window overlap is NOT pinned (no ``BATH_WINDOW_CONTEXT``): the queries
differ in max_length, so the shared stream's overlap is the largest
one and each query is handed its serial ORF set; the statistics lines
are compared too, unmasked.  ``PackedGates`` is held item for item to
one ``TorchCascade`` per model.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

from bath_tpu_torch import fixtures
from bath_tpu_torch.cli import bathsearch
from bath_tpu_torch.device_pipeline import TorchCascade
from bath_tpu_torch.hmmfile import read_hmms
from bath_tpu_torch.multiquery import PackedGates, QState
from bath_tpu_torch.sequence import Sequence
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MS = [120, 45, 90, 64]
EMBEDDED = [0, 2, 3]
HOST_FILTERS = {"BATH_MSV_DEVICE": "0", "BATH_VIT_DEVICE": "0"}


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    return fixtures.write_multi_fixture(
        MS, 300_000, EMBEDDED, 2, 5,
        directory=tmp_path_factory.mktemp("mq"))


@pytest.fixture(scope="module")
def fs_fx(tmp_path_factory):
    return fixtures.write_multi_fixture(
        MS, 300_000, EMBEDDED, 2, 5, fs=True,
        directory=tmp_path_factory.mktemp("mqfs"))


def rows(path):
    return "".join(ln for ln in open(path).read().splitlines(True)
                   if not ln.startswith("#"))


def per_query(out):
    """The output's per-query blocks, CPU-time lines masked."""
    out = re.sub(r"# (CPU time|Mc/sec):.*", "", out)
    return out.split("//\n")


def search(fixture, tmp_path, module, args, env_extra=None):
    """(per-query -o blocks, --tblout rows, --fstblout rows, the
    --tblout path, the --fstblout path) of one search in a
    subprocess."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", **HOST_FILTERS)
    env.pop("BATH_WINDOW_CONTEXT", None)
    env.update(env_extra or {})
    stem = tmp_path / f"run{len(os.listdir(tmp_path))}"
    tbl, fst = f"{stem}.tbl", f"{stem}.fst"
    r = subprocess.run(
        [sys.executable, "-m", module, *args, "--tblout", tbl,
         "--fstblout", fst, fixture.hmm_path, fixture.fasta_path],
        capture_output=True, text=True, timeout=900, cwd=ROOT, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    return per_query(r.stdout), rows(tbl), rows(fst), tbl, fst


TORCH = ["--backend", "torch", "--device", "cpu"]


@pytest.mark.parametrize("mode", [[], ["--fs"]], ids=["standard", "fs"])
def test_multiquery_byte_identical_per_query(fx, fs_fx, tmp_path, mode):
    fixture = fs_fx if mode else fx
    want = search(fixture, tmp_path, "bath_tpu.cli.bathsearch",
                  ["--backend", "numpy", *mode])
    got = search(fixture, tmp_path, "bath_tpu_torch.cli.bathsearch",
                 [*TORCH, *mode])
    own = search(fixture, tmp_path, "bath_tpu_torch.cli.bathsearch",
                 ["--backend", "numpy", *mode])
    serial = search(fixture, tmp_path, "bath_tpu_torch.cli.bathsearch",
                    [*TORCH, *mode], {"BATH_MULTIQUERY": "0"})
    assert len(got[0]) == len(MS) + 1          # four queries and [ok]
    for q, blocks in enumerate(zip(got[0], want[0], own[0], serial[0])):
        assert blocks[0] == blocks[1], f"query {q} vs bath_tpu numpy"
        assert blocks[0] == blocks[2], f"query {q} vs the port's numpy"
        assert blocks[0] == blocks[3], f"query {q} vs the serial loop"
    assert got[1] == want[1] == own[1] == serial[1] and got[1]
    assert got[2] == want[2] == own[2] == serial[2]
    assert bool(got[2]) == bool(mode)
    found = fixtures.multi_embeds_found(got[3], fixture)
    assert found == {g: 2 for g in EMBEDDED}
    if mode:            # every frameshifted copy is listed as one
        assert fixtures.multi_frameshifts_found(got[4], fixture) == \
            {g: 1 for g in EMBEDDED}


@pytest.mark.parametrize("mode", [[], ["--fs"]], ids=["standard", "fs"])
def test_multiquery_runs_every_stage_on_the_device_path(fx, fs_fx, tmp_path,
                                                        monkeypatch, mode):
    """In process: the drive goes through PackedGates (its stats fill),
    every stage with items takes the device path at the default
    thresholds, and a threshold above a stage's cells sends that stage
    to the host with the same bytes."""
    for k, v in HOST_FILTERS.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("BATH_WINDOW_CONTEXT", raising=False)
    fixture = fs_fx if mode else fx
    stats = {}
    out = tmp_path / "mq.out"
    assert bathsearch.run([*TORCH, *mode, "-o", str(out), fixture.hmm_path,
                           fixture.fasta_path], stats=stats) == 0
    assert stats["fwd_items"] > 0 and stats["fwd_cells"] > 0
    staged = [s[0] for s in stats["mq_stages"]]
    if mode:
        assert stats["fs3_items"] > 0
        assert stats["fs3domdec_ok"] == stats["fs3domdec_items"] > 0
        assert {"fwd", "fs3", "fs3domdec"} <= set(staged)
    else:
        assert stats["domdec_ok"] == stats["domdec_items"] > 0
        assert {"fwd", "domdec"} <= set(staged)
    assert set(stats["mq_phase_s"]) >= {"gates", "fwd", "fwd_stage"}
    assert "msv_items" not in stats            # no TorchCascade ran
    # the same drive with the Forward gate kept on the host
    monkeypatch.setenv("BATH_MQ_FWD_MIN_CELLS", "1e18")
    host_stats = {}
    out2 = tmp_path / "mq_hostfwd.out"
    assert bathsearch.run([*TORCH, *mode, "-o", str(out2), fixture.hmm_path,
                           fixture.fasta_path], stats=host_stats) == 0
    assert host_stats["fwd_items"] == 0
    assert per_query(out.read_text()) == per_query(out2.read_text())


def test_multiquery_gate_scores_reach_the_output(fx, tmp_path):
    """-60 nats on every packed gate score rejects the true hits."""
    want = search(fx, tmp_path, "bath_tpu_torch.cli.bathsearch", TORCH)
    got = search(fx, tmp_path, "bath_tpu_torch.cli.bathsearch", TORCH,
                 {"BATH_DEVICE_PERTURB": "-60.0"})
    assert got[0] != want[0]


def test_packed_gates_equal_per_model_cascades(fs_fx):
    """PackedGates results equal, item for item, those of four
    TorchCascades (one per model) on the same items."""
    hmms = list(read_hmms(fs_fx.hmm_path))
    args = bathsearch.build_parser().parse_args(
        ["--fs", fs_fx.hmm_path, fs_fx.fasta_path])
    from bath_tpu_torch.gencode import GeneticCode
    gcode = GeneticCode.create(1)
    gcode.set_initiator_any()
    for h in hmms:
        bathsearch.check_query(h, args)
    queries = [QState(h, args, gcode, qi) for qi, h in enumerate(hmms)]
    stats = {}
    pg = PackedGates(queries, device="cpu", stats=stats)
    rng = np.random.default_rng(8)
    aa = [(queries[g], rng.integers(0, 20, n).astype(np.int8), n)
          for g, n in ((0, 40), (3, 7), (1, 120), (2, 64), (0, 1), (3, 90))]
    nt = [(queries[g], rng.integers(0, 4, n).astype(np.int8), n)
          for g, n in ((2, 300), (0, 45), (1, 2), (3, 181), (2, 96))]
    fwd, dd = pg.fwd_scores(aa), pg.domdec(aa)
    fs3, fdd = pg.fs3_scores(nt), pg.fs3_domdec(nt, 100.0 / 103.0)
    assert stats["fwd_items"] == stats["domdec_items"] == len(aa)
    assert stats["fs3_items"] == stats["fs3domdec_items"] == len(nt)
    assert stats["fs3_cells"] == sum(n * q.hmm.M for q, _, n in nt) // 3
    cas = [TorchCascade(q.om, q.om_fs3, device="cpu") for q in queries]
    for (q, d, n), sc, post in zip(aa, fwd, dd):
        c = cas[q.qi]
        assert sc == float(c.fwd_scores([d], [n])[0])
        bt, et, mo, ok = c.domdec([Sequence(name="o", dsq=d)])
        assert post[3] == bool(ok[0])
        for a, b in zip(post[:3], (bt[0], et[0], mo[0])):
            assert np.array_equal(a[:n + 1], b[:n + 1])
    for (q, d, n), sc, post in zip(nt, fs3, fdd):
        c = cas[q.qi]
        one = float(c.fs3_scores([d], [n])[0])
        assert sc == one or (np.isinf(sc) and np.isinf(one))
        bt, et, mo, ok = c.fs3_domdec([Sequence(name="w", dsq=d)],
                                      100.0 / 103.0)
        assert post[3] == bool(ok[0])
        for a, b in zip(post[:3], (bt[0], et[0], mo[0])):
            assert np.array_equal(a[:n + 1], b[:n + 1])


def test_single_query_file_keeps_the_per_query_cascade(fx, tmp_path,
                                                       monkeypatch):
    """One HMM in the file: the drive is TorchCascade's, as before."""
    for k, v in HOST_FILTERS.items():
        monkeypatch.setenv(k, v)
    one = tmp_path / "one.bhmm"
    text = open(fx.hmm_path).read()
    one.write_text(text[:text.index("//\n") + 3])
    stats = {}
    assert bathsearch.run([*TORCH, "-o", os.devnull, str(one),
                           fx.fasta_path], stats=stats) == 0
    assert "mq_stages" not in stats and stats["fwd_items"] > 0
