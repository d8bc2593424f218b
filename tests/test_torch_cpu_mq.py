"""``bathsearch --cpu N`` of bath_tpu_torch on a multi-HMM query file,
on the CPU: the query-sharded pool of ``multiquery.run_multiquery``, on
``--backend numpy`` and on ``--backend torch --device cpu``, standard
and ``--fs``, on a 4-model query file (M = 120, 45, 90, 64; three of the
models have a copy in the genome) against a 100 kb genome cut into
many windows (``--block_length 8000``).

Each search is held byte for byte, query by query (``-o`` with its
CPU-time lines masked, ``--tblout`` and ``--fstblout`` without their
'#' lines), to the port's serial per-query loop (``--backend numpy``
without ``--cpu``) and to ``bath_tpu.cli.bathsearch --backend numpy
--cpu 2`` (a fresh subprocess).  With ``BATH_CHUNK_ORFS=500`` the drive
flushes many times, and each slice of queries stays with its worker
from flush to flush.  The port's searches run in this process with
``os.cpu_count`` pinned to 2, so that each worker takes one native
thread.
"""

import os
import re
import subprocess
import sys

import pytest

import jax_native
from bath_tpu_torch import fixtures, multiquery
from bath_tpu_torch.cli import bathsearch
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MS = [120, 45, 90, 64]
EMBEDDED = [0, 2, 3]
BLOCK = ["--block_length", "8000"]
HOST_FILTERS = {"BATH_MSV_DEVICE": "0", "BATH_VIT_DEVICE": "0"}
BACKENDS = {"numpy": ["--backend", "numpy"], "torch": ["--device", "cpu"]}


@pytest.fixture(scope="module")
def fxs(tmp_path_factory):
    jax_native.load()
    d = tmp_path_factory.mktemp("cpu_mq")
    return {fs: fixtures.write_multi_fixture(MS, 100_000, EMBEDDED, 1, 5,
                                             directory=d, fs=fs)
            for fs in (False, True)}


def rows(path) -> str:
    return "".join(ln for ln in open(path) if not ln.startswith("#"))


def read(stem):
    out = re.sub(r"# (CPU time|Mc/sec):.*", "", open(f"{stem}.out").read())
    return out.split("//\n"), rows(f"{stem}.tbl"), rows(f"{stem}.fst")


def outputs(stem):
    return ["-o", f"{stem}.out", "--tblout", f"{stem}.tbl", "--fstblout",
            f"{stem}.fst"]


def reference(fx, mode, d):
    """bath_tpu --backend numpy --cpu 2 in a fresh interpreter."""
    stem = d / "ref"
    r = subprocess.run(
        [sys.executable, "-m", "bath_tpu.cli.bathsearch", "--backend",
         "numpy", "--cpu", "2", *BLOCK, *mode, *outputs(stem), fx.hmm_path,
         fx.fasta_path], capture_output=True, text=True, timeout=600,
        cwd=ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu", **HOST_FILTERS))
    assert r.returncode == 0, r.stderr[-2000:]
    return read(stem)


def port(fx, args, d, tag, stats=None):
    stem = d / tag
    assert bathsearch.run([*args, *BLOCK, *outputs(stem), fx.hmm_path,
                           fx.fasta_path], stats=stats) == 0
    return read(stem)


@pytest.fixture
def host(monkeypatch):
    """Two cores and the host integer filters, for this process and
    the workers it starts."""
    monkeypatch.setattr(os, "cpu_count", lambda: 2)
    for k, v in HOST_FILTERS.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("BATH_WINDOW_CONTEXT", raising=False)
    monkeypatch.delenv("BATH_MULTIQUERY", raising=False)
    return monkeypatch


@pytest.mark.parametrize("chunk", [None, "500"], ids=["one-flush", "flushes"])
@pytest.mark.parametrize("mode", [[], ["--fs"]], ids=["standard", "fs"])
def test_query_pool_is_byte_identical_per_query(fxs, host, tmp_path, mode,
                                                chunk):
    fx = fxs[bool(mode)]
    if chunk:
        host.setenv("BATH_CHUNK_ORFS", chunk)
    serial = port(fx, ["--backend", "numpy", *mode], tmp_path, "serial")
    want = reference(fx, mode, tmp_path)
    assert len(serial[0]) == len(MS) + 1          # four queries and [ok]
    for backend, args in BACKENDS.items():
        stats = {}
        got = port(fx, [*args, "--cpu", "2", *mode], tmp_path, backend,
                   stats)
        for q, blocks in enumerate(zip(got[0], serial[0], want[0])):
            assert blocks[0] == blocks[1], f"{backend} query {q} vs serial"
            assert blocks[0] == blocks[2], f"{backend} query {q} vs bath_tpu"
        assert got[1:] == serial[1:] == want[1:]
        assert bool(got[2]) == bool(mode)
        # the multi-query drive ran, with one single-worker pool a slice
        # and no stage of this process on the device path
        assert stats["pools"] == len(multiquery._balance_slices(MS, 2)) == 2
        assert (stats["worker_cuda"], stats["worker_launches"]) == (0, 0)
        assert stats["mq_stages"] == [] and stats["fwd_items"] == 0
    found = fixtures.multi_embeds_found(f"{tmp_path}/torch.tbl", fx)
    assert found == {g: 1 for g in EMBEDDED}


def test_workers_keep_every_stage_off_the_device(monkeypatch):
    """The worker's initializer puts every stage's threshold out of
    reach, whatever the caller set."""
    for k in multiquery._DEV_MIN_ENV.values():
        monkeypatch.setenv(k, "0")
    multiquery._mq_pool_init(1)
    assert [multiquery._dev_min(k) for k in multiquery._DEV_MIN_ENV] == \
        [float("inf")] * 4


@pytest.mark.parametrize("weights,n,want", [
    (MS, 2, [(0, 2), (2, 4)]),
    (MS, 8, [(0, 1), (1, 2), (2, 3), (3, 4)]),
    ([60 + (1140 * i) // 47 for i in range(48)], 8, None)])
def test_slices_are_contiguous_and_balanced(weights, n, want):
    slices = multiquery._balance_slices(weights, n)
    if want:
        assert slices == want
    assert slices[0][0] == 0 and slices[-1][1] == len(weights)
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    sums = [sum(weights[lo:hi]) for lo, hi in slices]
    assert len(slices) == min(n, len(weights))
    assert max(sums) - min(sums) <= max(weights)


def test_numpy_without_cpu_keeps_the_serial_loop(fxs, host, tmp_path):
    """--backend numpy on a multi-HMM file without --cpu: the serial
    per-query loop, no pool, as the reference routes it."""
    stats = {}
    port(fxs[False], ["--backend", "numpy"], tmp_path, "plain", stats)
    # no pool: only the serial loop's count of its host fills
    assert list(stats) == ["rescore_host_items"]
