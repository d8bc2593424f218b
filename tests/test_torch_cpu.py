"""``bathsearch --cpu N`` of bath_tpu_torch for a single query, on the
CPU: the window pool of ``--backend numpy`` and the hybrid of
``--backend torch --device cpu`` (workers beside the device cascade of
this process, which runs the kernels' plain versions), standard,
``--fs`` and ``--splice``, on seeded fixtures cut into many windows
(``--block_length 8000``).

Every ``--cpu 2`` search is held byte for byte (``-o`` with its CPU-time
lines masked, ``--tblout``, ``--fstblout`` and ``--exontblout`` without
their run lines) to the same search with ``--cpu 0`` and to
``bath_tpu.cli.bathsearch --backend numpy``, each run of which is a
fresh subprocess; one is held to ``bath_tpu --backend numpy --cpu 2``.
The port's searches run in this process with ``os.cpu_count`` pinned
to 2, so that each worker takes one native thread.  The hybrid runs
with ``BATH_HYBRID_MAIN=1 BATH_HYBRID_MAXQ=1``, so that this process
takes windows too; on the all-device cascade its share goes through
the plain MSV, SSV capture, ViterbiFilter and Viterbi capture.

The order that hangs a forked pool (a pool started after this process
ran OpenMP teams, and the hybrid's second query in the serial loop) runs
in a subprocess under a time limit of its own.
"""

import os
import re
import subprocess
import sys
from concurrent.futures.process import BrokenProcessPool

import pytest
import torch

import jax_native
from bath_tpu_torch import fixtures
from bath_tpu_torch.cli import bathsearch
from bath_tpu_torch.parallel import pool as wpool
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = ["--block_length", "8000"]
MAX_INTRON = ["--max_intron", "5000"]
LOOSE = ["--F1", "0.1", "--F2", "0.05"]
HOST_FILTERS = {"BATH_MSV_DEVICE": "0", "BATH_VIT_DEVICE": "0"}
ALL_DEVICE = {"BATH_MSV_DEVICE": "1", "BATH_VIT_DEVICE": "1"}
HYBRID = {"BATH_HYBRID_MAIN": "1", "BATH_HYBRID_MAXQ": "1"}
RUN_LINES = ("# Option settings:", "# Current dir:", "# Date:")
# (port backend arguments, environment, thresholds) of each backend
BACKENDS = {
    "numpy": (["--backend", "numpy"], HOST_FILTERS, []),
    "hybrid": (["--device", "cpu"], HOST_FILTERS, []),
    "hybrid-all-device": (["--device", "cpu"], ALL_DEVICE, LOOSE),
}


@pytest.fixture(scope="module")
def fxs(tmp_path_factory):
    jax_native.load()
    d = tmp_path_factory.mktemp("cpu")
    return {
        "standard": (fixtures.write_fixture(100, 60_000, 3, 5, directory=d),
                     []),
        "fs": (fixtures.write_fixture(100, 60_000, 3, 5, directory=d,
                                      fs=True, n_frameshift=1), ["--fs"]),
        "splice": (fixtures.write_splice_fixture(120, 40_000, 3, 4,
                                                 directory=d),
                   ["--splice", *MAX_INTRON]),
    }


def masked(path) -> str:
    return re.sub(r"# (CPU time|Mc/sec):.*", "", open(path).read())


def table(path) -> str:
    return "".join(ln for ln in open(path) if not ln.startswith(RUN_LINES))


def rows(text) -> list:
    return [ln for ln in text.splitlines() if not ln.startswith("#")]


class Searches:
    """Each search once a module: (masked -o, --tblout, --fstblout,
    --exontblout without their run lines; the stats)."""

    def __init__(self, fxs, d):
        self.fxs, self.d, self.done = fxs, d, {}

    def _paths(self, mode):
        stem = self.d / f"s{len(self.done)}"
        paths = [f"{stem}.{x}" for x in ("out", "tbl", "fst", "ex")]
        opts = ["-o", paths[0], "--tblout", paths[1], "--fstblout",
                paths[2]]
        if mode == "splice":
            opts += ["--exontblout", paths[3]]
        else:
            open(paths[3], "w").close()
        return paths, opts

    @staticmethod
    def _read(paths):
        return (masked(paths[0]), *(table(p) for p in paths[1:]))

    def reference(self, mode, *opts):
        key = ("ref", mode) + opts
        if key not in self.done:
            fx, flags = self.fxs[mode]
            paths, out = self._paths(mode)
            r = subprocess.run(
                [sys.executable, "-m", "bath_tpu.cli.bathsearch",
                 "--backend", "numpy", *BLOCK, *flags, *opts, *out,
                 fx.hmm_path, fx.fasta_path], capture_output=True,
                text=True, timeout=600, cwd=ROOT,
                env=dict(os.environ, JAX_PLATFORMS="cpu", **HOST_FILTERS))
            assert r.returncode == 0, r.stderr[-2000:]
            self.done[key] = (self._read(paths), None)
        return self.done[key]

    def port(self, mode, backend, cpu, *opts, env_extra=None):
        key = (mode, backend, cpu) + opts + tuple(sorted(
            (env_extra or {}).items()))
        if key not in self.done:
            fx, flags = self.fxs[mode]
            args, env, loose = BACKENDS[backend]
            env = dict(env, **(env_extra or {}))
            paths, out = self._paths(mode)
            saved = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            stats = {}
            try:
                rc = bathsearch.run(
                    [*args, *BLOCK, *flags, *loose, *opts, "--cpu",
                     str(cpu), *out, fx.hmm_path, fx.fasta_path],
                    stats=stats)
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k)
                    else:
                        os.environ[k] = v
            assert rc == 0
            self.done[key] = (self._read(paths), stats)
        return self.done[key]


@pytest.fixture(scope="module")
def searches(fxs, tmp_path_factory):
    return Searches(fxs, tmp_path_factory.mktemp("searches"))


@pytest.fixture
def two_cores(monkeypatch):
    """One native thread for each of two workers."""
    monkeypatch.setattr(os, "cpu_count", lambda: 2)


@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("mode", ["standard", "fs", "splice"])
def test_cpu_2_is_byte_identical_to_serial_and_the_reference(
        searches, two_cores, mode, backend):
    hybrid = HYBRID if backend != "numpy" else None
    got, stats = searches.port(mode, backend, 2, env_extra=hybrid)
    serial, _ = searches.port(mode, backend, 0)
    want, _ = searches.reference(mode, *BACKENDS[backend][2])
    assert got == serial
    assert got == want
    assert rows(got[1]) and bool(rows(got[2])) == (mode == "fs")
    assert bool(rows(got[3])) == (mode == "splice")
    assert stats["pools"] == 1 and stats["pool_start_s"] > 0
    assert (stats["worker_cuda"], stats["worker_launches"]) == (0, 0)
    if backend == "numpy":
        assert "hybrid_pool" not in stats
        return
    # the hybrid: windows went to the workers and to this process, whose
    # share went through the cascade
    assert stats["hybrid_pool"] > 0 and stats["hybrid_main"] > 0
    assert stats["msv_items"] > 0 if backend == "hybrid-all-device" \
        else "msv_items" not in stats or stats["msv_items"] == 0
    if mode == "fs":
        assert stats["fs3_items"] > 0


def test_window_pool_matches_the_reference_pool(searches, two_cores):
    """The JAX package's forked pool, run in a fresh interpreter, and
    the port's pool print the same bytes."""
    got, _ = searches.port("standard", "numpy", 2)
    want, _ = searches.reference("standard", "--cpu", "2")
    assert got == want


def test_hmmer_ncpu_sets_the_workers(searches, fxs, two_cores, monkeypatch,
                                     tmp_path):
    """HMMER_NCPU=2 and no --cpu: the search runs on two workers, as the
    reference's default, with the bytes of --cpu 0."""
    monkeypatch.setenv("HMMER_NCPU", "2")
    for k, v in HOST_FILTERS.items():
        monkeypatch.setenv(k, v)
    fx, _ = fxs["standard"]
    stats = {}
    out, tbl = tmp_path / "n.out", tmp_path / "n.tbl"
    assert bathsearch.run(["--backend", "numpy", *BLOCK, "-o", str(out),
                           "--tblout", str(tbl), fx.hmm_path,
                           fx.fasta_path], stats=stats) == 0
    assert stats["pools"] == 1
    serial, _ = searches.port("standard", "numpy", 0)
    assert (masked(out), table(tbl)) == serial[:2]


HANG_ORDER = '''
import os, re, sys
os.cpu_count = lambda: 2
from bath_tpu_torch.cli import bathsearch
hmm, fa, two, splice_fa, d = sys.argv[1:6]

def search(tag, *args, q=hmm, t=fa, env=()):
    saved = dict(os.environ)
    os.environ.update(dict(env))
    stats = {}
    assert bathsearch.run([*args, "--block_length", "8000", "-o",
                           f"{d}/{tag}.out", q, t], stats=stats) == 0
    os.environ.clear()
    os.environ.update(saved)
    text = open(f"{d}/{tag}.out").read()
    return re.sub(r"# (CPU time|Mc/sec):.*", "", text), stats

hybrid = {"BATH_HYBRID_MAIN": "1", "BATH_HYBRID_MAXQ": "1"}
serial, _ = search("serial", "--backend", "numpy")
torch0, _ = search("torch0", "--device", "cpu")
pool, st = search("pool", "--backend", "numpy", "--cpu", "2")
hyb, hst = search("hybrid", "--device", "cpu", "--cpu", "2", env=hybrid)
two0, _ = search("two0", "--backend", "numpy", "--splice", "--max_intron",
                 "5000", q=two, t=splice_fa)
two2, tst = search("two2", "--device", "cpu", "--cpu", "2", "--splice",
                   "--max_intron", "5000", q=two, t=splice_fa, env=hybrid)
print("POOL", pool == serial == torch0, st["pools"])
print("HYBRID", hyb == serial, hst["hybrid_main"] > 0, hst["pools"])
print("TWO", two2 == two0, two2.count("Query:"), tst["pools"],
      tst["hybrid_main"] > 0)
'''


def test_pools_start_after_omp_teams_and_on_a_second_query(fxs, tmp_path):
    """In one process: two serial searches (ORF extraction runs a team
    of three threads, the batch filters run teams), then the window
    pool, the hybrid, and a two-model --splice file through the hybrid,
    whose second query's pool starts after the first query's teams.
    Every pool's bytes equal the serial ones, and the process ends
    inside its limit, where a forked pool would hang."""
    fx, _ = fxs["standard"]
    sfx, _ = fxs["splice"]
    two = tmp_path / "two.bhmm"
    two.write_text(open(sfx.hmm_path).read() + open(fx.hmm_path).read())
    env = dict(os.environ, **HOST_FILTERS)
    r = subprocess.run(
        [sys.executable, "-c", HANG_ORDER, fx.hmm_path, fx.fasta_path,
         str(two), sfx.fasta_path, str(tmp_path)], capture_output=True,
        text=True, timeout=180, cwd=ROOT, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.splitlines()
    assert "POOL True 1" in lines, r.stdout
    assert "HYBRID True True 1" in lines, r.stdout
    assert "TWO True 2 2 True" in lines, r.stdout


def session_processes(sid: int) -> list:
    """(pid, state, command line) of every process of session <sid>."""
    out = []
    for d in os.listdir("/proc"):
        try:
            stat = open(f"/proc/{d}/stat").read() if d.isdigit() else ""
            cmd = open(f"/proc/{d}/cmdline", "rb").read()
        except OSError:
            continue
        if stat and int(stat.rsplit(")", 1)[1].split()[3]) == sid:
            out.append((int(d), stat.rsplit(")", 1)[1].split()[0],
                        cmd.replace(b"\0", b" ").decode()[:200]))
    return out


def test_the_cli_leaves_no_process_behind(fxs, tmp_path):
    """``python -m bath_tpu_torch.cli.bathsearch --cpu 2`` stops its
    pools' server and resource tracker before it exits: once it has
    exited, no process of its session is left."""
    fx, _ = fxs["standard"]
    env = dict(os.environ, **HOST_FILTERS)
    proc = subprocess.Popen(
        [sys.executable, "-m", "bath_tpu_torch.cli.bathsearch", "--backend",
         "numpy", "--cpu", "2", *BLOCK, "-o", str(tmp_path / "c.out"),
         fx.hmm_path, fx.fasta_path], cwd=ROOT, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        start_new_session=True)
    try:
        _, err = proc.communicate(timeout=180)
        left = session_processes(proc.pid)
    finally:
        for pid, _, _ in session_processes(proc.pid):
            os.kill(pid, 9)
    assert proc.returncode == 0, err[-3000:]
    assert left == []


def test_a_worker_exception_fails_the_call():
    with wpool.worker_pool(1, wpool.__name__, "_UNUSED", None) as pool:
        wpool.ready([pool])
        with pytest.raises(ValueError):
            pool.submit(int, "not a number").result()


def test_a_worker_that_dies_breaks_the_pool():
    with pytest.raises(BrokenProcessPool):
        with wpool.worker_pool(1, wpool.__name__, "_UNUSED", None) as pool:
            wpool.ready([pool])
            pool.submit(os._exit, 3).result()


def test_workers_see_the_callers_environment_and_no_card(monkeypatch):
    """A worker reads the environment of the call that started its pool
    (not the one its server started with), and no CUDA device."""
    monkeypatch.setenv("BATH_POOL_PROBE", "seen")
    stats = {}
    with wpool.worker_pool(2, wpool.__name__, "_UNUSED", None,
                           stats=stats) as pool:
        wpool.ready([pool], stats)
        probe = pool.submit(os.getenv, "BATH_POOL_PROBE").result()
        cuda = pool.submit(os.getenv, "CUDA_VISIBLE_DEVICES").result()
        pids = {f.result()[0] for f in pool.started}
    assert (probe, cuda) == ("seen", "")
    assert stats["pools"] == 1 and os.getpid() not in pids
    assert 0 < stats["pool_spawn_s"] + stats["pool_init_s"] \
        <= stats["pool_start_s"]
    assert (stats["worker_cuda"], stats["worker_launches"]) == (0, 0)


def test_workers_report_their_own_launches():
    """The launches a pool's workers report are counted in the workers:
    a counter raised in a worker shows, this process's does not."""
    from bath_tpu_torch.ops import fwd
    stats = {}
    mine = fwd.fwd_score.launches
    with wpool.worker_pool(1, wpool.__name__, "_UNUSED", None,
                           stats=stats) as pool:
        pool.submit(setattr, fwd.fwd_score, "launches", 2).result()
    assert fwd.fwd_score.launches == mine
    assert (stats["worker_cuda"], stats["worker_launches"]) == (0, 2)


def test_hybrid_without_a_card_raises(fxs):
    """--backend torch --cpu 2 needs the card as every mode does: no
    pool starts, and nothing runs the plain versions instead."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    fx, _ = fxs["standard"]
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        bathsearch.run(["--cpu", "2", fx.hmm_path, fx.fasta_path])


def test_the_hybrid_gives_back_the_callers_native_threads(fxs, two_cores,
                                                         monkeypatch,
                                                         tmp_path):
    """The hybrid caps this process's OpenMP teams for its own share of
    windows, and restores the caller's team size when it ends."""
    from bath_tpu_torch.native import set_native_threads
    for k, v in dict(HOST_FILTERS, **HYBRID).items():
        monkeypatch.setenv(k, v)
    fx, _ = fxs["standard"]
    before = set_native_threads(3)
    try:
        stats = {}
        assert bathsearch.run(["--device", "cpu", "--cpu", "2", *BLOCK,
                               "-o", str(tmp_path / "h.out"), fx.hmm_path,
                               fx.fasta_path], stats=stats) == 0
        assert stats["hybrid_main"] > 0
    finally:
        after = set_native_threads(before)
    assert after == 3
