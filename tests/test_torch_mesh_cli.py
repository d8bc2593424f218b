"""``bathsearch --mesh N`` of bath_tpu_torch on the CPU, where the mesh
repeats the CPU and the shares run the kernels' plain versions in turn.

``--device cpu --mesh 2`` and ``--mesh 3`` print the bytes of ``--mesh
0``, of the port's ``--backend numpy``, of ``bath_tpu --backend numpy``
and of ``bath_tpu --backend jax --mesh 2`` over two virtual CPU devices
(``-o`` with its CPU-time lines masked, ``--tblout``, ``--fstblout``,
``--exontblout`` without their run lines): standard, ``--fs``, the
all-device cascade, ``--splice``, a three-model query file and the
hybrid ``--cpu 2`` (whose bath_tpu runs are the serial ones); every
share of every stage with as many items as shares got some
(``stats["mesh_items"]``).  The stages themselves are held over shares
in ``test_torch_mesh_shares.py``.
"""

import concurrent.futures
import os
import re
import subprocess
import sys

import pytest

import jax_native
from bath_tpu_torch import fixtures
from bath_tpu_torch.cli import bathsearch
from torch_threads import one_torch_thread  # noqa: F401

BLOCK = ["--block_length", "8000"]
LOOSE = ["--F1", "0.1", "--F2", "0.05"]
HOST_FILTERS = {"BATH_MSV_DEVICE": "0", "BATH_VIT_DEVICE": "0"}
ALL_DEVICE = {"BATH_MSV_DEVICE": "1", "BATH_VIT_DEVICE": "1"}
HYBRID = {"BATH_HYBRID_MAIN": "1", "BATH_HYBRID_MAXQ": "1"}
RUN_LINES = ("# Option settings:", "# Current dir:", "# Date:")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_LIMIT_S = 600


@pytest.fixture(scope="module")
def fxs(tmp_path_factory):
    jax_native.load()
    d = tmp_path_factory.mktemp("mesh")
    return {
        "standard": fixtures.write_fixture(100, 60_000, 3, 5, directory=d),
        "fs": fixtures.write_fixture(100, 60_000, 3, 5, directory=d,
                                     fs=True, n_frameshift=1),
        "splice": fixtures.write_splice_fixture(120, 40_000, 3, 4,
                                                directory=d),
        "multi": fixtures.write_multi_fixture([60, 40, 70], 60_000, [0, 2],
                                              1, 4, directory=d),
    }


# (fixture, options, environment) of each mode
MODES = {
    "standard": ("standard", [], HOST_FILTERS),
    "fs": ("fs", ["--fs"], HOST_FILTERS),
    "all-device": ("standard", LOOSE, ALL_DEVICE),
    "splice": ("splice", ["--splice", "--max_intron", "5000"], HOST_FILTERS),
    "multi": ("multi", [], HOST_FILTERS),
    "hybrid": ("standard", ["--cpu", "2"], dict(HOST_FILTERS, **HYBRID)),
}


def masked(path) -> str:
    return re.sub(r"# (CPU time|Mc/sec):.*", "", open(path).read())


def table(path) -> str:
    return "".join(ln for ln in open(path) if not ln.startswith(RUN_LINES))


def out_paths(stem, mode) -> tuple[list, list]:
    """The four output paths of a search and its output arguments;
    the exon table, which only --splice writes, made empty otherwise."""
    paths = [f"{stem}.{x}" for x in ("out", "tbl", "fst", "ex")]
    out = ["-o", paths[0], "--tblout", paths[1], "--fstblout", paths[2]]
    if mode == "splice":
        out += ["--exontblout", paths[3]]
    else:
        open(paths[3], "w").close()
    return paths, out


def outputs(paths) -> tuple:
    return (masked(paths[0]), *(table(p) for p in paths[1:]))


class References:
    """bath_tpu's run of each mode in a process of its own: ``--backend
    numpy``, and ``--backend jax --mesh 2`` on two virtual CPU devices,
    every run started at once (three at a time) when the module starts;
    the hybrid's are the serial runs."""

    def __init__(self, fxs, d):
        self.pool = concurrent.futures.ThreadPoolExecutor(3)
        self.runs = {}
        for mode, (name, opts, env) in MODES.items():
            if mode == "hybrid":
                continue
            for backend in ("numpy", "jax"):
                self.runs[(mode, backend)] = self.pool.submit(
                    self.run, fxs[name], mode, opts, env, backend,
                    d / f"{mode}.{backend}")

    @staticmethod
    def run(fx, mode, opts, env, backend, stem):
        paths, out = out_paths(stem, mode)
        mesh = ["--mesh", "2"] if backend == "jax" else []
        env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
                   XLA_FLAGS="--xla_force_host_platform_device_count=2",
                   **env)
        r = subprocess.run(
            [sys.executable, "-m", "bath_tpu.cli.bathsearch", "--backend",
             backend, *mesh, *BLOCK, *opts, *out, fx.hmm_path,
             fx.fasta_path], cwd=ROOT, env=env, capture_output=True,
            text=True, timeout=REF_LIMIT_S)
        assert r.returncode == 0, r.stderr[-3000:]
        return outputs(paths)

    def __call__(self, mode, backend):
        key = ("standard" if mode == "hybrid" else mode, backend)
        return self.runs[key].result()


@pytest.fixture(scope="module")
def references(fxs, tmp_path_factory):
    refs = References(fxs, tmp_path_factory.mktemp("references"))
    yield refs
    refs.pool.shutdown(cancel_futures=True)


class Searches:
    """Each search once a module: ((masked -o, tables), stats)."""

    def __init__(self, fxs, d):
        self.fxs, self.d, self.done = fxs, d, {}

    def __call__(self, mode, backend, mesh_n, monkeypatch):
        key = (mode, backend, mesh_n)
        if key not in self.done:
            name, opts, env = MODES[mode]
            fx = self.fxs[name]
            for k, v in env.items():
                monkeypatch.setenv(k, v)
            if mode == "hybrid":
                # one native thread for each of two workers
                monkeypatch.setattr(os, "cpu_count", lambda: 2)
            paths, out = out_paths(self.d / f"s{len(self.done)}", mode)
            stats = {}
            assert bathsearch.run(
                ["--backend", backend, "--device", "cpu", "--mesh",
                 str(mesh_n), *BLOCK, *opts, *out, fx.hmm_path,
                 fx.fasta_path], stats=stats) == 0
            self.done[key] = (outputs(paths), stats)
            monkeypatch.undo()
        return self.done[key]


@pytest.fixture(scope="module")
def searches(fxs, tmp_path_factory):
    return Searches(fxs, tmp_path_factory.mktemp("searches"))


@pytest.mark.parametrize("mesh_n", [2, 3])
@pytest.mark.parametrize("mode", list(MODES))
def test_mesh_search_is_byte_identical(searches, references, monkeypatch,
                                       mode, mesh_n):
    got, stats = searches(mode, "torch", mesh_n, monkeypatch)
    one, one_stats = searches(mode, "torch", 0, monkeypatch)
    host, _ = searches(mode, "numpy", 0, monkeypatch)
    assert got == one
    assert got == host
    assert got == references(mode, "numpy")
    assert got == references(mode, "jax")
    assert [ln for ln in got[1].splitlines() if not ln.startswith("#")]
    assert "mesh_items" not in one_stats
    shares = stats["mesh_items"]
    stages = {"standard": {"fwd", "domdec"}, "fs": {"fwd", "fs3"},
              "all-device": {"msv", "vit", "ssvcap", "vitcap", "fwd"},
              "splice": {"fwd", "domdec"}, "multi": {"fwd", "domdec"},
              "hybrid": {"fwd"}}[mode]
    assert stages <= set(shares), shares
    for key, counts in shares.items():
        assert len(counts) == mesh_n
        assert sum(counts) == stats[f"{key}_items"]
        if sum(counts) >= mesh_n:
            assert min(counts) > 0, (key, counts)
    if mode == "hybrid":
        assert stats["hybrid_main"] > 0 and stats["hybrid_pool"] > 0
    if mode == "multi":
        assert stats["mq_stages"]


def test_numpy_backend_ignores_the_mesh(searches, monkeypatch):
    got, stats = searches("standard", "numpy", 2, monkeypatch)
    want, _ = searches("standard", "numpy", 0, monkeypatch)
    # the numpy backend counts its envelopes' host fills, and nothing of a
    # device stage or a mesh
    assert got == want and list(stats) == ["rescore_host_items"]
