"""``bathsearch --hosts N`` of bath_tpu_torch on the CPU, beyond the
two-rank cases of ``test_torch_hosts.py``: rank processes as
``tests/torch_ranks.py`` starts them.

- Three ranks print the single-process run's bytes (rank 0's ``-o``,
  ``--tblout``, ``--fstblout``, run lines masked) in four cases of the
  two-rank test: numpy, torch on the CPU standard and ``--fs``, the
  numpy window pool ``--cpu 2``; ranks 1 and 2 write no file.
- ``--splice`` and a multi-HMM query file (which takes the serial
  per-query loop under ``--hosts``, as in the reference) over two
  ranks print the bytes of ``bath_tpu --backend numpy`` in one process.
- A process group that cannot form raises, and a rank whose peer
  never comes fails once the group's timeout has passed.
"""

import os
import socket
import subprocess
import sys
import time

import pytest

import jax_native
from bath_tpu_torch import fixtures
from torch_ranks import (BLOCK, CASES, HOST_FILTERS, RANK_LIMIT_S, ROOT,
                         free_port, outputs, out_args, rank_env, run_ranks,
                         run_single)
from torch_threads import one_torch_thread  # noqa: F401

MAX_INTRON = ["--max_intron", "5000"]


@pytest.fixture(scope="module")
def fxs(tmp_path_factory):
    jax_native.load()
    d = tmp_path_factory.mktemp("hosts_modes")
    return {"standard": fixtures.write_fixture(100, 60_000, 3, 5,
                                               directory=d),
            "fs": fixtures.write_fixture(100, 60_000, 3, 5, directory=d,
                                         fs=True, n_frameshift=1),
            "splice": fixtures.write_splice_fixture(120, 40_000, 3, 4,
                                                    directory=d),
            "multi": fixtures.write_multi_fixture([60, 40, 70], 60_000,
                                                  [0, 2], 1, 4,
                                                  directory=d)}


@pytest.mark.parametrize("case", [c for c in CASES if c != "torch-cpu2"])
def test_three_ranks_print_the_single_process_bytes(fxs, tmp_path, case):
    name, argv = CASES[case]
    fx = fxs[name]
    got = run_ranks(3, [*argv, *BLOCK, fx.hmm_path, fx.fasta_path],
                    tmp_path / "r")
    serial = [a for a in argv if a not in ("--cpu", "2")]
    assert got == run_single([*serial, *BLOCK, fx.hmm_path, fx.fasta_path],
                             tmp_path / "single")


def reference(argv, stem):
    """``bath_tpu --backend numpy`` in one process, started now: a
    function that waits for it and returns its outputs."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "bath_tpu.cli.bathsearch", "--backend",
         "numpy", *argv, *out_args(stem)], cwd=ROOT,
        env=dict(os.environ, JAX_PLATFORMS="cpu", **HOST_FILTERS),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)

    def wait():
        try:
            _, err = proc.communicate(timeout=RANK_LIMIT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        assert proc.returncode == 0, err[-3000:]
        return outputs(stem)
    return wait


@pytest.mark.parametrize("mode", ["splice", "multi"])
def test_two_ranks_print_the_reference_bytes(fxs, tmp_path, mode):
    fx = fxs[mode]
    opts = ["--splice", *MAX_INTRON] if mode == "splice" else []
    argv = [*BLOCK, *opts, fx.hmm_path, fx.fasta_path]
    want = reference(argv, tmp_path / "ref")
    got = run_ranks(2, ["--device", "cpu", *argv], tmp_path / "r")
    assert got == want()
    body = [ln for ln in got[1].splitlines() if not ln.startswith("#")]
    assert body
    if mode == "multi":
        # hits of the two embedded models, each in its query's block
        assert len({ln.split()[3] for ln in body}) >= 2


def test_a_group_that_cannot_form_raises(fxs, tmp_path):
    """Rank 0 cannot listen on the coordinator's port: the search stops
    with the process group's error and writes nothing."""
    fx = fxs["standard"]
    with socket.socket() as held:
        held.bind(("localhost", 0))
        held.listen()
        port = held.getsockname()[1]
        r = subprocess.run(
            [sys.executable, "-m", "bath_tpu_torch.cli.bathsearch",
             "--backend", "numpy", "--hosts", "2", "--host-id", "0",
             "--coordinator", f"localhost:{port}",
             *out_args(tmp_path / "r"), fx.hmm_path, fx.fasta_path],
            cwd=ROOT, env=rank_env(), capture_output=True, text=True,
            timeout=RANK_LIMIT_S)
    assert r.returncode != 0
    assert "DistNetworkError" in r.stderr or "address" in r.stderr
    assert not os.path.exists(tmp_path / "r.out")


@pytest.mark.parametrize("rank", [0, 1])
def test_a_rank_whose_peer_never_comes_fails_on_the_timeout(fxs, tmp_path,
                                                            rank):
    """Rank 0 alone (its store waits for rank 1) and rank 1 alone (no
    store to reach) stop with the process group's error once
    BATH_HOSTS_TIMEOUT_S has passed, and write nothing."""
    fx = fxs["standard"]
    t0 = time.monotonic()
    r = subprocess.run(
        [sys.executable, "-m", "bath_tpu_torch.cli.bathsearch",
         "--backend", "numpy", "--hosts", "2", "--host-id", str(rank),
         "--coordinator", f"localhost:{free_port()}",
         *out_args(tmp_path / "r"), fx.hmm_path, fx.fasta_path],
        cwd=ROOT, env=rank_env(BATH_HOSTS_TIMEOUT_S="3"),
        capture_output=True, text=True, timeout=RANK_LIMIT_S)
    assert r.returncode != 0
    assert "timed out" in r.stderr.lower(), r.stderr[-2000:]
    assert time.monotonic() - t0 < 60
    assert not os.path.exists(tmp_path / "r.out")
