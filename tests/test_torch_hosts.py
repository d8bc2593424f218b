"""``bathsearch --hosts 2`` of bath_tpu_torch on the CPU: two local rank
processes of ``python -m bath_tpu_torch.cli.bathsearch`` in a gloo group
(``tests/torch_ranks.py``), each searching the windows with tid % 2 ==
its rank, merged in stream order.

Rank 0's ``-o``, ``--tblout`` and ``--fstblout`` (run lines masked) are
the single-process run's bytes: ``--backend numpy``, ``--backend torch
--device cpu`` standard and ``--fs``, the numpy window pool ``--cpu 2``
and ``--backend torch --cpu 2``, which under ``--hosts`` takes the
chunked cascade and not the hybrid (both held to the serial run); rank
1 writes no file.  ``BATH_NPROCS``, ``BATH_PROC_ID`` and
``BATH_COORDINATOR`` route as the flags do.  The host helpers
(``merge_results``, ``psum_counters``) are held to the JAX package's,
and the gather to its contract over three ranks.  Three ranks and the
other modes are in ``test_torch_hosts_modes.py``.
"""

import pickle
import random
import subprocess
import sys

import pytest

from bath_tpu.parallel import hosts as ref_hosts
from bath_tpu_torch import fixtures
from bath_tpu_torch.cli import bathsearch
from bath_tpu_torch.parallel import hosts
from torch_ranks import (BLOCK, CASES, RANK_LIMIT_S, ROOT, free_port,
                         rank_env, run_ranks, run_single)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def fxs(tmp_path_factory):
    d = tmp_path_factory.mktemp("hosts")
    return {"standard": fixtures.write_fixture(100, 60_000, 3, 5,
                                               directory=d),
            "fs": fixtures.write_fixture(100, 60_000, 3, 5, directory=d,
                                         fs=True, n_frameshift=1)}


@pytest.fixture(scope="module")
def single(fxs, tmp_path_factory):
    """Each case's single-process run, serial, in this process, once."""
    d = tmp_path_factory.mktemp("single")
    done = {}

    def get(case):
        name, argv = CASES[case]
        argv = [a for a in argv if a not in ("--cpu", "2")]
        key = (name, tuple(argv))
        if key not in done:
            fx = fxs[name]
            done[key] = run_single([*argv, *BLOCK, fx.hmm_path,
                                    fx.fasta_path], d / f"s{len(done)}")
        return done[key]
    return get


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_print_the_single_process_bytes(fxs, single, tmp_path,
                                                  case):
    name, argv = CASES[case]
    fx = fxs[name]
    got = run_ranks(2, [*argv, *BLOCK, fx.hmm_path, fx.fasta_path],
                    tmp_path / "r")
    want = single(case)
    assert got == want
    assert any(not ln.startswith("#") for ln in want[1].splitlines())
    if case == "torch-fs":
        assert any(not ln.startswith("#") for ln in want[2].splitlines())


def test_environment_routes_like_the_flags(fxs, tmp_path):
    fx = fxs["standard"]
    argv = ["--device", "cpu", *BLOCK, fx.hmm_path, fx.fasta_path]
    got = run_ranks(2, argv, tmp_path / "r", flags=False,
                    env_of=lambda rank, port: {
                        "BATH_NPROCS": "2", "BATH_PROC_ID": str(rank),
                        "BATH_COORDINATOR": f"localhost:{port}"})
    assert got == run_single(argv, tmp_path / "single")


def hit_parts(nranks, seed):
    """Per-rank result lists as the CLI gathers them: (tid, hits, hit
    windows) with tids dealt tid % nranks, each rank's list in its own
    order, the ranks in any order."""
    rng = random.Random(seed)
    rows = [(tid, [f"hit{tid}.{k}" for k in range(rng.randint(0, 3))],
             [(tid, w) for w in range(rng.randint(0, 2))])
            for tid in range(40)]
    parts = [[r for r in rows if r[0] % nranks == rank]
             for rank in range(nranks)]
    for p in parts:
        rng.shuffle(p)
    rng.shuffle(parts)
    return rows, parts


@pytest.mark.parametrize("nranks", [1, 2, 3, 5])
def test_merge_results_is_the_reference(nranks):
    rows, parts = hit_parts(nranks, nranks)
    got = hosts.merge_results([list(p) for p in parts])
    assert got == ref_hosts.merge_results([list(p) for p in parts])
    assert got == rows


def test_helpers_without_a_group():
    """One process: the gather is the payload itself and the counters
    are unchanged, as the reference's on one JAX process."""
    rows, parts = hit_parts(1, 9)
    assert hosts.process_count() == 1
    assert hosts.allgather_bytes(b"\x00abc") == [b"\x00abc"]
    assert hosts.allgather_results(parts[0]) == rows
    deltas = {"n_past_msv": 7, "pos_past_fwd": 2 ** 62}
    assert hosts.psum_counters(deltas) == ref_hosts.psum_counters(deltas) \
        == deltas
    assert hosts.maybe_init_from_args(
        bathsearch.build_parser().parse_args(["q", "t"])) == (1, 0)
    hosts.shutdown()


GATHER = '''
import pickle, sys
from bath_tpu_torch.parallel import hosts
rank, n, port = (int(a) for a in sys.argv[1:4])
hosts.init_distributed(f"localhost:{port}", n, rank)
payload = bytes(range(256)) * rank + b"r%d" % rank
parts = hosts.allgather_bytes(payload)
sums = hosts.psum_counters({"n": 2 ** 62 + rank, "pos": rank})
hosts.shutdown()
print(pickle.dumps((parts, sums)).hex())
'''


def test_gather_and_counter_sums_over_three_ranks():
    """Payloads of different lengths come back in rank order on every
    rank; the counter sums are exact integers past 2^63."""
    port, n = free_port(), 3
    procs = [subprocess.Popen(
        [sys.executable, "-c", GATHER, str(i), str(n), str(port)], cwd=ROOT,
        env=rank_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(n)]
    try:
        outs = [p.communicate(timeout=RANK_LIMIT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    want = [bytes(range(256)) * i + b"r%d" % i for i in range(n)]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        parts, sums = pickle.loads(bytes.fromhex(out.split()[-1]))
        assert parts == want
        assert sums == {"n": 3 * 2 ** 62 + 3, "pos": 3}
