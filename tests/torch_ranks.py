"""Rank processes of the port's ``bathsearch --hosts N`` for the tests
(``test_torch_hosts.py``, ``test_torch_hosts_modes.py``): each rank a
``python -m bath_tpu_torch.cli.bathsearch`` on a free port of this
machine, with ``OMP_NUM_THREADS=1``, under a time limit of its own, and
killed if it is still alive when the call ends; and the single-process
runs they are held to.
"""

import os
import re
import socket
import subprocess
import sys

from bath_tpu_torch.cli import bathsearch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = ["--block_length", "8000"]
HOST_FILTERS = {"BATH_MSV_DEVICE": "0", "BATH_VIT_DEVICE": "0"}
RUN_LINES = ("# Option settings:", "# Current dir:", "# Date:")
RANK_LIMIT_S = 240


def masked(path) -> str:
    return re.sub(r"# (CPU time|Mc/sec):.*", "", open(path).read())


def table(path) -> str:
    return "".join(ln for ln in open(path) if not ln.startswith(RUN_LINES))


def outputs(stem) -> tuple:
    return (masked(f"{stem}.out"), table(f"{stem}.tbl"),
            table(f"{stem}.fst"))


def out_args(stem) -> list:
    return ["-o", f"{stem}.out", "--tblout", f"{stem}.tbl", "--fstblout",
            f"{stem}.fst"]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_env(**extra) -> dict:
    """This process's environment for a rank: one thread, the host
    filters, the repository on the path, no rank variables but those
    in <extra>."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("BATH_NPROCS", "BATH_PROC_ID", "BATH_COORDINATOR")}
    env.update(OMP_NUM_THREADS="1", **HOST_FILTERS, **extra)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


def run_ranks(n, argv, stem, flags=True, env_of=None):
    """Starts n ranks of the port's bathsearch with <argv> (and the
    rank's --hosts flags, or <env_of>(rank)'s environment), each writing
    to <stem><rank>.*; waits for all under RANK_LIMIT_S and kills any
    left; returns rank 0's outputs after checking that every rank exited
    0 and that no other rank wrote a file."""
    port = free_port()
    procs = []
    try:
        for i in range(n):
            rank = ["--hosts", str(n), "--host-id", str(i), "--coordinator",
                    f"localhost:{port}"] if flags else []
            env = rank_env(**(env_of(i, port) if env_of else {}))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "bath_tpu_torch.cli.bathsearch",
                 *rank, *argv, *out_args(f"{stem}{i}")], cwd=ROOT, env=env,
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                text=True))
        for p in procs:
            _, err = p.communicate(timeout=RANK_LIMIT_S)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i in range(1, n):
        assert not [x for x in ("out", "tbl", "fst")
                    if os.path.exists(f"{stem}{i}.{x}")], i
    return outputs(f"{stem}0")



# (fixture, port arguments) of each case
CASES = {
    "numpy": ("standard", ["--backend", "numpy"]),
    "torch": ("standard", ["--device", "cpu"]),
    "torch-fs": ("fs", ["--device", "cpu", "--fs"]),
    "numpy-cpu2": ("standard", ["--backend", "numpy", "--cpu", "2"]),
    # under --hosts no hybrid: the chunked cascade over the rank's windows
    "torch-cpu2": ("standard", ["--device", "cpu", "--cpu", "2"]),
}


def run_single(argv, stem) -> tuple:
    """One process's run of the port's bathsearch, in this process,
    with the host filters; its outputs."""
    saved = {k: os.environ.get(k) for k in HOST_FILTERS}
    os.environ.update(HOST_FILTERS)
    try:
        assert bathsearch.run([*argv, *out_args(stem)]) == 0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    return outputs(stem)
