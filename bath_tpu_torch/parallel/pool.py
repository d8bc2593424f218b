"""Worker pools of ``bathsearch --cpu N``, started without forking the
caller.

The JAX package forks its pools (``multiprocessing``'s ``fork``).  A
child forked from a process that has run an OpenMP team hangs at its
own first team of more than one thread, since GNU libgomp does not
survive ``fork``, and a child forked from a process that holds a CUDA
context must never touch CUDA.  A search of this package does both
before a pool may start: the native host library extracts every
window's ORFs in a team of three and runs its batch filters in teams,
and ``TorchCascade`` uploads its tables to the card when a query
starts.  So the serial per-query loop's second query, and any caller
that searched before in the same process, would fork from such a
state.  Here every pool's workers come from ``forkserver``: a server
process started afresh, which has run no OpenMP team and holds no CUDA
context, forks them.  The server imports the search modules once
(``PRELOAD``; importing them runs neither), so a worker starts without
importing PyTorch again.

A worker gets, through the pool's initializer and pickled once for it,
the context its task reads (set as a module global, as the forked
workers find it), the caller's environment (the server keeps the one
it started with), and no CUDA device: workers run host stages only,
and one that reached for the card would raise.  A worker's exception
is raised again by the caller, and a worker that dies breaks the pool
(``BrokenProcessPool``); nothing is retried.  Asked to (``stats``),
every worker says before its pool closes whether it made a CUDA
context, how many kernels it launched, counted in the worker, and which
native host library it mapped (the sanitizer tier checks that the
workers run the library their caller named).

The server, and the resource tracker that ``multiprocessing`` starts
with it, outlive the pools, so that a process's later pools start
without importing PyTorch again.  They end by themselves only after
the process that started them has exited; ``stop_servers`` ends them
and waits for them, which the CLI does before it exits.
"""

from __future__ import annotations

import contextlib
import importlib
import inspect
import multiprocessing as mp
import os
import sys
import time
from collections import deque
from concurrent.futures import ProcessPoolExecutor

START_METHOD = "forkserver"
# imported once by the server, before it forks a worker (PyTorch and
# the host pipeline; not the CLI, which a worker imports as its main
# module when the caller runs it as ``python -m``)
PRELOAD = ["bath_tpu_torch.multiquery"]


def _context():
    ctx = mp.get_context(START_METHOD)
    ctx.set_forkserver_preload(PRELOAD)
    return ctx


def by_name(fn):
    """<fn> from its module under the module's import name.  A module
    run as ``python -m`` runs as ``__main__``: its functions would be
    pickled under that name, and a worker would find them in another
    module object than the one its context is set in."""
    spec = getattr(sys.modules[fn.__module__], "__spec__", None)
    if spec is None or spec.name == fn.__module__:
        return fn
    return getattr(importlib.import_module(spec.name), fn.__qualname__)


# (when this worker's initializer began, when it ended), on the clock
# that every process of the host shares
_INIT_T = (0.0, 0.0)


def _init(module, name, value, env, initializer, initargs):
    global _INIT_T
    t = time.monotonic()
    os.environ.clear()
    os.environ.update(env)
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    setattr(importlib.import_module(module), name, value)
    if initializer is not None:
        initializer(*initargs)
    _INIT_T = (t, time.monotonic())


def _started():
    return (os.getpid(), *_INIT_T)


def launches() -> int:
    """The CUDA launches counted, in this process, by every kernel
    wrapper of ``bath_tpu_torch.ops`` imported here."""
    fns = {id(f): f for name, mod in list(sys.modules.items())
           if name.startswith("bath_tpu_torch.ops.")
           for f in vars(mod).values() if inspect.isfunction(f)
           and isinstance(getattr(f, "launches", None), int)}
    return sum(f.launches for f in fns.values())


def mapped_native() -> list:
    """The native host libraries mapped into this process."""
    with open("/proc/self/maps") as f:
        return sorted({ln.split()[-1] for ln in f
                       if "libbathio" in ln.split()[-1]})


def _report():
    # a short wait, so that each idle worker takes one of the probes
    time.sleep(0.01)
    import torch
    return (os.getpid(), torch.cuda.is_initialized(), launches(),
            mapped_native())


def report(pool, stats) -> None:
    """Asks every worker of <pool> whether it made a CUDA context, how
    many kernels it launched and which native libraries it mapped;
    <stats> gets the workers that made one (``worker_cuda``), their
    launches (``worker_launches``), summed over pools, and the libraries
    (``worker_native``, every path once)."""
    pids = set(pool._processes)
    seen: dict = {}
    while not pids <= seen.keys():
        for f in [pool.submit(_report) for _ in pids]:
            pid, cuda, n, libs = f.result()
            seen[pid] = (cuda, n, libs)
    stats["worker_cuda"] = stats.get("worker_cuda", 0) \
        + sum(c for c, _, _ in seen.values())
    stats["worker_launches"] = stats.get("worker_launches", 0) \
        + sum(n for _, n, _ in seen.values())
    stats["worker_native"] = sorted(set(stats.get("worker_native", []))
                                    .union(*(v[2] for v in seen.values())))


@contextlib.contextmanager
def worker_pool(nworkers: int, module: str, name: str, value,
                initializer=None, initargs=(), stats=None):
    """A ``ProcessPoolExecutor`` of <nworkers> workers in which
    ``<module>.<name>`` is <value> and <initializer>(*<initargs>) has
    run.  Its workers are started at once (``ready`` waits for them).
    With <stats>, a dict, every worker reports before the pool closes
    (``report``).  On an exception the queued tasks are cancelled
    before the workers are joined."""
    pool = ProcessPoolExecutor(
        nworkers, mp_context=_context(), initializer=_init,
        initargs=(module, name, value, dict(os.environ), initializer,
                  initargs))
    pool.t0 = time.monotonic()
    # a worker is started at each submission while none is idle
    pool.started = [pool.submit(_started) for _ in range(nworkers)]
    try:
        yield pool
        if stats is not None:
            report(pool, stats)
    except BaseException:
        pool.shutdown(wait=True, cancel_futures=True)
        raise
    pool.shutdown(wait=True)


def ready(pools, stats=None) -> None:
    """Waits for every worker of <pools> to start.  <stats>, a dict,
    gets the seconds since the first pool was made (``pool_start_s``),
    of them those until the last worker's initializer began
    (``pool_spawn_s``: the server's start, in a process's first pool,
    then the fork and the worker's import of the caller's main module)
    and the longest initializer (``pool_init_s``: the context's
    unpickling), and the pools (``pools``)."""
    starts = [f.result() for pool in pools for f in pool.started]
    if stats is not None and pools:
        t0 = min(pool.t0 for pool in pools)
        add = {"pool_start_s": time.monotonic() - t0,
               "pool_spawn_s": max(b for _, b, _ in starts) - t0,
               "pool_init_s": max(e - b for _, b, e in starts)}
        for k, v in add.items():
            stats[k] = stats.get(k, 0.0) + v
        stats["pools"] = stats.get("pools", 0) + len(pools)


def stop_servers() -> None:
    """Stops the forkserver and the resource tracker that this
    process's pools started, if any, and waits for them to exit.  A
    later pool starts them again."""
    from multiprocessing import forkserver, resource_tracker
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


def imap(pool, fn, items, depth: int):
    """<fn> over <items> in <pool>, the results in the items' order
    (``Pool.imap`` with ``chunksize=1``); at most <depth> items are in
    flight, so the items are read as the results are taken."""
    pend: deque = deque()
    for item in items:
        pend.append(pool.submit(fn, item))
        if len(pend) >= depth:
            yield pend.popleft().result()
    while pend:
        yield pend.popleft().result()
