"""One run of one cell: set-up, the measured window, the check.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``; everything
that belongs to it sits in files the harness finds by name:

- ``perfbench/workloads/<cell>.json``: its traffic (the genome
  generator's parameters), the warm-up genome's length, extra
  arguments and environment of the job, the check's sample sizes and
  limits;
- ``perfbench/configs/<config>.json``: the deployment (query file,
  search settings, host threads, the entry it runs);
- ``perfbench/entries/<entry>.py``: how a job of that entry is made
  and run;
- ``perfbench/metrics/<metric>.py``: a reader, ``read(run)`` -> a
  number or None, for every metric ``BENCHMARK.json`` lists;
- ``perfbench/checks/<number>.py``: each number the cell's ``limits``
  name (``check.py``).

The recorder keeps the items of the device stages that the cell's
numbers and metric readers declare (their ``ITEMS``), and no others.

A run: the inputs are made from ``--seed``; one warm-up job on a short
genome carrying the cell's copies launches every stage of the path;
then whole jobs run back to back from the window's start, and the
window closes at the end of the first job that ends after
``--seconds``.  With ``--trace 1`` ``torch.profiler`` records the
window.  Then the program's state is freed and the check holds the
jobs' answers against the reference (``check.py``).
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from . import check
from .recorder import Job, Recorder

# modules that may not be loaded once the window has closed, by whole
# top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "bath_tpu")


def process_start() -> float:
    """This process's start on the ``time.time`` clock."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - up + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def host_cores(n: int) -> list:
    """<n> of the cores this process may use, one a physical core first
    where the machine says which of them are siblings."""
    allowed = sorted(os.sched_getaffinity(0))
    first = []
    for c in allowed:
        try:
            with open(f"/sys/devices/system/cpu/cpu{c}/topology/"
                      "thread_siblings_list") as f:
                head = int(f.read().replace("-", ",").split(",")[0])
        except (OSError, ValueError):
            head = c
        if head == c:
            first.append(c)
    return (first + [c for c in allowed if c not in first])[:n]


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in sys.modules}
                  & set(FORBIDDEN))


class Spec:
    """``BENCHMARK.json`` and the files of one of its cells."""

    def __init__(self, root: Path, cell: str):
        self.root = root
        self.bench = json.loads((root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if cell not in cells:
            raise KeyError(f"no cell {cell!r} in BENCHMARK.json")
        self.entry = cells[cell]
        self.name = cell
        self.cell = json.loads(
            (root / "perfbench" / "workloads" / f"{cell}.json").read_text())
        self.config = json.loads(
            (root / "perfbench" / "configs"
             / f"{self.entry['config']}.json").read_text())

    def metrics(self, trace: bool) -> list:
        """The cell's metrics of the run's kind: end-to-end ones with
        ``--trace 0``, per-layer ones with ``--trace 1``."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if "workloads" not in m or self.name in m["workloads"]]


def metric(root: Path, name: str):
    """The module of metric <name> (``perfbench/metrics/<name>.py``)."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(root: Path, name: str):
    return metric(root, name).read


def kept_stages(spec: Spec, numbers: dict) -> set:
    """The device stages whose items the cell's <numbers> and its
    metrics, of either kind, read."""
    mods = [*numbers.values(), *(metric(spec.root, m["name"])
                                 for t in (False, True)
                                 for m in spec.metrics(t))]
    return {s for m in mods for s in getattr(m, "ITEMS", ())}


class Run:
    """What a metric reader reads: the window's jobs (``recorder.Job``,
    each with its spans, its items and the program's ``stats``), the
    window's length, the megabases searched, the set-up, the profiles'
    lengths, the program's phase spans and the trace's summary."""

    def __init__(self):
        self.jobs: list = []
        self.window_s = 0.0
        self.mb = 0.0
        self.setup_s = 0.0
        self.model_M: dict = {}
        self.phase: dict = {}           # BATH_PHASE_STATS: {span: s}
        self.trace = None               # trace.Summary


def model_lengths(text: str) -> dict:
    """{profile name: M} from a query file's headers."""
    out, name = {}, None
    for line in text.splitlines():
        if line.startswith("NAME "):
            name = line.split()[1]
        elif line.startswith("LENG ") and name is not None:
            out[name] = int(line.split()[1])
    return out


def power_limit() -> str | None:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 \
        and r.stdout.strip() else None


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: Path | None = None,
             t_proc: float | None = None) -> int:
    """Runs the cell and prints its result line; returns the exit code.
    <device> "cpu" runs the program's plain versions (the tests)."""
    t_proc = time.time() if t_proc is None else t_proc
    root = Path.cwd() if root is None else root
    spec = Spec(root, cell)
    cfg, cel = spec.config, spec.cell
    threads = str(cfg["host_threads"])
    # the process and every thread it starts on fixed cores
    os.sched_setaffinity(0, host_cores(int(threads)))
    os.environ["OMP_NUM_THREADS"] = threads
    os.environ.update(cel.get("env", {}))
    if trace:
        os.environ["BATH_PHASE_STATS"] = "1"
    import torch
    torch.set_num_threads(int(threads))
    entry = importlib.import_module(f"perfbench.entries.{cfg['entry']}")
    cuda = device == "cuda"
    scratch = Path(tempfile.mkdtemp(prefix="perfbench-"))
    try:
        return _run(spec, entry, seed, seconds, trace, device, cuda,
                    scratch, t_proc, torch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


def _run(spec, entry, seed, seconds, trace, device, cuda, scratch,
         t_proc, torch) -> int:
    cfg, cel = spec.config, spec.cell
    inputs = entry.prepare(spec.root, cfg, cel, scratch, seed)
    numbers = check.load(spec.root, cel["limits"])
    rec = Recorder(sorted(kept_stages(spec, numbers)))
    rec.install()
    # the warm-up job: every stage of the path launches once
    warm = entry.argv(cfg, cel, inputs, inputs.warm, scratch / "warm.out",
                      scratch / "warm.tbl", device)
    rc = entry.run(warm, {})
    if rc != 0:
        print(f"the warm-up job exited {rc}", file=sys.stderr)
        return 1
    if cuda:
        torch.cuda.synchronize()
    # set-up's objects leave the collector's generations, so that its
    # passes inside the window walk only what the jobs make
    gc.collect()
    gc.freeze()
    from bath_tpu_torch import phasestats
    run = Run()
    run.model_M = model_lengths(inputs.query.read_text())
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    phase0 = {k: v[1] for k, v in phasestats._STATS.items()}
    tblouts = []
    t_win = time.perf_counter()
    run.setup_s = time.time() - t_proc
    window = torch.profiler.record_function("bench.window") if trace \
        else None
    if window is not None:
        window.__enter__()
    while True:
        job = Job()
        tbl = scratch / f"job{len(run.jobs)}.tbl"
        args = entry.argv(cfg, cel, inputs, inputs.genome,
                          scratch / "job.out", tbl, device)
        rec.job = job
        job.start = time.perf_counter()
        try:
            job.rc = entry.run(args, job.stats)
        except Exception as exc:        # a failed job is counted, not fatal
            job.rc = f"{type(exc).__name__}: {exc}"
        if cuda:
            torch.cuda.synchronize()
        rec.job = None
        run.jobs.append(job)
        tblouts.append(tbl)
        # each job's garbage goes inside the window, in every job alike
        gc.collect()
        job.end = time.perf_counter()
        if job.end - t_win >= seconds:
            break
    if window is not None:
        window.__exit__(None, None, None)
    run.window_s = run.jobs[-1].end - t_win
    run.mb = len(run.jobs) * inputs.genome_nt / 1e6
    run.phase = {k: v[1] - phase0.get(k, 0.0)
                 for k, v in phasestats._STATS.items()}
    # read: the program's exit report would print after the checks
    phasestats._STATS.clear()
    if prof is not None:
        prof.__exit__(None, None, None)
        path = scratch / "trace.json"
        prof.export_chrome_trace(str(path))
        del prof
        from .trace import summarize
        run.trace = summarize(str(path), t_win, run.jobs)
        path.unlink()
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated())
           if cuda else 0}
    if cuda:
        dev["power_limit"] = power_limit()
    if trace:
        dev["busy_s"] = run.trace.busy_s if run.trace else 0.0
        dev["window_s"] = run.trace.window_s if run.trace \
            else run.window_s
    failed = sum(j.rc != 0 for j in run.jobs)
    metrics = {}
    for m in spec.metrics(trace):
        v = reader(spec.root, m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    info(run, inputs, seconds, torch)
    # the program's state goes before the reference runs on the card
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ctx = check.Context(run.jobs, inputs, cel, seed, device,
                        minlen(cfg), tblouts)
    t_check = time.perf_counter()
    correct, checks = check.decide(check.check(numbers, ctx), cel["limits"],
                                   failed)
    print(json.dumps({"check_s": time.perf_counter() - t_check}))
    # whatever the readers, the trace's summary or the check loaded
    # counts too
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 1
    for k, v in checks.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    result = {"correct": bool(correct), "attempted": len(run.jobs),
              "failed": failed, "metrics": metrics, "device": dev}
    if run.trace is not None:
        result["breakdown"] = breakdown(run.trace)
    result["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def minlen(config: dict) -> int:
    """The search's ``-l``: the shortest ORF it takes."""
    args = config["search_args"]
    return int(dict(zip(args, args[1:])).get("-l", 20))


def breakdown(s) -> dict:
    top = sorted(s.kernel_s.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(s.idle_by.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in gaps]}


def info(run, inputs, seconds, torch) -> None:
    """The lines before the result: the host, upstream BATH's own rate
    (Mc/s: residues of both strands x the query file's match states
    over the wall), every job's wall and the program's stats."""
    cells = 2 * inputs.genome_nt * sum(run.model_M.values())
    print(json.dumps({
        "host_cpus": os.cpu_count(),
        "omp_num_threads": os.environ.get("OMP_NUM_THREADS"),
        "torch_threads": torch.get_num_threads(),
        "seconds": seconds, "setup_s": run.setup_s,
        "window_s": run.window_s, "jobs": len(run.jobs),
        "mc_per_s": cells * len(run.jobs) / run.window_s / 1e6,
        "job_walls": [j.wall for j in run.jobs],
        "failed": [str(j.rc) for j in run.jobs if j.rc != 0]}))
    print(json.dumps({"stats": [{k: v for k, v in j.stats.items()
                                 if k != "mq_stages"} for j in run.jobs],
                      "phase_s": run.phase}, default=str))
