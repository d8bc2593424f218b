"""The readings the check's limits are set from, on the card:

    python3 -m perfbench.control --workload <cell> --seeds 1,2,3

For each seed, in one process: the cell's inputs, one job of the
timed path at the cell's size (after one warm-up job), then the
numbers ``check.py`` compares, for the program (its sound readings),
and for the control: the reference computed in bfloat16, the precision
below the configuration's float32, put in the device stages' place.
Each side's ``correct`` is decided as a run decides it
(``check.decide``, the cell's limits).  One JSON line a seed; the
command exits 1 unless the program comes out correct and the control
not, on every seed.  The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

from . import check
from .harness import Spec, kept_stages, minlen
from .recorder import DECODINGS, Job, Recorder


def readings(cell: str, seeds: list, device: str = "cuda",
             root: Path | None = None) -> list:
    root = Path.cwd() if root is None else root
    spec = Spec(root, cell)
    cfg, cel = spec.config, spec.cell
    os.environ["OMP_NUM_THREADS"] = str(cfg["host_threads"])
    os.environ.update(cel.get("env", {}))
    import torch
    entry = importlib.import_module(f"perfbench.entries.{cfg['entry']}")
    numbers = check.load(root, cel["limits"])
    rec = Recorder(sorted(kept_stages(spec, numbers)))
    rec.install()
    out = []
    for i, seed in enumerate(seeds):
        scratch = Path(tempfile.mkdtemp(prefix="perfbench-control-"))
        try:
            inputs = entry.prepare(root, cfg, cel, scratch, seed)
            if i == 0:
                entry.run(entry.argv(cfg, cel, inputs, inputs.warm,
                                     scratch / "warm.out",
                                     scratch / "warm.tbl", device), {})
            job = Job()
            tbl = scratch / "job.tbl"
            rec.job = job
            job.rc = entry.run(entry.argv(cfg, cel, inputs, inputs.genome,
                                          scratch / "job.out", tbl,
                                          device), job.stats)
            rec.job = None
            if device == "cuda":
                torch.cuda.synchronize()
            ctx = check.Context([job], inputs, cel, seed, device,
                                minlen(cfg), [tbl])
            t0 = time.perf_counter()
            prog = check.check(numbers, ctx)
            t1 = time.perf_counter()
            # the control in the stages' place: the same items and hits,
            # its own gaps
            ctl = {**prog, **check.control(numbers, ctx)}
            failed = int(job.rc != 0)
            row = {"cell": cell, "seed": seed, "rc": job.rc,
                   **{f"{k.removesuffix('_scores')}_items": len(v)
                      for k, v in job.items.items()},
                   **{f"{k}_ok": sum(r[5] for r in job.items[k])
                      for k in DECODINGS},
                   "check_s": t1 - t0, "control_s": time.perf_counter() - t1,
                   "program": prog, "control_bf16": ctl,
                   "program_correct": check.decide(prog, cel["limits"],
                                                   failed)[0],
                   "control_correct": check.decide(ctl, cel["limits"],
                                                   failed)[0],
                   "limits": cel["limits"]}
            print(json.dumps(row), flush=True)
            out.append(row)
        finally:
            shutil.rmtree(scratch, ignore_errors=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="perfbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    a = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("perfbench.control: no CUDA device", file=sys.stderr)
        return 2
    rows = readings(a.workload, [int(s) for s in a.seeds.split(",")])
    bad = [r["seed"] for r in rows
           if not r["program_correct"] or r["control_correct"]]
    if bad:
        print(f"perfbench.control: the program not correct or the control "
              f"correct on seeds {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
