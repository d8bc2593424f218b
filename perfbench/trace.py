"""The device trace of a ``--trace 1`` run, and what it says.

``torch.profiler`` (CUPTI) records the window; its Chrome trace gives
every kernel, copy and fill on the card and every launch on the host,
on one clock.  The window is the benchmark's ``bench.window``
annotation; the benchmark's own spans (``recorder``) are put on the
trace's clock through it.  From that:

- ``busy_s``: the union of the device's kernel, copy and fill intervals
  inside the window;
- ``kernel_s``: device seconds by kernel name;
- ``stage_kernel_s``: the kernel seconds of each device stage, a
  kernel counted to the stage span that was open when the host
  launched it;
- ``idle_by``: the seconds the device sat idle, by what the host was
  doing then (the innermost benchmark span open: a device stage,
  ``gates.host``, ``downstream.host``, ``output`` after a job's last
  flush, else ``cli``).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
STAGES = {"stage.fwd_scores": "gate", "stage.domdec": "decoding"}


@dataclass
class Summary:
    window_s: float
    busy_s: float
    kernel_s: dict = field(default_factory=dict)
    stage_kernel_s: dict = field(default_factory=dict)
    idle_by: dict = field(default_factory=dict)


def _union(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def host_label(job, t: float) -> str:
    """What the host was doing at perf_counter time <t> of <job>."""
    inner = None
    for lab, a, b in job.spans:
        if a <= t <= b and (inner is None or a >= inner[1]):
            inner = (lab, a, b)
    if inner is not None:
        lab, a, _ = inner
        if lab != "flush":
            return lab
        first = min((s for l2, s, _ in job.spans
                     if l2.startswith("stage.") and a <= s), default=None)
        return "gates.host" if first is None or t < first \
            else "downstream.host"
    flushes = [b for lab, _, b in job.spans
               if lab in ("flush", "gates.host", "downstream.host")]
    return "output" if flushes and t > max(flushes) else "cli"


def summarize(path: str, t_window: float, jobs: list) -> Summary | None:
    """The trace at <path>, whose window opened at perf_counter time
    <t_window>; None when it holds no window or no device activity."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    offset = w0 - t_window * 1e6          # trace us - perf_counter us
    dev = [e for e in events if e.get("cat") in DEVICE_CATS
           and e.get("ph") == "X"]
    iv = [(max(w0, float(e["ts"])), min(w1, float(e["ts"]) + float(e["dur"])))
          for e in dev]
    busy = _union([(a, b) for a, b in iv if b > a])
    if not busy:
        return None
    s = Summary(window_s=(w1 - w0) / 1e6,
                busy_s=sum(b - a for a, b in busy) / 1e6)
    launch = {e["args"]["correlation"]: float(e["ts"]) for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}

    def job_at(t):
        for j in jobs:
            if j.start <= t <= j.end:
                return j
        return None

    for e in dev:
        t0, dur = float(e["ts"]), float(e["dur"])
        if e["cat"] != "kernel" or t0 + dur < w0 or t0 > w1:
            continue
        s.kernel_s[e["name"]] = s.kernel_s.get(e["name"], 0.0) + dur / 1e6
        at = launch.get(e.get("args", {}).get("correlation"))
        if at is None:
            continue
        t = (at - offset) / 1e6
        job = job_at(t)
        if job is None:
            continue
        for lab, a, b in job.spans:
            if lab in STAGES and a <= t <= b:
                st = STAGES[lab]
                s.stage_kernel_s[st] = s.stage_kernel_s.get(st, 0.0) \
                    + dur / 1e6
                break
    # the idle intervals, cut where the host's span changes, each
    # piece counted to what the host was doing then
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    cuts = sorted({w0, w1} | {t * 1e6 + offset for j in jobs
                              for t in (j.start, j.end, *(x for _, a, b
                                                          in j.spans
                                                          for x in (a, b)))
                              if w0 < t * 1e6 + offset < w1})
    gi = 0
    for c0, c1 in zip(cuts, cuts[1:]):
        mid = ((c0 + c1) / 2 - offset) / 1e6
        job = job_at(mid)
        lab = host_label(job, mid) if job is not None else "between_jobs"
        while gi < len(gaps) and gaps[gi][1] <= c0:
            gi += 1
        k = gi
        while k < len(gaps) and gaps[k][0] < c1:
            a, b = max(gaps[k][0], c0), min(gaps[k][1], c1)
            if b > a:
                s.idle_by[lab] = s.idle_by.get(lab, 0.0) + (b - a) / 1e6
            k += 1
    return s
