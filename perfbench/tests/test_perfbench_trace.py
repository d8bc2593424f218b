"""The trace reduction on a synthetic Chrome trace whose numbers are
known: busy time, kernel time a stage, idle time by host span."""

import json

import pytest

from perfbench import trace
from perfbench.recorder import Job


def test_summarize_synthetic(tmp_path):
    # perf_counter 100.0 s is trace 5e6 us; window 100.0-101.0 s
    off = 5e6 - 100.0 * 1e6
    us = lambda t: t * 1e6 + off                          # noqa: E731
    job = Job()
    job.start, job.end = 100.0, 101.0
    job.spans = [("gates.host", 100.1, 100.3),
                 ("downstream.host", 100.3, 100.9),
                 ("stage.fwd_scores", 100.4, 100.5),
                 ("stage.domdec", 100.6, 100.8)]
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.window",
           "ts": us(100.0), "dur": 1e6}]
    # a gate kernel launched at 100.41 runs 100.42-100.46, decoding's
    # at 100.61 runs 100.62-100.72 (two kernels), a copy 100.72-100.74
    for corr, (t_launch, t0, t1, name) in enumerate([
            (100.41, 100.42, 100.46, "fwd_parser_kernel"),
            (100.61, 100.62, 100.70, "domdec_kernel"),
            (100.62, 100.70, 100.72, "domdec_kernel")]):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name":
                   "cudaLaunchKernel", "ts": us(t_launch), "dur": 5,
                   "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": us(t0),
                   "dur": (t1 - t0) * 1e6, "args": {"correlation": corr}})
    ev.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
               "ts": us(100.72), "dur": 0.02e6, "args": {}})
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    s = trace.summarize(str(path), 100.0, [job])
    assert s.window_s == pytest.approx(1.0)
    assert s.busy_s == pytest.approx(0.04 + 0.10 + 0.02)
    assert s.stage_kernel_s["gate"] == pytest.approx(0.04)
    assert s.stage_kernel_s["decoding"] == pytest.approx(0.10)
    assert s.kernel_s["domdec_kernel"] == pytest.approx(0.10)
    want = {"cli": 0.1, "gates.host": 0.2, "output": 0.1,
            "downstream.host": 0.1 + 0.1 + 0.1,
            "stage.fwd_scores": 0.06, "stage.domdec": 0.2 - 0.12}
    assert set(s.idle_by) == set(want)
    for k, v in want.items():
        assert s.idle_by[k] == pytest.approx(v, abs=1e-9), k
    assert sum(s.idle_by.values()) == pytest.approx(1.0 - s.busy_s)


def test_no_device_activity(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": "bench.window",
         "ts": 10.0, "dur": 100.0}]}))
    assert trace.summarize(str(path), 0.0, []) is None
