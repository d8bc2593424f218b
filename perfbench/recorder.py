"""The benchmark's spans and its record of the device stages' items.

``Recorder.install`` wraps, from the benchmark's side, the calls of
each layer of ``bath_tpu_torch``: the flushes of the single-query
cascade (``cli.bathsearch.flush_gates``, ``flush_downstream``), the
multi-query flush (``multiquery.flush_multi``) and every device stage
of ``TorchCascade`` and ``PackedGates``.  While a job is open each call
adds a span ``(label, start, end)`` on ``time.perf_counter``; the
Forward gate and decoding also keep every item they were given and
what they returned, which the check holds against the reference.
"""

from __future__ import annotations

import functools
import time

import numpy as np

CASCADE_STAGES = ("fwd_scores", "domdec", "fs3_scores", "fs3_domdec",
                  "msv_scores", "vit_scores", "ssv_captures",
                  "vit_captures")
PACKED_STAGES = ("fwd_scores", "domdec", "fs3_scores", "fs3_domdec")


class Job:
    def __init__(self):
        self.spans: list = []           # (label, start, end)
        self.fwd: list = []             # (profile, residues, score)
        self.domdec: list = []          # (profile, residues, btot,
        #                                  etot, mocc, ok)
        self.stats: dict = {}
        self.start = self.end = 0.0
        self.rc = None

    @property
    def wall(self) -> float:
        return self.end - self.start

    def span_s(self, *labels) -> float:
        return sum(b - a for lab, a, b in self.spans if lab in labels)


class Recorder:
    def __init__(self):
        self.job: Job | None = None

    def _span(self, label, fn):
        @functools.wraps(fn)
        def wrapped(*a, **kw):
            job = self.job
            if job is None:
                return fn(*a, **kw)
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                job.spans.append((label, t0, time.perf_counter()))
        return wrapped

    def install(self) -> None:
        from bath_tpu_torch.cli import bathsearch
        from bath_tpu_torch import device_pipeline, multiquery
        bathsearch.flush_gates = self._span("gates.host",
                                            bathsearch.flush_gates)
        bathsearch.flush_downstream = self._span(
            "downstream.host", bathsearch.flush_downstream)
        multiquery.flush_multi = self._span("flush", multiquery.flush_multi)
        tc, pg = device_pipeline.TorchCascade, multiquery.PackedGates
        for name in CASCADE_STAGES:
            setattr(tc, name, self._span(f"stage.{name}", getattr(tc, name)))
        for name in PACKED_STAGES:
            setattr(pg, name, self._span(f"stage.{name}", getattr(pg, name)))
        tc.fwd_scores = self._keep_cascade_fwd(tc.fwd_scores)
        tc.domdec = self._keep_cascade_domdec(tc.domdec)
        pg.fwd_scores = self._keep_packed_fwd(pg.fwd_scores)
        pg.domdec = self._keep_packed_domdec(pg.domdec)

    # -- the items of the two f32 stages -------------------------------
    def _keep_cascade_fwd(self, fn):
        @functools.wraps(fn)
        def wrapped(cascade, seqs, lens):
            out = fn(cascade, seqs, lens)
            if self.job is not None:
                name = cascade.om.name
                self.job.fwd += [(name, np.array(s, np.int8), float(v))
                                 for s, v in zip(seqs, out)]
            return out
        return wrapped

    def _keep_cascade_domdec(self, fn):
        @functools.wraps(fn)
        def wrapped(cascade, orfseqs):
            out = fn(cascade, orfseqs)
            if self.job is not None:
                name = cascade.om.name
                bt, et, mo, ok = out
                for i, s in enumerate(orfseqs):
                    n = int(s.n)
                    self.job.domdec.append(
                        (name, np.array(s.dsq[:n], np.int8),
                         *(np.array(a[i][:n + 1]) for a in (bt, et, mo)),
                         bool(ok[i])))
            return out
        return wrapped

    def _keep_packed_fwd(self, fn):
        @functools.wraps(fn)
        def wrapped(gates, items):
            out = fn(gates, items)
            if self.job is not None:
                self.job.fwd += [(qs.hmm.name, np.array(d[:n], np.int8),
                                  float(v))
                                 for (qs, d, n), v in zip(items, out)]
            return out
        return wrapped

    def _keep_packed_domdec(self, fn):
        @functools.wraps(fn)
        def wrapped(gates, items):
            out = fn(gates, items)
            if self.job is not None:
                for (qs, d, n), (bt, et, mo, ok) in zip(items, out):
                    self.job.domdec.append(
                        (qs.hmm.name, np.array(d[:n], np.int8),
                         *(np.array(a[:n + 1]) for a in (bt, et, mo)),
                         bool(ok)))
            return out
        return wrapped
