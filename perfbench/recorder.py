"""The benchmark's spans and its record of the device stages' items.

``Recorder.install`` wraps, from the benchmark's side, the calls of
each layer of ``bath_tpu_torch``: the flushes of the single-query
cascade (``cli.bathsearch.flush_gates``, ``flush_downstream``), the
multi-query flush (``multiquery.flush_multi``) and every device stage
of ``TorchCascade`` and ``PackedGates``.  While a job is open each call
adds a span ``(label, start, end)`` on ``time.perf_counter``.  The
stages a recorder is given (``Recorder(stages)``: those the cell's
check numbers and metrics declare) also keep every item they were
given and what they returned, in ``Job.items[stage]``, which the check
holds against the reference:

- ``fwd_scores``: (profile, residues, score);
- ``domdec``: (profile, residues, btot, etot, mocc, ok);
- ``fs3_scores``: (profile, window nucleotides, score);
- ``fs3_domdec``: (profile, window nucleotides, btot, etot, mocc, ok,
  dec_loop), ``dec_loop`` the N/J/C loop probability the stage was
  given.
"""

from __future__ import annotations

import functools
import time

import numpy as np

CASCADE_STAGES = ("fwd_scores", "domdec", "fs3_scores", "fs3_domdec",
                  "msv_scores", "vit_scores", "ssv_captures",
                  "vit_captures")
PACKED_STAGES = ("fwd_scores", "domdec", "fs3_scores", "fs3_domdec")
# the stages whose items a recorder can keep: scores or posteriors
SCORES = ("fwd_scores", "fs3_scores")
DECODINGS = ("domdec", "fs3_domdec")


class Job:
    def __init__(self):
        self.spans: list = []           # (label, start, end)
        self.items: dict = {s: [] for s in SCORES + DECODINGS}
        self.stats: dict = {}
        self.start = self.end = 0.0
        self.rc = None

    @property
    def wall(self) -> float:
        return self.end - self.start

    def span_s(self, *labels) -> float:
        return sum(b - a for lab, a, b in self.spans if lab in labels)


class Recorder:
    """Spans of every stage; the items of <stages> (of ``SCORES`` and
    ``DECODINGS``)."""

    def __init__(self, stages):
        unknown = set(stages) - set(SCORES + DECODINGS)
        if unknown:
            raise ValueError(f"no keeper of the items of {sorted(unknown)}")
        self.stages = tuple(stages)
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
        for name in self.stages:
            cascade, packed = (self._keep_cascade_scores,
                               self._keep_packed_scores) if name in SCORES \
                else (self._keep_cascade_decoding,
                      self._keep_packed_decoding)
            setattr(tc, name, cascade(name, getattr(tc, name)))
            setattr(pg, name, packed(name, getattr(pg, name)))

    # -- the items of the kept stages ----------------------------------
    def _keep_cascade_scores(self, stage, fn):
        @functools.wraps(fn)
        def wrapped(cascade, seqs, lens):
            out = fn(cascade, seqs, lens)
            if self.job is not None:
                name = cascade.om.name
                self.job.items[stage] += [
                    (name, np.array(s[:n], np.int8), float(v))
                    for s, n, v in zip(seqs, lens, out)]
            return out
        return wrapped

    def _keep_cascade_decoding(self, stage, fn):
        @functools.wraps(fn)
        def wrapped(cascade, seqs, *a, **kw):
            out = fn(cascade, seqs, *a, **kw)
            extra = (*a, *kw.values())
            if self.job is not None:
                name = cascade.om.name
                bt, et, mo, ok = out
                for i, s in enumerate(seqs):
                    n = int(s.n)
                    self.job.items[stage].append(
                        (name, np.array(s.dsq[:n], np.int8),
                         *(np.array(a[i][:n + 1]) for a in (bt, et, mo)),
                         bool(ok[i]), *extra))
            return out
        return wrapped

    def _keep_packed_scores(self, stage, fn):
        @functools.wraps(fn)
        def wrapped(gates, items):
            out = fn(gates, items)
            if self.job is not None:
                self.job.items[stage] += [
                    (qs.hmm.name, np.array(d[:n], np.int8), float(v))
                    for (qs, d, n), v in zip(items, out)]
            return out
        return wrapped

    def _keep_packed_decoding(self, stage, fn):
        @functools.wraps(fn)
        def wrapped(gates, items, *a, **kw):
            out = fn(gates, items, *a, **kw)
            extra = (*a, *kw.values())
            if self.job is not None:
                for (qs, d, n), (bt, et, mo, ok) in zip(items, out):
                    self.job.items[stage].append(
                        (qs.hmm.name, np.array(d[:n], np.int8),
                         *(np.array(a[:n + 1]) for a in (bt, et, mo)),
                         bool(ok), *extra))
            return out
        return wrapped
