"""The port's span recorder, switched on by ``BATH_PHASE_STATS=1`` (read
once, at import).

A span is a named stretch of host time: ``with phase(name):`` round a
block, ``each(name, iterable)`` round each ``next()`` of a stream,
``spanned(name)`` round each call of a function, and the table
``WRAPPED`` round each call of a binding that its callers import at
call time (``from .native import ...`` inside the function).  The
spans and the metrics of the benchmark that read them are listed in
PERF.md (section 3):

- ``cli.windows``, ``cli.orfs``, ``cli.output``, ``flush.gates``,
  ``flush.downstream``: ``cli/bathsearch.py``'s serial loop;
- ``stage.<name>``: each public stage of ``device_pipeline.TorchCascade``
  and ``multiquery.PackedGates``;
- ``envelope-std``, ``envelope-fs5``: envelope rescoring
  (``domaindef.py``, ``pipeline_fs.py``);
- ``gates.native``, ``rescore.dp``: the native filter batches and the
  native rescoring DPs (``WRAPPED``).

Off, ``phase`` returns one shared no-op context, ``each`` its iterable
and ``spanned`` its function, and the table is not installed: nothing
is timed or allocated.  On, each span adds to ``_STATS[name] =
[calls, seconds]`` on ``time.perf_counter``; a span opened inside an
open span of the same name counts once, at the outermost, so wrapped
bindings that call each other count once.  While a ``torch.profiler``
records, each outermost span is also a
``torch.profiler.record_function(name)``: a ``user_annotation`` on the
trace's clock that brackets what the span launched.  Spans are
recorded from the thread that drives the search.

Read with ``on()``, ``totals()`` and ``reset()``.  The totals are also
printed at process exit on stderr (``# phase-stats <name>: calls=<n>
wall_s=<s>``), which ``scripts/crossover_fs5.py`` reads.
"""

from __future__ import annotations

import atexit
import functools
import importlib
import os
import sys
import time

_STATS: dict[str, list] = {}
_ON = bool(os.environ.get("BATH_PHASE_STATS"))
_OPEN: dict[str, int] = {}          # spans open, by name
_REPORTING = False                  # the exit report is registered

# (span, module under this package, function): installed at import when
# tracing is on, by replacing the module's attribute
WRAPPED = tuple(("gates.native", "native", f) for f in (
    "msv_filter_native_batch", "bg_filter_score_batch",
    "vit_filter_score_batch", "vit_filter_native", "ssv_filter_bath_native",
    "vit_filter_bath_native")) + tuple(("rescore.dp", "native", f) for f in (
        "fwd_fill_native", "bwd_fill_native", "decoding_native",
        "oa_fill_native", "oa_trace_std_native", "fs5_forward_fill_native",
        "fs5_backward_fill_native", "fs5_decoding_native",
        "fs5_optacc_native", "fs5_oa_trace_native"))


class _Off:
    """The context of every span while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _profiling() -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and torch._C._autograd._profiler_enabled()


class _Span:
    __slots__ = ("name", "t0", "note")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        depth = _OPEN.get(self.name, 0)
        _OPEN[self.name] = depth + 1
        self.t0 = self.note = None
        if depth:
            return None
        if _profiling():
            import torch
            self.note = torch.profiler.record_function(self.name)
            self.note.__enter__()
        self.t0 = time.perf_counter()
        return None

    def __exit__(self, *exc):
        global _REPORTING
        t1 = time.perf_counter()
        _OPEN[self.name] -= 1
        if self.t0 is not None:
            s = _STATS.setdefault(self.name, [0, 0.0])
            s[0] += 1
            s[1] += t1 - self.t0
            if not _REPORTING:
                _REPORTING = True
                atexit.register(_report)
        if self.note is not None:
            self.note.__exit__(*exc)
        return False


def _report() -> None:
    for k, (c, t) in sorted(_STATS.items()):
        print(f"# phase-stats {k}: calls={c} wall_s={t:.2f}",
              file=sys.stderr)


def on() -> bool:
    """Whether tracing is on (``BATH_PHASE_STATS`` at import)."""
    return _ON


def phase(name: str):
    """The context of a span <name>."""
    return _Span(name) if _ON else _OFF


def each(name: str, iterable):
    """<iterable>, each ``next()`` of it a span <name>; the iterable
    itself when tracing is off."""
    return _each(name, iterable) if _ON else iterable


def _each(name, iterable):
    it = iter(iterable)
    while True:
        with _Span(name):
            try:
                item = next(it)
            except StopIteration:
                return
        yield item


def spanned(name: str):
    """Decorator: each call of the function a span <name>; the function
    itself when tracing is off."""
    def wrap(fn):
        if not _ON:
            return fn

        @functools.wraps(fn)
        def call(*args, **kwargs):
            with _Span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def totals() -> dict:
    """{span: (calls, seconds)}, a copy."""
    return {k: (c, t) for k, (c, t) in _STATS.items()}


def reset() -> None:
    """Forgets every span's totals."""
    _STATS.clear()


if _ON:
    for _span, _mod, _fn in WRAPPED:
        _m = importlib.import_module(f"{__package__}.{_mod}")
        setattr(_m, _fn, spanned(_span)(getattr(_m, _fn)))
