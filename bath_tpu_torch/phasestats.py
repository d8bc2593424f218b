"""Opt-in cumulative phase accounting (BATH_PHASE_STATS=1).

Used for the device-vs-host crossover analysis: the fs5 envelope
stack (full Forward/Backward/decoding/optacc per domain, ref:
impl_sse/fwdback_fs.c:2054,2634, decoding_fs.c:55, optacc_fs.c:53)
runs host-side at O(domains); this accounting measures what share of
end-to-end wall that is at a given hit density, against the
device-gate share reported by device_pipeline's BATH_DEVICE_STATS.
Printed once at process exit on stderr.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager

_STATS: dict[str, list] = {}
_ON = bool(os.environ.get("BATH_PHASE_STATS"))


@contextmanager
def phase(stage: str):
    if not _ON:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        s = _STATS.setdefault(stage, [0, 0.0])
        s[0] += 1
        s[1] += time.perf_counter() - t0
        if s[0] == 1 and len(_STATS) == 1:
            import atexit

            def report():
                import sys
                for k, (c, t) in sorted(_STATS.items()):
                    print(f"# phase-stats {k}: calls={c} "
                          f"wall_s={t:.2f}", file=sys.stderr)
            atexit.register(report)
