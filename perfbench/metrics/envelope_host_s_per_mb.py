"""envelope_host_s_per_mb: host seconds a megabase in envelope
rescoring, the program's own ``phasestats`` spans ``envelope-std`` and
``envelope-fs5`` (``BATH_PHASE_STATS=1``, set in traced runs)."""

SPANS = ("envelope-std", "envelope-fs5")


def read(run):
    s = sum(run.phase.get(k, 0.0) for k in SPANS)
    return s / run.mb if s > 0 else None
