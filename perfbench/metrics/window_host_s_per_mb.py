"""window_host_s_per_mb: host seconds a megabase reading the target's
windows: the program's ``phasestats`` span ``cli.windows``, each
``next()`` of the CLI's window stream (``read_windows``, digitising,
the stream's bookkeeping)."""


def read(run):
    s = run.phase.get("cli.windows")
    return s / run.mb if s is not None else None
