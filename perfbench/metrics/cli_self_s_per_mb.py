"""cli_self_s_per_mb: the CLI's own host seconds a megabase (windows,
six-frame ORFs, E-values, output): each job's wall less its flushes
(the benchmark's spans around ``flush_gates`` and ``flush_downstream``,
or ``flush_multi``)."""


def read(run):
    own = sum(j.wall - j.span_s("gates.host", "downstream.host", "flush")
              for j in run.jobs)
    return own / run.mb
