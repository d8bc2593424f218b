"""output_host_s_per_mb: host seconds a megabase in E-values and
output: the program's ``phasestats`` span ``cli.output``, from
``compute_evalues_bath`` to a query's ``//``, the ``--splice``
post-pass left out."""


def read(run):
    s = run.phase.get("cli.output")
    return s / run.mb if s is not None else None
