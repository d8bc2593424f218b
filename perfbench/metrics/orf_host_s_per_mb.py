"""orf_host_s_per_mb: host seconds a megabase making the six-frame
ORFs: the program's ``phasestats`` span ``cli.orfs``, the reverse
complement and ``extract_orfs`` of each window and strand."""


def read(run):
    s = run.phase.get("cli.orfs")
    return s / run.mb if s is not None else None
