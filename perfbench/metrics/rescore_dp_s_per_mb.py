"""rescore_dp_s_per_mb: host seconds a megabase in the native DPs of
rescoring (Forward, Backward, decoding, optimal accuracy and its trace,
standard and fs5): the program's ``phasestats`` span ``rescore.dp``."""


def read(run):
    s = run.phase.get("rescore.dp")
    return s / run.mb if s is not None else None
