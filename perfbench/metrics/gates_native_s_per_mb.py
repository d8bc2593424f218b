"""gates_native_s_per_mb: host seconds a megabase in the native filter
calls (MSV, bias and Viterbi batches, the SSV and Viterbi window
captures): the program's ``phasestats`` span ``gates.native``."""


def read(run):
    s = run.phase.get("gates.native")
    return s / run.mb if s is not None else None
