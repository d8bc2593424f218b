"""search_mb_per_s: megabases of target DNA searched against the whole
query file, over every job of the window, divided by the window."""


def read(run):
    return run.mb / run.window_s
