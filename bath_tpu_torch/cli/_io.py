"""Shared CLI input plumbing: stdin ('-') spooling.

The reference tools accept '-' for at most one input stream per
invocation (ref: testsuite/i17-stdin.pl contract; bathsearch.c /
bathfetch.c cmdline checks).  Our readers are path-based, so stdin is
spooled to a temp file that lives for the process lifetime.
"""

from __future__ import annotations

import atexit
import os
import shutil
import sys
import tempfile


def spool_stdin(suffix: str = ".in") -> str:
    """Copy stdin to a temp file and return its path."""
    fd, path = tempfile.mkstemp(suffix=suffix, prefix="bath_stdin_")
    with os.fdopen(fd, "w") as fh:
        shutil.copyfileobj(sys.stdin, fh)
    atexit.register(lambda p=path: os.path.exists(p) and os.remove(p))
    return path


def cli_main(run_fn):
    """Shared entry wrapper: run the tool, converting expected
    input-error exceptions into clean one-line failures (the
    reference's p7_Fail behavior) instead of tracebacks."""
    import sys
    try:
        sys.exit(run_fn())
    except (ValueError, KeyError, OSError) as e:
        msg = str(e)
        if isinstance(e, KeyError):
            msg = msg.strip("'\"")
        print(f"Error: {msg}", file=sys.stderr)
        sys.exit(1)
