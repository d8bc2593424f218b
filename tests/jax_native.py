"""bath_tpu's native host library for the port's tests, built once for
every test process and loaded without a race.

bath_tpu builds its library on first use with ``g++ -o`` straight into
``~/.cache/bath_tpu/libbathio.so``.  Test processes that start with an
empty cache (pytest-xdist workers under a fresh HOME) each run that
build into the same file at once, and one that loads the file while
another is still writing it fails.  ``load()`` builds the library once
for all of them instead: under an ``fcntl`` lock, with bath_tpu's own
g++ flags, into a temporary file in ``build/bath_tpu_native/`` that is
renamed into place under a name carrying a hash of the source and the
flags.  It then points bath_tpu at that file (``native._SO``, and
``BATH_NATIVE_SO`` for the subprocesses the tests start, which bath_tpu
loads as it is, never rebuilding it) and loads it.  A failed build
raises at once with the compiler's stderr, and a failed load raises
too: nothing runs bath_tpu's host stages in Python instead.
"""

import fcntl
import hashlib
import os
import subprocess
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, "build", "bath_tpu_native")
# bath_tpu/native/__init__.py _build's flags
FLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-fopenmp",
         "-shared", "-fPIC"]


def library_path(src: str) -> str:
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read() + " ".join(FLAGS).encode())
    return os.path.join(BUILD, f"libbathio-{tag.hexdigest()[:16]}.so")


def build(src: str) -> str:
    """The library built from <src>, once: the first process to take
    the lock builds it, the others wait for it and find it there."""
    so = library_path(src)
    os.makedirs(BUILD, exist_ok=True)
    with open(so + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(so):
            fd, tmp = tempfile.mkstemp(dir=BUILD, suffix=".so.tmp")
            os.close(fd)
            r = subprocess.run(["g++", *FLAGS, "-o", tmp, src],
                               capture_output=True, text=True)
            if r.returncode:
                os.unlink(tmp)
                raise RuntimeError(f"bath_tpu's native library did not "
                                   f"build from {src}:\n{r.stderr}")
            os.replace(tmp, so)
    return so


def load():
    """bath_tpu's native library, loaded in this process from the one
    build, which the subprocesses started after this call load too."""
    from bath_tpu import native as jnat
    so = build(jnat._SRC)
    os.environ["BATH_NATIVE_SO"] = so
    if jnat._LIB is None:
        jnat._SO, jnat._TRIED = so, False
        if jnat.get_lib() is None:
            raise RuntimeError(f"bath_tpu's native library {so} does "
                               "not load")
    return jnat._LIB
