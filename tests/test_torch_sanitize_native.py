"""The sanitizer tier's native half (``python -m bath_tpu_torch.sanitize
native``): the port's native host library built with ASAN+UBSAN,
fail-fast, and loaded through ``BATH_TORCH_NATIVE_SO``.

- The canary (the library's reverse complement into an output one
  element too short) aborts with an AddressSanitizer report.
- The sanitized child mapped the sanitized library and no other.
- Standard, ``--fs``, ``--splice``, a two-model query file and ``--cpu
  2`` (``--backend numpy --device cpu``, small seeded fixtures) exit 0
  under the sanitizers and print the bytes of the same searches without
  them; the ``--cpu`` workers mapped the sanitized library too.
- With the override set, a library that does not load raises, in this
  process as in a child: nothing falls through to the Python path.
"""

import os
import subprocess
import sys

import pytest

from bath_tpu_torch import sanitize
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tier(tmp_path_factory, one_torch_thread):  # noqa: F811
    return sanitize.native_check(tmp_path_factory.mktemp("sanitize"),
                                 tmp_path_factory.mktemp("fixtures"))


def test_the_canary_aborts_with_an_address_sanitizer_report(tier):
    canary = tier["canary"]
    assert canary["rc"] != 0, canary
    assert canary["reported"], canary


def test_the_child_loaded_the_sanitized_library(tier):
    asan = tier["children"]["asan"]
    assert asan["override"] == tier["library"]
    assert asan["mapped"] == [tier["library"]], asan
    assert "_asan_" in os.path.basename(tier["library"])
    plain = tier["children"]["plain"]
    assert plain["mapped"] and plain["mapped"] != asan["mapped"]


@pytest.mark.parametrize("mode", list(sanitize.NATIVE_SEARCHES))
def test_search_runs_clean_and_identical_under_the_sanitizers(tier, mode):
    s = tier["searches"][mode]
    assert tier["children"]["asan"]["rc"] == 0, \
        tier["children"]["asan"]["stderr"]
    assert (s["rc"], s["rc_plain"]) == (0, 0), s
    assert s["identical"], s
    if mode == "cpu":
        assert s["worker_native"] == [tier["library"]], s
    assert not sanitize.native_clean(tier)


def test_a_library_that_does_not_load_raises(tmp_path):
    bad = tmp_path / "not_a_library.so"
    bad.write_text("no ELF here")
    code = ("from bath_tpu_torch import native\n"
            "for path in (%r, %r):\n"
            "    import os; os.environ['BATH_TORCH_NATIVE_SO'] = path\n"
            "    for _ in range(2):\n"
            "        try:\n"
            "            native.get_lib()\n"
            "        except OSError as e:\n"
            "            print('RAISED', type(e).__name__)\n"
            "        else:\n"
            "            print('LOADED')\n"
            "print('AVAILABLE' if native.available() else 'NONE')\n"
            % (str(bad), str(tmp_path / "missing.so")))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 1, r.stdout + r.stderr
    assert r.stdout.split("\n")[:4] == ["RAISED OSError"] * 4, r.stdout
    assert "OSError" in r.stderr
