"""The all-device cascade end to end (``BATH_MSV_DEVICE=1
BATH_VIT_DEVICE=1``): MSV/SSV, the SSV capture, the ViterbiFilter and
its capture run through the port too, on the CPU through the kernels'
plain versions, on the seeded fixtures of test_torch_slice.py, and the
output stays ``bath_tpu --backend numpy``'s byte for byte.  Apart from
test_torch_slice.py because these are its longest searches.
"""

import os
import re
import subprocess
import sys

import pytest

from bath_tpu_torch.cli import bathsearch
from test_torch_slice import LOADED, ROOT, fs_fx, fx, search  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

ALL_DEVICE = {"BATH_MSV_DEVICE": "1", "BATH_VIT_DEVICE": "1"}
# looser F1/F2 than the defaults: on these fixtures some ORFs then take
# the Viterbi path and pass it, so the Viterbi capture runs too
LOOSE = ["--F1", "0.1", "--F2", "0.05"]


def fst_rows(path):
    return "".join(ln for ln in path.read_text().splitlines(True)
                   if not ln.startswith("#"))


@pytest.mark.parametrize("mode", [[], ["--fs"]], ids=["standard", "fs"])
def test_all_device_cascade_byte_identical_to_numpy(fx, fs_fx, tmp_path,
                                                    monkeypatch, mode):
    """BATH_MSV_DEVICE=1 BATH_VIT_DEVICE=1: MSV/SSV, the SSV capture,
    the ViterbiFilter and its capture run through the port too, and the
    output stays the host path's, byte for byte."""
    fixture = fs_fx if mode else fx
    fst_n, fst_t = tmp_path / "numpy.fst", tmp_path / "torch.fst"
    want, _ = search(fixture, tmp_path, "bath_tpu.cli.bathsearch",
                     ["--backend", "numpy", *LOOSE, *mode, "--fstblout",
                      str(fst_n)])
    for k, v in ALL_DEVICE.items():
        monkeypatch.setenv(k, v)
    out = tmp_path / "torch.out"
    stats = {}
    assert bathsearch.run(["--device", "cpu", *LOOSE, *mode, "-o",
                           str(out), "--fstblout", str(fst_t),
                           fixture.hmm_path, fixture.fasta_path],
                          stats=stats) == 0
    assert re.sub(r"# (CPU time|Mc/sec):.*", "", out.read_text()) == want
    assert fst_rows(fst_t) == fst_rows(fst_n)
    for stage in ("msv", "ssvcap", "vit", "vitcap"):
        assert stats[f"{stage}_items"] > 0, stage
    assert stats["msv_items"] > stats["vit_items"] > stats["vitcap_items"]
    assert stats["ssvcap_overflow"] > 0


def test_all_device_search_imports_no_jax(fx, tmp_path):
    code = ("import sys\n"
            "from bath_tpu_torch.cli.bathsearch import run\n"
            "stats = {}\n"
            f"rc = run(['--device', 'cpu', '-o', {str(tmp_path / 'o')!r},"
            f" {fx.hmm_path!r}, {fx.fasta_path!r}], stats=stats)\n"
            f"print(rc, {LOADED}, stats['vit_items'] > 0)\n")
    env = dict(os.environ, **ALL_DEVICE)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=ROOT, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == ["0", "False", "True"]
