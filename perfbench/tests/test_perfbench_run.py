"""A whole run on the CPU (the program's plain versions), its last
line, and ``correct`` coming out false when the timed path is broken
underneath."""

import json
import subprocess
import sys

import numpy as np
import pytest

from perfbench import harness
from perfbench.tests.conftest import REPO

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run(root, capsys, cell="single400.tiny", trace=False, seed=2**31 + 5):
    rc = harness.run_cell(cell, seed, 0.5, trace, device="cpu", root=root)
    out, err = capsys.readouterr()
    return rc, json.loads(out.strip().splitlines()[-1]), err


def test_last_line_keys(tiny_root, capsys):
    rc, res, err = run(tiny_root, capsys)
    assert rc == 0
    assert list(res)[:5] == KEYS and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s", "search_mb_per_s"}
    assert res["metrics"]["search_mb_per_s"]["unit"] == "Mb/s"
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    limits = res["checks"]
    assert set(limits) == {"fwd_gap_nats", "domdec_gap", "orf_misses",
                           "hits_off"}
    tail = err.strip().splitlines()[-4:]
    assert [ln.split()[1] for ln in tail] == list(limits)


def test_traced_run_keys(tiny_root, capsys):
    rc, res, _ = run(tiny_root, capsys, trace=True)
    assert rc == 0 and res["correct"] is True
    assert {"busy_s", "window_s"} <= set(res["device"])
    # on the CPU nothing runs on a device: the device's metrics stay out
    assert "device_idle_share" not in res["metrics"]
    assert {"cli_self_s_per_mb", "downstream_host_s_per_mb",
            "device_stage_share"} <= set(res["metrics"])


def test_library_cell(tiny_root, capsys):
    rc, res, _ = run(tiny_root, capsys, cell="lib2.tiny")
    assert rc == 0 and res["correct"] is True, res["checks"]


def test_frameshift_cell(tiny_root, capsys):
    """``--fs``: the fs3 gate's and fs3 decoding's items compared, and
    the frameshifted copies found with a shift."""
    rc, res, err = run(tiny_root, capsys, cell="fs84.tiny")
    assert rc == 0 and res["correct"] is True, res["checks"]
    assert list(res["checks"]) == ["fwd_gap_nats", "orf_misses", "hits_off",
                                   "fs3_gap_nats", "fs3_domdec_gap",
                                   "shift_misses"]
    assert res["checks"]["fs3_gap_nats"]["value"] > 0
    assert res["checks"]["fs3_domdec_gap"]["value"] > 0


def test_jax_loaded_after_the_window_prints_no_result(tmp_path, capsys,
                                                     monkeypatch):
    """A metric reader, run after the window, that loads a module named
    ``jax``: the run prints no result and names it."""
    from perfbench.tests.conftest import make_root
    (tmp_path / "checkout").mkdir()
    root = make_root(tmp_path / "checkout")
    stub = tmp_path / "stub" / "jax"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(stub.parent))
    (root / "perfbench" / "metrics" / "jax_probe.py").write_text(
        "import jax\n\n\ndef read(run):\n    return 1.0\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["end_to_end"].append({"name": "jax_probe", "unit": "s",
                            "better": "lower", "bound": 0.25,
                            "source": "host_clock",
                            "workloads": ["single400.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    try:
        rc = harness.run_cell("single400.tiny", 7, 0.5, False,
                              device="cpu", root=root)
        out, err = capsys.readouterr()
    finally:
        sys.modules.pop("jax", None)
    assert rc != 0
    assert not any(ln.startswith("{") and '"correct"' in ln
                   for ln in out.splitlines())
    assert "jax" in err.strip().splitlines()[-1]


def _half_scored(orig):
    def fwd_scores(self, seqs, lens):
        out = np.array(orig(self, seqs, lens))
        half = len(out) // 2
        out[half:] = out[:max(half, 1)].mean()
        return out
    return fwd_scores


def _one_altered(orig):
    def fwd_scores(self, seqs, lens):
        out = np.array(orig(self, seqs, lens))
        out[len(out) // 2] += 0.05
        return out
    return fwd_scores


def _decoding_altered(orig):
    def domdec(self, orfseqs):
        bt, et, mo, ok = orig(self, orfseqs)
        mo = [m.copy() for m in mo]
        for m in mo:
            m[len(m) // 2] *= 0.9
        return bt, et, mo, ok
    return domdec


def _fs3_altered(orig):
    def fs3_scores(self, seqs, lens):
        out = np.array(orig(self, seqs, lens))
        out[len(out) // 2] += 0.05
        return out
    return fs3_scores


def _fs3_decoding_altered(orig):
    def fs3_domdec(self, winseqs, dec_loop):
        bt, et, mo, ok = orig(self, winseqs, dec_loop)
        mo = [m.copy() for m in mo]
        for m in mo:
            m[len(m) // 2] += 0.05
        return bt, et, mo, ok
    return fs3_domdec


@pytest.mark.parametrize("fault,attr,number", [
    ("half of the batch left out, the mean of the rest in its place",
     ("fwd_scores", _half_scored), "fwd_gap_nats"),
    ("one gate score altered where it is produced",
     ("fwd_scores", _one_altered), "fwd_gap_nats"),
    ("one decoding row altered where it is produced",
     ("domdec", _decoding_altered), "domdec_gap"),
    ("one fs3 gate score altered where it is produced",
     ("fs3_scores", _fs3_altered, "fs84.tiny"), "fs3_gap_nats"),
    ("one fs3 decoding row altered where it is produced",
     ("fs3_domdec", _fs3_decoding_altered, "fs84.tiny"), "fs3_domdec_gap")])
def test_fault_makes_run_incorrect(tiny_root, capsys, monkeypatch, fault,
                                   attr, number):
    from bath_tpu_torch.device_pipeline import TorchCascade
    name, make, *cell = attr
    monkeypatch.setattr(TorchCascade, name,
                        make(getattr(TorchCascade, name)))
    rc, res, _ = run(tiny_root, capsys, *cell)
    assert rc == 0 and res["correct"] is False, fault
    c = res["checks"][number]
    assert c["value"] > c["limit"]


def test_reported_hit_altered(tiny_root, capsys, monkeypatch):
    """A hit's coordinates altered where the table is written."""
    from bath_tpu_torch import tophits
    orig = tophits.TopHits.tabular_targets_text

    def shifted(self, *a, **kw):
        text = orig(self, *a, **kw)
        lines = text.splitlines(True)
        for i, ln in enumerate(lines):
            if not ln.startswith("#") and ln.strip():
                c = ln.split()
                for col in (9, 10):
                    ln = ln.replace(f" {c[col]} ", f" {int(c[col]) + 9000} ")
                lines[i] = ln
                break
        return "".join(lines)
    monkeypatch.setattr(tophits.TopHits, "tabular_targets_text", shifted)
    rc, res, _ = run(tiny_root, capsys)
    assert rc == 0 and res["correct"] is False
    assert res["checks"]["hits_off"]["value"] >= 1


def test_shift_lost(tiny_root, capsys, monkeypatch):
    """The frameshifts of the hits read 0 where the table is written:
    the frameshifted copies are covered, but not with a shift."""
    from bath_tpu_torch import tophits
    orig = tophits.TopHits.tabular_targets_text

    def unshifted(self, *a, **kw):
        rows = []
        for ln in orig(self, *a, **kw).splitlines(True):
            if not ln.startswith("#") and ln.strip():
                c = ln.split()
                ln = " ".join(c[:15] + ["0"] + c[16:]) + "\n"
            rows.append(ln)
        return "".join(rows)
    monkeypatch.setattr(tophits.TopHits, "tabular_targets_text", unshifted)
    rc, res, _ = run(tiny_root, capsys, "fs84.tiny")
    assert rc == 0 and res["correct"] is False
    assert res["checks"]["shift_misses"]["value"] == 2
    assert res["checks"]["hits_off"]["value"] == 0


def test_no_card_no_result(tmp_path):
    """Without a card the command exits non-zero and prints nothing on
    its standard output."""
    r = subprocess.run([sys.executable, "-m", "perfbench.run",
                        "--workload", "single400.std_dense", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                            "HOME": str(tmp_path)})
    assert r.returncode != 0 and r.stdout.strip() == ""


@pytest.mark.cuda
def test_runs_on_the_card(tiny_root, capsys, card):
    rc = harness.run_cell("single400.tiny", 11, 1.0, True, root=tiny_root)
    res = json.loads(capsys.readouterr()[0].strip().splitlines()[-1])
    assert rc == 0 and res["correct"] is True
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
