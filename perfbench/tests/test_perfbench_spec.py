"""BENCHMARK.json's shape (keys, names, units, bounds), and every cell,
configuration and metric found by its name."""

import hashlib
import json
import lzma
import re

import pytest

from perfbench import check, harness, recorder
from perfbench.reference import hmmfile
from perfbench.tests.conftest import REPO, make_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_benchmark_json_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["perfbench"] and 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert {m["name"] for m in b["end_to_end"]} == {"setup_s",
                                                     "search_mb_per_s"}
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] == "search_mb_per_s"
        assert set(m["workloads"]) <= {w["name"] for w in b["workloads"]}


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_files_found_by_name(cell):
    spec = harness.Spec(REPO, cell)
    assert spec.cell["config"] == spec.entry["config"]
    assert spec.cell["traffic_name"] == spec.entry["traffic"]
    numbers = check.load(REPO, spec.cell["limits"])
    assert set(numbers) == set(spec.cell["limits"])
    assert all(callable(n.value) for n in numbers.values())
    text = lzma.decompress((REPO / spec.config["profiles"]).read_bytes())
    hmms = hmmfile.read_text(text.decode())
    prot = json.loads((REPO / spec.config["proteins"]).read_text())
    assert [h.name for h in hmms] == list(prot["proteins"])
    assert [h.M for h in hmms] == [len(p) for p in
                                   prot["proteins"].values()]
    assert len(hmms) == spec.config["models"]


@pytest.mark.parametrize("metric", [m["name"] for k in ("end_to_end",
                                                        "per_layer")
                                    for m in bench()[k]])
def test_metric_reader_found_by_name(metric):
    assert callable(harness.reader(REPO, metric))


def test_check_numbers_found_by_name():
    """A file for each number, each declaring the stages whose items it
    reads; the gaps have a control."""
    names = sorted(p.stem for p in (REPO / "perfbench" / "checks")
                   .glob("*.py"))
    assert names == ["domdec_gap", "fs3_domdec_gap", "fs3_gap_nats",
                     "fwd_gap_nats", "hits_off", "orf_misses",
                     "shift_misses"]
    kept = set(recorder.SCORES + recorder.DECODINGS)
    for name, mod in check.load(REPO, names).items():
        assert set(mod.ITEMS) <= kept, name
        assert hasattr(mod, "control") == ("gap" in name), name


def digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "perfbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_and_metric_need_no_edit(tmp_path):
    root = make_root(tmp_path)
    before = digest(root)
    (root / "perfbench" / "metrics" / "jobs_in_window.py").write_text(
        "def read(run):\n    return float(len(run.jobs))\n")
    cell = json.loads((root / "perfbench" / "workloads"
                       / "single400.std_dense.json").read_text())
    cell["traffic"]["copies"] = [[0, 8]]
    (root / "perfbench" / "checks" / "jobs_seen.py").write_text(
        "ITEMS = ()\n\n\ndef value(ctx):\n    return len(ctx.jobs)\n")
    cell["limits"]["jobs_seen"] = 3
    (root / "perfbench" / "workloads" / "single400.sparse.json") \
        .write_text(json.dumps(cell))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "single400.sparse", "config":
                           "single400", "traffic": "sparse", "chips": 1,
                           "why": "few copies"})
    b["per_layer"].append({"name": "jobs_in_window", "unit": "jobs",
                           "better": "higher", "source": "host_clock",
                           "layer": "cli", "moves": "search_mb_per_s",
                           "workloads": ["single400.sparse"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    spec = harness.Spec(root, "single400.sparse")
    assert spec.cell["traffic"]["copies"] == [[0, 8]]
    assert [m["name"] for m in spec.metrics(True)][-1] == "jobs_in_window"
    run = harness.Run()
    run.jobs = [object(), object()]
    assert harness.reader(root, "jobs_in_window")(run) == 2.0
    numbers = check.load(root, spec.cell["limits"])
    assert list(numbers)[-1] == "jobs_seen"
    ctx = check.Context([object(), object()], None, spec.cell, 1, "cpu",
                        20, [])
    assert check.check({"jobs_seen": numbers["jobs_seen"]}, ctx) == \
        {"jobs_seen": 2}
    assert harness.kept_stages(spec, numbers) == {"fwd_scores", "domdec"}
    after = digest(root)
    assert {k: v for k, v in after.items() if k in before} == before
