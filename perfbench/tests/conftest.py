"""Fixtures of the benchmark's CPU tests: a copy of the benchmark in a
temporary checkout root with tiny cells added as new files, which the
program runs with its plain PyTorch versions (``--device cpu``): one of
the committed configuration, one of a two-profile library
(``tests/data/lib2.*``) that drives the multi-query path, and one of a
frameshift profile (``tests/data/fs84.*``) searched with ``--fs``."""

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
TINY = {"single400.tiny": ("single400", {"genome_nt": 60000,
                                         "copies": [[0, 2]], "doubles": 0}),
        "lib2.tiny": ("lib2", {"genome_nt": 40000,
                               "copies": [[0, 1], [1, 1]], "doubles": 0}),
        "fs84.tiny": ("fs84", {"genome_nt": 60000, "copies": [[0, 4]],
                               "doubles": 0, "frameshifts": 2})}
# the frameshift cell: --fs, its numbers and their samples (standard
# decoding does not run under --fs)
FS_CELL = {"args": ["--fs"],
           "sample": {"fwd": 6, "fs3": 6, "fs3_domdec": 3},
           "limits": {"fwd_gap_nats": 0.003, "orf_misses": 0,
                      "hits_off": 0, "fs3_gap_nats": 0.003,
                      "fs3_domdec_gap": 0.001, "shift_misses": 0}}


def _add_config(root: Path, name: str, Ms: list) -> None:
    """A configuration of the profiles ``tests/data/<name>.*``, as new
    files of <root>."""
    cfg = json.loads((root / "perfbench" / "configs" / "single400.json")
                     .read_text())
    cfg.update(name=name, models=len(Ms), M=Ms,
               profiles=f"perfbench/profiles/{name}.bhmm.xz",
               proteins=f"perfbench/profiles/{name}.proteins.json")
    for f in (f"{name}.bhmm.xz", f"{name}.proteins.json"):
        shutil.copy(DATA / f, root / "perfbench" / "profiles" / f)
    (root / "perfbench" / "configs" / f"{name}.json").write_text(
        json.dumps(cfg))


def make_root(dst: Path) -> Path:
    """<dst> holding BENCHMARK.json and perfbench/ with the tiny cells
    added as new files (and entries of BENCHMARK.json)."""
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(REPO / "perfbench", dst / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    for name, Ms in (("lib2", [84, 181]), ("fs84", [84])):
        _add_config(dst, name, Ms)
        bench["configs"].append({"name": name, "source": "a CPU test",
                                 "file": f"perfbench/configs/{name}.json",
                                 "reduced": [], "why": "a CPU test"})
    cell = json.loads((dst / "perfbench" / "workloads"
                       / "single400.std_dense.json").read_text())
    for name, (config, traffic) in TINY.items():
        tiny = dict(cell, config=config, traffic_name="tiny",
                    traffic=dict(cell["traffic"], **traffic),
                    warmup_nt=20000, sample={"fwd": 6, "domdec": 3})
        if config == "fs84":
            tiny.update(FS_CELL)
        (dst / "perfbench" / "workloads" / f"{name}.json").write_text(
            json.dumps(tiny))
        bench["workloads"].append(
            {"name": name, "config": config, "traffic": "tiny",
             "chips": 1, "why": "a CPU test"})
    for m in bench["per_layer"]:
        m["workloads"] = m["workloads"] + list(TINY)
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_root(tmp_path_factory.mktemp("checkout"))


@pytest.fixture()
def card():
    """Skips a test that needs an NVIDIA GPU where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the benchmark's card)")
