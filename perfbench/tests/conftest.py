"""Fixtures of the benchmark's CPU tests: a copy of the benchmark in a
temporary checkout root with tiny cells added as new files, which the
program runs with its plain PyTorch versions (``--device cpu``): one of
the committed configuration, and one of a two-profile library
(``tests/data/lib2.*``) that drives the multi-query path."""

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
TINY = {"single400.tiny": ("single400", {"genome_nt": 60000,
                                         "copies": [[0, 2]], "doubles": 0}),
        "lib2.tiny": ("lib2", {"genome_nt": 40000,
                               "copies": [[0, 1], [1, 1]], "doubles": 0})}


def _lib2_config(root: Path) -> None:
    """The two-profile library's configuration and profiles, as new
    files of <root>."""
    cfg = json.loads((root / "perfbench" / "configs" / "single400.json")
                     .read_text())
    cfg.update(name="lib2", models=2, M=[84, 181],
               profiles="perfbench/profiles/lib2.bhmm.xz",
               proteins="perfbench/profiles/lib2.proteins.json")
    for f in ("lib2.bhmm.xz", "lib2.proteins.json"):
        shutil.copy(DATA / f, root / "perfbench" / "profiles" / f)
    (root / "perfbench" / "configs" / "lib2.json").write_text(
        json.dumps(cfg))


def make_root(dst: Path) -> Path:
    """<dst> holding BENCHMARK.json and perfbench/ with the tiny cells
    added as new files (and entries of BENCHMARK.json)."""
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(REPO / "perfbench", dst / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    _lib2_config(dst)
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "lib2", "source": "a CPU test",
                             "file": "perfbench/configs/lib2.json",
                             "reduced": [], "why": "a CPU test"})
    cell = json.loads((dst / "perfbench" / "workloads"
                       / "single400.std_dense.json").read_text())
    for name, (config, traffic) in TINY.items():
        tiny = dict(cell, config=config, traffic_name="tiny",
                    traffic=dict(cell["traffic"], **traffic),
                    warmup_nt=20000, sample={"fwd": 6, "domdec": 3})
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
