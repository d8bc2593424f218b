"""The readers of the program's own spans and counters on a synthetic
run whose numbers are known, and on a run of a program that has none
of them (every reader gives None and raises nothing)."""

import pytest

from perfbench import harness
from perfbench.recorder import Job
from perfbench.tests.conftest import REPO

SPANS = {"window_host_s_per_mb": "cli.windows",
         "orf_host_s_per_mb": "cli.orfs",
         "output_host_s_per_mb": "cli.output",
         "gates_native_s_per_mb": "gates.native",
         "rescore_dp_s_per_mb": "rescore.dp"}
COUNTERS = ("stage_host_s_per_mb", "decoding_pad_share")


def job(stats):
    j = Job()
    j.stats = stats
    return j


def synthetic():
    run = harness.Run()
    run.mb = 4.0
    run.phase = {"cli.windows": 0.2, "cli.orfs": 0.4, "cli.output": 0.6,
                 "gates.native": 1.0, "rescore.dp": 2.0,
                 "envelope-std": 3.0}
    run.jobs = [job({"fwd_s": 0.5, "fwd_dev_s": 0.1, "domdec_s": 1.0,
                     "domdec_dev_s": 0.4, "msv_s": 0.0,
                     "domdec_cells": 300, "domdec_padded_cells": 400}),
                job({"fwd_s": 0.3, "fwd_dev_s": 0.1, "domdec_s": 0.2,
                     "domdec_dev_s": 0.1,
                     "domdec_cells": 100, "domdec_padded_cells": 400})]
    return run


@pytest.mark.parametrize("metric,want", [
    ("window_host_s_per_mb", 0.05), ("orf_host_s_per_mb", 0.1),
    ("output_host_s_per_mb", 0.15), ("gates_native_s_per_mb", 0.25),
    ("rescore_dp_s_per_mb", 0.5),
    # (0.4 + 0.6) + (0.2 + 0.1) host seconds over 4 Mb
    ("stage_host_s_per_mb", 1.3 / 4.0),
    # 1 - 400 / 800
    ("decoding_pad_share", 0.5)])
def test_reader_on_synthetic_run(metric, want):
    assert harness.reader(REPO, metric)(synthetic()) == pytest.approx(want)


@pytest.mark.parametrize("metric", [*SPANS, *COUNTERS])
def test_reader_without_the_programs_spans(metric):
    """A program without the spans and counters (the parent of the
    change that added them): the reader gives None."""
    run = harness.Run()
    run.mb = 4.0
    run.phase = {"envelope-std": 3.0}
    run.jobs = [job({"fwd_s": 0.5, "domdec_s": 1.0, "domdec_items": 3})]
    assert harness.reader(REPO, metric)(run) is None


@pytest.mark.parametrize("metric", list(SPANS))
def test_span_reader_reads_its_own_span(metric):
    run = harness.Run()
    run.mb = 2.0
    run.phase = {SPANS[metric]: 1.0}
    assert harness.reader(REPO, metric)(run) == pytest.approx(0.5)
