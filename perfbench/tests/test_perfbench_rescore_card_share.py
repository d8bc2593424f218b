"""rescore_card_share on synthetic stats: None where the program counts
no envelope (the parent of the change that added the counters), 1.0
with every envelope on the card, and the share of a mixed run."""

import pytest

from perfbench import harness
from perfbench.recorder import Job
from perfbench.tests.conftest import REPO


def run_of(*stats):
    run = harness.Run()
    run.mb = 4.0
    run.jobs = []
    for st in stats:
        j = Job()
        j.stats = st
        run.jobs.append(j)
    return run


def read(run):
    return harness.reader(REPO, "rescore_card_share")(run)


def test_none_without_the_counters():
    assert read(run_of({"fwd_s": 0.5, "domdec_items": 3}, {})) is None
    assert read(run_of({"rescore_items": 0, "rescore_host_items": 0})) \
        is None


def test_every_envelope_on_the_card():
    assert read(run_of({"rescore_items": 41, "rescore_host_items": 0},
                       {"rescore_items": 40, "rescore_host_items": 0})) \
        == 1.0


def test_a_mixed_share():
    # 30 of 40 on the card, across two jobs, one of them host-only
    assert read(run_of({"rescore_items": 30, "rescore_host_items": 2},
                       {"rescore_host_items": 8})) == pytest.approx(0.75)
