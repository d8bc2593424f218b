"""``bath_tpu_torch.phasestats``, the port's span recorder, and the
device stages' counters (``device_pipeline.StageTally``), on the CPU.

- Off (no ``BATH_PHASE_STATS``): ``phase`` and ``each`` record nothing,
  every function of the wrapper table is the original object, and a
  stage's launch on a card would create no CUDA event.
- On, in a subprocess with ``BATH_PHASE_STATS=1``: one single-query
  ``bathsearch --backend torch --device cpu`` job on a fixture under
  ``torch.profiler`` (CPU activity) records every span, the native
  spans lie inside their flushes, the trace holds a ``user_annotation``
  for each span, and ``-o`` and ``--tblout`` equal those of the same job
  with tracing off.
- ``TorchCascade``'s cells are the items' residues x M, and
  ``PackedGates`` counts the same items alike.
"""

import json
import os
import re
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from bath_tpu_torch import fixtures
from bath_tpu_torch.cli import bathsearch
from bath_tpu_torch.device_pipeline import TorchCascade
from bath_tpu_torch.gencode import GeneticCode
from bath_tpu_torch.multiquery import PackedGates, QState
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# every span a standard single-query job on the fixture records
SPANS = ["cli.windows", "cli.orfs", "cli.output", "flush.gates",
         "flush.downstream", "gates.native", "rescore.dp", "stage.fwd_scores",
         "stage.domdec", "envelope-std", "stage.rescore"]

# a stage's launch on a card, with CUDA events that count themselves
FAKE_CARD = '''
import torch
from bath_tpu_torch.device_pipeline import StageTally
from bath_tpu_torch.ops.kernels.loader import Launch
made = []

class Event:
    def __init__(self, enable_timing=False):
        made.append(self)
    def record(self, stream=None):
        pass
    def elapsed_time(self, end):
        return 2.0

torch.cuda.Event = Event
torch.cuda.current_stream = lambda dev=None: None
stats = {}
tally = StageTally(stats, "fwd")
# a batch's launch call: a check, then the bare launch
out = tally.launch(torch.device("cuda"), 12,
                   lambda x: Launch(lambda y: y + 1, 1)(x), 1)
tally.close(1, 10)
timing_left = Launch.timing
'''

OFF = FAKE_CARD + '''
from bath_tpu_torch import native, phasestats
from bath_tpu_torch.device_pipeline import TorchCascade
from bath_tpu_torch.multiquery import PackedGates
report = {"on": phasestats.on(), "events": len(made), "launched": out,
          "tally": sorted(stats), "timing_left": timing_left}
report["shared"] = phasestats.phase("a") is phasestats.phase("b")
items = [1, 2]
report["each_is_iterable"] = phasestats.each("x", items) is items
with phasestats.phase("x"):
    list(phasestats.each("y", items))
report["totals"] = phasestats.totals()
fn = lambda: 0
report["spanned_is_fn"] = phasestats.spanned("z")(fn) is fn
report["wrapped"] = [f for _, mod, f in phasestats.WRAPPED
                     if hasattr(getattr(native, f), "__wrapped__")
                     or getattr(native, f).__code__.co_filename
                     != native.__file__]
report["stages"] = [n for cls in (TorchCascade, PackedGates)
                    for n in ("fwd_scores", "domdec")
                    if hasattr(getattr(cls, n), "__wrapped__")]
'''

ON = FAKE_CARD + '''
from bath_tpu_torch import native, phasestats
report = {"on": phasestats.on(), "events": len(made),
          "dev_s": stats.get("fwd_dev_s"), "timing_left": timing_left}
report["wrapped"] = [f for _, mod, f in phasestats.WRAPPED
                     if getattr(native, f).__wrapped__.__code__.co_filename
                     == native.__file__]
phasestats.reset()
with phasestats.phase("nest"):
    with phasestats.phase("nest"):
        pass
assert list(phasestats.each("each", [1, 2, 3])) == [1, 2, 3]
report["nest"] = phasestats.totals()["nest"][0]
report["each"] = phasestats.totals()["each"][0]
phasestats.reset()
'''

JOB = '''
import json, sys
import torch
from bath_tpu_torch.cli import bathsearch
d, hmm, fasta = sys.argv[1:4]
stats = {}
prof = torch.profiler.profile(
    activities=[torch.profiler.ProfilerActivity.CPU])
with prof:
    rc = bathsearch.run(["--device", "cpu", "-o", d + "/out", "--tblout",
                         d + "/tbl", hmm, fasta], stats=stats)
prof.export_chrome_trace(d + "/trace.json")
with open(d + "/trace.json") as f:
    events = json.load(f)["traceEvents"]
report["rc"] = rc
report["annotations"] = sorted({e["name"] for e in events
                                if e.get("cat") == "user_annotation"})
report["totals"] = phasestats.totals()
report["stats"] = {k: v for k, v in stats.items() if k != "mq_stages"}
'''


def run_script(body, tracing, *argv):
    env = dict(os.environ, BATH_MSV_DEVICE="0", BATH_VIT_DEVICE="0",
               OMP_NUM_THREADS="1")
    env.pop("BATH_PHASE_STATS", None)
    if tracing:
        env["BATH_PHASE_STATS"] = "1"
    r = subprocess.run(
        [sys.executable, "-c",
         body + "\nprint('REPORT', json.dumps(report, default=str))\n",
         *map(str, argv)],
        capture_output=True, text=True, timeout=600, cwd=ROOT, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("REPORT ")]
    return json.loads(line[-1][len("REPORT "):]), r.stderr


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    return fixtures.write_fixture(60, 40_000, 2, 3,
                                  directory=tmp_path_factory.mktemp("fx"))


def job(fx, tmp_path_factory, tracing):
    d = tmp_path_factory.mktemp("on" if tracing else "off")
    body = (ON if tracing else OFF) + JOB.replace("import json, sys", "")
    report, err = run_script("import json, sys\n" + body, tracing, d,
                             fx.hmm_path, fx.fasta_path)
    # the table's tail names the job's own directory and the date
    report["out"] = re.sub(r"# (CPU time|Mc/sec):.*", "",
                           (d / "out").read_text())
    report["tbl"] = re.sub(r"# Date:.*", "", (d / "tbl").read_text()
                           ).replace(str(d), "<d>")
    report["stderr"] = err
    return report


@pytest.fixture(scope="module")
def off(fx, tmp_path_factory):
    return job(fx, tmp_path_factory, False)


@pytest.fixture(scope="module")
def on(fx, tmp_path_factory):
    return job(fx, tmp_path_factory, True)


# ---------------------------------------------------------------------
# Off
# ---------------------------------------------------------------------
def test_off_records_nothing(off):
    assert off["on"] is False and off["rc"] == 0
    assert off["shared"] and off["each_is_iterable"]
    assert off["spanned_is_fn"]
    assert off["totals"] == {}
    assert "# phase-stats" not in off["stderr"]


def test_off_installs_no_wrapper(off):
    assert off["wrapped"] == [] and off["stages"] == []


def test_off_creates_no_cuda_event(off):
    """A launch on a card with tracing off: no CUDA event, no
    ``_dev_s``; the counters that are always on are there."""
    assert off["events"] == 0 and off["launched"] == 2
    assert off["timing_left"] is None
    assert off["tally"] == ["fwd_batches", "fwd_cells", "fwd_items",
                            "fwd_padded_cells", "fwd_s"]


def test_off_job_records_no_span(off):
    assert off["totals"] == {} and off["annotations"] == []


# ---------------------------------------------------------------------
# On
# ---------------------------------------------------------------------
def test_on_installs_the_wrapper_table(on):
    from bath_tpu_torch import phasestats
    assert on["on"] is True
    assert sorted(on["wrapped"]) == sorted(f for _, _, f
                                           in phasestats.WRAPPED)


def test_on_times_each_launch_with_cuda_events(on):
    """One pair of events round the bare launch, 2 ms apart."""
    assert on["events"] == 2 and on["dev_s"] == pytest.approx(0.002)
    assert on["timing_left"] is None


def test_on_counts_a_nested_span_once(on):
    assert on["nest"] == 1 and on["each"] == 4


@pytest.mark.parametrize("span", SPANS)
def test_on_job_records_span(on, span):
    assert on["rc"] == 0
    calls, seconds = on["totals"][span]
    assert calls > 0 and seconds >= 0


@pytest.mark.parametrize("span", SPANS)
def test_on_trace_holds_span_annotation(on, span):
    assert span in on["annotations"]


def test_on_native_spans_lie_inside_the_flushes(on):
    t = {k: v[1] for k, v in on["totals"].items()}
    assert 0 < t["gates.native"] <= t["flush.gates"]
    # the envelopes' native fills run in the envelope spans or, on the
    # device cascade, in its rescore stage, whose plain version on the
    # CPU is the host fills themselves
    assert 0 < t["rescore.dp"] <= t["envelope-std"] + t["stage.rescore"]
    assert t["envelope-std"] + t["stage.rescore"] <= t["flush.downstream"]
    assert t["stage.fwd_scores"] + t["stage.domdec"] + t["stage.rescore"] \
        <= t["flush.downstream"]


def test_on_outputs_equal_off(on, off):
    assert on["out"] == off["out"] and "[ok]" in on["out"]
    assert on["tbl"] == off["tbl"] and on["tbl"].count("\n") > 3


def test_on_exit_report(on):
    lines = [ln for ln in on["stderr"].splitlines()
             if ln.startswith("# phase-stats ")]
    assert {ln.split()[2].rstrip(":") for ln in lines} >= set(SPANS)


def test_on_job_stage_counters(on, off):
    """The same counters with tracing on and off, and no ``_dev_s`` on
    the CPU."""
    keys = ("fwd_cells", "fwd_padded_cells", "fwd_batches", "domdec_cells",
            "domdec_padded_cells", "domdec_batches")
    assert all(on["stats"][k] == off["stats"][k] > 0 for k in keys)
    assert not any(k.endswith("_dev_s") for k in on["stats"])


# ---------------------------------------------------------------------
# The stages' counters
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def items():
    rng = np.random.default_rng(7)
    hmm, q = fixtures.make_query(40, rng, calibrate=False)
    dsq, lens = fixtures.kernel_batch(q, 9, 70, rng)
    return hmm, [d[:n].copy() for d, n in zip(dsq, lens)]


def test_cascade_cells_are_residues_times_m(items):
    hmm, seqs = items
    stats = {}
    tc = TorchCascade(fixtures.search_profile(hmm), device="cpu",
                      stats=stats)
    lens = np.array([len(s) for s in seqs])
    tc.fwd_scores(seqs, lens)
    tc.domdec([SimpleNamespace(dsq=s, n=len(s)) for s in seqs])
    for key in ("fwd", "domdec"):
        assert stats[f"{key}_cells"] == int(lens.sum()) * hmm.M
        assert stats[f"{key}_padded_cells"] >= stats[f"{key}_cells"]
        assert stats[f"{key}_batches"] >= 1
        assert f"{key}_dev_s" not in stats
    # one batch, padded to the longest item
    assert stats["fwd_padded_cells"] == len(seqs) * int(lens.max()) * hmm.M


def test_packed_gates_count_the_same_cells(items):
    hmm, seqs = items
    args = bathsearch.build_parser().parse_args(["q.bhmm", "t.fa"])
    gcode = GeneticCode.create(1)
    gcode.set_initiator_any()
    qs = QState(hmm, args, gcode, 0)
    packed, cascade = {}, {}
    pg = PackedGates([qs], device="cpu", stats=packed)
    its = [(qs, s, len(s)) for s in seqs]
    pg.fwd_scores(its)
    pg.domdec(its)
    tc = TorchCascade(qs.om, device="cpu", stats=cascade)
    tc.fwd_scores(seqs, np.array([len(s) for s in seqs]))
    tc.domdec([SimpleNamespace(dsq=s, n=len(s)) for s in seqs])
    for k in ("fwd_cells", "domdec_cells", "fwd_padded_cells",
              "domdec_padded_cells", "fwd_batches", "domdec_batches"):
        assert packed[k] == cascade[k] > 0, k
    assert [c for _, _, c, _ in packed["mq_stages"]] == \
        [cascade["fwd_cells"], cascade["domdec_cells"]]
