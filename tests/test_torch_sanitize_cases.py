"""The sanitizer tier's CUDA half (``python -m bath_tpu_torch.sanitize
cuda``) on the CPU, where there is no card and no compute-sanitizer.

- The case list covers every kernel entry of ``chip_smoke.py``'s record
  (the twenty entries and the sharded step) and each plan family: one
  width, several widths and several models in one launch, a pack's
  single-model call (``_one_model_plan``), the fs3 pair on the direct
  loads and on the emission ring, the step over two shares, and a
  segmented class of each of the seven entries with a segmented
  instance (``loader.SEG_ENTRIES``): its model's layout walks a row in
  segments (``loader.segmented``), and the entry's plan, built here on
  the CPU as the loader builds it, has a class row of S > 1 segments.
- Each case runs on the CPU through the plain versions.
- The tool's filter names every ``__global__`` kernel of the sources;
  the tool's output is parsed into its error count, the kernels its
  reports name, and its own errors.  Only the tool's answer that it
  cannot attach to the card ("Device not supported") or a missing tool
  makes it unavailable, with nothing reported as checked; a canary the
  tool did not report for any other reason fails the run.  A run under
  the tool that outlasts its limit is killed with its whole session.
"""

import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from bath_tpu_torch import bands, sanitize
from bath_tpu_torch.ops import fs3, fwd, ssv, vit
from bath_tpu_torch.ops import multimodel as mm
from bath_tpu_torch.ops.kernels import loader
from torch_threads import one_torch_thread  # noqa: F401

CASES = sanitize.cuda_cases()
BY_NAME = {c.name: c for c in CASES}
SMS = 132


def test_every_entry_of_the_record_has_a_case():
    covered = {e for c in CASES for e in c.entries}
    assert covered == {name for name, _, _ in chip_smoke.ENTRIES}
    assert set(sanitize.KIND) == covered


def _plan(entry, M):
    """The plan a single-model call of <entry> takes for three ORFs (or
    windows) under the case model of M, built as the loader builds it."""
    lens = np.array([30, 20, 10])
    slot = np.zeros(3, np.int64)
    if entry in ("fs3_parser", "fs3_domdec"):
        p = fs3.fs3_params(sanitize.case_model(M, True)[0])
        return mm.fs3_plan(lens, slot, mm.OneModel(p),
                           2 if entry == "fs3_domdec" else 1)
    om = sanitize.case_model(M)[0]
    if entry == "fwd_parser":
        return mm.fwd_plan(lens, slot, mm.OneModel(fwd.fwd_params(om),
                                                   loader.fwd_layout), SMS)
    if entry == "domdec":
        return mm.domdec_plan(lens, slot, mm.OneModel(fwd.fwd_params(om),
                                                      loader.layout), SMS)
    if entry == "msv_filter":
        return mm.msv_plan(lens, slot, ssv.msv_params(om).as_pack(), SMS)
    if entry == "ssv_capture":
        return mm.ssv_plan(ssv.msv_params(om).as_pack())
    return mm.vit_plan(lens, slot, vit.vit_params(om).as_pack(), SMS)


LAYOUT = {"fwd_parser": loader.fwd_layout, "domdec": loader.layout,
          "fs3_parser": loader.fs3_layout, "fs3_domdec": loader.fs3_layout,
          "msv_filter": loader.msv_layout, "ssv_capture": loader.msv_layout,
          "vit_filter": loader.vit_layout}


@pytest.mark.parametrize("entry", loader.SEG_ENTRIES)
def test_a_segmented_class_of_each_segmented_entry(entry):
    cases = [c for c in CASES if entry in c.segmented
             and entry in c.entries]
    assert cases, entry
    M = max(cases[0].Ms)
    P, W, Mp = LAYOUT[entry](M)
    assert W == loader.SEG_WARPS and loader.segments(P, W, Mp) > 1
    assert (P, W, Mp) == loader.segmented(M, {
        "vit_filter": loader.VIT_SEG_LANES, "fs3_parser":
        loader.FS3_SEG_LANES, "fs3_domdec": loader.FS3_SEG_LANES}.get(
            entry, loader.SEG_LANES))
    # just past the former ceiling of a block's warps
    assert M <= 1.06 * {"vit_filter": 8704, "fs3_parser": 13312,
                        "fs3_domdec": 13312}.get(entry, 33792)
    plan = _plan(entry, M)
    rows = plan.table[:mm.PLAN_CLS * plan.ncls].reshape(-1, mm.PLAN_CLS)
    assert (rows[:, 8] > 1).any() and plan.scratch


def test_segmented_multi_model_cases():
    seg = {e for c in CASES for e in c.segmented if e.endswith("_multi")}
    assert seg == {"fwd_parser_multi", "domdec_multi", "fs3_parser_multi",
                   "fs3_domdec_multi", "msv_filter_multi",
                   "vit_filter_multi"}


def test_the_plan_families():
    plans = " ".join(c.plan for c in CASES)
    for family in ("single_plan", "_one_model_plan", "several models and "
                   "widths in one launch", "direct loads", "the ring",
                   "two shares", "segmented class"):
        assert family in plans, family
    # the fs3 pair: direct below FS3_DIRECT_P lanes, the ring above
    assert loader.fs3_layout(max(BY_NAME["fs3/direct"].Ms))[0] \
        <= mm.FS3_DIRECT_P
    assert loader.fs3_layout(max(BY_NAME["fs3/ring"].Ms))[0] \
        > mm.FS3_DIRECT_P
    widths = {loader.layout(M)[2] for M in BY_NAME["multi/f32 widths"].Ms}
    assert len(widths) == len(BY_NAME["multi/f32 widths"].Ms)


def test_the_microbenchmark_cases_reach_every_instance():
    """The tensor-core entry at n = 65 and 257 (KT = 5 and 17) over two
    splits or more, so ``ub_onehot_sum_kernel`` runs; the gather's
    instance of 16 threads a column with its 17th group, a last warp of
    one column, a last chunk shorter than its ring's and indices
    outside [0, n) in its stream; #10 at a ragged width."""
    from bath_tpu_torch import ubench as ub
    kts = {ub.onehot_kt(n) for n in (65, 257)}
    assert kts == {5, 17}
    assert loader.ub_onehot_splits(sanitize.UB_MMA_BT, sanitize.UB_REPS,
                                   SMS) >= 2
    assert sanitize.UB_MMA_BT % ub.WG_TILE
    for n in (65, 257):
        assert f"ubench/mma n={n} splits" in BY_NAME
    warps, _ = ub.gather_plan(ub.MT, 257, sanitize.UB_GATHER_BT, SMS)
    assert warps > 0 and ub.gather_groups(ub.MT) == (17, 16, 2)
    assert sanitize.UB_GATHER_BT % 2 == 1
    assert sanitize.UB_REPS % ub.GATHER_CHUNK
    got = BY_NAME["ubench/gather out of range"].run("cpu")
    assert got["ub_onehot_gather"][0].shape == (ub.MT, sanitize.UB_GATHER_BT)
    t, idx = ub.inputs("onehot", ub.MT, sanitize.UB_GATHER_BT,
                       sanitize.UB_REPS, n=257, seed=3)
    idx = ub.out_of_range(idx, 257)
    assert (idx == -1).any() and (idx == 257).any()
    assert sanitize.UB_SCALARS_BT % 32
    assert all(c.reps == sanitize.UB_REPS for c in CASES
               if c.name.startswith("ubench/"))


def test_the_rescore_cases_reach_each_plan():
    """The envelope fills: one launch of the shared-memory instance, a
    batch the byte budget cuts into three launches, and a model whose
    working vectors lie in global memory."""
    from bath_tpu_torch.ops import rescore as rr
    lens = [sanitize.RESCORE_SPLIT[1]] * 5
    assert len(rr.batch_plan(lens, sanitize.RESCORE_SPLIT[0],
                             sanitize.rescore_split_budget())) == 3
    assert len(rr.batch_plan(sanitize.RESCORE_LENS, 100)) == 1
    assert rr._scratch_floats(100) == 0
    assert rr._scratch_floats(sanitize.RESCORE_GLOBAL_M) > 0
    assert "rescore_kernel" in sanitize.kernel_names()


@pytest.mark.parametrize("name", list(BY_NAME))
def test_case_runs_through_the_plain_versions(name):
    errs = sanitize.run_case(BY_NAME[name], "cpu")
    assert set(errs) == set(BY_NAME[name].entries)
    assert all(e == 0.0 for e in errs.values()), errs


def test_a_mismatch_is_reported():
    got = torch.tensor([1.0, 2.0])
    with pytest.raises(sanitize.CaseMismatch):
        sanitize.hold("fwd_parser", got, got + 2 * bands.FWD_TOL)
    with pytest.raises(sanitize.CaseMismatch):
        sanitize.hold("msv_filter", (got.int(),), (got.int() + 1,))
    assert sanitize.hold("fwd_parser", got, got + bands.FWD_TOL / 2) > 0


def test_the_filter_names_every_kernel():
    names = sanitize.kernel_names()
    text = " ".join(p.read_text() for p in loader.sources())
    assert len(names) >= text.count("__global__")
    for n in ("fwd_parser_seg_kernel", "domdec_seg_kernel", "vit_filter_kernel",
              "ssv_capture_kernel", "fs3_domdec_wide_kernel",
              "canary_write_past_kernel", "ub_onehot_mma_kernel"):
        assert n in names
    cmd = sanitize.tool_command("memcheck")
    assert cmd[1:5] == ["--tool", "memcheck", "--error-exitcode",
                        str(sanitize.ERROR_EXIT)]
    assert [cmd[i + 1] for i, a in enumerate(cmd) if a == "--kernel-name"] \
        == [f"kns={n}" for n in names]


UNSUPPORTED = """========= COMPUTE-SANITIZER
========= Error: Device not supported. Please refer to the "Supported \
Devices" section of the sanitizer documentation
=========
canary returned -1
========= ERROR SUMMARY: 1 error
"""
CAUGHT = """========= COMPUTE-SANITIZER
========= Invalid __global__ write of size 4 bytes
=========     at void (anonymous namespace)::canary_write_past_kernel<1>(int *, \
int)+0x70 in canary.cu:23
=========     by thread (103,0,0) in block (7,0,0)
canary returned 719
========= ERROR SUMMARY: 1 error
"""
RACES = """========= Error: Race reported between Write access at \
vit_filter_kernel<(int)17, (bool)0, (bool)0, (bool)0>+0x10
========= RACECHECK SUMMARY: 3 hazards displayed (1 error, 2 warnings)
"""


def test_the_tools_output_is_parsed():
    got = sanitize.parse_tool(UNSUPPORTED)
    assert got["errors"] == 1 and got["tool_errors"][0].startswith(
        "Device not supported")
    got = sanitize.parse_tool(CAUGHT)
    assert got == {"errors": 1, "summary": "ERROR SUMMARY: 1 error",
                   "tool_errors": [],
                   "kernels_named": ["canary_write_past_kernel"]}
    got = sanitize.parse_tool(RACES)
    assert got["errors"] == 3 and got["kernels_named"] == [
        "vit_filter_kernel"]


def test_no_tool_checks_nothing(monkeypatch):
    monkeypatch.setattr(sanitize, "sanitizer", lambda: None)
    r = sanitize.run_tool("memcheck")
    assert r["available"] is False and r["checked"] is False
    assert "not found" in r["error"]


NOT_TERMINATED = """========= COMPUTE-SANITIZER
========= Error: process didn't terminate successfully
========= Target application returned an error
========= ERROR SUMMARY: 1 error
"""


@pytest.mark.parametrize("text, available", [
    (UNSUPPORTED, False), (UNSUPPORTED + NOT_TERMINATED, False),
    (NOT_TERMINATED, True), ("canary returned 0\n========= ERROR SUMMARY: "
                             "0 errors\n", True)])
def test_only_a_tool_that_cannot_attach_is_unavailable(monkeypatch, text,
                                                        available):
    """A canary run the tool did not report: unavailable (nothing
    checked, nothing failed) only where the tool answered that it cannot
    attach; any other miss is a fault, with no clean result."""
    monkeypatch.setattr(sanitize, "sanitizer", lambda: "compute-sanitizer")
    monkeypatch.setattr(sanitize, "canary_library", lambda: "canary.so")
    calls = []

    def under(cmd, env=None, limit_s=None):
        calls.append(cmd)
        return 1, text, 0.5
    monkeypatch.setattr(sanitize, "_under", under)
    r = sanitize.run_tool("memcheck")
    assert len(calls) == 1 and not r["canary_caught"] and not r["checked"]
    assert r["available"] is available
    assert not r.get("clean")
    if available:
        assert r["error"].startswith("the memcheck canary was not reported")
    else:
        assert r["error"].startswith("Device not supported")


def test_a_child_past_its_limit_is_killed_with_its_session(tmp_path):
    """A run under a tool that outlasts its limit: the tool and the
    program it started are killed, the code is None and the output says
    so (what fails the step rather than the whole run's time limit)."""
    pid_file = tmp_path / "grandchild.pid"
    code = ("import subprocess, sys, time; p = subprocess.Popen([sys.executable,"
            " '-c', 'import time; time.sleep(60)']); open(sys.argv[1], 'w')"
            ".write(str(p.pid)); print('started', flush=True); time.sleep(60)")
    t = time.perf_counter()
    rc, text, sec = sanitize._under([sys.executable, "-c", code,
                                     str(pid_file)], limit_s=3)
    assert rc is None and "timed out after 3 s" in text and "started" in text
    assert time.perf_counter() - t < 30 and sec < 30
    stat = Path(f"/proc/{int(pid_file.read_text())}/stat")
    for _ in range(100):
        try:
            if stat.read_text().rsplit(")", 1)[1].split()[0] == "Z":
                break
        except (FileNotFoundError, ProcessLookupError):
            break
        time.sleep(0.05)
    else:
        raise AssertionError("the program under the tool still runs")
