"""Smoke test of bath_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of the standard, the ``--fs``, the all-device
and the multi-query bathsearch paths and of bathbuild's device
calibration from ``bath_tpu_torch/ops/kernels/csrc/``, holds each
against its plain PyTorch version on the card (the integer filters
exactly, and MSV also against the native host library over every ORF of
the search genome; the six multi-model entries also bit for bit against
the single-model entries, on batches that mix 48 models of
M = 60..1200), times both and the host library's batch, then searches a
seeded 5 Mb genome with a seeded M = 400 profile through the port's
CLI: the standard search, then ``--fs`` and ``--fsonly`` on the
genome's frameshift twin (16 of its 40 embeds carry a 1-nt deletion or
insertion), then the all-device cascade (``BATH_MSV_DEVICE=1
BATH_VIT_DEVICE=1``: MSV/SSV, the ViterbiFilter and their window
captures on the card too), standard and ``--fs``, then the multi-query
drive: a 48-model query file against a 5 Mb genome that holds copies of
12 of the models, standard and ``--fs``.  It checks that the output is
byte-identical to the host path (the port's own ``--backend numpy``),
that the embedded homologs and the frameshifts are found, and that each
search went through its kernels.

Then the build path: ``bathbuild`` of a 48-alignment Stockholm file and
``bathconvert`` of the built models stripped of their frameshift
calibration, ``--backend torch`` (all models calibrated in one
device-batched pass through the two integer multi-model entries and the
two f32 gate ones) against ``--backend numpy`` (the serial host
calibration).  Both backends of ``bathconvert`` run in this process, one
after the other; ``bathbuild --backend numpy``, the longest single step
(two to three minutes), runs in a child process beside the parity phases
and has ended before anything is timed, so its own wall, printed with
``wall_numpy_concurrent=True``, carries those phases' load and no other
number in the output carries its.  The files may differ only in their
DATE lines and in the taus the f32 gates simulate; ``bathstat`` and
``bathfetch`` print the same for both, and a ``bathsearch --fs`` with
the built models finds the proteins they were emitted from.

Every phase prints one line; any failure exits non-zero.  The last two
lines are the kernels' JSON record (per kernel: launches on its main
path, error against the plain version, time, the plain version's time,
and the least time the card could take for the timed work) and
``{"ok": true, "device": ...}``.

Needs a CUDA device, nvcc (``$CUDA_HOME`` or ``/usr/local/cuda``) and
g++ (the host library of the integer filters).  Everything it builds or
writes goes under ``build/`` next to this file.  It imports nothing of
``bath_tpu`` and no JAX.
"""

import atexit
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
BUILD = ROOT / "build" / "bath_tpu_torch"

DEVICE = "cuda"
M_SEARCH = 400              # a Pfam-sized profile
GENOME_NT = 5_000_000       # one bacterial genome
N_EMBEDS = 40
MIN_FOUND = 30
SEED = 20261016
PARITY_FWD = (256, 2048)    # (B, longest L) of the parity batches
PARITY_DOMDEC = (32, 2048)
WIDE = (1500, 8, 1600)      # (M, B, L): several warps per ORF
TIME_FWD_B, TIME_DOMDEC_B = 4096, 128
TIME_FWD_M = (400, 1000)
FWD_TOL = 1e-3              # nats, kernel vs plain version
DOMDEC_TOL = 1e-4           # posterior units
MIN_OK_SHARE = 0.95
# --fs: parity batches (B, longest L in nt) at M_SEARCH and FS3_WIDE_M
PARITY_FS3 = (32, 2500)
PARITY_FS3DD = (8, 2500)
FS3_WIDE_M = 1500           # several warps per window
TIME_FS3_M = (134, 409)
TIME_FS3_B, TIME_FS3DD_B = 256, 32
N_FRAMESHIFT = 16
MIN_FS_FOUND = 12
# the integer filters: parity cases (genome ORFs besides the hot, short
# and empty ones) at M_SEARCH, with one ORF of LONG_ORF residues, and at
# INT_WIDE_M; capture thresholds (bytes, words) crossed by the hot ORFs
# only, then P = 1 (every row crosses)
PARITY_INT_N = 512
LONG_ORF = 2_000
INT_WIDE_M = 1500
SSV_THR, VIT_THR, P1_THR = 180, 16_000, -(1 << 30)
TIME_INT_B = 4096           # ORFs of the Viterbi set and the captures
F1, F2 = 0.02, 1e-3         # bathsearch's default filter thresholds
# the all-device cascade also runs with looser F1/F2, so that ORFs take
# the Viterbi path and pass it (the Viterbi capture's input)
LOOSE = ["--F1", "0.1", "--F2", "0.05"]
ALL_DEVICE = {"BATH_MSV_DEVICE": "1", "BATH_VIT_DEVICE": "1"}
# the multi-query drive: 48 models with M spread over 60..1200 (29 of
# them past 511, where the JAX package's packs stop), every fourth one
# with MQ_COPIES copies in the genome
MQ_MS = [60 + (1140 * i) // 47 for i in range(48)]
MQ_EMBEDDED = list(range(1, 48, 4))
MQ_COPIES = 2
# multi-model parity batches with homologs, (items per model, longest
# item), every model's items carrying copies of its own protein: all
# items against the single-model entries, and the items of
# PARITY_MQ_PLAIN (the narrowest model, which also holds the shortest
# items, and one model for each count of warps per item up to the
# widest) against the plain versions, whose Python row loops run once
# per model and take 1-5 ms a row.  The timing batches below hold the
# entries against the plain versions at the drive's shapes.
PARITY_MQ_FWD = (8, 1250)
PARITY_MQ_DOMDEC = (3, 1250)
PARITY_MQ_FS3 = (3, 3700)
PARITY_MQ_FS3DD = (2, 3700)
PARITY_MQ_PLAIN = (0, 11, 29, 47)
PARITY_MQ_PLAIN_FS3DD = (0, 47)
# multi-model timing batches, the shapes of the 5 Mb drive's one flush:
# F3 candidates, F3 survivors and fs3 windows over all 48 models, fs3
# survivors over the 12 embedded ones.  Each entry's output is also
# held against its plain version's: the Forward gate on every item,
# decoding on the items of every second model; the fs3 pair, whose plain
# versions take 7 and 21 s a model over windows of thousands of rows, on
# the items of two models (M = 132, 1200) and of two of the 12 (M = 84
# and 763, one and two warps a window; 3e holds both against them at up
# to three warps a window).
TIME_MQ_FWD_B, TIME_MQ_DOMDEC_B = 1600, 128
TIME_MQ_FS3_B, TIME_MQ_FS3DD_B = 512, 24
TIME_MQ_PLAIN_DOMDEC = tuple(range(0, 48, 2))
TIME_MQ_PLAIN_FS3 = (3, 47)
TIME_MQ_PLAIN_FS3DD = (1, 29)
# "torch_host": the multi-query drive with every stage's engagement
# threshold out of reach, so the host runs the f32 stages on the same
# items (what the card's stages are weighed against).  The standard
# drive takes such a turn; the --fs drive, whose host fs3 stages take
# longest, leaves its time to the build path
MQ_TURNS = ("numpy", "torch", "torch_host")
MQ_FS_TURNS = ("numpy", "torch")
MQ_MIN_CELLS = ("BATH_MQ_FWD_MIN_CELLS", "BATH_MQ_DD_MIN_CELLS",
                "BATH_MQ_FS3_MIN_CELLS", "BATH_MQ_FSDD_MIN_CELLS")

# bathbuild and bathconvert: alignments of MSA_NSEQ sequences emitted
# from the 48 multi-query models, the default calibration (200 x 200 aa
# for the MSV and Viterbi mus, 200 x 100 aa and 200 x 300 nt for the
# taus).  A tau of an f32 gate may sit TAU_WARN from the host parser's
# before the run says so, and TAU_TOL before it fails.
MSA_NSEQ = 20
TAU_WARN, TAU_TOL = 0.02, 0.05
F32_GATE_LINES = ("STATS LOCAL FORWARD", "STATS LOCAL FS3 FORWARD")

# The card's published peaks (NVIDIA H100 SXM data sheet): device memory
# and float32 outside the tensor cores.  The DP kernels are f32 (or one
# 32-bit int per cell) multiply-adds and maxima on the CUDA cores, so
# that rate bounds their operations.
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12
# Arithmetic per DP cell (one residue or nucleotide x one model
# position), counted from the recurrences: the M, I, D updates, the
# row sum and the rescale; decoding adds the backward pass's.
OPS_PER_CELL = {"fwd_parser": 19, "domdec": 37, "fs3_parser": 23,
                "fs3_domdec": 43, "msv_filter": 8, "ssv_capture": 4,
                "vit_filter": 20, "vit_capture": 21}


CHILDREN: list = []             # child processes still to be reaped


def stop_children() -> None:
    for proc in CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


atexit.register(stop_children)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def host_tool(name: str, argv) -> tuple:
    """Starts ``--backend numpy`` of one of the port's CLIs in a child
    process (no CUDA there), its output into a file under build/;
    ``host_result`` waits for it.  For bathbuild, whose serial host
    calibration of 48 models would add its minutes to the run."""
    log = BUILD / f"{name}_numpy.stdout"
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", f"bath_tpu_torch.cli.{name}", "--backend",
             "numpy", *(str(a) for a in argv)], cwd=ROOT, stdout=f,
            stderr=subprocess.STDOUT)
    CHILDREN.append(proc)
    return name, proc, log


def host_result(child: tuple) -> tuple:
    """(stdout with its run-dependent lines masked, the wall the CLI
    itself prints) of a ``host_tool`` child; fails if it did."""
    name, proc, log = child
    rc = proc.wait(timeout=900)
    text = log.read_text()
    wall = re.search(r"# CPU time: ([0-9.]+)u", text)
    if rc != 0 or not wall:
        fail(f"{name} --backend numpy exited {rc}: {text[-2000:]}")
    return mask_tool(text), float(wall.group(1))


def mask_tool(text: str) -> str:
    return re.sub(r"# (CPU time|output HMM file):.*", "", text)


T_START = time.perf_counter()


def phase(tag: str, **kv) -> None:
    print(f"[{tag}] at_s={time.perf_counter() - T_START:.0f} "
          + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def bound(kernel: str, cells: float, nbytes: float):
    """(bound_ms, bound_by): the least time the card could take for
    <cells> DP cells of <kernel> and <nbytes> bytes moved (each input
    read once, each output written once), against the published
    peaks."""
    by_ops = 1e3 * cells * OPS_PER_CELL[kernel.replace("_multi", "")] \
        / CORE_OPS_PER_S
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    return max(by_ops, by_bytes), \
        "operations" if by_ops >= by_bytes else "bytes"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over <reps> runs, by CUDA events, after
    one warm-up run."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def once_ms(fn) -> float:
    """Milliseconds of one fn() call on the card, by the host clock
    around a synchronise: for the plain versions, whose Python row
    loops take seconds."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t)


def host_ms(fn) -> float:
    """Milliseconds of one fn() call by the host clock."""
    t = time.perf_counter()
    fn()
    return 1e3 * (time.perf_counter() - t)


def exact(got, want) -> float:
    """max |got - want| over the outputs of an integer kernel and its
    plain version (0 when they agree bit for bit)."""
    return max(float((g.to(torch.int64) - w.to(torch.int64)).abs().max())
               if g.numel() else 0.0 for g, w in zip(got, want))


def one_batch(orfs, dev, pad=28):
    """(lengths as numpy, dsq, lens): <orfs> as one padded batch on
    <dev>, built as the cascade builds its batches."""
    from bath_tpu_torch.device_pipeline import batches
    ln = np.array([len(o) for o in orfs], np.int32)
    _, dsq, lens = next(batches(orfs, ln, dev, batch=len(orfs), pad=pad))
    return ln, dsq, lens


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(ROOT))
    from bath_tpu_torch import fixtures
    from bath_tpu_torch.cli import bathsearch
    from bath_tpu_torch.ops import domdec as dd
    from bath_tpu_torch.ops import fs3
    from bath_tpu_torch.ops import fs3_domdec as fdd
    from bath_tpu_torch.ops import fwd
    from bath_tpu_torch.ops import multimodel as mm
    from bath_tpu_torch.ops import ssv
    from bath_tpu_torch.ops import vit
    from bath_tpu_torch.ops.kernels import loader

    dev = torch.device(DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi exited {smi.returncode}: {smi.stderr[-500:]}")
    card = smi.stdout.strip().splitlines()[0]
    bathsearch.require_native()
    phase("device", torch=torch.__version__, cuda=torch.version.cuda,
          name=repr(kind), count=torch.cuda.device_count(),
          native_lib="loaded")
    print(card, flush=True)

    # 1b. the host yardstick of phase 5e starts now, in a child process
    # beside the kernel phases (it needs no card, the host has cores to
    # spare, and nothing timed below runs before it has ended):
    # bathbuild --backend numpy, the serial host calibration, of the
    # 48-alignment fixture
    BUILD.mkdir(parents=True, exist_ok=True)
    sto, msa_names = fixtures.write_msa_fixture(MQ_MS, MSA_NSEQ, SEED)
    built = {b: BUILD / f"built_{b}.bhmm" for b in ("numpy", "torch")}
    host_build = host_tool("bathbuild", [built["numpy"], sto])
    phase("bathbuild", backend="numpy", started="in a child process",
          alignments=len(MQ_MS), nseq=MSA_NSEQ)

    # 2. kernel build
    t = time.perf_counter()
    so = loader.build()
    loader.lib()
    phase("build", seconds=f"{time.perf_counter() - t:.1f}",
          nvcc=" ".join(loader.NVCC_FLAGS),
          sources=",".join(str(p.relative_to(ROOT))
                           for p in loader.sources()),
          library=so.relative_to(ROOT))

    # 3. parity with the plain versions, on the card
    rng = np.random.default_rng(SEED)
    hmm, q = fixtures.make_query(M_SEARCH, rng, calibrate=False)
    p400 = fwd.fwd_params(fixtures.search_profile(hmm), dev)
    dsq, lens = fixtures.kernel_batch(q, *PARITY_FWD, rng)
    dsq, lens = torch.from_numpy(dsq).to(dev), torch.from_numpy(lens).to(dev)
    got = fwd.fwd_score(dsq, lens, p400)
    want = fwd.fwd_score_ref(dsq, lens, p400)
    fwd_err = float((got - want).abs().max())
    if not torch.isfinite(got).all() or not fwd_err <= FWD_TOL:
        fail(f"fwd kernel vs plain: max |d| {fwd_err} > {FWD_TOL}")
    phase("parity", kernel="fwd_parser", M=M_SEARCH, B=PARITY_FWD[0],
          L=f"1..{PARITY_FWD[1]}",
          max_abs_err=fwd_err, tol=FWD_TOL,
          best_score=f"{float(got.max()):.2f}")
    dsq, lens = fixtures.kernel_batch(q, *PARITY_DOMDEC, rng)
    dsq, lens = torch.from_numpy(dsq).to(dev), torch.from_numpy(lens).to(dev)
    got = dd.domdec(dsq, lens, p400)
    want = dd.domdec_ref(dsq, lens, p400)
    dd_err = max(float((a - b).abs().max()) for a, b in zip(got[:3],
                                                            want[:3]))
    if not dd_err <= DOMDEC_TOL or not torch.equal(got[3], want[3]):
        fail(f"domdec kernel vs plain: max |d| {dd_err} > {DOMDEC_TOL} "
             f"or ok differs ({got[3].sum()} vs {want[3].sum()})")
    phase("parity", kernel="domdec", M=M_SEARCH, B=PARITY_DOMDEC[0],
          L=f"1..{PARITY_DOMDEC[1]}", max_abs_err=dd_err, tol=DOMDEC_TOL,
          ok=f"{int(got[3].sum())}/{PARITY_DOMDEC[0]}", ok_identical=True)
    # a model past one warp's reach (several warps per ORF)
    hmm_w, q_w = fixtures.make_query(WIDE[0], rng, calibrate=False)
    p_w = fwd.fwd_params(fixtures.search_profile(hmm_w), dev)
    dsq, lens = fixtures.kernel_batch(q_w, WIDE[1], WIDE[2], rng)
    dsq, lens = torch.from_numpy(dsq).to(dev), torch.from_numpy(lens).to(dev)
    e1 = float((fwd.fwd_score(dsq, lens, p_w)
                - fwd.fwd_score_ref(dsq, lens, p_w)).abs().max())
    g, w = dd.domdec(dsq, lens, p_w), dd.domdec_ref(dsq, lens, p_w)
    e2 = max(float((a - b).abs().max()) for a, b in zip(g[:3], w[:3]))
    if not (e1 <= FWD_TOL and e2 <= DOMDEC_TOL and torch.equal(g[3], w[3])):
        fail(f"M={WIDE[0]} parity: fwd {e1}, domdec {e2}")
    phase("parity", kernel="both", M=WIDE[0], layout=loader.layout(WIDE[0]),
          fwd_err=e1, domdec_err=e2)

    # 3b. the --fs kernels against their plain versions: DNA windows of
    # 0, 2, 3, 4 and up to 2500 nt with homologs (one in three
    # frameshifted) and runs of N, at M_SEARCH and at a model that
    # takes several warps per window
    fs3_err = fs3dd_err = 0.0
    for M in (M_SEARCH, FS3_WIDE_M):
        hm, qm = fixtures.make_query(M, rng, calibrate=False, fs=True)
        pm = fs3.fs3_params(fixtures.fs_search_profile(hm), dev)
        dsq, lens = (torch.from_numpy(a).to(dev) for a in
                     fixtures.fs_window_batch(qm, *PARITY_FS3, rng))
        got = fs3.fs3_score(dsq, lens, pm)
        want = fs3.fs3_score_ref(dsq, lens, pm)
        fin = torch.isfinite(want)
        e1 = float((got - want)[fin].abs().max())
        if not (torch.equal(fin, torch.isfinite(got)) and e1 <= FWD_TOL):
            fail(f"fs3 kernel vs plain at M={M}: max |d| {e1} > {FWD_TOL} "
                 "or the -inf windows differ")
        dsq, lens = (torch.from_numpy(a).to(dev) for a in
                     fixtures.fs_window_batch(qm, *PARITY_FS3DD, rng))
        g = fdd.fs3_domdec(dsq, lens, pm, 100.0 / 103.0)
        w = fdd.fs3_domdec_ref(dsq, lens, pm, 100.0 / 103.0)
        e2 = max(float((a - b).abs().max()) for a, b in zip(g[:3], w[:3]))
        if not (e2 <= DOMDEC_TOL and torch.equal(g[3], w[3])):
            fail(f"fs3_domdec kernel vs plain at M={M}: max |d| {e2} > "
                 f"{DOMDEC_TOL} or ok differs ({g[3].sum()} vs "
                 f"{w[3].sum()})")
        fs3_err, fs3dd_err = max(fs3_err, e1), max(fs3dd_err, e2)
        phase("parity", kernel="fs3_parser,fs3_domdec", M=M,
              layout=loader.fs3_layout(M),
              B=f"{PARITY_FS3[0]},{PARITY_FS3DD[0]}",
              L=f"0..{PARITY_FS3[1]}", fs3_err=e1, fs3_tol=FWD_TOL,
              fs3_domdec_err=e2, fs3_domdec_tol=DOMDEC_TOL,
              ok=f"{int(g[3].sum())}/{PARITY_FS3DD[0]}", ok_identical=True,
              best_score=f"{float(want[fin].max()):.2f}")

    # 3c. the integer filters against their plain versions, exactly:
    # ORFs of the search genome, its hot ORFs (int16 overflow; SSV slots
    # overflowing at P = 1), ORFs of 0, 1, 2, 19-21 and 3 missing-data
    # residues and, at M_SEARCH, one of LONG_ORF residues; INT_WIDE_M
    # takes several warps per ORF
    from bath_tpu_torch.hmmfile import read_hmm
    fx = fixtures.write_fixture(M_SEARCH, GENOME_NT, N_EMBEDS, SEED)
    om = fixtures.search_profile(read_hmm(fx.hmm_path))
    int_err = {k: 0.0 for k in ("msv_filter", "ssv_capture", "vit_filter",
                                "vit_capture")}

    def ints(values):
        return torch.from_numpy(np.asarray(values, np.int32)).to(dev)

    def held(name, got, want, M):
        err = exact(got, want)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            fail(f"{name} kernel vs plain at M={M}: max |d| {err}")
        int_err[name] = max(int_err[name], err)
        return got

    for M in (M_SEARCH, INT_WIDE_M):
        if M == M_SEARCH:
            src, om_m = fx, om
        else:
            src = fixtures.write_fixture(M, 30_000, 4, M, calibrate=False)
            om_m = fixtures.search_profile(read_hmm(src.hmm_path))
        orfs = fixtures.filter_cases(src, PARITY_INT_N, SEED,
                                     LONG_ORF if M == M_SEARCH else 1200)
        flat, offs, lens = (torch.from_numpy(a).to(dev)
                            for a in ssv.pack_stream(orfs))
        pm, pv = ssv.msv_params(om_m, dev), vit.vit_params(om_m, dev)
        ln = lens.cpu().numpy()
        tjb, move = ints(pm.tjb_for(ln)), ints(pv.move_for(ln))
        args = (flat, offs, lens)
        movf = held("msv_filter", ssv.msv_ssv(*args, tjb, pm),
                    ssv.msv_ssv_ref(*args, tjb, pm), M)[2]
        vs = held("vit_filter", vit.vit_ints(*args, move, pv),
                  vit.vit_ints_ref(*args, move, pv), M)
        nwin = {}
        for t in (SSV_THR, P1_THR):
            thr = ints(np.full(len(orfs), t))
            nwin[t] = held("ssv_capture", ssv.ssv_capture(*args, tjb, thr, pm),
                           ssv.ssv_capture_ref(*args, tjb, thr, pm), M)[0]
        orow = {}
        for t in (VIT_THR, P1_THR):
            thr = ints(np.full(len(orfs), t))
            orow[t] = held("vit_capture",
                           vit.vit_capture(*args, move, thr, pv),
                           vit.vit_capture_ref(*args, move, thr, pv), M)[1]
        branches = {"msv_overflow": int(movf.sum()),
                    "vit_overflow": int(vs[2].sum()),
                    "vit_no_result": int((~vs[1]).sum()),
                    "ssvcap_over_16": int((nwin[P1_THR] > 16).sum()),
                    "ssvcap_events": int(nwin[SSV_THR].sum()),
                    "vitcap_ovfrow": int((orow[VIT_THR] > 0).sum())}
        if min(branches.values()) <= 0:
            fail(f"integer-filter parity cases at M={M} miss a branch: "
                 f"{branches}")
        phase("parity", kernel="msv_filter,ssv_capture,vit_filter,"
              "vit_capture", M=M, layout=loader.layout(M), B=len(orfs),
              max_L=int(ln.max()), identical=True, **branches)

    # 3d. MSV through the cascade (one flat stream, one launch) over
    # every ORF of the search genome against the native host batch
    from bath_tpu_torch.native import msv_filter_native_batch
    from bath_tpu_torch.device_pipeline import TorchCascade
    cas = TorchCascade(om, device=dev, stats={})
    all_orfs = fixtures.genome_orfs(fx.fasta_path)
    a_flat, a_offs, a_lens = ssv.pack_stream(all_orfs)
    got = cas.msv_scores(None, a_lens, flat=a_flat, offs=a_offs)
    want = msv_filter_native_batch(all_orfs, om)
    if not np.array_equal(got, want):
        fail(f"device MSV differs from msv_filter_native_batch on "
             f"{int((got != want).sum())} of {len(all_orfs)} ORFs")
    phase("parity", kernel="msv_filter", M=M_SEARCH,
          vs="msv_filter_native_batch", orfs=len(all_orfs),
          residues=int(a_lens.sum()), inf=int(np.isinf(got).sum()),
          identical=True)

    # 3e. the four multi-model entries at full width: 48 models of
    # M = 60..1200 mixed in one batch per stage, items of up to 1250 aa
    # and 3700 nt with copies of their model's protein.  Each entry,
    # model by model, bit for bit against the single-model entry on the
    # same rows (for the decoding pair: the kernels' own outputs bit
    # for bit, the posteriors after the shared tensor-op combine within
    # 1e-6, because torch.cumsum's summation order on the card depends
    # on the batch's shape), and against its plain version on the items
    # of a few models that span the widths and the warps per item.  4e
    # holds every item of all 48 models against the plain versions at
    # the multi-query drive's shapes.
    def multi_case(fs, per_model, Lmax):
        oms, d, ln, sl = fixtures.multi_kernel_batch(MQ_MS, per_model, Lmax,
                                                     SEED, fs=fs)
        params = [(fs3.fs3_params if fs else fwd.fwd_params)(om, dev)
                  for om in oms]
        pack = (mm.build_fs3_pack if fs else mm.build_fwd_pack)(params)
        return (pack, torch.from_numpy(d).to(dev),
                torch.from_numpy(ln).to(dev), sl)

    def model_rows(sl):
        return [(g, torch.from_numpy(np.nonzero(sl == g)[0]).to(dev))
                for g in range(len(MQ_MS))]

    def vs_plain(name, got, want):
        """max |got - want| of a multi-model entry and its plain
        version; fails past the single-model kernels' bounds: gates
        FWD_TOL with the same -inf items, decoding DOMDEC_TOL on the
        posteriors with `ok` identical."""
        if isinstance(got, tuple):
            err = max(float((a - b).abs().max())
                      for a, b in zip(got[:3], want[:3]))
            if not (err <= DOMDEC_TOL and torch.equal(got[3], want[3])):
                fail(f"{name} vs plain: max |d| {err} > {DOMDEC_TOL} or ok "
                     f"differs ({got[3].sum()} vs {want[3].sum()})")
            return err
        fin = torch.isfinite(want)
        err = float((got - want)[fin].abs().max())
        if not (torch.equal(fin, torch.isfinite(got)) and err <= FWD_TOL):
            fail(f"{name} vs plain: max |d| {err} > {FWD_TOL} or the -inf "
                 "items differ")
        return err

    def plain_subset(sl, models):
        sub = np.nonzero(np.isin(sl, models))[0]
        return sub, torch.from_numpy(sub).to(dev)

    def gate_case(name, fs, shape, call, single, ref):
        """Holds one gate entry on a batch: against the single-model
        entry model by model, and against the plain version on the
        items of PARITY_MQ_PLAIN; returns the error against the plain
        version."""
        pack, d, lt, sl = multi_case(fs, *shape)
        got = call(pack, d, lt, sl)
        sub, rs = plain_subset(sl, PARITY_MQ_PLAIN)
        err = vs_plain(name, got[rs], ref(pack, d[rs].contiguous(),
                                          lt[rs].contiguous(), sl[sub]))
        for g, r in model_rows(sl):
            one = single(d[r].contiguous(), lt[r].contiguous(),
                         pack.params[g])
            if not torch.equal(one, got[r]):
                fail(f"{name} differs from the single-model entry at "
                     f"M={MQ_MS[g]}")
        phase("parity", kernel=name, models=len(MQ_MS),
              M=f"{min(MQ_MS)}..{max(MQ_MS)}", widths=sorted(pack.classes),
              B=len(sl), L=f"{int(lt.min())}..{int(lt.max())}",
              vs_plain=err, plain_items=len(sub),
              plain_M=[MQ_MS[g] for g in PARITY_MQ_PLAIN], tol=FWD_TOL,
              best_score=f"{float(got[torch.isfinite(got)].max()):.2f}",
              single_model_entry="bit for bit")
        return err

    def decoding_case(name, fs, shape, plain_models):
        """The same for a decoding entry: the kernels' own outputs bit
        for bit the single-model entry's, `ok` identical, posteriors
        within 1e-6 of it."""
        pack, d, lt, sl = multi_case(fs, *shape)
        n3 = lt.cpu().numpy() // 3
        dec = torch.from_numpy((n3 / (n3 + 3.0)).astype(np.float32)).to(dev)
        sub, rs = plain_subset(sl, plain_models)
        ds, ls = d[rs].contiguous(), lt[rs].contiguous()
        if fs:
            got = mm.fs3_domdec_pack_batch(pack, d, lt, sl, dec)
            raw, _ = loader.launch_fs3_domdec_multi(d, lt, sl, pack, 1.0)
            want = mm.fs3_domdec_pack_batch_ref(pack, ds, ls, sl[sub],
                                                dec[rs])
        else:
            got = mm.domdec_pack_batch(pack, d, lt, sl)
            raw, _ = loader.launch_domdec_multi(d, lt, sl, pack, 1.0)
            want = mm.domdec_pack_batch_ref(pack, ds, ls, sl[sub])
        err = vs_plain(name, tuple(t[rs] for t in got), want)
        post_err = 0.0
        for g, r in model_rows(sl):
            args = (d[r].contiguous(), lt[r].contiguous(), pack.params[g])
            one_raw = (loader.launch_fs3_domdec if fs
                       else loader.launch_domdec)(*args, 1.0)
            if not all(torch.equal(a, b[r]) for a, b in zip(one_raw, raw)):
                fail(f"{name}'s kernel outputs differ from the single-model "
                     f"entry's at M={MQ_MS[g]}")
            one = fdd.fs3_domdec(*args, dec[r]) if fs else dd.domdec(*args)
            if not torch.equal(one[3], got[3][r]):
                fail(f"{name}: ok differs from the single-model entry's at "
                     f"M={MQ_MS[g]}")
            post_err = max(post_err, *(float((a - b[r]).abs().max())
                                       for a, b in zip(one[:3], got[:3])))
        if post_err > 1e-6:
            fail(f"{name}: posteriors {post_err} from the single-model "
                 "entry's")
        phase("parity", kernel=name, models=len(MQ_MS),
              M=f"{min(MQ_MS)}..{max(MQ_MS)}", widths=sorted(pack.classes),
              B=len(sl), L=f"{int(lt.min())}..{int(lt.max())}",
              vs_plain=err, plain_items=len(sub),
              plain_M=[MQ_MS[g] for g in plain_models], tol=DOMDEC_TOL,
              ok=f"{int(got[3].sum())}/{len(sl)}",
              single_model_entry="kernel outputs bit for bit",
              posteriors_vs_single=post_err)
        return err

    mq_err = {
        "fwd_parser_multi": gate_case(
            "fwd_parser_multi", False, PARITY_MQ_FWD, mm.fwd_pack_scores,
            fwd.fwd_score, mm.fwd_pack_scores_ref),
        "fs3_parser_multi": gate_case(
            "fs3_parser_multi", True, PARITY_MQ_FS3, mm.fs3_pack_scores,
            fs3.fs3_score, mm.fs3_pack_scores_ref),
        "domdec_multi": decoding_case(
            "domdec_multi", False, PARITY_MQ_DOMDEC, PARITY_MQ_PLAIN),
        "fs3_domdec_multi": decoding_case(
            "fs3_domdec_multi", True, PARITY_MQ_FS3DD, PARITY_MQ_PLAIN_FS3DD),
    }

    # 3f. the child of phase 1b has to have ended before anything is
    # timed
    build_table_numpy, build_wall_numpy = host_result(host_build)
    phase("bathbuild", backend="numpy", ended=True,
          wall_s=f"{build_wall_numpy:.3f}", concurrent=True)

    # 4. timing at the main path's shapes (ORFs of the search genome)
    times = {}
    for M in TIME_FWD_M:
        hm, _ = fixtures.make_query(M, np.random.default_rng(M),
                                    calibrate=False)
        pm = fwd.fwd_params(fixtures.search_profile(hm), dev)
        ln, d, lt = one_batch(fixtures.sample_orfs(fx.fasta_path, TIME_FWD_B,
                                                   SEED), dev)
        k_ms = cuda_ms(lambda: fwd.fwd_score(d, lt, pm), 20)
        p_ms = once_ms(lambda: fwd.fwd_score_ref(d, lt, pm))
        cells = float(ln.sum()) * M
        times[("fwd", M)] = (k_ms, p_ms, *bound(
            "fwd_parser", cells,
            nbytes(d, lt, *pm.padded(loader.layout(M)[2])) + 4 * len(ln)))
        phase("timing", kernel="fwd_parser", M=M, B=TIME_FWD_B,
              mean_L=f"{ln.mean():.1f}", max_L=int(ln.max()),
              ms=f"{k_ms:.4f}", plain_ms=f"{p_ms:.2f}",
              gcups=f"{cells / k_ms / 1e6:.2f}",
              plain_gcups=f"{cells / p_ms / 1e6:.3f}")
    ln, d, lt = one_batch(fixtures.sample_orfs(fx.fasta_path, TIME_DOMDEC_B,
                                               SEED, min_len=100), dev)
    k_ms = cuda_ms(lambda: dd.domdec(d, lt, p400), 10)
    p_ms = once_ms(lambda: dd.domdec_ref(d, lt, p400))
    cells = float(ln.sum()) * M_SEARCH
    times["domdec"] = (k_ms, p_ms, *bound(
        "domdec", cells,
        nbytes(d, lt, *p400.padded(loader.layout(M_SEARCH)[2]))
        + 4 * 3 * d.shape[0] * (d.shape[1] + 1) + len(ln)))
    phase("timing", kernel="domdec", M=M_SEARCH, B=TIME_DOMDEC_B, min_L=100,
          mean_L=f"{ln.mean():.1f}", max_L=int(ln.max()),
          ms=f"{k_ms:.4f}", plain_ms=f"{p_ms:.2f}",
          gcups=f"{cells / k_ms / 1e6:.2f}")

    # 4b. the --fs kernels on windows of the fs3 gate's shape (2 *
    # max_length * 3 nt) cut from the search genome; GCUPS count
    # nucleotides x M
    for M in TIME_FS3_M:
        hm, _ = fixtures.make_query(M, np.random.default_rng(M),
                                    calibrate=False, fs=True)
        hm.set_max_length()
        pm = fs3.fs3_params(fixtures.fs_search_profile(hm), dev)
        wlen = 6 * hm.max_length
        ln, d, lt = one_batch(fixtures.sample_windows(
            fx.fasta_path, TIME_FS3_B, wlen, SEED), dev, pad=17)
        k_ms = cuda_ms(lambda: fs3.fs3_score(d, lt, pm), 5)
        p_ms = once_ms(lambda: fs3.fs3_score_ref(d, lt, pm))
        cells = float(ln.sum()) * M
        times[("fs3", M)] = (k_ms, p_ms, *bound(
            "fs3_parser", cells,
            nbytes(d, lt, *pm.padded(loader.fs3_layout(M)[2])) + 4 * len(ln)))
        phase("timing", kernel="fs3_parser", M=M, B=TIME_FS3_B, L=wlen,
              layout=loader.fs3_layout(M), ms=f"{k_ms:.4f}",
              plain_ms=f"{p_ms:.2f}", us_per_row=f"{1e3 * k_ms / wlen:.3f}",
              gcups=f"{cells / k_ms / 1e6:.2f}",
              plain_gcups=f"{cells / p_ms / 1e6:.3f}")
        if M == TIME_FS3_M[1]:
            pdd, ddd, ldd, wdd = pm, d[:TIME_FS3DD_B], lt[:TIME_FS3DD_B], wlen
    k_ms = cuda_ms(lambda: fdd.fs3_domdec(ddd, ldd, pdd, 100.0 / 103.0), 3)
    p_ms = once_ms(lambda: fdd.fs3_domdec_ref(ddd, ldd, pdd,
                                              100.0 / 103.0))
    times["fs3_domdec"] = (k_ms, p_ms, *bound(
        "fs3_domdec", float(TIME_FS3DD_B) * wdd * TIME_FS3_M[1],
        nbytes(ddd, ldd, *pdd.padded(loader.fs3_layout(TIME_FS3_M[1])[2]))
        + 4 * 3 * TIME_FS3DD_B * (wdd + 1) + TIME_FS3DD_B))
    phase("timing", kernel="fs3_domdec", M=TIME_FS3_M[1], B=TIME_FS3DD_B,
          L=wdd, ms=f"{k_ms:.4f}", plain_ms=f"{p_ms:.2f}",
          gcups=f"{TIME_FS3DD_B * wdd * TIME_FS3_M[1] / k_ms / 1e6:.2f}")

    # 4c. the integer filters: MSV over one flush of the search genome's
    # ORFs (the flat stream flush_gates hands over), the ViterbiFilter
    # and both captures over TIME_INT_B of them, at the default F1/F2
    # thresholds on the null scores; beside each kernel its plain version
    # and, for MSV and Viterbi, the native host library's OpenMP batch
    # on the same ORFs in the flat layout its ORF extractor hands over
    from bath_tpu_torch.bg import Background
    from bath_tpu_torch.gencode import OrfList
    from bath_tpu_torch.native import vit_filter_score_batch
    from bath_tpu_torch.cli.bathsearch import CHUNK_ORFS

    def host_layout(orfs):
        flat, offs, lens = ssv.pack_stream(orfs)
        out = OrfList(orfs)
        out.flat, out.offs, out.lens = flat.astype(np.int32), offs, lens
        return out
    pm, pv = cas.msv, cas.vit
    f_orfs = all_orfs[:CHUNK_ORFS]
    f_host = host_layout(f_orfs)
    f_flat, f_offs, f_lens = (torch.from_numpy(a).to(dev)
                              for a in ssv.pack_stream(f_orfs))
    f_tjb = ints(pm.tjb_for(f_lens.cpu().numpy()))
    fa = (f_flat, f_offs, f_lens, f_tjb, pm)
    k_ms = cuda_ms(lambda: ssv.msv_ssv(*fa), 20)
    p_ms = once_ms(lambda: ssv.msv_ssv_ref(*fa))
    held("msv_filter", ssv.msv_ssv(*fa), ssv.msv_ssv_ref(*fa), M_SEARCH)
    h_ms = host_ms(lambda: msv_filter_native_batch(f_host, om))
    cells = float(f_lens.sum()) * M_SEARCH
    Mp400 = loader.layout(M_SEARCH)[2]
    times["msv_filter"] = (k_ms, p_ms, *bound(
        "msv_filter", cells,
        nbytes(f_flat, f_offs, f_lens, f_tjb, pm.table(Mp400))
        + 4 * 3 * len(f_orfs)))
    phase("timing", kernel="msv_filter", M=M_SEARCH, B=len(f_orfs),
          layout="flat", mean_L=f"{float(f_lens.float().mean()):.1f}",
          max_L=int(f_lens.max()), ms=f"{k_ms:.4f}", plain_ms=f"{p_ms:.2f}",
          host_native_batch_ms=f"{h_ms:.2f}", host_cores=os.cpu_count(),
          gcups=f"{cells / k_ms / 1e6:.2f}",
          host_gcups=f"{cells / h_ms / 1e6:.2f}", card=repr(card))
    v_orfs = fixtures.sample_orfs(fx.fasta_path, TIME_INT_B, SEED)
    v_host = host_layout(v_orfs)
    v_flat, v_offs, v_lens = (torch.from_numpy(a).to(dev)
                              for a in ssv.pack_stream(v_orfs))
    vl = v_lens.cpu().numpy()
    got = cas.vit_scores(v_orfs, vl)
    want = vit_filter_score_batch(v_host, np.arange(len(v_orfs)), om)
    if not np.array_equal(got, want.astype(np.float32)):
        fail(f"device ViterbiFilter differs from vit_filter_score_batch on "
             f"{int((got != want).sum())} of {len(v_orfs)} ORFs")
    phase("parity", kernel="vit_filter", M=M_SEARCH,
          vs="vit_filter_score_batch", orfs=len(v_orfs),
          inf=int(np.isinf(got).sum()), identical=True)
    bg = Background()
    nulls = []
    for n in vl.tolist():
        bg.set_length(n)
        nulls.append(bg.null_one(n))
    tjb, s_thr = (ints(a) for a in cas.ssv_thresholds(vl, nulls, F1))
    move, v_thr = (ints(a) for a in cas.vit_thresholds(vl, nulls, F2))
    va = (v_flat, v_offs, v_lens)
    cells = float(vl.sum()) * M_SEARCH
    for name, k_fn, p_fn, host in (
            ("vit_filter", lambda: vit.vit_ints(*va, move, pv),
             lambda: vit.vit_ints_ref(*va, move, pv),
             lambda: vit_filter_score_batch(v_host, np.arange(TIME_INT_B),
                                            om)),
            ("ssv_capture", lambda: ssv.ssv_capture(*va, tjb, s_thr, pm),
             lambda: ssv.ssv_capture_ref(*va, tjb, s_thr, pm), None),
            ("vit_capture", lambda: vit.vit_capture(*va, move, v_thr, pv),
             lambda: vit.vit_capture_ref(*va, move, v_thr, pv), None)):
        k_ms = cuda_ms(k_fn, 20)
        p_ms = once_ms(p_fn)
        h_ms = host_ms(host) if host else None
        out = held(name, k_fn(), p_fn(), M_SEARCH)
        times[name] = (k_ms, p_ms, *bound(
            name, cells,
            nbytes(v_flat, v_offs, v_lens, move, v_thr,
                   (pv if name.startswith("vit") else pm).table(Mp400))
            + nbytes(*out)))
        events = {"ssv_capture": lambda: int(out[0].sum()),
                  "vit_capture": lambda: int((out[0] != 0).sum()),
                  "vit_filter": lambda: int(out[2].sum())}[name]()
        phase("timing", kernel=name, M=M_SEARCH, B=TIME_INT_B,
              mean_L=f"{vl.mean():.1f}", max_L=int(vl.max()),
              ms=f"{k_ms:.4f}", plain_ms=f"{p_ms:.2f}",
              host_native_batch_ms="not timed" if h_ms is None
              else f"{h_ms:.2f}",
              gcups=f"{cells / k_ms / 1e6:.2f}",
              **({"events": events} if name != "vit_filter"
                 else {"overflow": events}), card=repr(card))

    # 4d. the grid holds at most one ORF per resident warp, and an SM
    # holds at most 64 warps: one flush's ORFs outnumber them, so every
    # warp's grid-stride loop takes further ORFs; held exactly there
    resident = torch.cuda.get_device_properties(dev).multi_processor_count \
        * 64
    if len(f_orfs) <= resident:
        fail(f"{len(f_orfs)} ORFs do not outnumber {resident} warps")
    f_move = ints(pv.move_for(f_lens.cpu().numpy()))
    f_sthr, f_vthr = (ints(np.full(len(f_orfs), t))
                      for t in (SSV_THR, VIT_THR))
    fo = (f_flat, f_offs, f_lens)
    held("vit_filter", vit.vit_ints(*fo, f_move, pv),
         vit.vit_ints_ref(*fo, f_move, pv), M_SEARCH)
    ev = held("ssv_capture", ssv.ssv_capture(*fo, f_tjb, f_sthr, pm),
              ssv.ssv_capture_ref(*fo, f_tjb, f_sthr, pm), M_SEARCH)[0]
    kr = held("vit_capture", vit.vit_capture(*fo, f_move, f_vthr, pv),
              vit.vit_capture_ref(*fo, f_move, f_vthr, pv), M_SEARCH)[0]
    phase("parity", kernel="msv_filter,ssv_capture,vit_filter,vit_capture",
          M=M_SEARCH, B=len(f_orfs), resident_warps_max=resident,
          ssvcap_events=int(ev.sum()), vitcap_events=int((kr != 0).sum()),
          identical=True)

    # 4e. the multi-model entries at the multi-query drive's shapes:
    # genome ORFs (Forward gate, decoding) and genome windows of 2 *
    # max_length * 3 nt of each window's model (fs3 pair), their models
    # drawn over all 48; beside each entry, one single-model launch per
    # model over the same items, split by model beforehand
    mq_rng = np.random.default_rng(SEED + 1)
    mq_hmms = []
    for M in MQ_MS:
        hm, _ = fixtures.make_query(M, mq_rng, calibrate=False, fs=True)
        hm.set_max_length()
        mq_hmms.append(hm)
    std_pack = mm.build_fwd_pack(
        [fwd.fwd_params(fixtures.search_profile(h), dev) for h in mq_hmms])
    fs_pack = mm.build_fs3_pack(
        [fs3.fs3_params(fixtures.fs_search_profile(h), dev)
         for h in mq_hmms])
    Ms = np.asarray(MQ_MS, np.float64)
    wlens = np.array([6 * h.max_length for h in mq_hmms])
    windows = fixtures.sample_windows(fx.fasta_path, TIME_MQ_FS3_B,
                                      int(wlens.max()), SEED)
    fs_slot = mq_rng.integers(0, len(MQ_MS), TIME_MQ_FS3_B)
    windows = [w[:wlens[g]] for w, g in zip(windows, fs_slot)]
    dd_slot = np.resize(np.asarray(MQ_EMBEDDED), TIME_MQ_FS3DD_B)
    dd_windows = [w[:wlens[g]] for w, g in zip(
        fixtures.sample_windows(fx.fasta_path, TIME_MQ_FS3DD_B,
                                int(wlens.max()), SEED + 2), dd_slot)]

    plain_items = {}

    def time_multi(name, pack, items, sl, pad, call, single, reps, extra=(),
                   plain_models=range(len(MQ_MS))):
        """Times one entry on <items> under the models <sl>, beside one
        single-model launch per model, and holds its output against the
        single-model entries' on all items and against the plain
        version's on the items of <plain_models>, which it times."""
        ln, d, lt = one_batch(items, dev, pad=pad)
        # one_batch sorts by length: carry the slots along
        order = np.argsort([len(o) for o in items], kind="stable")
        sl = np.asarray(sl)[order]
        split = [(r, pack.params[g], d[r].contiguous(), lt[r].contiguous())
                 for g, r in model_rows(sl) if len(r)]
        k_ms = cuda_ms(lambda: call(pack, d, lt, sl, *extra), reps)
        s_ms = cuda_ms(lambda: [single(dg, lg, pg, *extra)
                                for _, pg, dg, lg in split], reps)
        out = call(pack, d, lt, sl, *extra)
        outs = out if isinstance(out, tuple) else (out,)
        # the single-model entries on the same items: the gates bit for
        # bit, the decoders' posteriors within 1e-6 (torch.cumsum)
        for r, pg, dg, lg in split:
            one = single(dg, lg, pg, *extra)
            one = one if isinstance(one, tuple) else (one,)
            if not (torch.equal(one[-1], outs[-1][r]) and all(
                    float((a - b[r]).abs().max()) <= 1e-6
                    for a, b in zip(one[:-1], outs[:-1]))):
                fail(f"{name} differs from the single-model entry on the "
                     "timing batch")
        sub, rs = plain_subset(sl, list(plain_models))
        ds, ls = d[rs].contiguous(), lt[rs].contiguous()
        want = []
        p_ms = once_ms(lambda: want.append(
            getattr(mm, call.__name__ + "_ref")(pack, ds, ls, sl[sub],
                                                *extra)))
        got = tuple(t[rs] for t in outs)
        err = vs_plain(name, got if len(outs) > 1 else got[0], want[0])
        plain_items[name] = len(sub)
        mq_err[name] = max(mq_err[name], err)
        cells = float((ln[order] * Ms[sl]).sum())
        tabs = [t for c in pack.classes.values() for t in (c.etab, c.ttab)]
        times[name] = (k_ms, p_ms, *bound(name, cells,
                                          nbytes(d, lt, *tabs, *outs)))
        phase("timing", kernel=name, models=len(split), B=len(items),
              mean_L=f"{ln.mean():.1f}", max_L=int(ln.max()),
              launches_per_call=len(pack.classes), ms=f"{k_ms:.4f}",
              per_model_launches_ms=f"{s_ms:.4f}", plain_ms=f"{p_ms:.2f}",
              plain_items=len(sub),
              plain_models=len(set(sl[sub].tolist())), vs_plain=err,
              tol=DOMDEC_TOL if len(outs) > 1 else FWD_TOL,
              single_model_entry="agrees",
              gcups=f"{cells / k_ms / 1e6:.2f}",
              bound_ms=f"{times[name][2]:.5f}", bound_by=times[name][3],
              card=repr(card))

    time_multi("fwd_parser_multi", std_pack,
               fixtures.sample_orfs(fx.fasta_path, TIME_MQ_FWD_B, SEED),
               mq_rng.integers(0, len(MQ_MS), TIME_MQ_FWD_B), 28,
               mm.fwd_pack_scores, fwd.fwd_score, 10)
    time_multi("domdec_multi", std_pack,
               fixtures.sample_orfs(fx.fasta_path, TIME_MQ_DOMDEC_B, SEED,
                                    min_len=100),
               mq_rng.integers(0, len(MQ_MS), TIME_MQ_DOMDEC_B), 28,
               mm.domdec_pack_batch, dd.domdec, 5,
               plain_models=TIME_MQ_PLAIN_DOMDEC)
    time_multi("fs3_parser_multi", fs_pack, windows, fs_slot, 17,
               mm.fs3_pack_scores, fs3.fs3_score, 3,
               plain_models=TIME_MQ_PLAIN_FS3)
    time_multi("fs3_domdec_multi", fs_pack, dd_windows, dd_slot, 17,
               mm.fs3_domdec_pack_batch, fdd.fs3_domdec, 2,
               extra=(100.0 / 103.0,), plain_models=TIME_MQ_PLAIN_FS3DD)

    # 4f. the two integer multi-model entries at the device
    # calibration's shapes: the 48 models, each over the one shared
    # batch of 200 x 200 aa (item b = model b // 200, sequence b % 200,
    # read at a repeated offset).  Each equal to its plain version and,
    # model by model, to the single-model entry and to the native host
    # batch; timed beside one single-model launch per model and the host
    # batches.
    from bath_tpu_torch import evalues_device as ed
    from bath_tpu_torch.evalues import CalibrateConfig
    from bath_tpu_torch.oprofile import oprofile_convert
    from bath_tpu_torch.profile import profile_config
    ccfg = CalibrateConfig(fs=True)
    cal_draws = ed.shared_draws(ccfg, Background())
    cal_oms = [oprofile_convert(profile_config(h, Background(), L=ccfg.EvL))
               for h in mq_hmms]

    cal_err: dict = {}

    def int_multi(name, batch, make, build_pack, word_for, call, ref, single,
                  scores, native):
        N, L = batch.shape
        params = [make(om_g, dev) for om_g in cal_oms]
        pack = build_pack(params)
        flat, offs, lens, slot = ed.shared_stream(batch, len(cal_oms), dev)
        word = ed.per_model_words([word_for(p_g, L) for p_g in params], N,
                                  dev)
        args = (flat, offs, lens, word)
        got = call(pack, *args, slot)
        want = []
        p_ms = once_ms(lambda: want.append(ref(pack, *args, slot)))
        if not all(torch.equal(a, b) for a, b in zip(got, want[0])):
            fail(f"{name} differs from its plain version: max |d| "
                 f"{exact(got, want[0])}")
        cal_err[name] = exact(got, want[0])
        split = [(params[g], r, offs[r].contiguous(), lens[r].contiguous(),
                  word[r].contiguous()) for g, r in model_rows(slot)]
        host = host_layout(list(batch))
        for g, (p_g, r, o_g, l_g, w_g) in enumerate(split):
            one = single(flat, o_g, l_g, w_g, p_g)
            if not all(torch.equal(a, b[r]) for a, b in zip(one, got)):
                fail(f"{name} differs from the single-model entry at "
                     f"M={MQ_MS[g]}")
            if not np.array_equal(scores(one, w_g, p_g),
                                  native(host, cal_oms[g])
                                  .astype(np.float32)):
                fail(f"{name} differs from the native host batch at "
                     f"M={MQ_MS[g]}")
        k_ms = cuda_ms(lambda: call(pack, *args, slot), 10)
        s_ms = cuda_ms(lambda: [single(flat, o_g, l_g, w_g, p_g)
                                for p_g, _, o_g, l_g, w_g in split], 5)
        h_ms = host_ms(lambda: [native(host, om_g) for om_g in cal_oms])
        cells = float(N * L * Ms.sum())
        tabs = [t for c in pack.classes.values() for t in (c.tab, c.scal)]
        times[name] = (k_ms, p_ms, *bound(name, cells,
                                          nbytes(*args, *tabs, *got)))
        plain_items[name] = len(slot)
        phase("timing", kernel=name, models=len(cal_oms),
              M=f"{min(MQ_MS)}..{max(MQ_MS)}", widths=sorted(pack.classes),
              B=len(slot), batch=f"{N}x{L}", vs_plain="identical",
              max_abs_err=cal_err[name],
              single_model_entry="bit for bit", native_host_batch="identical",
              launches_per_call=len(pack.classes), ms=f"{k_ms:.4f}",
              per_model_launches_ms=f"{s_ms:.4f}", plain_ms=f"{p_ms:.2f}",
              host_native_batches_ms=f"{h_ms:.2f}", host_cores=os.cpu_count(),
              gcups=f"{cells / k_ms / 1e6:.2f}",
              bound_ms=f"{times[name][2]:.5f}", bound_by=times[name][3],
              card=repr(card))

    def msv_nats(raw, tjb_g, p_g):
        out_int, out_inf = (t.cpu().numpy()
                            for t in ssv.msv_post(*raw, tjb_g, p_g))
        sc = np.float32((out_int.astype(np.float64) - float(p_g.base))
                        / p_g.scale - 3.0)
        return np.where(out_inf, np.float32(np.inf), sc).astype(np.float32)

    def vit_nats(raw, _move, p_g):
        score, has, ovf = (t.cpu().numpy() for t in raw)
        sc = np.float32((score.astype(np.float64) - float(p_g.base))
                        / p_g.scale - 3.0)
        sc = np.where(has, sc, np.float32(-np.inf))
        return np.where(ovf, np.float32(np.inf), sc).astype(np.float32)

    int_multi("msv_filter_multi", cal_draws.msv, ssv.msv_params,
              mm.build_msv_pack, lambda p_g, L: p_g.tjb_for([L])[0],
              mm.msv_ssv_multi, mm.msv_ssv_multi_ref, ssv.msv_ssv, msv_nats,
              msv_filter_native_batch)
    int_multi("vit_filter_multi", cal_draws.vit, vit.vit_params,
              mm.build_vit_pack, lambda p_g, L: p_g.move_for([L])[0],
              mm.vit_ints_multi, mm.vit_ints_multi_ref, vit.vit_ints,
              vit_nats,
              lambda h, om_g: vit_filter_score_batch(
                  h, np.arange(len(h)), om_g))

    # 5. end to end: the port's CLI against the host path, in turns
    # (numpy, torch, torch, numpy); --backend numpy is the port's own
    # serial host drive.  The first torch run is the one whose kernel
    # launches are counted.
    walls: dict = {"torch": [], "numpy": []}

    def search(backend, stats=None):
        stem = f"e2e_{backend}{len(walls[backend])}"
        out, tbl = BUILD / f"{stem}.out", BUILD / f"{stem}.tbl"
        t = time.perf_counter()
        rc = bathsearch.run(["--backend", backend, "--device", DEVICE,
                             "--tblout", str(tbl), "-o", str(out),
                             fx.hmm_path, fx.fasta_path], stats=stats)
        torch.cuda.synchronize()
        walls[backend].append(time.perf_counter() - t)
        if rc != 0:
            fail(f"{backend} bathsearch exited {rc}")
        return out, tbl

    out_n, tbl_n = search("numpy")
    stats: dict = {}
    fwd.fwd_score.launches = 0
    dd.domdec.launches = 0
    out_t, tbl_t = search("torch", stats)
    launches = {"fwd_parser": fwd.fwd_score.launches,
                "domdec": dd.domdec.launches}
    search("torch")
    search("numpy")

    def masked(path):
        return re.sub(r"# (CPU time|Mc/sec):.*", "", path.read_text())
    identical = masked(out_t) == masked(out_n)
    found_t = fixtures.embeds_found(str(tbl_t), fx)
    found_n = fixtures.embeds_found(str(tbl_n), fx)
    ok_share = stats["domdec_ok"] / max(1, stats["domdec_items"])
    wall_t, wall_n = (float(np.mean(walls[b])) for b in ("torch", "numpy"))
    phase("e2e", genome_nt=GENOME_NT, M=M_SEARCH, embeds=N_EMBEDS,
          found_torch=found_t, found_numpy=found_n,
          byte_identical=identical,
          walls_torch_s=",".join(f"{w:.4f}" for w in walls["torch"]),
          walls_numpy_s=",".join(f"{w:.4f}" for w in walls["numpy"]),
          mb_per_s_torch=f"{GENOME_NT / 1e6 / wall_t:.3f}",
          mb_per_s_numpy=f"{GENOME_NT / 1e6 / wall_n:.3f}",
          cascade_fwd_s=f"{stats['fwd_s']:.4f}",
          cascade_domdec_s=f"{stats['domdec_s']:.4f}",
          f3_candidates=stats["fwd_items"],
          f3_survivors=stats["domdec_items"],
          device_ok=stats["domdec_ok"], ok_share=f"{ok_share:.4f}",
          launches=launches)
    if not identical:
        fail("torch output differs from the numpy backend")
    if found_t < MIN_FOUND:
        fail(f"only {found_t}/{N_EMBEDS} embeds reported")
    if min(launches.values()) <= 0:
        fail(f"a kernel of the path never launched: {launches}")
    if ok_share < MIN_OK_SHARE:
        fail(f"device ok share {ok_share} < {MIN_OK_SHARE}")

    # 5b. --fs and --fsonly on the frameshift twin of the genome: --fs
    # in turns (numpy, torch, torch, numpy), --fsonly once each; the
    # first torch --fs run is the one whose launches are counted
    fs_fx = fixtures.write_fixture(M_SEARCH, GENOME_NT, N_EMBEDS, SEED,
                                   fs=True, n_frameshift=N_FRAMESHIFT)
    fs_walls: dict = {}

    def fs_search(backend, mode, stats=None):
        runs = fs_walls.setdefault((backend, mode), [])
        stem = BUILD / f"e2e{mode.replace('-', '_')}_{backend}{len(runs)}"
        paths = [stem.with_suffix(x) for x in (".out", ".tbl", ".fst")]
        t = time.perf_counter()
        rc = bathsearch.run(["--backend", backend, "--device", DEVICE, mode,
                             "-o", str(paths[0]), "--tblout", str(paths[1]),
                             "--fstblout", str(paths[2]), fs_fx.hmm_path,
                             fs_fx.fasta_path], stats=stats)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t)
        if rc != 0:
            fail(f"{backend} bathsearch {mode} exited {rc}")
        return paths

    def fs_masked(paths):
        return (masked(paths[0]),
                "".join(ln for ln in paths[2].read_text().splitlines(True)
                        if not ln.startswith("#")))

    fs_n = fs_search("numpy", "--fs")
    fs_stats: dict = {}
    for f in (fwd.fwd_score, dd.domdec, fs3.fs3_score, fdd.fs3_domdec):
        f.launches = 0
    fs_t = fs_search("torch", "--fs", fs_stats)
    # under --fs the host decodes the standard branch's F3 survivors
    # with the fs windows (pipeline.py:737), so domdec is not on this
    # path: its count is printed, not required
    fs_launches = {"fwd_parser": fwd.fwd_score.launches,
                   "fs3_parser": fs3.fs3_score.launches,
                   "fs3_domdec": fdd.fs3_domdec.launches}
    fs_domdec_launches = dd.domdec.launches
    fs_search("torch", "--fs")
    fs_search("numpy", "--fs")
    only_n = fs_search("numpy", "--fsonly")
    only_stats: dict = {}
    for f in (fwd.fwd_score, dd.domdec, fs3.fs3_score, fdd.fs3_domdec):
        f.launches = 0
    only_t = fs_search("torch", "--fsonly", only_stats)
    only_launches = {"fwd_parser": fwd.fwd_score.launches,
                     "fs3_parser": fs3.fs3_score.launches,
                     "fs3_domdec": fdd.fs3_domdec.launches}
    fs_identical = fs_masked(fs_t) == fs_masked(fs_n)
    only_identical = fs_masked(only_t) == fs_masked(only_n)
    fs_found = fixtures.embeds_found(str(fs_t[1]), fs_fx)
    shifts = fixtures.frameshifts_found(str(fs_t[2]), fs_fx)
    only_shifts = fixtures.frameshifts_found(str(only_t[2]), fs_fx)
    fs_ok = fs_stats["fs3domdec_ok"] / max(1, fs_stats["fs3domdec_items"])
    fw_t, fw_n = (float(np.mean(fs_walls[(b, "--fs")]))
                  for b in ("torch", "numpy"))
    phase("e2e_fs", genome_nt=GENOME_NT, M=M_SEARCH, embeds=N_EMBEDS,
          frameshifted=N_FRAMESHIFT, found_torch=fs_found,
          frameshifts_found=shifts, byte_identical=fs_identical,
          walls_torch_s=",".join(f"{w:.4f}" for w in
                                 fs_walls[("torch", "--fs")]),
          walls_numpy_s=",".join(f"{w:.4f}" for w in
                                 fs_walls[("numpy", "--fs")]),
          mb_per_s_torch=f"{GENOME_NT / 1e6 / fw_t:.3f}",
          mb_per_s_numpy=f"{GENOME_NT / 1e6 / fw_n:.3f}",
          cascade_fwd_s=f"{fs_stats['fwd_s']:.4f}",
          cascade_domdec_s=f"{fs_stats['domdec_s']:.4f}",
          cascade_fs3_s=f"{fs_stats['fs3_s']:.4f}",
          cascade_fs3domdec_s=f"{fs_stats['fs3domdec_s']:.4f}",
          fs3_windows=fs_stats["fs3_items"],
          fs3_survivors=fs_stats["fs3domdec_items"],
          fs3_device_ok=fs_stats["fs3domdec_ok"], ok_share=f"{fs_ok:.4f}",
          launches=fs_launches, domdec_launches=fs_domdec_launches)
    phase("e2e_fsonly", byte_identical=only_identical,
          frameshifts_found=only_shifts,
          wall_torch_s=f"{fs_walls[('torch', '--fsonly')][0]:.4f}",
          wall_numpy_s=f"{fs_walls[('numpy', '--fsonly')][0]:.4f}",
          cascade_fs3_s=f"{only_stats['fs3_s']:.4f}",
          cascade_fs3domdec_s=f"{only_stats['fs3domdec_s']:.4f}",
          fs3_windows=only_stats["fs3_items"],
          fs3_survivors=only_stats["fs3domdec_items"],
          fs3_device_ok=only_stats["fs3domdec_ok"], launches=only_launches,
          domdec_launches=dd.domdec.launches)
    if not (fs_identical and only_identical):
        fail(f"torch --fs/--fsonly output differs from the numpy backend "
             f"(--fs {fs_identical}, --fsonly {only_identical})")
    if fs_found < MIN_FOUND:
        fail(f"--fs: only {fs_found}/{N_EMBEDS} embeds reported")
    if shifts < MIN_FS_FOUND:
        fail(f"--fs: only {shifts}/{N_FRAMESHIFT} frameshifted embeds in "
             "--fstblout")
    if min(fs_launches.values()) <= 0 or min(only_launches.values()) <= 0:
        fail(f"a kernel of the --fs path never launched: {fs_launches}, "
             f"--fsonly {only_launches}")
    if fs_ok < MIN_OK_SHARE:
        fail(f"fs3 device ok share {fs_ok} < {MIN_OK_SHARE}")

    # 5c. the all-device cascade (BATH_MSV_DEVICE=1 BATH_VIT_DEVICE=1):
    # standard twice against the numpy run of phase 5, --fs once against
    # phase 5b's, then standard with LOOSE filter thresholds against a
    # numpy run of its own; each run's launches are counted from 0, and
    # the first run (the main path) must launch all four kernels
    int_fns = {"msv_filter": ssv.msv_ssv, "ssv_capture": ssv.ssv_capture,
               "vit_filter": vit.vit_ints, "vit_capture": vit.vit_capture}
    saved = {k: os.environ.get(k) for k in ALL_DEVICE}
    os.environ.update(ALL_DEVICE)
    ad_walls, ad_stats, ad_launches = [], [], []

    def all_device(extra, stem, fxr):
        st: dict = {}
        for f in int_fns.values():
            f.launches = 0
        paths = [BUILD / f"{stem}.{x}" for x in ("out", "tbl", "fst")]
        t = time.perf_counter()
        rc = bathsearch.run(["--backend", "torch", "--device", DEVICE,
                             *extra, "-o", str(paths[0]), "--tblout",
                             str(paths[1]), "--fstblout", str(paths[2]),
                             fxr.hmm_path, fxr.fasta_path], stats=st)
        torch.cuda.synchronize()
        ad_walls.append(time.perf_counter() - t)
        if rc != 0:
            fail(f"all-device bathsearch {extra} exited {rc}")
        ad_launches.append({k: f.launches for k, f in int_fns.items()})
        ad_stats.append(st)
        return paths

    ad0 = all_device([], "ad0", fx)
    int_launches = ad_launches[0]
    ad1 = all_device([], "ad1", fx)
    ad_fs = all_device(["--fs"], "ad_fs", fs_fx)
    ad_loose = all_device(LOOSE, "ad_loose", fx)
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    rc = bathsearch.run(["--backend", "numpy", *LOOSE, "-o",
                         str(BUILD / "ad_loose_numpy.out"), fx.hmm_path,
                         fx.fasta_path])
    if rc != 0:
        fail(f"numpy bathsearch {LOOSE} exited {rc}")
    ad_identical = {
        "standard": masked(ad0[0]) == masked(out_n),
        "standard_again": masked(ad1[0]) == masked(out_n),
        "fs": fs_masked(ad_fs) == fs_masked(fs_n),
        "loose": masked(ad_loose[0]) == masked(BUILD /
                                               "ad_loose_numpy.out")}
    ad_found = fixtures.embeds_found(str(ad0[1]), fx)
    for tag, st, w, n in zip(("standard", "standard_again", "fs", "loose"),
                             ad_stats, ad_walls, ad_launches):
        phase("e2e_all_device", run=tag, wall_s=f"{w:.4f}",
              **{k: (f"{v:.4f}" if isinstance(v, float) else v)
                 for k, v in st.items()
                 if k.split("_")[0] in ("msv", "ssvcap", "vit", "vitcap")},
              launches=n)
    phase("e2e_all_device", genome_nt=GENOME_NT, M=M_SEARCH,
          found_torch=ad_found, byte_identical=ad_identical,
          walls_all_device_s=",".join(f"{w:.4f}" for w in ad_walls[:2]),
          walls_hybrid_torch_s=",".join(f"{w:.4f}" for w in walls["torch"]),
          walls_numpy_s=",".join(f"{w:.4f}" for w in walls["numpy"]),
          fs_wall_all_device_s=f"{ad_walls[2]:.4f}",
          fs_walls_hybrid_torch_s=",".join(
              f"{w:.4f}" for w in fs_walls[("torch", "--fs")]),
          launches=int_launches,
          ssvcap_host_rescans=ad_stats[0]["ssvcap_overflow"])
    if not all(ad_identical.values()):
        fail(f"all-device output differs from the numpy backend: "
             f"{ad_identical}")
    if ad_found < MIN_FOUND:
        fail(f"all-device: only {ad_found}/{N_EMBEDS} embeds reported")
    if min(int_launches.values()) <= 0:
        fail(f"an integer-filter kernel never launched in the all-device "
             f"search: {int_launches}")

    # 5d. the multi-query drive: the 48-model query file against a
    # 5 Mb genome with MQ_COPIES copies of each of 12 of the models
    # (under --fs the first copy of each frameshifted), --backend torch
    # (one pass over the genome, the four multi-model kernels) against
    # the port's --backend numpy (the serial per-query host drive), in
    # turns; the first torch run of each mode is the one whose launches
    # are counted.  Compared query by query: -o with its CPU-time lines
    # masked, --tblout and --fstblout without their '#' lines.
    def rows(path):
        return "".join(ln for ln in path.read_text().splitlines(True)
                       if not ln.startswith("#"))

    def mq_drive(mode, turns, fixture):
        walls: dict = {"torch": [], "numpy": [], "torch_host": []}
        first: dict = {}
        stats: dict = {}
        host_stats: dict = {}
        launches = None
        fns = {"fwd_parser_multi": mm.fwd_pack_scores,
               "domdec_multi": mm.domdec_pack_batch,
               "fs3_parser_multi": mm.fs3_pack_scores,
               "fs3_domdec_multi": mm.fs3_domdec_pack_batch}
        for backend in turns:
            stem = BUILD / (f"mq{''.join(mode).replace('-', '_')}_{backend}"
                            f"{len(walls[backend])}")
            paths = [stem.with_suffix(x) for x in (".out", ".tbl", ".fst")]
            counted = backend == "torch" and launches is None
            st = stats if counted else \
                host_stats if backend == "torch_host" else {}
            if counted:
                for f in fns.values():
                    f.launches = 0
            if backend == "torch_host":
                os.environ.update(dict.fromkeys(MQ_MIN_CELLS, "inf"))
            t = time.perf_counter()
            rc = bathsearch.run(
                ["--backend", backend.split("_")[0], "--device", DEVICE,
                 *mode, "-o", str(paths[0]), "--tblout", str(paths[1]),
                 "--fstblout", str(paths[2]), fixture.hmm_path,
                 fixture.fasta_path], stats=st)
            torch.cuda.synchronize()
            walls[backend].append(time.perf_counter() - t)
            for k in MQ_MIN_CELLS:
                os.environ.pop(k, None)
            if counted:
                launches = {k: f.launches for k, f in fns.items()}
            if rc != 0:
                fail(f"{backend} multi-query bathsearch {mode} exited {rc}")
            first.setdefault(backend, paths)
        t_out = masked(first["torch"][0]).split("//\n")
        n_out = masked(first["numpy"][0]).split("//\n")
        differ = [q for q, (a, b) in enumerate(zip(t_out, n_out)) if a != b]
        identical = {
            "out": not differ and len(t_out) == len(n_out) == len(MQ_MS) + 1,
            "tblout": rows(first["torch"][1]) == rows(first["numpy"][1]),
            "fstblout": rows(first["torch"][2]) == rows(first["numpy"][2])}
        if "torch_host" in first:
            identical["host_stages"] = masked(first["torch_host"][0]) \
                == masked(first["numpy"][0])
        found = fixtures.multi_embeds_found(str(first["torch"][1]), fixture)
        tag = "e2e_multiquery" + "".join(mode).replace("--", "_")
        for stage, items, cells, secs in stats["mq_stages"]:
            phase(tag, flush_stage=stage, items=items, cells=cells,
                  host_wall_s=f"{secs:.4f}")
        phase(tag, genome_nt=GENOME_NT, models=len(MQ_MS),
              M=f"{min(MQ_MS)}..{max(MQ_MS)}",
              embedded_models=len(MQ_EMBEDDED), copies=MQ_COPIES,
              found=f"{sum(found.values())}/{MQ_COPIES * len(MQ_EMBEDDED)}",
              byte_identical=identical, queries_differing=differ,
              walls_torch_s=",".join(f"{w:.3f}" for w in walls["torch"]),
              walls_numpy_s=",".join(f"{w:.3f}" for w in walls["numpy"]),
              walls_torch_host_stages_s=",".join(
                  f"{w:.3f}" for w in walls["torch_host"]),
              phase_s={k: round(v, 3)
                       for k, v in stats["mq_phase_s"].items()},
              phase_host_stages_s={
                  k: round(v, 3)
                  for k, v in host_stats.get("mq_phase_s", {}).items()},
              **{k: (round(v, 4) if isinstance(v, float) else v)
                 for k, v in stats.items()
                 if k not in ("mq_stages", "mq_phase_s")},
              launches=launches, card=repr(card))
        if "torch_host" in turns and (not host_stats or any(
                host_stats.get(f"{k}_items")
                for k in ("fwd", "domdec", "fs3", "fs3domdec"))):
            fail(f"multi-query {mode}: a stage reached the card with its "
                 f"threshold out of reach: {host_stats}")
        if not all(identical.values()):
            fail(f"multi-query {mode} output differs from the numpy "
                 f"backend: {identical}, queries {differ}")
        if sum(found.values()) < 0.75 * MQ_COPIES * len(MQ_EMBEDDED):
            fail(f"multi-query {mode}: only {found} embeds reported")
        return launches, stats, first

    # (the fixtures' 48 models are calibrated in one pass on the card:
    # phase 5e holds that calibration against the host's)
    mq_fx = fixtures.write_multi_fixture(MQ_MS, GENOME_NT, MQ_EMBEDDED,
                                         MQ_COPIES, SEED, device=DEVICE)
    mq_launches, mq_stats, _ = mq_drive([], MQ_TURNS, mq_fx)
    mq_fs_fx = fixtures.write_multi_fixture(MQ_MS, GENOME_NT, MQ_EMBEDDED,
                                            MQ_COPIES, SEED, fs=True,
                                            device=DEVICE)
    mq_fs_launches, mq_fs_stats, mq_fs_paths = mq_drive(
        ["--fs"], MQ_FS_TURNS, mq_fs_fx)
    mq_shifts = fixtures.multi_frameshifts_found(
        str(mq_fs_paths["torch"][2]), mq_fs_fx)
    phase("e2e_multiquery_fs", frameshifts_found=f"{sum(mq_shifts.values())}"
          f"/{len(MQ_EMBEDDED)}")
    if sum(mq_shifts.values()) < 0.75 * len(MQ_EMBEDDED):
        fail(f"multi-query --fs: only {mq_shifts} frameshifted copies in "
             "--fstblout")
    # the standard drive decodes on the device (domdec_multi); under
    # --fs the host decodes the standard branch with the fs windows, as
    # in the single-query drive, and the fs3 pair runs
    mq_counts = {"fwd_parser_multi": mq_launches["fwd_parser_multi"],
                 "domdec_multi": mq_launches["domdec_multi"],
                 "fs3_parser_multi": mq_fs_launches["fs3_parser_multi"],
                 "fs3_domdec_multi": mq_fs_launches["fs3_domdec_multi"]}
    if min(mq_counts.values()) <= 0:
        fail(f"a multi-model kernel never launched in the multi-query "
             f"drives: {mq_counts} (standard {mq_launches}, --fs "
             f"{mq_fs_launches})")
    for st, key in ((mq_stats, "domdec"), (mq_fs_stats, "fs3domdec")):
        share = st[f"{key}_ok"] / max(1, st[f"{key}_items"])
        if share < MIN_OK_SHARE:
            fail(f"multi-query {key} ok share {share} < {MIN_OK_SHARE}")

    # 5e. bathbuild and bathconvert: --backend torch (host builds, then
    # all 48 models calibrated in one device-batched pass), in this
    # process, against --backend numpy (the serial host calibration):
    # bathbuild's ran in the child process of phase 1b, bathconvert's
    # runs here, just before the torch one.
    # The files may differ in their DATE line and in the taus of the
    # f32 gates' STATS lines (within TAU_TOL), nowhere else: the MSV and
    # VITERBI lines come from the bit-exact integer entries, the FS5
    # line from the same host parser.
    from bath_tpu_torch.cli import bathbuild, bathconvert, bathfetch, \
        bathstat
    import contextlib
    import io
    cal_fns = {"msv_filter_multi": mm.msv_ssv_multi,
               "vit_filter_multi": mm.vit_ints_multi,
               "fwd_parser_multi": mm.fwd_pack_scores,
               "fs3_parser_multi": mm.fs3_pack_scores}

    def tool(main, argv, **kw):
        """(stdout, wall) of one CLI call; the launch counts start at 0."""
        for f in cal_fns.values():
            f.launches = 0
        out = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = main([str(a) for a in argv], **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        if rc:
            fail(f"{main.__module__} {argv} exited {rc}")
        return mask_tool(out.getvalue()), wall

    def model_diff(a, b, allowed, what):
        """The largest tau difference between two model files that may
        differ only in their DATE lines and in the tau of the <allowed>
        STATS lines; fails on any other difference or past TAU_TOL."""
        la, lb = (["" if ln.startswith("DATE") else ln
                   for ln in Path(x).read_text().splitlines()]
                  for x in (a, b))
        if len(la) != len(lb):
            fail(f"{what}: {len(la)} lines against {len(lb)}")
        worst, n = 0.0, 0
        for x, y in zip(la, lb):
            if x == y:
                continue
            fx, fy = x.split(), y.split()
            if not (x.startswith(allowed) and y.startswith(allowed)
                    and fx[:-2] == fy[:-2] and fx[-1] == fy[-1]):
                fail(f"{what}: the files differ outside the f32 gates' "
                     f"taus: {x!r} against {y!r}")
            worst = max(worst, abs(float(fx[-2]) - float(fy[-2])))
            n += 1
        if worst > TAU_TOL:
            fail(f"{what}: a tau differs by {worst} > {TAU_TOL}")
        return worst, n

    def stats_lines(path, key):
        return sum(ln.startswith(f"STATS LOCAL {key}")
                   for ln in Path(path).read_text().splitlines())

    build_stats: dict = {}
    build_table, build_wall = tool(
        bathbuild.main, ["--backend", "torch", "--device", DEVICE,
                         built["torch"], sto], stats=build_stats)
    build_launches = {k: f.launches for k, f in cal_fns.items()}
    build_err, build_ndiff = model_diff(built["torch"], built["numpy"],
                                        F32_GATE_LINES, "bathbuild")
    phase("bathbuild", alignments=len(MQ_MS), nseq=MSA_NSEQ,
          M=f"{min(MQ_MS)}..{max(MQ_MS)}", fs=True,
          calibration="200x200 aa (MSV, Viterbi), 200x100 aa (Forward), "
          "200x300 nt (fs3, fs5)",
          wall_numpy_s=f"{build_wall_numpy:.3f}",
          wall_numpy_concurrent=True,
          wall_torch_s=f"{build_wall:.3f}",
          **{k: (round(v, 4) if isinstance(v, float) else v)
             for k, v in build_stats.items()},
          msv_viterbi_fs5_lines="equal as text",
          gate_tau_lines_differing=build_ndiff,
          max_tau_diff=f"{build_err:.4f}", tau_warn=TAU_WARN, tau_tol=TAU_TOL,
          within_warn=build_err <= TAU_WARN,
          tables_identical=build_table == build_table_numpy,
          launches=build_launches, card=repr(card))
    if build_table != build_table_numpy:
        fail("bathbuild's tables differ between the backends")
    if stats_lines(built["torch"], "FS5") != len(MQ_MS) \
            or build_stats.get("cal_fs_serial"):
        fail(f"bathbuild: {stats_lines(built['torch'], 'FS5')} models with "
             f"frameshift taus, {build_stats.get('cal_fs_serial')} through "
             "the serial fallback")
    if min(build_launches.values()) <= 0:
        fail(f"a kernel of the calibration never launched in bathbuild: "
             f"{build_launches}")

    # bathconvert on the numpy-built models without their frameshift
    # calibration: only the fs3 rows may differ
    conv_in = fixtures.write_convert_input(str(built["numpy"]),
                                           str(BUILD / "convert_in.bhmm"))
    conv = {b: BUILD / f"converted_{b}.bhmm" for b in ("numpy", "torch")}
    conv_table_numpy, conv_wall_numpy = tool(
        bathconvert.main, ["--backend", "numpy", conv["numpy"], conv_in])
    conv_stats: dict = {}
    conv_table, conv_wall = tool(
        bathconvert.main, ["--backend", "torch", "--device", DEVICE,
                           conv["torch"], conv_in], stats=conv_stats)
    conv_launches = {"fs3_parser_multi": mm.fs3_pack_scores.launches}
    conv_err, conv_ndiff = model_diff(conv["torch"], conv["numpy"],
                                      F32_GATE_LINES[1:], "bathconvert")
    phase("bathconvert", models=len(MQ_MS),
          wall_numpy_s=f"{conv_wall_numpy:.3f}",
          wall_numpy_concurrent=False,
          wall_torch_s=f"{conv_wall:.3f}",
          **{k: (round(v, 4) if isinstance(v, float) else v)
             for k, v in conv_stats.items()},
          fs3_lines_differing=conv_ndiff, max_tau_diff=f"{conv_err:.4f}",
          tau_tol=TAU_TOL,
          tables_identical=conv_table == conv_table_numpy,
          launches=conv_launches, card=repr(card))
    if conv_table != conv_table_numpy:
        fail("bathconvert's tables differ between the backends")
    if stats_lines(conv["torch"], "FS3") != len(MQ_MS):
        fail("bathconvert left models without frameshift taus")
    if conv_launches["fs3_parser_multi"] <= 0:
        fail("bathconvert never launched the fs3 gate")

    # bathstat and bathfetch on both built files: nothing they print
    # holds a tau, so the output is the same (the fetched model but for
    # its gate taus).  The fetched model, as an HMMER3/f file without
    # frameshift calibration, through bathconvert on both backends in
    # this process.
    stat = {b: tool(bathstat.main, [built[b]])[0] for b in built}
    fetched = {}
    for b in built:
        tool(bathfetch.main, ["--index", built[b]])
        fetched[b] = BUILD / f"fetched_{b}.bhmm"
        tool(bathfetch.main, ["-o", fetched[b], built[b], msa_names[29]])
    fetch_err, _ = model_diff(fetched["torch"], fetched["numpy"],
                              F32_GATE_LINES, "bathfetch")
    h3_in = fixtures.write_convert_input(str(fetched["numpy"]),
                                         str(BUILD / "fetched.hmm"),
                                         hmmer3=True)
    for b in built:
        tool(bathconvert.main, ["--backend", b, "--device", DEVICE,
                                BUILD / f"fetched_h3_{b}.bhmm", h3_in])
    h3_err, _ = model_diff(BUILD / "fetched_h3_torch.bhmm",
                           BUILD / "fetched_h3_numpy.bhmm",
                           F32_GATE_LINES[1:], "bathconvert of HMMER3/f")
    phase("bathstat_bathfetch", bathstat_identical=stat["torch"] ==
          stat["numpy"], rows=len(stat["torch"].splitlines()),
          fetched=msa_names[29], fetched_tau_diff=f"{fetch_err:.4f}",
          fetched_as_hmmer3_converted_tau_diff=f"{h3_err:.4f}")
    if stat["torch"] != stat["numpy"] \
            or len(stat["torch"].splitlines()) < len(MQ_MS):
        fail("bathstat differs between the torch- and the numpy-built file")

    # one bathsearch --fs of the multi-query genome (copies of 12 of the
    # proteins the alignments were emitted from) with either file: the
    # same hits
    def hit_set(tbl):
        hits = set()
        for ln in Path(tbl).read_text().splitlines():
            if ln and not ln.startswith("#"):
                cols = ln.split()
                hits.add((cols[3], cols[9], cols[10]))
        return hits

    hits, search_walls = {}, {}
    for b in built:
        tbl = BUILD / f"built_{b}_search.tbl"
        t = time.perf_counter()
        rc = bathsearch.run(["--backend", "torch", "--device", DEVICE,
                             "--fs", "-o", str(tbl.with_suffix(".out")),
                             "--tblout", str(tbl), str(built[b]),
                             mq_fs_fx.fasta_path])
        torch.cuda.synchronize()
        search_walls[b] = time.perf_counter() - t
        if rc != 0:
            fail(f"bathsearch --fs with the {b}-built file exited {rc}")
        hits[b] = hit_set(tbl)
    phase("bathsearch_with_built_models", genome_nt=GENOME_NT,
          models=len(MQ_MS), hits_torch_built=len(hits["torch"]),
          hits_numpy_built=len(hits["numpy"]),
          same_hits=hits["torch"] == hits["numpy"],
          queries_with_hits=len({h[0] for h in hits["torch"]}),
          walls_s=",".join(f"{search_walls[b]:.3f}" for b in built))
    if hits["torch"] != hits["numpy"]:
        fail(f"bathsearch --fs reports other hits with the torch-built "
             f"file: {sorted(hits['torch'] ^ hits['numpy'])[:10]}")
    if len({h[0] for h in hits["torch"]}) < 0.75 * len(MQ_EMBEDDED):
        fail(f"the built models find only {len(hits['torch'])} hits of "
             f"{len(MQ_EMBEDDED)} embedded proteins")

    # 6. the record
    csrc = "bath_tpu_torch/ops/kernels/csrc/"

    def entry(name, src, replaces, n, err, t):
        # no single PyTorch call computes any of these DPs
        return {"name": name, "route": "cuda", "source": csrc + src,
                "replaces": replaces, "launches": n, "max_abs_err": err,
                "ms": t[0], "plain_ms": t[1], "bound_ms": t[2],
                "bound_by": t[3], "library_ms": None}

    kernels = [
        entry("fwd_parser", "fwd_parser.cu", "bath_tpu/ops/pallas/fwd.py:32",
              launches["fwd_parser"], fwd_err, times[("fwd", TIME_FWD_M[0])]),
        entry("domdec", "domdec.cu", "bath_tpu/ops/jaxk/kernels.py:988",
              launches["domdec"], dd_err, times["domdec"]),
        entry("fs3_parser", "fs3_parser.cu", "bath_tpu/ops/pallas/fs3.py:69",
              fs_launches["fs3_parser"], fs3_err,
              times[("fs3", TIME_FS3_M[1])]),
        entry("fs3_domdec", "fs3_domdec.cu",
              "bath_tpu/ops/jaxk/kernels.py:1235",
              fs_launches["fs3_domdec"], fs3dd_err, times["fs3_domdec"]),
    ]
    for name, src, replaces in (
            ("msv_filter", "msv_filter.cu", "bath_tpu/ops/pallas/ssv.py:30"),
            ("ssv_capture", "ssv_capture.cu",
             "bath_tpu/ops/jaxk/filters_mb.py:623"),
            ("vit_filter", "vit_filter.cu", "bath_tpu/ops/pallas/vit.py:64"),
            ("vit_capture", "vit_filter.cu",
             "bath_tpu/ops/jaxk/filters_mb.py:304")):
        kernels.append(entry(name, src, replaces, int_launches[name],
                             int_err[name], times[name]))
    for name, src, line in (("fwd_parser_multi", "fwd_parser.cu", 171),
                            ("domdec_multi", "domdec.cu", 220),
                            ("fs3_parser_multi", "fs3_parser.cu", 263),
                            ("fs3_domdec_multi", "fs3_domdec.cu", 312)):
        kernels.append(entry(name, src,
                             f"bath_tpu/ops/jaxk/multimodel.py:{line}",
                             mq_counts[name], mq_err[name], times[name]))
        # its plain version was timed on this many of the timed items
        kernels[-1]["plain_items"] = plain_items[name]
    for name, src, line in (("msv_filter_multi", "msv_filter.cu", 160),
                            ("vit_filter_multi", "vit_filter.cu", 175)):
        kernels.append(entry(name, src, f"bath_tpu/evalues_device.py:{line}",
                             build_launches[name], cal_err[name],
                             times[name]))
        kernels[-1]["plain_items"] = plain_items[name]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
