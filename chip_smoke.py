"""Smoke test of bath_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--phases parity,timing,...]

Builds the CUDA kernels of ``bath_tpu_torch/ops/kernels/csrc/`` and runs
its phases in this order (``--phases`` picks some; the default is every
phase but ``deep`` and ``sanitize_full``; ``all`` adds both):

- ``parity``: every single- and multi-model kernel entry of the search
  and calibration paths against its plain PyTorch version on the card
  (the integer filters exactly, and MSV also against the native host
  library over every ORF of the search genome; the six multi-model
  entries also bit for bit against the single-model entries, on batches
  that mix 48 models of M = 60..1200); then one model past each former
  limit of a block's shared memory (the ViterbiFilter and its capture
  at M = 3000, the fs3 gate and fs3 decoding at M = 4000, MSV and the
  Forward gate at M = 4200) against its plain version on a few items;
  then every family just past a block's warps, where the segments
  begin (the ViterbiFilter at 9000, the fs3 pair at 14000, the gate,
  decoding and MSV at 34000; the SSV capture at 23000, on 22 warps of
  33 lanes, and at 40000), each row walked in segments, and the gate,
  the ViterbiFilter and MSV in one launch of an M = 400 and an
  M = 40000 model;
- ``sanitize``: memcheck of NVIDIA's compute-sanitizer over the cases
  of ``bath_tpu_torch/sanitize.py`` (every kernel entry at tiny shapes,
  each plan family, a segmented class of each segmented entry, the step
  over two shares; each output held against its plain version) in a
  child process whose filter instruments the port's kernels only, once
  the tool has reported its canary (a write past a buffer); where the
  machine has no tool or it cannot attach to the card, the line says
  ``available=False`` with the tool's own error and nothing is checked;
- ``timing``: the same entries at the main paths' shapes, beside their
  plain versions, the host library's batches and one single-model
  launch per model, each output held again; every entry's ``ms`` is the
  kernel's launch alone (checked and planned beforehand by
  ``loader.prepare_*``), its wrapper's time (``wrapper_ms``) beside it;
- ``ubench``: the card's microbenchmarks (``bath_tpu_torch.ubench``,
  the counterparts of ``scripts/ubench_vpu.py``), each of the five
  entries against its plain version at the script's shapes (the one-hot
  and overlap entries also at [136, 4096] and with a partial last tile,
  the one-hot ones and overlap twice, bit for bit; the gather also at
  Mt = 135 and 8 with indices outside the table, the scalars at 4096
  and a ragged width), ``F.embedding_bag`` timed beside the one-hot
  entries (their library call), then the drive (chain, one-hot by index
  and on the tensor cores, overlap, scalars at [136, 1024] and [136,
  4096], each with its design's ``floor_ms``);
- ``mesh``: the self-check's dry run (``bath_tpu_torch/selfcheck.py``
  ``dryrun_multichip``): the data-parallel gate step
  (``parallel/mesh.py``) over every card of the machine (two shares of
  one card on a machine of one) on one flush's shape, bit for bit the
  step on one card and the three single-model entries launched on the
  whole batch, then the production cascade over the same devices,
  standard, ``--fs``, ``--splice`` and a multi-HMM file, byte-identical
  to one device and to numpy;
- ``search``: a seeded 5 Mb genome against a seeded M = 400 profile
  through the port's CLI, standard, then ``--fs`` and ``--fsonly`` on
  its frameshift twin (16 of its 40 embeds carry a 1-nt indel), then
  the all-device cascade (``BATH_MSV_DEVICE=1 BATH_VIT_DEVICE=1``),
  standard and ``--fs``, the all-device cascade with an M = 9000
  model against a seeded genome with two copies of it, ``--splice``
  against a seeded 5 Mb genome with 16 genes of 2-4 exons, with the
  default cascade and the all-device one, and then ``--cpu 4`` in this
  process (the hybrid of workers and the card, standard and ``--fs``,
  the numpy window pool, and a two-model ``--splice`` file through the
  hybrid), then ``--mesh`` over every card (on one card, two shares of
  it), standard, ``--fs`` and all-device, and ``--hosts 2``: two rank
  processes of the CLI on the standard search; each held to the serial
  numpy run;
- ``multiquery``: a 48-model query file against a 2 Mb genome that
  holds copies of 12 of the models, standard and ``--fs``, serial and
  with ``--cpu 8`` (the query-sharded pool, every stage on the host),
  and the standard drive over the mesh;
- ``build``: ``bathbuild`` of a 14-alignment Stockholm file (12 of the
  multi-query models and the narrowest and widest, M = 60..1200) and
  ``bathconvert`` of the built models stripped of their frameshift
  calibration, ``--backend torch`` (one device-batched calibration)
  against ``--backend numpy`` (the serial host calibration), then
  ``bathstat``, ``bathfetch`` and a ``bathsearch --fs`` with each file;
- ``deep`` (not in the default run, for its time): the parity shapes
  the default run cuts: an ORF of 16 500 residues through the integer
  filters, the gate, decoding, MSV, the ViterbiFilter and the fs3 pair
  at M = 40000 (5-9 segments a row), fs3 windows of 4500 nt, the fs3 gate timed at M = 781, 1000
  and 2048, and the plain fs3 pair at the multi-query drive's shapes
  on 12 and 4 models;
- ``sanitize_full`` (not in the default run): racecheck, synccheck and
  initcheck over the sanitize phase's cases, each after its canary,
  then the cases with no tool (their parity alone).

The searches check that the output is byte-identical to the host path
(the port's own ``--backend numpy``), that the embedded homologs and the
frameshifts are found, and that each search went through its kernels;
the built files may differ from the host's only in their DATE lines
and in the taus the f32 gates simulate.  ``bathbuild --backend numpy``,
its serial host calibration of 14 models, runs in a child process
beside the parity phase and has ended before anything is timed, so its
own wall, printed with ``wall_numpy_concurrent=True``, carries that
phase's load and no other number in the output carries its.

Every step prints one line, every phase a ``[phase] <name>
seconds=...`` line; any failure exits non-zero.  The last two lines are
the kernels' JSON record (per kernel entry: launches on its main path,
error against the plain version, time, the plain version's time, and
the least time the card could take for the timed work) and
``{"ok": true, "device": ...}``.

Needs a CUDA device, nvcc (``$CUDA_HOME`` or ``/usr/local/cuda``) and
g++ (the host library of the integer filters).  Everything it builds or
writes goes under ``build/`` next to this file.  It imports nothing of
``bath_tpu`` and no JAX.
"""

import argparse
import atexit
import contextlib
import faulthandler
import io
import json
import os
import re
import socket
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
BUILD = ROOT / "build" / "bath_tpu_torch"
sys.path.insert(0, str(ROOT))
# the card's published peaks and the timer, shared with the ubench phase
from bath_tpu_torch.ubench import (  # noqa: E402
    F32_OPS_PER_S, HBM_BYTES_PER_S, card_line, cuda_ms)
from bath_tpu_torch.parallel.pool import stop_servers  # noqa: E402
# the bands of a kernel against its plain version (the gates' nats,
# decoding's posteriors, the microbenchmarks') and the capture
# thresholds, which the sanitizer tier's cases use too
from bath_tpu_torch.bands import (  # noqa: E402
    DOMDEC_TOL, FWD_TOL, P1_THR, SSV_THR, UB_TOL, VIT_THR)

DEVICE = "cuda"
DEV = torch.device(DEVICE)
M_SEARCH = 400              # a Pfam-sized profile
GENOME_NT = 5_000_000       # one bacterial genome
N_EMBEDS = 40
MIN_FOUND = 30
SEED = 20261016
PARITY_FWD = (256, 2048)    # (B, longest L) of the parity batches
PARITY_DOMDEC = (32, 2048)
# the envelope fills: envelopes of these lengths at M_SEARCH (parity),
# and a flush of the benchmark's cell, envelopes of M_SEARCH residues
PARITY_RESCORE = (1, 7, 64, 129, 250, 400, 401, 777)
TIME_RESCORE_B = 20
WIDE = (1500, 8, 1600)      # (M, B, L): several warps per ORF
TIME_FWD_B, TIME_DOMDEC_B = 4096, 128
TIME_FWD_M = (400, 1000)
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
# one model past each former limit of a block's shared memory, and the
# (items, longest) of its parity batch
LONG_VIT_M, LONG_FS3_M, LONG_GATE_M = 3000, 4000, 4200
# MSV and the gate past a narrow instance's block of registers: 23 warps
# of 17 lanes, 19 of 33 (loader.fwd_layout)
LONG_BLOCK_MS = (12000, 20000)
LONG_ITEMS = (6, 700)
LONG_FS3_ITEMS = (4, 900)
# past a block's warps, each row walked in segments (loader.segmented):
# every family at SEG_M and just past a block's warps (the
# ViterbiFilter's 16 warps of 17 lanes, the fs3 pair's 32 of 13, the
# gate, decoding and MSV's 32 of 33; the SSV capture past 21 of 33), and
# the gate, the ViterbiFilter and MSV in one launch of an M = 400 and an
# M = SEG_M model
SEG_M = 40_000
SEG_PAST = {"vit": 9000, "fs3": 14_000, "ssv": 23_000, "dd": 34_000}
# the families at SEG_M in the default run: the SSV capture, which is
# one segment at SEG_PAST (its 22 warps of 33 lanes); ``deep`` runs the
# others at SEG_M too (5-9 segments a row; 38 s of the default run)
SEG_M_FAMILIES = ("ssv",)
DEEP_SEG_M_FAMILIES = ("dd", "vit", "fs3")
SEG_CAP_THR = (150, 1000)   # SSV capture bytes, ViterbiFilter words
# the all-device search with a long model: an M = SEG_SEARCH_M profile
# against a seeded genome with two copies, at the LOOSE thresholds
# (so that the ViterbiFilter's capture has input)
SEG_SEARCH_M = 9000
SEG_SEARCH = (300_000, 2)   # (genome nt, copies)
SPLICE_GENES = 16           # spaced 312 kb apart, past --max_intron
# bath_tpu --backend numpy --splice's own count of whole genes on this
# fixture on the CPU: 14 of 16 (the last two genes, 2 kb apart, come
# out as one hit and a piece)
SPLICE_MIN_FOUND = 14
LONG_ORF = 2_000
# --cpu: workers of the single-query searches (half of an eight-core
# host, so the hybrid's own process takes windows too) and of the
# multi-query drives (every core); a run that has not ended by
# CPU_RUN_LIMIT_S fails with every thread's stack.  The hybrid runs
# with one window queued a worker (BATH_HYBRID_MAXQ; the default of
# three a worker left the CLI's process 1 of the 20 windows of the 5 Mb
# genome, which held no F3 candidate): it takes every window the
# workers have no room for into the card's cascade
CPU_WORKERS, MQ_CPU_WORKERS = 4, 8
HYBRID_MAXQ = {"BATH_HYBRID_MAXQ": str(CPU_WORKERS)}
CPU_RUN_LIMIT_S = 300
INT_WIDE_M = 1500
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
# its genome: 2 Mb (a small bacterial genome) holds the 24 copies as a
# 5 Mb one does, and takes the drives' 48-model passes 2.5 times fewer
# residues (the single-query searches keep GENOME_NT)
MQ_GENOME_NT = 2_000_000
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
# decoding on the items of every eighth model; the fs3 pair, whose plain
# versions take 7 and 21 s a model over windows of thousands of rows, on
# the items of one model (M = 132) and of one of the 12 (M = 84: one
# warp a window; the parity phase holds both against them at up to three
# warps a window, ``deep`` on 12 and 4 models of the drive's).  The
# --mesh and --hosts drives of ``search`` and ``multiquery`` took the
# place of the plain versions of every second decoded model, and the
# run's time limit that of every fourth and of the fs3 pair's second
# models (M = 1200 and 763).
TIME_MQ_FWD_B, TIME_MQ_DOMDEC_B = 1600, 128
TIME_MQ_FS3_B, TIME_MQ_FS3DD_B = 512, 24
TIME_MQ_PLAIN_DOMDEC = tuple(range(0, 48, 8))
TIME_MQ_PLAIN_FS3 = (3,)
TIME_MQ_PLAIN_FS3DD = (1,)
# "torch_host": the multi-query drive with every stage's engagement
# threshold out of reach, so the host runs the f32 stages on the same
# items (what the card's stages are weighed against).  The standard
# drive takes such a turn; the --fs drive, whose host fs3 stages take
# longest, leaves its time to the build path.  "_cpu": the query-sharded
# pool (--cpu MQ_CPU_WORKERS).  "torch_mesh": the packed stages over
# the mesh of ``mesh_options`` (standard only).  Each turn is held to
# the first one: the serial numpy drive, and under --fs the numpy pool
# (which the CPU tests hold to the serial loop; the serial --fs turn
# took 82 s)
MQ_TURNS = ("numpy", "torch", "torch_host", "torch_cpu", "torch_mesh")
MQ_FS_TURNS = ("numpy_cpu", "torch", "torch_cpu")
# the --fs drive's queries that the serial numpy loop also runs, alone,
# as a reference independent of the multi-query drive's shared stream
# (the narrowest model, two embedded ones, the widest)
MQ_FS_SERIAL = (0, 1, 29, 47)
MQ_MIN_CELLS = ("BATH_MQ_FWD_MIN_CELLS", "BATH_MQ_DD_MIN_CELLS",
                "BATH_MQ_FS3_MIN_CELLS", "BATH_MQ_FSDD_MIN_CELLS")

# bathbuild and bathconvert: alignments of MSA_NSEQ sequences emitted
# from the 48 multi-query models, the default calibration (200 x 200 aa
# for the MSV and Viterbi mus, 200 x 100 aa and 200 x 300 nt for the
# taus).  A tau of an f32 gate may sit TAU_WARN from the host parser's
# before the run says so, and TAU_TOL before it fails.
MSA_NSEQ = 20
# the models that get an alignment: the narrowest, the 12 embedded ones
# (whose copies the built files' search finds) and the widest, M = 60..1200
# (bathbuild's host calibration takes ~2.5 s a model); the one fetched
BUILD_MQ = (0, *MQ_EMBEDDED, 47)
FETCHED = 29
TAU_WARN, TAU_TOL = 0.02, 0.05
F32_GATE_LINES = ("STATS LOCAL FORWARD", "STATS LOCAL FS3 FORWARD")

# --hosts: rank processes of the CLI on the 5 Mb search, each under
# HOSTS_LIMIT_S (one card: both ranks on cuda:0, a CUDA context each)
HOSTS = 2
HOSTS_LIMIT_S = 300

# the mesh step on one flush's shape: MESH_B DNA windows of MESH_LN nt
# (the fs3 gate's windows at M = 409), MESH_HOMOLOGS of them over
# embedded copies of the model, and the longest ORF of each
MESH_B, MESH_LN, MESH_HOMOLOGS = 256, 2748, 16

# deep: the shapes the default run cuts for its time
DEEP_LONG_ORF = 16_500
DEEP_PARITY_FS3 = (32, 4500)
DEEP_PARITY_FS3DD = (8, 4500)
DEEP_TIME_FS3_M = (781, 1000, 2048)
DEEP_TIME_MQ_PLAIN_FS3 = tuple(range(3, 48, 4))      # 12 models
DEEP_TIME_MQ_PLAIN_FS3DD = (1, 13, 29, 45)           # M = 84..1151

# The DP kernels are f32 (or one 32-bit int per cell) multiply-adds and
# maxima on the CUDA cores, so the card's f32 rate (F32_OPS_PER_S)
# bounds their operations.  Arithmetic per DP cell (one residue or
# nucleotide x one model position), counted from the recurrences: the
# M, I, D updates, the row sum and the rescale; decoding adds the
# backward pass's.
OPS_PER_CELL = {"fwd_parser": 19, "domdec": 37, "fs3_parser": 23,
                "fs3_domdec": 43, "msv_filter": 8, "ssv_capture": 4,
                "vit_filter": 20, "vit_capture": 21, "rescore": 45}


CHILDREN: list = []             # child processes still to be reaped


def stop_children() -> None:
    """Ends the child processes, and the server and resource tracker
    that the --cpu pools of this process started."""
    for proc in CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    stop_servers()


def descendants() -> list:
    """(pid, state, command line) of every process that descends from
    this one."""
    kids: dict = {}
    for d in Path("/proc").iterdir():
        try:
            stat = (d / "stat").read_text() if d.name.isdigit() else ""
            cmd = (d / "cmdline").read_bytes()
        except OSError:
            continue
        if stat:
            state, ppid = stat.rsplit(")", 1)[1].split()[:2]
            kids.setdefault(int(ppid), []).append(
                (int(d.name), state, cmd.replace(b"\0", b" ").decode()[:200]))
    out, todo = [], [os.getpid()]
    while todo:
        for kid in kids.get(todo.pop(), []):
            out.append(kid)
            todo.append(kid[0])
    return out


atexit.register(stop_children)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def host_tool(name: str, argv) -> tuple:
    """Starts ``--backend numpy`` of one of the port's CLIs in a child
    process (no CUDA there), its output into a file under build/;
    ``host_result`` waits for it.  For bathbuild, whose serial host
    calibration of BUILD_MQ models would add its half minute to the
    run."""
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


def masked(path) -> str:
    return re.sub(r"# (CPU time|Mc/sec):.*", "", Path(path).read_text())


def fs_masked(paths) -> tuple:
    return (masked(paths[0]),
            "".join(ln for ln in paths[2].read_text().splitlines(True)
                    if not ln.startswith("#")))


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
        / F32_OPS_PER_S
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    return max(by_ops, by_bytes), \
        "operations" if by_ops >= by_bytes else "bytes"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


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


def max_err(got, want) -> float:
    return float((got - want).abs().max()) if got.numel() else 0.0


def ints(values) -> torch.Tensor:
    return torch.from_numpy(np.asarray(values, np.int32)).to(DEV)


def one_batch(orfs, dev=DEV, pad=28):
    """(lengths as numpy, dsq, lens): <orfs> as one padded batch on
    <dev>, built as the cascade builds its batches."""
    from bath_tpu_torch.device_pipeline import batches
    ln = np.array([len(o) for o in orfs], np.int32)
    _, dsq, lens = next(batches(orfs, ln, dev, batch=len(orfs), pad=pad))
    return ln, dsq, lens


def host_layout(orfs):
    """<orfs> as the native host library's ORF extractor hands them
    over (one flat stream)."""
    from bath_tpu_torch.gencode import OrfList
    from bath_tpu_torch.ops import ssv
    flat, offs, lens = ssv.pack_stream(orfs)
    out = OrfList(orfs)
    out.flat, out.offs, out.lens = flat.astype(np.int32), offs, lens
    return out


class Run:
    """What the phases hand on to each other and to the record: per
    kernel entry its time (ms, plain ms, bound ms, bound by), its error
    against its plain version, its launches on its main path's run and
    further keys; fixtures and models made once."""

    def __init__(self, phases):
        self.phases = phases
        self.card = ""
        self.times: dict = {}
        self.err: dict = {}
        self.launches: dict = {}
        self.extra: dict = {}
        self.library: dict = {}     # library_ms, where one call computes it
        self.cache: dict = {}
        self.host_build = None
        self.built_numpy = None

    def note_err(self, name: str, err: float) -> None:
        self.err[name] = max(self.err.get(name, 0.0), err)

    def once(self, key, make):
        if key not in self.cache:
            self.cache[key] = make()
        return self.cache[key]

    def fx(self):
        """The 5 Mb search fixture with its M = 400 profile."""
        from bath_tpu_torch import fixtures
        return self.once("fx", lambda: fixtures.write_fixture(
            M_SEARCH, GENOME_NT, N_EMBEDS, SEED))

    def fs_fx(self):
        """Its frameshift twin, the query calibrated for --fs."""
        from bath_tpu_torch import fixtures
        return self.once("fs_fx", lambda: fixtures.write_fixture(
            M_SEARCH, GENOME_NT, N_EMBEDS, SEED, fs=True,
            n_frameshift=N_FRAMESHIFT))

    def om(self):
        """The search profile of the fixture's model."""
        from bath_tpu_torch import fixtures
        from bath_tpu_torch.hmmfile import read_hmm
        return self.once("om", lambda: fixtures.search_profile(
            read_hmm(self.fx().hmm_path)))

    def mq_fx(self, fs: bool):
        """The multi-query fixtures (48 models calibrated in one pass on
        the card: the build phase holds that calibration against the
        host's)."""
        from bath_tpu_torch import fixtures
        return self.once(("mq_fx", fs), lambda: fixtures.write_multi_fixture(
            MQ_MS, MQ_GENOME_NT, MQ_EMBEDDED, MQ_COPIES, SEED, fs=fs,
            device=DEVICE))

    def msa(self):
        """(Stockholm file, alignment names) of the BUILD_MQ models."""
        from bath_tpu_torch import fixtures
        return self.once("msa", lambda: fixtures.write_msa_fixture(
            MQ_MS, MSA_NSEQ, SEED, keep=BUILD_MQ))

    def join_host_build(self) -> None:
        """Waits for the bathbuild --backend numpy child, if one runs."""
        if self.host_build is None or self.built_numpy is not None:
            return
        self.built_numpy = host_result(self.host_build)
        phase("bathbuild", backend="numpy", ended=True,
              wall_s=f"{self.built_numpy[1]:.3f}", concurrent=True)


def held(run: Run, name: str, got, want, M) -> tuple:
    """An integer kernel's outputs, failed unless equal to its plain
    version's."""
    err = exact(got, want)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        fail(f"{name} kernel vs plain at M={M}: max |d| {err}")
    run.note_err(name, err)
    return got


# ---------------------------------------------------------------------
# parity: every kernel entry against its plain version on the card
# ---------------------------------------------------------------------
def query400():
    """(hmm, query, Forward parameters) of an uncalibrated M = 400
    model, the same in every phase."""
    from bath_tpu_torch import fixtures
    from bath_tpu_torch.ops import fwd
    hmm, q = fixtures.make_query(M_SEARCH, np.random.default_rng(SEED),
                                 calibrate=False)
    return hmm, q, fwd.fwd_params(fixtures.search_profile(hmm), DEV)


def parity_single(run: Run, rng) -> None:
    """The Forward gate and decoding at M_SEARCH and at a model past one
    warp's reach (several warps per ORF)."""
    from bath_tpu_torch import fixtures
    from bath_tpu_torch.ops import domdec as dd
    from bath_tpu_torch.ops import fwd
    from bath_tpu_torch.ops.kernels import loader
    _, q, p400 = run.once("q400", query400)
    dsq, lens = (torch.from_numpy(a).to(DEV)
                 for a in fixtures.kernel_batch(q, *PARITY_FWD, rng))
    got = fwd.fwd_score(dsq, lens, p400)
    err = max_err(got, fwd.fwd_score_ref(dsq, lens, p400))
    if not torch.isfinite(got).all() or not err <= FWD_TOL:
        fail(f"fwd kernel vs plain: max |d| {err} > {FWD_TOL}")
    run.note_err("fwd_parser", err)
    phase("parity", kernel="fwd_parser", M=M_SEARCH, B=PARITY_FWD[0],
          L=f"1..{PARITY_FWD[1]}", max_abs_err=err, tol=FWD_TOL,
          best_score=f"{float(got.max()):.2f}")
    dsq, lens = (torch.from_numpy(a).to(DEV)
                 for a in fixtures.kernel_batch(q, *PARITY_DOMDEC, rng))
    got = dd.domdec(dsq, lens, p400)
    want = dd.domdec_ref(dsq, lens, p400)
    err = max(max_err(a, b) for a, b in zip(got[:3], want[:3]))
    if not err <= DOMDEC_TOL or not torch.equal(got[3], want[3]):
        fail(f"domdec kernel vs plain: max |d| {err} > {DOMDEC_TOL} "
             f"or ok differs ({got[3].sum()} vs {want[3].sum()})")
    run.note_err("domdec", err)
    phase("parity", kernel="domdec", M=M_SEARCH, B=PARITY_DOMDEC[0],
          L=f"1..{PARITY_DOMDEC[1]}", max_abs_err=err, tol=DOMDEC_TOL,
          ok=f"{int(got[3].sum())}/{PARITY_DOMDEC[0]}", ok_identical=True)
    hmm_w, q_w = fixtures.make_query(WIDE[0], rng, calibrate=False)
    p_w = fwd.fwd_params(fixtures.search_profile(hmm_w), DEV)
    dsq, lens = (torch.from_numpy(a).to(DEV)
                 for a in fixtures.kernel_batch(q_w, WIDE[1], WIDE[2], rng))
    e1 = max_err(fwd.fwd_score(dsq, lens, p_w),
                 fwd.fwd_score_ref(dsq, lens, p_w))
    g, w = dd.domdec(dsq, lens, p_w), dd.domdec_ref(dsq, lens, p_w)
    e2 = max(max_err(a, b) for a, b in zip(g[:3], w[:3]))
    if not (e1 <= FWD_TOL and e2 <= DOMDEC_TOL and torch.equal(g[3], w[3])):
        fail(f"M={WIDE[0]} parity: fwd {e1}, domdec {e2}")
    phase("parity", kernel="both", M=WIDE[0],
          fwd_layout=loader.fwd_layout(WIDE[0]),
          domdec_layout=loader.layout(WIDE[0]), fwd_err=e1, domdec_err=e2)


def parity_fs3(run: Run, rng, shape, shape_dd) -> None:
    """The --fs kernels against their plain versions: DNA windows of 0,
    2, 3, 4 and up to shape[1] nt with homologs (one in three
    frameshifted) and runs of N, at M_SEARCH and at a model that takes
    several warps per window."""
    from bath_tpu_torch import fixtures
    from bath_tpu_torch.ops import fs3
    from bath_tpu_torch.ops import fs3_domdec as fdd
    from bath_tpu_torch.ops.kernels import loader
    for M in (M_SEARCH, FS3_WIDE_M):
        hm, qm = fixtures.make_query(M, rng, calibrate=False, fs=True)
        pm = fs3.fs3_params(fixtures.fs_search_profile(hm), DEV)
        dsq, lens = (torch.from_numpy(a).to(DEV) for a in
                     fixtures.fs_window_batch(qm, *shape, rng))
        got = fs3.fs3_score(dsq, lens, pm)
        want = fs3.fs3_score_ref(dsq, lens, pm)
        fin = torch.isfinite(want)
        e1 = max_err(got[fin], want[fin])
        if not (torch.equal(fin, torch.isfinite(got)) and e1 <= FWD_TOL):
            fail(f"fs3 kernel vs plain at M={M}: max |d| {e1} > {FWD_TOL} "
                 "or the -inf windows differ")
        dsq, lens = (torch.from_numpy(a).to(DEV) for a in
                     fixtures.fs_window_batch(qm, *shape_dd, rng))
        g = fdd.fs3_domdec(dsq, lens, pm, 100.0 / 103.0)
        w = fdd.fs3_domdec_ref(dsq, lens, pm, 100.0 / 103.0)
        e2 = max(max_err(a, b) for a, b in zip(g[:3], w[:3]))
        if not (e2 <= DOMDEC_TOL and torch.equal(g[3], w[3])):
            fail(f"fs3_domdec kernel vs plain at M={M}: max |d| {e2} > "
                 f"{DOMDEC_TOL} or ok differs ({g[3].sum()} vs "
                 f"{w[3].sum()})")
        run.note_err("fs3_parser", e1)
        run.note_err("fs3_domdec", e2)
        phase("parity", kernel="fs3_parser,fs3_domdec", M=M,
              layout=loader.fs3_layout(M), B=f"{shape[0]},{shape_dd[0]}",
              L=f"0..{shape[1]}", fs3_err=e1, fs3_tol=FWD_TOL,
              fs3_domdec_err=e2, fs3_domdec_tol=DOMDEC_TOL,
              ok=f"{int(g[3].sum())}/{shape_dd[0]}", ok_identical=True,
              best_score=f"{float(want[fin].max()):.2f}")


def parity_int(run: Run, long_orf: int) -> None:
    """The integer filters against their plain versions, exactly: ORFs
    of the search genome, its hot ORFs (int16 overflow; SSV slots
    overflowing at P = 1), ORFs of 0, 1, 2, 19-21 and 3 missing-data
    residues and, at M_SEARCH, one of <long_orf> residues; INT_WIDE_M
    takes several warps per ORF."""
    from bath_tpu_torch import fixtures
    from bath_tpu_torch.hmmfile import read_hmm
    from bath_tpu_torch.ops import ssv, vit
    from bath_tpu_torch.ops.kernels import loader
    for M in (M_SEARCH, INT_WIDE_M):
        if M == M_SEARCH:
            src, om_m = run.fx(), run.om()
        else:
            src = fixtures.write_fixture(M, 30_000, 4, M, calibrate=False)
            om_m = fixtures.search_profile(read_hmm(src.hmm_path))
        orfs = fixtures.filter_cases(src, PARITY_INT_N, SEED,
                                     long_orf if M == M_SEARCH else 1200)
        flat, offs, lens = (torch.from_numpy(a).to(DEV)
                            for a in ssv.pack_stream(orfs))
        pm, pv = ssv.msv_params(om_m, DEV), vit.vit_params(om_m, DEV)
        ln = lens.cpu().numpy()
        tjb, move = ints(pm.tjb_for(ln)), ints(pv.move_for(ln))
        args = (flat, offs, lens)
        movf = held(run, "msv_filter", ssv.msv_ssv(*args, tjb, pm),
                    ssv.msv_ssv_ref(*args, tjb, pm), M)[2]
        vs = held(run, "vit_filter", vit.vit_ints(*args, move, pv),
                  vit.vit_ints_ref(*args, move, pv), M)
        nwin = {}
        for t in (SSV_THR, P1_THR):
            thr = ints(np.full(len(orfs), t))
            nwin[t] = held(run, "ssv_capture",
                           ssv.ssv_capture(*args, tjb, thr, pm),
                           ssv.ssv_capture_ref(*args, tjb, thr, pm), M)[0]
        orow = {}
        for t in (VIT_THR, P1_THR):
            thr = ints(np.full(len(orfs), t))
            orow[t] = held(run, "vit_capture",
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
              "vit_capture", M=M, layout=loader.msv_layout(M),
              vit_layout=loader.vit_layout(M), B=len(orfs),
              max_L=int(ln.max()), identical=True, **branches)


def cascade(run: Run):
    """(TorchCascade of the search profile, every ORF of the genome)."""
    from bath_tpu_torch import fixtures
    from bath_tpu_torch.device_pipeline import TorchCascade
    return run.once("cascade", lambda: (
        TorchCascade(run.om(), device=DEV, stats={}),
        fixtures.genome_orfs(run.fx().fasta_path)))


def parity_msv_native(run: Run) -> None:
    """MSV through the cascade (one flat stream, one launch) over every
    ORF of the search genome against the native host batch."""
    from bath_tpu_torch.native import msv_filter_native_batch
    from bath_tpu_torch.ops import ssv
    cas, all_orfs = cascade(run)
    a_flat, a_offs, a_lens = ssv.pack_stream(all_orfs)
    got = cas.msv_scores(None, a_lens, flat=a_flat, offs=a_offs)
    want = msv_filter_native_batch(all_orfs, run.om())
    if not np.array_equal(got, want):
        fail(f"device MSV differs from msv_filter_native_batch on "
             f"{int((got != want).sum())} of {len(all_orfs)} ORFs")
    phase("parity", kernel="msv_filter", M=M_SEARCH,
          vs="msv_filter_native_batch", orfs=len(all_orfs),
          residues=int(a_lens.sum()), inf=int(np.isinf(got).sum()),
          identical=True)


# the multi-model entries: helpers shared by the parity and timing
# phases
def multi_case(fs, per_model, Lmax):
    from bath_tpu_torch import fixtures
    from bath_tpu_torch.ops import fs3, fwd
    from bath_tpu_torch.ops import multimodel as mm
    oms, d, ln, sl = fixtures.multi_kernel_batch(MQ_MS, per_model, Lmax,
                                                 SEED, fs=fs)
    params = [(fs3.fs3_params if fs else fwd.fwd_params)(om, DEV)
              for om in oms]
    pack = (mm.build_fs3_pack if fs else mm.build_fwd_pack)(params)
    return (pack, torch.from_numpy(d).to(DEV),
            torch.from_numpy(ln).to(DEV), sl)


def model_rows(sl):
    return [(g, torch.from_numpy(np.nonzero(sl == g)[0]).to(DEV))
            for g in range(len(MQ_MS))]


def vs_plain(name, got, want):
    """max |got - want| of a multi-model entry and its plain version;
    fails past the single-model kernels' bounds: gates FWD_TOL with the
    same -inf items, decoding DOMDEC_TOL on the posteriors with `ok`
    identical."""
    if isinstance(got, tuple):
        err = max(max_err(a, b) for a, b in zip(got[:3], want[:3]))
        if not (err <= DOMDEC_TOL and torch.equal(got[3], want[3])):
            fail(f"{name} vs plain: max |d| {err} > {DOMDEC_TOL} or ok "
                 f"differs ({got[3].sum()} vs {want[3].sum()})")
        return err
    fin = torch.isfinite(want)
    err = max_err(got[fin], want[fin])
    if not (torch.equal(fin, torch.isfinite(got)) and err <= FWD_TOL):
        fail(f"{name} vs plain: max |d| {err} > {FWD_TOL} or the -inf "
             "items differ")
    return err


def plain_subset(sl, models):
    sub = np.nonzero(np.isin(sl, models))[0]
    return sub, torch.from_numpy(sub).to(DEV)


def gate_case(run, name, fs, shape, call, single, ref):
    """Holds one gate entry on a batch: against the single-model entry
    model by model, and against the plain version on the items of
    PARITY_MQ_PLAIN."""
    pack, d, lt, sl = multi_case(fs, *shape)
    got = call(pack, d, lt, sl)
    sub, rs = plain_subset(sl, PARITY_MQ_PLAIN)
    err = vs_plain(name, got[rs], ref(pack, d[rs].contiguous(),
                                      lt[rs].contiguous(), sl[sub]))
    for g, r in model_rows(sl):
        one = single(d[r].contiguous(), lt[r].contiguous(), pack.params[g])
        if not torch.equal(one, got[r]):
            fail(f"{name} differs from the single-model entry at "
                 f"M={MQ_MS[g]}")
    run.note_err(name, err)
    phase("parity", kernel=name, models=len(MQ_MS),
          M=f"{min(MQ_MS)}..{max(MQ_MS)}", widths=sorted(pack.classes),
          B=len(sl), L=f"{int(lt.min())}..{int(lt.max())}",
          vs_plain=err, plain_items=len(sub),
          plain_M=[MQ_MS[g] for g in PARITY_MQ_PLAIN], tol=FWD_TOL,
          best_score=f"{float(got[torch.isfinite(got)].max()):.2f}",
          single_model_entry="bit for bit")


def decoding_case(run, name, fs, shape, plain_models):
    """The same for a decoding entry: the kernels' own outputs bit for
    bit the single-model entry's, `ok` identical, posteriors within 1e-6
    of it (torch.cumsum's summation order on the card depends on the
    batch's shape)."""
    from bath_tpu_torch.ops import domdec as dd
    from bath_tpu_torch.ops import fs3_domdec as fdd
    from bath_tpu_torch.ops import multimodel as mm
    from bath_tpu_torch.ops.kernels import loader
    pack, d, lt, sl = multi_case(fs, *shape)
    n3 = lt.cpu().numpy() // 3
    dec = torch.from_numpy((n3 / (n3 + 3.0)).astype(np.float32)).to(DEV)
    sub, rs = plain_subset(sl, plain_models)
    ds, ls = d[rs].contiguous(), lt[rs].contiguous()
    if fs:
        got = mm.fs3_domdec_pack_batch(pack, d, lt, sl, dec)
        raw = loader.prepare_fs3(d, lt, sl, pack, True)(1.0)
        want = mm.fs3_domdec_pack_batch_ref(pack, ds, ls, sl[sub], dec[rs])
    else:
        got = mm.domdec_pack_batch(pack, d, lt, sl)
        raw = loader.prepare_domdec(d, lt, sl, pack)(1.0)
        want = mm.domdec_pack_batch_ref(pack, ds, ls, sl[sub])
    err = vs_plain(name, tuple(t[rs] for t in got), want)
    post_err = 0.0
    for g, r in model_rows(sl):
        args = (d[r].contiguous(), lt[r].contiguous(), pack.params[g])
        one_raw = (loader.prepare_fs3(args[0], args[1], None, args[2], True)
                   if fs else loader.prepare_domdec(args[0], args[1], None,
                                                    args[2]))(1.0)
        if not all(torch.equal(a, b[r]) for a, b in zip(one_raw, raw)):
            fail(f"{name}'s kernel outputs differ from the single-model "
                 f"entry's at M={MQ_MS[g]}")
        one = fdd.fs3_domdec(*args, dec[r]) if fs else dd.domdec(*args)
        if not torch.equal(one[3], got[3][r]):
            fail(f"{name}: ok differs from the single-model entry's at "
                 f"M={MQ_MS[g]}")
        post_err = max(post_err, *(max_err(a, b[r])
                                   for a, b in zip(one[:3], got[:3])))
    if post_err > 1e-6:
        fail(f"{name}: posteriors {post_err} from the single-model "
             "entry's")
    run.note_err(name, err)
    phase("parity", kernel=name, models=len(MQ_MS),
          M=f"{min(MQ_MS)}..{max(MQ_MS)}", widths=sorted(pack.classes),
          B=len(sl), L=f"{int(lt.min())}..{int(lt.max())}",
          vs_plain=err, plain_items=len(sub),
          plain_M=[MQ_MS[g] for g in plain_models], tol=DOMDEC_TOL,
          ok=f"{int(got[3].sum())}/{len(sl)}",
          single_model_entry="kernel outputs bit for bit",
          posteriors_vs_single=post_err)


def parity_multi(run: Run) -> None:
    """The four f32 multi-model entries at full width: 48 models of
    M = 60..1200 mixed in one batch per stage, items of up to 1250 aa
    and 3700 nt with copies of their model's protein; the timing phase
    holds every item of all 48 models against the plain versions at the
    multi-query drive's shapes."""
    from bath_tpu_torch.ops import fs3, fwd
    from bath_tpu_torch.ops import multimodel as mm
    gate_case(run, "fwd_parser_multi", False, PARITY_MQ_FWD,
              mm.fwd_pack_scores, fwd.fwd_score, mm.fwd_pack_scores_ref)
    gate_case(run, "fs3_parser_multi", True, PARITY_MQ_FS3,
              mm.fs3_pack_scores, fs3.fs3_score, mm.fs3_pack_scores_ref)
    decoding_case(run, "domdec_multi", False, PARITY_MQ_DOMDEC,
                  PARITY_MQ_PLAIN)
    decoding_case(run, "fs3_domdec_multi", True, PARITY_MQ_FS3DD,
                  PARITY_MQ_PLAIN_FS3DD)


def parity_long(run: Run) -> None:
    """The classes past a block's shared memory against their plain
    versions: the ViterbiFilter and its capture at LONG_VIT_M (its int16
    table read from global memory), the fs3 gate and decoding at
    LONG_FS3_M (the direct loads), MSV and the Forward gate at
    LONG_GATE_M (MSV's table from global memory, the gate's odds from
    L2) and at LONG_BLOCK_MS (blocks of more warps than the narrow
    instances' registers allow), each through its single-model wrapper
    on a few items."""
    from bath_tpu_torch import fixtures
    from bath_tpu_torch.ops import fs3, fwd, ssv, vit
    from bath_tpu_torch.ops import fs3_domdec as fdd
    from bath_tpu_torch.ops.kernels import loader
    rng = np.random.default_rng(SEED + 13)
    hm, q = fixtures.make_query(LONG_FS3_M, rng, calibrate=False, fs=True)
    p3 = fs3.fs3_params(fixtures.fs_search_profile(hm), DEV)
    d, lt = (torch.from_numpy(a).to(DEV) for a in
             fixtures.fs_window_batch(q, *LONG_FS3_ITEMS, rng))
    row = loader.prepare_fs3(d, lt, None, p3, False).plan.table
    e1 = vs_plain("fs3_parser", fs3.fs3_score(d, lt, p3),
                  fs3.fs3_score_ref(d, lt, p3))
    e2 = vs_plain("fs3_domdec", fdd.fs3_domdec(d, lt, p3, 100.0 / 103.0),
                  fdd.fs3_domdec_ref(d, lt, p3, 100.0 / 103.0))
    run.note_err("fs3_parser", e1)
    run.note_err("fs3_domdec", e2)
    phase("parity", kernel="fs3_parser,fs3_domdec", M=LONG_FS3_M,
          layout=loader.fs3_layout(LONG_FS3_M), direct_loads=int(row[6]),
          transitions_global=int(row[7]), B=LONG_FS3_ITEMS[0],
          L=f"0..{LONG_FS3_ITEMS[1]}", fs3_err=e1, fs3_domdec_err=e2)
    for M in (LONG_VIT_M, LONG_GATE_M, *LONG_BLOCK_MS):
        hm, q = fixtures.make_query(M, rng, calibrate=False)
        om = fixtures.search_profile(hm)
        dsq, lens = fixtures.kernel_batch(q, *LONG_ITEMS, rng)
        flat, offs, ln = (torch.from_numpy(a).to(DEV) for a in
                          ssv.pack_stream([r[:n] for r, n in zip(dsq,
                                                                  lens)]))
        if M == LONG_VIT_M:
            pv = vit.vit_params(om, DEV)
            move = ints(pv.move_for(lens))
            glob = loader.prepare_vit(flat, offs, ln, move, None,
                                      pv).plan.table[7] != 0
            held(run, "vit_filter", vit.vit_ints(flat, offs, ln, move, pv),
                 vit.vit_ints_ref(flat, offs, ln, move, pv), M)
            for t in (VIT_THR, P1_THR):
                thr = ints(np.full(len(lens), t))
                held(run, "vit_capture",
                     vit.vit_capture(flat, offs, ln, move, thr, pv),
                     vit.vit_capture_ref(flat, offs, ln, move, thr, pv), M)
            phase("parity", kernel="vit_filter,vit_capture", M=M,
                  vit_layout=loader.vit_layout(M), table_global=bool(glob),
                  B=len(lens), max_L=int(lens.max()), identical=True)
            continue
        pm = ssv.msv_params(om, DEV)
        tjb = ints(pm.tjb_for(lens))
        staged = loader.prepare_msv(flat, offs, ln, tjb, None,
                                    pm).plan.table[7]
        held(run, "msv_filter", ssv.msv_ssv(flat, offs, ln, tjb, pm),
             ssv.msv_ssv_ref(flat, offs, ln, tjb, pm), M)
        pf = fwd.fwd_params(om, DEV)
        d, lt = torch.from_numpy(dsq).to(DEV), torch.from_numpy(lens).to(DEV)
        fplan = loader.prepare_fwd(d, lt, None, pf).plan
        e = vs_plain("fwd_parser", fwd.fwd_score(d, lt, pf),
                     fwd.fwd_score_ref(d, lt, pf))
        run.note_err("fwd_parser", e)
        phase("parity", kernel="msv_filter,fwd_parser", M=M,
              layout=loader.msv_layout(M), msv_table_staged=int(staged),
              fwd_stage=int(fplan.table[7]), block_warps=fplan.warps,
              B=len(lens), max_L=int(lens.max()),
              msv_identical=True, fwd_err=e, fwd_tol=FWD_TOL)


def seg_model(M, fs=False):
    """(profile, query residues) of an uncalibrated model of M positions
    (the fs3 profile with <fs>), made once."""
    from bath_tpu_torch import fixtures
    hmm, q = fixtures.make_query(M, np.random.default_rng(SEED + M + fs),
                                 calibrate=False, fs=fs)
    return (fixtures.fs_search_profile(hmm) if fs
            else fixtures.search_profile(hmm)), q


def seg_family(run: Run, fam: str, M: int, rng) -> dict:
    """One family at M through its single-model wrappers against the
    plain versions on a few short items: the integer filters bit for
    bit (the captures at a threshold and at P = 1), the f32 kernels
    within FWD_TOL and DOMDEC_TOL with the same `ok`.  Returns what the
    phase line prints."""
    from bath_tpu_torch import fixtures
    from bath_tpu_torch.ops import domdec as dd
    from bath_tpu_torch.ops import fs3, fwd, ssv, vit
    from bath_tpu_torch.ops import fs3_domdec as fdd
    from bath_tpu_torch.ops.kernels import loader
    if fam == "fs3":
        om, q = run.once(("seg", M, True), lambda: seg_model(M, True))
        p3 = fs3.fs3_params(om, DEV)
        d, lt = (torch.from_numpy(a).to(DEV) for a in
                 fixtures.fs_window_batch(q, *LONG_FS3_ITEMS, rng))
        e1 = vs_plain("fs3_parser", fs3.fs3_score(d, lt, p3),
                      fs3.fs3_score_ref(d, lt, p3))
        e2 = vs_plain("fs3_domdec", fdd.fs3_domdec(d, lt, p3, 100.0 / 103.0),
                      fdd.fs3_domdec_ref(d, lt, p3, 100.0 / 103.0))
        run.note_err("fs3_parser", e1)
        run.note_err("fs3_domdec", e2)
        return dict(layout=loader.fs3_layout(M), fs3_err=e1,
                    fs3_domdec_err=e2)
    om, q = run.once(("seg", M, False), lambda: seg_model(M))
    dsq, lens = fixtures.kernel_batch(q, *LONG_ITEMS, rng)
    d, lt = torch.from_numpy(dsq).to(DEV), torch.from_numpy(lens).to(DEV)
    flat, offs, ln = (torch.from_numpy(a).to(DEV) for a in ssv.pack_stream(
        [r[:n] for r, n in zip(dsq, lens)]))
    if fam == "vit":
        pv = vit.vit_params(om, DEV)
        move = ints(pv.move_for(lens))
        held(run, "vit_filter", vit.vit_ints(flat, offs, ln, move, pv),
             vit.vit_ints_ref(flat, offs, ln, move, pv), M)
        for t in (SEG_CAP_THR[1], P1_THR):
            thr = ints(np.full(len(lens), t))
            held(run, "vit_capture",
                 vit.vit_capture(flat, offs, ln, move, thr, pv),
                 vit.vit_capture_ref(flat, offs, ln, move, thr, pv), M)
        return dict(layout=loader.vit_layout(M), identical=True)
    pm = ssv.msv_params(om, DEV)
    tjb = ints(pm.tjb_for(lens))
    if fam == "ssv":
        for t in (SEG_CAP_THR[0], P1_THR):
            thr = ints(np.full(len(lens), t))
            got = held(run, "ssv_capture",
                       ssv.ssv_capture(flat, offs, ln, tjb, thr, pm),
                       ssv.ssv_capture_ref(flat, offs, ln, tjb, thr, pm), M)
        events = int((got[0] > 16).sum())
        if events == 0:
            fail(f"the SSV capture at M={M} and P = 1 passed no ORF past "
                 "16 events")
        return dict(layout=loader.msv_layout(M), identical=True,
                    orfs_past_16_events=events)
    held(run, "msv_filter", ssv.msv_ssv(flat, offs, ln, tjb, pm),
         ssv.msv_ssv_ref(flat, offs, ln, tjb, pm), M)
    pf = fwd.fwd_params(om, DEV)
    e1 = vs_plain("fwd_parser", fwd.fwd_score(d, lt, pf),
                  fwd.fwd_score_ref(d, lt, pf))
    e2 = vs_plain("domdec", dd.domdec(d, lt, pf), dd.domdec_ref(d, lt, pf))
    run.note_err("fwd_parser", e1)
    run.note_err("domdec", e2)
    return dict(msv_layout=loader.msv_layout(M), msv_identical=True,
                fwd_layout=loader.fwd_layout(M), fwd_err=e1,
                domdec_layout=loader.layout(M), domdec_err=e2)


def seg_mixed(run: Run, rng) -> dict:
    """The gate, the ViterbiFilter and MSV in one launch of a pack of an
    M = 400 and an M = SEG_M model (the device calibration's path,
    bathbuild's J4): against the plain versions, and bit for bit the
    single-model wrapper on each model's items."""
    from bath_tpu_torch import fixtures
    from bath_tpu_torch.ops import fwd, ssv, vit
    from bath_tpu_torch.ops import multimodel as mm
    (om, q), (om4, _) = (run.once(("seg", M, False), lambda M=M: seg_model(M))
                         for M in (SEG_M, M_SEARCH))
    dsq, lens = fixtures.kernel_batch(q, *LONG_ITEMS, rng)
    slot = np.arange(len(lens)) % 2
    d, lt = torch.from_numpy(dsq).to(DEV), torch.from_numpy(lens).to(DEV)
    flat, offs, ln = (torch.from_numpy(a).to(DEV) for a in ssv.pack_stream(
        [r[:n] for r, n in zip(dsq, lens)]))
    oms = (om, om4)
    pf = [fwd.fwd_params(o, DEV) for o in oms]
    got = mm.fwd_pack_scores(mm.build_fwd_pack(pf), d, lt, slot)
    err = vs_plain("fwd_parser_multi", got, mm.fwd_pack_scores_ref(
        mm.build_fwd_pack(pf), d, lt, slot))
    run.note_err("fwd_parser_multi", err)
    for name, make, build, word, call, ref, single in (
            ("msv_filter_multi", ssv.msv_params, mm.build_msv_pack,
             lambda p, n: p.tjb_for([n])[0], mm.msv_ssv_multi,
             mm.msv_ssv_multi_ref, ssv.msv_ssv),
            ("vit_filter_multi", vit.vit_params, mm.build_vit_pack,
             lambda p, n: p.move_for([n])[0], mm.vit_ints_multi,
             mm.vit_ints_multi_ref, vit.vit_ints)):
        ps = [make(o, DEV) for o in oms]
        w = ints([word(ps[g], int(n)) for g, n in zip(slot, lens)])
        pack = build(ps)
        out = held(run, name, call(pack, flat, offs, ln, w, slot),
                   ref(pack, flat, offs, ln, w, slot), SEG_M)
        on = torch.from_numpy(slot == 0).to(DEV)
        one = single(flat, offs, ln, w, ps[0])
        if not all(torch.equal(a[on], b[on]) for a, b in zip(out, one)):
            fail(f"{name} in one launch with M = {M_SEARCH} differs from the "
                 f"single-model entry at M = {SEG_M}")
    one = fwd.fwd_score(d, lt, pf[0])
    on = torch.from_numpy(slot == 0).to(DEV)
    if not torch.equal(one[on], got[on]):
        fail(f"the gate in one launch with M = {M_SEARCH} differs from the "
             f"single-model entry at M = {SEG_M}")
    return dict(fwd_err=err, msv_identical=True, vit_identical=True,
                single_model_entry="bit for bit")


def parity_segmented(run: Run, cases, mixed=True) -> None:
    """The (family, M) <cases>, then (with <mixed>) the one-launch mix;
    each case's seconds printed."""
    from bath_tpu_torch.ops.kernels import loader
    rng = np.random.default_rng(SEED + 17)
    for fam, M in cases:
        t = time.perf_counter()
        info = seg_family(run, fam, M, rng)
        lay = (loader.fs3_layout if fam == "fs3" else loader.vit_layout
               if fam == "vit" else loader.msv_layout if fam == "ssv"
               else loader.layout)(M)
        phase("parity", case="segmented", family=fam, M=M,
              segments=loader.segments(*lay), B=LONG_ITEMS[0], **info,
              seconds=f"{time.perf_counter() - t:.1f}")
    if not mixed:
        return
    t = time.perf_counter()
    info = seg_mixed(run, rng)
    phase("parity", case="one launch of M = 400 and 40000",
          kernels="fwd_parser,msv_filter,vit_filter", **info,
          seconds=f"{time.perf_counter() - t:.1f}")


def rescore_batch(run: Run, lens, seed: int):
    """(profile, residues, length models) of envelopes of <lens>
    residues under the M_SEARCH model (``fixtures.envelope_batch``)."""
    from bath_tpu_torch import fixtures
    hmm, q, _ = run.once("q400", query400)
    om = fixtures.search_profile(hmm)
    return (om, *fixtures.envelope_batch(om, q, lens,
                                         np.random.default_rng(seed)))


def parity_rescore(run: Run) -> None:
    """The envelope fills at M_SEARCH on envelopes of 1-777 residues,
    every status, and every float of the region of each fill that did
    not fail, bit for bit the host fills (``ops/rescore.py``
    ``same_fills``)."""
    from bath_tpu_torch.ops import rescore as rr
    om, dsqs, xffs = rescore_batch(run, PARITY_RESCORE, SEED + 20)
    got = rr.rescore(rr.rescore_params(om, DEV), dsqs, xffs)
    want = rr.rescore(rr.rescore_params(om), dsqs, xffs)
    if not rr.same_fills(got, want):
        fail("rescore kernel vs the native fills: not bit for bit")
    run.note_err("rescore", 0.0)
    phase("parity", kernel="rescore", M=M_SEARCH, B=len(dsqs),
          L=f"1..{max(PARITY_RESCORE)}", bit_identical=True,
          failed=sum(f.status != 0 for f in want),
          rescaled=sum(bool((f.spec("fscale") != 1).any()) for f in want))


def phase_parity(run: Run) -> None:
    rng = np.random.default_rng(SEED + 7)
    parity_rescore(run)
    parity_single(run, rng)
    parity_fs3(run, rng, PARITY_FS3, PARITY_FS3DD)
    parity_int(run, LONG_ORF)
    parity_msv_native(run)
    parity_multi(run)
    parity_long(run)
    parity_segmented(run, [(f, SEG_M) for f in SEG_M_FAMILIES]
                     + sorted(SEG_PAST.items()))


# ---------------------------------------------------------------------
# timing: the entries at the main paths' shapes
# ---------------------------------------------------------------------
def time_fwd_domdec(run: Run) -> None:
    """The Forward gate and decoding on ORFs of the search genome."""
    from bath_tpu_torch import fixtures
    from bath_tpu_torch.ops import domdec as dd
    from bath_tpu_torch.ops import fwd
    from bath_tpu_torch.ops.kernels import loader
    fx = run.fx()
    for M in TIME_FWD_M:
        hm, _ = fixtures.make_query(M, np.random.default_rng(M),
                                    calibrate=False)
        pm = fwd.fwd_params(fixtures.search_profile(hm), DEV)
        ln, d, lt = one_batch(fixtures.sample_orfs(fx.fasta_path, TIME_FWD_B,
                                                   SEED))
        launch = loader.prepare_fwd(d, lt, None, pm)
        k_ms = cuda_ms(lambda: launch(1.0), 20)
        w_ms = cuda_ms(lambda: fwd.fwd_score(d, lt, pm), 20)
        p_ms = once_ms(lambda: fwd.fwd_score_ref(d, lt, pm))
        cells = float(ln.sum()) * M
        t = (k_ms, p_ms, *bound(
            "fwd_parser", cells,
            nbytes(d, lt, *pm.padded(loader.layout(M)[2])) + 4 * len(ln)))
        if M == TIME_FWD_M[0]:
            run.times["fwd_parser"] = t
            run.extra["fwd_parser"] = {"wrapper_ms": w_ms}
        phase("timing", kernel="fwd_parser", M=M, B=TIME_FWD_B,
              mean_L=f"{ln.mean():.1f}", max_L=int(ln.max()),
              launches_per_call=launch.launches,
              block_warps=launch.plan.warps,
              ms=f"{k_ms:.4f}", wrapper_ms=f"{w_ms:.4f}",
              plain_ms=f"{p_ms:.2f}",
              gcups=f"{cells / k_ms / 1e6:.2f}",
              plain_gcups=f"{cells / p_ms / 1e6:.3f}")
    _, _, p400 = run.once("q400", query400)
    ln, d, lt = one_batch(fixtures.sample_orfs(fx.fasta_path, TIME_DOMDEC_B,
                                               SEED, min_len=100))
    launch = loader.prepare_domdec(d, lt, None, p400)
    k_ms = cuda_ms(lambda: launch(1.0), 10)
    w_ms = cuda_ms(lambda: dd.domdec(d, lt, p400), 10)
    p_ms = once_ms(lambda: dd.domdec_ref(d, lt, p400))
    cells = float(ln.sum()) * M_SEARCH
    run.times["domdec"] = (k_ms, p_ms, *bound(
        "domdec", cells,
        nbytes(d, lt, *p400.padded(loader.layout(M_SEARCH)[2]))
        + 4 * 3 * d.shape[0] * (d.shape[1] + 1) + len(ln)))
    run.extra["domdec"] = {"wrapper_ms": w_ms}
    phase("timing", kernel="domdec", M=M_SEARCH, B=TIME_DOMDEC_B, min_L=100,
          mean_L=f"{ln.mean():.1f}", max_L=int(ln.max()),
          ms=f"{k_ms:.4f}", wrapper_ms=f"{w_ms:.4f}", plain_ms=f"{p_ms:.2f}",
          launches_per_call=launch.launches, blocks=launch.plan.nblk,
          block_warps=launch.plan.warps,
          us_per_row=f"{1e3 * k_ms / int(ln.max()):.3f}",
          gcups=f"{cells / k_ms / 1e6:.2f}", card=repr(run.card))


def time_fs3(run: Run, Ms, decoding: bool) -> None:
    """The fs3 gate on windows of its shape (2 * max_length * 3 nt) cut
    from the search genome at each M of <Ms> (GCUPS count nucleotides x
    M); with <decoding>, fs3 decoding on TIME_FS3DD_B of the last M's
    windows.  ``ms`` is the kernel's launch alone (the batch checked and
    planned beforehand, ``loader.prepare_fs3``), ``wrapper_ms`` the
    wrapper's call, checks and plan included.  The record takes
    M = TIME_FS3_M[1]."""
    from bath_tpu_torch import fixtures
    from bath_tpu_torch.ops import fs3
    from bath_tpu_torch.ops import fs3_domdec as fdd
    from bath_tpu_torch.ops.kernels import loader
    fx = run.fx()
    for M in Ms:
        hm, _ = fixtures.make_query(M, np.random.default_rng(M),
                                    calibrate=False, fs=True)
        hm.set_max_length()
        pm = fs3.fs3_params(fixtures.fs_search_profile(hm), DEV)
        wlen = 6 * hm.max_length
        ln, d, lt = one_batch(fixtures.sample_windows(
            fx.fasta_path, TIME_FS3_B, wlen, SEED), pad=17)
        launch = loader.prepare_fs3(d, lt, None, pm, False)
        k_ms = cuda_ms(lambda: launch(1.0), 5)
        w_ms = cuda_ms(lambda: fs3.fs3_score(d, lt, pm), 5)
        p_ms = once_ms(lambda: fs3.fs3_score_ref(d, lt, pm))
        cells = float(ln.sum()) * M
        t = (k_ms, p_ms, *bound(
            "fs3_parser", cells,
            nbytes(d, lt, *pm.padded(loader.fs3_layout(M)[2])) + 4 * len(ln)))
        if M == TIME_FS3_M[1]:
            run.times["fs3_parser"] = t
            run.extra["fs3_parser"] = {"wrapper_ms": w_ms}
        phase("timing", kernel="fs3_parser", M=M, B=TIME_FS3_B, L=wlen,
              layout=loader.fs3_layout(M), ms=f"{k_ms:.4f}",
              wrapper_ms=f"{w_ms:.4f}", plain_ms=f"{p_ms:.2f}",
              launches_per_call=launch.launches,
              us_per_row=f"{1e3 * k_ms / int(ln.max()):.3f}",
              gcups=f"{cells / k_ms / 1e6:.2f}",
              plain_gcups=f"{cells / p_ms / 1e6:.3f}", card=repr(run.card))
    if not decoding:
        return
    ddd, ldd = d[:TIME_FS3DD_B], lt[:TIME_FS3DD_B]
    launch = loader.prepare_fs3(ddd, ldd, None, pm, True)
    k_ms = cuda_ms(lambda: launch(1.0), 3)
    w_ms = cuda_ms(lambda: fdd.fs3_domdec(ddd, ldd, pm, 100.0 / 103.0), 3)
    p_ms = once_ms(lambda: fdd.fs3_domdec_ref(ddd, ldd, pm, 100.0 / 103.0))
    cells = float(TIME_FS3DD_B) * wlen * M
    run.times["fs3_domdec"] = (k_ms, p_ms, *bound(
        "fs3_domdec", cells,
        nbytes(ddd, ldd, *pm.padded(loader.fs3_layout(M)[2]))
        + 4 * 3 * TIME_FS3DD_B * (wlen + 1) + TIME_FS3DD_B))
    run.extra["fs3_domdec"] = {"wrapper_ms": w_ms}
    phase("timing", kernel="fs3_domdec", M=M, B=TIME_FS3DD_B, L=wlen,
          ms=f"{k_ms:.4f}", wrapper_ms=f"{w_ms:.4f}", plain_ms=f"{p_ms:.2f}",
          launches_per_call=launch.launches,
          us_per_row=f"{1e3 * k_ms / int(ldd.max()):.3f}",
          gcups=f"{cells / k_ms / 1e6:.2f}", card=repr(run.card))


def time_int(run: Run) -> None:
    """The integer filters: MSV over one flush of the search genome's
    ORFs (the flat stream flush_gates hands over), the ViterbiFilter and
    both captures over TIME_INT_B of them, at the default F1/F2
    thresholds on the null scores; beside each kernel its plain version
    and, for MSV and Viterbi, the native host library's OpenMP batch on
    the same ORFs in the flat layout its ORF extractor hands over.
    Then the four held exactly on one flush, more ORFs than the card
    has resident warps, so every warp's grid-stride loop takes further
    ORFs."""
    from bath_tpu_torch import fixtures
    from bath_tpu_torch.bg import Background
    from bath_tpu_torch.cli.bathsearch import CHUNK_ORFS
    from bath_tpu_torch.native import (msv_filter_native_batch,
                                       vit_filter_score_batch)
    from bath_tpu_torch.ops import multimodel as mm
    from bath_tpu_torch.ops import ssv, vit
    from bath_tpu_torch.ops.kernels import loader
    fx, om = run.fx(), run.om()
    cas, all_orfs = cascade(run)
    pm, pv = cas.msv, cas.vit
    f_orfs = all_orfs[:CHUNK_ORFS]
    f_host = host_layout(f_orfs)
    f_flat, f_offs, f_lens = (torch.from_numpy(a).to(DEV)
                              for a in ssv.pack_stream(f_orfs))
    f_tjb = ints(pm.tjb_for(f_lens.cpu().numpy()))
    fa = (f_flat, f_offs, f_lens, f_tjb, pm)
    launch = loader.prepare_msv(f_flat, f_offs, f_lens, f_tjb, None, pm)
    k_ms = cuda_ms(launch, 20)
    w_ms = cuda_ms(lambda: ssv.msv_ssv(*fa), 20)
    p_ms = once_ms(lambda: ssv.msv_ssv_ref(*fa))
    held(run, "msv_filter", ssv.msv_ssv(*fa), ssv.msv_ssv_ref(*fa), M_SEARCH)
    h_ms = host_ms(lambda: msv_filter_native_batch(f_host, om))
    cells = float(f_lens.sum()) * M_SEARCH
    Mp400 = loader.layout(M_SEARCH)[2]
    run.times["msv_filter"] = (k_ms, p_ms, *bound(
        "msv_filter", cells,
        nbytes(f_flat, f_offs, f_lens, f_tjb, pm.table(Mp400))
        + 4 * 3 * len(f_orfs)))
    run.extra["msv_filter"] = {"wrapper_ms": w_ms}
    phase("timing", kernel="msv_filter", M=M_SEARCH, B=len(f_orfs),
          layout="flat", launches_per_call=launch.launches,
          block_warps=launch.plan.warps,
          mean_L=f"{float(f_lens.float().mean()):.1f}",
          max_L=int(f_lens.max()), ms=f"{k_ms:.4f}", wrapper_ms=f"{w_ms:.4f}",
          plain_ms=f"{p_ms:.2f}",
          host_native_batch_ms=f"{h_ms:.2f}", host_cores=os.cpu_count(),
          gcups=f"{cells / k_ms / 1e6:.2f}",
          host_gcups=f"{cells / h_ms / 1e6:.2f}", card=repr(run.card))
    v_orfs = fixtures.sample_orfs(fx.fasta_path, TIME_INT_B, SEED)
    v_host = host_layout(v_orfs)
    v_flat, v_offs, v_lens = (torch.from_numpy(a).to(DEV)
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
    for name, launch, k_fn, p_fn, host in (
            ("vit_filter", loader.prepare_vit(*va, move, None, pv),
             lambda: vit.vit_ints(*va, move, pv),
             lambda: vit.vit_ints_ref(*va, move, pv),
             lambda: vit_filter_score_batch(v_host, np.arange(TIME_INT_B),
                                            om)),
            ("ssv_capture",
             loader.prepare_ssv_capture(*va, tjb, s_thr, pm),
             lambda: ssv.ssv_capture(*va, tjb, s_thr, pm),
             lambda: ssv.ssv_capture_ref(*va, tjb, s_thr, pm), None),
            ("vit_capture", loader.prepare_vit(*va, move, None, pv, v_thr),
             lambda: vit.vit_capture(*va, move, v_thr, pv),
             lambda: vit.vit_capture_ref(*va, move, v_thr, pv), None)):
        k_ms = cuda_ms(launch, 20)
        w_ms = cuda_ms(k_fn, 20)
        p_ms = once_ms(p_fn)
        h_ms = host_ms(host) if host else None
        out = held(run, name, k_fn(), p_fn(), M_SEARCH)
        run.times[name] = (k_ms, p_ms, *bound(
            name, cells,
            nbytes(v_flat, v_offs, v_lens, move, v_thr,
                   (pv if name.startswith("vit") else pm).table(Mp400))
            + nbytes(*out)))
        run.extra[name] = {"wrapper_ms": w_ms}
        events = {"ssv_capture": lambda: int(out[0].sum()),
                  "vit_capture": lambda: int((out[0] != 0).sum()),
                  "vit_filter": lambda: int(out[2].sum())}[name]()
        plan = {} if launch.plan is None else dict(
            blocks=launch.plan.nblk, block_warps=launch.plan.warps)
        if name == "ssv_capture":
            # one class row, its ORFs dealt round the blocks
            plan["blocks"] = mm.ssv_blocks(
                TIME_INT_B, int(launch.plan.table[5]), loader.sms(DEV))[1]
            plan["us_per_row"] = f"{1e3 * k_ms / int(vl.max()):.4f}"
            run.extra[name].update(us_per_row=1e3 * k_ms / int(vl.max()),
                                   max_L=int(vl.max()))
        phase("timing", kernel=name, M=M_SEARCH, B=TIME_INT_B,
              mean_L=f"{vl.mean():.1f}", max_L=int(vl.max()),
              ms=f"{k_ms:.4f}", wrapper_ms=f"{w_ms:.4f}", **plan,
              plain_ms=f"{p_ms:.2f}",
              host_native_batch_ms="not timed" if h_ms is None
              else f"{h_ms:.2f}",
              gcups=f"{cells / k_ms / 1e6:.2f}",
              **({"events": events} if name != "vit_filter"
                 else {"overflow": events}), card=repr(run.card))
    resident = torch.cuda.get_device_properties(DEV).multi_processor_count \
        * 64
    if len(f_orfs) <= resident:
        fail(f"{len(f_orfs)} ORFs do not outnumber {resident} warps")
    f_move = ints(pv.move_for(f_lens.cpu().numpy()))
    f_sthr, f_vthr = (ints(np.full(len(f_orfs), t))
                      for t in (SSV_THR, VIT_THR))
    fo = (f_flat, f_offs, f_lens)
    held(run, "vit_filter", vit.vit_ints(*fo, f_move, pv),
         vit.vit_ints_ref(*fo, f_move, pv), M_SEARCH)
    ev = held(run, "ssv_capture", ssv.ssv_capture(*fo, f_tjb, f_sthr, pm),
              ssv.ssv_capture_ref(*fo, f_tjb, f_sthr, pm), M_SEARCH)[0]
    kr = held(run, "vit_capture", vit.vit_capture(*fo, f_move, f_vthr, pv),
              vit.vit_capture_ref(*fo, f_move, f_vthr, pv), M_SEARCH)[0]
    phase("parity", kernel="msv_filter,ssv_capture,vit_filter,vit_capture",
          M=M_SEARCH, B=len(f_orfs), resident_warps_max=resident,
          ssvcap_events=int(ev.sum()), vitcap_events=int((kr != 0).sum()),
          identical=True)


def mq_models(run: Run):
    """The 48 multi-query models (uncalibrated, with max_length), their
    two packs, and the drive-shaped fs3 window batches (windows of
    2 * max_length * 3 nt of each window's model)."""
    from bath_tpu_torch import fixtures
    from bath_tpu_torch.ops import fs3, fwd
    from bath_tpu_torch.ops import multimodel as mm

    def make():
        rng = np.random.default_rng(SEED + 1)
        hmms = []
        for M in MQ_MS:
            hm, _ = fixtures.make_query(M, rng, calibrate=False, fs=True)
            hm.set_max_length()
            hmms.append(hm)
        std_pack = mm.build_fwd_pack(
            [fwd.fwd_params(fixtures.search_profile(h), DEV) for h in hmms])
        fs_pack = mm.build_fs3_pack(
            [fs3.fs3_params(fixtures.fs_search_profile(h), DEV)
             for h in hmms])
        fasta = run.fx().fasta_path
        wlens = np.array([6 * h.max_length for h in hmms])
        windows = fixtures.sample_windows(fasta, TIME_MQ_FS3_B,
                                          int(wlens.max()), SEED)
        fs_slot = rng.integers(0, len(MQ_MS), TIME_MQ_FS3_B)
        windows = [w[:wlens[g]] for w, g in zip(windows, fs_slot)]
        dd_slot = np.resize(np.asarray(MQ_EMBEDDED), TIME_MQ_FS3DD_B)
        dd_windows = [w[:wlens[g]] for w, g in zip(
            fixtures.sample_windows(fasta, TIME_MQ_FS3DD_B, int(wlens.max()),
                                    SEED + 2), dd_slot)]
        return dict(hmms=hmms, std_pack=std_pack, fs_pack=fs_pack,
                    windows=windows, fs_slot=fs_slot, dd_windows=dd_windows,
                    dd_slot=dd_slot, rng=rng)
    return run.once("mq_models", make)


def time_multi(run, name, pack, items, sl, pad, call, single, prepare,
               reps, extra=(), plain_models=range(len(MQ_MS)), record=True):
    """Times one multi-model entry on <items> under the models <sl>,
    beside one single-model launch per model, and holds its output
    against the single-model entries' on all items (the gates bit for
    bit, the decoders' posteriors within 1e-6: torch.cumsum) and
    against the plain version's on the items of <plain_models>, which it
    times.  ``ms`` is the kernel's launch alone (<prepare>(dsq, lens,
    slots) checks and plans beforehand), ``wrapper_ms`` the wrapper's
    call."""
    from bath_tpu_torch.ops import multimodel as mm
    ln, d, lt = one_batch(items, pad=pad)
    # one_batch sorts by length: carry the slots along
    order = np.argsort([len(o) for o in items], kind="stable")
    sl = np.asarray(sl)[order]
    split = [(r, pack.params[g], d[r].contiguous(), lt[r].contiguous())
             for g, r in model_rows(sl) if len(r)]
    w_ms = cuda_ms(lambda: call(pack, d, lt, sl, *extra), reps)
    launch = prepare(d, lt, sl)
    k_ms = cuda_ms(lambda: launch(1.0), reps)
    plan_keys = {}
    if launch.plan is not None:
        # each class's longest item and rows a microsecond of the
        # longest chain
        plan_keys = dict(class_max_L={Mp: L for _, _, Mp, _, L
                                      in launch.plan.classes},
                         blocks=launch.plan.nblk,
                         us_per_row=f"{1e3 * k_ms / int(ln.max()):.3f}")
    s_ms = cuda_ms(lambda: [single(dg, lg, pg, *extra)
                            for _, pg, dg, lg in split], reps)
    out = call(pack, d, lt, sl, *extra)
    outs = out if isinstance(out, tuple) else (out,)
    for r, pg, dg, lg in split:
        one = single(dg, lg, pg, *extra)
        one = one if isinstance(one, tuple) else (one,)
        if not (torch.equal(one[-1], outs[-1][r]) and all(
                max_err(a, b[r]) <= 1e-6 for a, b in zip(one[:-1],
                                                          outs[:-1]))):
            fail(f"{name} differs from the single-model entry on the "
                 "timing batch")
    sub, rs = plain_subset(sl, list(plain_models))
    ds, ls = d[rs].contiguous(), lt[rs].contiguous()
    want = []
    p_ms = once_ms(lambda: want.append(
        getattr(mm, call.__name__ + "_ref")(pack, ds, ls, sl[sub], *extra)))
    got = tuple(t[rs] for t in outs)
    err = vs_plain(name, got if len(outs) > 1 else got[0], want[0])
    run.note_err(name, err)
    cells = float((ln[order] * np.asarray(MQ_MS, np.float64)[sl]).sum())
    tabs = [t for c in pack.classes.values() for t in (c.etab, c.ttab)]
    t = (k_ms, p_ms, *bound(name, cells, nbytes(d, lt, *tabs, *outs)))
    if record:
        run.times[name] = t
        run.extra[name] = {"plain_items": len(sub), "wrapper_ms": w_ms}
    phase("timing", kernel=name, models=len(split), B=len(items),
          mean_L=f"{ln.mean():.1f}", max_L=int(ln.max()),
          launches_per_call=launch.launches, ms=f"{k_ms:.4f}",
          wrapper_ms=f"{w_ms:.4f}", **plan_keys,
          per_model_launches_ms=f"{s_ms:.4f}", plain_ms=f"{p_ms:.2f}",
          plain_items=len(sub), plain_models=len(set(sl[sub].tolist())),
          vs_plain=err, tol=DOMDEC_TOL if len(outs) > 1 else FWD_TOL,
          single_model_entry="agrees", gcups=f"{cells / k_ms / 1e6:.2f}",
          bound_ms=f"{t[2]:.5f}", bound_by=t[3], card=repr(run.card))


def time_multi_fs3(run: Run, plain_fs3, plain_fs3dd, record=True) -> None:
    """The fs3 pair of multi-model entries at the drive's shapes, their
    plain versions on the items of the models <plain_fs3>,
    <plain_fs3dd>."""
    from bath_tpu_torch.ops import fs3
    from bath_tpu_torch.ops import fs3_domdec as fdd
    from bath_tpu_torch.ops import multimodel as mm
    from bath_tpu_torch.ops.kernels import loader
    m = mq_models(run)
    pk = m["fs_pack"]
    time_multi(run, "fs3_parser_multi", pk, m["windows"], m["fs_slot"], 17,
               mm.fs3_pack_scores, fs3.fs3_score,
               lambda d, lt, sl: loader.prepare_fs3(d, lt, sl, pk, False), 3,
               plain_models=plain_fs3, record=record)
    time_multi(run, "fs3_domdec_multi", pk, m["dd_windows"], m["dd_slot"], 17,
               mm.fs3_domdec_pack_batch, fdd.fs3_domdec,
               lambda d, lt, sl: loader.prepare_fs3(d, lt, sl, pk, True), 2,
               extra=(100.0 / 103.0,), plain_models=plain_fs3dd,
               record=record)


def time_multi_all(run: Run) -> None:
    """The four f32 multi-model entries at the multi-query drive's
    shapes: genome ORFs (Forward gate, decoding) and genome windows
    (fs3 pair), their models drawn over all 48."""
    from bath_tpu_torch import fixtures
    from bath_tpu_torch.ops import domdec as dd
    from bath_tpu_torch.ops import fwd
    from bath_tpu_torch.ops import multimodel as mm
    from bath_tpu_torch.ops.kernels import loader
    m = mq_models(run)
    pk = m["std_pack"]
    fasta = run.fx().fasta_path
    time_multi(run, "fwd_parser_multi", pk,
               fixtures.sample_orfs(fasta, TIME_MQ_FWD_B, SEED),
               m["rng"].integers(0, len(MQ_MS), TIME_MQ_FWD_B), 28,
               mm.fwd_pack_scores, fwd.fwd_score,
               lambda d, lt, sl: loader.prepare_fwd(d, lt, sl, pk), 10)
    time_multi(run, "domdec_multi", pk,
               fixtures.sample_orfs(fasta, TIME_MQ_DOMDEC_B, SEED,
                                    min_len=100),
               m["rng"].integers(0, len(MQ_MS), TIME_MQ_DOMDEC_B), 28,
               mm.domdec_pack_batch, dd.domdec,
               lambda d, lt, sl: loader.prepare_domdec(d, lt, sl, pk), 5,
               plain_models=TIME_MQ_PLAIN_DOMDEC)
    time_multi_fs3(run, TIME_MQ_PLAIN_FS3, TIME_MQ_PLAIN_FS3DD)


def time_int_multi(run: Run) -> None:
    """The two integer multi-model entries at the device calibration's
    shapes: the 48 models, each over the one shared batch of 200 x 200
    aa (item b = model b // 200, sequence b % 200, read at a repeated
    offset).  Each equal to its plain version and, model by model, to
    the single-model entry and to the native host batch; timed beside
    one single-model launch per model and the host batches."""
    from bath_tpu_torch import evalues_device as ed
    from bath_tpu_torch.bg import Background
    from bath_tpu_torch.evalues import CalibrateConfig
    from bath_tpu_torch.native import (msv_filter_native_batch,
                                       vit_filter_score_batch)
    from bath_tpu_torch.ops import multimodel as mm
    from bath_tpu_torch.ops import ssv, vit
    from bath_tpu_torch.ops.kernels import loader
    from bath_tpu_torch.oprofile import oprofile_convert
    from bath_tpu_torch.profile import profile_config
    ccfg = CalibrateConfig(fs=True)
    cal_draws = ed.shared_draws(ccfg, Background())
    cal_oms = [oprofile_convert(profile_config(h, Background(), L=ccfg.EvL))
               for h in mq_models(run)["hmms"]]
    Ms = np.asarray(MQ_MS, np.float64)

    def int_multi(name, batch, make, build_pack, word_for, call, ref,
                  single, prepare, scores, native):
        N, L = batch.shape
        params = [make(om_g, DEV) for om_g in cal_oms]
        pack = build_pack(params)
        flat, offs, lens, slot = ed.shared_stream(batch, len(cal_oms), DEV)
        word = ed.per_model_words([word_for(p_g, L) for p_g in params], N,
                                  DEV)
        args = (flat, offs, lens, word)
        got = call(pack, *args, slot)
        want = []
        p_ms = once_ms(lambda: want.append(ref(pack, *args, slot)))
        if not all(torch.equal(a, b) for a, b in zip(got, want[0])):
            fail(f"{name} differs from its plain version: max |d| "
                 f"{exact(got, want[0])}")
        run.note_err(name, exact(got, want[0]))
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
        launch = prepare(*args, slot, pack)
        k_ms = cuda_ms(launch, 10)
        w_ms = cuda_ms(lambda: call(pack, *args, slot), 10)
        s_ms = cuda_ms(lambda: [single(flat, o_g, l_g, w_g, p_g)
                                for p_g, _, o_g, l_g, w_g in split], 5)
        h_ms = host_ms(lambda: [native(host, om_g) for om_g in cal_oms])
        cells = float(N * L * Ms.sum())
        tabs = [t for c in pack.classes.values() for t in (c.tab, c.scal)]
        run.times[name] = (k_ms, p_ms, *bound(name, cells,
                                              nbytes(*args, *tabs, *got)))
        run.extra[name] = {"plain_items": len(slot), "wrapper_ms": w_ms}
        plan = {} if launch.plan is None else dict(
            blocks=launch.plan.nblk, block_warps=launch.plan.warps,
            us_per_row=f"{1e3 * k_ms / L:.3f}")
        phase("timing", kernel=name, models=len(cal_oms),
              M=f"{min(MQ_MS)}..{max(MQ_MS)}", widths=sorted(pack.classes),
              B=len(slot), batch=f"{N}x{L}", vs_plain="identical",
              max_abs_err=run.err[name],
              single_model_entry="bit for bit", native_host_batch="identical",
              launches_per_call=launch.launches, ms=f"{k_ms:.4f}",
              wrapper_ms=f"{w_ms:.4f}", **plan,
              per_model_launches_ms=f"{s_ms:.4f}", plain_ms=f"{p_ms:.2f}",
              host_native_batches_ms=f"{h_ms:.2f}", host_cores=os.cpu_count(),
              gcups=f"{cells / k_ms / 1e6:.2f}",
              bound_ms=f"{run.times[name][2]:.5f}",
              bound_by=run.times[name][3], card=repr(run.card))

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
              mm.msv_ssv_multi, mm.msv_ssv_multi_ref, ssv.msv_ssv,
              loader.prepare_msv, msv_nats, msv_filter_native_batch)
    int_multi("vit_filter_multi", cal_draws.vit, vit.vit_params,
              mm.build_vit_pack, lambda p_g, L: p_g.move_for([L])[0],
              mm.vit_ints_multi, mm.vit_ints_multi_ref, vit.vit_ints,
              loader.prepare_vit, vit_nats,
              lambda h, om_g: vit_filter_score_batch(
                  h, np.arange(len(h)), om_g))


def time_rescore(run: Run) -> None:
    """The envelope fills of a flush of the benchmark's cell:
    TIME_RESCORE_B envelopes of M_SEARCH residues under the M_SEARCH
    model; ``ms`` the bare launch, ``wrapper_ms`` the stage's call with
    its copies into pinned memory, ``plain_ms`` the native host fills."""
    from bath_tpu_torch.ops import rescore as rr
    om, dsqs, xffs = rescore_batch(run, [M_SEARCH] * TIME_RESCORE_B,
                                   SEED + 21)
    p = rr.rescore_params(om, DEV)
    lens = np.array([len(d) for d in dsqs], np.int64)
    launch, sizes = rr.prepare(p, dsqs, xffs, lens)
    k_ms = cuda_ms(launch, 5)
    w_ms = cuda_ms(lambda: rr.rescore(p, dsqs, xffs), 5)
    p_ms = host_ms(lambda: rr.rescore(rr.rescore_params(om), dsqs, xffs))
    cells = float(lens.sum()) * M_SEARCH
    run.times["rescore"] = (k_ms, p_ms, *bound(
        "rescore", cells, int(lens.sum()) + 4 * int(sizes.sum())
        + nbytes(p.tv, p.rfv)))
    run.extra["rescore"] = {"wrapper_ms": w_ms}
    phase("timing", kernel="rescore", M=M_SEARCH, B=TIME_RESCORE_B,
          L=M_SEARCH, ms=f"{k_ms:.4f}", wrapper_ms=f"{w_ms:.4f}",
          plain_ms=f"{p_ms:.2f}", launches_per_call=1,
          us_per_row=f"{1e3 * k_ms / M_SEARCH:.3f}",
          gcups=f"{cells / k_ms / 1e6:.3f}", card=repr(run.card))


def phase_timing(run: Run) -> None:
    time_rescore(run)
    time_fwd_domdec(run)
    time_fs3(run, TIME_FS3_M, decoding=True)
    time_int(run)
    time_multi_all(run)
    time_int_multi(run)


# ---------------------------------------------------------------------
# search: the port's CLI against its own host path
# ---------------------------------------------------------------------
def search_standard(run: Run) -> dict:
    """The standard search in turns (numpy, torch, torch, numpy); the
    port's --backend numpy is its own serial host drive.  The first
    torch run is the one whose launches are counted.  Returns the
    walls."""
    from bath_tpu_torch import fixtures
    from bath_tpu_torch.cli import bathsearch
    from bath_tpu_torch.ops import domdec as dd
    from bath_tpu_torch.ops import fwd
    from bath_tpu_torch.ops import rescore as rr
    fx = run.fx()
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
    rr.launch.launches = 0
    out_t, tbl_t = search("torch", stats)
    launches = {"fwd_parser": fwd.fwd_score.launches,
                "domdec": dd.domdec.launches,
                "rescore": rr.launch.launches}
    search("torch")
    search("numpy")
    run.cache["out_numpy"] = out_n
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
    run.launches.update(launches)
    return walls


def search_fs(run: Run) -> dict:
    """--fs and --fsonly on the frameshift twin of the genome: --fs in
    turns (numpy, torch, torch, numpy), --fsonly once each; the first
    torch --fs run is the one whose launches are counted.  Returns the
    walls."""
    from bath_tpu_torch import fixtures
    from bath_tpu_torch.cli import bathsearch
    from bath_tpu_torch.ops import domdec as dd
    from bath_tpu_torch.ops import fs3
    from bath_tpu_torch.ops import fs3_domdec as fdd
    from bath_tpu_torch.ops import fwd
    fs_fx = run.fs_fx()
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

    wrappers = (fwd.fwd_score, dd.domdec, fs3.fs3_score, fdd.fs3_domdec)
    fs_n = fs_search("numpy", "--fs")
    run.cache["fs_numpy"] = fs_n
    fs_stats: dict = {}
    for f in wrappers:
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
    for f in wrappers:
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
    run.launches["fs3_parser"] = fs_launches["fs3_parser"]
    run.launches["fs3_domdec"] = fs_launches["fs3_domdec"]
    return fs_walls


def search_all_device(run: Run, walls, fs_walls) -> None:
    """The all-device cascade (BATH_MSV_DEVICE=1 BATH_VIT_DEVICE=1):
    standard twice against the numpy run of the standard search, --fs
    once against the --fs one, then standard with LOOSE filter
    thresholds against a numpy run of its own; each run's launches are
    counted from 0, and the first run (the main path) must launch all
    four kernels."""
    from bath_tpu_torch import fixtures
    from bath_tpu_torch.cli import bathsearch
    from bath_tpu_torch.ops import ssv, vit
    fx, fs_fx = run.fx(), run.fs_fx()
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
    run.cache["ad_wall"] = ad_walls[0]
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
    out_n, fs_n = run.cache["out_numpy"], run.cache["fs_numpy"]
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
    run.launches.update(int_launches)


def search_long_model(run: Run) -> None:
    """The all-device search (BATH_MSV_DEVICE=1 BATH_VIT_DEVICE=1) with
    a model of SEG_SEARCH_M positions (past the ViterbiFilter's 16 warps
    of 17 lanes) against a seeded genome that carries SEG_SEARCH[1] copies
    of it (one across the first window boundary), at the LOOSE
    thresholds, byte-identical to --backend numpy; fails if a copy is
    missed or the ViterbiFilter, the captures, the gate or decoding did
    not launch."""
    from bath_tpu_torch import fixtures
    from bath_tpu_torch.cli import bathsearch
    from bath_tpu_torch.ops import domdec as dd
    from bath_tpu_torch.ops import fwd, ssv, vit
    t0 = time.perf_counter()
    fx = fixtures.write_fixture(SEG_SEARCH_M, *SEG_SEARCH, SEED)
    fns = {"msv_filter": ssv.msv_ssv, "ssv_capture": ssv.ssv_capture,
           "vit_filter": vit.vit_ints, "vit_capture": vit.vit_capture,
           "fwd_parser": fwd.fwd_score, "domdec": dd.domdec}
    outs, walls = {}, {}
    for backend in ("torch", "numpy"):
        saved = {k: os.environ.get(k) for k in ALL_DEVICE}
        if backend == "torch":
            os.environ.update(ALL_DEVICE)
        for f in fns.values():
            f.launches = 0
        outs[backend] = [BUILD / f"long_{backend}.{x}" for x in ("out", "tbl")]
        t = time.perf_counter()
        rc = bathsearch.run(["--backend", backend, "--device", DEVICE,
                             *LOOSE, "-o", str(outs[backend][0]),
                             "--tblout", str(outs[backend][1]), fx.hmm_path,
                             fx.fasta_path])
        torch.cuda.synchronize()
        walls[backend] = time.perf_counter() - t
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        if rc != 0:
            fail(f"bathsearch --backend {backend} with M={SEG_SEARCH_M} "
                 f"exited {rc}")
        if backend == "torch":
            launches = {k: f.launches for k, f in fns.items()}
    identical = masked(outs["torch"][0]) == masked(outs["numpy"][0])
    found = fixtures.embeds_found(str(outs["torch"][1]), fx)
    phase("e2e_long_model", M=SEG_SEARCH_M, genome_nt=SEG_SEARCH[0],
          copies=SEG_SEARCH[1], found_torch=found,
          found_numpy=fixtures.embeds_found(str(outs["numpy"][1]), fx),
          byte_identical=identical, thresholds=" ".join(LOOSE),
          wall_torch_s=f"{walls['torch']:.3f}",
          wall_numpy_s=f"{walls['numpy']:.3f}", launches=launches,
          seconds=f"{time.perf_counter() - t0:.1f}")
    if not identical:
        fail(f"the all-device search with M={SEG_SEARCH_M} differs from "
             "the numpy backend")
    if found < SEG_SEARCH[1]:
        fail(f"the all-device search with M={SEG_SEARCH_M} found "
             f"{found}/{SEG_SEARCH[1]} copies")
    missing = [k for k in ("vit_filter", "ssv_capture", "vit_capture",
                           "fwd_parser", "domdec") if launches[k] <= 0]
    if missing:
        fail(f"the all-device search with M={SEG_SEARCH_M} never launched "
             f"{missing}: {launches}")


def table(path) -> str:
    """A tabular output without its run-dependent lines."""
    return "".join(ln for ln in Path(path).read_text().splitlines(True)
                   if not ln.startswith(("# Option settings:", "# Date:",
                                         "# Current dir:")))


def search_splice(run: Run) -> None:
    """--splice on a seeded 5 Mb genome holding SPLICE_GENES genes of
    2-4 exons (``fixtures.write_splice_fixture``) against the M = 400
    profile, at the default --min_intron and --max_intron, in turns:
    numpy, torch, torch on the all-device cascade, numpy.  The seeds of
    the splice graph are the windows of the captures that the Forward
    gate passed.  Fails unless -o, --tblout and --exontblout equal the
    numpy run's, a hit has two exons or more, at least SPLICE_MIN_FOUND
    genes come out whole, the gate and decoding launched in both torch
    runs and the four integer entries in the all-device one."""
    from bath_tpu_torch import fixtures
    from bath_tpu_torch.cli import bathsearch
    from bath_tpu_torch.ops import domdec as dd
    from bath_tpu_torch.ops import fwd, ssv, vit
    t0 = time.perf_counter()
    fx = fixtures.write_splice_fixture(M_SEARCH, GENOME_NT, SPLICE_GENES,
                                       SEED)
    fns = {"fwd_parser": fwd.fwd_score, "domdec": dd.domdec,
           "msv_filter": ssv.msv_ssv, "ssv_capture": ssv.ssv_capture,
           "vit_filter": vit.vit_ints, "vit_capture": vit.vit_capture}
    outs, walls, splice_s, launches = {}, {}, {}, {}
    turns = {"numpy0": "numpy", "torch": "torch", "all_device": "torch",
             "numpy1": "numpy"}
    for turn, backend in turns.items():
        env = ALL_DEVICE if turn == "all_device" else \
            {k: "0" for k in ALL_DEVICE}
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        paths = [BUILD / f"splice_{turn}.{x}" for x in ("out", "tbl", "ex")]
        stats: dict = {}
        for f in fns.values():
            f.launches = 0
        t = time.perf_counter()
        rc = bathsearch.run(["--backend", backend, "--device", DEVICE,
                             "--splice", "-o", str(paths[0]), "--tblout",
                             str(paths[1]), "--exontblout", str(paths[2]),
                             fx.hmm_path, fx.fasta_path], stats=stats)
        torch.cuda.synchronize()
        walls[turn] = time.perf_counter() - t
        launches[turn] = {k: f.launches for k, f in fns.items()}
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        if rc != 0:
            fail(f"bathsearch --splice ({turn}) exited {rc}")
        outs[turn] = (masked(paths[0]), table(paths[1]), table(paths[2]))
        splice_s[turn] = stats["splice_s"]
    identical = {turn: outs[turn] == outs["numpy0"]
                 for turn in ("torch", "all_device", "numpy1")}
    exons = [len(s) for s in fixtures.exon_hits(BUILD / "splice_torch.ex")]
    found = fixtures.spliced_found(BUILD / "splice_torch.ex", fx)
    phase("e2e_splice", genome_nt=GENOME_NT, M=M_SEARCH,
          genes=SPLICE_GENES, found_torch=found,
          found_numpy=fixtures.spliced_found(BUILD / "splice_numpy0.ex", fx),
          min_found=SPLICE_MIN_FOUND, byte_identical=identical,
          hits=len(exons), exons_per_hit=",".join(map(str, exons)),
          walls_s=",".join(f"{k}:{w:.4f}" for k, w in walls.items()),
          splice_pass_s=",".join(f"{k}:{v:.4f}"
                                 for k, v in splice_s.items()),
          launches_torch=launches["torch"],
          launches_all_device=launches["all_device"],
          seconds=f"{time.perf_counter() - t0:.1f}", card=repr(run.card))
    if not all(identical.values()):
        fail(f"--splice output differs from the numpy backend: {identical}")
    if not exons or max(exons) < 2:
        fail(f"--splice reported no hit of two exons or more: {exons}")
    if found < SPLICE_MIN_FOUND:
        fail(f"--splice found {found}/{SPLICE_GENES} genes whole, below "
             f"{SPLICE_MIN_FOUND}")
    missing = [(turn, k) for turn in ("torch", "all_device")
               for k in fns if launches[turn][k] <= 0
               and (turn == "all_device" or k in ("fwd_parser", "domdec"))]
    if missing:
        fail(f"a kernel of the --splice path never launched: {missing}")


@contextlib.contextmanager
def hang_limit(what: str):
    """Fails the run, with every thread's stack, if <what> has not
    ended within CPU_RUN_LIMIT_S (a pool that hangs would otherwise eat
    the run's time limit)."""
    print(f"[hang_limit] {what} limit_s={CPU_RUN_LIMIT_S}", flush=True)
    faulthandler.dump_traceback_later(CPU_RUN_LIMIT_S, exit=True)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()


def cpu_search(argv, stats, tag, env=None):
    """(wall, rc) of one ``--cpu`` search in this process, under
    hang_limit, with <env> set for it."""
    from bath_tpu_torch.cli import bathsearch
    saved = {k: os.environ.get(k) for k in env or {}}
    os.environ.update(env or {})
    try:
        with hang_limit(tag):
            t = time.perf_counter()
            rc = bathsearch.run(argv, stats=stats)
            torch.cuda.synchronize()
            return time.perf_counter() - t, rc
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def search_cpu(run: Run, walls, fs_walls) -> None:
    """--cpu CPU_WORKERS in this process, after every earlier search
    (ORF extraction has run its OpenMP teams here, and the card's
    context is held): the 5 Mb x M = 400 search standard on the hybrid
    (workers beside the device cascade of this process) and on the
    numpy window pool, --fs on the hybrid, and a two-model query file
    (the splice model, then the M = 400 model) with --splice through
    the hybrid, whose second query's pool starts after the first
    query's teams and uploads.  Each is held byte for byte to the serial
    numpy run of the same search; each torch run's share of this
    process must have gone through its kernels (HYBRID_MAXQ)."""
    from bath_tpu_torch import fixtures
    from bath_tpu_torch.cli import bathsearch
    from bath_tpu_torch.ops import domdec as dd
    from bath_tpu_torch.ops import fs3, fwd
    from bath_tpu_torch.ops import fs3_domdec as fdd
    t0 = time.perf_counter()
    fx, fs_fx = run.fx(), run.fs_fx()
    sfx = fixtures.write_splice_fixture(M_SEARCH, GENOME_NT, SPLICE_GENES,
                                        SEED)
    two = BUILD / "splice_two.bhmm"
    two.write_text(Path(sfx.hmm_path).read_text()
                   + Path(fx.hmm_path).read_text())
    fns = {"fwd_parser": fwd.fwd_score, "domdec": dd.domdec,
           "fs3_parser": fs3.fs3_score, "fs3_domdec": fdd.fs3_domdec}
    cpu = ["--cpu", str(CPU_WORKERS)]
    splice = ["--splice"]
    # (backend, options, query, target, serial numpy outputs, kernels
    # that must launch)
    std_serial = (BUILD / "e2e_numpy0.out", BUILD / "e2e_numpy0.tbl")
    cases = {
        "standard_torch": ("torch", [], fx, None, std_serial,
                           ("fwd_parser", "domdec")),
        "standard_numpy": ("numpy", [], fx, None, std_serial, ()),
        "fs_torch": ("torch", ["--fs"], fs_fx, None,
                     tuple(run.cache["fs_numpy"][:2]),
                     ("fs3_parser", "fs3_domdec")),
        "splice_two_torch": ("torch", splice, sfx, str(two), None,
                             ("fwd_parser",)),
    }
    # the serial numpy run of the two-model --splice file
    serial_two = [BUILD / f"splice_two_numpy.{x}" for x in ("out", "tbl",
                                                            "ex")]
    t = time.perf_counter()
    rc = bathsearch.run(["--backend", "numpy", *splice, "-o",
                         str(serial_two[0]), "--tblout", str(serial_two[1]),
                         "--exontblout", str(serial_two[2]), str(two),
                         sfx.fasta_path])
    wall_two_serial = time.perf_counter() - t
    if rc != 0:
        fail(f"bathsearch --splice on two models exited {rc}")
    bad = []
    for name, (backend, opts, f, query, serial, need) in cases.items():
        paths = [BUILD / f"cpu_{name}.{x}" for x in ("out", "tbl", "ex")]
        argv = ["--backend", backend, "--device", DEVICE, *cpu, *opts,
                "-o", str(paths[0]), "--tblout", str(paths[1])]
        if opts == splice:
            argv += ["--exontblout", str(paths[2])]
        stats: dict = {}
        for fn in fns.values():
            fn.launches = 0
        wall, rc = cpu_search(argv + [query or f.hmm_path, f.fasta_path],
                              stats, f"cpu_{name}",
                              HYBRID_MAXQ if backend == "torch" else None)
        launches = {k: fn.launches for k, fn in fns.items()}
        if rc != 0:
            fail(f"bathsearch --cpu ({name}) exited {rc}")
        if serial is None:
            identical = (masked(paths[0]) == masked(serial_two[0])
                         and table(paths[1]) == table(serial_two[1])
                         and table(paths[2]) == table(serial_two[2]))
            serial_walls = {"numpy": [wall_two_serial]}
        else:
            identical = (masked(paths[0]) == masked(serial[0])
                         and rows(paths[1]) == rows(serial[1]))
            w = fs_walls if opts else walls
            serial_walls = {b: w[(b, "--fs")] if opts else w[b]
                            for b in ("torch", "numpy")}
        phase("e2e_cpu", run=name, cpu=CPU_WORKERS,
              host_cores=os.cpu_count(),
              byte_identical=identical, wall_s=f"{wall:.4f}",
              **{f"serial_{b}_walls_s": ",".join(f"{x:.4f}" for x in ws)
                 for b, ws in serial_walls.items()},
              hybrid_pool=stats.get("hybrid_pool"),
              hybrid_main=stats.get("hybrid_main"),
              pools=stats.get("pools"),
              pool_start_s=f"{stats.get('pool_start_s', 0.0):.4f}",
              pool_spawn_s=f"{stats.get('pool_spawn_s', 0.0):.4f}",
              pool_init_s=f"{stats.get('pool_init_s', 0.0):.4f}",
              worker_cuda=stats.get("worker_cuda"),
              worker_launches=stats.get("worker_launches"),
              cascade_s={k: round(stats[k], 4) for k in
                         ("fwd_s", "domdec_s", "fs3_s", "fs3domdec_s")
                         if stats.get(k)},
              launches=launches, card=repr(run.card))
        if not identical:
            bad.append(f"{name}: output differs from serial numpy")
        if stats.get("worker_cuda") != 0 or stats.get("worker_launches"):
            bad.append(f"{name}: a worker made a CUDA context or launched "
                       f"a kernel, or did not report: {stats}")
        if backend == "torch":
            if not (stats.get("hybrid_main", 0) > 0
                    and stats.get("hybrid_pool", 0) > 0):
                bad.append(f"{name}: the hybrid split "
                           f"{stats.get('hybrid_pool')} -> workers, "
                           f"{stats.get('hybrid_main')} -> main")
            if any(launches[k] <= 0 for k in need):
                bad.append(f"{name}: a kernel of the main's share never "
                           f"launched: {launches}")
        elif stats.get("pools") != 1:
            bad.append(f"{name}: no window pool ran: {stats}")
    phase("e2e_cpu", seconds=f"{time.perf_counter() - t0:.1f}",
          serial_two_model_splice_numpy_s=f"{wall_two_serial:.4f}")
    if bad:
        fail("--cpu: " + "; ".join(bad))


def mesh_options():
    """(CLI options, devices for ``bathsearch.run``, shares) of the
    --mesh drives: --mesh over every card of the machine, or on one card
    two shares of it through ``run``'s devices (the CLI never repeats a
    card)."""
    n = torch.cuda.device_count()
    if n > 1:
        return ["--mesh", str(n)], None, n
    return [], [DEV, DEV], 2


def mesh_shares_ok(tag, stats, n) -> dict:
    """The run's items per share and stage; fails unless every stage
    that had items had them on every share (a stage of fewer items than
    shares aside)."""
    shares = stats.get("mesh_items") or {}
    bad = {k: v for k, v in shares.items()
           if len(v) != n or (sum(v) >= n and min(v) == 0)}
    if not shares or bad:
        fail(f"{tag}: a share of the mesh got no items: {shares}")
    return shares


def search_mesh(run: Run, walls, fs_walls) -> None:
    """The 5 Mb x M = 400 searches over the mesh (``mesh_options``):
    standard, --fs and the all-device cascade (at the default
    thresholds), each byte-identical to the serial numpy run of the same
    search, every stage's items on every share (``mesh_items``), and the
    kernels of the path launched; walls beside the one-device torch
    runs'."""
    from bath_tpu_torch.cli import bathsearch
    from bath_tpu_torch.ops import domdec as dd
    from bath_tpu_torch.ops import fs3, fwd, ssv, vit
    from bath_tpu_torch.ops import fs3_domdec as fdd
    t0 = time.perf_counter()
    opts, devices, n = mesh_options()
    fx, fs_fx = run.fx(), run.fs_fx()
    std = (BUILD / "e2e_numpy0.out", BUILD / "e2e_numpy0.tbl", None)
    fns = {"fwd_parser": fwd.fwd_score, "domdec": dd.domdec,
           "fs3_parser": fs3.fs3_score, "fs3_domdec": fdd.fs3_domdec,
           "msv_filter": ssv.msv_ssv, "ssv_capture": ssv.ssv_capture,
           "vit_filter": vit.vit_ints, "vit_capture": vit.vit_capture}
    # (options, fixture, environment, serial numpy outputs, one-device
    # torch walls, kernels that must launch)
    cases = {
        "standard": ([], fx, {}, std, walls["torch"],
                     ("fwd_parser", "domdec")),
        "fs": (["--fs"], fs_fx, {}, tuple(run.cache["fs_numpy"]),
               fs_walls[("torch", "--fs")],
               ("fwd_parser", "fs3_parser", "fs3_domdec")),
        "all_device": ([], fx, ALL_DEVICE, std, [run.cache["ad_wall"]],
                       ("msv_filter", "ssv_capture", "vit_filter",
                        "vit_capture", "fwd_parser", "domdec")),
    }
    bad = []
    for name, (extra, f, env, serial, one_walls, need) in cases.items():
        paths = [BUILD / f"mesh_{name}.{x}" for x in ("out", "tbl", "fst")]
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        st: dict = {}
        for fn in fns.values():
            fn.launches = 0
        t = time.perf_counter()
        rc = bathsearch.run(["--backend", "torch", "--device", DEVICE,
                             *opts, *extra, "-o", str(paths[0]), "--tblout",
                             str(paths[1]), "--fstblout", str(paths[2]),
                             f.hmm_path, f.fasta_path], stats=st,
                            devices=devices)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        launches = {k: fn.launches for k, fn in fns.items()}
        if rc != 0:
            fail(f"bathsearch over the mesh ({name}) exited {rc}")
        identical = (masked(paths[0]) == masked(serial[0])
                     and rows(paths[1]) == rows(serial[1])
                     and (serial[2] is None
                          or rows(paths[2]) == rows(serial[2])))
        shares = mesh_shares_ok(f"mesh {name}", st, n)
        phase("e2e_mesh", run=name, shares=n, across_cards=devices is None,
              byte_identical=identical, wall_s=f"{wall:.4f}",
              one_device_torch_walls_s=",".join(f"{w:.4f}"
                                                for w in one_walls),
              mesh_items=shares, launches=launches, card=repr(run.card))
        if not identical:
            bad.append(f"{name}: output differs from serial numpy")
        missing = [k for k in need if launches[k] <= 0]
        if missing:
            bad.append(f"{name}: {missing} never launched: {launches}")
    if n < 2:
        phase("e2e_mesh", across_cards="not run: this machine has 1 card; "
              "the cascade ran two shares of it")
    phase("e2e_mesh", seconds=f"{time.perf_counter() - t0:.1f}")
    if bad:
        fail("--mesh: " + "; ".join(bad))


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def search_hosts(run: Run, walls) -> None:
    """--hosts HOSTS: rank processes of ``python -m
    bath_tpu_torch.cli.bathsearch --backend torch`` in one gloo group on
    a free port of this machine, on the standard 5 Mb x M = 400 search
    (its --fs turn went to the plain fs3 pair's timing models); each rank searches its windows on its card (rank % cards)
    and all take the merged result.  Fails unless every rank exits 0
    within HOSTS_LIMIT_S, rank 0's outputs equal the serial numpy run's
    and no other rank wrote a file; a rank still alive is killed (and
    the check after the last phase finds any left)."""
    t0 = time.perf_counter()
    std = (BUILD / "e2e_numpy0.out", BUILD / "e2e_numpy0.tbl", None)
    cases = {"standard": ([], run.fx(), std, walls)}
    bad = []
    for name, (extra, f, serial, one_walls) in cases.items():
        port = free_port()
        outs = [[BUILD / f"hosts_{name}{i}.{x}" for x in ("out", "tbl", "fst")]
                for i in range(HOSTS)]
        for p in (p for ps in outs for p in ps):
            p.unlink(missing_ok=True)
        procs = []
        t = time.perf_counter()
        for i, paths in enumerate(outs):
            with open(BUILD / f"hosts_{name}{i}.log", "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "bath_tpu_torch.cli.bathsearch",
                     "--backend", "torch", "--device", DEVICE, *extra,
                     "--hosts", str(HOSTS), "--host-id", str(i),
                     "--coordinator", f"localhost:{port}", "-o",
                     str(paths[0]), "--tblout", str(paths[1]),
                     "--fstblout", str(paths[2]), f.hmm_path, f.fasta_path],
                    cwd=ROOT, stdout=log, stderr=subprocess.STDOUT))
            CHILDREN.append(procs[-1])
        try:
            rcs = [p.wait(timeout=max(1.0, HOSTS_LIMIT_S
                                      - (time.perf_counter() - t)))
                   for p in procs]
        except subprocess.TimeoutExpired:
            stop_children()
            fail(f"--hosts {HOSTS} ({name}): a rank ran past "
                 f"{HOSTS_LIMIT_S} s")
        wall = time.perf_counter() - t
        logs = [(BUILD / f"hosts_{name}{i}.log").read_text()[-1500:]
                for i in range(HOSTS)]
        if any(rcs):
            fail(f"--hosts {HOSTS} ({name}): ranks exited {rcs}: {logs}")
        identical = (masked(outs[0][0]) == masked(serial[0])
                     and rows(outs[0][1]) == rows(serial[1])
                     and (serial[2] is None
                          or rows(outs[0][2]) == rows(serial[2])))
        wrote = [str(p) for ps in outs[1:] for p in ps if p.exists()]
        phase("e2e_hosts", run=name, ranks=HOSTS,
              cards=torch.cuda.device_count(), byte_identical=identical,
              other_ranks_wrote=wrote or "nothing", wall_s=f"{wall:.4f}",
              **{f"serial_{b}_walls_s": ",".join(f"{w:.4f}" for w in ws)
                 for b, ws in one_walls.items()},
              card=repr(run.card))
        if not identical:
            bad.append(f"{name}: rank 0's output differs from serial numpy")
        if wrote:
            bad.append(f"{name}: ranks other than 0 wrote {wrote}")
    phase("e2e_hosts", seconds=f"{time.perf_counter() - t0:.1f}")
    if bad:
        fail(f"--hosts {HOSTS}: " + "; ".join(bad))


def phase_search(run: Run) -> None:
    walls = search_standard(run)
    fs_walls = search_fs(run)
    search_all_device(run, walls, fs_walls)
    search_long_model(run)
    search_splice(run)
    search_cpu(run, walls, fs_walls)
    search_mesh(run, walls, fs_walls)
    search_hosts(run, walls)


# ---------------------------------------------------------------------
# multiquery: the 48-model drive against the serial host drive
# ---------------------------------------------------------------------
def rows(path) -> str:
    return "".join(ln for ln in Path(path).read_text().splitlines(True)
                   if not ln.startswith("#"))


def mq_drive(run: Run, mode, turns, fixture):
    """The multi-query drive: --backend torch (one pass over the genome,
    the four multi-model kernels) against the port's --backend numpy
    (the serial per-query host drive), in turns; the first torch run is
    the one whose launches are counted.  A turn whose name ends in
    ``_cpu`` runs the query-sharded pool (--cpu MQ_CPU_WORKERS) in this
    process, after every earlier phase, under hang_limit: its workers
    keep every stage on the host, and none of the four entries may
    launch, in this process or in a worker (each worker reports its own
    counts).  The ``torch_mesh`` turn runs over the mesh of
    ``mesh_options``: every packed stage's items on every share.  Every
    turn is compared with the first turn's output, query by query: -o
    with its CPU-time lines masked, --tblout and --fstblout without their
    '#' lines."""
    from bath_tpu_torch import fixtures
    from bath_tpu_torch.cli import bathsearch
    from bath_tpu_torch.ops import multimodel as mm
    walls: dict = {t: [] for t in turns}
    first: dict = {}
    stats: dict = {}
    host_stats: dict = {}
    cpu_stats: dict = {}
    mesh_stats: dict = {}
    launches = None
    cpu_launches: dict = {}
    fns = {"fwd_parser_multi": mm.fwd_pack_scores,
           "domdec_multi": mm.domdec_pack_batch,
           "fs3_parser_multi": mm.fs3_pack_scores,
           "fs3_domdec_multi": mm.fs3_domdec_pack_batch}
    for turn in turns:
        stem = BUILD / (f"mq{''.join(mode).replace('-', '_')}_{turn}"
                        f"{len(walls[turn])}")
        paths = [stem.with_suffix(x) for x in (".out", ".tbl", ".fst")]
        counted = turn == "torch" and launches is None
        pooled = turn.endswith("_cpu")
        meshed = turn == "torch_mesh"
        mesh_opts, mesh_devs, n_shares = mesh_options() if meshed \
            else ([], None, 1)
        st = stats if counted else host_stats if turn == "torch_host" \
            else cpu_stats.setdefault(turn, {}) if pooled \
            else mesh_stats if meshed else {}
        if counted or pooled:
            for f in fns.values():
                f.launches = 0
        if turn == "torch_host":
            os.environ.update(dict.fromkeys(MQ_MIN_CELLS, "inf"))
        argv = ["--backend", turn.split("_")[0], "--device", DEVICE, *mode,
                *(["--cpu", str(MQ_CPU_WORKERS)] if pooled else []),
                *mesh_opts, "-o", str(paths[0]), "--tblout", str(paths[1]),
                "--fstblout", str(paths[2]), fixture.hmm_path,
                fixture.fasta_path]
        if pooled:
            wall, rc = cpu_search(argv, st, stem.name)
        else:
            t = time.perf_counter()
            rc = bathsearch.run(argv, stats=st, devices=mesh_devs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        walls[turn].append(wall)
        if meshed:
            mesh_shares_ok(f"multi-query {mode} mesh", st, n_shares)
        for k in MQ_MIN_CELLS:
            os.environ.pop(k, None)
        if counted:
            launches = {k: f.launches for k, f in fns.items()}
        if pooled:
            cpu_launches[turn] = {k: f.launches for k, f in fns.items()}
        if rc != 0:
            fail(f"{turn} multi-query bathsearch {mode} exited {rc}")
        first.setdefault(turn, paths)
    ref = turns[0]
    n_out = masked(first[ref][0]).split("//\n")
    identical: dict = {}
    differ: dict = {}
    for turn, paths in first.items():
        if turn == ref:
            continue
        t_out = masked(paths[0]).split("//\n")
        differ[turn] = [q for q, (a, b) in enumerate(zip(t_out, n_out))
                        if a != b]
        identical[turn] = {
            "out": not differ[turn]
            and len(t_out) == len(n_out) == len(MQ_MS) + 1,
            "tblout": rows(paths[1]) == rows(first[ref][1]),
            "fstblout": rows(paths[2]) == rows(first[ref][2])}
    found = fixtures.multi_embeds_found(str(first["torch"][1]), fixture)
    tag = "e2e_multiquery" + "".join(mode).replace("--", "_")
    for stage, items, cells, secs in stats["mq_stages"]:
        phase(tag, flush_stage=stage, items=items, cells=cells,
              host_wall_s=f"{secs:.4f}")
    phase(tag, genome_nt=MQ_GENOME_NT, models=len(MQ_MS),
          M=f"{min(MQ_MS)}..{max(MQ_MS)}",
          embedded_models=len(MQ_EMBEDDED), copies=MQ_COPIES,
          found=f"{sum(found.values())}/{MQ_COPIES * len(MQ_EMBEDDED)}",
          compared_with=ref, byte_identical=identical,
          queries_differing=differ,
          **{f"walls_{t}_s": ",".join(f"{w:.3f}" for w in walls[t])
             for t in turns},
          host_cores=os.cpu_count(), cpu_workers=MQ_CPU_WORKERS,
          **{k: {t: round(st.get(k, 0.0), 4) for t, st in cpu_stats.items()}
             for k in ("pool_start_s", "pool_spawn_s", "pool_init_s")},
          pools={t: st.get("pools") for t, st in cpu_stats.items()},
          cpu_launches=cpu_launches,
          mesh_items=mesh_stats.get("mesh_items"),
          mesh_across_cards=torch.cuda.device_count() > 1,
          **{k: {t: st.get(k) for t, st in cpu_stats.items()}
             for k in ("worker_cuda", "worker_launches")},
          phase_s={k: round(v, 3) for k, v in stats["mq_phase_s"].items()},
          phase_host_stages_s={
              k: round(v, 3)
              for k, v in host_stats.get("mq_phase_s", {}).items()},
          **{k: (round(v, 4) if isinstance(v, float) else v)
             for k, v in stats.items()
             if k not in ("mq_stages", "mq_phase_s")},
          launches=launches, card=repr(run.card))
    if "torch_host" in turns and (not host_stats or any(
            host_stats.get(f"{k}_items")
            for k in ("fwd", "domdec", "fs3", "fs3domdec"))):
        fail(f"multi-query {mode}: a stage reached the card with its "
             f"threshold out of reach: {host_stats}")
    if not all(all(v.values()) for v in identical.values()):
        fail(f"multi-query {mode} output differs from {ref}: {identical}, "
             f"queries {differ}")
    if any(any(v.values()) for v in cpu_launches.values()) or any(
            st.get("pools", 0) < 2 or st.get("fwd_items")
            or st.get("worker_cuda") != 0 or st.get("worker_launches")
            for st in cpu_stats.values()):
        fail(f"multi-query {mode} --cpu: a stage of the pool's run reached "
             f"the card (in this process or in a worker), or no pool ran: "
             f"{cpu_launches}, {cpu_stats}")
    if sum(found.values()) < 0.75 * MQ_COPIES * len(MQ_EMBEDDED):
        fail(f"multi-query {mode}: only {found} embeds reported")
    return launches, stats, first


def query_parts(paths, names) -> dict:
    """Each query of <names>: its block of -o (from its "Query:" line,
    CPU-time lines masked) and its rows of --tblout and --fstblout."""
    blocks = {}
    for block in masked(paths[0]).split("//\n"):
        at = block.find("Query:")
        if at >= 0:
            blocks[block[at:].split()[1]] = block[at:]
    tables = [rows(p).splitlines(True) for p in paths[1:3]]
    return {q: (blocks.get(q), *("".join(ln for ln in t if q in ln.split())
                                 for t in tables))
            for q in names}


def mq_fs_serial(fixture, paths) -> None:
    """The queries MQ_FS_SERIAL of the --fs drive through the port's
    serial numpy loop, from a query file of their own, held per query
    to the torch turn's output (a reference that shares no code of the
    multi-query drive's stream and pools)."""
    from bath_tpu_torch.cli import bathsearch
    records = [r for r in Path(fixture.hmm_path).read_text().split("//\n")
               if r.strip()]
    pick = [records[i] + "//\n" for i in MQ_FS_SERIAL]
    names = [re.search(r"^NAME\s+(\S+)", r, re.M).group(1) for r in pick]
    query = BUILD / "mq_fs_serial.bhmm"
    query.write_text("".join(pick))
    out = [BUILD / f"mq_fs_serial.{x}" for x in ("out", "tbl", "fst")]
    t = time.perf_counter()
    rc = bathsearch.run(["--backend", "numpy", "--cpu", "0", "--fs", "-o",
                         str(out[0]), "--tblout", str(out[1]), "--fstblout",
                         str(out[2]), str(query), fixture.fasta_path])
    wall = time.perf_counter() - t
    if rc != 0:
        fail(f"serial numpy --fs on {names} exited {rc}")
    want, got = query_parts(out, names), query_parts(paths, names)
    same = {q: [a == b for a, b in zip(want[q], got[q])] for q in names}
    phase("e2e_multiquery_fs", serial_numpy_queries=names,
          serial_numpy_s=f"{wall:.4f}", byte_identical_to_torch=same,
          tbl_rows={q: want[q][1].count("\n") for q in names},
          fst_rows={q: want[q][2].count("\n") for q in names})
    if not all(want[q][0] for q in names) \
            or not all(all(v) for v in same.values()):
        fail(f"multi-query --fs: the torch drive differs from the serial "
             f"numpy loop on {same}")


def phase_multiquery(run: Run) -> None:
    from bath_tpu_torch import fixtures
    mq_launches, mq_stats, _ = mq_drive(run, [], MQ_TURNS, run.mq_fx(False))
    mq_fs_fx = run.mq_fx(True)
    mq_fs_launches, mq_fs_stats, mq_fs_paths = mq_drive(
        run, ["--fs"], MQ_FS_TURNS, mq_fs_fx)
    mq_fs_serial(mq_fs_fx, mq_fs_paths["torch"])
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
    counts = {"fwd_parser_multi": mq_launches["fwd_parser_multi"],
              "domdec_multi": mq_launches["domdec_multi"],
              "fs3_parser_multi": mq_fs_launches["fs3_parser_multi"],
              "fs3_domdec_multi": mq_fs_launches["fs3_domdec_multi"]}
    if min(counts.values()) <= 0:
        fail(f"a multi-model kernel never launched in the multi-query "
             f"drives: {counts} (standard {mq_launches}, --fs "
             f"{mq_fs_launches})")
    for st, key in ((mq_stats, "domdec"), (mq_fs_stats, "fs3domdec")):
        share = st[f"{key}_ok"] / max(1, st[f"{key}_items"])
        if share < MIN_OK_SHARE:
            fail(f"multi-query {key} ok share {share} < {MIN_OK_SHARE}")
    run.launches.update(counts)


# ---------------------------------------------------------------------
# build: bathbuild and bathconvert, torch against numpy
# ---------------------------------------------------------------------
def built_paths() -> dict:
    return {b: BUILD / f"built_{b}.bhmm" for b in ("numpy", "torch")}


def start_host_build(run: Run) -> None:
    """bathbuild --backend numpy, the serial host calibration, of the
    BUILD_MQ-alignment fixture, in a child process beside the parity phase
    (it needs no card, the host has cores to spare, and nothing timed
    runs before it has ended)."""
    sto, _ = run.msa()
    run.host_build = host_tool("bathbuild", [built_paths()["numpy"], sto])
    phase("bathbuild", backend="numpy", started="in a child process",
          alignments=len(BUILD_MQ), nseq=MSA_NSEQ)


def tool(main, argv, **kw):
    """(stdout, wall) of one CLI call; the calibration entries' launch
    counts start at 0."""
    from bath_tpu_torch.ops import multimodel as mm
    for f in (mm.msv_ssv_multi, mm.vit_ints_multi, mm.fwd_pack_scores,
              mm.fs3_pack_scores):
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
               for ln in Path(x).read_text().splitlines()] for x in (a, b))
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


def stats_lines(path, key) -> int:
    return sum(ln.startswith(f"STATS LOCAL {key}")
               for ln in Path(path).read_text().splitlines())


def hit_set(tbl) -> set:
    hits = set()
    for ln in Path(tbl).read_text().splitlines():
        if ln and not ln.startswith("#"):
            cols = ln.split()
            hits.add((cols[3], cols[9], cols[10]))
    return hits


def phase_build(run: Run) -> None:
    """--backend torch (host builds, then all BUILD_MQ models calibrated in
    one device-batched pass), in this process, against --backend numpy
    (the serial host calibration): bathbuild's ran in the child process
    started before the parity phase, bathconvert's runs here, just
    before the torch one.  The files may differ in their DATE line and
    in the taus of the f32 gates' STATS lines (within TAU_TOL), nowhere
    else: the MSV and VITERBI lines come from the bit-exact integer
    entries, the FS5 line from the same host parser."""
    from bath_tpu_torch import fixtures
    from bath_tpu_torch.cli import (bathbuild, bathconvert, bathfetch,
                                    bathsearch, bathstat)
    from bath_tpu_torch.ops import multimodel as mm
    sto, msa_names = run.msa()
    built = built_paths()
    run.join_host_build()
    build_table_numpy, build_wall_numpy = run.built_numpy
    cal_fns = {"msv_filter_multi": mm.msv_ssv_multi,
               "vit_filter_multi": mm.vit_ints_multi,
               "fwd_parser_multi": mm.fwd_pack_scores,
               "fs3_parser_multi": mm.fs3_pack_scores}
    build_stats: dict = {}
    build_table, build_wall = tool(
        bathbuild.main, ["--backend", "torch", "--device", DEVICE,
                         built["torch"], sto], stats=build_stats)
    build_launches = {k: f.launches for k, f in cal_fns.items()}
    build_err, build_ndiff = model_diff(built["torch"], built["numpy"],
                                        F32_GATE_LINES, "bathbuild")
    built_ms = [MQ_MS[i] for i in BUILD_MQ]
    fetched_name = msa_names[BUILD_MQ.index(FETCHED)]
    phase("bathbuild", alignments=len(BUILD_MQ), nseq=MSA_NSEQ,
          M=f"{min(built_ms)}..{max(built_ms)}", fs=True,
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
          launches=build_launches, card=repr(run.card))
    if build_table != build_table_numpy:
        fail("bathbuild's tables differ between the backends")
    if stats_lines(built["torch"], "FS5") != len(BUILD_MQ) \
            or build_stats.get("cal_fs_serial"):
        fail(f"bathbuild: {stats_lines(built['torch'], 'FS5')} models with "
             f"frameshift taus, {build_stats.get('cal_fs_serial')} through "
             "the serial fallback")
    if min(build_launches.values()) <= 0:
        fail(f"a kernel of the calibration never launched in bathbuild: "
             f"{build_launches}")
    run.launches["msv_filter_multi"] = build_launches["msv_filter_multi"]
    run.launches["vit_filter_multi"] = build_launches["vit_filter_multi"]

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
    phase("bathconvert", models=len(BUILD_MQ),
          wall_numpy_s=f"{conv_wall_numpy:.3f}",
          wall_numpy_concurrent=False, wall_torch_s=f"{conv_wall:.3f}",
          **{k: (round(v, 4) if isinstance(v, float) else v)
             for k, v in conv_stats.items()},
          fs3_lines_differing=conv_ndiff, max_tau_diff=f"{conv_err:.4f}",
          tau_tol=TAU_TOL, tables_identical=conv_table == conv_table_numpy,
          launches=conv_launches, card=repr(run.card))
    if conv_table != conv_table_numpy:
        fail("bathconvert's tables differ between the backends")
    if stats_lines(conv["torch"], "FS3") != len(BUILD_MQ):
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
        tool(bathfetch.main, ["-o", fetched[b], built[b], fetched_name])
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
          fetched=fetched_name, fetched_tau_diff=f"{fetch_err:.4f}",
          fetched_as_hmmer3_converted_tau_diff=f"{h3_err:.4f}")
    if stat["torch"] != stat["numpy"] \
            or len(stat["torch"].splitlines()) < len(BUILD_MQ):
        fail("bathstat differs between the torch- and the numpy-built file")

    # one bathsearch --fs of the multi-query genome (copies of 12 of the
    # proteins the alignments were emitted from) with either file: the
    # same hits
    hits, search_walls = {}, {}
    for b in built:
        tbl = BUILD / f"built_{b}_search.tbl"
        t = time.perf_counter()
        rc = bathsearch.run(["--backend", "torch", "--device", DEVICE,
                             "--fs", "-o", str(tbl.with_suffix(".out")),
                             "--tblout", str(tbl), str(built[b]),
                             run.mq_fx(True).fasta_path])
        torch.cuda.synchronize()
        search_walls[b] = time.perf_counter() - t
        if rc != 0:
            fail(f"bathsearch --fs with the {b}-built file exited {rc}")
        hits[b] = hit_set(tbl)
    phase("bathsearch_with_built_models", genome_nt=MQ_GENOME_NT,
          models=len(BUILD_MQ), hits_torch_built=len(hits["torch"]),
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


# ---------------------------------------------------------------------
# ubench: the card's microbenchmarks (scripts/ubench_vpu.py's four)
# ---------------------------------------------------------------------
# Tolerances against the plain versions: bands.UB_TOL, and for the
# tensor-core entry ubench.onehot_mma_tol.
# After 512 steps every element of the chain sits at its map's fixed
# point whatever x is, and yacc's columns stay equal from the script's
# start: the entries are also held after 1-3 steps, where the chain
# still follows x element by element, from a yacc start whose columns
# differ (ubench.overlap_start).
UB_SHORT_REPS = (1, 2, 3)
# the drive's widths; the tensor-core entries' last tiles of 64 columns
# hold 16 (onehot) and 32 (overlap) columns at the partial widths
UB_WIDTHS = (1024, 4096)
UB_PARTIAL = {"onehot": 1040, "overlap": 1056}
# the gather at every n also at these Mt (the 17th group's rows below 8,
# a table of 8 rows: a column a lane) on the partial width, each with
# indices -1 and n in the stream (ubench.out_of_range); #10 also at the
# full width and a ragged one
UB_GATHER_MT = (136, 135, 8)
UB_SCALARS_BT = (1024, 4096, 1000)


def phase_ubench(run: Run) -> None:
    """Each of the five entries against its plain version at the
    script's shapes ([136, 1024], 512 steps), the one-hot and overlap
    entries also at [136, 4096] and a partial last tile, the one-hot
    ones twice (equal bits), the gather also at UB_GATHER_MT with
    indices out of range, #10 at UB_SCALARS_BT, then the drive
    (launches counted from 0) at [136, 1024] and [136, 4096], each
    record with its design's floor_ms (the gather's at the card's
    clocks.max.sm, which it carries).  Beside the one-hot entries
    F.embedding_bag, the one PyTorch call that computes their sum (#8's
    library_ms); beside the overlap entry one torch.matmul of one step's
    product, a yardstick.  The port calls neither."""
    import torch.nn.functional as F
    from bath_tpu_torch import ubench as ub
    from bath_tpu_torch.ops.kernels import loader
    entries = {"ub_chain": ub.chain, "ub_onehot_gather": ub.onehot_gather,
               "ub_onehot_mma": ub.onehot_mma, "ub_overlap": ub.overlap,
               "ub_scalars": ub.scalars}
    plain_ms = {}

    def hold(entry, got, ref, case):
        want = []
        ms = once_ms(lambda: want.append(ref()))
        err = max_err(got, want[0])
        tol = ub.onehot_mma_tol(want[0]) if entry == "ub_onehot_mma" \
            else UB_TOL[entry]
        if not (torch.isfinite(got).all() and err <= tol):
            fail(f"{entry} ({case}) vs plain: max |d| {err} > {tol}")
        run.note_err(entry, err)
        phase("parity", kernel=entry, case=case, max_abs_err=err, tol=tol,
              plain_ms=f"{ms:.2f}")
        return ms

    def twice(entry, fn, case):
        """The entry called twice: equal bits (fixed orders of sums)."""
        a, b = fn(), fn()
        if not torch.equal(a, b):
            fail(f"{entry} ({case}) differs between two calls: max |d| "
                 f"{max_err(a, b)}")
        return a

    x, = (a.to(DEV) for a in ub.inputs("chain"))
    for nops in ub.CHAIN_NOPS:
        plain_ms["ub_chain"] = hold("ub_chain", ub.chain(x, nops),
                                    lambda: ub.chain_ref(x, nops),
                                    f"nops={nops}")
        for reps in UB_SHORT_REPS:
            hold("ub_chain", ub.chain(x, nops, reps),
                 lambda: ub.chain_ref(x, nops, reps),
                 f"nops={nops} reps={reps}")
    library = {}
    for Bt in UB_WIDTHS + (UB_PARTIAL["onehot"],):
        for n in ub.ONEHOT_N:
            t, idx = (a.to(DEV) for a in ub.inputs("onehot", ub.MT, Bt,
                                                   n=n))
            gat = twice("ub_onehot_gather", lambda: ub.onehot_gather(t, idx),
                        f"n={n} Bt={Bt}")
            mma = twice("ub_onehot_mma", lambda: ub.onehot_mma(t, idx),
                        f"n={n} Bt={Bt}")
            for name, got in (("ub_onehot_gather", gat),
                              ("ub_onehot_mma", mma)):
                ms = hold(name, got, lambda: ub.onehot_ref(t, idx),
                          f"n={n} Bt={Bt}")
                if Bt == ub.BT:
                    plain_ms[name] = ms
            err = max_err(mma, gat)
            if err > ub.onehot_mma_tol(gat):
                fail(f"onehot mma vs gather at n={n} Bt={Bt}: max |d| {err}")
            if Bt not in UB_WIDTHS:
                continue
            # the library call: its inputs laid out before the timed calls
            bag, w = idx.T.contiguous(), t.float().T.contiguous()
            lib_out = F.embedding_bag(bag, w, mode="sum")
            err = max_err(lib_out.T, gat)
            if err > ub.onehot_mma_tol(gat):
                fail(f"embedding_bag vs the gather at n={n} Bt={Bt}: max "
                     f"|d| {err}")
            library[(Bt, n)] = cuda_ms(
                lambda: F.embedding_bag(bag, w, mode="sum"), 20)
    # the gather's other instances, indices -1 and n adding nothing (the
    # plain version sums the same through ub.onehot_in_range)
    Bt = UB_PARTIAL["onehot"]
    for Mt in UB_GATHER_MT:
        for n in ub.ONEHOT_N:
            t, idx = ub.inputs("onehot", Mt, Bt, n=n, seed=Mt + n)
            idx = ub.out_of_range(idx, n)
            t0, idx0 = (a.to(DEV) for a in ub.onehot_in_range(t, idx))
            t, idx = t.to(DEV), idx.to(DEV)
            case = f"Mt={Mt} n={n} Bt={Bt} out of range"
            gat = twice("ub_onehot_gather", lambda: ub.onehot_gather(t, idx),
                        case)
            hold("ub_onehot_gather", gat, lambda: ub.onehot_ref(t0, idx0),
                 case)
    yard = {}
    for Bt in UB_WIDTHS + (UB_PARTIAL["overlap"],):
        g, x = (a.to(DEV) for a in ub.inputs("overlap", ub.MT, Bt))
        for mode in ub.OVERLAP_MODES:
            got = twice("ub_overlap", lambda: ub.overlap(g, x, mode),
                        f"mode={mode} Bt={Bt}")
            ms = hold("ub_overlap", got, lambda: ub.overlap_ref(g, x, mode),
                      f"mode={mode} Bt={Bt}")
            if Bt == ub.BT:
                plain_ms["ub_overlap"] = ms
    g, x = (a.to(DEV) for a in ub.inputs("overlap"))
    y0 = ub.overlap_start().to(DEV)
    for reps in UB_SHORT_REPS:
        got = {m: ub.overlap(g, x, m, reps, y0) for m in ub.OVERLAP_MODES}
        want = {m: ub.overlap_ref(g, x, m, reps, y0)
                for m in ub.OVERLAP_MODES}
        # mode chain leaves yacc at its bf16 start: the chain's tolerance
        for m in ub.OVERLAP_MODES:
            tol = UB_TOL["ub_chain" if m == "chain" else "ub_overlap"]
            err = max_err(got[m], want[m])
            if not (torch.isfinite(got[m]).all() and err <= tol):
                fail(f"ub_overlap (mode={m}, reps={reps}, yacc from "
                     f"overlap_start) vs plain: max |d| {err} > {tol}")
            run.note_err("ub_overlap", err)
        # the chain half of mode both: both - dot is acc - x, whatever
        # the bf16 ulp in which yacc may differ
        err = max_err(got["both"] - got["dot"], want["both"] - want["dot"])
        if err > UB_TOL["ub_chain"]:
            fail(f"ub_overlap's chain beside the product (reps={reps}): "
                 f"max |d| {err} > {UB_TOL['ub_chain']}")
        phase("parity", kernel="ub_overlap", case=f"reps={reps} y0",
              max_abs_err=max(max_err(got[m], want[m])
                              for m in ub.OVERLAP_MODES),
              chain_half_err=err)
    y = torch.full((2 * ub.MT, ub.BT), 0.3, dtype=torch.bfloat16,
                   device=DEV)
    yard["ub_overlap"] = cuda_ms(lambda: torch.matmul(g, y), 20)
    for Bt in UB_SCALARS_BT:
        x, = (a.to(DEV) for a in ub.inputs("scalars", 1, Bt))
        ms = hold("ub_scalars", ub.scalars(x), lambda: ub.scalars_ref(x),
                  f"row 0 Bt={Bt}")
        if Bt == ub.BT:
            plain_ms["ub_scalars"] = ms
        # the scratch the kernel wrote: all 16 stepped rows, the rest at
        # the start
        sp, _ = loader.launch_ub_scalars(Bt, ub.REPS, DEV)
        err = max_err(sp[:16], ub.scalars_ref(x).expand(16, Bt))
        start = torch.full((16, Bt), 0.3, device=DEV)
        if err > UB_TOL["ub_scalars"] or not torch.equal(sp[16:], start):
            fail(f"ub_scalars' scratch at Bt={Bt}: stepped rows max |d| "
                 f"{err}, rows 16-31 at the start: "
                 f"{torch.equal(sp[16:], start)}")

    for f in entries.values():
        f.launches = 0
    recs = ub.drive()
    launches = {k: f.launches for k, f in entries.items()}
    for r in recs:
        if r["case"] == "onehot":
            r["library_ms"] = library[(r["Bt"], r["n"])]
        phase("ubench", **{k: (f"{v:.5g}" if isinstance(v, float) else v)
                           for k, v in r.items()}, card=repr(run.card))
    if min(launches.values()) <= 0:
        fail(f"a microbenchmark kernel never launched in the drive: "
             f"{launches}")
    run.launches.update(launches)

    # the record: the script's shape, the widest table, both modes' sum
    def pick(entry, r):
        return (r["Bt"] == ub.BT and r["Mt"] == ub.MT and {
            "ub_chain": r.get("nops") == ub.CHAIN_NOPS[-1],
            "ub_onehot_gather": r.get("n") == ub.ONEHOT_N[-1]
            and not r["mma"],
            "ub_onehot_mma": r.get("n") == ub.ONEHOT_N[-1] and r["mma"],
            "ub_overlap": r.get("mode") == "both",
            "ub_scalars": True}[entry])

    for entry in entries:
        mine = [r for r in recs if "bt_" + entry == r["entry"]]
        r, = [r for r in mine if pick(entry, r)]
        run.times[entry] = (r["ms"], plain_ms[entry], r["bound_ms"],
                            r["bound_by"])
        run.extra[entry] = {"timed": {k: v for k, v in r.items()
                                      if k not in ("entry", "bound_by")},
                            "drive": [{k: v for k, v in q.items()
                                       if k not in ("entry", "case")}
                                      for q in mine]}
        if "floor_ms" in r:
            run.extra[entry]["floor_ms"] = r["floor_ms"]
        if "sm_clock_mhz" in r:         # the clock the gather's floor is at
            run.extra[entry]["floor_sm_clock_mhz"] = r["sm_clock_mhz"]
        if "library_ms" in r:
            run.library[entry] = r["library_ms"]
        if entry in yard:
            run.extra[entry]["torch_matmul_one_step_ms_yardstick"] = \
                yard[entry]
    hidden = {r["Bt"]: r["hidden_share"] for r in recs if "hidden_share" in r}
    phase("ubench_summary", note="library_ms: F.embedding_bag, not called "
          "by the port",
          **{f"library_ms_n{n}_bt{Bt}": f"{ms:.5f}"
             for (Bt, n), ms in sorted(library.items())},
          **{f"hidden_share_bt{Bt}": f"{h:.4f}" for Bt, h in hidden.items()},
          overlap_matmul_one_step_ms=f"{yard['ub_overlap']:.5f}")


# ---------------------------------------------------------------------
# mesh: the data-parallel gate step (J5)
# ---------------------------------------------------------------------
def phase_mesh(run: Run) -> None:
    """The step on one flush's shape: MESH_B windows of MESH_LN nt of
    the frameshift fixture's genome and the longest ORF of each window's
    six frames (La the longest of those), under the fixture's own
    M_SEARCH model, through the self-check's dry run
    (``selfcheck.dryrun_multichip`` over every card, or two shares of
    one card): bit for bit the step on one card and the three entries
    launched directly on the whole batch, within tolerance of the plain
    versions (MSV exactly), its counters exact.  The dry run then holds
    the production cascade over the same devices (standard, --fs,
    --splice, a multi-HMM file) to one device and to numpy.  The step
    over every card is timed as a whole (host copies and the counters'
    sync included), and on two or more cards beside the whole batch and
    one card's share on one card."""
    from bath_tpu_torch import fixtures, selfcheck
    from bath_tpu_torch.alphabet import dna
    from bath_tpu_torch.hmmfile import read_hmm
    from bath_tpu_torch.ops import fs3, fwd, ssv
    from bath_tpu_torch.ops.kernels import loader
    from bath_tpu_torch.parallel import mesh
    from bath_tpu_torch.sequence import read_fasta
    fx = run.fs_fx()
    hm = read_hmm(fx.hmm_path)
    om = fixtures.search_profile(hm)
    fp, mp = fwd.fwd_params(om, DEV), ssv.msv_params(om, DEV)
    p3 = fs3.fs3_params(fixtures.fs_search_profile(hm), DEV)
    # windows at random, then MESH_HOMOLOGS over embedded copies (those
    # on the plus strand score on these windows), so scores pass
    genome = read_fasta(fx.fasta_path, dna())[0].dsq
    over = [max(0, min(s - 200, len(genome) - MESH_LN))
            for s, _ in fx.embeds[:MESH_HOMOLOGS]]
    windows = fixtures.sample_windows(
        fx.fasta_path, MESH_B - len(over), MESH_LN, SEED + 3) + [
        np.asarray(genome[o:o + MESH_LN], np.int8) for o in over]
    orfs = fixtures.longest_orfs(windows)
    alens = np.array([len(o) for o in orfs], np.int32)
    La = int(alens.max())
    adsq = np.full((MESH_B, La), 28, np.int8)
    for b, o in enumerate(orfs):
        adsq[b, :len(o)] = o
    batch = (adsq, alens, np.stack(windows).astype(np.int8),
             np.full(MESH_B, MESH_LN, np.int32), mp.tjb_for(alens))
    a, al, nd, nl, tj = (torch.from_numpy(np.ascontiguousarray(v)).to(DEV)
                         for v in batch)
    offs = torch.arange(MESH_B, dtype=torch.int64, device=DEV) * La

    def direct(fwd_fn, msv_fn, fs3_fn):
        raw = msv_fn(a.reshape(-1), offs, al, tj, mp)
        return (fwd_fn(a, al, fp),
                mesh.msv_nats(*ssv.msv_post(*raw, tj, mp), mp),
                fs3_fn(nd, nl, p3))

    want = direct(fwd.fwd_score, ssv.msv_ssv, fs3.fs3_score)
    plain = []
    p_ms = once_ms(lambda: plain.append(direct(
        fwd.fwd_score_ref, ssv.msv_ssv_ref, fs3.fs3_score_ref)))
    plain = plain[0]
    errs = []
    for k, tol in zip(("fwd", "msv", "fs3"), (FWD_TOL, 0.0, FWD_TOL)):
        got, ref = want[len(errs)], plain[len(errs)]
        fin = torch.isfinite(ref)
        err = max_err(got[fin], ref[fin])
        if not (torch.equal(fin, torch.isfinite(got)) and err <= tol):
            fail(f"mesh step's {k} entry vs plain: max |d| {err} > {tol}")
        errs.append(err)
    n = torch.cuda.device_count()
    # the self-check's dry run (bath_tpu_torch/selfcheck.py): the step
    # over every card (two shares of one card on a machine of one)
    # against one card, bit for bit, its counters exact, then the
    # production cascade over the same devices in four modes
    t = time.perf_counter()
    try:
        rep = selfcheck.dryrun_multichip(max(n, 2), DEVICE,
                                         step=((fp, mp, p3), batch))
    except AssertionError as e:
        fail(f"the self-check's dry run: {e}")
    dry_s = time.perf_counter() - t
    npass = int((want[0] > 0).sum() + (want[2] > 0).sum())
    nres = int(alens.sum()) + MESH_B * MESH_LN
    if npass == 0:
        fail("no score of the mesh batch passes: the counters' check is "
             "vacuous")
    if min(rep["step_launches"].values()) < len(rep["devices"]):
        fail(f"the dry run's step did not launch every kernel on every "
             f"share: {rep['step_launches']} over {rep['devices']}")
    # the step over every card, the one timed below: its own launches
    # (each wrapper's count set to 0 just before its first call and
    # read just after), its outputs bit for bit the entries on the whole
    # batch, its counters exact
    wrappers = {"fwd_parser": fwd.fwd_score, "msv_filter": ssv.msv_ssv,
                "fs3_parser": fs3.fs3_score}
    step = mesh.make_pipeline_step(mesh.make_mesh(n), fp, mp, p3)
    for f in wrappers.values():
        f.launches = 0
    out = step(*batch)
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in wrappers.items()}
    for tag, o in (("the dry run's shares", rep["step"]),
                   (f"{n} card(s)", out)):
        if not all(torch.equal(x, y) for x, y in zip(o[:3], want)):
            fail(f"the step over {tag} differs from the entries launched "
                 "on the whole batch")
        if o[3].tolist() != [nres, npass]:
            fail(f"the step over {tag} counts {o[3].tolist()}, not "
                 f"{[nres, npass]}")
    if min(launches.values()) < n:
        fail(f"the step did not launch every kernel on every card: "
             f"{launches} over {n}")
    # the self-check's entry: the fs3 gate of its flagship model on its
    # windows, launched on the card, against the plain version
    fn, fargs = selfcheck.entry(DEVICE)
    before = fs3.fs3_score.launches
    got = fn(*fargs)
    entry_launches = fs3.fs3_score.launches - before
    e = vs_plain("fs3_parser", got, fs3.fs3_score_ref(
        *fargs, fs3.fs3_params(selfcheck.flagship()[1], DEV), 1.0))
    if entry_launches != 1:
        fail(f"selfcheck.entry launched bt_fs3_parser {entry_launches} "
             "times")
    phase("mesh", selfcheck_entry="bt_fs3_parser", M=selfcheck.ENTRY_M,
          B=selfcheck.ENTRY_B, L=selfcheck.ENTRY_L, launches=entry_launches,
          vs_plain=e)
    phase("mesh", dryrun_multichip=max(n, 2), devices=rep["devices"],
          step="bit for bit one device and the entries on the whole batch",
          cascade=",".join(rep["mesh_items"]),
          cascade_vs="one device and numpy, byte-identical",
          mesh_items=rep["mesh_items"], seconds=f"{dry_s:.1f}")
    k_ms = cuda_ms(lambda: step(*batch), 10)
    if n > 1:
        # the same batch on one card, and one card's share of it alone:
        # the step over n cards takes about the share's time if the
        # cards work at once, and about n times it if they take turns
        one = mesh.make_pipeline_step(mesh.make_mesh(1), fp, mp, p3)
        share = tuple(v[:MESH_B // n] for v in batch)
        one_ms = cuda_ms(lambda: one(*batch), 10)
        share_ms = cuda_ms(lambda: one(*share), 10)
        run.extra["mesh_step"] = {"one_card_ms": one_ms,
                                  "one_share_alone_ms": share_ms}
        phase("mesh", shard_invariance_across_cards=f"bit for bit over {n}",
              step_ms=f"{k_ms:.4f}", one_card_ms=f"{one_ms:.4f}",
              one_share_alone_ms=f"{share_ms:.4f}",
              # 1 when the step takes one share's time, 0 when n times
              cards_at_once=f"{(n - k_ms / share_ms) / (n - 1):.3f}")
    M = M_SEARCH
    parts = [
        bound("fwd_parser", float(alens.sum()) * M,
              nbytes(a, al, *fp.padded(loader.layout(M)[2])) + 4 * MESH_B),
        bound("msv_filter", float(alens.sum()) * M,
              nbytes(a, offs, al, tj, mp.table(loader.layout(M)[2]))
              + 4 * 3 * MESH_B),
        bound("fs3_parser", float(MESH_B * MESH_LN) * M,
              nbytes(nd, nl, *p3.padded(loader.fs3_layout(M)[2]))
              + 4 * MESH_B)]
    run.times["mesh_step"] = (k_ms, p_ms, sum(p[0] for p in parts),
                              max(parts)[1])
    run.err["mesh_step"] = max(errs)
    run.launches["mesh_step"] = sum(launches.values())
    run.extra.setdefault("mesh_step", {}).update(
        launches_by_kernel=launches, devices=n, B=MESH_B, La=La, Ln=MESH_LN,
        M=M, nres=nres, npass=npass)
    phase("mesh", devices=n, B=MESH_B, La=La, Ln=MESH_LN, M=M,
          windows_over_copies=len(over),
          bit_for_bit_vs_entries=True,
          counters=[nres, npass], vs_plain=[f"{e:.3g}" for e in errs],
          launches=launches, ms=f"{k_ms:.4f}", plain_ms=f"{p_ms:.2f}",
          bound_ms=f"{run.times['mesh_step'][2]:.5f}", card=repr(run.card))
    if n < 2:
        phase("mesh", shard_invariance_across_cards="not run: this machine "
              "has 1 card")


# ---------------------------------------------------------------------
# sanitize: the kernels under compute-sanitizer
# ---------------------------------------------------------------------
def sanitize_line(r: dict) -> dict:
    """What a phase line says of one tool's run (``sanitize.run_tool``):
    whether the tool could check here, its own error where it could
    not, whether it reported its canary, and over the cases its count
    of errors, its summary, the cases and entries checked."""
    keys = ("tool", "available", "error", "canary_caught", "canary_summary",
            "errors", "summary", "rc", "held")
    out = {k: r[k] for k in keys if k in r}
    if r.get("checked"):
        out.update(cases=len(r.get("cases") or ()),
                   entries=len(r.get("entries") or ()),
                   entry_names=",".join(r.get("entries") or ()),
                   seconds=f"{r['seconds']:.1f}")
    else:
        out["checked"] = "nothing"
    return out


def sanitized(r: dict) -> None:
    """Fails a tool's run that could check and did not come out clean:
    its canary missed, a report over the cases, or a case off its plain
    version.  A tool that could not check here (``available`` false)
    checked nothing and fails nothing."""
    if r.get("available") and not (r.get("canary_caught")
                                   and r.get("clean")):
        fail(f"{r['tool']}: {r.get('error') or r.get('report', '')[-3000:]}")


# each child of the default memcheck step (its canary, then the cases)
# is killed past this, a failed phase: the step is budgeted at 90 s, and
# a tool that attaches but runs far past that must not carry the run
# past its time limit
SANITIZE_LIMIT_S = 150


def phase_sanitize(run: Run) -> None:
    """memcheck over every case of ``bath_tpu_torch.sanitize`` (every
    kernel entry of the record, each plan family, a segmented class of
    each segmented entry, the step over two shares) in a child process
    under compute-sanitizer, once the tool has reported its canary (a
    write past a buffer)."""
    from bath_tpu_torch import sanitize
    t = time.perf_counter()
    r = sanitize.run_tool("memcheck", limit_s=SANITIZE_LIMIT_S)
    phase("sanitize", **sanitize_line(r), card=repr(run.card),
          step_seconds=f"{time.perf_counter() - t:.1f}")
    sanitized(r)


def phase_sanitize_full(run: Run) -> None:
    """racecheck, synccheck and initcheck over the same cases, each
    after its canary (a shared race, a barrier half a warp reaches, a
    read of memory nothing wrote); then the cases with no tool, their
    outputs against the plain versions alone (nothing sanitized)."""
    from bath_tpu_torch import sanitize
    for tool in ("racecheck", "synccheck", "initcheck"):
        t = time.perf_counter()
        r = sanitize.run_tool(tool)
        phase("sanitize_full", **sanitize_line(r),
              step_seconds=f"{time.perf_counter() - t:.1f}")
        if r.get("report"):
            print(r["report"], flush=True)
        sanitized(r)
    r = sanitize.run_untooled()
    phase("sanitize_full", tool="none", sanitized="nothing (parity only)",
          cases=len(r.get("cases") or ()),
          entries=len(r.get("entries") or ()), held=r["held"],
          seconds=f"{r['seconds']:.1f}")
    if not r["clean"]:
        fail(f"the sanitizer cases off their plain versions: "
             f"{r.get('report', '')}")


# ---------------------------------------------------------------------
# deep: the shapes the default run cuts for its time
# ---------------------------------------------------------------------
def phase_deep(run: Run) -> None:
    parity_int(run, DEEP_LONG_ORF)
    parity_segmented(run, [(f, SEG_M) for f in DEEP_SEG_M_FAMILIES],
                     mixed=False)
    parity_fs3(run, np.random.default_rng(SEED + 11), DEEP_PARITY_FS3,
               DEEP_PARITY_FS3DD)
    time_fs3(run, DEEP_TIME_FS3_M, decoding=False)
    time_multi_fs3(run, DEEP_TIME_MQ_PLAIN_FS3, DEEP_TIME_MQ_PLAIN_FS3DD,
                   record=False)


# ---------------------------------------------------------------------
# the record, the phases, main
# ---------------------------------------------------------------------
CSRC = "bath_tpu_torch/ops/kernels/csrc/"
ENTRIES = (  # (name, source, the TPU kernel it replaces)
    ("fwd_parser", CSRC + "fwd_parser.cu", "bath_tpu/ops/pallas/fwd.py:32"),
    ("domdec", CSRC + "domdec.cu", "bath_tpu/ops/jaxk/kernels.py:988"),
    ("fs3_parser", CSRC + "fs3_parser.cu", "bath_tpu/ops/pallas/fs3.py:69"),
    ("fs3_domdec", CSRC + "fs3_domdec.cu",
     "bath_tpu/ops/jaxk/kernels.py:1235"),
    ("msv_filter", CSRC + "msv_filter.cu", "bath_tpu/ops/pallas/ssv.py:30"),
    ("ssv_capture", CSRC + "ssv_capture.cu",
     "bath_tpu/ops/jaxk/filters_mb.py:623"),
    ("vit_filter", CSRC + "vit_filter.cu", "bath_tpu/ops/pallas/vit.py:64"),
    ("vit_capture", CSRC + "vit_filter.cu",
     "bath_tpu/ops/jaxk/filters_mb.py:304"),
    ("fwd_parser_multi", CSRC + "fwd_parser.cu",
     "bath_tpu/ops/jaxk/multimodel.py:171"),
    ("domdec_multi", CSRC + "domdec.cu",
     "bath_tpu/ops/jaxk/multimodel.py:220"),
    ("fs3_parser_multi", CSRC + "fs3_parser.cu",
     "bath_tpu/ops/jaxk/multimodel.py:263"),
    ("fs3_domdec_multi", CSRC + "fs3_domdec.cu",
     "bath_tpu/ops/jaxk/multimodel.py:312"),
    ("msv_filter_multi", CSRC + "msv_filter.cu",
     "bath_tpu/evalues_device.py:160"),
    ("vit_filter_multi", CSRC + "vit_filter.cu",
     "bath_tpu/evalues_device.py:175"),
    ("ub_chain", CSRC + "ubench.cu", "scripts/ubench_vpu.py:68"),
    ("ub_onehot_gather", CSRC + "ubench.cu", "scripts/ubench_vpu.py:101"),
    ("ub_onehot_mma", CSRC + "ubench.cu", "scripts/ubench_vpu.py:101"),
    ("ub_overlap", CSRC + "ubench.cu", "scripts/ubench_vpu.py:145"),
    ("ub_scalars", CSRC + "ubench.cu", "scripts/ubench_vpu.py:183"),
    ("mesh_step", "bath_tpu_torch/parallel/mesh.py",
     "bath_tpu/parallel/mesh.py:53"),
    ("rescore", CSRC + "rescore.cu", "bath_tpu/domaindef.py:267"),
)

PHASES = {"parity": phase_parity, "sanitize": phase_sanitize,
          "timing": phase_timing, "ubench": phase_ubench,
          "mesh": phase_mesh, "search": phase_search,
          "multiquery": phase_multiquery, "build": phase_build,
          "deep": phase_deep, "sanitize_full": phase_sanitize_full}
DEFAULT_PHASES = tuple(p for p in PHASES
                       if p not in ("deep", "sanitize_full"))


def record(run: Run) -> list:
    """The kernels' record: every entry whose phases ran (all of them in
    the default run, or it fails).  library_ms is null but for the two
    one-hot entries (#8): F.embedding_bag(idx.T, t.float().T,
    mode="sum") computes their sum in one call (timed in the ubench
    phase); no single PyTorch call computes any other row's function."""
    kernels = []
    for name, src, replaces in ENTRIES:
        if not (name in run.times and name in run.err
                and name in run.launches):
            continue
        t = run.times[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": run.launches[name],
                        "max_abs_err": run.err[name], "ms": t[0],
                        "plain_ms": t[1], "bound_ms": t[2], "bound_by": t[3],
                        "library_ms": run.library.get(name),
                        **run.extra.get(name, {})})
    missing = sorted({e[0] for e in ENTRIES} - {k["name"] for k in kernels})
    if set(DEFAULT_PHASES) <= set(run.phases) and missing:
        fail(f"the record lacks entries: {missing}")
    return kernels


def parse_phases(argv) -> tuple:
    ap = argparse.ArgumentParser(description="Smoke test of bath_tpu_torch "
                                 "on one NVIDIA GPU.")
    ap.add_argument("--phases", default=",".join(DEFAULT_PHASES),
                    help=f"comma list of {', '.join(PHASES)} or all "
                    f"(default: every phase but deep and sanitize_full)")
    names = ap.parse_args(argv).phases.split(",")
    if "all" in names:
        return tuple(PHASES)
    unknown = set(names) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    return tuple(p for p in PHASES if p in names)


def host_fixtures(run: Run) -> str:
    """Writes the seeded genomes and host-calibrated profiles of the
    phases to run (the 5 Mb fixtures, the splice and long-model ones,
    the alignments), which need no card, while nvcc compiles; the
    phases read them back.  Returns what it wrote, with its seconds."""
    from bath_tpu_torch import fixtures
    t = time.perf_counter()
    made = []
    if {"parity", "timing", "search"} & set(run.phases):
        run.fx()
        made.append("fx")
    if "search" in run.phases:
        run.fs_fx()
        fixtures.write_splice_fixture(M_SEARCH, GENOME_NT, SPLICE_GENES,
                                      SEED)
        fixtures.write_fixture(SEG_SEARCH_M, *SEG_SEARCH, SEED)
        made += ["fs_fx", "splice", "long_model"]
    if "build" in run.phases:
        run.msa()
        made.append("msa")
    return f"{','.join(made) or 'none'}:{time.perf_counter() - t:.1f}s"


def setup(run: Run) -> None:
    """The device and card lines, the kernels' build (the host's
    fixtures written meanwhile), then the bathbuild --backend numpy
    child (when the build phase runs), which so leaves nvcc its
    cores."""
    from bath_tpu_torch.cli import bathsearch
    from bath_tpu_torch.ops.kernels import loader
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run.card = card_line()
    bathsearch.require_native()
    phase("device", torch=torch.__version__, cuda=torch.version.cuda,
          name=repr(torch.cuda.get_device_name(0)),
          count=torch.cuda.device_count(), native_lib="loaded",
          phases=",".join(run.phases))
    print(run.card, flush=True)
    BUILD.mkdir(parents=True, exist_ok=True)
    t = time.perf_counter()
    per = {}

    def compile_kernels():
        return loader.build(per), time.perf_counter() - t
    with ThreadPoolExecutor(1) as pool:
        job = pool.submit(compile_kernels)
        made = host_fixtures(run)
        so, seconds = job.result()
    loader.lib()
    # each source's nvcc ends per[src] seconds after the start (they run
    # together): ubench.cu's share of the wall and of their sum
    ub_s = per.get("ubench.cu")
    phase("nvcc", seconds=f"{seconds:.1f}",
          host_fixtures_meanwhile=made,
          per_source_s=",".join(f"{k}:{v:.1f}" for k, v in per.items())
          or "cached",
          ubench_cu_s=f"{ub_s:.1f}" if ub_s else "cached",
          ubench_cu_share_of_wall=f"{ub_s / seconds:.3f}" if ub_s else "-",
          ubench_cu_share_of_sum=f"{ub_s / sum(per.values()):.3f}"
          if ub_s else "-",
          nvcc=" ".join(loader.NVCC_FLAGS),
          sources=",".join(str(p.relative_to(ROOT))
                           for p in loader.sources()),
          library=so.relative_to(ROOT))
    if "build" in run.phases:
        start_host_build(run)


def main(argv=None) -> None:
    phases = parse_phases(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    run = Run(phases)
    setup(run)
    for name in phases:
        if name != "parity":
            # the bathbuild child has to have ended before anything is
            # timed
            run.join_host_build()
        t = time.perf_counter()
        PHASES[name](run)
        print(f"[phase] {name} seconds={time.perf_counter() - t:.1f}",
              flush=True)
    stop_children()
    left = [p for p in descendants() if p[1] != "Z"]
    if left:
        fail(f"processes still running after every phase: {left}")
    print(json.dumps({"kernels": record(run)}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
