"""Builds, loads and launches the CUDA kernels of ``csrc/``.

On first use the sources ``csrc/*.cu`` are compiled with nvcc for
``sm_90a``, one nvcc per source, all started together, and linked into
one shared library with a plain C interface under
``build/bath_tpu_torch/`` at the repository root; the file name carries
a hash of the sources, so an edited source builds anew.  The library is
bound with ctypes.  Each C entry returns the launch's
``cudaGetLastError()``; a non-zero code raises.  Without nvcc or a CUDA
device the loader raises: it never returns None and no caller falls
back to the plain versions.

Each entry is launched through a ``prepare_*`` function, which checks
the inputs with one read back from the device and builds the launch
plan once; the ``Launch`` it returns allocates outputs with
``torch.empty``/``zeros`` on the input's device and launches
(``_launch``) with that device selected, on its current stream, so the
kernels of several cards run at once; it does not synchronise.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ...ubench import (ONEHOT_MAX_N, WG_N, WG_TILE, gather_groups,
                       gather_plan, onehot_kt)
from ..fs3 import DNA_CODES
from ..ssv import SSVB_NCAP

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "bath_tpu_torch"
# -lineinfo: line tables only (the code is the same), so that the
# sanitizer tier's reports (bath_tpu_torch/sanitize.py) name a source
# line; the production library and the sanitized run's are one build
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-Xcompiler", "-fPIC")

# Lanes per thread the kernels are instantiated for (odd: conflict-free
# strided shared-memory reads).  A model of M positions takes the
# smallest P with 32*P >= M in one warp, or W warps of P = 33 beyond.
LANES_PER_THREAD = (3, 5, 9, 13, 17, 25, 33)
# The fs3 kernels keep ~10 rows of P floats a thread in their rings, so
# they stop at P = 13 and put W warps of 13 lanes on a longer model.
FS3_LANES_PER_THREAD = (3, 5, 9, 13)
# The ViterbiFilter (csrc/vit_filter.cu), MSV and the Forward gate take
# the whole ladder in one warp, then W warps of VIT_WIDE_LANES: the
# ViterbiFilter's int16 tables fit a block's shared memory up to
# M = 2720 (W = 5), MSV's to M = 3808 (W = 7), where warps of 33 lanes
# would stop at 2112 and 3168; and a call bound by its longest chain
# runs faster past M = 1056 on three warps of 17 lanes than on two of 33
# (PERF.md, the lane-ladder sweeps).  Decoding keeps warps of 33 lanes
# past one warp (layout).
VIT_WIDE_LANES = 17
# The ViterbiFilter's 17-lane instance runs blocks of 16 warps.
VIT_BLOCK_WARPS = 16
# A group's warps share one block, at most 32 warps.
MAX_GROUP_WARPS = 32
# A model past a block's warps takes a group of SEG_WARPS warps (a block
# of 512 threads, so up to 128 registers a thread) that walks each row in
# S segments of 32 * W * P lanes (segmented), at most SEG_LANES lanes a
# thread (the ViterbiFilter's VIT_SEG_LANES, the fs3 pair's
# FS3_SEG_LANES): a thread's state of a segment stays in registers.
SEG_WARPS = 16
SEG_LANES = (3, 5, 9, 13)
VIT_SEG_LANES = (3, 5, 9, 13, 17)
FS3_SEG_LANES = (3, 5, 9)
# threads an SM holds (sm_90): a segmented class's scratch takes a slot
# for each of its blocks the card holds at once (_planned)
SM_THREADS = 2048


_lib = None


class CudaKernelError(RuntimeError):
    pass


def layout(M: int, lanes=LANES_PER_THREAD,
           seg_lanes=SEG_LANES) -> tuple[int, int, int]:
    """(P, W, Mp): lanes per thread, warps per item, padded lanes; past
    a block of MAX_GROUP_WARPS warps, the segmented group's on
    <seg_lanes>."""
    for P in lanes:
        if 32 * P >= M:
            return P, 1, 32 * P
    P = lanes[-1]
    W = -(-M // (32 * P))
    if W <= MAX_GROUP_WARPS:
        return P, W, 32 * P * W
    return segmented(M, seg_lanes)


def segmented(M: int, lanes) -> tuple[int, int, int]:
    """(P, W, Mp) of a model past a block of warps: SEG_WARPS warps a
    group, which walks each row in S = Mp / (32 W P) segments; S is the
    fewest that the widest P of <lanes> allows, P then the fewest lanes
    that cover M in S segments."""
    span = 32 * SEG_WARPS
    S = -(-M // (span * lanes[-1]))
    P = next(p for p in lanes if span * p * S >= M)
    return P, SEG_WARPS, span * P * S


@functools.cache
def segmented_beside(layout_of, lanes):
    """<layout_of> in a launch with a segmented class, whose blocks
    hold SEG_WARPS warps: a model past SEG_WARPS warps is segmented too,
    on <lanes> (made once a ladder, so that a pack relaid on it is made
    once: ``ModelPack.with_layout``)."""
    def of(M: int) -> tuple[int, int, int]:
        P, W, Mp = layout_of(M)
        return (P, W, Mp) if W <= SEG_WARPS else segmented(M, lanes)
    return of


def segments(P: int, W: int, Mp: int) -> int:
    """S, the segments a group of W warps of P lanes walks a row of Mp
    padded lanes in (1: the row fits the group at once)."""
    return Mp // (32 * P * W)


def fs3_layout(M: int) -> tuple[int, int, int]:
    return layout(M, FS3_LANES_PER_THREAD, FS3_SEG_LANES)


def _wide17(M: int) -> tuple[int, int, int]:
    """The whole ladder in one warp, then warps of VIT_WIDE_LANES."""
    if M <= 32 * LANES_PER_THREAD[-1]:
        return layout(M)
    W = -(-M // (32 * VIT_WIDE_LANES))
    return VIT_WIDE_LANES, W, 32 * VIT_WIDE_LANES * W


def vit_layout(M: int) -> tuple[int, int, int]:
    """The ViterbiFilter's: warps of 17 lanes past one warp, up to its
    instance's VIT_BLOCK_WARPS (M = 8704); a longer model takes the
    segmented group, at most 17 lanes a thread."""
    P, W, Mp = _wide17(M)
    if W <= VIT_BLOCK_WARPS:
        return P, W, Mp
    return segmented(M, VIT_SEG_LANES)


def wide_layout(M: int) -> tuple[int, int, int]:
    """MSV's and the Forward gate's ladder: the ViterbiFilter's up to a
    block of MAX_GROUP_WARPS warps of 17 lanes (M = 17408), then warps
    of 33 lanes, to a block of them (M = 33792), then the segmented
    group."""
    if M <= 32 * VIT_WIDE_LANES * MAX_GROUP_WARPS:
        return _wide17(M)
    return layout(M)


msv_layout = fwd_layout = wide_layout


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    path = cand if os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise CudaKernelError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the "
            "bath_tpu_torch CUDA kernels cannot be built")
    return path


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libbath_tpu_torch_{h.hexdigest()[:16]}.so"


def build(seconds: dict | None = None) -> Path:
    """Compile the kernels unless a library of the current sources
    exists: one nvcc per source, run together, then one link.  Writes
    to temporary names and renames, so concurrent processes never load
    a half-written file.  <seconds>, when given, gets each source's
    name with the seconds from the build's start until its nvcc ended
    (nothing when the library existed)."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    ended = {} if seconds is None else seconds
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs, procs = [], []
        for src in sources():
            obj = os.path.join(tmpdir, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        def wait(job):
            (cmd, proc), src = job
            _, err = proc.communicate()
            ended[src.name] = time.perf_counter() - t0
            return cmd, proc.returncode, err
        with ThreadPoolExecutor(len(procs)) as pool:
            ends = list(pool.map(wait, zip(procs, sources())))
        errors = [f"{' '.join(cmd)}\n{err[-4000:]}"
                  for cmd, rc, err in ends if rc != 0]
        if errors:
            raise CudaKernelError("nvcc failed:\n" + "\n".join(errors))
        tmp = os.path.join(tmpdir, so.name)
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise CudaKernelError(f"nvcc link failed ({r.returncode}):\n"
                                  f"{' '.join(cmd)}\n{r.stderr[-4000:]}")
        os.replace(tmp, so)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library; builds it on first use."""
    global _lib
    if _lib is not None:
        return _lib
    if not torch.cuda.is_available():
        raise CudaKernelError("no CUDA device: the bath_tpu_torch kernels "
                              "run only on an NVIDIA GPU")
    so = ctypes.CDLL(str(build()))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    so.bt_fwd_parser.restype = I
    so.bt_fwd_parser.argtypes = [P, P, I, I, F, P, P, P, I, I, I, P]
    so.bt_domdec.restype = I
    so.bt_domdec.argtypes = [P, P, I, F, P, P, P, P, P, I, I, I, P]
    so.bt_fs3_parser.restype = I
    so.bt_fs3_parser.argtypes = [P, P, I, F, P, P, P, I, I, I, P]
    so.bt_fs3_domdec.restype = I
    so.bt_fs3_domdec.argtypes = [P, P, I, F, P, P, P, P, P, I, I, I, P]
    so.bt_msv_filter.restype = I
    so.bt_msv_filter.argtypes = [P, P, P, P, I, P, P, P, I, I, I, I, P]
    so.bt_msv_grid.restype = I
    so.bt_msv_grid.argtypes = [P, I]
    so.bt_ssv_capture.restype = I
    so.bt_ssv_capture.argtypes = [P, P, P, P, P, I, P, P, P, I, I, P, P, I,
                                  P]
    so.bt_vit_filter.restype = I
    so.bt_vit_filter.argtypes = [P, P, P, P, I, P, P, P, I, I, I, P]
    so.bt_vit_capture.restype = I
    so.bt_vit_capture.argtypes = [P, P, P, P, P, I, P, P, P, P, I, I, I, P]
    for name in SEG_ENTRIES:
        f = getattr(so, f"bt_{name}_seg_bytes")
        f.restype = ctypes.c_longlong
        f.argtypes = [I, I]
    so.bt_ub_chain.restype = I
    so.bt_ub_chain.argtypes = [P, P, I, I, I, P]
    so.bt_ub_onehot_gather.restype = I
    so.bt_ub_onehot_gather.argtypes = [P, P, P, P, I, I, I, I, I, P]
    so.bt_ub_onehot_mma.restype = I
    so.bt_ub_onehot_mma.argtypes = [P, P, P, P, P, I, I, I, I, I, P]
    so.bt_ub_overlap.restype = I
    so.bt_ub_overlap.argtypes = [P, P, P, P, I, I, I, I, P]
    so.bt_ub_scalars.restype = I
    so.bt_ub_scalars.argtypes = [P, P, I, I, P]
    so.bt_rescore.restype = I
    so.bt_rescore.argtypes = [P, P, P, P, P, P, P, P, I, I, P, P, P, I, P]
    so.bt_rescore_scratch_floats.restype = ctypes.c_longlong
    so.bt_rescore_scratch_floats.argtypes = [I, I]
    _lib = so
    return so


def _check(err: int, name: str) -> None:
    if err != 0:
        raise CudaKernelError(f"{name} launch failed: cudaError {err}")


def _batch_lens(dsq, lens, codes: int) -> np.ndarray:
    """The padded-batch entries' input check, with one read back from
    the device: contiguous tensors, residue codes in [0, <codes>),
    lengths in [0, L].  Returns the lengths on the host (the plans order
    the items by them)."""
    if dsq.device.type != "cuda":
        raise ValueError(f"CUDA kernel given a {dsq.device} tensor")
    if not (dsq.is_contiguous() and lens.is_contiguous()):
        raise ValueError("dsq and lens must be contiguous")
    parts = [lens.to(torch.int32)]
    if dsq.numel():
        parts.append(torch.stack(torch.aminmax(dsq)).to(torch.int32))
    host = torch.cat(parts).cpu().numpy()
    B = dsq.shape[0]
    if dsq.numel():
        lo, hi = host[B:]
        if lo < 0 or hi >= codes:
            raise ValueError(f"residue codes must lie in [0, {codes})")
        if host[:B].min() < 0 or host[:B].max() > dsq.shape[1]:
            raise ValueError("lens must lie in [0, L]")
    return host[:B]


def _stream_lens(flat, offs, lens, p, *per_item) -> np.ndarray:
    """The integer filters' input check, with one read back from the
    device: contiguous tensors on the device of the parameters <p>,
    residue codes in [0, p.Kp) and every item inside <flat>.  Returns
    the lengths on the host."""
    if flat.device.type != "cuda":
        raise ValueError(f"CUDA kernel given a {flat.device} tensor")
    if p.device != flat.device:
        raise ValueError(f"parameters on {p.device}, input on "
                         f"{flat.device}")
    if not all(t.is_contiguous() for t in (flat, offs, lens, *per_item)):
        raise ValueError("the stream and per-item tensors must be "
                         "contiguous")
    B = lens.numel()
    parts = [lens.to(torch.int64)]
    if flat.numel():
        parts.append(torch.stack(torch.aminmax(flat)).to(torch.int64))
    if B:
        parts.append(torch.stack([offs.min(), (offs + lens).max()]))
    host = torch.cat(parts).cpu().numpy()
    rest = host[B:]
    if flat.numel():
        if rest[0] < 0 or rest[1] >= p.Kp:
            raise ValueError(f"residue codes must lie in [0, {p.Kp})")
        rest = rest[2:]
    if B and (host[:B].min() < 0 or rest[0] < 0 or rest[1] > flat.numel()):
        raise ValueError("every item must lie inside flat")
    return host[:B]


def _launch(name: str, entry, *args) -> None:
    """Calls the C entry <entry> with <args>, each tensor passed as its
    data pointer, on the device of its tensors and that device's
    current stream; raises unless all of them lie on one CUDA device,
    and on a non-zero cudaError."""
    devs = {a.device for a in args if isinstance(a, torch.Tensor)}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{name}: the tensors of one launch must lie on "
                         f"one CUDA device, got {sorted(map(str, devs))}")
    dev = devs.pop()
    with torch.cuda.device(dev):
        err = entry(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                      for a in args),
                    torch.cuda.current_stream(dev).cuda_stream)
    _check(err, name)


def sms(device) -> int:
    """The streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


class Launch:
    """One call of a kernel entry on a checked (and planned) batch: the
    prepare_* functions check the inputs and build the plan once, with
    one read back from the device; calling the object allocates the
    outputs and launches, with no check and no read back, so the
    kernel's own time is the call's.  ``launches``: kernel launches a
    call; ``plan``: the one-launch plan (``ops/multimodel.py``
    ``LaunchPlan``) of the entries that take one.  ``timing``: while a
    device stage times its launches (``device_pipeline.StageTally``),
    its device and its list of event pairs; each call then records a
    pair of CUDA events round itself on that device's current stream."""

    timing = None

    def __init__(self, call, launches: int, plan=None):
        self._call, self.launches, self.plan = call, launches, plan

    def __call__(self, *args):
        if Launch.timing is None:
            return self._call(*args)
        dev, pairs = Launch.timing
        stream = torch.cuda.current_stream(dev)
        pair = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        pair[0].record(stream)
        out = self._call(*args)
        pair[1].record(stream)
        pairs.append(pair)
        return out


# the entries with a segmented instance, each with its bt_*_seg_bytes
SEG_ENTRIES = ("fwd_parser", "domdec", "fs3_parser", "fs3_domdec",
               "msv_filter", "ssv_capture", "vit_filter")


def _planned(plan, device, entry: str) -> tuple:
    """The plan's trailing arguments of a one-launch entry: its table on
    the host and on the device, classes, blocks, warps a block.  Each
    segmented class gets its scratch on <device> (``csrc/plan.cuh``
    ``seg_take``), its address in the class row's word 9: a slot for
    each of its blocks the card holds at once, of the bytes the kernel
    of <entry> says (``bt_<entry>_seg_bytes``), and a header of the slot
    count and a free flag a slot; the plan holds it
    (``LaunchPlan.buffers``)."""
    from ..multimodel import PLAN_CLS
    plan.buffers = []
    if plan.scratch:
        held = sms(device) * (SM_THREADS // (32 * plan.warps))
        seg_bytes = getattr(lib(), f"bt_{entry}_seg_bytes")
    for c, blocks in plan.scratch:
        n = min(blocks or held, held)
        buf = torch.empty(seg_bytes(int(plan.table[PLAN_CLS * c + 4]), n),
                          dtype=torch.uint8, device=device)
        head = buf[:4 * (n + 1)].view(torch.int32)
        head.zero_()
        head[0] = n
        plan.buffers.append(buf)
        plan.table[PLAN_CLS * c + 9] = buf.data_ptr()
    table = torch.from_numpy(plan.table).to(device)
    return (plan.table.ctypes.data, table, plan.ncls, plan.nblk, plan.warps)


def one_segment(M: int, layout_of) -> bool:
    """Whether a model of M positions takes one segment (S = 1) under
    <layout_of>: a single-model call then takes its class row alone
    (``single_plan``), a segmented one a per-item plan."""
    return segments(*layout_of(M)) == 1


def _single(p, key, make, most=None) -> tuple:
    """A single-model call's plan (``ops/multimodel.py`` ``single_plan``),
    its trailing launch arguments (``_planned``) and, with <most>,
    ``most(plan)`` (MSV: the blocks the card holds at once), made once
    per parameter set <p> and <key> (the entry, the device): the call
    then uploads and asks nothing."""
    cache = p.__dict__.setdefault("_single_plans", {})
    if key not in cache:
        plan = make()
        cache[key] = (plan, _planned(plan, key[-1], key[0]),
                      most and most(plan))
    return cache[key]


def prepare_fwd(dsq, lens, slot, p) -> Launch:
    """fwd_parser.cu: the Forward gate of item b under model ``slot[b]``
    of <p> (``build_fwd_pack``, taken under ``fwd_layout``), or of every
    item under one model (<slot> None, <p> its ``ProfileTensors``: a
    plan of its one class, built once), as one launch
    (``ops/multimodel.py`` ``fwd_plan``); a call (nj) gives the scores
    [B] f32 (nats)."""
    from ..multimodel import OneModel, fwd_plan
    ln = _batch_lens(dsq, lens, p.Kp)
    dev = dsq.device
    if p.device != dev:
        raise ValueError(f"parameters on {p.device}, input on {dev}")
    if slot is None and one_segment(p.M, fwd_layout):
        plan, tail, _ = _single(p, ("fwd_parser", dev), lambda: fwd_plan(
            None, None, OneModel(p, fwd_layout)))
    else:
        pack = OneModel(p, fwd_layout) if slot is None \
            else p.with_layout(fwd_layout)
        if slot is None:
            slot = np.zeros(len(ln), np.int64)
        plan = fwd_plan(ln, slot, pack, sms(dev))
        tail = _planned(plan, dev, "fwd_parser")
    so = lib()
    B, L = dsq.shape

    def run(nj):
        out = torch.empty(B, dtype=torch.float32, device=dev)
        _launch("fwd_parser", so.bt_fwd_parser, dsq, lens, B, L, float(nj),
                out, *tail)
        return out
    return Launch(run, int(B > 0 and plan.ncls > 0), plan)


def prepare_domdec(dsq, lens, slot, pack) -> Launch:
    """domdec.cu: decoding of ORF b under model ``slot[b]`` of <pack>
    (``build_domdec_pack``), or of every ORF under one model (<slot>
    None, <pack> its ``ProfileTensors``), as one launch; a call (nj)
    gives the forward and backward specials [B, 6, L+1] f64 of every row
    and (logZ, total forward log scale) [B, 2] f64
    (``ops/domdec.py`` ``finish_passes`` takes them)."""
    from ..multimodel import OneModel, domdec_plan
    if slot is None:
        slot, pack = np.zeros(dsq.shape[0], np.int64), \
            OneModel(pack, layout)
    ln = _batch_lens(dsq, lens, pack.Kp)
    dev = dsq.device
    if pack.device != dev:
        raise ValueError(f"pack on {pack.device}, input on {dev}")
    plan = domdec_plan(ln, slot, pack, sms(dev))
    tail = _planned(plan, dev, "domdec")
    so = lib()
    B, L = dsq.shape

    def run(nj):
        spec = torch.zeros(2, B, 6, L + 1, dtype=torch.float64, device=dev)
        logz2 = torch.empty(B, 2, dtype=torch.float64, device=dev)
        _launch("domdec", so.bt_domdec, dsq, lens, L, float(nj), spec[0],
                spec[1], logz2, *tail)
        return spec[0], spec[1], logz2
    return Launch(run, int(plan.nblk > 0), plan)


def prepare_fs3(dsq, lens, slot, pack, decoding: bool) -> Launch:
    """The fs3 gate (or, with <decoding>, fs3 decoding) of window b under
    model ``slot[b]`` of <pack> (``build_fs3_pack``), or of every window
    under one model (<slot> None, <pack> its ``ProfileTensors``), as one
    launch (``ops/multimodel.py`` ``fs3_plan``).  A call (nj) gives
    fs3_parser.cu's gate scores [B] f32 (nats) of DNA windows (residue
    codes 0..17), or fs3_domdec.cu's forward and backward specials
    [B, 6, L+1] f64 of every nucleotide row and (logZ, total forward
    log scale) [B, 2] f64."""
    from ..multimodel import OneModel, fs3_plan
    if slot is None:
        slot, pack = np.zeros(dsq.shape[0], np.int64), OneModel(pack)
    ln = _batch_lens(dsq, lens, DNA_CODES)
    dev = dsq.device
    if pack.device != dev:
        raise ValueError(f"pack on {pack.device}, input on {dev}")
    plan = fs3_plan(ln, slot, pack, 2 if decoding else 1)
    tail = _planned(plan, dev, "fs3_domdec" if decoding else "fs3_parser")
    so = lib()
    B, L = dsq.shape

    def run(nj):
        head = (dsq, lens, L, float(nj))
        if not decoding:
            out = torch.empty(B, dtype=torch.float32, device=dev)
            _launch("fs3_parser", so.bt_fs3_parser, *head, out, *tail)
            return out
        spec = torch.zeros(2, B, 6, L + 1, dtype=torch.float64, device=dev)
        logz2 = torch.empty(B, 2, dtype=torch.float64, device=dev)
        _launch("fs3_domdec", so.bt_fs3_domdec, *head, spec[0], spec[1],
                logz2, *tail)
        return spec[0], spec[1], logz2
    return Launch(run, int(plan.nblk > 0), plan)


def prepare_msv(flat, offs, lens, tjb, slot, p) -> Launch:
    """msv_filter.cu: the fused SSV+MSV filter of every ORF of the
    stream under model ``slot[b]`` of <p> (``build_msv_pack``), or under
    one model (<slot> None, <p> its ``MSVParams``: a plan of its one
    class and the blocks the card holds at once, built once, the blocks
    striding over the items), as one launch (``ops/multimodel.py``
    ``msv_plan``); a call gives (xEu, xJm, movf) [3, B] int32."""
    from ..multimodel import msv_plan
    ln = _stream_lens(flat, offs, lens, p, tjb)
    dev = flat.device
    so = lib()
    B = lens.numel()
    if slot is None and one_segment(p.M, msv_layout):
        def most(plan):
            with torch.cuda.device(dev):
                return so.bt_msv_grid(plan.table.ctypes.data, plan.warps)
        plan, tail, most = _single(
            p, ("msv_filter", dev), lambda: msv_plan(None, None, p.as_pack()),
            most)
        tail = (*tail, min(-(-B // int(plan.table[5])), most))
    else:
        if slot is None:
            slot, p = np.zeros(B, np.int64), p.as_pack()
        plan = msv_plan(ln, slot, p, sms(dev))
        tail = (*_planned(plan, dev, "msv_filter"), plan.nblk)

    def run():
        out = torch.empty(3, B, dtype=torch.int32, device=dev)
        _launch("msv_filter", so.bt_msv_filter, flat, offs, lens, tjb, B,
                out, *tail)
        return out
    return Launch(run, int(B > 0 and plan.ncls > 0), plan)


def prepare_ssv_capture(flat, offs, lens, tjb, thresh, p) -> Launch:
    """ssv_capture.cu: the SSV capture of every ORF of the stream under
    the one model of <p> (``ops/ssv.py`` ``MSVParams``), as one launch on
    MSV's table and class row (``ops/multimodel.py`` ``ssv_plan``, made
    once a parameter set, with a segmented model's scratch), the ORFs
    longest first by a sort on the card (``ssv_order``, started before
    the check's read back) and dealt round the blocks (``ssv_blocks``);
    a call gives (nwin [B], wi, wk, wsc [B, SSVB_NCAP]) int32."""
    from ..multimodel import ssv_blocks, ssv_order, ssv_plan
    order = ssv_order(lens)
    _stream_lens(flat, offs, lens, p, tjb, thresh)
    dev = flat.device
    B = lens.numel()
    plan, tail, _ = _single(p, ("ssv_capture", dev),
                            lambda: ssv_plan(p.as_pack()))
    groups, blocks = ssv_blocks(B, int(plan.table[5]), sms(dev))
    so = lib()

    def run():
        nwin = torch.empty(B, dtype=torch.int32, device=dev)
        caps = torch.zeros(3, B, SSVB_NCAP, dtype=torch.int32, device=dev)
        _launch("ssv_capture", so.bt_ssv_capture, flat, offs, lens, tjb,
                thresh, B, nwin, caps, order, groups, blocks, tail[0],
                tail[1], tail[4])
        return nwin, caps[0], caps[1], caps[2]
    return Launch(run, int(B > 0), plan)


def prepare_vit(flat, offs, lens, move, slot, pack, thresh=None) -> Launch:
    """vit_filter.cu: the ViterbiFilter (or, with <thresh>, its capture)
    of every ORF of the stream under model ``slot[b]`` of <pack>
    (``build_vit_pack``), or under one model (<slot> None, <pack> its
    ``VitParams``), as one launch (``ops/multimodel.py`` ``vit_plan``).
    A call gives (score_int, has, ovf) [3, B] int32, or with <thresh>
    (karr [N] int16 in the layout of <flat>, ovfrow [B] int32)."""
    from ..multimodel import vit_plan
    if slot is None:
        slot, pack = np.zeros(lens.numel(), np.int64), pack.as_pack()
    extra = () if thresh is None else (thresh,)
    ln = _stream_lens(flat, offs, lens, pack, move, *extra)
    dev = flat.device
    plan = vit_plan(ln, slot, pack, sms(dev))
    tail = _planned(plan, dev, "vit_filter")
    so = lib()
    B = lens.numel()

    def run():
        if thresh is None:
            out = torch.empty(3, B, dtype=torch.int32, device=dev)
            _launch("vit_filter", so.bt_vit_filter, flat, offs, lens, move, B,
                    out, *tail)
            return out
        ovfrow = torch.empty(B, dtype=torch.int32, device=dev)
        karr = torch.zeros(flat.numel(), dtype=torch.int16, device=dev)
        _launch("vit_capture", so.bt_vit_capture, flat, offs, lens, move,
                thresh, B, ovfrow, karr, *tail)
        return karr, ovfrow
    return Launch(run, int(plan.nblk > 0), plan)


# ---------------------------------------------------------------------
# rescore.cu: the envelope fills (``ops/rescore.py``)
# ---------------------------------------------------------------------
def prepare_rescore(dsq, doff, lens, xff, ooff, total: int, p) -> Launch:
    """The envelope fills of ``csrc/rescore.cu`` on a batch whose
    residues, lengths and length models the caller checked on the host
    (``ops/rescore.py``): one block an envelope, <dsq> one int8 stream
    read at the int64 offsets <doff>, each envelope's output region at
    the float offsets <ooff> of one buffer of <total> floats.  The call
    gives (that buffer, the int32 statuses)."""
    so = lib()
    B = int(lens.numel())
    per_block = int(so.bt_rescore_scratch_floats(p.M, p.nleaf))

    def run():
        dev = dsq.device
        out = torch.empty(total, dtype=torch.float32, device=dev)
        status = torch.empty(B, dtype=torch.int32, device=dev)
        scratch = torch.empty(per_block * B, dtype=torch.float32,
                              device=dev) if per_block else None
        _launch("rescore", so.bt_rescore, dsq, doff, lens, xff, ooff, p.rfv,
                p.tv, p.pw, p.M, p.nleaf, out, status, scratch, B)
        return out, status

    return Launch(run, 1)


# ---------------------------------------------------------------------
# ubench.cu: the card's microbenchmarks (``bath_tpu_torch/ubench.py``)
# ---------------------------------------------------------------------
def _check_ub(*tensors):
    if tensors[0].device.type != "cuda":
        raise ValueError(f"CUDA kernel given a {tensors[0].device} tensor")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the microbenchmarks take contiguous tensors")


def launch_ub_chain(x: torch.Tensor, nops: int, reps: int) -> torch.Tensor:
    """ubench.cu bt_ub_chain: x [Mt, Bt] f32 stepped <reps> times."""
    _check_ub(x)
    out = torch.empty_like(x)
    _launch("ub_chain", lib().bt_ub_chain, x, out, x.numel(), int(nops),
            int(reps))
    return out


UB_MAX_MT = 136                 # rows of t the onehot entries take
UB_IDX_CHUNK = 32               # steps of indices a block copies at once


def ub_onehot_check(Mt: int, n: int, Bt: int, mma: bool) -> None:
    """The onehot entries' shapes: Mt <= UB_MAX_MT; on the tensor cores
    also n <= ubench.ONEHOT_MAX_N and Bt a multiple of 16 (a last tile
    of fewer than ubench.WG_TILE columns is masked).  Raises
    ValueError."""
    if Mt < 1 or Mt > UB_MAX_MT or n < 1 or Bt < 1 or (mma and (
            n > ONEHOT_MAX_N or Bt % 16)):
        raise ValueError(f"the onehot entries take Mt <= {UB_MAX_MT} (and "
                         f"on the tensor cores n <= {ONEHOT_MAX_N} and Bt a "
                         f"multiple of 16), got t [{Mt}, {n}], Bt {Bt}")


def ub_overlap_check(Mt: int, Bt: int) -> None:
    """The overlap entry's shapes: Mt a multiple of 8 up to UB_MAX_MT,
    Bt a multiple of 32 (a last tile of 32 columns is masked)."""
    if Mt < 8 or Mt % 8 or Mt > UB_MAX_MT or Bt < 32 or Bt % 32:
        raise ValueError(f"the overlap entry takes Mt a multiple of 8 up "
                         f"to {UB_MAX_MT} and Bt of 32, got [{Mt}, {Bt}]")


def ub_onehot_splits(Bt: int, reps: int, sms: int) -> int:
    """The blocks bt_ub_onehot_mma splits the steps of each tile of
    ubench.WG_TILE columns over: about two blocks an SM (its registers
    and shared memory hold two), whole chunks of UB_IDX_CHUNK steps
    each, none empty.  [136, 1024] x 512 on 132 SMs: 16 tiles x 16
    splits of 32 steps; Bt = 4096: 64 x 4 of 128."""
    tiles = -(-Bt // WG_TILE)
    chunks = -(-reps // UB_IDX_CHUNK)
    if chunks <= 1:
        return 1
    per = -(-chunks // min(chunks, max(1, 2 * sms // tiles)))
    return -(-chunks // per)


def launch_ub_onehot(t: torch.Tensor, idx: torch.Tensor,
                     mma: bool) -> torch.Tensor:
    """ubench.cu bt_ub_onehot_mma (tensor cores) or bt_ub_onehot_gather
    (by index): acc [Mt, Bt] f32 = sum over reps i of t[:, idx[i]]; an
    index outside [0, n) adds nothing (not checked here: that would
    read the indices back and stall the host on every call).  Both
    entries pack t^T into an image once a call (scratch ``img``).  The
    gather's blocks take ``ubench.gather_plan``'s warps (0: the wide
    instance, for a table whose padded image does not fit); the
    tensor-core entry splits the steps over blocks
    (``ub_onehot_splits``) into a scratch of partial sums, which it adds
    in split order."""
    _check_ub(t, idx)
    Mt, n = t.shape
    reps, Bt = idx.shape
    ub_onehot_check(Mt, n, Bt, mma)
    out = torch.empty(Mt, Bt, dtype=torch.float32, device=t.device)
    if not mma:
        warps, _ = gather_plan(Mt, n, Bt, sms(t.device))
        img = torch.empty((n + 1) * 8 * gather_groups(Mt)[0],
                          dtype=torch.bfloat16,
                          device=t.device) if warps else None
        _launch("ub_onehot_gather", lib().bt_ub_onehot_gather, t, idx, out,
                img, Mt, n, Bt, reps, warps)
        return out
    splits = ub_onehot_splits(Bt, reps, sms(t.device))
    img = torch.empty(WG_N * 16 * onehot_kt(n), dtype=torch.bfloat16,
                      device=t.device)
    part = torch.empty(splits, Mt, Bt, dtype=torch.float32,
                       device=t.device) if splits > 1 else None
    _launch("ub_onehot_mma", lib().bt_ub_onehot_mma, t, idx, out, img, part,
            Mt, n, Bt, reps, splits)
    return out


OVERLAP_MODES = {"chain": 1, "dot": 2, "both": 3}


def launch_ub_overlap(g: torch.Tensor, x: torch.Tensor, mode: str,
                      reps: int, y0=None) -> torch.Tensor:
    """ubench.cu bt_ub_overlap: acc + yacc[:Mt], [Mt, Bt] f32; yacc
    starts at 0.3, or at <y0> [2Mt, Bt] bf16."""
    _check_ub(g, x, *(() if y0 is None else (y0,)))
    Mt, Bt = x.shape
    ub_overlap_check(Mt, Bt)
    if g.data_ptr() % 16:
        raise ValueError("the overlap entry reads g in 16-byte rows: g must "
                         "start on a 16-byte boundary")
    out = torch.empty_like(x)
    _launch("ub_overlap", lib().bt_ub_overlap, g, x, y0, out, Mt, Bt,
            OVERLAP_MODES[mode], int(reps))
    return out


def launch_ub_scalars(Bt: int, reps: int, device) -> tuple:
    """ubench.cu bt_ub_scalars, one launch: (the scratch sp [32, Bt],
    which the kernel starts and writes whole, its rows 0-15 stepped and
    rows 16-31 at the 0.3 start; row 0 [1, Bt]) f32."""
    sp = torch.empty(32, Bt, dtype=torch.float32, device=device)
    out = torch.empty(1, Bt, dtype=torch.float32, device=device)
    _check_ub(sp, out)
    _launch("ub_scalars", lib().bt_ub_scalars, sp, out, Bt, int(reps))
    return sp, out
