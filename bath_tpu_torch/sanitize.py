"""The sanitizer tier of bath_tpu_torch: the port's native host library
under ASAN+UBSAN, and its hand-written CUDA kernels under NVIDIA's
compute-sanitizer.

    python -m bath_tpu_torch.sanitize native [-- COMMAND ...]
    python -m bath_tpu_torch.sanitize cuda [--tools memcheck,racecheck,...]

``native`` builds ``native/src/bathio.cpp`` with ASAN and UBSAN,
fail-fast (the flags of ``scripts/sanitize_native.sh``), into
``build/bath_tpu_torch/`` and runs a process with the sanitizers'
runtimes preloaded and the package pointed at that library
(``BATH_TORCH_NATIVE_SO``, which raises where the library does not
load).  Given a command, it runs that command so and exits with its
code.  Without one it first runs the canary, a native call given an
output buffer one element too short, which must abort with an
AddressSanitizer report; then five ``--backend numpy`` searches of
seeded fixtures, the self-check's four modes (``selfcheck.MODES``:
standard, ``--fs``, ``--splice``, a multi-HMM query file) and ``--cpu
2``, each of which must exit 0 under the sanitizers and print the bytes
of the same search without them.  The
``--cpu`` workers start from ``forkserver`` with the caller's
environment (``parallel/pool.py``); each says which native library it
mapped (``stats["worker_native"]``), which must be the sanitized one.

``cuda`` runs every kernel entry of the port (the twenty of
``chip_smoke.py``'s record and the sharded step over two shares) at
tiny shapes on the card, each output held against its plain version as
the parity phase holds it (the integer entries bit for bit, the f32
ones within FWD_TOL and DOMDEC_TOL with the same ``ok``), in one child
process under ``compute-sanitizer --tool <tool>`` for each tool asked
for, with a kernel filter that instruments the port's kernels and not
PyTorch's.  The cases (``cuda_cases``) cover each entry's plan
families: one width, several widths in one launch, several models in
one launch, a single-model call on ``_one_model_plan``, a segmented
class (``loader.segmented``: a model just past the block's warps, whose
blocks take scratch slots through ``seg_take``/``seg_free``), the fs3
pair on the direct loads and on the emission ring, and the step over
two shares.  Before the cases, each tool runs its canary
(``ops/kernels/canary/canary.cu``: a write past a buffer, a shared
race, a read of memory nothing wrote, a barrier half a warp reaches),
which it must report: a clean run counts only after that.  The
library is the production one (``loader.NVCC_FLAGS`` carry
``-lineinfo``, so the tools' reports name source lines).
"""

from __future__ import annotations

import argparse
import fcntl
import functools
import hashlib
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from .bands import DOMDEC_TOL, FWD_TOL, P1_THR, SSV_THR, UB_TOL, VIT_THR
from .selfcheck import MODES, cascade_fixtures, masked_outputs

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build" / "bath_tpu_torch"

# ---------------------------------------------------------------------
# native: the host library under ASAN+UBSAN
# ---------------------------------------------------------------------
# scripts/sanitize_native.sh's flags: every report aborts the process
ASAN_FLAGS = ("-O1", "-g", "-march=native", "-ffp-contract=off", "-fopenmp",
              "-shared", "-fPIC", "-fsanitize=address,undefined",
              "-fno-sanitize-recover=all")
SANITIZER_ENV = {"ASAN_OPTIONS": "detect_leaks=0,abort_on_error=1",
                 "UBSAN_OPTIONS": "halt_on_error=1"}
OVERRIDE = "BATH_TORCH_NATIVE_SO"
NATIVE_LIMIT_S = 600        # each child of the native tier


def _cpu_flags() -> bytes:
    try:
        with open("/proc/cpuinfo") as f:
            return next((ln for ln in f if ln.startswith("flags")),
                        "").encode()
    except OSError:
        return b""


def _built(so: Path, cmd: list, what: str) -> Path:
    """<so>, built by <cmd> (which writes the path that follows its
    ``-o``) unless it exists: under a lock, into a temporary name that
    is renamed into place, so that concurrent processes build it once
    and never load a half-written file."""
    so.parent.mkdir(parents=True, exist_ok=True)
    with open(f"{so}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not so.exists():
            fd, tmp = tempfile.mkstemp(dir=so.parent, suffix=".so.tmp")
            os.close(fd)
            r = subprocess.run([*cmd, "-o", tmp], capture_output=True,
                               text=True)
            if r.returncode:
                os.unlink(tmp)
                raise RuntimeError(f"{what} did not build:\n"
                                   f"{' '.join(cmd)}\n{r.stderr[-4000:]}")
            os.replace(tmp, so)
    return so


def asan_library() -> Path:
    """The native library built with ASAN+UBSAN, once a source, flag
    set and CPU (the build is -march=native)."""
    from .native import _SRC
    h = hashlib.sha256(Path(_SRC).read_bytes())
    h.update(" ".join(ASAN_FLAGS).encode())
    h.update(_cpu_flags())
    so = BUILD / f"libbathio_torch_asan_{h.hexdigest()[:16]}.so"
    return _built(so, ["g++", *ASAN_FLAGS, _SRC],
                  "the ASAN+UBSAN native library")


def runtime(name: str) -> str:
    """The path of a sanitizer runtime (libasan.so, libubsan.so) of the
    compiler that built the library."""
    path = subprocess.run(["g++", f"-print-file-name={name}"],
                          capture_output=True, text=True,
                          check=True).stdout.strip()
    if not os.path.isabs(path):
        raise RuntimeError(f"g++ knows no {name}")
    return path


def native_env(so: Path | None = None) -> dict:
    """The environment of a process under the sanitizers: their
    runtimes preloaded (Python itself is not instrumented), every report
    fatal, leak checks off (the interpreter keeps its memory by design),
    the package pointed at the sanitized library <so>."""
    so = so or asan_library()
    pre = [runtime("libasan.so"), runtime("libubsan.so")]
    if os.environ.get("LD_PRELOAD"):
        pre.append(os.environ["LD_PRELOAD"])
    path = os.pathsep.join(p for p in (str(ROOT),
                                       os.environ.get("PYTHONPATH")) if p)
    return dict(os.environ, **SANITIZER_ENV, LD_PRELOAD=" ".join(pre),
                PYTHONPATH=path, **{OVERRIDE: str(so)})


def native_canary() -> None:
    """The native tier's known fault: the library's reverse complement
    of n residues into an output of n - 1.  Under ASAN the process
    aborts with a heap-buffer-overflow report before it prints."""
    import numpy as np

    from . import native
    n = 4096
    dsq = np.zeros(n, np.int32)
    comp = np.arange(16, dtype=np.int32)
    out = np.zeros(n - 1, np.int32)
    native.get_lib().bio_revcomp(dsq, n, comp, out)
    print("the write past the buffer was not caught", flush=True)


# mode: (fixture, options); the self-check's four modes and the window
# pool; every search is --backend numpy
NATIVE_SEARCHES = {**MODES,
                   "cpu": ("standard", ["--cpu", "2", "--block_length",
                                        "8000"])}


def search_outputs(out_dir, mode: str) -> list:
    """The output paths of one search: -o, --tblout, --fstblout,
    --exontblout."""
    return [str(Path(out_dir) / f"{mode}.{x}")
            for x in ("out", "tbl", "fst", "ex")]


def run_searches(fixture_dir, out_dir) -> dict:
    """The five searches in this process, each into <out_dir>; returns
    (and prints as its last line) each one's exit code, the native
    libraries this process mapped, and, for ``--cpu``, those its
    workers mapped."""
    from .cli import bathsearch
    from .parallel.pool import mapped_native, stop_servers
    fxs = cascade_fixtures(fixture_dir)
    res: dict = {}
    for mode, (name, opts) in NATIVE_SEARCHES.items():
        paths = search_outputs(out_dir, mode)
        outs = ["-o", paths[0], "--tblout", paths[1]]
        if mode == "fs":
            outs += ["--fstblout", paths[2]]
        if mode == "splice":
            outs += ["--exontblout", paths[3]]
        st: dict = {}
        rc = bathsearch.run(["--backend", "numpy", "--device", "cpu", *opts,
                             *outs, fxs[name].hmm_path, fxs[name].fasta_path],
                            stats=st)
        res[mode] = {"rc": rc, "worker_native": st.get("worker_native")}
    stop_servers()
    summary = {"searches": res, "mapped": mapped_native(),
               "override": os.environ.get(OVERRIDE)}
    print(json.dumps(summary), flush=True)
    return summary


def _python(code: str, *args) -> list:
    return [sys.executable, "-c", code, *map(str, args)]


SEARCHES_CODE = ("import sys; from bath_tpu_torch.sanitize import "
                 "run_searches; run_searches(sys.argv[1], sys.argv[2])")
CANARY_CODE = ("from bath_tpu_torch.sanitize import native_canary; "
               "native_canary()")


def _last_json(text: str) -> dict:
    for ln in reversed(text.strip().splitlines()):
        if ln.startswith("{"):
            return json.loads(ln)
    return {}


def native_check(work_dir, fixture_dir=None) -> dict:
    """The native tier: the canary under the sanitizers, then the five
    searches with and without them, at once, in two child processes.
    Returns the canary's exit code and whether ASAN reported, the
    sanitized library, what each child mapped, and for each search its
    exit codes, the libraries the ``--cpu`` workers mapped and whether
    the outputs were byte-identical (run-dependent lines masked)."""
    from .fixtures import FIXTURE_DIR
    t0 = time.perf_counter()
    so = asan_library()
    build_s = time.perf_counter() - t0
    fixture_dir = fixture_dir or FIXTURE_DIR
    cascade_fixtures(fixture_dir)
    env = native_env(so)
    r = subprocess.run(_python(CANARY_CODE), env=env, cwd=ROOT,
                       capture_output=True, text=True,
                       timeout=NATIVE_LIMIT_S)
    canary = {"rc": r.returncode,
              "reported": "ERROR: AddressSanitizer: heap-buffer-overflow"
              in r.stderr and "was not caught" not in r.stdout,
              "report": "\n".join(r.stderr.splitlines()[:3])}
    work = Path(work_dir)
    plain_env = {k: v for k, v in os.environ.items() if k != OVERRIDE}
    plain_env["PYTHONPATH"] = env["PYTHONPATH"]
    procs = {}
    for tag, e in (("plain", plain_env), ("asan", env)):
        (work / tag).mkdir(parents=True, exist_ok=True)
        procs[tag] = subprocess.Popen(
            _python(SEARCHES_CODE, fixture_dir, work / tag), env=e, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    done = {}
    for tag, p in procs.items():
        try:
            out, err = p.communicate(timeout=NATIVE_LIMIT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        done[tag] = {"rc": p.returncode, "summary": _last_json(out),
                     "stderr": err[-4000:]}
    searches = {}
    for mode in NATIVE_SEARCHES:
        got = {tag: done[tag]["summary"].get("searches", {}).get(mode, {})
               for tag in done}
        texts = {tag: masked_outputs(search_outputs(work / tag, mode))
                 for tag in done}
        searches[mode] = {
            "rc_plain": got["plain"].get("rc"), "rc": got["asan"].get("rc"),
            "worker_native": got["asan"].get("worker_native"),
            "identical": texts["plain"] == texts["asan"]
            and texts["plain"][0] is not None}
    return {"library": str(so), "build_s": build_s, "canary": canary,
            "children": {t: {"rc": d["rc"],
                             "mapped": d["summary"].get("mapped"),
                             "override": d["summary"].get("override"),
                             "stderr": d["stderr"] if d["rc"] else ""}
                         for t, d in done.items()},
            "searches": searches, "seconds": time.perf_counter() - t0}


def native_clean(res: dict) -> list:
    """What a native tier's result <res> (``native_check``) fails on."""
    bad = []
    so = res["library"]
    if not (res["canary"]["reported"] and res["canary"]["rc"] != 0):
        bad.append(f"the canary was not caught: {res['canary']}")
    asan = res["children"]["asan"]
    if asan["rc"] != 0:
        bad.append(f"the sanitized searches exited {asan['rc']}: "
                   f"{asan['stderr']}")
    if asan["mapped"] != [so] or asan["override"] != so:
        bad.append(f"the sanitized child mapped {asan['mapped']}, not {so}")
    for mode, s in res["searches"].items():
        if s["rc"] != 0 or s["rc_plain"] != 0 or not s["identical"]:
            bad.append(f"{mode}: rc {s['rc']} (without the sanitizers "
                       f"{s['rc_plain']}), identical={s['identical']}")
    workers = res["searches"]["cpu"]["worker_native"]
    if workers != [so]:
        bad.append(f"the --cpu workers mapped {workers}, not {so}")
    return bad


def main_native(argv) -> int:
    if argv:
        env = native_env()
        print(f"# {OVERRIDE}={env[OVERRIDE]}", file=sys.stderr, flush=True)
        return subprocess.run(argv, env=env).returncode
    with tempfile.TemporaryDirectory(dir=BUILD if BUILD.exists()
                                     else None) as work:
        res = native_check(work)
    bad = native_clean(res)
    print(f"[sanitize] native library={res['library']} "
          f"build_s={res['build_s']:.1f} canary_caught="
          f"{res['canary']['reported']} searches="
          f"{','.join(res['searches'])} clean={not bad} "
          f"seconds={res['seconds']:.1f}", flush=True)
    for mode, s in res["searches"].items():
        print(f"[sanitize] native {mode}: rc={s['rc']} "
              f"identical={s['identical']}", flush=True)
    for b in bad:
        print(f"[sanitize] native FAILED: {b}", file=sys.stderr, flush=True)
    return 1 if bad else 0


# ---------------------------------------------------------------------
# cuda: the kernels' cases
# ---------------------------------------------------------------------
SEED = 20261018
# models just past each family's former ceiling of a block's warps,
# where the rows are walked in segments (loader.segmented): the gate,
# decoding, MSV and the SSV capture past 33792, the ViterbiFilter past
# 8704, the fs3 pair past 13312
SEG_M = {"dd": 34_000, "vit": 9_000, "fs3": 14_000}
# what each entry's outputs are held as
KIND = {"fwd_parser": "gate", "fs3_parser": "gate",
        "fwd_parser_multi": "gate", "fs3_parser_multi": "gate",
        "domdec": "decoding", "fs3_domdec": "decoding",
        "domdec_multi": "decoding", "fs3_domdec_multi": "decoding",
        "msv_filter": "exact", "ssv_capture": "exact", "vit_filter": "exact",
        "vit_capture": "exact", "msv_filter_multi": "exact",
        "vit_filter_multi": "exact", "mesh_step": "step",
        "rescore": "exact",
        **{k: "ubench" for k in ("ub_chain", "ub_onehot_gather",
                                 "ub_onehot_mma", "ub_overlap",
                                 "ub_scalars")}}


class CaseMismatch(AssertionError):
    pass


@functools.cache
def case_model(M: int, fs: bool = False):
    """(profile, query residues) of a seeded uncalibrated model of M
    positions (the fs3 profile with <fs>), made once.  Its maximum
    length is 4M (``BuilderConfig(w_beta=0)``): the kernels do not read
    it, and the exact one takes O(M^2) on the host."""
    import numpy as np

    from . import fixtures
    from .bg import Background
    from .builder import BuilderConfig, single_build
    rng = np.random.default_rng(SEED + M + fs)
    f = Background().f[:20].astype(np.float64)
    q = rng.choice(20, size=M, p=f / f.sum()).astype(np.uint8)
    hmm = single_build(q, f"case{M}", BuilderConfig(fs=fs, w_beta=0.0),
                       do_calibrate=False)
    return (fixtures.fs_search_profile(hmm) if fs
            else fixtures.search_profile(hmm)), q


class Case:
    """One case of the sanitized run: <entries> (names of
    ``chip_smoke.py``'s record) launched on the models of lengths <Ms>
    by ``run(device)``, which gives {entry: [outputs of each call]}; on
    a CUDA device the wrappers launch the kernels, on the CPU they run
    the plain versions.  <plan> names the plan family; <segmented> the
    entries whose launch holds a segmented class; <reps> the steps of
    its microbenchmark calls (the tensor-core entry's band grows with
    them)."""

    def __init__(self, name, plan, Ms, entries, run, segmented=(), reps=3):
        self.name, self.plan, self.Ms = name, plan, tuple(Ms)
        self.entries, self.run = tuple(entries), run
        self.segmented = tuple(segmented)
        self.reps = reps


def _t(a, dev):
    import torch
    return torch.as_tensor(a).to(dev)


def _orfs(M: int, B: int, L: int, seed: int):
    """(dsq [B, L] padded, lens [B]) of ORFs of 1..L residues, half
    with a mutated copy of the query of the model of M (``kernel_batch``)
    where it fits."""
    import numpy as np

    from .fixtures import kernel_batch
    _, q = case_model(M)
    return kernel_batch(q, B, L, np.random.default_rng(seed))


def _windows(M: int, B: int, L: int, seed: int):
    """(dsq [B, L] padded, lens [B]) of DNA windows of 0..L nt, some with
    (frameshifted) copies of the query (``fs_window_batch``)."""
    import numpy as np

    from .fixtures import fs_window_batch
    _, q = case_model(M, True)
    return fs_window_batch(q, B, L, np.random.default_rng(seed))


def _stream(dsq, lens, dev):
    from .ops import ssv
    return tuple(_t(a, dev) for a in ssv.pack_stream(
        [r[:n] for r, n in zip(dsq, lens)]))


def _f32(M, dsq, lens, decoding=True):
    """The Forward gate and decoding of one model on ORFs."""
    def run(dev):
        from .ops import domdec as dd
        from .ops import fwd
        p = fwd.fwd_params(case_model(M)[0], dev)
        d, lt = _t(dsq, dev), _t(lens, dev)
        out = {"fwd_parser": [fwd.fwd_score(d, lt, p)]}
        if decoding:
            out["domdec"] = [dd.domdec(d, lt, p)]
        return out
    return run


def _fs3(M, dsq, lens):
    """The fs3 gate and fs3 decoding of one model on DNA windows."""
    def run(dev):
        from .ops import fs3
        from .ops import fs3_domdec as fdd
        p = fs3.fs3_params(case_model(M, True)[0], dev)
        d, lt = _t(dsq, dev), _t(lens, dev)
        return {"fs3_parser": [fs3.fs3_score(d, lt, p)],
                "fs3_domdec": [fdd.fs3_domdec(d, lt, p, 100.0 / 103.0)]}
    return run


def _ints(M, dsq, lens, entries):
    """The integer filters of one model on the ORFs as one stream: MSV,
    the SSV capture at SSV_THR and P1_THR, the ViterbiFilter and its
    capture at VIT_THR and P1_THR (those of <entries>)."""
    def run(dev):
        import numpy as np

        from .ops import ssv, vit
        om = case_model(M)[0]
        flat, offs, ln = _stream(dsq, lens, dev)
        out = {}
        pm = ssv.msv_params(om, dev)
        tjb = _t(pm.tjb_for(lens).astype(np.int32), dev)
        if "msv_filter" in entries:
            out["msv_filter"] = [ssv.msv_ssv(flat, offs, ln, tjb, pm)]
        if "ssv_capture" in entries:
            out["ssv_capture"] = [ssv.ssv_capture(
                flat, offs, ln, tjb, _t(np.full(len(lens), t, np.int32), dev),
                pm) for t in (SSV_THR, P1_THR)]
        pv = vit.vit_params(om, dev)
        move = _t(pv.move_for(lens).astype(np.int32), dev)
        if "vit_filter" in entries:
            out["vit_filter"] = [vit.vit_ints(flat, offs, ln, move, pv)]
        if "vit_capture" in entries:
            out["vit_capture"] = [vit.vit_capture(
                flat, offs, ln, move, _t(np.full(len(lens), t, np.int32), dev),
                pv) for t in (VIT_THR, P1_THR)]
        return out
    return run


def _mixed(Ms, per_model: int, L: int, seed: int, entries, one=None):
    """Several models in one launch of each entry of <entries> (the
    multi-model wrappers), items of every model mixed in one batch; with
    <one>, every item under model <one> of the pack (a pack's
    single-model call, ``_one_model_plan``)."""
    import numpy as np
    fs = any(e.startswith("fs3") for e in entries)
    rng = np.random.default_rng(seed)
    rows, lens, slot = [], [], []
    for g, M in enumerate(Ms):
        seed_g = int(rng.integers(1 << 30))
        if fs:
            # the first model keeps the opening windows of 0, 2, 3, 4 and
            # L nt
            d, ln = _windows(M, per_model + 5, L, seed_g)
            d, ln = (d, ln) if g == 0 else (d[5:], ln[5:])
        else:
            d, ln = _orfs(M, per_model, L, seed_g)
        rows.append(d)
        lens.append(ln)
        slot += [g] * len(ln)
    dsq, lens = np.concatenate(rows), np.concatenate(lens)
    slot = np.asarray(slot, np.int64)
    order = rng.permutation(len(slot))
    dsq, lens, slot = dsq[order], lens[order], slot[order]
    if one is not None:
        slot = np.full_like(slot, one)

    def run(dev):
        from .ops import fs3, fwd, ssv, vit
        from .ops import multimodel as mm
        out = {}
        if fs:
            pack = mm.build_fs3_pack([fs3.fs3_params(case_model(M, True)[0],
                                                     dev) for M in Ms])
            d, lt = _t(dsq, dev), _t(lens, dev)
            n3 = lens // 3
            dec = _t((n3 / (n3 + 3.0)).astype(np.float32), dev)
            if "fs3_parser_multi" in entries:
                out["fs3_parser_multi"] = [mm.fs3_pack_scores(pack, d, lt,
                                                              slot)]
            if "fs3_domdec_multi" in entries:
                out["fs3_domdec_multi"] = [mm.fs3_domdec_pack_batch(
                    pack, d, lt, slot, dec)]
            return out
        oms = [case_model(M)[0] for M in Ms]
        if {"fwd_parser_multi", "domdec_multi"} & set(entries):
            pack = mm.build_fwd_pack([fwd.fwd_params(om, dev) for om in oms])
            d, lt = _t(dsq, dev), _t(lens, dev)
            if "fwd_parser_multi" in entries:
                out["fwd_parser_multi"] = [mm.fwd_pack_scores(pack, d, lt,
                                                              slot)]
            if "domdec_multi" in entries:
                out["domdec_multi"] = [mm.domdec_pack_batch(pack, d, lt,
                                                            slot)]
        flat, offs, ln = _stream(dsq, lens, dev)
        for name, make, build, word, call in (
                ("msv_filter_multi", ssv.msv_params, mm.build_msv_pack,
                 lambda p, n: p.tjb_for([n])[0], mm.msv_ssv_multi),
                ("vit_filter_multi", vit.vit_params, mm.build_vit_pack,
                 lambda p, n: p.move_for([n])[0], mm.vit_ints_multi)):
            if name not in entries:
                continue
            ps = [make(om, dev) for om in oms]
            w = _t(np.asarray([word(ps[g], int(n))
                               for g, n in zip(slot, lens)], np.int32), dev)
            out[name] = [call(build(ps), flat, offs, ln, w, slot)]
        return out
    return run


def _ubench(dev):
    """The five microbenchmark entries at [8, 32], 3 steps."""
    from . import ubench as ub
    x, = (a.to(dev) for a in ub.inputs("chain", 8, 32, 3))
    t, idx = (a.to(dev) for a in ub.inputs("onehot", 8, 32, 3, n=17))
    g, y = (a.to(dev) for a in ub.inputs("overlap", 8, 32, 3))
    return {"ub_chain": [ub.chain(x, 4, 3)],
            "ub_onehot_gather": [ub.onehot_gather(t, idx)],
            "ub_onehot_mma": [ub.onehot_mma(t, idx)],
            "ub_overlap": [ub.overlap(g, y, "both", 3)],
            "ub_scalars": [ub.scalars(x[:1].contiguous(), 3)]}


# the wider microbenchmark cases, UB_REPS steps: the tensor-core entry's
# KT = 5 and 17 instances over splits of 32 steps and the sum of their
# partial sums (UB_MMA_BT = 80: two tiles, the last of 16 columns); the
# gather's instance of 16 threads a column with its 17th group, a last
# warp of one column, a last chunk of 6 steps and indices outside
# [0, n) (UB_GATHER_BT = 37); #10 at a ragged width
UB_REPS = 70
UB_MMA_BT, UB_GATHER_BT, UB_SCALARS_BT = 80, 37, 37


def _ub_mma(n):
    def run(dev):
        from . import ubench as ub
        t, idx = (a.to(dev) for a in ub.inputs("onehot", ub.MT, UB_MMA_BT,
                                               UB_REPS, n=n, seed=n))
        return {"ub_onehot_mma": [ub.onehot_mma(t, idx)]}
    return run


def _ub_gather_out_of_range(dev):
    """On the CPU the plain version gets the same sum through
    ``ubench.onehot_in_range``."""
    import torch

    from . import ubench as ub
    t, idx = ub.inputs("onehot", ub.MT, UB_GATHER_BT, UB_REPS, n=257, seed=3)
    idx = ub.out_of_range(idx, 257)
    if torch.device(dev).type == "cpu":
        t, idx = ub.onehot_in_range(t, idx)
    return {"ub_onehot_gather": [ub.onehot_gather(t.to(dev), idx.to(dev))]}


def _ub_scalars(dev):
    from . import ubench as ub
    x, = (a.to(dev) for a in ub.inputs("scalars", 1, UB_SCALARS_BT, UB_REPS))
    return {"ub_scalars": [ub.scalars(x, UB_REPS)]}


def _rescore(M: int, lens, seed: int, budget=None):
    """The envelope fills of envelopes of <lens> residues under the case
    model of M (``fixtures.envelope_batch``), through the launches of
    <budget> bytes (``ops/rescore.py`` ``batch_plan``; None: the stage's
    own): the floats of every region whose fill did not fail, as int32,
    and the statuses."""
    def run(dev):
        import copy

        import numpy as np
        import torch

        from .fixtures import envelope_batch
        from .ops import rescore as rr
        om, q = case_model(M)
        om = copy.deepcopy(om)
        dsqs, xffs = envelope_batch(om, q, lens,
                                    np.random.default_rng(SEED + seed))
        fills = rr.rescore(rr.rescore_params(om, dev), dsqs, xffs,
                           budget or rr.RESCORE_BYTES)
        region = np.concatenate([f.region for f in fills
                                 if f.status == 0])
        return {"rescore": [(
            torch.from_numpy(region.view(np.int32)),
            torch.tensor([f.status for f in fills], dtype=torch.int32))]}
    return run


# the envelope fills' cases: lengths about each leaf size of the pairwise
# row sums, a batch cut by a budget of two envelopes of RESCORE_SPLIT[1]
# residues, and a model past a block's shared memory
RESCORE_LENS = (1, 7, 8, 9, 64, 129, 200)
RESCORE_SPLIT = (100, 120)
RESCORE_GLOBAL_M = 4000


def _step(dev):
    """The sharded gate step over two shares of <dev> (on the CPU the
    plain versions, share by share)."""
    import numpy as np
    import torch

    from .ops import fs3, fwd, ssv
    from .parallel import mesh
    om = case_model(100)[0]
    om3 = case_model(60, True)[0]
    rng = np.random.default_rng(SEED + 5)
    b, La, Ln = 4, 48, 150
    batch = (rng.integers(0, 20, (b, La)), np.full(b, La) - np.arange(b),
             rng.integers(0, 4, (b, Ln)), np.full(b, Ln) - 3 * np.arange(b),
             None)
    pm = ssv.msv_params(om, dev)
    batch = (*batch[:4], pm.tjb_for(batch[1]))
    step = mesh.make_pipeline_step([torch.device(dev)] * 2,
                                   fwd.fwd_params(om, dev), pm,
                                   fs3.fs3_params(om3, dev))
    return {"mesh_step": [step(*batch)]}


def cuda_cases() -> list:
    """The cases of the sanitized run, seeded; their models are made on
    first use (``case_model``)."""
    from . import ubench as ub
    dd, vit_m, fs_m = SEG_M["dd"], SEG_M["vit"], SEG_M["fs3"]
    cases = [
        Case("f32/one width", "single_plan (gate), _one_model_plan "
             "(decoding)", [100], ["fwd_parser", "domdec"],
             _f32(100, *_orfs(100, 6, 160, 1))),
        Case("f32/several warps", "one width of W > 1 warps", [1500],
             ["fwd_parser", "domdec"], _f32(1500, *_orfs(1500, 3, 80, 2))),
        Case("int/one width", "single_plan (MSV, SSV capture), "
             "_one_model_plan (ViterbiFilter)", [100],
             ["msv_filter", "ssv_capture", "vit_filter", "vit_capture"],
             _ints(100, *_orfs(100, 8, 160, 3),
                   ("msv_filter", "ssv_capture", "vit_filter",
                    "vit_capture"))),
        Case("fs3/direct", "one width, direct loads (P <= FS3_DIRECT_P)",
             [60], ["fs3_parser", "fs3_domdec"],
             _fs3(60, *_windows(60, 7, 300, 4))),
        Case("fs3/ring", "one width, the emission ring", [200],
             ["fs3_parser", "fs3_domdec"], _fs3(200, *_windows(200, 7, 400,
                                                              5))),
        Case("multi/f32 widths", "several models and widths in one launch",
             [40, 100, 300, 700], ["fwd_parser_multi", "domdec_multi"],
             _mixed([40, 100, 300, 700], 2, 120, 6,
                    ("fwd_parser_multi", "domdec_multi"))),
        Case("multi/fs3 widths", "several models and widths in one "
             "launch, the ring", [40, 150, 400],
             ["fs3_parser_multi", "fs3_domdec_multi"],
             _mixed([40, 150, 400], 2, 300, 7,
                    ("fs3_parser_multi", "fs3_domdec_multi"))),
        Case("multi/int widths", "several models and widths in one launch",
             [40, 100, 300, 700], ["msv_filter_multi", "vit_filter_multi"],
             _mixed([40, 100, 300, 700], 3, 120, 8,
                    ("msv_filter_multi", "vit_filter_multi"))),
        Case("multi/one model of a pack", "_one_model_plan",
             [40, 100, 300, 700],
             ["fwd_parser_multi", "domdec_multi", "msv_filter_multi",
              "vit_filter_multi"],
             _mixed([40, 100, 300, 700], 2, 120, 9,
                    ("fwd_parser_multi", "domdec_multi", "msv_filter_multi",
                     "vit_filter_multi"), one=2)),
        Case("multi/fs3 one model of a pack", "_one_model_plan, the ring",
             [40, 150, 400], ["fs3_parser_multi", "fs3_domdec_multi"],
             _mixed([40, 150, 400], 2, 300, 10,
                    ("fs3_parser_multi", "fs3_domdec_multi"), one=2)),
        Case(f"segmented/gate, decoding M={dd}", "segmented class "
             "(_one_model_plan, scratch)", [dd], ["fwd_parser", "domdec"],
             _f32(dd, *_orfs(dd, 3, 40, 11)),
             segmented=("fwd_parser", "domdec")),
        Case(f"segmented/int M={dd}", "segmented class (scratch)", [dd],
             ["msv_filter", "ssv_capture"],
             _ints(dd, *_orfs(dd, 3, 40, 12), ("msv_filter", "ssv_capture")),
             segmented=("msv_filter", "ssv_capture")),
        Case(f"segmented/ViterbiFilter M={vit_m}", "segmented class "
             "(scratch)", [vit_m], ["vit_filter", "vit_capture"],
             _ints(vit_m, *_orfs(vit_m, 3, 40, 13),
                   ("vit_filter", "vit_capture")),
             segmented=("vit_filter", "vit_capture")),
        Case(f"segmented/fs3 M={fs_m}", "segmented class (scratch), the "
             "direct loads", [fs_m], ["fs3_parser", "fs3_domdec"],
             _fs3(fs_m, *_windows(fs_m, 3, 90, 14)),
             segmented=("fs3_parser", "fs3_domdec")),
        Case(f"segmented/multi M={dd} beside 100", "a segmented class "
             "beside a narrow one in one launch", [dd, 100],
             ["fwd_parser_multi", "domdec_multi", "msv_filter_multi",
              "vit_filter_multi"],
             _mixed([dd, 100], 2, 40, 15,
                    ("fwd_parser_multi", "domdec_multi", "msv_filter_multi",
                     "vit_filter_multi")),
             segmented=("fwd_parser_multi", "domdec_multi",
                        "msv_filter_multi", "vit_filter_multi")),
        Case(f"segmented/fs3 multi M={fs_m} beside 60", "a segmented class "
             "beside a narrow one in one launch", [fs_m, 60],
             ["fs3_parser_multi", "fs3_domdec_multi"],
             _mixed([fs_m, 60], 2, 90, 16,
                    ("fs3_parser_multi", "fs3_domdec_multi")),
             segmented=("fs3_parser_multi", "fs3_domdec_multi")),
        Case("ubench", "[8, 32], 3 steps", [],
             ["ub_chain", "ub_onehot_gather", "ub_onehot_mma", "ub_overlap",
              "ub_scalars"], _ubench),
        *(Case(f"ubench/mma n={n} splits", f"[136, {UB_MMA_BT}], "
               f"{UB_REPS} steps over splits of 32 (KT = "
               f"{ub.onehot_kt(n)})", [], ["ub_onehot_mma"], _ub_mma(n),
               reps=UB_REPS) for n in (65, 257)),
        Case("ubench/gather out of range", f"[136, {UB_GATHER_BT}], n=257, "
             f"{UB_REPS} steps, indices -1 and n", [], ["ub_onehot_gather"],
             _ub_gather_out_of_range, reps=UB_REPS),
        Case("ubench/scalars ragged", f"Bt={UB_SCALARS_BT}, {UB_REPS} steps",
             [], ["ub_scalars"], _ub_scalars, reps=UB_REPS),
        Case("mesh/two shares", "the step over two shares of one device",
             [100, 60], ["mesh_step"], _step),
        Case("rescore/one launch", "one block an envelope, the transitions "
             "and working vectors in shared memory", [100], ["rescore"],
             _rescore(100, RESCORE_LENS, 17)),
        Case("rescore/budget", "a batch cut into launches by the byte "
             "budget", [RESCORE_SPLIT[0]], ["rescore"],
             _rescore(RESCORE_SPLIT[0], [RESCORE_SPLIT[1]] * 5, 18,
                      rescore_split_budget())),
        Case(f"rescore/M={RESCORE_GLOBAL_M}", "the transitions and working "
             "vectors in global memory (past a block's shared memory)",
             [RESCORE_GLOBAL_M], ["rescore"],
             _rescore(RESCORE_GLOBAL_M, (1, 9, 40), 19)),
    ]
    return cases


def rescore_split_budget() -> int:
    """The budget of the rescore/budget case: two envelopes' outputs."""
    from .ops.rescore import region_floats
    return 2 * 4 * region_floats(RESCORE_SPLIT[1], RESCORE_SPLIT[0])


def _err(got, want) -> float:
    import torch
    if got.numel() == 0:
        return 0.0
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)):
        return float("inf")
    if not fin.any():
        return 0.0
    return float((got[fin].double() - want[fin].double()).abs().max())


def hold(entry: str, got, want, reps: int = 3) -> float:
    """max |got - want| of one call's outputs, or CaseMismatch where they
    differ past the entry's band (``KIND``; the tensor-core entry's on
    <reps> steps)."""
    import torch

    from . import ubench as ub
    got = tuple(got) if isinstance(got, (tuple, list)) else (got,)
    want = tuple(want) if isinstance(want, (tuple, list)) else (want,)
    got = tuple(g.cpu() for g in got)
    want = tuple(w.cpu() for w in want)
    kind = KIND[entry]
    if kind == "exact":
        err = max(_err(g, w) for g, w in zip(got, want))
        ok = all(torch.equal(g, w) for g, w in zip(got, want))
    elif kind == "gate":
        err = _err(got[0], want[0])
        ok = err <= FWD_TOL
    elif kind == "decoding":
        err = max(_err(g, w) for g, w in zip(got[:3], want[:3]))
        ok = err <= DOMDEC_TOL and torch.equal(got[3], want[3])
    elif kind == "step":
        # (fwd, msv, fs3, counters): the gates in their band, MSV and the
        # counters exact
        err = max(_err(got[0], want[0]), _err(got[2], want[2]))
        ok = err <= FWD_TOL and torch.equal(got[1], want[1]) \
            and torch.equal(got[3], want[3])
    else:
        err = _err(got[0], want[0])
        tol = ub.onehot_mma_tol(want[0], reps) \
            if entry == "ub_onehot_mma" \
            else UB_TOL[entry]
        ok = bool(torch.isfinite(got[0]).all()) and err <= tol
    if not ok:
        raise CaseMismatch(f"{entry}: max |d| {err} against the plain "
                           f"version ({kind})")
    return err


def run_case(case: Case, device) -> dict:
    """<case> on <device> against its plain version on the CPU: {entry:
    the largest error of its calls}; raises CaseMismatch."""
    got, want = case.run(device), case.run("cpu")
    errs = {}
    for entry in case.entries:
        if len(got.get(entry, ())) != len(want.get(entry, ())) \
                or not got.get(entry):
            raise CaseMismatch(f"{case.name}: {entry} was not called")
        errs[entry] = max(hold(entry, g, w, case.reps)
                          for g, w in zip(got[entry], want[entry]))
    return errs


# ---------------------------------------------------------------------
# cuda: the cases under compute-sanitizer
# ---------------------------------------------------------------------
TOOLS = ("memcheck", "racecheck", "synccheck", "initcheck")
CANARY = {"memcheck": 0, "racecheck": 1, "initcheck": 2, "synccheck": 3}
CANARY_SRC = Path(__file__).resolve().parent / "ops" / "kernels" / \
    "canary" / "canary.cu"
ERROR_EXIT = 86             # the tool's exit code where it reported
# the tool's own answer where it cannot attach to the card: the one
# outcome of a canary run, besides a missing tool, that makes the tool
# unavailable (nothing checked) rather than a failure
CANNOT_ATTACH = ("Device not supported",)
TOOL_LIMIT_S = 900          # each child under a tool, by default
# the tool's own summary line: memcheck, initcheck and synccheck count
# errors, racecheck hazards (errors and warnings)
SUMMARY = re.compile(r"========= (ERROR SUMMARY: (\d+) errors?|RACECHECK "
                     r"SUMMARY: (\d+) hazards? displayed \((\d+) errors?, "
                     r"(\d+) warnings?\))")


def kernel_names() -> list:
    """The __global__ kernels of the port's sources (``csrc/*.cu``) and
    of the canary: what the tools' filter instruments."""
    from .ops.kernels import loader
    names = set()
    for src in [*loader.sources(), CANARY_SRC]:
        for chunk in src.read_text().split("__global__")[1:]:
            m = re.search(r"\b(\w+_kernel)\s*\(", chunk)
            if m:
                names.add(m.group(1))
    return sorted(names)


def sanitizer() -> str | None:
    """compute-sanitizer of the CUDA toolkit ($CUDA_HOME or
    /usr/local/cuda), or on PATH."""
    import shutil
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "compute-sanitizer")
    return cand if os.path.exists(cand) else shutil.which("compute-sanitizer")


def canary_library() -> Path:
    """The canaries' library, built beside the kernels' with their nvcc
    flags (``loader.NVCC_FLAGS``)."""
    from .ops.kernels import loader
    h = hashlib.sha256(CANARY_SRC.read_bytes())
    h.update(" ".join(loader.NVCC_FLAGS).encode())
    so = BUILD / f"libbt_canary_{h.hexdigest()[:16]}.so"
    return _built(so, [loader._nvcc(), *loader.NVCC_FLAGS, "-shared",
                       str(CANARY_SRC)], "the canaries' library")


def tool_command(tool: str) -> list:
    """compute-sanitizer with <tool>, an exit code of its own where it
    reports, and a filter of every kernel of ``kernel_names`` (a
    substring of the mangled name, so every instance of a template)."""
    cmd = [sanitizer(), "--tool", tool, "--error-exitcode", str(ERROR_EXIT)]
    for name in kernel_names():
        cmd += ["--kernel-name", f"kns={name}"]
    if tool == "racecheck":
        cmd += ["--racecheck-report", "all"]
    return cmd


def parse_tool(text: str) -> dict:
    """What a tool printed: its count of errors (racecheck's errors and
    warnings), the kernels its reports name, and its own error where it
    could not check (its ``========= Error:`` lines but racecheck's
    reports)."""
    errors = None
    for m in SUMMARY.finditer(text):
        errors = int(m.group(2)) if m.group(2) is not None \
            else int(m.group(4)) + int(m.group(5))
    summary = [m.group(1) for m in SUMMARY.finditer(text)]
    tool_errors = [ln.split("Error:", 1)[1].strip()
                   for ln in text.splitlines()
                   if ln.startswith("========= Error:")
                   and "Race reported" not in ln]
    named = sorted(set(re.findall(r"\b(\w+_kernel)\b", " ".join(
        ln for ln in text.splitlines() if ln.startswith("=========")))))
    return {"errors": errors, "summary": summary[-1] if summary else None,
            "tool_errors": tool_errors, "kernels_named": named}


CASES_CODE = ("import sys; from bath_tpu_torch.sanitize import cases_main; "
              "sys.exit(cases_main())")
CANARY_RUN = ("import ctypes, sys; print('canary returned', "
              "ctypes.CDLL(sys.argv[1]).bt_canary(int(sys.argv[2])))")


def _under(cmd: list, env=None, limit_s: float = TOOL_LIMIT_S) -> tuple:
    """(exit code, stdout + stderr, seconds) of <cmd> in a session of its
    own.  Past <limit_s> the whole session is killed (the tool and the
    program it runs) and the code is None, the output saying so."""
    t = time.perf_counter()
    p = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, cwd=ROOT, env=env, start_new_session=True)
    try:
        out, err = p.communicate(timeout=limit_s)
        rc = p.returncode
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, err = p.communicate()
        rc, err = None, err + f"\ntimed out after {limit_s} s\n"
    return rc, out + err, time.perf_counter() - t


def run_tool(tool: str, limit_s: float = TOOL_LIMIT_S) -> dict:
    """<tool> over the canary, then (once it reported the canary) over
    the cases in a child process on the card, each run killed past
    <limit_s> (a fault).  ``available`` is false,
    with the tool's own error, where there is no tool or it answers that
    it cannot attach to the card (``CANNOT_ATTACH``); then nothing is
    checked.  Any other canary run that did not report the canary is a
    fault: ``available`` true, nothing clean."""
    res = {"tool": tool, "available": False, "canary_caught": False,
           "checked": False}
    if sanitizer() is None:
        res["error"] = "compute-sanitizer not found ($CUDA_HOME/bin, PATH)"
        return res
    so = canary_library()
    rc, text, sec = _under([*tool_command(tool), sys.executable, "-c",
                            CANARY_RUN, str(so), str(CANARY[tool])],
                           limit_s=limit_s)
    got = parse_tool(text)
    res.update(canary_rc=rc, canary_s=sec, canary_summary=got["summary"])
    res["canary_caught"] = rc == ERROR_EXIT and bool(got["errors"]) \
        and any(k.startswith("canary_") for k in got["kernels_named"])
    if not res["canary_caught"]:
        # the tool could not attach (unavailable: nothing checked), or
        # any other miss: a tool that ran and did not report its canary,
        # or failed for another reason (a fault of the phase)
        attach = any(e.startswith(CANNOT_ATTACH) for e in got["tool_errors"])
        res["available"] = not attach
        res["error"] = "; ".join(got["tool_errors"]) if attach else (
            f"the {tool} canary was not reported (rc {rc}): "
            f"{'; '.join(got['tool_errors']) or text[-2000:]}")
        return res
    res["available"] = True
    env = dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1")
    rc, text, sec = _under([*tool_command(tool), sys.executable, "-c",
                            CASES_CODE], env, limit_s=limit_s)
    got = parse_tool(text)
    report = _last_json(text)
    res.update(checked=True, rc=rc, seconds=sec, errors=got["errors"],
               summary=got["summary"], kernels_named=got["kernels_named"],
               cases=report.get("cases"), entries=report.get("entries"),
               held=report.get("held"))
    res["clean"] = rc == 0 and got["errors"] == 0 and bool(report.get("held"))
    if not res["clean"]:
        res["report"] = "\n".join(ln for ln in text.splitlines()
                                  if ln.startswith("=========")
                                  or "CaseMismatch" in ln
                                  or ln.startswith("timed out"))[-6000:]
    return res


def run_untooled() -> dict:
    """The cases in a child process on the card with no tool: their
    outputs against the plain versions only (what checks the case list
    on a card where no tool can attach); nothing is sanitized."""
    rc, text, sec = _under([sys.executable, "-c", CASES_CODE])
    report = _last_json(text)
    return {"tool": "none", "rc": rc, "seconds": sec,
            "cases": report.get("cases"), "entries": report.get("entries"),
            "held": report.get("held"), "clean": rc == 0 and bool(
                report.get("held")),
            **({} if rc == 0 else {"report": text[-4000:]})}


def cases_main() -> int:
    """The child of a tool: every case on the card against the plain
    versions; prints a line a case and, last, {cases, entries, held} as
    JSON."""
    done, entries, held = [], set(), True
    for case in cuda_cases():
        t = time.perf_counter()
        try:
            errs = run_case(case, "cuda")
        except CaseMismatch as e:
            held = False
            print(f"CaseMismatch in {case.name}: {e}", flush=True)
            continue
        done.append(case.name)
        entries.update(errs)
        print(f"case {case.name}: {case.plan}; M={list(case.Ms)}; "
              f"max |d| {errs}; {time.perf_counter() - t:.1f}s", flush=True)
    print(json.dumps({"cases": done, "entries": sorted(entries),
                      "held": held}), flush=True)
    return 0 if held else 1


def main_cuda(argv) -> int:
    ap = argparse.ArgumentParser(prog="python -m bath_tpu_torch.sanitize "
                                 "cuda")
    ap.add_argument("--tools", default="memcheck",
                    help=f"comma list of {', '.join(TOOLS)}, or all; none "
                    "runs the cases with no tool (their parity alone)")
    args = ap.parse_args(argv)
    tools = TOOLS if args.tools == "all" else tuple(args.tools.split(","))
    from .ops.kernels import loader
    loader.build()
    bad = unavailable = False
    for tool in tools:
        r = run_untooled() if tool == "none" else run_tool(tool)
        print("[sanitize] cuda " + " ".join(
            f"{k}={json.dumps(v) if isinstance(v, (list, dict)) else v}"
            for k, v in r.items() if k != "report"), flush=True)
        if r.get("report"):
            print(r["report"], flush=True)
        if r.get("available", True):
            bad |= not r.get("clean", False)
        else:
            unavailable = True
    # 1: a fault (a report, a missed canary, a case off its plain
    # version); 3: a tool could not check here, so nothing was checked
    return 1 if bad else 3 if unavailable else 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["native"]:
        rest = argv[1:]
        return main_native(rest[1:] if rest[:1] == ["--"] else rest)
    if argv[:1] == ["cuda"]:
        return main_cuda(argv[1:])
    ap = argparse.ArgumentParser(prog="python -m bath_tpu_torch.sanitize",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("half", choices=["native", "cuda"])
    ap.parse_args(argv[:1])
    return 2


if __name__ == "__main__":
    sys.exit(main())
