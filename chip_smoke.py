"""Smoke test of bath_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of the standard, the ``--fs`` and the
all-device bathsearch paths from ``bath_tpu_torch/ops/kernels/csrc/``,
holds each against its plain PyTorch version on the card (the integer
filters exactly, and MSV also against the native host library over
every ORF of the search genome), times both and the host library's
batch, then searches a seeded 5 Mb genome with a seeded M = 400 profile
through the port's CLI: the standard search, then ``--fs`` and
``--fsonly`` on the genome's frameshift twin (16 of its 40 embeds carry
a 1-nt deletion or insertion), then the all-device cascade
(``BATH_MSV_DEVICE=1 BATH_VIT_DEVICE=1``: MSV/SSV, the ViterbiFilter
and their window captures on the card too), standard and ``--fs``.
It checks that the output is byte-identical to the host path
(``bath_tpu --backend numpy``), that the embedded homologs and the
frameshifts are found, and that each search went through its
kernels.  Every phase prints one line; any failure exits non-zero.  The
last two lines are the kernels' JSON record and ``{"ok": true,
"device": ...}``.

Needs a CUDA device, nvcc (``$CUDA_HOME`` or ``/usr/local/cuda``) and
g++ (the host library of the integer filters).  Everything it builds or
writes goes under ``build/`` next to this file.
"""

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
PARITY_FS3 = (64, 6000)
PARITY_FS3DD = (16, 6000)
FS3_WIDE_M = 1500           # several warps per window
TIME_FS3_M = (134, 409, 781, 1000, 2048)
TIME_FS3_B, TIME_FS3DD_B = 256, 32
N_FRAMESHIFT = 16
MIN_FS_FOUND = 12
# the integer filters: parity cases (genome ORFs besides the hot, short
# and empty ones) at M_SEARCH, with one ORF of LONG_ORF residues, and at
# INT_WIDE_M; capture thresholds (bytes, words) crossed by the hot ORFs
# only, then P = 1 (every row crosses)
PARITY_INT_N = 512
LONG_ORF = 16_500
INT_WIDE_M = 1500
SSV_THR, VIT_THR, P1_THR = 180, 16_000, -(1 << 30)
TIME_INT_B = 4096           # ORFs of the Viterbi set and the captures
F1, F2 = 0.02, 1e-3         # bathsearch's default filter thresholds
# the all-device cascade also runs with looser F1/F2, so that ORFs take
# the Viterbi path and pass it (the Viterbi capture's input)
LOOSE = ["--F1", "0.1", "--F2", "0.05"]
ALL_DEVICE = {"BATH_MSV_DEVICE": "1", "BATH_VIT_DEVICE": "1"}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(tag: str, **kv) -> None:
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


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
    # the host library of the integer filters builds into build/
    os.environ["XDG_CACHE_HOME"] = str(BUILD / "cache")
    sys.path.insert(0, str(ROOT))
    from bath_tpu_torch import fixtures
    from bath_tpu_torch.cli import bathsearch
    from bath_tpu_torch.ops import domdec as dd
    from bath_tpu_torch.ops import fs3
    from bath_tpu_torch.ops import fs3_domdec as fdd
    from bath_tpu_torch.ops import fwd
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
    # 0, 2, 3, 4 and up to 6000 nt with homologs (one in three
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
    from bath_tpu.hmmfile import read_hmm
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
    from bath_tpu.native import msv_filter_native_batch
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

    # 4. timing at the main path's shapes (ORFs of the search genome)
    times = {}
    for M in TIME_FWD_M:
        hm, _ = fixtures.make_query(M, np.random.default_rng(M),
                                    calibrate=False)
        pm = fwd.fwd_params(fixtures.search_profile(hm), dev)
        ln, d, lt = one_batch(fixtures.sample_orfs(fx.fasta_path, TIME_FWD_B,
                                                   SEED), dev)
        k_ms = cuda_ms(lambda: fwd.fwd_score(d, lt, pm), 20)
        p_ms = cuda_ms(lambda: fwd.fwd_score_ref(d, lt, pm), 2)
        cells = float(ln.sum()) * M
        times[("fwd", M)] = (k_ms, p_ms)
        phase("timing", kernel="fwd_parser", M=M, B=TIME_FWD_B,
              mean_L=f"{ln.mean():.1f}", max_L=int(ln.max()),
              ms=f"{k_ms:.4f}", plain_ms=f"{p_ms:.2f}",
              gcups=f"{cells / k_ms / 1e6:.2f}",
              plain_gcups=f"{cells / p_ms / 1e6:.3f}")
    ln, d, lt = one_batch(fixtures.sample_orfs(fx.fasta_path, TIME_DOMDEC_B,
                                               SEED, min_len=100), dev)
    k_ms = cuda_ms(lambda: dd.domdec(d, lt, p400), 10)
    p_ms = cuda_ms(lambda: dd.domdec_ref(d, lt, p400), 1)
    times["domdec"] = (k_ms, p_ms)
    cells = float(ln.sum()) * M_SEARCH
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
        p_ms = cuda_ms(lambda: fs3.fs3_score_ref(d, lt, pm), 1)
        cells = float(ln.sum()) * M
        times[("fs3", M)] = (k_ms, p_ms)
        phase("timing", kernel="fs3_parser", M=M, B=TIME_FS3_B, L=wlen,
              layout=loader.fs3_layout(M), ms=f"{k_ms:.4f}",
              plain_ms=f"{p_ms:.2f}", us_per_row=f"{1e3 * k_ms / wlen:.3f}",
              gcups=f"{cells / k_ms / 1e6:.2f}",
              plain_gcups=f"{cells / p_ms / 1e6:.3f}")
        if M == TIME_FS3_M[1]:
            pdd, ddd, ldd, wdd = pm, d[:TIME_FS3DD_B], lt[:TIME_FS3DD_B], wlen
    k_ms = cuda_ms(lambda: fdd.fs3_domdec(ddd, ldd, pdd, 100.0 / 103.0), 3)
    p_ms = cuda_ms(lambda: fdd.fs3_domdec_ref(ddd, ldd, pdd, 100.0 / 103.0),
                   1)
    times["fs3_domdec"] = (k_ms, p_ms)
    phase("timing", kernel="fs3_domdec", M=TIME_FS3_M[1], B=TIME_FS3DD_B,
          L=wdd, ms=f"{k_ms:.4f}", plain_ms=f"{p_ms:.2f}",
          gcups=f"{TIME_FS3DD_B * wdd * TIME_FS3_M[1] / k_ms / 1e6:.2f}")

    # 4c. the integer filters: MSV over one flush of the search genome's
    # ORFs (the flat stream flush_gates hands over), the ViterbiFilter
    # and both captures over TIME_INT_B of them, at the default F1/F2
    # thresholds on the null scores; beside each kernel its plain version
    # and, for MSV and Viterbi, the native host library's OpenMP batch
    # on the same ORFs in the flat layout its ORF extractor hands over
    from bath_tpu.bg import Background
    from bath_tpu.gencode import OrfList
    from bath_tpu.native import vit_filter_score_batch
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
    p_ms = cuda_ms(lambda: ssv.msv_ssv_ref(*fa), 1)
    held("msv_filter", ssv.msv_ssv(*fa), ssv.msv_ssv_ref(*fa), M_SEARCH)
    h_ms = host_ms(lambda: msv_filter_native_batch(f_host, om))
    cells = float(f_lens.sum()) * M_SEARCH
    times["msv_filter"] = (k_ms, p_ms)
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
        p_ms = cuda_ms(p_fn, 1)
        h_ms = host_ms(host) if host else None
        times[name] = (k_ms, p_ms)
        out = held(name, k_fn(), p_fn(), M_SEARCH)
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

    # 5. end to end: the port's CLI against the host path, in turns
    # (numpy, torch, torch, numpy); --backend numpy runs
    # bath_tpu.cli.bathsearch.run as it is.  The first torch run is the
    # one whose kernel launches are counted.
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

    # 6. the record
    kernels = [
        {"name": "fwd_parser", "route": "cuda",
         "source": "bath_tpu_torch/ops/kernels/csrc/fwd_parser.cu",
         "replaces": "bath_tpu/ops/pallas/fwd.py:32",
         "launches": launches["fwd_parser"], "max_abs_err": fwd_err,
         "ms": times[("fwd", TIME_FWD_M[0])][0],
         "plain_ms": times[("fwd", TIME_FWD_M[0])][1]},
        {"name": "domdec", "route": "cuda",
         "source": "bath_tpu_torch/ops/kernels/csrc/domdec.cu",
         "replaces": "bath_tpu/ops/jaxk/kernels.py:988",
         "launches": launches["domdec"], "max_abs_err": dd_err,
         "ms": times["domdec"][0], "plain_ms": times["domdec"][1]},
        {"name": "fs3_parser", "route": "cuda",
         "source": "bath_tpu_torch/ops/kernels/csrc/fs3_parser.cu",
         "replaces": "bath_tpu/ops/pallas/fs3.py:69",
         "launches": fs_launches["fs3_parser"], "max_abs_err": fs3_err,
         "ms": times[("fs3", TIME_FS3_M[1])][0],
         "plain_ms": times[("fs3", TIME_FS3_M[1])][1]},
        {"name": "fs3_domdec", "route": "cuda",
         "source": "bath_tpu_torch/ops/kernels/csrc/fs3_domdec.cu",
         "replaces": "bath_tpu/ops/jaxk/kernels.py:1235",
         "launches": fs_launches["fs3_domdec"], "max_abs_err": fs3dd_err,
         "ms": times["fs3_domdec"][0], "plain_ms": times["fs3_domdec"][1]},
    ]
    for name, src, replaces in (
            ("msv_filter", "msv_filter.cu", "bath_tpu/ops/pallas/ssv.py:30"),
            ("ssv_capture", "ssv_capture.cu",
             "bath_tpu/ops/jaxk/filters_mb.py:623"),
            ("vit_filter", "vit_filter.cu", "bath_tpu/ops/pallas/vit.py:64"),
            ("vit_capture", "vit_filter.cu",
             "bath_tpu/ops/jaxk/filters_mb.py:304")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"bath_tpu_torch/ops/kernels/csrc/{src}",
            "replaces": replaces, "launches": int_launches[name],
            "max_abs_err": int_err[name], "ms": times[name][0],
            "plain_ms": times[name][1]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
