"""Kernel-only times of the Forward-gate and MSV entries of
bath_tpu_torch on one NVIDIA GPU, for an A/B of two checkouts on one
card.

    python3 scripts/torch_fwd_msv_ab.py [--tree DIR] [--tag NAME]
                                        [--out FILE] [--vs TAG] [--sweep]
                                        [--build]

Times, at ``chip_smoke.py``'s timing shapes, the Forward gate (#1:
M = 400, 4096 genome ORFs), MSV (#2: M = 400, one flush of 65 536 genome
ORFs), the multi-model Forward gate (J3a: 1600 genome ORFs over the 48
models of M = 60..1200), the multi-model MSV of the device calibration
(J4a: the 48 models, each over the one batch of 200 x 200 aa) and the
calibration's Forward gate (J4c: the 48 models, each over 200 sequences
of 100 aa), each as the kernel's own launches (the batch checked and
planned beforehand by ``loader.prepare_fwd``/``prepare_msv``) and
through its wrapper, with ``ubench.cuda_ms``.  ``--tree`` names the checkout whose
``bath_tpu_torch`` and ``chip_smoke.py`` make the batches and run
(default: this one), so the same command times a parent commit unpacked
beside this one: run parent, change, change, parent in one call.  The
genome fixture is shared through ``build/ab_fixtures/`` of this
checkout.

Prints one JSON line: per entry ms (kernel only), wrapper_ms,
launches_per_call and a digest of the wrapper's output bytes; with
``--out`` also appends it there.  Each run keeps its wrappers' outputs
under ``build/ab_out/<tag>/``; ``--vs TAG`` also gives, per entry, the
largest difference from the outputs run TAG kept (absolute, and
relative to the larger magnitude) and the count of elements that
differ.  ``--build`` adds ``bathbuild --backend torch`` of the
``build`` phase's 48-alignment Stockholm file: its wall, its device
calibration's stage seconds (``cal_*``) and a digest of the file
without its DATE lines.  ``--sweep`` (a tree with the one-launch
Forward gate) adds, each choice forced for the measurement by setting
the module constant the plans read (``loader.fwd_layout``,
``multimodel.FWD_WIDE_STAGE``, ``multimodel.FS3_DIRECT_P``):
- the Forward gate under three lane ladders (one warp up to 33 lanes,
  W warps of 33 beyond; one warp up to 17, W warps of 17 beyond 544;
  one warp up to 33, W warps of 17 beyond 1056: the kernel's) on J3a,
  on J4c and on the 4096 ORFs under one model at M = 400, 700, 1000,
  1100 and 1500 (a pack of that one model); J4a under the same ladders;
- J3a with its widest class (Mp 1632 under the kept ladder) reading its
  odds from L2 with its transitions staged, or neither;
- the fs3 pair's emission rows fetched a row ahead into shared memory
  (the ring) against every thread reading them from global memory (the
  direct loads), each forced, at M = 60 (P = 3), 134 (P = 5) and 409
  (P = 13), the gate on 256 windows of 2 * max_length * 3 nt, decoding
  on 32 of them: ms and microseconds a row.
"""

import argparse
import contextlib
import functools
import hashlib
import io
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ENTRIES = ("fwd_parser", "msv_filter", "fwd_parser_multi",
           "msv_filter_multi", "fwd_parser_cal")
REPS = {"fwd_parser": 20, "msv_filter": 20, "fwd_parser_multi": 10,
        "msv_filter_multi": 10, "fwd_parser_cal": 10}
SWEEP_FWD_MS = (400, 700, 1000, 1100, 1500)
SWEEP_FS3_MS = (60, 134, 409)
LADDERS = {"p33": (3, 5, 9, 13, 17, 25, 33), "p17": (3, 5, 9, 13, 17),
           "mixed": None}


@contextlib.contextmanager
def setting(module, name, value):
    """<module>.<name> = <value> while the block runs (the plans read
    these module constants at every call)."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def as_tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def differs(got, want) -> dict:
    """Largest absolute and relative difference and differing count of
    two runs' outputs (infinities equal where both are)."""
    import torch
    ab = rel = 0.0
    n = 0
    for g, w in zip(got, want):
        g, w = g.double().cpu(), w.double().cpu()
        same = (g == w) | (torch.isnan(g) & torch.isnan(w))
        n += int((~same).sum())
        fin = torch.isfinite(g) & torch.isfinite(w) & ~same
        if fin.any():
            d = (g - w)[fin].abs()
            ab = max(ab, float(d.max()))
            rel = max(rel, float((d / torch.maximum(g[fin].abs(),
                                                    w[fin].abs())).max()))
    return {"max_abs": ab, "max_rel": rel, "n_differ": n}


def make_batches(cs, fx):
    """The five timing batches, {entry: (kind, args, slots or None,
    params or pack)}."""
    import numpy as np
    import torch
    from bath_tpu_torch import evalues_device as ed
    from bath_tpu_torch import fixtures
    from bath_tpu_torch.bg import Background
    from bath_tpu_torch.cli.bathsearch import CHUNK_ORFS
    from bath_tpu_torch.evalues import CalibrateConfig
    from bath_tpu_torch.ops import fwd, ssv
    from bath_tpu_torch.ops import multimodel as mm
    from bath_tpu_torch.oprofile import oprofile_convert
    from bath_tpu_torch.profile import profile_config
    run = cs.Run(("timing",))
    run.cache["fx"] = fx
    out = {}
    hm, _ = fixtures.make_query(cs.M_SEARCH,
                                np.random.default_rng(cs.M_SEARCH),
                                calibrate=False)
    p400 = fwd.fwd_params(fixtures.search_profile(hm), cs.DEV)
    _, d, lt = cs.one_batch(fixtures.sample_orfs(fx.fasta_path,
                                                 cs.TIME_FWD_B, cs.SEED))
    out["fwd_parser"] = ("fwd", (d, lt), None, p400)
    cas, all_orfs = cs.cascade(run)
    f_orfs = all_orfs[:CHUNK_ORFS]
    flat, offs, lens = (torch.from_numpy(a).to(cs.DEV)
                        for a in ssv.pack_stream(f_orfs))
    tjb = cs.ints(cas.msv.tjb_for(lens.cpu().numpy()))
    out["msv_filter"] = ("msv", (flat, offs, lens, tjb), None, cas.msv)
    m = cs.mq_models(run)
    items = fixtures.sample_orfs(fx.fasta_path, cs.TIME_MQ_FWD_B, cs.SEED)
    sl = m["rng"].integers(0, len(cs.MQ_MS), cs.TIME_MQ_FWD_B)
    _, md, ml = cs.one_batch(items, pad=28)
    order = np.argsort([len(o) for o in items], kind="stable")
    out["fwd_parser_multi"] = ("fwd", (md, ml), np.asarray(sl)[order],
                               m["std_pack"])
    ccfg = CalibrateConfig(fs=True)
    draws = ed.shared_draws(ccfg, Background())
    cal_oms = [oprofile_convert(profile_config(h, Background(), L=ccfg.EvL))
               for h in m["hmms"]]
    params = [ssv.msv_params(om, cs.DEV) for om in cal_oms]
    N, L = draws.msv.shape
    cflat, coffs, clens, slot = ed.shared_stream(draws.msv, len(cal_oms),
                                                 cs.DEV)
    word = ed.per_model_words([p.tjb_for([L])[0] for p in params], N,
                              cs.DEV)
    out["msv_filter_multi"] = ("msv", (cflat, coffs, clens, word), slot,
                               mm.build_msv_pack(params))
    # J4c: the calibration's Forward gate, each of 200 sequences of EfL
    # aa under every model
    G = len(cal_oms)
    fdsq = torch.from_numpy(np.ascontiguousarray(draws.fwd, np.int8)) \
        .to(cs.DEV).repeat(G, 1)
    flens = torch.full((fdsq.shape[0],), ccfg.EfL, dtype=torch.int32,
                       device=cs.DEV)
    fslot = np.repeat(np.arange(G), draws.fwd.shape[0])
    out["fwd_parser_cal"] = ("fwd", (fdsq, flens), fslot, mm.build_fwd_pack(
        [fwd.fwd_params(om, cs.DEV) for om in cal_oms]))
    return out


def kernel_call(loader, kind, args, slot, pk):
    """(launch-only callable, launches a call) of an entry, nj = 1."""
    if kind == "fwd":
        run = loader.prepare_fwd(*args, slot, pk)
        return (lambda: run(1.0)), run.launches
    run = loader.prepare_msv(*args, slot, pk)
    return run, run.launches


def wrapper(name, args, slot, pk):
    """The entry's public call, checks and plan included."""
    from bath_tpu_torch.ops import fwd, ssv
    from bath_tpu_torch.ops import multimodel as mm
    return {"fwd_parser": lambda: fwd.fwd_score(*args, pk),
            "msv_filter": lambda: ssv.msv_ssv(*args, pk),
            "fwd_parser_multi": lambda: mm.fwd_pack_scores(pk, *args, slot),
            "msv_filter_multi": lambda: mm.msv_ssv_multi(pk, *args, slot),
            "fwd_parser_cal": lambda: mm.fwd_pack_scores(pk, *args, slot)
            }[name]


def ladder(loader, lanes):
    """A lane ladder's layout: <lanes> in one warp and W warps of the
    last beyond, or (None) the kept one (``loader.fwd_layout``: one
    warp up to 33 lanes and W warps of 17 beyond 1056)."""
    if lanes is None:
        return loader.fwd_layout
    return functools.partial(loader.layout, lanes=lanes)


def sweep(cs, loader, batches) -> dict:
    """The Forward gate's ms under the three lane ladders and the two
    wide layouts; the fs3 gate's ring against the direct loads."""
    import numpy as np
    from bath_tpu_torch import fixtures, ubench
    from bath_tpu_torch.ops import fs3, fwd
    from bath_tpu_torch.ops import multimodel as mm
    out = {"ladder": [], "wide": [], "fs3": []}
    _, (md, ml), msl, spk = batches["fwd_parser_multi"]
    _, (fd, fl), fsl, cpk = batches["fwd_parser_cal"]
    for name, lanes in LADDERS.items():
        lay = ladder(loader, lanes)
        for entry, pk, d, lt, sl in (
                ("fwd_parser_multi", spk, md, ml, msl),
                ("fwd_cal", cpk, fd, fl, fsl)):
            with setting(loader, "fwd_layout", lay):
                run = loader.prepare_fwd(d, lt, sl, pk)
            ms = ubench.cuda_ms(lambda: run(1.0), 10)
            out["ladder"].append({"entry": entry, "ladder": name,
                                  "classes": [c[:4]
                                              for c in run.plan.classes],
                                  "block_warps": run.plan.warps, "ms": ms})
    _, (d, lt), _, _ = batches["fwd_parser"]
    for M in SWEEP_FWD_MS:
        hm, _ = fixtures.make_query(M, np.random.default_rng(M),
                                    calibrate=False)
        one = mm.build_fwd_pack([fwd.fwd_params(fixtures.search_profile(hm),
                                                cs.DEV)])
        zeros = np.zeros(d.shape[0], np.int64)
        for name, lanes in LADDERS.items():
            lay = ladder(loader, lanes)
            with setting(loader, "fwd_layout", lay):
                run = loader.prepare_fwd(d, lt, zeros, one)
            ms = ubench.cuda_ms(lambda: run(1.0), 10)
            out["ladder"].append({"entry": "fwd_parser", "M": M,
                                  "ladder": name, "layout": list(lay(M)),
                                  "block_warps": run.plan.warps, "ms": ms,
                                  "us_per_row": 1e3 * ms / int(lt.max())})
    _, margs, mslot, mpk = batches["msv_filter_multi"]
    for name, lanes in LADDERS.items():
        lay = ladder(loader, lanes)
        pack = mm.IntPack(mpk.params, mm.MSV_SCALARS, lay)
        run = loader.prepare_msv(*margs, mslot, pack)
        ms = ubench.cuda_ms(run, 10)
        out["ladder"].append({"entry": "msv_filter_multi", "ladder": name,
                              "classes": [c[:4] for c in run.plan.classes],
                              "block_warps": run.plan.warps, "ms": ms})
    for wide in (mm.STAGE_TRANS, mm.STAGE_NONE):
        with setting(mm, "FWD_WIDE_STAGE", wide):
            run = loader.prepare_fwd(md, ml, msl, spk)
        ms = ubench.cuda_ms(lambda: run(1.0), 10)
        out["wide"].append({"entry": "fwd_parser_multi", "wide": wide,
                            "stages": {c[2]: int(r[7]) for c, r in zip(
                                run.plan.classes,
                                run.plan.table[:mm.PLAN_CLS * run.plan.ncls]
                                .reshape(-1, mm.PLAN_CLS))},
                            "ms": ms})
    fx = fixtures.write_fixture(cs.M_SEARCH, cs.GENOME_NT, cs.N_EMBEDS,
                                cs.SEED,
                                directory=HERE / "build" / "ab_fixtures")
    for M in SWEEP_FS3_MS:
        hm, _ = fixtures.make_query(M, np.random.default_rng(M),
                                    calibrate=False, fs=True)
        hm.set_max_length()
        pm = fs3.fs3_params(fixtures.fs_search_profile(hm), cs.DEV)
        wlen = 6 * hm.max_length
        ln, d3, l3 = cs.one_batch(fixtures.sample_windows(
            fx.fasta_path, cs.TIME_FS3_B, wlen, cs.SEED), pad=17)
        dd = (d3[:cs.TIME_FS3DD_B], l3[:cs.TIME_FS3DD_B])
        for direct in (False, True):
            for dec, (d, lt) in ((False, (d3, l3)), (True, dd)):
                with setting(mm, "FS3_DIRECT_P", 13 if direct else 0):
                    run = loader.prepare_fs3(d, lt, None, pm, dec)
                ms = ubench.cuda_ms(lambda: run(1.0), 5 if dec else 3)
                out["fs3"].append({
                    "M": M, "layout": list(loader.fs3_layout(M)),
                    "entry": "fs3_domdec" if dec else "fs3_parser",
                    "loads": "direct" if direct else "ring",
                    "windows": d.shape[0], "L": wlen, "ms": ms,
                    "us_per_row": 1e3 * ms / int(lt.max())})
    return out


def build(cs, tag: str) -> dict:
    """``bathbuild --backend torch`` of the 48-alignment Stockholm file
    of ``chip_smoke.py``'s build phase: wall, the device calibration's
    stage seconds, and a digest of the file without its DATE lines."""
    import torch
    from bath_tpu_torch.cli import bathbuild
    sto, _ = cs.Run(("build",)).msa()
    out = HERE / "build" / "ab_out" / tag / "built.bhmm"
    stats: dict = {}
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = bathbuild.main(["--backend", "torch", "--device", "cuda",
                             str(out), str(sto)], stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    text = "\n".join(ln for ln in out.read_text().splitlines()
                     if not ln.startswith("DATE"))
    return {"rc": rc, "wall_s": wall, **stats,
            "digest": hashlib.sha256(text.encode()).hexdigest()[:16]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(HERE))
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--vs", default="")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--build", action="store_true")
    args = ap.parse_args(argv)
    tree = Path(args.tree).resolve()
    tag = args.tag or tree.name
    sys.path.insert(0, str(tree))
    import torch
    if not torch.cuda.is_available():
        print("torch_fwd_msv_ab: no CUDA device", file=sys.stderr)
        sys.exit(2)
    import chip_smoke as cs
    assert Path(cs.__file__).resolve().parent == tree, cs.__file__
    from bath_tpu_torch import fixtures, ubench
    from bath_tpu_torch.ops.kernels import loader
    loader.lib()
    fx = fixtures.write_fixture(cs.M_SEARCH, cs.GENOME_NT, cs.N_EMBEDS,
                                cs.SEED,
                                directory=HERE / "build" / "ab_fixtures")
    batches = make_batches(cs, fx)
    keep = HERE / "build" / "ab_out"
    (keep / tag).mkdir(parents=True, exist_ok=True)
    rec = {"tag": tag, "tree": str(tree), "card": ubench.card_line(),
           "entries": {}}
    for name in ENTRIES:
        kind, a, sl, pk = batches[name]
        fn, n = kernel_call(loader, kind, a, sl, pk)
        wr = wrapper(name, a, sl, pk)
        outs = as_tuple(wr())
        torch.save([t.cpu() for t in outs], keep / tag / f"{name}.pt")
        e = {"ms": ubench.cuda_ms(fn, REPS[name]),
             "wrapper_ms": ubench.cuda_ms(wr, REPS[name]),
             "launches_per_call": n, "digest": digest(*outs)}
        if args.vs:
            e["vs_" + args.vs] = differs(
                outs, torch.load(keep / args.vs / f"{name}.pt"))
        rec["entries"][name] = e
    if args.sweep:
        rec["sweep"] = sweep(cs, loader, batches)
    if args.build:
        rec["build"] = build(cs, tag)
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
