"""Kernel-only times of the ViterbiFilter and decoding entries of
bath_tpu_torch on one NVIDIA GPU, for an A/B of two checkouts on one
card.

    python3 scripts/torch_vit_domdec_ab.py [--tree DIR] [--tag NAME]
                                           [--out FILE] [--vs TAG] [--sweep]

Times, at ``chip_smoke.py``'s timing shapes, the ViterbiFilter (#3:
M = 400, 4096 genome ORFs), its capture (J7: the same ORFs at the F2
thresholds), the multi-model ViterbiFilter of the device calibration
(J4b: 48 models of M = 60..1200, each over the one batch of 200 x 200
aa), decoding (J1: M = 400, 128 genome ORFs of at least 100 aa) and
multi-model decoding (J3b: 128 ORFs over the 48 models), each as the
kernel's own launches (the batch checked and planned beforehand) and
through its wrapper, with ``ubench.cuda_ms``.  ``--tree`` names the
checkout whose ``bath_tpu_torch`` and ``chip_smoke.py`` make the
batches and run (default: this one), so the same command times a
parent commit unpacked beside this one: run parent, change, change,
parent in one call.  The genome fixture is shared through
``build/ab_fixtures/`` of this checkout.

Prints one JSON line: per entry ms (kernel only), wrapper_ms,
launches_per_call and a digest of the wrapper's output bytes; with
``--out`` also appends it there.  Each run keeps its wrappers' outputs
under ``build/ab_out/<tag>/``; ``--vs TAG`` also gives, per entry, the
largest difference from the outputs run TAG kept (absolute, and
relative to the larger magnitude) and the count of elements that
differ.  ``--sweep`` (a tree with the one-launch ViterbiFilter) adds:
J4b and the single-model ViterbiFilter on the 4096 ORFs at M = 520,
700, 1000, 1100 and 1500 under two lane ladders (at most 17 lanes a
thread with W warps beyond, the kernel's; at most 33), ms and GCUPS;
and decoding's microseconds a row of the longest chain on the 128 ORFs
at M = 90, 150, 280, 400, 800, 1200 and 2000 (P = 3 .. 33 in one warp,
then two warps of 33 lanes).
"""

import argparse
import functools
import hashlib
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ENTRIES = ("vit_filter", "vit_capture", "vit_filter_multi", "domdec",
           "domdec_multi")
REPS = {"vit_filter": 20, "vit_capture": 20, "vit_filter_multi": 10,
        "domdec": 10, "domdec_multi": 5}
SWEEP_VIT_MS = (520, 700, 1000, 1100, 1500)
SWEEP_DD_MS = (90, 150, 280, 400, 800, 1200, 2000)
LADDERS = {"p17": (3, 5, 9, 13, 17), "p33": (3, 5, 9, 13, 17, 25, 33),
           "mixed": None}


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
    """The five timing batches of chip_smoke.py's timing phase, {entry:
    (kind, args, slots or None, params or pack)}, and the calibration's
    48 ViterbiFilter parameter sets."""
    import numpy as np
    import torch
    from bath_tpu_torch import evalues_device as ed
    from bath_tpu_torch import fixtures
    from bath_tpu_torch.bg import Background
    from bath_tpu_torch.evalues import CalibrateConfig
    from bath_tpu_torch.ops import multimodel as mm
    from bath_tpu_torch.ops import ssv, vit
    from bath_tpu_torch.oprofile import oprofile_convert
    from bath_tpu_torch.profile import profile_config
    run = cs.Run(("timing",))
    run.cache["fx"] = fx
    cas, _ = cs.cascade(run)
    pv = cas.vit
    v_orfs = fixtures.sample_orfs(fx.fasta_path, cs.TIME_INT_B, cs.SEED)
    flat, offs, lens = (torch.from_numpy(a).to(cs.DEV)
                        for a in ssv.pack_stream(v_orfs))
    vl = lens.cpu().numpy()
    bg = Background()
    nulls = []
    for n in vl.tolist():
        bg.set_length(n)
        nulls.append(bg.null_one(n))
    move, v_thr = (cs.ints(a) for a in cas.vit_thresholds(vl, nulls, cs.F2))
    out = {"vit_filter": ("vit", (flat, offs, lens, move), None, pv),
           "vit_capture": ("vitcap", (flat, offs, lens, move, v_thr), None,
                           pv)}
    ccfg = CalibrateConfig(fs=True)
    cal = ed.shared_draws(ccfg, Background()).vit
    m = cs.mq_models(run)
    cal_oms = [oprofile_convert(profile_config(h, Background(), L=ccfg.EvL))
               for h in m["hmms"]]
    params = [vit.vit_params(om, cs.DEV) for om in cal_oms]
    N, L = cal.shape
    cflat, coffs, clens, slot = ed.shared_stream(cal, len(cal_oms), cs.DEV)
    word = ed.per_model_words([p.move_for([L])[0] for p in params], N,
                              cs.DEV)
    out["vit_filter_multi"] = ("vit", (cflat, coffs, clens, word), slot,
                               mm.build_vit_pack(params))
    _, _, p400 = cs.query400()
    _, d, lt = cs.one_batch(fixtures.sample_orfs(
        fx.fasta_path, cs.TIME_DOMDEC_B, cs.SEED, min_len=100))
    out["domdec"] = ("dd", (d, lt), None, p400)
    # the slots chip_smoke.py's time_multi_all draws after the Forward
    # gate's
    m["rng"].integers(0, len(cs.MQ_MS), cs.TIME_MQ_FWD_B)
    items = fixtures.sample_orfs(fx.fasta_path, cs.TIME_MQ_DOMDEC_B, cs.SEED,
                                 min_len=100)
    sl = m["rng"].integers(0, len(cs.MQ_MS), cs.TIME_MQ_DOMDEC_B)
    _, md, ml = cs.one_batch(items, pad=28)
    order = np.argsort([len(o) for o in items], kind="stable")
    out["domdec_multi"] = ("dd", (md, ml), np.asarray(sl)[order],
                           m["std_pack"])
    return out, params


def kernel_call(loader, kind, args, slot, pk):
    """(launch-only callable, launches a call) of an entry of either
    design, nj = 1."""
    import torch
    if hasattr(loader, "prepare_vit"):
        if kind == "dd":
            run = loader.prepare_domdec(*args, slot, pk)
            return (lambda: run(1.0)), run.launches
        run = loader.prepare_vit(*args[:4], slot, pk,
                                 args[4] if kind == "vitcap" else None)
        return run, run.launches
    so = loader.lib()
    if kind == "dd":
        d, lt = args
        B, L = d.shape
        dev = d.device

        def outs():
            spec = torch.empty(B, 6, L + 1, dtype=torch.float64, device=dev)
            inc = torch.zeros(3, B, L, dtype=torch.float32, device=dev)
            lz = torch.empty(B, 2, dtype=torch.float32, device=dev)
            return spec, inc, lz
        if slot is None:
            P, _, Mp = loader.layout(pk.M)
            et, tt = pk.padded(Mp)

            def one():
                spec, inc, lz = outs()
                loader._launch("domdec", so.bt_domdec, d, lt, B, L, et, tt,
                               pk.Kp, pk.M, Mp, P, 1.0, spec, inc[0], inc[1],
                               inc[2], lz)
                return inc, lz
            return one, 1
        plans = loader._multi_plans(slot, pk, loader.items_per_block, dev)

        def many():
            spec, inc, lz = outs()
            for c, order, blk, nb, G in plans:
                loader._launch("domdec_multi", so.bt_domdec_multi, d, lt, B,
                               L, c.etab, c.ttab, c.Ms, pk.Kp, c.Mp, c.P,
                               1.0, spec, inc[0], inc[1], inc[2], lz, blk,
                               order, nb, G)
            return inc, lz
        return many, len(plans)
    flat, offs, lens, move = args[:4]
    B = lens.numel()
    dev = flat.device
    if slot is None:
        P, _, Mp = loader.layout(pk.M)
        tab = pk.table(Mp)
        if kind == "vitcap":
            def cap():
                orow = torch.empty(B, dtype=torch.int32, device=dev)
                karr = torch.zeros(flat.numel(), dtype=torch.int16,
                                   device=dev)
                loader._launch("vit_capture", so.bt_vit_capture, flat, offs,
                               lens, move, args[4], B, tab, pk.Kp, pk.M, Mp,
                               P, pk.base, pk.emove, pk.eloop, orow, karr)
                return karr, orow
            return cap, 1

        def one():
            o = torch.empty(3, B, dtype=torch.int32, device=dev)
            loader._launch("vit_filter", so.bt_vit_filter, flat, offs, lens,
                           move, B, tab, pk.Kp, pk.M, Mp, P, pk.base,
                           pk.emove, pk.eloop, o)
            return o
        return one, 1
    plans = loader._multi_plans(slot, pk, loader.items_per_block, dev)

    def many():
        o = torch.empty(3, B, dtype=torch.int32, device=dev)
        for c, order, blk, nb, G in plans:
            loader._launch("vit_filter_multi", so.bt_vit_filter_multi, flat,
                           offs, lens, move, B, c.tab, c.scal, pk.Kp, c.Mp,
                           c.P, o, blk, order, nb, G)
        return o
    return many, len(plans)


def wrapper(name, args, slot, pk):
    """The entry's public call, checks and plan included."""
    from bath_tpu_torch.ops import domdec as dd
    from bath_tpu_torch.ops import multimodel as mm
    from bath_tpu_torch.ops import vit
    return {"vit_filter": lambda: vit.vit_ints(*args, pk),
            "vit_capture": lambda: vit.vit_capture(*args, pk),
            "vit_filter_multi": lambda: mm.vit_ints_multi(pk, *args, slot),
            "domdec": lambda: dd.domdec(*args, pk),
            "domdec_multi": lambda: mm.domdec_pack_batch(pk, *args, slot)
            }[name]


def ladder(loader, lanes):
    """A lane ladder's layout: <lanes> in one warp and W warps of the
    last beyond, or (None) the kernel's own (``loader.vit_layout``)."""
    if lanes is None:
        return loader.vit_layout
    return functools.partial(loader.layout, lanes=lanes)


def sweep(cs, loader, batches, cal_params) -> dict:
    """ms of the ViterbiFilter under the two lane ladders, and decoding's
    us a row by M, P and W."""
    import numpy as np
    from bath_tpu_torch import fixtures, ubench
    from bath_tpu_torch.ops import fwd
    from bath_tpu_torch.ops import multimodel as mm
    from bath_tpu_torch.ops import vit
    out = {"vit": [], "decoding": []}
    _, args, slot, _ = batches["vit_filter_multi"]
    Ms = np.array([p.M for p in cal_params], np.float64)
    cells = float((args[2].cpu().numpy() * Ms[slot]).sum())
    for name, lanes in LADDERS.items():
        lay = ladder(loader, lanes)
        pack = mm.IntPack(cal_params, mm.VIT_SCALARS, lay)
        run = loader.prepare_vit(*args, slot, pack)
        ms = ubench.cuda_ms(run, 10)
        out["vit"].append({"entry": "vit_filter_multi", "ladder": name,
                           "classes": [c[:4] for c in run.plan.classes],
                           "block_warps": run.plan.warps, "ms": ms,
                           "gcups": cells / ms / 1e6})
    _, vargs, _, _ = batches["vit_filter"]
    for M in SWEEP_VIT_MS:
        hm, _ = fixtures.make_query(M, np.random.default_rng(M),
                                    calibrate=False)
        pv = vit.vit_params(fixtures.search_profile(hm), cs.DEV)
        move = cs.ints(pv.move_for(vargs[2].cpu().numpy()))
        for name, lanes in LADDERS.items():
            lay = ladder(loader, lanes)
            pack = mm.IntPack([pv], mm.VIT_SCALARS, lay)
            run = loader.prepare_vit(*vargs[:3], move,
                                     np.zeros(vargs[2].numel(), np.int64),
                                     pack)
            ms = ubench.cuda_ms(run, 10)
            out["vit"].append({"M": M, "ladder": name,
                               "layout": list(lay(M)),
                               "block_warps": run.plan.warps, "ms": ms,
                               "gcups": float(vargs[2].sum()) * M / ms / 1e6})
    _, (d, lt), _, _ = batches["domdec"]
    for M in SWEEP_DD_MS:
        hm, _ = fixtures.make_query(M, np.random.default_rng(M),
                                    calibrate=False)
        p = fwd.fwd_params(fixtures.search_profile(hm), cs.DEV)
        run = loader.prepare_domdec(d, lt, None, p)
        ms = ubench.cuda_ms(lambda: run(1.0), 5)
        out["decoding"].append({"M": M, "layout": list(loader.layout(M)),
                                "block_warps": run.plan.warps,
                                "us_per_row": 1e3 * ms / int(lt.max())})
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(HERE))
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--vs", default="")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args(argv)
    tree = Path(args.tree).resolve()
    tag = args.tag or tree.name
    sys.path.insert(0, str(tree))
    import torch
    if not torch.cuda.is_available():
        print("torch_vit_domdec_ab: no CUDA device", file=sys.stderr)
        sys.exit(2)
    import chip_smoke as cs
    assert Path(cs.__file__).resolve().parent == tree, cs.__file__
    from bath_tpu_torch import fixtures, ubench
    from bath_tpu_torch.ops.kernels import loader
    loader.lib()
    fx = fixtures.write_fixture(cs.M_SEARCH, cs.GENOME_NT, cs.N_EMBEDS,
                                cs.SEED,
                                directory=HERE / "build" / "ab_fixtures")
    batches, cal_params = make_batches(cs, fx)
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
        rec["sweep"] = sweep(cs, loader, batches, cal_params)
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
