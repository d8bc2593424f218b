"""Kernel-only times of the SSV capture and the other main-path kernel
entries of bath_tpu_torch at M = 400 on one NVIDIA GPU, for an A/B of
two checkouts on one card, and the segmented rows of every family at
M = 40000.

    python3 scripts/torch_ssv_ab.py [--tree DIR] [--tag NAME] [--out FILE]
                                    [--vs TAG] [--sweep] [--segments]

Times, at ``chip_smoke.py``'s timing shapes, the SSV capture (J6:
M = 400, 4096 genome ORFs at the F1 thresholds of their null scores),
the Forward gate (#1: 4096 ORFs), MSV (#2: one flush of 65 536 ORFs),
the ViterbiFilter and its capture (#3, J7: the 4096 ORFs, F2
thresholds), decoding (J1: 128 ORFs of at least 100 aa), the fs3 gate
(#4-6: M = 409, 256 windows of 2 * max_length * 3 nt) and fs3 decoding
(J2: 32 of them), each as the kernel's own launches (the batch checked
and planned beforehand by ``loader.prepare_*``) and through its wrapper,
with ``ubench.cuda_ms``.  ``--tree`` names the checkout whose
``bath_tpu_torch`` and ``chip_smoke.py`` make the batches and run
(default: this one), so the same command times a parent commit unpacked
beside this one: run parent, change, change, parent in one call.  The
genome fixture is shared through ``build/ab_fixtures/`` of this
checkout.

Prints one JSON line: per entry ms (kernel only), wrapper_ms,
launches_per_call, the batch's longest item and microseconds a row of
it, and a digest of the wrapper's output bytes; with ``--out`` also
appends it there.  Each run keeps its wrappers' outputs under
``build/ab_out/<tag>/``; ``--vs TAG`` also gives, per entry, the largest
difference from the outputs run TAG kept and the count of elements that
differ.  ``--sweep`` times the SSV capture with the model under other
lane ladders (more warps of fewer lanes: one warp of 13 lanes, the
kept, against two of 9, three of 5 and five of 3), and with its ORFs a
block consecutive in the longest-first order (block k the ranks
8k .. 8k + 7) against dealt round the blocks (the kept: block k the
ranks k, k + 512, ...).  ``--segments`` (a
tree that takes long models) times one launch of every family at
M = 40000 (walked in segments) on a few items: ms and microseconds a
row of the longest.
"""

import argparse
import contextlib
import hashlib
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ENTRIES = ("ssv_capture", "fwd_parser", "msv_filter", "vit_filter",
           "vit_capture", "domdec", "fs3_parser", "fs3_domdec")
REPS = {"ssv_capture": 20, "fwd_parser": 20, "msv_filter": 20,
        "vit_filter": 20, "vit_capture": 20, "domdec": 10,
        "fs3_parser": 5, "fs3_domdec": 3}
SWEEP_LANES = {"13x1": (3, 5, 9, 13), "9x2": (3, 5, 9), "5x3": (3, 5),
               "3x5": (3,)}
SEG_M = 40_000
SEG_ITEMS = (8, 300)            # (items, longest) of a segmented batch
SEG_WINDOWS = (4, 900)          # (windows, longest nt) of the fs3 pair


@contextlib.contextmanager
def setting(obj, name, value):
    """obj.<name> = <value> while the block runs."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def as_tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def differs(got, want) -> dict:
    """Largest absolute difference and differing count of two runs'
    outputs (infinities equal where both are)."""
    import torch
    ab, n = 0.0, 0
    for g, w in zip(got, want):
        g, w = g.double().cpu(), w.double().cpu()
        same = (g == w) | (torch.isnan(g) & torch.isnan(w))
        n += int((~same).sum())
        fin = torch.isfinite(g) & torch.isfinite(w) & ~same
        if fin.any():
            ab = max(ab, float((g - w)[fin].abs().max()))
    return {"max_abs": ab, "n_differ": n}


def make_batches(cs, fx):
    """{entry: (prepare-and-launch callable, wrapper callable, longest
    item)} at chip_smoke.py's timing shapes."""
    import numpy as np
    import torch
    from bath_tpu_torch import fixtures
    from bath_tpu_torch.bg import Background
    from bath_tpu_torch.cli.bathsearch import CHUNK_ORFS
    from bath_tpu_torch.ops import domdec as dd
    from bath_tpu_torch.ops import fs3, fwd, ssv, vit
    from bath_tpu_torch.ops import fs3_domdec as fdd
    from bath_tpu_torch.ops.kernels import loader
    run = cs.Run(("timing",))
    run.cache["fx"] = fx
    out = {}
    hm, _ = fixtures.make_query(cs.M_SEARCH,
                                np.random.default_rng(cs.M_SEARCH),
                                calibrate=False)
    p400 = fwd.fwd_params(fixtures.search_profile(hm), cs.DEV)
    ln, d, lt = cs.one_batch(fixtures.sample_orfs(fx.fasta_path,
                                                  cs.TIME_FWD_B, cs.SEED))
    k = loader.prepare_fwd(d, lt, None, p400)
    out["fwd_parser"] = (lambda: k(1.0), lambda: fwd.fwd_score(d, lt, p400),
                         int(ln.max()), k.launches)
    _, _, pq = run.once("q400", cs.query400)
    ln, dd_d, dd_l = cs.one_batch(fixtures.sample_orfs(
        fx.fasta_path, cs.TIME_DOMDEC_B, cs.SEED, min_len=100))
    kd = loader.prepare_domdec(dd_d, dd_l, None, pq)
    out["domdec"] = (lambda: kd(1.0), lambda: dd.domdec(dd_d, dd_l, pq),
                     int(ln.max()), kd.launches)
    M3 = cs.TIME_FS3_M[1]
    hm3, _ = fixtures.make_query(M3, np.random.default_rng(M3),
                                 calibrate=False, fs=True)
    hm3.set_max_length()
    p3 = fs3.fs3_params(fixtures.fs_search_profile(hm3), cs.DEV)
    wlen = 6 * hm3.max_length
    ln, d3, l3 = cs.one_batch(fixtures.sample_windows(
        fx.fasta_path, cs.TIME_FS3_B, wlen, cs.SEED), pad=17)
    kg = loader.prepare_fs3(d3, l3, None, p3, False)
    out["fs3_parser"] = (lambda: kg(1.0), lambda: fs3.fs3_score(d3, l3, p3),
                         int(ln.max()), kg.launches)
    dd3, ld3 = d3[:cs.TIME_FS3DD_B], l3[:cs.TIME_FS3DD_B]
    kf = loader.prepare_fs3(dd3, ld3, None, p3, True)
    out["fs3_domdec"] = (lambda: kf(1.0), lambda: fdd.fs3_domdec(
        dd3, ld3, p3, 100.0 / 103.0), int(ld3.max()), kf.launches)
    cas, all_orfs = cs.cascade(run)
    pm, pv = cas.msv, cas.vit
    f_orfs = all_orfs[:CHUNK_ORFS]
    fa = tuple(torch.from_numpy(a).to(cs.DEV)
               for a in ssv.pack_stream(f_orfs))
    ftjb = cs.ints(pm.tjb_for(fa[2].cpu().numpy()))
    km = loader.prepare_msv(*fa, ftjb, None, pm)
    out["msv_filter"] = (km, lambda: ssv.msv_ssv(*fa, ftjb, pm),
                         int(fa[2].max()), km.launches)
    v_orfs = fixtures.sample_orfs(fx.fasta_path, cs.TIME_INT_B, cs.SEED)
    va = tuple(torch.from_numpy(a).to(cs.DEV)
               for a in ssv.pack_stream(v_orfs))
    vl = va[2].cpu().numpy()
    bg = Background()
    nulls = []
    for n in vl.tolist():
        bg.set_length(n)
        nulls.append(bg.null_one(n))
    tjb, s_thr = (cs.ints(a) for a in cas.ssv_thresholds(vl, nulls, cs.F1))
    move, v_thr = (cs.ints(a) for a in cas.vit_thresholds(vl, nulls, cs.F2))
    kv = loader.prepare_vit(*va, move, None, pv)
    out["vit_filter"] = (kv, lambda: vit.vit_ints(*va, move, pv),
                         int(vl.max()), kv.launches)
    kc = loader.prepare_vit(*va, move, None, pv, v_thr)
    out["vit_capture"] = (kc, lambda: vit.vit_capture(*va, move, v_thr, pv),
                          int(vl.max()), kc.launches)
    ks = loader.prepare_ssv_capture(*va, tjb, s_thr, pm)
    out["ssv_capture"] = (ks, lambda: ssv.ssv_capture(*va, tjb, s_thr, pm),
                          int(vl.max()), ks.launches)
    out["_capture"] = (va, tjb, s_thr, pm)
    return out


def sweep(cs, loader, batches) -> list:
    """The SSV capture with the model under other lane ladders (more
    warps of fewer lanes), each forced by the model's MSV pack
    (``MSVParams.as_pack``, which the plan reads), then its ORFs a block
    consecutive against dealt (the order the kernel deals, permuted so
    that block k takes the ranks G k .. G k + G - 1; exact when G
    divides the batch)."""
    import functools
    from bath_tpu_torch import ubench
    from bath_tpu_torch.ops import multimodel as mm
    va, tjb, s_thr, pm = batches["_capture"]
    plans = pm.__dict__.setdefault("_single_plans", {})
    key = ("ssv_capture", va[0].device)
    rows = []
    for name, lanes in SWEEP_LANES.items():
        lay = functools.partial(loader.layout, lanes=lanes)
        kept = plans.pop(key, None)
        with setting(pm, "_pack", mm.IntPack([pm], mm.MSV_SCALARS, lay)):
            k = loader.prepare_ssv_capture(*va, tjb, s_thr, pm)
            ms = ubench.cuda_ms(k, 20)
            outs = k()
        plans.pop(key, None)
        if kept is not None:
            plans[key] = kept
        rows.append({"ladder": name, "layout": list(lay(pm.M)),
                     "block_warps": k.plan.warps, "ms": ms,
                     "digest": digest(*outs)})
    dealt = mm.ssv_order

    def consecutive(lens):
        import torch
        order = dealt(lens)
        G, nb = mm.ssv_blocks(lens.numel(), int(k.plan.table[5]),
                              loader.sms(lens.device))
        at = (torch.arange(nb, device=lens.device)[None, :] * G
              + torch.arange(G, device=lens.device)[:, None]).reshape(-1)
        return order[at[at < lens.numel()]]
    for name, fn in (("dealt", dealt), ("consecutive", consecutive)):
        with setting(mm, "ssv_order", fn):
            k = loader.prepare_ssv_capture(*va, tjb, s_thr, pm)
            ms = ubench.cuda_ms(k, 20)
            outs = k()
        rows.append({"blocks": name, "B": int(va[2].numel()), "ms": ms,
                     "digest": digest(*outs)})
    return rows


def segments(cs, loader) -> list:
    """One launch of every family at SEG_M on SEG_ITEMS items (the fs3
    pair on SEG_WINDOWS windows): kernel-only ms and microseconds a row
    of the longest item, with the layout and its segments."""
    import numpy as np
    import torch
    from bath_tpu_torch import fixtures, ubench
    from bath_tpu_torch.ops import fs3, fwd, ssv, vit
    hmm, q = fixtures.make_query(SEG_M, np.random.default_rng(SEG_M),
                                 calibrate=False, fs=True)
    om = fixtures.search_profile(hmm)
    rng = np.random.default_rng(SEG_M + 1)
    dsq, lens = fixtures.kernel_batch(q, *SEG_ITEMS, rng)
    d, lt = torch.from_numpy(dsq).to(cs.DEV), torch.from_numpy(lens).to(cs.DEV)
    flat, offs, ln = (torch.from_numpy(a).to(cs.DEV) for a in ssv.pack_stream(
        [r[:n] for r, n in zip(dsq, lens)]))
    pf, pm, pv = (fwd.fwd_params(om, cs.DEV), ssv.msv_params(om, cs.DEV),
                  vit.vit_params(om, cs.DEV))
    tjb, move = cs.ints(pm.tjb_for(lens)), cs.ints(pv.move_for(lens))
    thr = cs.ints(np.full(len(lens), cs.SSV_THR))
    vthr = cs.ints(np.full(len(lens), cs.VIT_THR))
    p3 = fs3.fs3_params(fixtures.fs_search_profile(hmm), cs.DEV)
    d3, l3 = (torch.from_numpy(a).to(cs.DEV)
              for a in fixtures.fs_window_batch(q, *SEG_WINDOWS, rng))
    cases = (
        ("fwd_parser", loader.fwd_layout,
         loader.prepare_fwd(d, lt, None, pf), 1.0, int(lens.max())),
        ("domdec", loader.layout, loader.prepare_domdec(d, lt, None, pf),
         1.0, int(lens.max())),
        ("msv_filter", loader.msv_layout,
         loader.prepare_msv(flat, offs, ln, tjb, None, pm), None,
         int(lens.max())),
        ("ssv_capture", loader.msv_layout,
         loader.prepare_ssv_capture(flat, offs, ln, tjb, thr, pm), None,
         int(lens.max())),
        ("vit_filter", loader.vit_layout,
         loader.prepare_vit(flat, offs, ln, move, None, pv), None,
         int(lens.max())),
        ("vit_capture", loader.vit_layout,
         loader.prepare_vit(flat, offs, ln, move, None, pv, vthr), None,
         int(lens.max())),
        ("fs3_parser", loader.fs3_layout,
         loader.prepare_fs3(d3, l3, None, p3, False), 1.0, int(l3.max())),
        ("fs3_domdec", loader.fs3_layout,
         loader.prepare_fs3(d3, l3, None, p3, True), 1.0, int(l3.max())))
    rows = []
    for name, lay, k, nj, longest in cases:
        fn = (lambda k=k, nj=nj: k(nj)) if nj is not None else k
        ms = ubench.cuda_ms(fn, 3)
        rows.append({"entry": name, "M": SEG_M, "layout": list(lay(SEG_M)),
                     "segments": loader.segments(*lay(SEG_M)),
                     "items": int(lt.shape[0] if not name.startswith("fs3")
                                  else l3.shape[0]),
                     "longest": longest, "ms": ms,
                     "us_per_row": 1e3 * ms / longest})
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(HERE))
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--vs", default="")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--segments", action="store_true")
    args = ap.parse_args(argv)
    tree = Path(args.tree).resolve()
    tag = args.tag or tree.name
    sys.path.insert(0, str(tree))
    import torch
    if not torch.cuda.is_available():
        print("torch_ssv_ab: no CUDA device", file=sys.stderr)
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
        fn, wr, longest, n = batches[name]
        outs = as_tuple(wr())
        torch.save([t.cpu() for t in outs], keep / tag / f"{name}.pt")
        ms = ubench.cuda_ms(fn, REPS[name])
        e = {"ms": ms, "wrapper_ms": ubench.cuda_ms(wr, REPS[name]),
             "launches_per_call": n, "longest": longest,
             "us_per_row": 1e3 * ms / longest, "digest": digest(*outs)}
        if args.vs:
            e["vs_" + args.vs] = differs(
                outs, torch.load(keep / args.vs / f"{name}.pt"))
        rec["entries"][name] = e
    if args.sweep:
        rec["sweep"] = sweep(cs, loader, batches)
    if args.segments:
        rec["segments"] = segments(cs, loader)
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
