"""Kernel-only times of the four fs3 entries of bath_tpu_torch on one
NVIDIA GPU, for an A/B of two checkouts on one card.

    python3 scripts/torch_fs3_ab.py [--tree DIR] [--tag NAME] [--out FILE]
                                    [--vs TAG] [--sweep] [--once]

Times, at ``chip_smoke.py``'s timing shapes, the fs3 gate (M = 409, 256
genome windows of 2 * max_length * 3 nt), fs3 decoding (32 of them),
the multi-model fs3 gate (48 models of M = 60..1200, 512 windows) and
multi-model fs3 decoding (24 windows of 12 models), each as the
kernel's own launches (the batch checked and planned beforehand) and
through its wrapper, with ``ubench.cuda_ms``.  ``--tree`` names the
checkout whose ``bath_tpu_torch`` and ``chip_smoke.py`` make the
batches and run (default: this one), so the same command times a
parent commit unpacked beside this one: run parent, change, parent,
change in one call.  The genome fixture is shared through
``build/ab_fixtures/`` of this checkout.

Prints one JSON line: per entry ms (kernel only), wrapper_ms,
launches_per_call and a digest of the kernel's output bytes; with
``--out`` also appends it there.  Each run keeps its kernels' outputs
under ``build/ab_out/<tag>/``; ``--vs TAG`` also gives, per entry, the
largest difference from the outputs run TAG kept (absolute, and
relative to the larger magnitude) and the count of elements that
differ.  ``--sweep`` adds the single-model gate and decoding on 64 and
16 windows of 2400 nt at M = 90, 150, 280, 400, 800, 1200 and 2000 (P =
3, 5, 9, 13 in one warp, then 2, 3 and 5 warps of 13 lanes):
microseconds a row of the longest chain.  ``--once`` launches each
entry once, in the order above, and times nothing: the run to give a
profiler (``ncu --kernel-name regex:fs3_ --launch-count 4 ...``).
"""

import argparse
import hashlib
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ENTRIES = ("fs3_parser", "fs3_domdec", "fs3_parser_multi",
           "fs3_domdec_multi")
REPS = {"fs3_parser": 5, "fs3_domdec": 3, "fs3_parser_multi": 5,
        "fs3_domdec_multi": 3}
SWEEP_MS = (90, 150, 280, 400, 800, 1200, 2000)
SWEEP_L = 2400


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


def single_call(loader, d, lt, p, dec: bool):
    """A launch-only callable of the single-model gate (or decoding) of
    either design, nj = 1."""
    import torch
    if hasattr(loader, "prepare_fs3"):
        run = loader.prepare_fs3(d, lt, None, p, dec)
        return lambda: run(1.0)
    so = loader.lib()
    B, L = d.shape
    P, _, Mp = loader.fs3_layout(p.M)
    et, tt = p.padded(Mp)

    def one():
        if not dec:
            o = torch.empty(B, dtype=torch.float32, device=d.device)
            loader._launch("fs3_parser", so.bt_fs3_parser, d, lt, B, L, et,
                           tt, Mp, P, 1.0, o)
            return o
        spec = torch.zeros(2, B, 6, L + 1, dtype=torch.float64,
                           device=d.device)
        lz = torch.empty(B, 2, dtype=torch.float64, device=d.device)
        loader._launch("fs3_domdec", so.bt_fs3_domdec, d, lt, B, L, et, tt,
                       p.M, Mp, P, 1.0, spec[0], spec[1], lz)
        return spec[0], spec[1], lz
    return one


def multi_call(loader, d, lt, sl, pack, dec: bool):
    """(launch-only callable, launches a call) of a multi-model entry of
    either design, nj = 1."""
    import torch
    if hasattr(loader, "prepare_fs3"):
        run = loader.prepare_fs3(d, lt, sl, pack, dec)
        return (lambda: run(1.0)), run.launches
    so = loader.lib()
    B, L = d.shape
    plans = loader._multi_plans(sl, pack, loader.fs3_items_per_block,
                                d.device)

    def many():
        if not dec:
            o = torch.empty(B, dtype=torch.float32, device=d.device)
            for c, order, blk, nb, G in plans:
                loader._launch("fs3_parser_multi", so.bt_fs3_parser_multi, d,
                               lt, B, L, c.etab, c.ttab, pack.Kp, c.Mp, c.P,
                               1.0, o, blk, order, nb, G)
            return o
        spec = torch.zeros(2, B, 6, L + 1, dtype=torch.float64,
                           device=d.device)
        lz = torch.empty(B, 2, dtype=torch.float64, device=d.device)
        for c, order, blk, nb, G in plans:
            loader._launch("fs3_domdec_multi", so.bt_fs3_domdec_multi, d, lt,
                           B, L, c.etab, c.ttab, c.Ms, pack.Kp, c.Mp, c.P,
                           1.0, spec[0], spec[1], lz, blk, order, nb, G)
        return spec[0], spec[1], lz
    return many, len(plans)


def make_batches(cs, fx):
    """The four timing batches of chip_smoke.py's timing phase:
    {entry: (dsq, lens, slots or None, pack or params, decoding)}."""
    import numpy as np
    from bath_tpu_torch import fixtures
    from bath_tpu_torch.ops import fs3
    run = cs.Run(("timing",))
    run.cache["fx"] = fx
    M = cs.TIME_FS3_M[1]
    hm, _ = fixtures.make_query(M, np.random.default_rng(M),
                                calibrate=False, fs=True)
    hm.set_max_length()
    pm = fs3.fs3_params(fixtures.fs_search_profile(hm), cs.DEV)
    _, d, lt = cs.one_batch(fixtures.sample_windows(
        fx.fasta_path, cs.TIME_FS3_B, 6 * hm.max_length, cs.SEED), pad=17)
    n = cs.TIME_FS3DD_B
    out = {"fs3_parser": (d, lt, None, pm, False),
           "fs3_domdec": (d[:n].contiguous(), lt[:n].contiguous(), None, pm,
                          True)}
    m = cs.mq_models(run)
    for name, items, sl, dec in (
            ("fs3_parser_multi", m["windows"], m["fs_slot"], False),
            ("fs3_domdec_multi", m["dd_windows"], m["dd_slot"], True)):
        _, mb, ml = cs.one_batch(items, pad=17)
        order = np.argsort([len(o) for o in items], kind="stable")
        out[name] = (mb, ml, np.asarray(sl)[order], m["fs_pack"], dec)
    return out


def wrapper(name, d, lt, sl, pk):
    """The entry's public call, checks and plan included."""
    from bath_tpu_torch.ops import fs3, fs3_domdec as fdd
    from bath_tpu_torch.ops import multimodel as mm
    return {"fs3_parser": lambda: fs3.fs3_score(d, lt, pk),
            "fs3_domdec": lambda: fdd.fs3_domdec(d, lt, pk, 100.0 / 103.0),
            "fs3_parser_multi": lambda: mm.fs3_pack_scores(pk, d, lt, sl),
            "fs3_domdec_multi": lambda: mm.fs3_domdec_pack_batch(
                pk, d, lt, sl, 100.0 / 103.0)}[name]


def sweep(cs, loader, fx) -> list:
    """us a row of the single-model gate and decoding by M, P and W."""
    import numpy as np
    from bath_tpu_torch import fixtures, ubench
    from bath_tpu_torch.ops import fs3
    _, d, lt = cs.one_batch(fixtures.sample_windows(
        fx.fasta_path, 64, SWEEP_L, cs.SEED + 5), pad=17)
    rows = []
    for M in SWEEP_MS:
        hm, _ = fixtures.make_query(M, np.random.default_rng(M),
                                    calibrate=False, fs=True)
        p = fs3.fs3_params(fixtures.fs_search_profile(hm), cs.DEV)
        rec = {"M": M, "layout": list(loader.fs3_layout(M))}
        for key, B, dec in (("gate", 64, False), ("decoding", 16, True)):
            fn = single_call(loader, d[:B].contiguous(), lt[:B].contiguous(),
                             p, dec)
            ms = ubench.cuda_ms(fn, 3)
            rec[key + "_us_per_row"] = 1e3 * ms / int(lt[:B].max())
        rows.append(rec)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(HERE))
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--vs", default="")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--once", action="store_true")
    args = ap.parse_args(argv)
    tree = Path(args.tree).resolve()
    tag = args.tag or tree.name
    sys.path.insert(0, str(tree))
    import torch
    if not torch.cuda.is_available():
        print("torch_fs3_ab: no CUDA device", file=sys.stderr)
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
    calls = {}
    for name, (d, lt, sl, pk, dec) in batches.items():
        calls[name] = (multi_call(loader, d, lt, sl, pk, dec)
                       if sl is not None
                       else (single_call(loader, d, lt, pk, dec), 1))
    if args.once:
        for name in ENTRIES:
            print(name, digest(*as_tuple(calls[name][0]())), flush=True)
        return
    keep = HERE / "build" / "ab_out"
    (keep / tag).mkdir(parents=True, exist_ok=True)
    rec = {"tag": tag, "tree": str(tree), "card": ubench.card_line(),
           "entries": {}}
    for name in ENTRIES:
        fn, n = calls[name]
        outs = as_tuple(fn())
        torch.save([t.cpu() for t in outs], keep / tag / f"{name}.pt")
        e = {"ms": ubench.cuda_ms(fn, REPS[name]),
             "wrapper_ms": ubench.cuda_ms(wrapper(name, *batches[name][:4]),
                                          REPS[name]),
             "launches_per_call": n, "digest": digest(*outs)}
        if args.vs:
            e["vs_" + args.vs] = differs(
                outs, torch.load(keep / args.vs / f"{name}.pt"))
        rec["entries"][name] = e
    if args.sweep:
        rec["sweep"] = sweep(cs, loader, fx)
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
