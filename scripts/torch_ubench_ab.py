"""Kernel-only times of the one-hot (#8), overlap (#9) and scalars (#10)
microbenchmark entries of bath_tpu_torch on one NVIDIA GPU, for an A/B
of two checkouts on one card.

    python3 scripts/torch_ubench_ab.py [--tree DIR] [--tag NAME]
                                       [--out FILE] [--vs TAG] [--sweep]

Times with ``ubench.cuda_ms``, at [136, 1024] and [136, 4096] and 512
steps (the script's shapes, ``ubench.inputs``), ``bt_ub_onehot_mma``
and ``bt_ub_onehot_gather`` for n = 17, 65 and 257, beside
``F.embedding_bag(idx.T, t.float().T, mode="sum")``, the one PyTorch
call that computes the same sum (its inputs laid out before the timed
calls), ``bt_ub_overlap`` in modes chain, dot and both, with the share
of the chain that mode both hides, and ``bt_ub_scalars`` ([32, Bt]).
Each entry runs through the tree's own wrapper, which launches its
kernels with no read back, so its time is the kernels'.  ``--tree``
names the checkout whose ``bath_tpu_torch`` runs (default: this one; it
builds its own kernels under its ``build/``), so the same command times
a parent commit unpacked beside this one: run parent, change, change,
parent in one call.

Each record carries its design's ``floor_ms``, computed by this
checkout's ``bath_tpu_torch/ubench.py`` whatever tree runs (the gather's
``gather_floor_ms`` at the card's ``clocks.max.sm``, the tensor-core
entry's ``onehot_mma_floor_ms``,
the overlap product's ``overlap_floor_ms``, #10's ``scalars_floor_ms``
from the one-warp chain timed in the same run); the chain alone and
``embedding_bag`` have none.  ``--sweep`` also times the gather at n =
257 with no steps (what every call pays besides its steps).

Prints one JSON line: the card (``nvidia-smi``'s name and power limit,
and its ``clocks.max.sm``), and a record per entry and shape with ms,
the largest difference from the plain version, whether two calls gave
equal bits, and a digest of the output; with ``--out`` also appends it
there.  Each run keeps its outputs under ``build/ab_out/<tag>/``; ``--vs
TAG`` gives, per record, the largest difference from the outputs run
TAG kept.
"""

import argparse
import hashlib
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SHAPES = (1024, 4096)
TIMING_REPS = {"onehot": 20, "overlap": 5, "scalars": 50}


def floors():
    """This checkout's ubench.py, loaded by path (it imports numpy and
    torch only), for the designs' floors whatever tree runs."""
    spec = importlib.util.spec_from_file_location(
        "ubench_floors", HERE / "bath_tpu_torch" / "ubench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def digest(t) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().numpy()
                          .tobytes()).hexdigest()[:16]


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
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("torch_ubench_ab: no CUDA device", file=sys.stderr)
        sys.exit(2)
    from bath_tpu_torch import ubench as ub
    from bath_tpu_torch.ops.kernels import loader
    assert Path(ub.__file__).resolve().is_relative_to(tree), ub.__file__
    fl = floors()
    clock_hz = fl.max_sm_clock_hz()
    torch.backends.cuda.matmul.allow_tf32 = False
    loader.lib()
    dev = torch.device("cuda")
    keep = HERE / "build" / "ab_out"
    (keep / tag).mkdir(parents=True, exist_ok=True)
    recs = []

    def entry(name, fn, ref, kind, floor=None, **shape):
        a, b = fn(), fn()
        key = "_".join([name] + [f"{k}{v}" for k, v in shape.items()])
        torch.save(a.cpu(), keep / tag / f"{key}.pt")
        r = {"entry": name, **shape,
             "ms": ub.cuda_ms(fn, TIMING_REPS[kind]),
             "max_abs_err": float((a - ref).abs().max()),
             "deterministic": bool(torch.equal(a, b)), "digest": digest(a),
             "floor_ms": floor}
        other = keep / args.vs / f"{key}.pt"
        if args.vs and other.exists():
            r["vs_" + args.vs] = float((a.cpu() - torch.load(other))
                                       .abs().max())
        recs.append(r)
        return r

    # the one-warp chain: the dependent FMA's latency, #10's floor
    x1, = (a.to(dev) for a in ub.inputs("chain", 1, 32))
    nops = ub.CHAIN_NOPS[-1]
    step_ns = 1e6 * ub.cuda_ms(lambda: ub.chain(x1, nops), 20) \
        / (ub.REPS * (nops + 1))
    for Bt in SHAPES:
        for n in ub.ONEHOT_N:
            t, idx = (a.to(dev) for a in ub.inputs("onehot", ub.MT, Bt,
                                                   n=n))
            ref = ub.onehot_ref(t, idx)
            entry("bt_ub_onehot_gather", lambda: ub.onehot_gather(t, idx),
                  ref, "onehot",
                  fl.gather_floor_ms(ub.MT, Bt, ub.REPS, n, clock_hz),
                  Bt=Bt, n=n)
            entry("bt_ub_onehot_mma", lambda: ub.onehot_mma(t, idx), ref,
                  "onehot", fl.onehot_mma_floor_ms(Bt, ub.REPS, n), Bt=Bt,
                  n=n)
            if args.sweep and n == ub.ONEHOT_N[-1]:
                # no steps: the pack kernel, the image's copy, the
                # output and two launches, the cost every call pays
                i0 = idx[:0]
                entry("bt_ub_onehot_gather_steps0",
                      lambda: ub.onehot_gather(t, i0), ub.onehot_ref(t, i0),
                      "onehot", None, Bt=Bt, n=n)
            bag, w = idx.T.contiguous(), t.float().T.contiguous()
            entry("embedding_bag",
                  lambda: F.embedding_bag(bag, w, mode="sum").T, ref,
                  "onehot", Bt=Bt, n=n)
        g, x = (a.to(dev) for a in ub.inputs("overlap", ub.MT, Bt))
        ms = {}
        for mode in ub.OVERLAP_MODES:
            ms[mode] = entry("bt_ub_overlap",
                             lambda: ub.overlap(g, x, mode),
                             ub.overlap_ref(g, x, mode), "overlap",
                             None if mode == "chain"
                             else fl.overlap_floor_ms(Bt, ub.REPS), Bt=Bt,
                             mode=mode)["ms"]
        recs[-1]["hidden_share"] = (ms["chain"] + ms["dot"] - ms["both"]) \
            / min(ms["chain"], ms["dot"])
        xs, = (a.to(dev) for a in ub.inputs("scalars", 1, Bt))
        entry("bt_ub_scalars", lambda: ub.scalars(xs), ub.scalars_ref(xs),
              "scalars", fl.scalars_floor_ms(ub.REPS, step_ns), Bt=Bt)
    line = json.dumps({"tag": tag, "tree": str(tree),
                       "card": ub.card_line(),
                       "clocks_max_sm_mhz": clock_hz / 1e6,
                       "chain_one_warp_ns_per_step": step_ns,
                       "records": recs})
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
