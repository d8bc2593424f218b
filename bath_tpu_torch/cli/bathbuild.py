"""bathbuild: construct profile HMM(s) from MSA(s) or sequences and
write a BATH3/f model file (ref: bathbuild.c main/serial_master,
output_header :260, output_result :~900).

``--backend torch`` (the default) builds the models on the host and then
calibrates all of them in one device-batched pass
(``evalues_device.calibrate_many_device``: MSV mu, Viterbi mu, Forward
tau and fs3 tau on the GPU, fs5 tau in the native host library on
threads beside it); ``--device cpu`` runs the kernels' plain PyTorch
versions instead.  ``--backend numpy`` is the serial host calibration.
The written file is the same but for the simulated Forward and fs3
taus, which the f32 gates place within ~1e-3 of the host parsers'.
Without a CUDA device the torch backend raises unless ``--device cpu``
is given: nothing falls back.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from ..bg import Background
from ..builder import BuilderConfig, build, single_build

from ..evalues import CalibrateConfig, mean_match_relative_entropy
from ..hmmfile import write_hmm
from ..msa import read_msas
from ..rng import Randomness
from ..sequence import read_fasta
from ..alphabet import amino

BANNER = "# bathbuild :: profile HMM construction from multiple sequence alignments"

_BCTX: dict | None = None


def _build_task(msa):
    """One model build in a (possibly forked) worker.  With the
    device backend, calibration is deferred: the parent
    batch-calibrates the whole model set on the GPU
    (evalues_device.calibrate_many_device) before serializing, and
    touches CUDA only after the workers have been joined."""
    import io
    c = _BCTX
    hmm = build(msa, c["cfg"], bg=Background(), r=c["r"],
                postmsa_file=c["postmsa_file"],
                do_calibrate=not c.get("defer_cal"))
    entropy = mean_match_relative_entropy(hmm, c["bg"])
    if c.get("defer_cal"):
        return (hmm, msa.name, msa.nseq, msa.alen,
                hmm.M, hmm.ct, hmm.eff_nseq, entropy, msa.desc)
    buf = io.StringIO()
    write_hmm(buf, hmm)
    return (buf.getvalue(), msa.name, msa.nseq, msa.alen,
            hmm.M, hmm.ct, hmm.eff_nseq, entropy, msa.desc)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bathbuild",
        description="construct profile HMM(s) from alignment(s) "
                    "(bath_tpu_torch)")
    p.add_argument("hmmfile_out")
    p.add_argument("msafile")
    p.add_argument("-n", dest="name", default=None,
                   help="name the (single) HMM")
    p.add_argument("-o", dest="outfile", default=None)
    p.add_argument("-O", dest="postmsafile", default=None,
                   help="resave annotated, possibly modified MSA "
                        "to file <f>")
    p.add_argument("--ct", type=int, default=1,
                   help="NCBI translation table id")
    p.add_argument("--fsprob", type=float, default=0.01)
    p.add_argument("--nofs", action="store_true",
                   help="skip frameshift calibration")
    p.add_argument("--fast", action="store_true", default=True)
    p.add_argument("--hand", action="store_true")
    p.add_argument("--symfrac", type=float, default=0.5)
    p.add_argument("--fragthresh", type=float, default=0.5)
    p.add_argument("--wpb", action="store_true", default=True)
    p.add_argument("--wgsc", action="store_true",
                   help="Gerstein/Sonnhammer/Chothia tree weights")
    p.add_argument("--wblosum", action="store_true",
                   help="Henikoff simple filter weights")
    p.add_argument("--wid", type=float, default=0.62,
                   help="for --wblosum: set identity cutoff")
    p.add_argument("--wnone", action="store_true")
    p.add_argument("--wgiven", action="store_true")
    p.add_argument("--eent", action="store_true", default=True)
    p.add_argument("--eentexp", action="store_true",
                   help="adjust eff seq # to reach rel. ent. target "
                        "using exp scaling")
    p.add_argument("--eclust", action="store_true",
                   help="eff seq # is # of single linkage clusters")
    p.add_argument("--eid", type=float, default=0.62,
                   help="for --eclust: set fractional identity cutoff")
    p.add_argument("--enone", action="store_true")
    p.add_argument("--eset", type=float, default=None)
    p.add_argument("--mx", default="BLOSUM62",
                   help="substitution score matrix (with --singlemx)")
    p.add_argument("--mxfile", default=None,
                   help="read substitution score matrix from file <f>")
    p.add_argument("--backend", choices=("torch", "numpy"),
                   default="torch",
                   help="calibration backend: torch batch-runs the "
                        "E-value simulations of all models on the "
                        "device; numpy: the serial host calibration")
    p.add_argument("--device", default="cuda",
                   help="torch device of the calibration (cuda, cuda:N, "
                        "or cpu for the kernels' plain versions)")
    p.add_argument("--cpu", type=int, default=0,
                   help="number of parallel model-build workers (multi-MSA files)")
    p.add_argument("--ere", type=float, default=None)
    p.add_argument("--esigma", type=float, default=45.0)
    p.add_argument("--pnone", action="store_true")
    p.add_argument("--plaplace", action="store_true")
    p.add_argument("--singlemx", action="store_true",
                   help="use substitution score matrix for single-seq inputs")
    p.add_argument("--popen", type=float, default=0.02)
    p.add_argument("--pextend", type=float, default=0.4)
    p.add_argument("--maxinsertlen", type=int, default=0)
    p.add_argument("--EmL", type=int, default=200)
    p.add_argument("--EmN", type=int, default=200)
    p.add_argument("--EvL", type=int, default=200)
    p.add_argument("--EvN", type=int, default=200)
    p.add_argument("--EfL", type=int, default=100)
    p.add_argument("--EfN", type=int, default=200)
    p.add_argument("--Eft", type=float, default=0.04)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--informat", default=None,
                   help="assert input file format (stockholm/pfam/"
                        "afa/a2m/clustal/psiblast/phylip/fasta); "
                        "no autodetect")
    p.add_argument("--w_beta", type=float, default=1e-7)
    p.add_argument("--w_length", type=int, default=0)
    return p


def config_from_args(args) -> BuilderConfig:
    cfg = BuilderConfig()
    cfg.arch = "hand" if args.hand else "fast"
    cfg.symfrac = args.symfrac
    cfg.fragthresh = args.fragthresh
    if args.wnone:
        cfg.wgt = "none"
    elif args.wgiven:
        cfg.wgt = "given"
    elif args.wgsc:
        cfg.wgt = "gsc"
    elif args.wblosum:
        cfg.wgt = "blosum"
        cfg.wid = args.wid
    if args.enone:
        cfg.effn = "none"
    elif args.eset is not None:
        cfg.effn = "set"
        cfg.eset = args.eset
    elif args.eclust:
        cfg.effn = "clust"
        cfg.eid = args.eid
    elif args.eentexp:
        cfg.effn = "entropy_exp"
    cfg.mx = args.mx
    cfg.mxfile = args.mxfile
    if args.ere is not None:
        cfg.re_target = args.ere
    cfg.esigma = args.esigma
    if args.pnone:
        cfg.prior = "none"
    elif args.plaplace:
        cfg.prior = "laplace"
    cfg.max_insert_len = args.maxinsertlen
    cfg.popen = args.popen
    cfg.pextend = args.pextend
    cfg.fs = not args.nofs
    cfg.fsprob = args.fsprob
    cfg.ct = args.ct
    cfg.w_beta = args.w_beta
    cfg.w_len = args.w_length
    cfg.seed = args.seed
    cfg.calibration = CalibrateConfig(
        EmL=args.EmL, EmN=args.EmN, EvL=args.EvL, EvN=args.EvN,
        EfL=args.EfL, EfN=args.EfN, Eft=args.Eft, seed=args.seed,
        fs=cfg.fs)
    return cfg


def main(argv=None, stats=None) -> int:
    """The CLI.  <stats>: optional dict the device calibration adds its
    stage walls and counts to (``evalues_device``)."""
    args = build_parser().parse_args(argv)
    if args.hmmfile_out == "-":
        print("Can't use '-' (stdin) for <hmmfile_out>",
              file=sys.stderr)
        return 1
    # option relations (ref: bathbuild.c option table)
    given = set(argv if argv is not None else sys.argv[1:])
    # --fast is the default construction, so --symfrac's requirement
    # is only violated when --hand overrides it
    if "--symfrac" in given and "--hand" in given:
        print("Failed to parse command line: Option --symfrac "
              "requires option --fast", file=sys.stderr)
        return 1
    for opt, req in (("--wid", "--wblosum"), ("--eid", "--eclust")):
        if opt in given and req not in given:
            print(f"Failed to parse command line: Option {opt} "
                  f"requires option {req}", file=sys.stderr)
            return 1
    for a, b in (("--pnone", "--plaplace"), ("--mx", "--mxfile")):
        if a in given and b in given:
            print(f"Failed to parse command line: Option {a} is "
                  f"incompatible with option {b}", file=sys.stderr)
            return 1
    if args.msafile == "-":
        from ._io import spool_stdin
        args.msafile = spool_stdin(".sto")
    if not os.path.exists(args.msafile):
        print(f"Failed to open MSA file {args.msafile} for reading",
              file=sys.stderr)
        return 1
    ofp = open(args.outfile, "w") if args.outfile else sys.stdout
    cfg = config_from_args(args)

    print(BANNER, file=ofp)
    print(f"# input file:                       {args.msafile}", file=ofp)
    print(f"# output HMM file:                  {args.hmmfile_out}",
          file=ofp)
    if args.postmsafile:
        print("# processed alignment resaved to:   "
              f"{args.postmsafile}", file=ofp)
    print("# " + "-" * 70, file=ofp)
    print("# %-6s %-20s %5s %5s %5s %4s %8s %6s %s"
          % ("idx", "name", "nseq", "len", "mlen", "ctbl", "eff_nseq",
             "re/pos", "description"), file=ofp)
    print("# %-6s %-20s %5s %5s %5s %4s %8s %6s %s"
          % ("------", "-" * 20, "-----", "-----", "-----", "----",
             "--------", "------", "-----------"), file=ofp)

    bg = Background()
    r = Randomness(args.seed)
    t0 = time.time()
    nali = 0
    with open(args.hmmfile_out, "w") as hfp:
        # try MSA first; fall back to unaligned FASTA single-seq
        # builds.  --informat asserts the format, no autodetect
        # (ref: bathbuild.c:119,381-388 — MSA formats go through
        # esl_msafile_EncodeFormat, 'fasta' means unaligned seqs)
        if args.informat and args.informat.lower() in ("fasta",
                                                       "embl",
                                                       "genbank"):
            msas, is_msa = None, False
        else:
            try:
                msas = read_msas(args.msafile, fmt=args.informat)
                is_msa = True
            except ValueError:
                if args.informat:
                    raise
                msas = None
                is_msa = False
        if is_msa:
            for i, msa in enumerate(msas):
                if args.name and len(msas) == 1:
                    msa.name = args.name
                elif not msa.name:
                    base = os.path.basename(args.msafile)
                    msa.name = base.rsplit(".", 1)[0]

            global _BCTX
            _BCTX = dict(cfg=cfg, r=r, bg=bg,
                         postmsa_file=args.postmsafile,
                         defer_cal=args.backend == "torch")
            try:
                ncpu = max(0, int(args.cpu or 0))
                if ncpu > 1 and len(msas) > 1 \
                        and not args.postmsafile:
                    # forked workers, one model per task; calibration
                    # reseeds the RNG so builds are order- and
                    # worker-independent (ref: threaded bathbuild +
                    # evalues.c:94 do_reseeding)
                    import multiprocessing as mp
                    with mp.get_context("fork").Pool(ncpu) as pool:
                        results = list(pool.imap(_build_task, msas,
                                                 chunksize=1))
                else:
                    results = [_build_task(m) for m in msas]
            finally:
                _BCTX = None
            if args.backend == "torch":
                # device-batched calibration over the whole model set
                # (ref: evalues.c p7_Calibrate per model; here one
                # batched simulation stage per kernel for all models:
                # evalues_device.py).  The build workers are joined:
                # CUDA starts here, never before the fork above.
                from ..evalues_device import calibrate_many_device
                ccfg = cfg.calibration
                ccfg.fs = cfg.fs
                hmms = [rrow[0] for rrow in results]
                calibrate_many_device(hmms, ccfg, device=args.device,
                                      stats=stats)
                import io
                packed = []
                for hmm, name, nseq, alen, M, ct, effn, ent, desc \
                        in results:
                    buf = io.StringIO()
                    write_hmm(buf, hmm)
                    packed.append((buf.getvalue(), name, nseq, alen,
                                   M, ct, effn, ent, desc))
                results = packed
            for text, name, nseq, alen, M, ct, effn, ent, desc \
                    in results:
                nali += 1
                hfp.write(text)
                print("  %-6d %-20s %5d %5d %5d %4d %8.2f %6.3f %s"
                      % (nali, name or "", nseq, alen, M, ct,
                         effn, ent, desc or ""), file=ofp)
        else:
            defer = args.backend == "torch"
            rows = []
            for sq in read_fasta(args.msafile, amino()):
                hmm = single_build(sq.dsq, sq.name, cfg, bg=Background(),
                                   r=r, do_calibrate=not defer)
                if sq.desc:
                    hmm.desc = sq.desc
                entropy = mean_match_relative_entropy(hmm, bg)
                rows.append((hmm, sq, entropy))
            if defer and rows:
                from ..evalues_device import calibrate_many_device
                ccfg = cfg.calibration
                ccfg.fs = cfg.fs
                calibrate_many_device([h for h, _, _ in rows], ccfg,
                                      device=args.device, stats=stats)
            for hmm, sq, entropy in rows:
                nali += 1
                write_hmm(hfp, hmm)
                print("  %-6d %-20s %5d %5d %5d %4d %8.2f %6.3f %s"
                      % (nali, sq.name, 1, sq.n, hmm.M, hmm.ct,
                         hmm.eff_nseq, entropy, sq.desc or ""), file=ofp)

    print(f"\n# CPU time: {time.time() - t0:.2f}u", file=ofp)
    print("# [ok]", file=ofp)
    if ofp is not sys.stdout:
        ofp.close()
    return 0


def cli_entry():
    from ._io import cli_main
    cli_main(main)


if __name__ == "__main__":
    cli_entry()
