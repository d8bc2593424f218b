"""bathsearch on a GPU: search protein profile HMM(s) against a DNA
database with the device stages of ``bath_tpu_torch``.

    python -m bath_tpu_torch.cli.bathsearch [--backend torch|numpy]
        [--device cuda|cpu] <query.bhmm> <dna.fa> [bathsearch options]

``--backend torch`` (the default) runs the standard pipeline's chunked
cascade: windows and six-frame ORFs on the host, the integer filters
(MSV/SSV, bias, ViterbiFilter) in the native host library, the
Forward gate (F3) and domain decoding on the device through
``TorchCascade``, and host rescoring, domain definition and output.
As in the JAX package, ``BATH_MSV_DEVICE=1`` moves MSV/SSV and the
SSV window capture, and ``BATH_VIT_DEVICE=1`` the ViterbiFilter and its
window capture, to the device (the all-device cascade); the bias
filter stays on the host.
``--fs``/``--fsonly`` add the frameshift branch: merged DNA windows on
the host, the fs3-Forward gate (F4) and fs3 domain decoding on the
device, and the host fs5 envelope stack.
A query file with more than one HMM runs the multi-query drive
(``multiquery.py``): one pass over the target, host filters per query
over shared ORFs, and every device stage batched across all queries
by the multi-model kernels (``ops/multimodel.py``).
``BATH_MULTIQUERY=0`` forces the serial per-query loop, and so does
``--splice``.
``--splice`` adds the JAX package's splice post-pass on the host
(``splice/``): the windows that the SSV and Viterbi captures found, and
the Forward gate passed, seed the splice graph beside the reported
hits; ``--exontblout`` writes the exon table.
``--cpu N`` (N > 1, default ``$HMMER_NCPU``) runs N worker processes
over the target windows, each with the host pipeline: under
``--backend numpy`` the windows go to the workers in stream order;
under ``--backend torch`` (the hybrid) the workers take windows while
they have room and this process takes the overflow into the device
cascade, and the results are merged in stream order.  With several
HMMs in the query file ``--cpu N`` runs the multi-query drive on either
backend, its queries split into N slices, one to a worker.  The pools
start their workers from a fresh server process
(``parallel/pool.py``), never by forking this one.
Its output is byte-identical to ``--backend numpy``, the package's own
serial host drive (every stage in the host kernels).  ``--device``
defaults to ``cuda``, and a missing CUDA device is an error; the CPU is
used only when ``--device cpu`` is given, which runs the kernels' plain
PyTorch versions.
``--mesh N`` (``--backend torch``) splits every device stage of the
cascade and of the multi-query drive over N devices of this process
(``parallel/mesh.py``: for ``--device cuda``, cards (rank * N + i) %
count; for ``cuda:K``, K..K+N-1; fewer cards is an error); ``--backend
numpy`` ignores it.  ``--hosts N --host-id i --coordinator host:port``
(or ``BATH_NPROCS``, ``BATH_PROC_ID``, ``BATH_COORDINATOR``) runs rank i
of N processes in a ``torch.distributed`` group (``parallel/hosts.py``):
every rank walks the whole window stream and searches the windows with
tid % N == i, the ranks' hits, hit windows and counters are gathered and
merged in stream order, and only rank 0 writes; a multi-HMM file takes
the serial per-query loop, and ``--cpu N`` the window pool or the
chunked cascade, not the hybrid.

``build_parser``, ``make_pipeline``, ``output_header``,
``load_queries`` and ``_pool_task`` are the JAX package's own, copied,
and so are the statements of the hybrid (``_hybrid``), of the window
pool (``_window_pool``) and of ``--hosts`` (rank 0's outputs, ``shard``
and the merge).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from collections import deque
from concurrent.futures import wait

import torch

from .. import constants as C
from ..bg import Background
from ..device_pipeline import (ChunkEntry, TorchCascade, flush_downstream,
                               flush_gates)
from ..gencode import GeneticCode, extract_orfs
from ..hmmfile import read_hmms
from ..native import set_native_threads
from ..oprofile import oprofile_convert
from ..ops.reference.fwdback_fs import fs_oprofile_convert
from ..parallel import hosts
from ..parallel.hosts import (allgather_results, maybe_init_from_args,
                              psum_counters, ranks_from_args)
from ..parallel.mesh import mesh_devices
from ..parallel.pool import by_name, imap, ready, stop_servers, worker_pool
from ..phasestats import each, phase
from ..pipeline import Pipeline, pipeline_bath, statistics_text
from ..profile import profile_config, profile_config_fs
from ..scoredata import score_data_create
from ..sequence import read_windows
from ..tophits import IS_INCLUDED, IS_REPORTED, TopHits, tabular_tail

# ORFs per gate flush: the host filters run per chunk, and every flush's
# F3 candidates and survivors go to the device together
CHUNK_ORFS = 65536


# ---------------------------------------------------------------------
# Multi-worker host path (ref: bathsearch.c thread_loop/pipeline_thread
# :1118-1291 — the pthread work queue over target blocks).  Workers are
# processes that receive the per-query profile state once, when they
# start (parallel/pool.py); results stream back in window order, so
# output is byte-identical to the serial path for any worker count (the
# reference's determinism contract, tested by i2-search-variation.sh).
# ---------------------------------------------------------------------
_WCTX: dict | None = None

_PLI_COUNTERS = ("n_past_msv", "n_past_bias", "n_past_vit",
                 "n_past_fwd", "n_output", "pos_past_msv",
                 "pos_past_bias", "pos_past_vit", "pos_past_fwd",
                 "pos_output")


def _pool_task(spec):
    """One window, both strands, in a worker."""
    tid, window, seqid, nres_at = spec
    c = _WCTX
    pli = c["pli"]
    # serial-stream residue count as of this window: the early domain
    # keep-filter reads pli.Z = nres/max_length at domain-definition
    # time (ref p7_pipeline.c:1230-1249); the worker's copy of the
    # counter is frozen when it starts, so restore the serial value per
    # window
    pli.nres = nres_at
    before = [getattr(pli, f) for f in _PLI_COUNTERS]
    th = TopHits()
    hws: list = []
    if pli.strands != C.STRAND_BOTTOMONLY:
        orfs = extract_orfs(c["gcode"], window.dsq,
                            minlen=c["minlen"],
                            require_initiator=c["require_init"])
        pipeline_bath(pli, c["om"], c["gm"], c["om_fs3"], c["om_fs5"],
                      c["gm_fs5"], c["data"], c["bg"], th, seqid,
                      window, orfs, c["gcode"], hws, C.NOCOMPLEMENT,
                      c["fs_funcs"])
    if pli.strands != C.STRAND_TOPONLY:
        rc = window.reverse_complement()
        orfs = extract_orfs(c["gcode"], rc.dsq, minlen=c["minlen"],
                            is_revcomp=True,
                            require_initiator=c["require_init"])
        pipeline_bath(pli, c["om"], c["gm"], c["om_fs3"], c["om_fs5"],
                      c["gm_fs5"], c["data"], c["bg"], th, seqid,
                      rc, orfs, c["gcode"], hws, C.COMPLEMENT,
                      c["fs_funcs"])
    deltas = {f: getattr(pli, f) - b
              for f, b in zip(_PLI_COUNTERS, before)}
    return tid, th.unsrt, hws, deltas


def backend_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--backend", default="torch",
                   choices=["torch", "numpy", "jax"],
                   help="torch: the device cascade of bath_tpu_torch; "
                        "numpy: the serial host drive, every stage in "
                        "the host kernels (byte-identical)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the cascade (cuda, cuda:N, or "
                        "cpu for the kernels' plain versions)")
    return p


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bathsearch",
        description="search protein profile(s) against DNA sequence "
                    "database (bath_tpu_torch)")
    p.add_argument("queryfile")
    p.add_argument("dbfile")
    p.add_argument("-o", dest="outfile", default=None)
    p.add_argument("--tblout", default=None)
    p.add_argument("--fstblout", default=None)
    p.add_argument("--exontblout", default=None)
    p.add_argument("--qformat", default=None)
    p.add_argument("--splice", action="store_true")
    p.add_argument("--min_intron", type=int, default=13)
    p.add_argument("--max_intron", type=int, default=200000)
    p.add_argument("--fs", action="store_true")
    p.add_argument("--fsonly", action="store_true")
    p.add_argument("--acc", action="store_true")
    p.add_argument("--noali", action="store_true")
    p.add_argument("--notrans", action="store_true")
    p.add_argument("--frameline", action="store_true")
    p.add_argument("--cigar", action="store_true")
    p.add_argument("--notextw", action="store_true")
    p.add_argument("--textw", type=int, default=150)
    p.add_argument("--ct", type=int, default=1)
    p.add_argument("-l", dest="minlen", type=int, default=20)
    p.add_argument("-m", dest="aug_only", action="store_true")
    p.add_argument("-M", dest="init_any_codon", action="store_true")
    p.add_argument("--strand", default="both",
                   choices=["both", "plus", "minus"])
    p.add_argument("-E", type=float, default=10.0)
    p.add_argument("-T", type=float, default=None)
    p.add_argument("--incE", type=float, default=0.01)
    p.add_argument("--incT", type=float, default=None)
    p.add_argument("--max", action="store_true")
    p.add_argument("--F1", type=float, default=C.F1_DEFAULT)
    p.add_argument("--F2", type=float, default=C.F2_DEFAULT)
    p.add_argument("--F3", type=float, default=C.F3_DEFAULT)
    p.add_argument("--F4", type=float, default=C.F4_DEFAULT)
    p.add_argument("--nobias", action="store_true")
    p.add_argument("--nonull2", action="store_true")
    p.add_argument("-Z", type=float, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--mx", default="BLOSUM62",
                   help="substitution score matrix for single-seq "
                        "queries (built-in choices)")
    p.add_argument("--mxfile", default=None,
                   help="read substitution score matrix from file <f>")
    p.add_argument("--crick", action="store_true",
                   help="only translate top strand")
    p.add_argument("--watson", action="store_true",
                   help="only translate bottom strand")
    p.add_argument("--nodeinfo", action="store_true",
                   help="additional info on node types for "
                        "--exontblout")
    p.add_argument("--ssifile", default=None,
                   help="override the restrictdb index file to <s>")
    # accepted for reference cmdline compatibility; unused there too
    # (ref: bathsearch.c options marked "Not used")
    p.add_argument("--domE", type=float, default=10.0,
                   help=argparse.SUPPRESS)
    p.add_argument("--domT", type=float, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--domZ", type=float, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--incdomE", type=float, default=0.01,
                   help=argparse.SUPPRESS)
    p.add_argument("--incdomT", type=float, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--block_length", type=int,
                   default=C.BLOCK_LENGTH_DEFAULT)
    p.add_argument("--restrictdb_stkey", default=None,
                   help="search starts at the sequence named <key> "
                        "(ref: bathsearch.c :143)")
    p.add_argument("--restrictdb_n", type=int, default=-1,
                   help="search at most <n> sequences from stkey")
    p.add_argument("--hmmout", default=None,
                   help="save HMMs built from MSA/seq queries to <f>")
    p.add_argument("--tformat", default=None)
    p.add_argument("--singlemx", action="store_true")
    p.add_argument("--popen", type=float, default=0.02)
    p.add_argument("--pextend", type=float, default=0.4)
    p.add_argument("--w_beta", type=float, default=1e-7)
    p.add_argument("--w_length", type=int, default=0)
    import os as _os
    p.add_argument("--cpu", type=int,
                   default=int(_os.environ.get("HMMER_NCPU", 0)),
                   help="number of parallel workers over target "
                        "windows; 0/1 = serial")
    # --backend and --device are read by backend_parser before this
    # one
    p.add_argument("--mesh", type=int, default=0,
                   help="with --backend torch: shard the device stages "
                        "over N devices of this process (profiles on "
                        "each; output is identical for any N)")
    p.add_argument("--hosts", type=int,
                   default=int(_os.environ.get("BATH_NPROCS", 0)),
                   help="total process count of a torch.distributed "
                        "data-parallel run: windows are sharded "
                        "tid %% hosts == host-id, hits/stats are "
                        "all-gathered and merged in stream order, so "
                        "output is byte-identical for any host count "
                        "(run one process per host)")
    p.add_argument("--host-id", type=int, default=-1,
                   help="this process's rank (0..hosts-1); host 0 "
                        "writes the output")
    p.add_argument("--coordinator", default=None,
                   help="host:port of rank 0's torch.distributed "
                        "store (default localhost:9377)")
    return p


def make_pipeline(args) -> Pipeline:
    pli = Pipeline()
    pli.fs_pipe = args.fs or args.fsonly
    pli.std_pipe = not args.fsonly
    pli.spliced = args.splice
    pli.E = args.E
    if args.T is not None:
        pli.T = args.T
        pli.by_E = False
    pli.incE = args.incE
    if args.incT is not None:
        pli.incT = args.incT
        pli.inc_by_E = False
    pli.F1 = min(1.0, args.F1)
    pli.F2 = min(1.0, args.F2)
    pli.F3 = min(1.0, args.F3)
    pli.F4 = min(1.0, args.F4)
    if args.max:
        pli.do_max = True
        pli.do_biasfilter = False
        pli.F1 = pli.F2 = pli.F3 = pli.F4 = 1.0
    if args.nobias:
        pli.do_biasfilter = False
    if args.nonull2:
        pli.do_null2 = False
    pli.show_alignments = not args.noali
    pli.show_accessions = args.acc
    pli.show_frameline = args.frameline
    pli.show_trans = not args.notrans
    pli.show_cigar = args.cigar
    pli.strands = {"both": C.STRAND_BOTH, "plus": C.STRAND_TOPONLY,
                   "minus": C.STRAND_BOTTOMONLY}[args.strand]
    pli.block_length = args.block_length
    return pli


def output_header(ofp, args):
    ofp.write("# bathsearch :: search protein profile(s) against DNA "
              "sequence database\n")
    ofp.write("# bath_tpu (TPU-native framework)\n")
    ofp.write("# - - - - - - - - - - - - - - - - - - - - - - - - - - - "
              "- - - - - - - -\n")
    ofp.write("# query HMM file:                                %s\n"
              % args.queryfile)
    ofp.write("# target sequence database:                      %s\n"
              % args.dbfile)
    ofp.write("# codon translation table:                       %d\n"
              % args.ct)
    ofp.write("# - - - - - - - - - - - - - - - - - - - - - - - - - - - "
              "- - - - - - - -\n\n")


def load_queries(path, args):
    """Query open/autodetect: profile HMM file, MSA, or sequence(s)
    (ref: bathsearch.c :552-632, p7_search_builder.c :98 — MSA/seq
    queries are built + calibrated on the fly)."""
    from ..sequence import _open_text
    with _open_text(path) as fh:
        head = fh.read(256)
    qfmt = getattr(args, "qformat", None)
    if head.startswith(("BATH", "HMMER")):
        yield from read_hmms(path)
        return
    from ..builder import BuilderConfig, build, single_build
    from ..msa import read_stockholm
    cfg = BuilderConfig(fs=True, ct=args.ct,
                        popen=getattr(args, "popen", 0.02),
                        pextend=getattr(args, "pextend", 0.4),
                        w_beta=getattr(args, "w_beta", 1e-7),
                        w_len=getattr(args, "w_length", 0),
                        mx=getattr(args, "mx", "BLOSUM62"),
                        mxfile=getattr(args, "mxfile", None))
    hmmout = getattr(args, "hmmout", None)
    hfp = open(hmmout, "w") if hmmout else None

    def emit(h):
        if hfp is not None:
            from ..hmmfile import write_hmm
            write_hmm(hfp, h)
            hfp.flush()
        return h
    if head.startswith("# STOCKHOLM") or qfmt in ("stockholm", "sto"):
        for msa in read_stockholm(path):
            if not msa.name:
                msa.name = path.rsplit("/", 1)[-1].rsplit(".", 1)[0]
            yield emit(build(msa, cfg))
        return
    if not head.lstrip().startswith(">"):
        raise SystemExit(f"can't autodetect query format of {path}")
    body = "".join(ln for ln in head.splitlines()[1:]
                   if not ln.startswith(">"))
    is_aligned = any(c in body for c in "-.")
    if qfmt in ("afa",) or (is_aligned and qfmt is None):
        from ..msa import read_afa
        for msa in read_afa(path):
            if not msa.name:
                msa.name = path.rsplit("/", 1)[-1].rsplit(".", 1)[0]
            yield emit(build(msa, cfg))
        return
    from ..alphabet import amino
    from ..sequence import read_fasta
    for sq in read_fasta(path, amino()):
        h = single_build(sq.dsq, sq.name, cfg)
        if sq.desc:
            h.desc = sq.desc
        yield emit(h)
    if hfp is not None:
        hfp.close()


def require_native():
    """The native host library; the torch backend runs the bias filter,
    and the integer filters unless BATH_MSV_DEVICE=1/BATH_VIT_DEVICE=1
    send them to the device, there, and refuses to fall back to the
    pure-numpy filters."""
    from ..native import _SO, _SRC, get_lib
    lib = get_lib()
    if lib is None:
        raise RuntimeError(
            f"the native host library ({_SO}) failed to build from "
            f"{_SRC} (g++) or to load; the torch backend runs the bias "
            "filter and, by default, the integer filters (MSV/SSV, "
            "ViterbiFilter) in it")
    return lib


def check_query(hmm, args) -> None:
    """The per-query checks of the serial loop; sets max_length."""
    if args.fs or args.fsonly:
        if not (hmm.fsprob and hmm.ct):
            raise SystemExit(
                f"HMM file {args.queryfile} not formatted for "
                "frameshift search; run bathconvert first.")
    else:
        hmm.fs = False
        hmm.fsprob = 0.0
    if hmm.ct and hmm.ct != args.ct:
        raise SystemExit(
            f"--ct {args.ct} does not match HMM codon table {hmm.ct}")
    if hmm.max_length == -1:
        hmm.set_max_length()


def run(argv=None, stats=None, devices=None) -> int:
    """The CLI.  <stats>: optional dict the device stages add their
    counts to (see TorchCascade and multiquery.PackedGates).
    <devices>: the mesh of the device stages (``--backend torch``), in
    place of the one ``--mesh``/``--hosts`` give (``mesh_devices``); a
    list may repeat a device, so that one card holds several shares."""
    argv = list(sys.argv[1:] if argv is None else argv)
    pre, rest = backend_parser().parse_known_args(argv)
    args = build_parser().parse_args(rest)
    if pre.backend == "jax":
        raise NotImplementedError(
            "--backend jax is the JAX package's (python -m "
            "bath_tpu.cli.bathsearch); this package runs --backend torch "
            "or numpy")
    on_device = pre.backend == "torch"
    device = torch.device(pre.device)
    if on_device:
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("--backend torch needs a CUDA device (none "
                               "is available); --device cpu runs the plain "
                               "PyTorch versions instead")
        require_native()
    if args.crick:
        args.strand = "plus"
    elif args.watson:
        args.strand = "minus"
    if args.queryfile == "-" and args.dbfile == "-":
        print("Either <hmmfile> or <seqdb> may be '-' (stdin), "
              "but not both", file=sys.stderr)
        return 1
    # option incompatibilities (ref: bathsearch.c option table
    # :75-76, :81, :156)
    if args.fs and args.splice:
        print("Failed to parse command line: Option --fs is "
              "incompatible with option --splice", file=sys.stderr)
        return 1
    if getattr(args, "fsonly", False) and args.splice:
        print("Failed to parse command line: Option --fsonly is "
              "incompatible with option --splice", file=sys.stderr)
        return 1
    for opt in ("exontblout", "min_intron", "max_intron"):
        if getattr(args, opt, None) not in (None, False) \
                and not args.splice \
                and f"--{opt}" in (argv or sys.argv[1:]):
            print(f"Failed to parse command line: Option --{opt} "
                  "requires (or has no effect without) option "
                  "--splice", file=sys.stderr)
            return 1
    if args.queryfile == "-":
        from ._io import spool_stdin
        args.queryfile = spool_stdin(".bhmm")
    if args.dbfile == "-":
        from ._io import spool_stdin
        args.dbfile = spool_stdin(".fa")
    for path, what in ((args.queryfile, "query file"),
                       (args.dbfile, "target sequence database")):
        if not os.path.exists(path):
            print(f"Failed to open {what} {path} for reading",
                  file=sys.stderr)
            return 1

    # this rank's devices before it joins the group or opens an
    # output: a rank that cannot have them fails alone
    nprocs, proc_id, _ = ranks_from_args(args)
    if on_device and devices is None and (args.mesh > 1 or nprocs > 1):
        # --mesh N: this rank's N devices; --hosts alone: its one card
        devices = mesh_devices(max(1, args.mesh), pre.device, proc_id)
    # multi-host SPMD (ref discipline: bathsearch.c thread merge
    # :887-892 lifted across hosts; see parallel/hosts.py)
    nprocs, proc_id = maybe_init_from_args(args)

    if proc_id:
        # every rank computes the merged result (it is deterministic);
        # only rank 0 writes it.  One null file an output: the tail
        # closes each table before the next is written
        ofp = open(os.devnull, "w")
        tblfp = open(os.devnull, "w") if args.tblout else None
        fstblfp = open(os.devnull, "w") if args.fstblout else None
        extblfp = open(os.devnull, "w") if args.exontblout else None
    else:
        ofp = open(args.outfile, "w") if args.outfile else sys.stdout
        tblfp = open(args.tblout, "w") if args.tblout else None
        fstblfp = open(args.fstblout, "w") if args.fstblout else None
        extblfp = open(args.exontblout, "w") if args.exontblout \
            else None
    textw = 0 if args.notextw else args.textw
    gcode = GeneticCode.create(args.ct)
    if args.aug_only:
        gcode.set_initiator_only_aug()
    require_init = args.aug_only or args.init_any_codon
    if not require_init:
        gcode.set_initiator_any()
    output_header(ofp, args)

    def finish():
        for fp in (tblfp, fstblfp, extblfp):
            if fp:
                fp.write(tabular_tail("bathsearch", args.queryfile,
                                      args.dbfile,
                                      "bathsearch " + " ".join(argv)))
                fp.close()
        ofp.write("[ok]\n")
        if ofp is not sys.stdout:
            ofp.close()
        return 0

    # Multi-query drive: one pass over the target, device gate batches
    # across models (multiquery.py).  Byte-identical to the serial
    # per-query loop; engaged when several HMMs share one query file
    # and no mode that needs the per-query stream (the splice
    # post-pass, multi-host sharding) is on: for the torch backend
    # always, for numpy when --cpu N asks for workers (the
    # query-sharded pool).  BATH_MULTIQUERY=0 forces the serial loop.
    queries = load_queries(args.queryfile, args)
    ncpu = max(0, int(args.cpu or 0))
    if nprocs <= 1 and (on_device or ncpu > 1) and not args.splice \
            and os.environ.get("BATH_MULTIQUERY", "1") != "0":
        hmms = []
        for hmm in queries:
            check_query(hmm, args)
            hmms.append(hmm)
        if len(hmms) > 1:
            from ..multiquery import run_multiquery
            run_multiquery(args, hmms, gcode, require_init, ofp, tblfp,
                           fstblfp, device=device, stats=stats,
                           devices=devices)
            return finish()
        queries = iter(hmms)

    fs_funcs = None
    if args.fs or args.fsonly:
        from ..pipeline_fs import pli_frameshift
        fs_funcs = pli_frameshift

    nquery = 0
    for hmm in queries:
        nquery += 1
        t0 = time.time()
        check_query(hmm, args)
        bg = Background()
        gm = profile_config(hmm, bg, L=100, mode=C.P7_LOCAL)
        om = oprofile_convert(gm)
        gm_fs5 = profile_config_fs(hmm, bg, gcode, 5, 100, C.P7_LOCAL)
        om_fs3 = om_fs5 = None
        if args.fs or args.fsonly:
            om_fs3 = fs_oprofile_convert(
                profile_config_fs(hmm, bg, gcode, 3, 100, C.P7_LOCAL))
            om_fs5 = fs_oprofile_convert(gm_fs5)
        data = score_data_create(om)
        pli = make_pipeline(args)
        pli.nmodels = 1
        pli.nnodes = hmm.M
        pli.W = om.max_length
        if pli.do_biasfilter:
            bg.set_filter(om.M, om.compo)
        th = TopHits()
        hit_windows: list = []
        id_lengths: dict = {}
        ofp.write("Query:       %s  [M=%d]\n" % (hmm.name, hmm.M))
        if hmm.acc:
            ofp.write("Accession:   %s\n" % hmm.acc)
        if hmm.desc:
            ofp.write("Description: %s\n" % hmm.desc)
        cascade = TorchCascade(om, om_fs3, device=device, stats=stats,
                               devices=devices) if on_device else None
        # the hybrid only without --hosts (ref :588-591): under it a
        # rank's torch drive is the chunked cascade over its windows
        hybrid = ncpu > 1 and nprocs <= 1 and cascade is not None
        results = [] if nprocs > 1 else None
        ctr0 = {f: getattr(pli, f) for f in _PLI_COUNTERS} \
            if nprocs > 1 else None

        def shard(specs):
            """Window sharding across hosts: every rank walks the
            full stream (global nres/nseqs/length bookkeeping), only
            its own windows are processed."""
            for spec in specs:
                if spec[0] % nprocs == (proc_id if nprocs > 1 else 0):
                    yield spec

        specs = ((tid, *spec) for tid, spec in enumerate(
            _windows(args, pli, om, id_lengths)))
        if hybrid or (ncpu > 1 and cascade is None):
            wctx = dict(pli=pli, om=om, gm=gm, om_fs3=om_fs3,
                        om_fs5=om_fs5, gm_fs5=gm_fs5, data=data, bg=bg,
                        gcode=gcode, minlen=args.minlen,
                        require_init=require_init, fs_funcs=fs_funcs)
            if cascade is None:
                _window_pool(ncpu, wctx, shard(specs), th, hit_windows,
                             stats, results)
            else:
                _hybrid(args, ncpu, wctx, cascade, specs, th,
                        hit_windows, stats)
        else:
            def down_flush(chunk):
                with phase("flush.gates"):
                    staged = flush_gates(chunk, cascade, pli, om, data, bg,
                                         hit_windows)
                with phase("flush.downstream"):
                    flush_downstream(staged, cascade, pli, om, gm, om_fs3,
                                     om_fs5, gm_fs5, data, bg, th, gcode,
                                     hit_windows, use_device=True)
                if results is not None:
                    for e in staged:
                        results.append(
                            (e.tid, list(e.hits.unsrt),
                             hit_windows[e.win_start:e.win_end]))

            chunk: list = []
            pending_orfs = 0
            for tid, window, seqid, nres_at in each("cli.windows",
                                                    shard(specs)):
                th_w = th if results is None else TopHits()
                hws_w = hit_windows if results is None else []
                for comp in (C.NOCOMPLEMENT, C.COMPLEMENT):
                    if comp == C.NOCOMPLEMENT \
                            and pli.strands == C.STRAND_BOTTOMONLY:
                        continue
                    if comp == C.COMPLEMENT \
                            and pli.strands == C.STRAND_TOPONLY:
                        continue
                    with phase("cli.orfs"):
                        w = window if comp == C.NOCOMPLEMENT \
                            else window.reverse_complement()
                        orfs = extract_orfs(
                            gcode, w.dsq, minlen=args.minlen,
                            is_revcomp=comp == C.COMPLEMENT,
                            require_initiator=require_init)
                    if cascade is None:
                        # the serial host drive: every stage of this
                        # (window, strand) in the host kernels
                        pipeline_bath(pli, om, gm, om_fs3, om_fs5,
                                      gm_fs5, data, bg, th_w, seqid, w,
                                      orfs, gcode, hws_w, comp, fs_funcs)
                        continue
                    chunk.append(ChunkEntry(w, seqid, comp, orfs,
                                            tid=tid, nres_at=nres_at))
                    pending_orfs += len(orfs)
                if cascade is None and results is not None:
                    results.append((tid, th_w.unsrt, hws_w))
                if pending_orfs >= CHUNK_ORFS:
                    down_flush(chunk)
                    pending_orfs = 0
            if chunk:
                down_flush(chunk)

        if nprocs > 1:
            # cross-host merge (ref: p7_tophits_Merge +
            # p7_pipeline_Merge at bathsearch.c:887-892): every rank
            # rebuilds the identical global result in stream order
            combined = allgather_results(results)
            th.unsrt = [h for _, hs, _ in combined for h in hs]
            hit_windows[:] = [w for _, _, hws in combined
                              for w in hws]
            delta = {f: getattr(pli, f) - ctr0[f]
                     for f in _PLI_COUNTERS}
            red = psum_counters(delta)
            for f in _PLI_COUNTERS:
                setattr(pli, f, ctr0[f] + red[f])

        # E-values from the global residue count (ref: bathsearch.c
        # :869-884), then the serial path's sort/dedup/threshold
        if args.Z is not None:
            res_cnt = int(1000000 * args.Z)
            if pli.strands == C.STRAND_BOTH:
                res_cnt *= 2
        else:
            res_cnt = pli.nres
        # the E-values and the output are the span cli.output, the
        # --splice post-pass between them is not
        with phase("cli.output"):
            th.compute_evalues_bath(res_cnt, om.max_length * 3)
            th.sort_by_seqidx_and_alipos()
            for h in th.unsrt:
                if h.seqidx in id_lengths:
                    h.target_len = id_lengths[h.seqidx]
                    if h.dcl and h.dcl[0].ad is not None:
                        h.dcl[0].ad.L = id_lengths[h.seqidx]
            th.remove_duplicates(pli.use_bit_cutoffs)
            th.sort_by_sortkey()
            pli.Z = 1.0
            th.threshold(pli)

        t_splice = time.time()
        # --splice post-pass (ref: bathsearch.c :925-947)
        if args.splice and th.N:
            from ..splice.pipeline import splice_hits
            from ..splice.splice import SpliceConfig
            gm_tr = profile_config_fs(hmm, bg, gcode, 1, 100,
                                      C.P7_UNILOCAL)
            gm_tr.evparam = hmm.evparam.copy()
            from ..sequence import LazySeqLookup
            from ..alphabet import dna as dna_abc
            seq_lookup = LazySeqLookup(args.dbfile, dna_abc())
            pli.qname = hmm.name
            scfg = SpliceConfig(min_intron=args.min_intron,
                                max_intron=args.max_intron,
                                E=pli.E,
                                T=None if pli.by_E else pli.T,
                                F1=pli.F1, F2=pli.F2, F3=pli.F3,
                                do_null2=pli.do_null2,
                                do_biasfilter=pli.do_biasfilter)
            # seed recovery (ref: bathsearch.c :930-933)
            from ..splice.seeds import (get_seed_hits,
                                        remove_duplicate_windows)
            th.sort_by_seqidx_and_alipos()
            ws = remove_duplicate_windows(hit_windows, th, pli.F3)
            seeds = get_seed_hits(ws, th, gm_fs5, seq_lookup, pli.F3,
                                  args.max_intron)
            splice_hits(th, seeds, om, gm, gm_tr, bg, gcode,
                        seq_lookup, res_cnt, scfg)
            for h in th.unsrt:
                if h.seqidx in id_lengths:
                    h.target_len = id_lengths[h.seqidx]
            th.sort_by_seqidx_and_alipos()
            th.remove_duplicates(pli.use_bit_cutoffs)
            th.sort_by_sortkey()
        if stats is not None and args.splice:
            stats["splice_s"] = stats.get("splice_s", 0.0) \
                + time.time() - t_splice

        with phase("cli.output"):
            pli.n_output = pli.pos_output = 0
            for h in th.hit:
                if h.flags & (IS_REPORTED | IS_INCLUDED):
                    pli.n_output += 1
                    for d in h.dcl:
                        pli.pos_output += 1 + abs(d.jali - d.iali)
            ofp.write(th.targets_text(pli, textw))
            ofp.write("\n\n")
            ofp.write(th.domains_text(pli, textw))
            ofp.write("\n\n")
            if tblfp:
                tblfp.write(th.tabular_targets_text(hmm.name, hmm.acc, pli,
                                                    nquery == 1))
            if fstblfp:
                fstblfp.write(th.tabular_frameshifts_text(
                    hmm.name, hmm.acc, pli, nquery == 1))
            if extblfp:
                extblfp.write(th.tabular_exons_text(
                    hmm.name, hmm.acc, pli, nquery == 1,
                    node_info=args.nodeinfo))
            ofp.write(statistics_text(pli, time.time() - t0))
            ofp.write("//\n")
        if stats is not None:
            stats["rescore_host_items"] = \
                stats.get("rescore_host_items", 0) + pli.ddef.host_fills
    return finish()


def _windows(args, pli, om, id_lengths):
    """The window stream with the database bookkeeping of the serial
    path: yields (window, seqid_for_hits, nres_at), nres_at being the
    serial stream's residue count as of this window, which the deferred
    domain keep-filter reads (ref p7_pipeline.c:1230-1249)."""
    db_started = args.restrictdb_stkey is None
    db_seqs_done = 0
    ctx = int(os.environ.get("BATH_WINDOW_CONTEXT", 0)) \
        or om.max_length * 3
    for window, is_last in read_windows(args.dbfile, context=ctx,
                                        block_length=pli.block_length):
        if not db_started:
            if window.name == args.restrictdb_stkey:
                db_started = True
            else:
                continue
        if args.restrictdb_n > 0 and db_seqs_done >= args.restrictdb_n:
            break
        if is_last:
            db_seqs_done += 1
        if window.n < 15:
            if is_last:
                id_lengths[window.idx] = window.start + window.n - 1
                pli.nseqs += 1
            continue
        window.L = window.n
        seqid_for_hits = pli.nseqs
        if pli.strands != C.STRAND_BOTTOMONLY:
            pli.nres += window.W
        if pli.strands != C.STRAND_TOPONLY:
            pli.nres += window.W
        yield window, seqid_for_hits, pli.nres
        if is_last:
            id_lengths[window.idx] = window.start + window.n - 1
            pli.nseqs += 1


def _window_pool(ncpu, wctx, specs, th, hit_windows, stats, results=None):
    """``--backend numpy --cpu N`` (ref: the JAX package's forked
    worker pool, thread_loop): N workers, one window each at a time;
    the results are taken in window order, so output is byte-identical
    to serial.  <stats> gets the pool's start and its workers' reports
    (``ready`` and ``report`` in ``parallel/pool.py``); <results>, a
    list under ``--hosts``, gets (tid, hits, hit windows) a window."""
    pli = wctx["pli"]
    # N workers share the machine: cap each worker's OpenMP team so
    # the native batch kernels don't oversubscribe
    _wthreads = max(1, (os.cpu_count() or 1) // ncpu)
    task = by_name(_pool_task)
    with worker_pool(ncpu, task.__module__, "_WCTX", wctx,
                     initializer=set_native_threads,
                     initargs=(_wthreads,), stats=stats) as pool:
        ready([pool], stats)
        for _tid, hits, hws, deltas in imap(pool, task, specs,
                                            depth=4 * ncpu):
            th.unsrt.extend(hits)
            hit_windows.extend(hws)
            if results is not None:
                results.append((_tid, hits, hws))
            for f, v in deltas.items():
                setattr(pli, f, getattr(pli, f) + v)


def _hybrid(args, ncpu, wctx, cascade, spec_iter, th, hit_windows,
            stats):
    """``--backend torch --cpu N`` (ref: bathsearch.c thread_loop
    :1118-1291, and the JAX package's hybrid): N workers run the host
    pipeline per window, and this process takes the windows they have
    no room for into the chunked device cascade.  Worker and device
    results arrive in any order; they are merged in stream (tid) order,
    so bytes equal the serial loop whatever the split.  <stats> gets
    the split, ``hybrid_pool`` and ``hybrid_main`` windows, the pool's
    start and its workers' reports (``parallel/pool.py``)."""
    pli, om, gm, om_fs3, om_fs5, gm_fs5, data, bg, gcode = (
        wctx[k] for k in ("pli", "om", "gm", "om_fs3", "om_fs5",
                          "gm_fs5", "data", "bg", "gcode"))
    require_init = wctx["require_init"]
    results: list = []
    # N full workers (the reference's thread_loop also keeps its reader
    # thread out of the count, bathsearch.c:183); the cascade main is a
    # bonus consumer that only takes windows the saturated workers
    # cannot
    nworkers = max(1, ncpu)
    _wthreads = max(1, (os.cpu_count() or 1) // nworkers)
    # main's own OpenMP share; the caller's team size comes back when
    # the hybrid ends
    threads = set_native_threads(_wthreads)
    # small chunks: the main must return to the submission loop between
    # windows or the saturated workers starve during a batched flush;
    # every flush's downstream goes to the device, as in the serial
    # torch drive
    CHUNK_ORFS = 4096
    chunk: list = []
    staged: list = []
    pending_orfs = 0

    def _down_flush():
        flush_downstream(staged, cascade, pli, om, gm,
                         om_fs3, om_fs5, gm_fs5, data, bg,
                         th, gcode, hit_windows,
                         use_device=True)
        for e in staged:
            results.append(
                (e.tid, list(e.hits.unsrt),
                 hit_windows[e.win_start:e.win_end]))
        staged.clear()

    def _take(spec):
        """Main-side window: into the device cascade chunk."""
        nonlocal pending_orfs
        _tid, window, seqid_for_hits, nres_at = spec
        if pli.strands != C.STRAND_BOTTOMONLY:
            orfs = extract_orfs(
                gcode, window.dsq, minlen=args.minlen,
                require_initiator=require_init)
            chunk.append(ChunkEntry(window, seqid_for_hits,
                                    C.NOCOMPLEMENT, orfs,
                                    tid=_tid,
                                    nres_at=nres_at))
            pending_orfs += len(orfs)
        if pli.strands != C.STRAND_TOPONLY:
            rc = window.reverse_complement()
            orfs = extract_orfs(
                gcode, rc.dsq, minlen=args.minlen,
                is_revcomp=True,
                require_initiator=require_init)
            chunk.append(ChunkEntry(rc, seqid_for_hits,
                                    C.COMPLEMENT, orfs,
                                    tid=_tid,
                                    nres_at=nres_at))
            pending_orfs += len(orfs)
        if pending_orfs >= CHUNK_ORFS:
            staged.extend(flush_gates(chunk, cascade, pli,
                                      om, data, bg,
                                      hit_windows))
            pending_orfs = 0
            _down_flush()

    def _collect(res):
        _tid, hits, hws, deltas = res
        results.append((_tid, hits, hws))
        for f, v in deltas.items():
            setattr(pli, f, getattr(pli, f) + v)

    pend: deque = deque()
    MAXQ = int(os.environ.get("BATH_HYBRID_MAXQ",
                              3 * nworkers))
    n_main = n_pool = 0
    # Main-compute policy (BATH_HYBRID_MAIN=auto|0|1): the cascade main
    # only takes windows when the host has a core to spare (nworkers <
    # cores); --cpu <cores> therefore matches the pool, --cpu with
    # headroom (or =1 forced) adds the device stream
    hmain = os.environ.get("BATH_HYBRID_MAIN", "auto")
    take_ok = (nworkers < (os.cpu_count() or 1)
               if hmain == "auto" else hmain != "0")
    done_stream = False
    final_done = False
    task = by_name(_pool_task)
    try:
        with worker_pool(nworkers, task.__module__, "_WCTX", wctx,
                         initializer=set_native_threads,
                         initargs=(_wthreads,), stats=stats) as pool:
            ready([pool], stats)
            while True:
                while pend and pend[0].done():
                    _collect(pend.popleft().result())
                if not done_stream:
                    spec = next(spec_iter, None)
                    if spec is None:
                        done_stream = True
                    elif len(pend) < MAXQ:
                        # keep the workers saturated first
                        pend.append(pool.submit(task, spec))
                        n_pool += 1
                    elif take_ok:
                        # overflow: the device cascade's share
                        _take(spec)
                        n_main += 1
                    else:
                        # host saturated: hold the spec until a worker
                        # slot frees
                        while len(pend) >= MAXQ:
                            wait([pend[0]], 0.02)
                            while pend and pend[0].done():
                                _collect(pend.popleft().result())
                        pend.append(pool.submit(task, spec))
                        n_pool += 1
                    continue
                if not final_done:
                    if chunk:
                        staged.extend(flush_gates(
                            chunk, cascade, pli, om, data,
                            bg, hit_windows))
                    _down_flush()
                    final_done = True
                if not pend:
                    break
                wait([pend[0]], 0.05)
    finally:
        set_native_threads(threads)
    if stats is not None:
        stats["hybrid_pool"] = stats.get("hybrid_pool", 0) + n_pool
        stats["hybrid_main"] = stats.get("hybrid_main", 0) + n_main
    # worker/device results interleave by completion; rebuild the
    # serial stream (tid) order.  sort is stable, so a tid's entries
    # (forward then revcomp) keep their order.
    results.sort(key=lambda r: r[0])
    th.unsrt = [h for _, hs, _ in results for h in hs]
    hit_windows[:] = [w for _, _, hws in results for w in hws]


def main():
    try:
        sys.exit(run())
    except (NotImplementedError, ValueError, KeyError, OSError) as e:
        print(f"Error: {e}", file=sys.stderr)
        sys.exit(1)
    finally:
        # the pools' server outlives them (parallel/pool.py); leave
        # the process group of --hosts
        stop_servers()
        hosts.shutdown()


if __name__ == "__main__":
    main()
