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
Its output is byte-identical to ``--backend numpy``, which runs
``bath_tpu.cli.bathsearch`` unchanged.  ``--device`` defaults to
``cuda``, and a missing CUDA device is an error; the CPU is used only
when ``--device cpu`` is given, which runs the kernels' plain PyTorch
versions.  Modes whose device stages are not ported yet are refused
with the ROADMAP.md item that ports them.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from bath_tpu import constants as C
from bath_tpu.bg import Background
from bath_tpu.cli.bathsearch import (build_parser, load_queries,
                                     make_pipeline, output_header)
from bath_tpu.device_pipeline import (ChunkEntry, flush_downstream,
                                      flush_gates)
from bath_tpu.gencode import GeneticCode, extract_orfs
from bath_tpu.oprofile import oprofile_convert
from bath_tpu.ops.reference.fwdback_fs import fs_oprofile_convert
from bath_tpu.pipeline import statistics_text
from bath_tpu.profile import profile_config, profile_config_fs
from bath_tpu.scoredata import score_data_create
from bath_tpu.sequence import read_windows
from bath_tpu.tophits import IS_INCLUDED, IS_REPORTED, TopHits, tabular_tail

from ..device_pipeline import TorchCascade, not_ported

# ORFs per gate flush: the host filters run per chunk, and every flush's
# F3 candidates and survivors go to the device together
CHUNK_ORFS = 65536


def backend_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--backend", default="torch", choices=["torch", "numpy"],
                   help="torch: the device cascade of bath_tpu_torch; "
                        "numpy: bath_tpu's host path (byte-identical)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the cascade (cuda, cuda:N, or "
                        "cpu for the kernels' plain versions)")
    return p


def _unported(args) -> str | None:
    """The first requested mode this backend cannot run yet."""
    if args.mesh and args.mesh > 1:
        return not_ported("--mesh", 5)
    if args.hosts and args.hosts > 1:
        return not_ported("--hosts", 5)
    if int(args.cpu or 0) > 1:
        return not_ported("--cpu N>1", 5)
    if args.splice:
        return not_ported("--splice", 6)
    return None


def require_native():
    """The native host library; the torch backend runs the bias filter,
    and the integer filters unless BATH_MSV_DEVICE=1/BATH_VIT_DEVICE=1
    send them to the device, there, and refuses to fall back to the
    pure-numpy filters."""
    from bath_tpu.native import _SO, get_lib
    lib = get_lib()
    if lib is None:
        raise RuntimeError(
            f"the native host library ({_SO}) failed to build or load; "
            "the torch backend runs the bias filter and, by default, the "
            "integer filters (MSV/SSV, ViterbiFilter) in it")
    return lib


def run(argv=None, stats=None) -> int:
    """The CLI.  <stats>: optional dict the cascade adds its device
    counts to (see TorchCascade)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    pre, rest = backend_parser().parse_known_args(argv)
    if pre.backend == "numpy":
        from bath_tpu.cli.bathsearch import run as run_numpy
        return run_numpy(rest + ["--backend", "numpy"])
    args = build_parser().parse_args(rest)
    why = _unported(args)
    if why:
        raise NotImplementedError(why)
    device = torch.device(pre.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--backend torch needs a CUDA device (none is "
                           "available); --device cpu runs the plain "
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
    for opt in ("exontblout", "min_intron", "max_intron"):
        if f"--{opt}" in rest:
            print(f"Failed to parse command line: Option --{opt} "
                  "requires (or has no effect without) option "
                  "--splice", file=sys.stderr)
            return 1
    if args.queryfile == "-":
        from bath_tpu.cli._io import spool_stdin
        args.queryfile = spool_stdin(".bhmm")
    if args.dbfile == "-":
        from bath_tpu.cli._io import spool_stdin
        args.dbfile = spool_stdin(".fa")
    for path, what in ((args.queryfile, "query file"),
                       (args.dbfile, "target sequence database")):
        if not os.path.exists(path):
            print(f"Failed to open {what} {path} for reading",
                  file=sys.stderr)
            return 1

    ofp = open(args.outfile, "w") if args.outfile else sys.stdout
    tblfp = open(args.tblout, "w") if args.tblout else None
    fstblfp = open(args.fstblout, "w") if args.fstblout else None
    textw = 0 if args.notextw else args.textw
    gcode = GeneticCode.create(args.ct)
    if args.aug_only:
        gcode.set_initiator_only_aug()
    require_init = args.aug_only or args.init_any_codon
    if not require_init:
        gcode.set_initiator_any()
    output_header(ofp, args)

    nquery = 0
    for hmm in load_queries(args.queryfile, args):
        nquery += 1
        t0 = time.time()
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
        cascade = TorchCascade(om, om_fs3, device=device, stats=stats)

        def down_flush(chunk):
            staged = flush_gates(chunk, cascade, pli, om, data, bg,
                                 hit_windows)
            flush_downstream(staged, cascade, pli, om, gm, om_fs3, om_fs5,
                             gm_fs5, data, bg, th, gcode, hit_windows,
                             use_device=True)

        chunk: list = []
        pending_orfs = 0
        for tid, (window, seqid, nres_at) in enumerate(
                _windows(args, pli, om, id_lengths)):
            for comp in (C.NOCOMPLEMENT, C.COMPLEMENT):
                if comp == C.NOCOMPLEMENT \
                        and pli.strands == C.STRAND_BOTTOMONLY:
                    continue
                if comp == C.COMPLEMENT and pli.strands == C.STRAND_TOPONLY:
                    continue
                w = window if comp == C.NOCOMPLEMENT \
                    else window.reverse_complement()
                orfs = extract_orfs(gcode, w.dsq, minlen=args.minlen,
                                    is_revcomp=comp == C.COMPLEMENT,
                                    require_initiator=require_init)
                chunk.append(ChunkEntry(w, seqid, comp, orfs, tid=tid,
                                        nres_at=nres_at))
                pending_orfs += len(orfs)
            if pending_orfs >= CHUNK_ORFS:
                down_flush(chunk)
                pending_orfs = 0
        if chunk:
            down_flush(chunk)

        # E-values from the global residue count (ref: bathsearch.c
        # :869-884), then the serial path's sort/dedup/threshold
        if args.Z is not None:
            res_cnt = int(1000000 * args.Z)
            if pli.strands == C.STRAND_BOTH:
                res_cnt *= 2
        else:
            res_cnt = pli.nres
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
        ofp.write(statistics_text(pli, time.time() - t0))
        ofp.write("//\n")

    for fp in (tblfp, fstblfp):
        if fp:
            fp.write(tabular_tail("bathsearch", args.queryfile,
                                  args.dbfile, "bathsearch " + " ".join(argv)))
            fp.close()
    ofp.write("[ok]\n")
    if ofp is not sys.stdout:
        ofp.close()
    return 0


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


def main():
    try:
        sys.exit(run())
    except (NotImplementedError, ValueError, KeyError, OSError) as e:
        print(f"Error: {e}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
