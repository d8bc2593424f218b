"""bathfetch: retrieve profile HMM(s) from a file
(ref: bathfetch.c main, onefetch :~300, multifetch :240,
create_ssi_index :166).
"""

from __future__ import annotations

import argparse
import sys

from ..ssi import fetch_hmm_text, index_hmm_file, load_index


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bathfetch",
        description="retrieve profile HMM(s) from a file "
                    "(bath_tpu_torch)")
    p.add_argument("hmmfile")
    p.add_argument("key", nargs="?", default=None,
                   help="name/accession of HMM to retrieve "
                        "(or keyfile with -f)")
    p.add_argument("-f", action="store_true",
                   help="second cmdline arg is a file of names to retrieve")
    p.add_argument("-o", dest="outfile", default=None,
                   help="output HMM to file <f> instead of stdout")
    p.add_argument("-O", dest="keynamed", action="store_true",
                   help="output HMM to file named <key>")
    p.add_argument("--index", action="store_true",
                   help="index the <hmmfile>, creating <hmmfile>.ssi")
    p.add_argument("--ct", type=int, default=None,
                   help="use alt genetic code of NCBI transl table "
                        "<n> (recalibrates frameshift taus)")
    return p


def _fetch_text(hmmfile: str, key: str, ct: int | None) -> str:
    """Fetch one HMM; with --ct (or missing fs taus) re-derive the
    frameshift calibration under the requested genetic code
    (ref: bathfetch.c :296-330)."""
    text = fetch_hmm_text(hmmfile, key)
    if ct is None:
        return text
    import io

    from .. import constants as C
    from ..bg import Background
    from ..codontable import CodonTable
    from ..evalues import fs_tau
    from ..gencode import GeneticCode
    from ..hmmfile import read_hmms_text, write_hmm
    from ..ops.reference.fwdback_fs import fs_oprofile_convert
    from ..profile import profile_config_fs
    from ..rng import Randomness

    hmm = read_hmms_text(text)[0]
    hmm.fs = True
    hmm.fsprob = 0.01
    if (ct != hmm.ct
            or hmm.evparam[C.EV_FTAUFS3] == C.EVPARAM_UNSET
            or hmm.evparam[C.EV_FTAUFS5] == C.EVPARAM_UNSET):
        hmm.ct = ct
        bg = Background()
        r = Randomness(42)
        gcode = GeneticCode.create(ct)
        gcode.set_initiator_any()
        tbl = CodonTable(gcode)
        lam = float(hmm.evparam[C.EV_FLAMBDA])
        for nc, slot in ((3, C.EV_FTAUFS3), (5, C.EV_FTAUFS5)):
            om = fs_oprofile_convert(
                profile_config_fs(hmm, bg, gcode, nc, 100))
            hmm.evparam[slot] = fs_tau(r, om, tbl, bg, 100, 200,
                                       lam, 0.04)
    hmm.ct = ct
    buf = io.StringIO()
    write_hmm(buf, hmm)
    return buf.getvalue()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.index and args.hmmfile == "-":
        print("Can't use - with --index", file=sys.stderr)
        return 1
    if args.hmmfile == "-" and args.f and args.key == "-":
        print("Either <hmmfile> or <keyfile> may be '-' (stdin), "
              "but not both", file=sys.stderr)
        return 1
    if args.hmmfile == "-":
        from ._io import spool_stdin
        args.hmmfile = spool_stdin(".bhmm")
    if args.f and args.key == "-":
        from ._io import spool_stdin
        args.key = spool_stdin(".key")
    if args.index:
        out = index_hmm_file(args.hmmfile)
        ix = load_index(args.hmmfile)
        print(f"Indexed {len(ix['keys'])} HMMs ({out}).")
        return 0
    if args.key is None:
        print("a key (or -f keyfile, or --index) is required",
              file=sys.stderr)
        return 1
    keys = [args.key]
    if args.f:
        with open(args.key) as fh:
            keys = [ln.split()[0] for ln in fh if ln.strip()]
    if args.keynamed:
        for k in keys:
            with open(k, "w") as fh:
                fh.write(_fetch_text(args.hmmfile, k, args.ct))
        return 0
    ofp = open(args.outfile, "w") if args.outfile else sys.stdout
    for k in keys:
        ofp.write(_fetch_text(args.hmmfile, k, args.ct))
    if ofp is not sys.stdout:
        ofp.close()
    return 0


def cli_entry():
    from ._io import cli_main
    cli_main(main)


if __name__ == "__main__":
    cli_entry()
