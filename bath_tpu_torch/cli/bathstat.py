"""bathstat: display summary statistics for a profile file
(ref: bathstat.c main :26+).
"""

from __future__ import annotations

import argparse

from ..bg import Background
from ..evalues import mean_match_relative_entropy
from ..hmmfile import read_hmms


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="bathstat",
        description="display summary statistics for a profile file "
                    "(bath_tpu_torch)")
    p.add_argument("hmmfile")
    args = p.parse_args(argv)
    if args.hmmfile == "-":
        from ._io import spool_stdin
        args.hmmfile = spool_stdin(".bhmm")

    print("# bathstat :: display summary statistics for a profile file")
    print("#")
    print("# %-6s %-20s %5s %5s %9s %8s %6s %s"
          % ("idx", "name", "nseq", "mlen", "codon_tbl", "eff_nseq",
             "re/pos", "description"))
    print("# %-6s %-20s %5s %5s %9s %8s %6s %s"
          % ("------", "-" * 20, "-----", "-----", "---------",
             "--------", "------", "-----------"))
    bg = Background()
    for idx, hmm in enumerate(read_hmms(args.hmmfile), 1):
        entropy = mean_match_relative_entropy(hmm, bg)
        print("  %-6d %-20s %5d %5d %9d %8.2f %6.3f %s"
              % (idx, hmm.name, hmm.nseq, hmm.M, hmm.ct, hmm.eff_nseq,
                 entropy, hmm.desc or ""))
    return 0


def cli_entry():
    from ._io import cli_main
    cli_main(main)


if __name__ == "__main__":
    cli_entry()
