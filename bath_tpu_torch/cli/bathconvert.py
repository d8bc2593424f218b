"""bathconvert: convert HMMER or older BATH HMM files to the current
BATH3/f format, computing frameshift calibration when missing
(ref: bathconvert.c main :63-210).

``--backend torch`` (the default) computes the missing frameshift taus
of all models in one device-batched pass
(``evalues_device.convert_fs_taus_device``: the fs3 gate on the GPU, fs5
in the native host library on threads beside it; ``--device cpu`` runs
the gate's plain PyTorch version), ``--backend numpy`` the serial host
loop.  Both draw the same DNA from the one shared RNG stream.  Without a
CUDA device the torch backend raises unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
import time

from .. import constants as C
from ..bg import Background
from ..codontable import CodonTable
from ..evalues import fs_tau, mean_match_relative_entropy
from ..gencode import GeneticCode
from ..hmmfile import read_hmms, write_hmm
from ..ops.reference.fwdback_fs import fs_oprofile_convert
from ..profile import profile_config_fs
from ..rng import Randomness

FSPROB_DEFAULT = 0.01      # ref: hmmer.h p7P_FSPROB


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bathconvert",
        description="convert HMMER or older BATH formatted HMM to "
                    "current BATH format (bath_tpu_torch)")
    p.add_argument("hmmfile_out")
    p.add_argument("hmmfile_in")
    p.add_argument("--backend", choices=("torch", "numpy"),
                   default="torch",
                   help="fs-tau calibration backend: torch batch-runs "
                        "the simulations of all models on the device; "
                        "numpy: the serial host loop")
    p.add_argument("--device", default="cuda",
                   help="torch device of the calibration (cuda, cuda:N, "
                        "or cpu for the gate's plain version)")
    p.add_argument("--ct", type=int, default=None,
                   help="use alt genetic code of NCBI transl table <n>")
    return p


def main(argv=None, stats=None) -> int:
    """The CLI.  <stats>: optional dict the device calibration adds its
    stage walls and counts to (``evalues_device``)."""
    args = build_parser().parse_args(argv)
    t0 = time.time()
    print("# bathconvert :: convert HMMER or older BATH formatted HMM "
          "to current BATH format")
    print(f"# input HMM file:                   {args.hmmfile_in}")
    print(f"# output HMM file:                  {args.hmmfile_out}")
    print("# %-6s %-20s %5s %5s %9s %8s %6s %s"
          % ("idx", "name", "nseq", "mlen", "codon_tbl", "eff_nseq",
             "re/pos", "description"))
    print("# %-6s %-20s %5s %5s %9s %8s %6s %s"
          % ("------", "-" * 20, "-----", "-----", "---------",
             "--------", "------", "-----------"))

    bg = Background()
    r = Randomness(42)
    idx = 0
    hmms = []
    fs_items = []                 # (hmm, ct) needing fs calibration
    for hmm in read_hmms(args.hmmfile_in):
        if hmm.abc.kind != "amino":
            print(f"Invalid alphabet type in {args.hmmfile_in}; "
                  "expected amino acid", file=sys.stderr)
            return 1
        ct = args.ct if args.ct is not None else (hmm.ct or 1)
        hmm.fsprob = FSPROB_DEFAULT
        needs_fs = ((args.ct is not None and ct != hmm.ct)
                    or hmm.evparam[C.EV_FTAUFS3] == C.EVPARAM_UNSET
                    or hmm.evparam[C.EV_FTAUFS5] == C.EVPARAM_UNSET)
        hmm.fs = True
        hmm.ct = ct
        hmms.append(hmm)
        if needs_fs:
            fs_items.append((hmm, ct))
    if fs_items and args.backend == "torch":
        from ..evalues_device import convert_fs_taus_device
        convert_fs_taus_device(fs_items, r, bg, device=args.device,
                               stats=stats)
    else:
        for hmm, ct in fs_items:
            gcode = GeneticCode.create(ct)
            gcode.set_initiator_any()
            tbl = CodonTable(gcode)
            lam = float(hmm.evparam[C.EV_FLAMBDA])
            gm3 = profile_config_fs(hmm, bg, gcode, 3, 100)
            om3 = fs_oprofile_convert(gm3)
            hmm.evparam[C.EV_FTAUFS3] = fs_tau(
                r, om3, tbl, bg, 100, 200, lam, 0.04)
            gm5 = profile_config_fs(hmm, bg, gcode, 5, 100)
            om5 = fs_oprofile_convert(gm5)
            hmm.evparam[C.EV_FTAUFS5] = fs_tau(
                r, om5, tbl, bg, 100, 200, lam, 0.04)
    with open(args.hmmfile_out, "w") as ofp:
        for hmm in hmms:
            if hmm.max_length <= 0:
                hmm.set_max_length()
            idx += 1
            entropy = mean_match_relative_entropy(hmm, bg)
            print("  %-6d %-20s %5d %5d %9d %8.2f %6.3f %s"
                  % (idx, hmm.name, hmm.nseq, hmm.M, hmm.ct,
                     hmm.eff_nseq, entropy, hmm.desc or ""))
            write_hmm(ofp, hmm)
    if idx == 0:
        print(f"HMM file {args.hmmfile_in} is empty or misformatted",
              file=sys.stderr)
        return 1
    print(f"# CPU time: {time.time() - t0:.2f}u")
    return 0


def cli_entry():
    from ._io import cli_main
    cli_main(main)


if __name__ == "__main__":
    cli_entry()
