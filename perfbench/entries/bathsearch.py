"""A ``bathsearch`` job: one call of the port's CLI,
``bath_tpu_torch.cli.bathsearch.run``, as a user runs it: the
configuration's query file against the cell's genome, ``-o`` and
``--tblout`` written under the run's directory.

The query file is the configuration's fixed asset, kept compressed
under ``perfbench/profiles/``; the genome comes from the run's seed
(``perfbench/genome.py``).  Nothing here makes a profile with the
program.
"""

from __future__ import annotations

import json
import lzma
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from .. import genome
from ..reference.translate import AMINO


@dataclass
class Inputs:
    query: Path
    genome: Path
    dna: str                # the genome, for the reference
    copies: dict            # {profile name: [(first, last)]}
    warm: Path              # the warm-up job's genome
    genome_nt: int
    shifted: dict           # the copies made with a frameshift, as copies


def seed_rng(seed: int, *tail: int):
    """The generator of <seed> (any whole number) and <tail>."""
    return np.random.default_rng([seed % (1 << 64), *tail])


def prepare(root: Path, config: dict, cell: dict, rundir: Path,
            seed: int) -> Inputs:
    query = rundir / "query.bhmm"
    query.write_bytes(lzma.decompress((root / config["profiles"])
                                      .read_bytes()))
    prot = json.loads((root / config["proteins"]).read_text())["proteins"]
    names = list(prot)
    proteins = [np.array([AMINO.index(c) for c in s], np.uint8)
                for s in prot.values()]
    traffic = cell["traffic"]
    shifted: dict = {}
    dna, copies = genome.make(traffic, config["genome"], names, proteins,
                              traffic["genome_nt"], seed_rng(seed), shifted)
    path = rundir / "genome.fa"
    genome.write_fasta(path, f"genome{seed}", dna)
    wdna, _ = genome.make(traffic, config["genome"], names, proteins,
                          cell["warmup_nt"], seed_rng(seed, 1))
    warm = rundir / "warmup.fa"
    genome.write_fasta(warm, f"warmup{seed}", wdna)
    return Inputs(query, path, dna, copies, warm, traffic["genome_nt"],
                  shifted)


def argv(config: dict, cell: dict, inputs: Inputs, target: Path,
         out: Path, tbl: Path, device: str) -> list:
    return ["--backend", "torch", "--device", device, "--cpu", "0",
            *config["search_args"], *cell.get("args", []),
            "-o", str(out), "--tblout", str(tbl), str(inputs.query),
            str(target)]


def run(args: list, stats: dict) -> int:
    from bath_tpu_torch.cli import bathsearch
    return bathsearch.run(args, stats=stats)
