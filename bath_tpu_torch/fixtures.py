"""Seeded query and genome fixtures, made with ``bath_tpu`` itself.

The query is a protein of M residues drawn from the background
frequencies, built into a single-sequence profile HMM (BLOSUM62, as
``bathsearch`` builds a sequence query) and calibrated.  The genome is
uniform random DNA with reverse-translated copies of the query carrying
about 30% amino-acid substitutions: half on the minus strand, every
eighth site (the last ones) an ORF that holds two copies (a two-domain
hit), and one copy placed across the first window boundary.

The CPU tests use a small fixture (M = 120, 300 kb); ``chip_smoke.py``
searches a 5 Mb genome (one bacterial genome) with M = 400 (a
Pfam-sized profile) and 40 embeds.  Files are written once per
parameter set under ``build/bath_tpu_torch/fixtures/`` and reused.
"""

from __future__ import annotations

import io
import json
import os
import tempfile
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from bath_tpu import constants as C
from bath_tpu.bg import Background
from bath_tpu.builder import BuilderConfig, single_build
from bath_tpu.gencode import GeneticCode
from bath_tpu.hmmfile import write_hmm

FIXTURE_DIR = Path(__file__).resolve().parents[1] / "build" / \
    "bath_tpu_torch" / "fixtures"
NT = "ACGT"
SUBST_RATE = 0.30
LINKER = 12                  # residues between the copies of a 2-domain ORF


@dataclass
class Fixture:
    hmm_path: str
    fasta_path: str
    # (first, last) 1-based plus-strand nt coordinates of every copy
    embeds: list


def _write_atomic(path: Path, text: str) -> None:
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    with os.fdopen(fd, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def make_query(M: int, rng: np.random.Generator, calibrate: bool = True):
    """(hmm, query residues): a background-drawn protein built into a
    single-sequence profile (standard search; no frameshift taus)."""
    f = Background().f[:20].astype(np.float64)
    q = rng.choice(20, size=M, p=f / f.sum()).astype(np.uint8)
    hmm = single_build(q, f"synth{M}", BuilderConfig(fs=False),
                       do_calibrate=calibrate)
    return hmm, q


def _codons():
    gcode = GeneticCode.create(1)
    table: dict[int, list[str]] = {}
    for a in range(4):
        for b in range(4):
            for c in range(4):
                table.setdefault(gcode.translate_codon(a, b, c),
                                 []).append(NT[a] + NT[b] + NT[c])
    return table


def _mutate(q: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    f = Background().f[:20].astype(np.float64)
    aa = q.copy()
    hit = rng.random(len(aa)) < SUBST_RATE
    aa[hit] = rng.choice(20, size=int(hit.sum()), p=f / f.sum())
    return aa


def make_genome(q: np.ndarray, genome_len: int, n_embeds: int,
                rng: np.random.Generator,
                block_length: int = C.BLOCK_LENGTH_DEFAULT):
    """(DNA string, [(first, last), ...] 1-based coordinates of each
    copy) of a random genome carrying <n_embeds> mutated copies of the
    protein <q>."""
    codons = _codons()
    n_double = n_embeds // 8
    sites = n_embeds - n_double           # the last n_double hold two
    seq = np.frombuffer(NT.encode(), np.uint8)[
        rng.integers(0, 4, genome_len)]
    spacing = genome_len // (sites + 1)
    embeds = []
    for s in range(sites):
        ncopy = 2 if s >= sites - n_double else 1
        parts, spans = [], []
        pos = 0
        for c in range(ncopy):
            if c:
                link = rng.integers(0, 20, LINKER)
                parts.append(link)
                pos += LINKER
            aa = _mutate(q, rng)
            spans.append((pos * 3, (pos + len(aa)) * 3))
            parts.append(aa)
            pos += len(aa)
        dna = "".join(codons[int(a)][rng.integers(len(codons[int(a)]))]
                      for a in np.concatenate(parts))
        minus = s % 2 == 1
        if minus:
            dna = dna.translate(str.maketrans("ACGT", "TGCA"))[::-1]
            spans = [(len(dna) - e, len(dna) - b) for b, e in spans]
        # site 1 straddles the first window boundary, if there is one
        start = spacing * (s + 1)
        if s == 1 and genome_len > block_length + len(dna):
            start = block_length - len(dna) // 2
        seq[start:start + len(dna)] = np.frombuffer(dna.encode(), np.uint8)
        embeds += [(start + b + 1, start + e) for b, e in spans]
    return seq.tobytes().decode(), sorted(embeds)


def write_fixture(M: int, genome_len: int, n_embeds: int, seed: int,
                  directory: Path | None = None,
                  calibrate: bool = True) -> Fixture:
    """The fixture for these parameters, written on first use."""
    d = Path(directory or FIXTURE_DIR)
    d.mkdir(parents=True, exist_ok=True)
    stem = d / f"synth-M{M}-L{genome_len}-E{n_embeds}-s{seed}"
    meta = stem.with_suffix(".json")
    hmm_path, fa_path = stem.with_suffix(".bhmm"), stem.with_suffix(".fa")
    if meta.exists():
        return Fixture(str(hmm_path), str(fa_path),
                       json.loads(meta.read_text()))
    rng = np.random.default_rng(seed)
    hmm, q = make_query(M, rng, calibrate)
    dna, embeds = make_genome(q, genome_len, n_embeds, rng)
    buf = io.StringIO()
    write_hmm(buf, hmm)
    _write_atomic(hmm_path, buf.getvalue())
    body = "\n".join(dna[i:i + 80] for i in range(0, len(dna), 80))
    _write_atomic(fa_path, f">genome{seed}\n{body}\n")
    fx = Fixture(str(hmm_path), str(fa_path), [list(e) for e in embeds])
    _write_atomic(meta, json.dumps(fx.embeds))
    return fx


def embeds_found(tblout_path: str, fx: Fixture) -> int:
    """Embedded copies that a reported hit's alignment overlaps, read
    from a ``--tblout`` table."""
    spans = []
    with open(tblout_path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            a, b = (int(x) for x in line.split()[9:11])
            spans.append((min(a, b), max(a, b)))
    return sum(any(a <= e and b >= s for a, b in spans)
               for s, e in fx.embeds)


def search_profile(hmm):
    """The OProfile a standard search configures for <hmm>."""
    from bath_tpu.oprofile import oprofile_convert
    from bath_tpu.profile import profile_config
    return oprofile_convert(profile_config(hmm, Background(), L=100))


def kernel_batch(q: np.ndarray, B: int, Lmax: int,
                 rng: np.random.Generator):
    """(dsq [B, Lmax] int8 padded with 28, lens [B] int32): ragged random
    ORFs of 1..Lmax residues (one of length 1, one of Lmax); every
    second item long enough carries one mutated copy of <q> and every
    fourth two, so the batch holds single- and two-domain homologs."""
    f = Background().f[:20].astype(np.float64)
    lens = rng.integers(1, Lmax + 1, B).astype(np.int32)
    lens[0], lens[-1] = 1, Lmax
    dsq = np.full((B, Lmax), 28, np.int8)
    for b, L in enumerate(lens):
        dsq[b, :L] = rng.choice(20, size=L, p=f / f.sum())
        ncopy = 0 if b % 2 else (2 if b % 4 == 0 else 1)
        for c in range(ncopy):
            if L >= (c + 1) * len(q):
                k = c * len(q) + int(rng.integers(0, L // (c + 1)
                                                  - len(q) + 1))
                dsq[b, k:k + len(q)] = _mutate(q, rng)
    return dsq, lens


def sample_orfs(fasta_path: str, n: int, seed: int,
                min_len: int = 1) -> list[np.ndarray]:
    """<n> ORFs (int8 residues) drawn at random from the six-frame ORFs
    of a genome, as bathsearch extracts them (minimum length 20)."""
    from bath_tpu.gencode import extract_orfs
    from bath_tpu.sequence import read_windows
    gcode = GeneticCode.create(1)
    gcode.set_initiator_any()
    pool = []
    for window, _ in read_windows(fasta_path, context=0,
                                  block_length=C.BLOCK_LENGTH_DEFAULT):
        for w, rev in ((window, False), (window.reverse_complement(), True)):
            pool += [np.asarray(o.dsq, np.int8)
                     for o in extract_orfs(gcode, w.dsq, minlen=20,
                                           is_revcomp=rev)
                     if o.n >= min_len]
    rng = np.random.default_rng(seed)
    return [pool[i] for i in rng.choice(len(pool), size=n,
                                        replace=len(pool) < n)]
