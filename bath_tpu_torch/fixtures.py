"""Seeded query and genome fixtures, made with the package itself.

The query is a protein of M residues drawn from the background
frequencies, built into a single-sequence profile HMM (BLOSUM62, as
``bathsearch`` builds a sequence query) and calibrated.  The genome is
uniform random DNA with reverse-translated copies of the query carrying
about 30% amino-acid substitutions: half on the minus strand, every
eighth site (the last ones) an ORF that holds two copies (a two-domain
hit), and one copy placed across the first window boundary.

For ``--fs`` searches the query is built with frameshift calibration
(``BuilderConfig(fs=True)``: the ``.bhmm`` carries the fs3/fs5 taus,
the frameshift probability and the codon table), and <n_frameshift>
copies carry a 1-nt deletion or insertion near their middle,
alternating between the two.

The CPU tests use a small fixture (M = 120, 300 kb); ``chip_smoke.py``
searches a 5 Mb genome (one bacterial genome) with M = 400 (a
Pfam-sized profile) and 40 embeds, 16 of them frameshifted in its fs
drive.  Files are written once per parameter set under
``build/bath_tpu_torch/fixtures/`` and reused.

``write_multi_fixture`` makes the multi-query twin: one query file of
several seeded models and a genome with copies of some of them.
``write_msa_fixture`` makes the input of ``bathbuild`` (one Stockholm
file of alignments emitted from seeded models) and
``write_convert_input`` the input of ``bathconvert`` (a model file
stripped of its frameshift calibration).  ``write_splice_fixture``
makes the input of ``--splice``: a genome whose copies of the query
are genes split into exons by GT...AG introns.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import tempfile
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from . import constants as C
from .bg import Background
from .builder import BuilderConfig, single_build
from .gencode import GeneticCode
from .hmmfile import write_hmm

FIXTURE_DIR = Path(__file__).resolve().parents[1] / "build" / \
    "bath_tpu_torch" / "fixtures"
NT = "ACGT"
SUBST_RATE = 0.30
LINKER = 12                  # residues between the copies of a 2-domain ORF
INTRONS = (60, 2000)         # nt, the range of a spliced gene's introns
SHORT_EXON = 15              # residues of gene 0's first exon
CLOSE_GAP = 2000             # nt between the last two spliced genes


@dataclass
class Fixture:
    hmm_path: str
    fasta_path: str
    # (first, last) 1-based plus-strand nt coordinates of every copy
    embeds: list
    # the subset of <embeds> that carries a frameshift
    frameshifted: list = field(default_factory=list)


def _write_atomic(path: Path, text: str) -> None:
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    with os.fdopen(fd, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def make_query(M: int, rng: np.random.Generator, calibrate: bool = True,
               fs: bool = False):
    """(hmm, query residues): a background-drawn protein built into a
    single-sequence profile; <fs> adds the frameshift calibration that
    ``--fs``/``--fsonly`` need."""
    f = Background().f[:20].astype(np.float64)
    q = rng.choice(20, size=M, p=f / f.sum()).astype(np.uint8)
    hmm = single_build(q, f"synth{M}", BuilderConfig(fs=fs),
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


def frameshift_sites(sites: int, n_frameshift: int) -> set:
    """The <n_frameshift> site indices, evenly spread over <sites>,
    whose first copy carries a frameshift."""
    if n_frameshift <= 0:
        return set()
    if n_frameshift > sites:
        raise ValueError(f"{n_frameshift} frameshifts for {sites} sites")
    return {int(v) for v in np.linspace(0, sites - 1, n_frameshift)
            .round()}


def make_genome(q: np.ndarray, genome_len: int, n_embeds: int,
                rng: np.random.Generator,
                block_length: int = C.BLOCK_LENGTH_DEFAULT,
                n_frameshift: int = 0):
    """(DNA string, [(first, last), ...] 1-based coordinates of each
    copy, [(first, last), ...] of the frameshifted copies) of a random
    genome carrying <n_embeds> mutated copies of the protein <q>.
    <n_frameshift> sites get a 1-nt deletion (even count) or insertion
    (odd) inside the middle codon of their first copy."""
    codons = _codons()
    n_double = n_embeds // 8
    sites = n_embeds - n_double           # the last n_double hold two
    fs_sites = frameshift_sites(sites, n_frameshift)
    seq = np.frombuffer(NT.encode(), np.uint8)[
        rng.integers(0, 4, genome_len)]
    spacing = genome_len // (sites + 1)
    embeds, shifted = [], []
    n_shift = 0
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
        if s in fs_sites:
            # the middle codon's second nt of the first copy
            at = spans[0][0] + 3 * (len(q) // 2) + 1
            if n_shift % 2 == 0:
                dna = dna[:at] + dna[at + 1:]
                d = -1
            else:
                dna = dna[:at] + NT[int(rng.integers(0, 4))] + dna[at:]
                d = 1
            n_shift += 1
            spans = [(spans[0][0], spans[0][1] + d)] + \
                [(b + d, e + d) for b, e in spans[1:]]
        minus = s % 2 == 1
        if minus:
            dna = dna.translate(str.maketrans("ACGT", "TGCA"))[::-1]
            spans = [(len(dna) - e, len(dna) - b) for b, e in spans]
        # site 1 straddles the first window boundary, if there is one
        start = spacing * (s + 1)
        if s == 1 and genome_len > block_length + len(dna):
            start = block_length - len(dna) // 2
        seq[start:start + len(dna)] = np.frombuffer(dna.encode(), np.uint8)
        copies = [(start + b + 1, start + e) for b, e in spans]
        embeds += copies
        if s in fs_sites:
            shifted.append(copies[0])
    return seq.tobytes().decode(), sorted(embeds), sorted(shifted)


def write_fixture(M: int, genome_len: int, n_embeds: int, seed: int,
                  directory: Path | None = None,
                  calibrate: bool = True, fs: bool = False,
                  n_frameshift: int = 0) -> Fixture:
    """The fixture for these parameters, written on first use.  <fs>
    builds the query for frameshift search; <n_frameshift> copies carry
    a frameshift.  Both appear in the file stem (``-fs``, ``-F<K>``);
    the meta file of a fixture with frameshifts also lists them."""
    d = Path(directory or FIXTURE_DIR)
    d.mkdir(parents=True, exist_ok=True)
    stem = d / (f"synth-M{M}-L{genome_len}-E{n_embeds}-s{seed}"
                + ("-fs" if fs else "")
                + (f"-F{n_frameshift}" if n_frameshift else ""))
    meta = stem.with_suffix(".json")
    hmm_path, fa_path = stem.with_suffix(".bhmm"), stem.with_suffix(".fa")
    if meta.exists():
        m = json.loads(meta.read_text())
        if isinstance(m, dict):
            return Fixture(str(hmm_path), str(fa_path), m["embeds"],
                           m["frameshifted"])
        return Fixture(str(hmm_path), str(fa_path), m)
    rng = np.random.default_rng(seed)
    hmm, q = make_query(M, rng, calibrate, fs=fs)
    dna, embeds, shifted = make_genome(q, genome_len, n_embeds, rng,
                                       n_frameshift=n_frameshift)
    buf = io.StringIO()
    write_hmm(buf, hmm)
    _write_atomic(hmm_path, buf.getvalue())
    body = "\n".join(dna[i:i + 80] for i in range(0, len(dna), 80))
    _write_atomic(fa_path, f">genome{seed}\n{body}\n")
    fx = Fixture(str(hmm_path), str(fa_path), [list(e) for e in embeds],
                 [list(e) for e in shifted])
    _write_atomic(meta, json.dumps(
        {"embeds": fx.embeds, "frameshifted": fx.frameshifted}
        if n_frameshift else fx.embeds))
    return fx


@dataclass
class MultiFixture:
    hmm_path: str               # one query file holding every model
    fasta_path: str
    Ms: list                    # model lengths, file order
    names: list                 # model names, file order
    # {model index: [(first, last), ...]} 1-based plus-strand nt
    # coordinates of the copies of each embedded model
    embeds: dict
    # the subset of <embeds> that carries a frameshift
    frameshifted: dict = field(default_factory=dict)


def write_multi_fixture(Ms, genome_len: int, embedded, copies: int,
                        seed: int, directory: Path | None = None,
                        calibrate: bool = True, fs: bool = False,
                        device=None) -> MultiFixture:
    """A query file of len(<Ms>) seeded models (lengths <Ms>, named
    ``mq<i>-M<M>``) and one genome carrying <copies> mutated copies of
    each model whose index is in <embedded>, alternating strands, the
    first one across the first window boundary where the genome has
    one.  With <fs> the models are built for frameshift search and the
    first copy of each embedded model carries a 1-nt deletion or
    insertion in its middle codon, alternating.  With <device> the
    models are calibrated together by ``evalues_device`` on that torch
    device (the same MSV/Viterbi mus and fs5 tau as the host
    calibration, the f32 gates' taus within ~1e-5) instead of one by
    one on the host (the file's name says which).  Written on first use,
    as ``write_fixture``."""
    d = Path(directory or FIXTURE_DIR)
    d.mkdir(parents=True, exist_ok=True)
    tag = hashlib.sha256(repr((list(Ms), list(embedded))).encode()) \
        .hexdigest()[:10]
    stem = d / (f"multi-{len(Ms)}x{tag}-L{genome_len}-C{copies}-s{seed}"
                + ("-fs" if fs else "") + ("" if calibrate else "-nocal")
                + ("-devcal" if calibrate and device is not None else ""))
    meta = stem.with_suffix(".json")
    hmm_path, fa_path = stem.with_suffix(".bhmm"), stem.with_suffix(".fa")
    names = [f"mq{i}-M{M}" for i, M in enumerate(Ms)]
    if meta.exists():
        m = json.loads(meta.read_text())
        return MultiFixture(
            str(hmm_path), str(fa_path), list(Ms), names,
            {int(k): v for k, v in m["embeds"].items()},
            {int(k): v for k, v in m["frameshifted"].items()})
    rng = np.random.default_rng(seed)
    codons = _codons()
    buf = io.StringIO()
    hmms, proteins = [], []
    for name, M in zip(names, Ms):
        hmm, q = make_query(M, rng, calibrate and device is None, fs=fs)
        hmm.name = name
        hmms.append(hmm)
        proteins.append(q)
    if calibrate and device is not None:
        from .evalues import CalibrateConfig
        from .evalues_device import calibrate_many_device
        calibrate_many_device(hmms, CalibrateConfig(fs=fs), device=device)
    for hmm in hmms:
        write_hmm(buf, hmm)
    seq = np.frombuffer(NT.encode(), np.uint8)[
        rng.integers(0, 4, genome_len)]
    sites = [(g, c) for c in range(copies) for g in embedded]
    spacing = genome_len // (len(sites) + 1)
    embeds: dict = {int(g): [] for g in embedded}
    shifted: dict = {}
    for s, (g, c) in enumerate(sites):
        dna = "".join(codons[int(a)][rng.integers(len(codons[int(a)]))]
                      for a in _mutate(proteins[g], rng))
        if fs and c == 0:
            at = 3 * (len(proteins[g]) // 2) + 1
            dna = dna[:at] + dna[at + 1:] if s % 4 < 2 \
                else dna[:at] + NT[int(rng.integers(0, 4))] + dna[at:]
        if s % 2 == 1:
            dna = dna.translate(str.maketrans("ACGT", "TGCA"))[::-1]
        start = spacing * (s + 1)
        if s == 0 and genome_len > C.BLOCK_LENGTH_DEFAULT + len(dna):
            start = C.BLOCK_LENGTH_DEFAULT - len(dna) // 2
        if spacing < len(dna):
            raise ValueError(f"genome of {genome_len} nt too short for "
                             f"{len(sites)} copies")
        seq[start:start + len(dna)] = np.frombuffer(dna.encode(), np.uint8)
        embeds[int(g)].append([start + 1, start + len(dna)])
        if fs and c == 0:
            shifted[int(g)] = [embeds[int(g)][-1]]
    _write_atomic(hmm_path, buf.getvalue())
    dna = seq.tobytes().decode()
    body = "\n".join(dna[i:i + 80] for i in range(0, len(dna), 80))
    _write_atomic(fa_path, f">genome{seed}\n{body}\n")
    _write_atomic(meta, json.dumps({"embeds": embeds,
                                    "frameshifted": shifted}))
    return MultiFixture(str(hmm_path), str(fa_path), list(Ms), names, embeds,
                        shifted)


AMINO = "ACDEFGHIKLMNPQRSTVWY"


def emit_alignment(hmm, nseq: int, r) -> list[str]:
    """<nseq> aligned rows sampled from the core model of <hmm>
    (``emit.core_emit``): one column per match state (upper case, '-'
    where the path takes D) and, after position k, as many insert
    columns as the longest insertion there (lower case, '.' padding)."""
    from .emit import core_emit
    M = hmm.M
    paths = []
    for _ in range(nseq):
        seq, trace = core_emit(r, hmm)
        match = ["-"] * (M + 1)
        inserts: list[list[str]] = [[] for _ in range(M + 1)]
        at = 0
        for state, k in trace:
            if state == "D":
                continue
            res = AMINO[int(seq[at])]
            at += 1
            if state == "M":
                match[k] = res
            else:
                inserts[k].append(res.lower())
        paths.append((match, inserts))
    width = [max(len(ins[k]) for _, ins in paths) for k in range(M + 1)]
    return ["".join(("" if k == 0 else match[k])
                    + "".join(ins[k]).ljust(width[k], ".")
                    for k in range(M + 1)) for match, ins in paths]


def write_msa_fixture(Ms, nseq: int, seed: int,
                      directory: Path | None = None, keep=None):
    """(path, names): one multi-alignment Stockholm file with, for each
    of the seeded models of ``write_multi_fixture`` (lengths <Ms>), an
    alignment of <nseq> sequences emitted from it, named ``msa<i>-M<M>``;
    what ``bathbuild`` takes.  With <keep> (indexes into <Ms>) only
    those models get an alignment, each still the model of its index.
    Written on first use."""
    from .rng import Randomness
    d = Path(directory or FIXTURE_DIR)
    d.mkdir(parents=True, exist_ok=True)
    kept = range(len(Ms)) if keep is None else sorted(set(keep))
    key = list(Ms) if keep is None else (list(Ms), list(kept))
    tag = hashlib.sha256(repr(key).encode()).hexdigest()[:10]
    path = d / f"msa-{len(kept)}x{tag}-N{nseq}-s{seed}.sto"
    names = [f"msa{i}-M{Ms[i]}" for i in kept]
    if path.exists():
        return str(path), names
    rng = np.random.default_rng(seed)
    r = Randomness(seed)
    blocks = []
    models = [make_query(M, rng, calibrate=False)[0] for M in Ms]
    for name, i in zip(names, kept):
        hmm = models[i]
        rows = emit_alignment(hmm, nseq, r)
        blocks.append("# STOCKHOLM 1.0\n#=GF ID " + name + "\n" + "".join(
            f"{name}-s{j:<4d} {row}\n" for j, row in enumerate(rows))
            + "//\n")
    _write_atomic(path, "".join(blocks))
    return str(path), names


def write_convert_input(bhmm_path: str, out_path: str,
                        hmmer3: bool = False) -> str:
    """The models of <bhmm_path> written without their frameshift
    calibration (no fs3/fs5 taus, no frameshift probability), as
    BATH3/f or, with <hmmer3>, HMMER3/f: what ``bathconvert`` takes."""
    from .hmmfile import read_hmms
    buf = io.StringIO()
    for hmm in read_hmms(bhmm_path):
        hmm.fs = False
        hmm.fsprob = 0.0
        hmm.evparam[C.EV_FTAUFS3] = C.EVPARAM_UNSET
        hmm.evparam[C.EV_FTAUFS5] = C.EVPARAM_UNSET
        write_hmm(buf, hmm, fmt="3f" if hmmer3 else "bath3f")
    _write_atomic(Path(out_path), buf.getvalue())
    return out_path


def multi_embeds_found(tblout_path: str, fx: MultiFixture) -> dict:
    """{model index: copies that a reported hit of that model's query
    overlaps}, read from a ``--tblout`` table."""
    spans: dict = {}
    with open(tblout_path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            cols = line.split()
            a, b = (int(x) for x in cols[9:11])
            spans.setdefault(cols[3], []).append((min(a, b), max(a, b)))
    return {g: sum(any(a <= e and b >= s
                       for a, b in spans.get(fx.names[g], []))
                   for s, e in copies)
            for g, copies in fx.embeds.items()}


def multi_frameshifts_found(fstblout_path: str, fx: MultiFixture) -> dict:
    """{model index: frameshifted copies that a hit of that model's
    query listed in an ``--fstblout`` table overlaps}."""
    spans: dict = {}
    with open(fstblout_path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            cols = line.split()
            a, b = (int(x) for x in cols[5:7])
            spans.setdefault(cols[2], []).append((min(a, b), max(a, b)))
    return {g: sum(any(a <= e and b >= s
                       for a, b in spans.get(fx.names[g], []))
                   for s, e in copies)
            for g, copies in fx.frameshifted.items()}


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
    from .oprofile import oprofile_convert
    from .profile import profile_config
    return oprofile_convert(profile_config(hmm, Background(), L=100))


def fs_search_profile(hmm, ct: int = 1):
    """The fs3 profile (``FSOProfile``) a ``--fs`` search configures for
    <hmm>; the hmm must carry the frameshift fields
    (``make_query(..., fs=True)``)."""
    from .ops.reference.fwdback_fs import fs_oprofile_convert
    from .profile import profile_config_fs
    gcode = GeneticCode.create(ct)
    gcode.set_initiator_any()
    return fs_oprofile_convert(profile_config_fs(hmm, Background(), gcode,
                                                 3, 100, C.P7_LOCAL))


def _back_translate(aa: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    codons = _codons()
    dna = "".join(codons[int(a)][rng.integers(len(codons[int(a)]))]
                  for a in aa)
    return np.frombuffer(dna.translate(str.maketrans(NT, "\0\1\2\3"))
                         .encode(), np.uint8).astype(np.int8)


def fs_window_batch(q: np.ndarray, B: int, Lmax: int,
                    rng: np.random.Generator):
    """(dsq [B, Lmax] int8 padded with 17, lens [B] int32): ragged random
    DNA windows of up to Lmax nt, the first five of 0, 2, 3, 4 and Lmax
    nt.  Every second window long enough carries a back-translated
    mutated copy of <q> and every fourth two; every third copy has a
    1-nt deletion or insertion in its middle, and every fifth window a
    run of ten N."""
    lens = rng.integers(5, Lmax + 1, B).astype(np.int32)
    lens[:min(B, 5)] = (0, 2, 3, 4, Lmax)[:min(B, 5)]
    dsq = np.full((B, Lmax), 17, np.int8)
    ncopies = 0
    for b, L in enumerate(lens):
        s = rng.integers(0, 4, L).astype(np.int8)
        ncopy = 0 if b % 2 else (2 if b % 4 == 0 else 1)
        span = 3 * len(q) + 1
        for c in range(ncopy):
            if L < (c + 1) * span:
                continue
            dna = _back_translate(_mutate(q, rng), rng)
            if ncopies % 3 == 0:
                at = 3 * (len(q) // 2) + 1
                dna = np.delete(dna, at) if ncopies % 2 == 0 \
                    else np.insert(dna, at, rng.integers(0, 4))
            ncopies += 1
            k = c * span + int(rng.integers(0, L // (c + 1) - span + 1))
            s[k:k + len(dna)] = dna
        if b % 5 == 4 and L > 20:
            k = int(rng.integers(0, L - 10))
            s[k:k + 10] = 15
        dsq[b, :L] = s
    return dsq, lens


def envelope_batch(om, q: np.ndarray, lens, rng: np.random.Generator):
    """(residues, [n, 8] length models) of envelopes of the lengths
    <lens> under the profile <om> of the query <q>, as envelope
    rescoring fills them: two of three are mutated copies of <q> laid end
    to end and cut to their length, the third background residues; each
    length model is <om>'s unihit one at the envelope's length
    (``native._xff_of``).  Leaves <om> unihit."""
    from .native import _xff_of
    dsqs, xffs = [], []
    for n, L in enumerate(lens):
        if n % 3 == 2:
            d = rng.integers(0, 20, L)
        else:
            d = np.concatenate([_mutate(q, rng)
                                for _ in range(-(-L // len(q)))])[:L]
        om.reconfig_unihit(L)
        dsqs.append(np.asarray(d, np.uint8))
        xffs.append(_xff_of(om))
    return dsqs, np.array(xffs, np.float32)


def failing_envelopes(M: int, n: int, seed: int):
    """(profile, residues, length models) of <n> >= 5 envelopes of 120
    residues (``envelope_batch``) whose first five fail on the host, one
    a way: a NaN, an underflow and an overflow of the Forward, a NaN and
    an underflow of the Backward; the profile's match odds of the code 27
    are infinite."""
    rng = np.random.default_rng(seed)
    hmm, q = make_query(M, rng, calibrate=False)
    om = search_profile(hmm)
    dsqs, xffs = envelope_batch(om, q, [120] * n, rng)
    om.rfv = np.array(om.rfv)
    om.rfv[27] = np.inf
    dsqs[0] = dsqs[0].copy()
    dsqs[0][60] = 27
    dsqs[1] = np.full(40, 28, np.uint8)
    xffs[2, 4] = 3e38
    xffs[3, 5] = np.nan
    xffs[4, 5] = 0.0
    return om, dsqs, xffs


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


def multi_kernel_batch(Ms, per_model: int, Lmax: int, seed: int,
                       fs: bool = False):
    """A mixed batch for the multi-model kernels: (profiles, dsq
    [B, Lmax] int8, lens [B] int32, slot [B] int32) with <per_model>
    items for each of the seeded models of lengths <Ms>, shuffled.
    Standard: the search profiles and ``kernel_batch`` ORFs (pad 28);
    <fs>: the fs3 profiles and ``fs_window_batch`` DNA windows (pad
    17).  Each model's items carry copies of its own protein."""
    rng = np.random.default_rng(seed)
    profiles, rows, lens, slot = [], [], [], []
    for g, M in enumerate(Ms):
        hmm, q = make_query(M, rng, calibrate=False, fs=fs)
        profiles.append(fs_search_profile(hmm) if fs
                        else search_profile(hmm))
        if fs:
            # fs_window_batch opens with windows of 0, 2, 3, 4 and Lmax
            # nt: the first model keeps them, the others take the
            # random ones that follow
            d, ln = fs_window_batch(q, per_model + 5, Lmax, rng)
            keep = slice(0, per_model) if g == 0 else slice(5, None)
            d, ln = d[keep], ln[keep]
        else:
            d, ln = kernel_batch(q, per_model, Lmax, rng)
        rows.append(d)
        lens.append(ln)
        slot += [g] * per_model
    order = rng.permutation(len(slot))
    return (profiles, np.concatenate(rows)[order],
            np.concatenate(lens)[order],
            np.asarray(slot, np.int32)[order])


def genome_orfs(fasta_path: str, min_len: int = 1) -> list[np.ndarray]:
    """Every six-frame ORF (int8 residues) of a genome's windows, as
    bathsearch extracts them (minimum length 20, windows without
    overlap)."""
    from .gencode import extract_orfs
    from .sequence import read_windows
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
    return pool


def sample_orfs(fasta_path: str, n: int, seed: int,
                min_len: int = 1) -> list[np.ndarray]:
    """<n> ORFs (int8 residues) drawn at random from the six-frame ORFs
    of a genome (``genome_orfs``)."""
    pool = genome_orfs(fasta_path, min_len)
    rng = np.random.default_rng(seed)
    return [pool[i] for i in rng.choice(len(pool), size=n,
                                        replace=len(pool) < n)]


def hot_orfs(fasta_path: str, embeds, margin: int = 30) -> list[np.ndarray]:
    """The ORFs (int8 residues) of the embedded homologs of a genome:
    for each (first, last) copy of <embeds>, the ORFs of both strands
    of its span (+ <margin> nt) at least half the copy's length.  Their
    high-scoring diagonals saturate the Viterbi filter's int16 and make
    the SSV window capture overflow its slots at P = 1."""
    from .alphabet import dna, revcomp
    from .gencode import extract_orfs
    from .sequence import read_fasta
    gcode = GeneticCode.create(1)
    gcode.set_initiator_any()
    seq = read_fasta(fasta_path, dna())[0].dsq
    out = []
    for first, last in embeds:
        seg = seq[max(0, first - 1 - margin):last + margin]
        for s in (seg, revcomp(seg)):
            out += [np.asarray(o.dsq, np.int8)
                    for o in extract_orfs(gcode, s,
                                          minlen=(last - first + 1) // 6)]
    return out


def filter_cases(fx: Fixture, n_genome: int, seed: int,
                 long_len: int = 0) -> list[np.ndarray]:
    """ORFs (int8 residues) for the integer filters' parity checks:
    <n_genome> ORFs of the genome, its hot ORFs (``hot_orfs``), random
    residues of 1, 2, 19, 20 and 21, three missing-data residues, an
    empty one (no Viterbi result: the score is -inf) and, with
    <long_len>, one random ORF that long carrying a copy of every hot
    ORF."""
    f = Background().f[:20].astype(np.float64)
    rng = np.random.default_rng(seed)
    hot = hot_orfs(fx.fasta_path, fx.embeds)
    cases = sample_orfs(fx.fasta_path, n_genome, seed) + hot
    cases += [rng.choice(20, size=n, p=f / f.sum()).astype(np.int8)
              for n in (1, 2, 19, 20, 21)]
    cases += [np.full(3, 28, np.int8), np.zeros(0, np.int8)]
    if long_len:
        long = rng.choice(20, size=long_len, p=f / f.sum()).astype(np.int8)
        at = np.linspace(0, long_len, len(hot) + 1).astype(int)
        for h, a in zip(hot, at):
            long[a:a + len(h)] = h[:long_len - a]
        cases.append(long)
    return cases


def sample_windows(fasta_path: str, n: int, length: int,
                   seed: int) -> list[np.ndarray]:
    """<n> DNA windows (int8 nucleotide codes) of <length> nt at random
    places of a genome's first sequence, the shape of the fs3 gate's
    merged windows (2 * max_length * 3 nt)."""
    from .alphabet import dna
    from .sequence import read_fasta
    seq = read_fasta(fasta_path, dna())[0].dsq
    rng = np.random.default_rng(seed)
    return [np.asarray(seq[s:s + length], np.int8)
            for s in rng.integers(0, len(seq) - length, n)]


def longest_orfs(windows) -> list[np.ndarray]:
    """The longest six-frame ORF (int8 residues) of each DNA window."""
    from .gencode import extract_orfs
    from .sequence import revcomp
    gcode = GeneticCode.create(1)
    gcode.set_initiator_any()
    out = []
    for w in windows:
        w = np.asarray(w, np.int32)
        orfs = [o.dsq for d, rev in ((w, False), (revcomp(w), True))
                for o in extract_orfs(gcode, d, minlen=1, is_revcomp=rev)]
        out.append(np.asarray(max(orfs, key=len), np.int8))
    return out


@dataclass
class SpliceFixture:
    hmm_path: str
    fasta_path: str
    # per gene: {"strand": "+" or "-", "exons": [[first, last], ...]
    # 1-based plus-strand nt coordinates in the gene's own 5'->3'
    # order, "phases": the codon phase (0, 1, 2) of each intron}
    genes: list


def make_spliced_genome(q: np.ndarray, genome_len: int, n_genes: int,
                        rng: np.random.Generator):
    """(DNA string, genes as in ``SpliceFixture.genes``) of a random
    genome carrying <n_genes> mutated copies of the protein <q>, gene g
    split into 2 + g % 3 exons by GT...AG introns of INTRONS nt.
    Intron j of gene g falls at codon phase (g + j) % 3, so split
    codons of every phase occur; odd genes lie on the minus strand.
    Gene 0's first exon is SHORT_EXON residues long, too short to be a
    hit of its own.  Genes are spaced genome_len // n_genes apart,
    except the last, which follows the one before it on the same strand
    CLOSE_GAP nt after its end (two close genes on one sequence)."""
    codons = _codons()
    seq = np.frombuffer(NT.encode(), np.uint8)[
        rng.integers(0, 4, genome_len)]
    M = len(q)
    spacing = genome_len // n_genes
    genes, prev_end = [], 0
    for g in range(n_genes):
        n_ex = 2 + g % 3
        bounds = np.linspace(0, M, n_ex + 1).round().astype(int)
        bounds[1:-1] += rng.integers(-M // (4 * n_ex), M // (4 * n_ex) + 1,
                                     n_ex - 1)
        if g == 0:
            bounds[1] = SHORT_EXON
        phases = [(g + j) % 3 for j in range(n_ex - 1)]
        cds = "".join(codons[int(a)][rng.integers(len(codons[int(a)]))]
                      for a in _mutate(q, rng))
        cuts = [0] + [3 * int(b) + p for b, p in zip(bounds[1:-1], phases)] \
            + [len(cds)]
        parts, spans, pos = [], [], 0
        for j in range(n_ex):
            if j:
                n = int(rng.integers(*INTRONS))
                body = "".join(NT[int(x)] for x in rng.integers(0, 4, n - 4))
                parts.append("GT" + body + "AG")
                pos += n
            exon = cds[cuts[j]:cuts[j + 1]]
            spans.append((pos, pos + len(exon)))
            parts.append(exon)
            pos += len(exon)
        dna = "".join(parts)
        minus = g % 2 == 1
        if g == n_genes - 1 and n_genes > 1:
            minus = genes[-1]["strand"] == "-"
            start = prev_end + CLOSE_GAP
        else:
            start = spacing * g + (spacing - len(dna)) // 2
        if minus:
            dna = dna.translate(str.maketrans("ACGT", "TGCA"))[::-1]
            spans = [(len(dna) - e, len(dna) - b) for b, e in spans]
        if start + len(dna) > genome_len:
            raise ValueError(f"genome of {genome_len} nt too short for "
                             f"{n_genes} genes")
        seq[start:start + len(dna)] = np.frombuffer(dna.encode(), np.uint8)
        genes.append({"strand": "-" if minus else "+",
                      "exons": [[start + b + 1, start + e] for b, e in spans],
                      "phases": phases})
        prev_end = start + len(dna)
    return seq.tobytes().decode(), genes


def write_splice_fixture(M: int, genome_len: int, n_genes: int, seed: int,
                         directory: Path | None = None) -> SpliceFixture:
    """The spliced-gene fixture for these parameters
    (``make_spliced_genome``), written on first use as
    ``write_fixture``.  A search of it should pass a ``--max_intron``
    below genome_len // n_genes, the spacing of its genes, or it may
    chain exons of two genes into one hit."""
    d = Path(directory or FIXTURE_DIR)
    d.mkdir(parents=True, exist_ok=True)
    stem = d / f"splice-M{M}-L{genome_len}-G{n_genes}-s{seed}"
    meta = stem.with_suffix(".json")
    hmm_path, fa_path = stem.with_suffix(".bhmm"), stem.with_suffix(".fa")
    if meta.exists():
        return SpliceFixture(str(hmm_path), str(fa_path),
                             json.loads(meta.read_text()))
    rng = np.random.default_rng(seed)
    hmm, q = make_query(M, rng)
    dna, genes = make_spliced_genome(q, genome_len, n_genes, rng)
    buf = io.StringIO()
    write_hmm(buf, hmm)
    _write_atomic(hmm_path, buf.getvalue())
    body = "\n".join(dna[i:i + 80] for i in range(0, len(dna), 80))
    _write_atomic(fa_path, f">genome{seed}\n{body}\n")
    _write_atomic(meta, json.dumps(genes))
    return SpliceFixture(str(hmm_path), str(fa_path), genes)


def exon_hits(exontblout_path: str) -> list:
    """[[(lo, hi), ...], ...]: the exons' nt spans of each reported hit
    of an ``--exontblout`` table, in table order."""
    hits: dict = {}
    with open(exontblout_path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            cols = line.split()
            a, b = int(cols[14]), int(cols[15])
            hits.setdefault(cols[0], []).append((min(a, b), max(a, b)))
    return list(hits.values())


def spliced_found(exontblout_path: str, fx: SpliceFixture) -> int:
    """Genes reported as one hit that holds all their exons: a hit with
    as many exons as the gene, each overlapping its own exon of the
    gene, read from an ``--exontblout`` table."""
    hits = [sorted(spans) for spans in exon_hits(exontblout_path)]
    found = 0
    for gene in fx.genes:
        want = sorted((min(e), max(e)) for e in gene["exons"])
        found += any(len(h) == len(want)
                     and all(a <= y and b >= x
                             for (a, b), (x, y) in zip(h, want))
                     for h in hits)
    return found


def frameshifts_found(fstblout_path: str, fx: Fixture) -> int:
    """Frameshifted copies that a hit listed in an ``--fstblout`` table
    overlaps (its alignment's nt range)."""
    spans = []
    with open(fstblout_path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            a, b = (int(x) for x in line.split()[5:7])
            spans.append((min(a, b), max(a, b)))
    return sum(any(a <= e and b >= s for a, b in spans)
               for s, e in fx.frameshifted)
