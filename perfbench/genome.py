"""The traffic: a bacterial genome made from the run's seed after the
configuration's published figures, some of whose genes are mutated
copies of the configuration's proteins.

The configuration's ``genome`` holds the figures of the genome it
models (length, protein-coding genes, coding share, GC content) and
what is assumed beside them; the cell's traffic file (key ``traffic``)
holds the genome's length, the copies and their substitution rate.
``make`` reads both.  The model:

- **genes**: as many a megabase as the source has; each ATG, codons of
  a protein drawn from the background (``AMINO_FREQS``; synonymous
  codons weighted by their bases so that the coding DNA has the
  source's GC content), one of the three stops.  Their lengths are
  the mid-quantiles of a gamma distribution (shape ``gene_shape``, the
  mean the source's coding share over its genes, at least
  ``min_gene_codons``), so every seed has the same set of lengths in
  another order; half of them on each strand;
- **spacers** between genes: the mid-quantiles of an exponential
  distribution whose mean is what the coding share leaves a gene, of
  bases drawn at the source's GC content;
- **copies**: the traffic's ``copies`` (``[[profile index, count],
  ...]``, in rounds) at ``substitution``, each site one gene at a fixed
  place (evenly spread, the second across the first window boundary,
  odd sites on the minus strand); the last ``doubles`` sites each hold
  two copies in one gene; ``frameshifts`` of the sites carry a 1-nt
  indel in their first copy's middle codon.  The background genes tile
  the stretches between the sites.

``_mutate`` and ``frameshift_sites`` are frozen copies of
``bath_tpu_torch/fixtures.py`` (``:101-106``, ``:109-117``) at commit
520fb61: copied, not imported, so the yardstick does not follow later
changes to the program's fixtures.
"""

from __future__ import annotations

import numpy as np

from .reference.profile import AMINO_FREQS
from .reference.translate import AMINO, _codon_letters

NT = "ACGT"
LINKER = 12                  # residues between the copies of a 2-copy gene
BLOCK_LENGTH = 1024 * 256    # the search's window: 1/4 Mb
STOPS = ("TAA", "TAG", "TGA")


def _codon_table() -> tuple[np.ndarray, np.ndarray]:
    """([20, 6, 3] bases of each residue's codons, [20] their counts)."""
    lett = _codon_letters()
    table = np.zeros((20, 6, 3), np.uint8)
    count = np.zeros(20, np.int64)
    for i in range(64):
        ch = chr(lett[i])
        if ch in AMINO:
            r = AMINO.index(ch)
            table[r, count[r]] = [ord(NT[i // 16]), ord(NT[(i // 4) % 4]),
                                  ord(NT[i % 4])]
            count[r] += 1
    return table, count


def revcomp(dna: np.ndarray) -> np.ndarray:
    """The reverse complement of ASCII bases."""
    lut = np.zeros(256, np.uint8)
    for a, b in zip(b"ACGT", b"TGCA"):
        lut[a] = b
    return lut[dna[::-1]]


def _mutate(q: np.ndarray, subst: float, rng) -> np.ndarray:
    f = AMINO_FREQS.astype(np.float64)
    aa = q.copy()
    hit = rng.random(len(aa)) < subst
    aa[hit] = rng.choice(20, size=int(hit.sum()), p=f / f.sum())
    return aa


def frameshift_sites(sites: int, n_frameshift: int) -> set:
    if n_frameshift <= 0:
        return set()
    if n_frameshift > sites:
        raise ValueError(f"{n_frameshift} frameshifts for {sites} sites")
    return {int(v) for v in np.linspace(0, sites - 1, n_frameshift)
            .round()}


class Model:
    """The genome model of a configuration's ``genome`` figures at
    <genome_len> nt."""

    def __init__(self, fig: dict, genome_len: int):
        from scipy.special import gammaincinv
        self.genome_len = genome_len
        n = max(1, round(fig["genes"] * genome_len / fig["genome_nt"]))
        mean_nt = fig["coding"] * fig["genome_nt"] / fig["genes"]
        k = fig["gene_shape"]
        p = (np.arange(n) + 0.5) / n
        codons = gammaincinv(k, p) * (mean_nt / 3) / k
        self.gene_codons = np.maximum(np.rint(codons).astype(np.int64),
                                      fig["min_gene_codons"])
        spacer_mean = mean_nt * (1 - fig["coding"]) / fig["coding"]
        self.spacers = np.rint(-spacer_mean * np.log1p(-p)).astype(np.int64)
        gc = fig["gc"]
        self.base_p = np.array([1 - gc, gc, gc, 1 - gc]) / 2
        f = AMINO_FREQS.astype(np.float64)
        self.aa_p = f / f.sum()
        self.table, self.count = _codon_table()
        # a synonymous codon is drawn with weight g^(its G+C) (1-g)^(its
        # A+T), g set so the coding DNA has the source's GC content too
        ngc = np.isin(self.table, np.frombuffer(b"GC", np.uint8)).sum(2)
        real = np.arange(6)[None, :] < self.count[:, None]
        lo, hi = 1e-3, 1 - 1e-3
        for _ in range(60):
            g = (lo + hi) / 2
            w = np.where(real, g ** ngc * (1 - g) ** (3 - ngc), 0.0)
            w /= w.sum(1, keepdims=True)
            if self.aa_p @ (w * ngc).sum(1) / 3 < gc:
                lo = g
            else:
                hi = g
        self.codon_cdf = np.cumsum(w, 1)

    def coding(self, aa: np.ndarray, rng) -> np.ndarray:
        """ASCII bases of ATG, the codons of residues <aa> and a
        stop."""
        cdf = self.codon_cdf[aa]
        pick = np.minimum((cdf < rng.random(len(aa))[:, None]).sum(1),
                          self.count[aa] - 1)
        body = self.table[aa, pick].reshape(-1)
        stop = np.frombuffer(STOPS[int(rng.integers(3))].encode(), np.uint8)
        return np.concatenate([np.frombuffer(b"ATG", np.uint8), body, stop])

    def background(self, rng) -> np.ndarray:
        """The whole genome as spacer bases."""
        return np.frombuffer(NT.encode(), np.uint8)[
            rng.choice(4, size=self.genome_len, p=self.base_p)]


def _site_gene(model, proteins, members, subst, shift, rng):
    """(ASCII bases, [(begin, end)] 0-based spans of the copies in
    them) of a gene holding copies of <members> (protein indices);
    <shift> -1 or +1 puts a 1-nt indel in the first copy's middle
    codon."""
    parts, spans, pos = [], [], 0
    for c, g in enumerate(members):
        if c:
            parts.append(rng.choice(20, size=LINKER, p=model.aa_p))
            pos += LINKER
        aa = _mutate(proteins[g], subst, rng)
        spans.append(((pos + 1) * 3, (pos + 1 + len(aa)) * 3))
        parts.append(aa)
        pos += len(aa)
    dna = model.coding(np.concatenate(parts).astype(np.int64), rng)
    if shift:
        at = spans[0][0] + 3 * (len(proteins[members[0]]) // 2) + 1
        if shift < 0:
            dna = np.delete(dna, at)
        else:
            dna = np.insert(dna, at, ord(NT[int(rng.integers(0, 4))]))
        spans = [(spans[0][0], spans[0][1] + shift)] + \
            [(b + shift, e + shift) for b, e in spans[1:]]
    return dna, spans


def make(traffic: dict, figures: dict, names: list, proteins: list,
         genome_len: int, rng, shifted: dict | None = None):
    """(DNA, {profile name: [(first, last)]} 1-based plus-strand
    coordinates of each copy) of the traffic at <genome_len> nt;
    <figures>: the configuration's ``genome``; <names>, <proteins>: its
    profiles in file order and their residues.  <shifted>, where given,
    gets the same of the copies made with a frameshift."""
    model = Model(figures, genome_len)
    subst = traffic.get("substitution", 0.30)
    rounds = max(n for _, n in traffic["copies"])
    order = [g for c in range(rounds) for g, n in traffic["copies"]
             if c < n]
    doubles = traffic.get("doubles", 0)
    n_sites = len(order) - doubles
    members = [[g] for g in order[:n_sites - doubles]] + \
        [order[i:i + 2] for i in range(n_sites - doubles, len(order), 2)]
    fs = frameshift_sites(n_sites, traffic.get("frameshifts", 0))
    seq = model.background(rng)
    spacing = genome_len // (n_sites + 1)
    sites = []                      # (start, gene bases)
    copies: dict = {names[g]: [] for g in order}
    for s, mem in enumerate(members):
        shift = (-1, 1)[sorted(fs).index(s) % 2] if s in fs else 0
        dna, spans = _site_gene(model, proteins, mem, subst, shift, rng)
        if s % 2 == 1:
            dna = revcomp(dna)
            spans = [(len(dna) - e, len(dna) - b) for b, e in spans]
        start = spacing * (s + 1)
        if s == min(1, n_sites - 1) and genome_len > BLOCK_LENGTH + len(dna):
            start = BLOCK_LENGTH - len(dna) // 2
        if spacing < len(dna) + 1:
            raise ValueError(f"genome of {genome_len} nt too short for "
                             f"{n_sites} sites")
        sites.append((start, dna))
        for g, (b, e) in zip(mem, spans):
            copies[names[g]].append((start + b + 1, start + e))
        if shift and shifted is not None:
            b, e = spans[0]
            shifted.setdefault(names[mem[0]], []).append((start + b + 1,
                                                          start + e))
    # the background genes tile the stretches between the sites
    perm = rng.permutation(len(model.gene_codons))
    lengths = model.gene_codons[perm]
    strands = rng.permutation(np.arange(len(lengths)) % 2)
    spacers = model.spacers[rng.permutation(len(model.spacers))]
    sites.sort(key=lambda sd: sd[0])
    bounds = [0] + [x for st, d in sites for x in (st, st + len(d))] + \
        [genome_len]
    if any(a > b for a, b in zip(bounds, bounds[1:])):
        raise ValueError(f"the copies' sites overlap in {genome_len} nt")
    j = 0
    for a, b in zip(bounds[::2], bounds[1::2]):
        pos = a
        while True:
            i = j % len(lengths)
            n_nt = 3 * int(lengths[i])
            at = pos + int(spacers[i])
            if at + n_nt > b:
                break
            aa = rng.choice(20, size=n_nt // 3 - 2, p=model.aa_p)
            dna = model.coding(aa, rng)
            seq[at:at + n_nt] = revcomp(dna) if strands[i] else dna
            pos = at + n_nt
            j += 1
    for start, dna in sites:
        seq[start:start + len(dna)] = dna
    if shifted is not None:
        for v in shifted.values():
            v.sort()
    return seq.tobytes().decode(), {k: sorted(v) for k, v in copies.items()}


def write_fasta(path, name: str, dna: str) -> None:
    with open(path, "w") as f:
        f.write(f">{name}\n")
        for i in range(0, len(dna), 80):
            f.write(dna[i:i + 80] + "\n")
