"""The traffic generator: seeded, modelled on the configuration's
figures, and carrying what it says."""

import json

import numpy as np
import pytest

from perfbench import genome
from perfbench.entries.bathsearch import seed_rng
from perfbench.reference import translate
from perfbench.tests.conftest import DATA, REPO

CONFIG = json.loads((REPO / "perfbench" / "configs"
                     / "single400.json").read_text())
FIG = CONFIG["genome"]
PROT = json.loads((REPO / "perfbench" / "profiles"
                   / "single400.proteins.json").read_text())["proteins"]
Q = np.array([translate.AMINO.index(c) for c in PROT["synth400"]],
             np.uint8)
TRAFFIC = {"copies": [[0, 9]], "doubles": 1, "substitution": 0.3}
COMP = str.maketrans("ACGT", "TGCA")


def make(seed, n=300_000, traffic=TRAFFIC):
    return genome.make(traffic, FIG, ["synth400"], [Q], n, seed_rng(seed))


def identity(seg, q):
    """The larger share of <q>'s residues that either strand of <seg>
    gives in frame 0."""
    aa = [translate.six_frames(x)[0]
          for x in (seg, seg.translate(COMP)[::-1])]
    return max(sum(a == translate.AMINO[r] for a, r in zip(t, q))
               for t in aa) / len(q)


def test_same_seed_same_bytes():
    a, b = make(2**31 + 7), make(2**31 + 7)
    assert a == b
    c = make(2**31 + 8)
    assert c[0] != a[0]
    assert len(a[0]) == len(c[0]) == 300_000


def test_copies_translate_to_the_protein():
    dna, copies = make(5)
    spans = copies["synth400"]
    # 9 copies: 7 genes of one, the last gene two
    assert len(spans) == 9
    for s, e in spans:
        assert e - s + 1 == 3 * len(Q)
        # 30% substitution, some back to the same residue
        assert identity(dna[s - 1:e], Q) > 0.6
    # the second site straddles the first window
    assert any(s < genome.BLOCK_LENGTH < e for s, e in spans)


def test_genome_follows_the_figures():
    """GC content, coding share and gene count of the source, and the
    same set of gene lengths for every seed."""
    n = 1_000_000
    dna, _ = make(11, n)
    gc = sum(map(dna.count, "GC")) / n
    assert abs(gc - FIG["gc"]) < 0.01
    model = genome.Model(FIG, n)
    assert len(model.gene_codons) == round(FIG["genes"] * n
                                           / FIG["genome_nt"])
    mean_nt = 3 * model.gene_codons.mean()
    assert mean_nt == pytest.approx(FIG["coding"] * FIG["genome_nt"]
                                    / FIG["genes"], rel=0.02)
    # stop-free stretches of 200 codons or more: the genes, on either
    # strand (uniform random DNA holds almost none)
    frames = translate.six_frames(dna)
    long = sum(len(x) for f in frames for x in f.split("*")
               if len(x) >= 200)
    assert long > 0.6 * FIG["coding"] * n / 3
    assert np.array_equal(genome.Model(FIG, n).gene_codons,
                          model.gene_codons)


def test_frameshifted_copies():
    tr = dict(TRAFFIC, frameshifts=4, doubles=0)
    dna, copies = make(3, traffic=tr)
    lengths = sorted(e - s + 1 for s, e in copies["synth400"])
    # two deletions and two insertions of one base
    assert lengths.count(3 * len(Q) - 1) == 2
    assert lengths.count(3 * len(Q) + 1) == 2


def test_library_copies():
    lib = json.loads((DATA / "lib2.proteins.json").read_text())["proteins"]
    names = list(lib)
    prots = [np.array([translate.AMINO.index(c) for c in p], np.uint8)
             for p in lib.values()]
    tr = {"copies": [[0, 2], [1, 3]]}
    dna, copies = genome.make(tr, FIG, names, prots, 200_000, seed_rng(1))
    assert [len(copies[n]) for n in names] == [2, 3]
    for g, n in enumerate(names):
        for s, e in copies[n]:
            assert e - s + 1 == 3 * len(prots[g])
            assert identity(dna[s - 1:e], prots[g]) > 0.6


def test_too_short_a_genome_is_refused():
    with pytest.raises(ValueError):
        make(1, 20_000, {"copies": [[0, 40]]})


def test_shifted_copies_recorded():
    """``shifted`` names the copies made with a frameshift, and only
    those, without changing what is made."""
    tr = dict(TRAFFIC, frameshifts=4, doubles=1)
    shifted: dict = {}
    dna, copies = genome.make(tr, FIG, ["synth400"], [Q], 300_000,
                              seed_rng(3), shifted)
    assert (dna, copies) == make(3, traffic=tr)
    spans = shifted["synth400"]
    assert len(spans) == 4 and set(spans) <= set(copies["synth400"])
    assert sorted(e - s + 1 for s, e in spans) == \
        [3 * len(Q) - 1] * 2 + [3 * len(Q) + 1] * 2
