"""``--splice`` in the port: ``bath_tpu_torch.cli.bathsearch --splice``
on its own ``--backend numpy``, on ``--backend torch --device cpu`` and
on the all-device cascade's plain versions, against ``bath_tpu
--backend numpy --splice``, on a seeded spliced genome (M = 200, 100 kb,
five genes of 2-4 exons split by GT...AG introns at all three codon
phases, on both strands, one with a 15-residue first exon and the last
two 2 kb apart).

The seed windows of the splice graph come from the captures of the
cascade (the SSV and Viterbi windows that the Forward gate passed), so
the byte identity of the torch backends also holds the plain versions
of the SSV capture (J6) and the Viterbi capture (J7) that feed them.
The gene spacing (20 kb) exceeds the searches' ``--max_intron 5000``,
so no two genes but the close pair can be chained into one hit.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax_native
from bath_tpu_torch import fixtures
from bath_tpu_torch.cli import bathsearch
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M, GENOME, GENES, SEED = 200, 100_000, 5, 7
MAX_INTRON = ["--max_intron", "5000"]
# looser F1/F2 than the defaults: some ORFs then take the Viterbi path
# and pass it, so the Viterbi capture feeds seeds too
LOOSE = ["--F1", "0.1", "--F2", "0.05"]
ALL_DEVICE = {"BATH_MSV_DEVICE": "1", "BATH_VIT_DEVICE": "1"}
HOST_FILTERS = {"BATH_MSV_DEVICE": "0", "BATH_VIT_DEVICE": "0"}
RUN_LINES = ("# Option settings:", "# Current dir:", "# Date:")


@pytest.fixture(scope="module")
def sfx(tmp_path_factory):
    jax_native.load()
    return fixtures.write_splice_fixture(
        M, GENOME, GENES, SEED, directory=tmp_path_factory.mktemp("sfx"))


def masked(path) -> str:
    return re.sub(r"# (CPU time|Mc/sec):.*", "", open(path).read())


def table(path) -> str:
    return "".join(ln for ln in open(path)
                   if not ln.startswith(RUN_LINES))


def paths(d, tag):
    return [str(d / f"{tag}.{x}") for x in ("out", "tbl", "ex")]


def read(out, tbl, ex):
    return masked(out), table(tbl), table(ex)


class Searches:
    """Each search once a module: (masked -o, --tblout, --exontblout
    without their run lines, the paths, the stats)."""

    def __init__(self, fx, d):
        self.fx, self.d, self.done = fx, d, {}

    def reference(self, *opts, hmm=None):
        key = ("ref", hmm) + opts
        if key not in self.done:
            out, tbl, ex = paths(self.d, f"ref{len(self.done)}")
            r = subprocess.run(
                [sys.executable, "-m", "bath_tpu.cli.bathsearch",
                 "--backend", "numpy", "--splice", *MAX_INTRON, *opts,
                 "-o", out, "--tblout", tbl, "--exontblout", ex,
                 hmm or self.fx.hmm_path, self.fx.fasta_path],
                capture_output=True, text=True, timeout=600, cwd=ROOT,
                env=dict(os.environ, JAX_PLATFORMS="cpu", **HOST_FILTERS))
            assert r.returncode == 0, r.stderr[-2000:]
            self.done[key] = (*read(out, tbl, ex), (out, tbl, ex), None)
        return self.done[key]

    def port(self, backend, *opts, hmm=None, fasta=None):
        key = (backend, hmm, fasta) + opts
        if key not in self.done:
            out, tbl, ex = paths(self.d, f"port{len(self.done)}")
            args = ["--backend", "numpy"] if backend == "numpy" \
                else ["--device", "cpu"]
            env = ALL_DEVICE if backend == "all-device" else HOST_FILTERS
            saved = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            stats = {}
            try:
                rc = bathsearch.run(
                    [*args, "--splice", *MAX_INTRON, *opts, "-o", out,
                     "--tblout", tbl, "--exontblout", ex,
                     hmm or self.fx.hmm_path, fasta or self.fx.fasta_path],
                    stats=stats)
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k)
                    else:
                        os.environ[k] = v
            assert rc == 0
            self.done[key] = (*read(out, tbl, ex), (out, tbl, ex), stats)
        return self.done[key]


@pytest.fixture(scope="module")
def searches(sfx, tmp_path_factory):
    return Searches(sfx, tmp_path_factory.mktemp("searches"))


def exon_rows(ex_text) -> list:
    return [ln.split() for ln in ex_text.splitlines()
            if ln.strip() and not ln.startswith("#")]


@pytest.mark.parametrize("cigar", [[], ["--cigar"]], ids=["plain", "cigar"])
@pytest.mark.parametrize("backend", ["numpy", "torch", "all-device"])
def test_splice_byte_identical_to_the_reference(searches, backend, cigar):
    """-o (its run lines masked), --tblout and --exontblout equal
    bath_tpu --backend numpy --splice's; the all-device cascade at
    looser F1/F2, so that both captures feed the seeds."""
    opts = (*(LOOSE if backend == "all-device" else ()), *cigar)
    want = searches.reference(*opts)
    got = searches.port(backend, *opts)
    assert got[:3] == want[:3]
    assert max(int(r[11]) for r in exon_rows(got[2])) >= 2
    stats = got[4]
    if backend == "numpy":
        # the post-pass's seconds and the count of the host's envelope
        # fills, no device stage
        assert stats == {"splice_s": stats["splice_s"],
                         "rescore_host_items": stats["rescore_host_items"]}
    else:
        assert stats["fwd_items"] > 0 and stats["domdec_items"] > 0
    integer = ("msv", "ssvcap", "vit", "vitcap")
    for stage in integer:
        assert (stats.get(f"{stage}_items", 0) > 0) \
            == (backend == "all-device"), stage


def test_every_gene_is_found_with_all_its_exons(searches, sfx):
    _, _, ex, (_, _, ex_path), _ = searches.port("torch")
    assert fixtures.spliced_found(ex_path, sfx) == GENES
    assert len(fixtures.exon_hits(ex_path)) == GENES
    assert sorted(len(s) for s in fixtures.exon_hits(ex_path)) == \
        sorted(len(g["exons"]) for g in sfx.genes)
    # every phase of a split codon is in a reported gene
    assert {p for g in sfx.genes for p in g["phases"]} == {0, 1, 2}


def test_the_short_first_exon_is_recovered(searches, sfx):
    """Gene 0's 15-residue first exon, too short to be a hit of its
    own, joins its gene's hit through the seed extension, with its own
    model and nt coordinates."""
    _, _, ex, _, _ = searches.port("torch")
    first, _ = sfx.genes[0]["exons"]
    rows = [r for r in exon_rows(ex)
            if r[10] == "1" and int(r[14]) == first[0]]
    assert len(rows) == 1
    hmm_from, hmm_to, ali_from, ali_to = (int(x) for x in rows[0][12:16])
    assert rows[0][11] == "2" and hmm_from <= 3 and hmm_to == 15
    assert ali_to - ali_from + 1 == 45 == first[1] - first[0] + 1


def test_minus_strand_genes_come_out_mirrored(searches, sfx, tmp_path):
    """The reverse complement of the genome gives the same hits, their
    scores and exons, at mirrored coordinates; a gene of the minus
    strand runs from high to low coordinates."""
    _, _, ex, _, _ = searches.port("numpy")
    seq = "".join(ln.strip() for ln in open(sfx.fasta_path)
                  if not ln.startswith(">"))
    rc = seq.translate(str.maketrans("ACGT", "TGCA"))[::-1]
    fa = tmp_path / "rc.fa"
    fa.write_text(">rc\n" + "\n".join(rc[i:i + 80]
                                      for i in range(0, len(rc), 80)) + "\n")
    _, _, ex_rc, _, _ = searches.port("numpy", fasta=str(fa))

    def exons(text, mirror):
        hits = {}
        for r in exon_rows(text):
            a, b = int(r[14]), int(r[15])
            if mirror:
                a, b = len(seq) - a + 1, len(seq) - b + 1
            hits.setdefault(r[0], [r[7], r[8], r[11]]).append((a, b))
        return sorted(hits.values(), key=lambda h: h[3:])

    assert exons(ex, False) == exons(ex_rc, True)
    for gene in sfx.genes:
        lo, hi = gene["exons"][0]
        row = next(r for r in exon_rows(ex) if r[10] == "1"
                   and lo - 3 <= int(r[14 if gene["strand"] == "+" else 15])
                   and int(r[15 if gene["strand"] == "+" else 14]) <= hi + 3)
        assert (int(row[14]) > int(row[15])) == (gene["strand"] == "-")


def test_two_close_genes_are_two_hits(searches, sfx):
    """The last two genes, 2 kb apart on one strand, are reported as
    two hits, each with its own exons, not chained into one."""
    _, _, _, (_, _, ex_path), _ = searches.port("torch")
    a, b = sfx.genes[-2:]
    assert a["strand"] == b["strand"]
    ends = sorted(x for e in a["exons"] + b["exons"] for x in e)
    hits = [sorted(s) for s in fixtures.exon_hits(ex_path)
            if ends[0] - 3 <= min(s)[0] and max(s)[1] <= ends[-1] + 3]
    assert sorted(len(h) for h in hits) == \
        sorted([len(a["exons"]), len(b["exons"])])
    assert hits[0][-1][1] < hits[1][0][0] or hits[1][-1][1] < hits[0][0][0]


def test_cigar_n_records_reconcile_with_the_exons(searches):
    """--cigar: a hit's CIGAR has an N record for each intron; the
    target nt its M and I records take between two N records are its
    exon's span in --exontblout, and each N is the gap between two
    exons."""
    _, tbl, ex, _, _ = searches.port("torch", "--cigar")
    rows = [ln.split() for ln in tbl.splitlines()
            if ln.strip() and not ln.startswith("#")]
    by_hit = {}
    for r in exon_rows(ex):
        by_hit.setdefault(r[0], []).append((int(r[14]), int(r[15])))
    assert len(rows) == len(by_hit) == GENES
    for r in rows:
        exons = by_hit[r[0]]
        spans, introns, take = [], [], 0
        for n, op in re.findall(r"(\d+)([MIDN])", r[-1]):
            if op == "N":
                spans.append(take)
                introns.append(int(n))
                take = 0
            elif op in "MI":
                take += int(n)
        spans.append(take)
        assert spans == [abs(b - a) + 1 for a, b in exons]
        assert introns == [abs(c - b) - 1 for (_, b), (c, _) in
                           zip(exons, exons[1:])]


def test_spliced_viterbi_matches_the_jax_package(sfx):
    """The port's spliced Viterbi and its trace equal bath_tpu's on two
    exons of the model's consensus joined by a GT...AG intron: the same
    states, nodes, positions and codon lengths, and the same score to
    the bit, with one P state at the junction."""
    from bath_tpu.bg import Background as JBg
    from bath_tpu.codontable import CodonTable as JCt
    from bath_tpu.gencode import GeneticCode as JGc
    from bath_tpu.hmmfile import read_hmm as jread
    from bath_tpu.profile import profile_config_fs as jconf
    from bath_tpu.rng import Randomness as JRng
    from bath_tpu.splice import viterbi_spliced as jvs
    from bath_tpu_torch.bg import Background
    from bath_tpu_torch.gencode import GeneticCode
    from bath_tpu_torch.hmmfile import read_hmm
    from bath_tpu_torch.profile import profile_config_fs
    from bath_tpu_torch.splice import viterbi_spliced as tvs

    jhmm = jread(sfx.hmm_path)
    jgc = JGc.create(1)
    jgc.set_initiator_any()
    r = JRng(7)
    ct = JCt(jgc)
    aminos = np.argmax(jhmm.mat[1:61, :20], axis=1)
    intron = np.concatenate([[2, 3], r.sample_iid(np.full(4, 0.25), 46),
                             [0, 2]])
    dsq = np.concatenate([ct.reverse_translate(r, aminos[:30]), intron,
                          ct.reverse_translate(r, aminos[30:])]
                         ).astype(np.int32)
    L = len(dsq)
    gc = GeneticCode.create(1)
    gc.set_initiator_any()
    models = ((jvs, jconf(jhmm, JBg(), jgc, 1, 100)),
              (tvs, profile_config_fs(read_hmm(sfx.hmm_path), Background(),
                                      gc, 1, 100)))
    traces = []
    for vs, gm in models:
        gx = vs.viterbi_spliced(dsq, gm, 1, L, 1, 60, min_intron=30)
        assert np.isfinite(gx.xC[L])
        traces.append((gx, vs.viterbi_spliced_trace(dsq, gm, gx, 1, L, 1,
                                                    60, min_intron=30)))
    (jgx, jtr), (tgx, ttr) = traces
    assert np.array_equal(jgx.xC, tgx.xC)
    assert (jtr.st, jtr.k, jtr.i, jtr.c) == (ttr.st, ttr.k, ttr.i, ttr.c)
    assert np.float64(jtr.vitsc).tobytes() == np.float64(ttr.vitsc).tobytes()
    assert [s for s in ttr.st if s == tvs.T_P] == [tvs.T_P]


REFUSALS = {
    "fs": ["--fs", "--splice"],
    "fsonly": ["--fsonly", "--splice"],
    "exontblout": ["--exontblout", "x.ex"],
    "min_intron": ["--min_intron", "20"],
    "max_intron": ["--max_intron", "9000"],
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_match_the_reference(sfx, capsys, case):
    """--fs or --fsonly with --splice, and --exontblout, --min_intron or
    --max_intron without it: the reference's message and exit code 1,
    on both backends of the port."""
    from bath_tpu.cli import bathsearch as jsearch
    argv = [*REFUSALS[case], sfx.hmm_path, sfx.fasta_path]
    assert jsearch.run(["--backend", "numpy", *argv]) == 1
    want = capsys.readouterr().err
    assert "Failed to parse command line" in want
    for backend in (["--backend", "numpy"], ["--device", "cpu"]):
        assert bathsearch.run([*backend, *argv]) == 1
        assert capsys.readouterr().err == want


def test_two_model_file_takes_the_serial_loop(searches, sfx, tmp_path):
    """A query file of two models with --splice runs the serial
    per-query loop on the torch backend, as the reference does, and is
    byte-identical to it."""
    other = fixtures.write_fixture(80, 30_000, 2, 5, directory=tmp_path)
    two = tmp_path / "two.bhmm"
    two.write_text(open(sfx.hmm_path).read() + open(other.hmm_path).read())
    want = searches.reference(hmm=str(two))
    got = searches.port("torch", hmm=str(two))
    assert got[:3] == want[:3]
    assert got[0].count("Query:") == 2
    assert "mq_stages" not in got[4] and got[4]["fwd_items"] > 0


def test_splice_without_cuda_raises(sfx):
    """--splice on --backend torch needs the card, as every mode does."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        bathsearch.run(["--splice", sfx.hmm_path, sfx.fasta_path])
