"""The frameshift reference (``reference/fs3.py``): against a textbook
version written state by state, against the program's plain fs3 gate
and fs3 decoding, and its control in bfloat16 reading far from it."""

import json
import lzma
import math

import numpy as np
import pytest
import torch

from perfbench.reference import fs3, hmmfile, profile
from perfbench.reference.hmmfile import DD, DM, II, IM, MD, MI, MM, Hmm
from perfbench.tests.conftest import DATA
from perfbench.tests.test_perfbench_reference import tiny_hmm

DEC = 100.0 / 103.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def fs_hmm(M, rng, name, fsprob=0.01):
    h = tiny_hmm(M, rng, name)
    return Hmm(h.name, h.M, h.mat, h.t, fsprob, 1)


def textbook(h, x, dec):
    """(log Z, btot, etot, mocc) by explicit Forward and Backward
    matrices over every state and nucleotide row of the local multihit
    3-codon frameshift model."""
    M, L, t = h.M, len(x), h.t
    odds, tr = fs3.tables(h)
    rows = fs3.codon_rows(x, L)
    tBM = np.concatenate([[0.0], tr[profile.T_BM]])

    def e(k, c, i):                  # odds of the c-nt codon ending at i
        return odds[rows[c - 2, i], k - 1] if 1 <= k <= M and i <= L \
            else 0.0

    amino = L // 3
    pm = 3.0 / (amino + 3.0)
    pl = 1.0 - pm
    T = lambda k, c: t[k, c] if 1 <= k < M else 0.0          # noqa: E731
    fM, fI, fD = (np.zeros((L + 1, M + 2)) for _ in range(3))
    fN, fB, fE, fJ, fC = (np.zeros(L + 1) for _ in range(5))
    for i in range(L + 1):
        for k in range(1, M + 1):
            for c in (2, 3, 4):
                if i - c >= 0:
                    j = i - c
                    fM[i, k] += e(k, c, i) * (
                        fB[j] * tBM[k] + fM[j, k - 1] * T(k - 1, MM)
                        + fI[j, k - 1] * T(k - 1, IM)
                        + fD[j, k - 1] * T(k - 1, DM))
            if i >= 3:
                fI[i, k] = fM[i - 3, k] * T(k, MI) + fI[i - 3, k] * T(k, II)
            if k >= 2:
                fD[i, k] = fM[i, k - 1] * T(k - 1, MD) \
                    + (fD[i, k - 1] * T(k - 1, DD) if k >= 3 else 0.0)
        fE[i] = fM[i, 1:M + 1].sum() + fD[i, 1:M + 1].sum()
        fN[i] = fN[i - 3] * pl if i >= 3 else 1.0
        fJ[i] = (fJ[i - 3] * pl if i >= 3 else 0.0) + fE[i] * 0.5
        fC[i] = (fC[i - 3] * pl if i >= 3 else 0.0) + fE[i] * 0.5
        fB[i] = (fN[i] + fJ[i]) * pm
    Z = (fC[L] + (fC[L - 1] + fC[L - 2]) * pl) * pm
    bM, bI, bD = (np.zeros((L + 5, M + 2)) for _ in range(3))
    bN, bB, bE, bJ, bC = (np.zeros(L + 4) for _ in range(5))
    for i in range(L, -1, -1):
        bB[i] = sum(tBM[k] * e(k, c, i + c) * bM[i + c, k]
                    for k in range(1, M + 1) for c in (2, 3, 4))
        bC[i] = pm if i == L else pl * pm if i >= L - 2 else pl * bC[i + 3]
        bJ[i] = bB[i] * pm + bJ[i + 3] * pl
        bN[i] = bB[i] * pm + bN[i + 3] * pl
        bE[i] = 0.5 * (bC[i] + bJ[i])
        for k in range(M, 0, -1):
            nxt = sum(e(k + 1, c, i + c) * bM[i + c, k + 1] for c in (2, 3, 4))
            bD[i, k] = bE[i] + T(k, DM) * nxt + T(k, DD) * bD[i, k + 1]
            bM[i, k] = (bE[i] + T(k, MM) * nxt + T(k, MI) * bI[i + 3, k]
                        + T(k, MD) * bD[i, k + 1])
            bI[i, k] = T(k, IM) * nxt + T(k, II) * bI[i + 3, k]
    # N starts at 1 in each of rows 0, 1 and 2
    assert bN[0] + bN[1] + bN[2] == pytest.approx(Z, rel=1e-12)
    inc_b, inc_e, tt = (np.zeros(L + 3) for _ in range(3))
    for i in range(3, L + 1):
        inc_b[i] = fB[i - 3] * bB[i - 3] / Z
        inc_e[i] = fE[i] * bE[i] / Z
        tt[i] = (fN[i - 3] * bN[i] + fJ[i - 3] * bJ[i]
                 + fC[i - 3] * bC[i]) / Z
    btot, etot, mocc = (np.zeros(L + 1) for _ in range(3))
    for i in range(3, L + 1):
        btot[i] = inc_b[i] + btot[i - 3]
        etot[i] = inc_e[i] + etot[i - 3]
        mocc[i] = 1.0 - dec * (tt[i] + tt[i + 1] + tt[i + 2])
    return math.log(Z), btot, etot, mocc


def test_fs3_reference_against_textbook():
    rng = np.random.default_rng(5)
    hmms = [fs_hmm(4, rng, "a"), fs_hmm(3, rng, "b", 0.05)]
    lens = [14, 9, 2, 25, 17]
    items = [(i % 2, rng.integers(0, 4, n)) for i, n in enumerate(lens)]
    items[3][1][7] = 15                     # an N: a degenerate codon
    decs = [DEC, 0.9, DEC, 0.95, DEC]
    bt = fs3.Batch(items, [fs3.tables(h) for h in hmms], "cpu",
                   dec_loop=decs)
    scores, post = fs3.decode(bt)
    for (p, x), dec, sc, rows in zip(items, decs, scores, post):
        want = textbook(hmms[p], x, dec)
        assert sc == pytest.approx(want[0], abs=1e-10)
        for got, w in zip(rows, want[1:]):
            np.testing.assert_allclose(got, w, atol=1e-10)
    fwd, _ = fs3.forward(bt)
    np.testing.assert_allclose(fwd.numpy(), scores, atol=1e-12)


def test_codon_odds_by_hand():
    """A few rows of the emission table worked out from the code."""
    rng = np.random.default_rng(6)
    h = fs_hmm(3, rng, "c")
    odds, _ = fs3.tables(h)
    a = h.mat[1:] / profile.AMINO_FREQS.astype(np.float64)

    def best(letters, pen):
        return a[:, [fs3.AMINO.index(c) for c in letters]].max(1) * pen

    # AAA Lys and AAC Asn, clean: 1 - 3 fsprob
    np.testing.assert_allclose(odds[fs3.ROW3 + 0], best("K", 0.97))
    np.testing.assert_allclose(odds[fs3.ROW3 + 1], best("N", 0.97))
    # TAA, a stop: one base away AAA Lys, CAA Gln, GAA Glu, TCA Ser,
    # TTA Leu, TAC and TAT Tyr (TGA and TAG are stops)
    np.testing.assert_allclose(odds[fs3.ROW3 + 16 * 3], best("KQESLY", 0.01))
    # AA as 2 nt: xAA (Lys, Gln, Glu; TAA a stop), AxA (Lys, Thr, Arg,
    # Ile), AAx (Lys, Asn)
    np.testing.assert_allclose(odds[fs3.ROW2 + 0], best("KQETRIN", 0.01))
    # ACGT as 4 nt: ACT Thr, AGT Ser, CGT Arg (its first, second or
    # third base dropped)
    np.testing.assert_allclose(odds[fs3.ROW4 + 0b00011011],
                               best("TSR", 0.01))


@pytest.mark.parametrize("M,seed", [(40, 7), (42, 8), (84, None)],
                         ids=["seeded40", "seeded42", "fs84"])
def test_fs3_reference_against_the_program(M, seed):
    """Against ``ops/fs3.py`` ``fs3_score_ref`` and ``ops/fs3_domdec.py``
    ``fs3_domdec_ref``, the program's plain float32 versions, on DNA
    windows of 150-600 nt with homologs, frameshifted ones among them.
    Both read the same file.  Tolerances: the program keeps its rows in
    float32 and rescales them in its own cadence, so a score carries
    the rounding of some hundreds of rows at about 6e-8 each (measured
    up to 7.2e-6 nats over the three profiles; bound 1e-4), and a
    posterior row that of its products (measured up to 1.8e-6; bound
    2e-5)."""
    from bath_tpu_torch import fixtures
    from bath_tpu_torch.hmmfile import read_hmms_text
    from bath_tpu_torch.ops import fs3 as t3
    from bath_tpu_torch.ops import fs3_domdec as t3d
    if seed is None:
        text = lzma.decompress((DATA / "fs84.bhmm.xz").read_bytes()).decode()
        ref = hmmfile.read_text(text)[0]
        prot = json.loads((DATA / "fs84.proteins.json").read_text())
        q = np.array([fs3.AMINO.index(c)
                      for c in prot["proteins"][ref.name]], np.uint8)
        prog = read_hmms_text(text)[0]
    else:
        prog, q = fixtures.make_query(M, np.random.default_rng(seed),
                                      calibrate=False, fs=True)
        ref = Hmm(prog.name, prog.M, np.asarray(prog.mat[:, :20], float),
                  np.asarray(prog.t, float), float(prog.fsprob), 1)
    dsq, lens = fixtures.fs_window_batch(q, 6, 600,
                                         np.random.default_rng(9))
    lens = np.clip(lens, 150, 600).astype(np.int32)
    p = t3.fs3_params(fixtures.fs_search_profile(prog))
    d, ln = torch.from_numpy(dsq), torch.from_numpy(lens)
    got = t3.fs3_score_ref(d, ln, p).numpy()
    gb, ge, gm, ok = t3d.fs3_domdec_ref(d, ln, p, DEC)
    items = [(0, dsq[b, :n]) for b, n in enumerate(lens)]
    bt = fs3.Batch(items, [fs3.tables(ref)], "cpu",
                   dec_loop=[DEC] * len(items))
    want, post = fs3.decode(bt)
    assert got.max() > 15.0             # the windows hold homologs
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert ok.all()
    for b, n in enumerate(lens):
        for g, w in zip((gb, ge, gm), post[b]):
            np.testing.assert_allclose(g[b, :n + 1].numpy(), w, atol=2e-5)


def test_fs3_control_reads_far_from_the_reference():
    rng = np.random.default_rng(10)
    h = fs_hmm(40, rng, "d")
    items = [(0, rng.integers(0, 4, 300)) for _ in range(3)]
    tabs = [fs3.tables(h)]
    ref, post = fs3.decode(fs3.Batch(items, tabs, "cpu", dec_loop=[DEC] * 3))
    low, lpost = fs3.decode(fs3.Batch(items, tabs, "cpu", torch.bfloat16,
                                      dec_loop=[DEC] * 3))
    gap = np.abs(ref - low).max()
    dgap = max(np.abs(a - b).max() for r, q in zip(post, lpost)
               for a, b in zip(r, q))
    # bfloat16 keeps 8 bits of mantissa: far past the limits a cell sets
    assert gap > 1e-2 and dgap > 1e-2


def test_reader_keeps_the_frameshift_fields():
    text = lzma.decompress((DATA / "fs84.bhmm.xz").read_bytes()).decode()
    h = hmmfile.read_text(text)[0]
    assert (h.name, h.M, h.fsprob, h.ct) == ("mq1-M84", 84, 0.01, 1)
    std = hmmfile.read_text(lzma.decompress(
        (DATA / "lib2.bhmm.xz").read_bytes()).decode())[0]
    assert std.fsprob is None and std.ct == 1
    with pytest.raises(ValueError, match="FRAMESHIFT"):
        fs3.tables(std)
    # the frameshift fields leave what the standard tables read alone
    np.testing.assert_array_equal(std.mat, h.mat)
    np.testing.assert_array_equal(std.t, h.t)
