"""The reference on tiny profiles, against the textbook recurrences
written state by state, and its control in a lower precision."""

import numpy as np
import pytest
import torch

from perfbench.reference import dp, profile
from perfbench.reference.hmmfile import (DD, DM, II, IM, MD, MI, MM, Hmm,
                                         read_text)
from perfbench.tests.conftest import DATA, REPO


def tiny_hmm(M, rng, name):
    mat = np.zeros((M + 1, 20))
    mat[1:] = rng.dirichlet(np.ones(20) * 0.5, M)
    t = np.zeros((M + 1, 7))
    for k in range(M + 1):
        t[k, [MM, MI, MD]] = rng.dirichlet([4, 1, 1])
        t[k, [IM, II]] = rng.dirichlet([3, 1])
        t[k, [DM, DD]] = rng.dirichlet([3, 1])
    t[M, [MM, MI, MD]] = [1, 0, 0]
    t[M, [DM, DD]] = [1, 0]
    return Hmm(name, M, mat, t)


def textbook(h, x):
    """(log Z, btot, etot, mocc) by explicit Forward and Backward
    matrices over every state of the local multihit model."""
    M, L, t = h.M, len(x), h.t
    odds, tr = profile.tables(h)
    tBM = np.concatenate([[0.0], tr[profile.T_BM]])
    e = lambda k, r: odds[r, k - 1] if 1 <= k <= M else 0.0  # noqa: E731
    pm = 3.0 / (L + 3.0)
    pl = 1.0 - pm
    T = lambda k, c: t[k, c] if 1 <= k < M else 0.0          # noqa: E731
    fM, fI, fD = (np.zeros((L + 1, M + 2)) for _ in range(3))
    fN, fB, fE, fJ, fC = (np.zeros(L + 1) for _ in range(5))
    fN[0], fB[0] = 1.0, pm
    for i in range(1, L + 1):
        for k in range(1, M + 1):
            fM[i, k] = e(k, x[i - 1]) * (
                fB[i - 1] * tBM[k] + fM[i - 1, k - 1] * T(k - 1, MM)
                + fI[i - 1, k - 1] * T(k - 1, IM)
                + fD[i - 1, k - 1] * T(k - 1, DM))
            fI[i, k] = fM[i - 1, k] * T(k, MI) + fI[i - 1, k] * T(k, II)
            if k >= 2:
                fD[i, k] = fM[i, k - 1] * T(k - 1, MD) \
                    + (fD[i, k - 1] * T(k - 1, DD) if k >= 3 else 0.0)
        fE[i] = fM[i, 1:M + 1].sum() + fD[i, 1:M + 1].sum()
        fN[i] = fN[i - 1] * pl
        fJ[i] = fJ[i - 1] * pl + fE[i] * 0.5
        fC[i] = fC[i - 1] * pl + fE[i] * 0.5
        fB[i] = (fN[i] + fJ[i]) * pm
    Z = fC[L] * pm
    bM, bI, bD = (np.zeros((L + 1, M + 2)) for _ in range(3))
    bN, bB, bE, bJ, bC = (np.zeros(L + 1) for _ in range(5))
    bC[L] = pm
    bE[L] = 0.5 * bC[L]
    for k in range(M, 0, -1):
        bD[L, k] = bE[L] + T(k, DD) * bD[L, k + 1]
        bM[L, k] = bE[L] + T(k, MD) * bD[L, k + 1]
    for i in range(L - 1, -1, -1):
        r = x[i]
        bB[i] = sum(tBM[k] * bM[i + 1, k] * e(k, r)
                    for k in range(1, M + 1))
        bC[i] = bC[i + 1] * pl
        bJ[i] = bJ[i + 1] * pl + bB[i] * pm
        bN[i] = bN[i + 1] * pl + bB[i] * pm
        bE[i] = 0.5 * (bC[i] + bJ[i])
        for k in range(M, 0, -1):
            nxt = bM[i + 1, k + 1] * e(k + 1, r)
            bD[i, k] = bE[i] + T(k, DM) * nxt + T(k, DD) * bD[i, k + 1]
            bM[i, k] = (bE[i] + T(k, MM) * nxt + T(k, MI) * bI[i + 1, k]
                        + T(k, MD) * bD[i, k + 1])
            bI[i, k] = T(k, IM) * nxt + T(k, II) * bI[i + 1, k]
    assert bN[0] == pytest.approx(Z, rel=1e-12)
    pb = fB[:-1] * bB[:-1] / Z
    pe = fE[1:] * bE[1:] / Z
    njc = (fN[:-1] * bN[1:] + fJ[:-1] * bJ[1:] + fC[:-1] * bC[1:]) * pl / Z
    return (np.log(Z), np.concatenate([[0], np.cumsum(pb)]),
            np.concatenate([[0], np.cumsum(pe)]),
            np.concatenate([[0], 1.0 - njc]))


def test_reference_against_textbook():
    rng = np.random.default_rng(3)
    hmms = [tiny_hmm(4, rng, "a"), tiny_hmm(3, rng, "b")]
    items = [(0, rng.integers(0, 20, 6)), (1, rng.integers(0, 20, 3)),
             (0, rng.integers(0, 20, 1)), (1, rng.integers(0, 20, 7))]
    bt = dp.Batch(items, [profile.tables(h) for h in hmms], "cpu")
    scores, post = dp.decode(bt)
    for (p, x), sc, rows in zip(items, scores, post):
        want = textbook(hmms[p], x)
        assert sc == pytest.approx(want[0], abs=1e-10)
        for got, w in zip(rows, want[1:]):
            np.testing.assert_allclose(got, w, atol=1e-10)
    fwd, _ = dp.forward(bt)
    np.testing.assert_allclose(fwd.numpy(), scores, atol=1e-12)


def test_control_reads_far_from_the_reference():
    rng = np.random.default_rng(4)
    h = tiny_hmm(40, rng, "c")
    items = [(0, rng.integers(0, 20, 120)) for _ in range(4)]
    tabs = [profile.tables(h)]
    ref, post = dp.decode(dp.Batch(items, tabs, "cpu"))
    low, lpost = dp.decode(dp.Batch(items, tabs, "cpu", torch.bfloat16))
    gap = np.abs(ref - low).max()
    dgap = max(np.abs(a - b).max() for r, q in zip(post, lpost)
               for a, b in zip(r, q))
    # bfloat16 keeps 8 bits of mantissa: far past the cells' limits
    assert gap > 1e-2 and dgap > 1e-2


@pytest.mark.parametrize("path,Ms", [
    (REPO / "perfbench" / "profiles" / "single400.bhmm.xz", [400]),
    (DATA / "lib2.bhmm.xz", [84, 181])], ids=["single400", "lib2"])
def test_committed_profiles_parse(path, Ms):
    import lzma
    hmms = read_text(lzma.decompress(path.read_bytes()).decode())
    assert [h.M for h in hmms] == Ms
    M = Ms[0]
    odds, tr = profile.tables(hmms[0])
    assert odds.shape == (profile.NRES, M) and tr.shape == (8, M)
    assert np.all(tr[profile.T_DD, :2] == 0)
    np.testing.assert_allclose(hmms[0].mat[1:].sum(1), 1, atol=1e-4)
