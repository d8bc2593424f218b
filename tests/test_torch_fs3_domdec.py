"""bath_tpu_torch fused fs3 Forward + Backward + frameshift domain
decoding (ops/fs3_domdec.py) against the JAX package.

The plain PyTorch version is held against the jnp kernel
``fs3_domdec_mb_batch`` and against the host parsers
``forward_parser_fs3``/``backward_parser_fs3`` + ``domain_decoding_fs``,
within ``fs_domdec_margin(L)/3`` (the bound of test_jax_kernels.py) on
mocc and on the stride-3 increments of btot/etot, with the same `ok`
flags, on windows of up to 900 nt with one or two homolog copies, 1-nt
deletions and insertions and runs of N, and on windows of 0, 2, 3 and
4 nt.
"""

import numpy as np
import pytest
import torch

from bath_tpu.ops.jaxk import kernels as jk
from bath_tpu.ops.reference import fwdback_fs as ffs
from bath_tpu.pipeline_fs import fs_domdec_margin
from bath_tpu_torch import fixtures
from bath_tpu_torch.ops import fs3 as t3
from bath_tpu_torch.ops import fs3_domdec as td3
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def decoded():
    hmm, q = fixtures.make_query(100, np.random.default_rng(5),
                                 calibrate=False, fs=True)
    om3 = fixtures.fs_search_profile(hmm)
    dsq, lens = fixtures.fs_window_batch(q, 9, 900, np.random.default_rng(6))
    # the host decoder's N/J/C loop at each window's length model
    dec = np.asarray([(L // 3) / ((L // 3) + 3.0) for L in lens], np.float32)
    got = td3.fs3_domdec(torch.from_numpy(dsq), torch.from_numpy(lens),
                         t3.fs3_params(om3), torch.from_numpy(dec))
    return om3, dsq, lens, dec, [x.numpy() for x in got]


def _close(L, bt, et, mo, hbt, het, hmo):
    """mocc and the stride-3 increments of btot/etot within the bound;
    returns the largest difference."""
    bound = fs_domdec_margin(L) / 3.0
    dmo = np.abs(mo[:L + 1] - hmo[:L + 1]).max()
    db3 = np.abs((bt[3:L + 1] - bt[:L - 2]) - (hbt[3:L + 1] - hbt[:L - 2]))
    de3 = np.abs((et[3:L + 1] - et[:L - 2]) - (het[3:L + 1] - het[:L - 2]))
    worst = max(dmo, db3.max(), de3.max())
    assert worst < bound, (L, dmo, db3.max(), de3.max(), bound)
    return worst


def test_fs3_domdec_plain_vs_jnp_kernel(decoded):
    """Max difference measured: 1.1e-5."""
    om3, dsq, lens, dec, (bt, et, mo, ok) = decoded
    jbt, jet, jmo, jok = (np.asarray(x) for x in jk.fs3_domdec_mb_batch(
        dsq.astype(np.int32), lens, jk.fs3_domdec_params(om3),
        dec_loop=dec, nj=1.0))
    assert np.array_equal(ok, jok)
    assert list(ok) == [L >= 2 for L in lens]
    for b, L in enumerate(lens):
        if ok[b] and L >= 3:
            _close(int(L), bt[b], et[b], mo[b], jbt[b], jet[b], jmo[b])


def test_fs3_domdec_plain_vs_host_decoding(decoded):
    """Max difference measured: 3.9e-4 (the bound at these lengths is
    about 3e-3)."""
    om3, dsq, lens, _, (bt, et, mo, ok) = decoded
    # a two-domain window is in the batch: its expected begins, summed
    # over the three frames of the stride-3 cumsum, pass 1.5
    assert max(bt[b, L - 2:L + 1].sum() for b, L in enumerate(lens)
               if L >= 2) > 1.5
    for b, L in enumerate(lens):
        L = int(L)
        if L < 4:                      # the host parser needs 4 nt
            continue
        om3.reconfig_length(L // 3)
        d = dsq[b, :L].astype(np.int32)
        oxf, _ = ffs.forward_parser_fs3(d, om3)
        oxb, _ = ffs.backward_parser_fs3(d, om3, oxf)
        hbt, het, hmo = ffs.domain_decoding_fs(om3, oxf, oxb)
        _close(L, bt[b], et[b], mo[b], hbt, het, hmo)


def test_fs3_domdec_rows_outside_the_window(decoded):
    """Rows 0-2 and the rows past each window carry nothing; windows
    under 2 nt have no Forward score and go to the host."""
    _, _, lens, _, (bt, et, mo, ok) = decoded
    assert not (bt[:, :3].any() or et[:, :3].any() or mo[:, :3].any())
    for b, L in enumerate(lens):
        for x in (bt[b], et[b]):            # each frame's sum stays
            assert np.array_equal(x[L + 1:], x[L - 2:len(x) - 3]) \
                if L >= 2 else not x.any()
        assert not mo[b, L + 1:].any()
    assert not ok[lens < 2].any()


def test_fs3_domdec_scalar_dec_loop(decoded):
    """A scalar dec_loop (the cascade's 100/103) equals the per-window
    form."""
    om3, dsq, lens, _, _ = decoded
    p = t3.fs3_params(om3)
    sel = slice(4, 6)
    d, ln = torch.from_numpy(dsq[sel]), torch.from_numpy(lens[sel])
    a = td3.fs3_domdec(d, ln, p, 100.0 / 103.0)
    b = td3.fs3_domdec(d, ln, p, torch.full((2,), 100.0 / 103.0,
                                            dtype=torch.float64))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
