"""bath_tpu_torch fused Forward + Backward + domain decoding
(ops/domdec.py) against the JAX package.

The plain PyTorch version is held against the jnp kernel
(domdec_mb_batch) and against the host parsers + p7_DomainDecoding, at
the 5e-4 bound of test_jax_kernels.py (well inside
pipeline.DOMDEC_MARGIN), with the same `ok` flags, on ragged
multi-domain ORFs that include L = 1.
"""

import numpy as np
import pytest
import torch

from bath_tpu.ops.jaxk import kernels as jk
from bath_tpu.ops.reference import fwdback as fb
from bath_tpu_torch import fixtures
from bath_tpu_torch.ops import domdec as td
from bath_tpu_torch.ops import fwd as tf
from torch_threads import one_torch_thread  # noqa: F401

TOL = 5e-4


@pytest.fixture(scope="module")
def decoded():
    hmm, q = fixtures.make_query(100, np.random.default_rng(5),
                                 calibrate=False)
    om = fixtures.search_profile(hmm)
    dsq, lens = fixtures.kernel_batch(q, 6, 420, np.random.default_rng(6))
    got = td.domdec(torch.from_numpy(dsq), torch.from_numpy(lens),
                    td.domdec_params(om))
    return om, dsq, lens, [x.numpy() for x in got]


def test_domdec_plain_vs_jnp_kernel(decoded):
    om, dsq, lens, (bt, et, mo, ok) = decoded
    jbt, jet, jmo, jok = (np.asarray(x) for x in jk.domdec_mb_batch(
        dsq.astype(np.int32), lens, jk.domdec_params(om), nj=1.0))
    assert ok.all() and np.array_equal(ok, jok)
    for b, L in enumerate(lens):
        n = int(L) + 1
        assert np.abs(bt[b, :n] - jbt[b, :n]).max() < TOL
        assert np.abs(et[b, :n] - jet[b, :n]).max() < TOL
        assert np.abs(mo[b, :n] - jmo[b, :n]).max() < TOL


def test_domdec_plain_vs_host_decoding(decoded):
    om, dsq, lens, (bt, et, mo, ok) = decoded
    assert 1 in lens and bt[:, -1].max() > 1.5     # L=1 and 2-domain ORFs
    for b, L in enumerate(lens):
        L = int(L)
        seq = dsq[b, :L].astype(np.int32)
        om.reconfig_length(L)
        oxf, _ = fb.forward(seq, om, full=False)
        oxb, _ = fb.backward(seq, om, oxf, full=False)
        hbt, het, hmo = fb.domain_decoding(om, oxf, oxb)
        assert np.abs(bt[b, :L + 1] - hbt).max() < TOL
        assert np.abs(et[b, :L + 1] - het).max() < TOL
        assert np.abs(mo[b, :L + 1] - hmo).max() < TOL
        # rows past the item's length carry nothing
        assert np.all(bt[b, L + 1:] == bt[b, L]) and not mo[b, L + 1:].any()


def test_domdec_params_carry_over(decoded):
    om = decoded[0]
    got = td.domdec_params_from_jax(jk.domdec_params(om))
    own = td.domdec_params(om)
    assert torch.equal(got.rfv, own.rfv)
    assert torch.equal(got.tr, own.tr)
    assert torch.equal(own.tr, tf.fwd_params(om).tr)

