"""bath_tpu_torch Forward gate (ops/fwd.py) against the JAX package.

The plain PyTorch version -- what the wrapper runs for CPU tensors --
is held against the Pallas TPU kernel in interpret mode and the jnp
per-length Forward (both f32: 0.01 nats, the bound of
test_pallas_kernels.py) and against the production jnp gate, which
rounds emissions to bf16 (0.2 nats, the bound of test_jax_kernels.py).
The CUDA kernel is held against the plain version on the card in
test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bath_tpu.ops.jaxk import kernels as jk
from bath_tpu.ops.pallas.fwd import fwd_params_pallas, fwd_score_pallas
from bath_tpu_torch import fixtures
from bath_tpu_torch.ops import fwd as tf
from bath_tpu_torch.ops.kernels import loader
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def model():
    hmm, q = fixtures.make_query(100, np.random.default_rng(3),
                                 calibrate=False)
    om = fixtures.search_profile(hmm)
    dsq, lens = fixtures.kernel_batch(q, 8, 240, np.random.default_rng(4))
    return om, q, dsq, lens


def _plain(om, dsq, lens):
    return tf.fwd_score(torch.from_numpy(dsq), torch.from_numpy(lens),
                        tf.fwd_params(om)).numpy()


def test_fwd_plain_vs_pallas_and_perlen(model):
    om, _, dsq, lens = model
    got = _plain(om, dsq, lens)
    rfv, tr, U, Mp = fwd_params_pallas(om)
    pal = np.asarray(fwd_score_pallas(
        jnp.asarray(dsq.T.astype(np.int32).copy()), jnp.asarray(lens),
        rfv, tr, U, Mp, nj=1.0, interpret=True, btile=8, lblk=48))
    p = jk.fwd_params(om)
    perlen = np.asarray(jk._forward_score_perlen_impl(
        jnp.asarray(dsq.astype(np.int32)), jnp.asarray(lens), p.rfv,
        p.tBM, p.tMM, p.tIM, p.tDM, p.tMD, p.tDD, p.tMI, p.tII, nj=1.0,
        Mp=p.Mp, U=p.U))
    assert np.isfinite(got).all()
    assert got.max() > 50.0            # the batch holds real homologs
    assert np.abs(got - pal).max() < 0.01, (got, pal)
    assert np.abs(got - perlen).max() < 0.01, (got, perlen)


def test_fwd_plain_vs_production_bf16_gate(model):
    om, _, dsq, lens = model
    got = _plain(om, dsq, lens)
    mb = np.asarray(jk.fwd_mb_score_batch(dsq, lens, jk.fwd_mb_params(om),
                                          nj=1.0))
    assert np.abs(got - mb).max() < 0.2, (got, mb)


def test_fwd_params_carry_over(model):
    om = model[0]
    rfv, tr, _, _ = fwd_params_pallas(om)
    got = tf.fwd_params_from_jax(np.asarray(rfv), np.asarray(tr), om.M)
    own = tf.fwd_params(om)
    assert torch.equal(got.rfv, own.rfv)
    assert torch.equal(got.tr, own.tr)


def test_fwd_wrapper_checks_inputs(model):
    om, _, dsq, lens = model
    p = tf.fwd_params(om)
    with pytest.raises(ValueError):
        tf.fwd_score(torch.from_numpy(dsq.astype(np.int32)),
                     torch.from_numpy(lens), p)
    with pytest.raises(ValueError):
        tf.fwd_score(torch.from_numpy(dsq), torch.from_numpy(lens[:-1]), p)


@pytest.mark.parametrize("M", [1, 96, 97, 400, 1056, 1057, 2500])
def test_kernel_layout_covers_model(M):
    P, W, Mp = loader.layout(M)
    assert P % 2 == 1 and P in loader.LANES_PER_THREAD
    assert Mp == 32 * P * W and Mp >= M
    assert W == 1 or P == loader.LANES_PER_THREAD[-1]


def test_loader_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(loader.CudaKernelError):
        loader.lib()

