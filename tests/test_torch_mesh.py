"""bath_tpu_torch.parallel.mesh against bath_tpu.parallel.mesh.

The JAX package's sharded gate step (``make_pipeline_step`` under
``shard_map``) runs on the conftest's virtual CPU devices, on meshes of
1 and 8; the port's step runs on ``make_mesh(1, "cpu")`` and
``make_mesh(8, "cpu")`` (the shares in turn, through the kernels' plain
versions) on the same batch: B = 16 amino ORFs of 60 residues and DNA
windows of 180 nt, as ``tests/test_parallel.py`` shapes it, with the
model's protein in three ORFs and its back-translation in two windows so
that some scores pass.  The model is a ``fixtures`` query (M = 60).

Tolerances: Forward 0.01 nats (the f32 bound of test_torch_fwd.py; the
JAX step runs the jnp per-length Forward); MSV bit for bit (integer
arithmetic, and the nats in the JAX step's f32 order); fs3 0.05 nats
(``BF16_TOL`` of test_torch_fs3.py: the JAX step's v1 gate rounds its
emissions to bf16, so the port is fed the same bf16-rounded emissions).
``nres`` is exact; ``npass`` equals the count from the port's own scores
and the JAX step's unless a score lies within its tolerance of 0, which
the failure message would name.  The port's 1-, 2- and 8-share outputs
are bit-identical.
"""

import numpy as np
import pytest
import torch

from bath_tpu.ops.jaxk import kernels as jk
from bath_tpu.ops.pallas.fwd import fwd_params_pallas
from bath_tpu.parallel import mesh as jmesh
from bath_tpu_torch import fixtures
from bath_tpu_torch.ops import fs3 as t3
from bath_tpu_torch.ops import fwd as tf
from bath_tpu_torch.ops import ssv as ts
from bath_tpu_torch.ops.fwd import ProfileTensors
from bath_tpu_torch.parallel import mesh as tmesh
from torch_threads import one_torch_thread  # noqa: F401

B, LA, LN = 16, 60, 180
FWD_TOL, FS3_TOL = 0.01, 0.05


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(11)
    hmm, q = fixtures.make_query(LA, rng, calibrate=False, fs=True)
    om = fixtures.search_profile(hmm)
    om3 = fixtures.fs_search_profile(hmm)
    adsq = rng.integers(0, 20, (B, LA)).astype(np.int32)
    for row in (3, 9, 12):
        adsq[row] = q[:LA]
    ndsq = rng.integers(0, 4, (B, LN)).astype(np.int32)
    for row in (4, 9):
        ndsq[row] = fixtures._back_translate(q[:LN // 3], rng)
    batch = (adsq, np.full(B, LA, np.int32), ndsq, np.full(B, LN, np.int32),
             np.full(B, om.tjb_b, np.int32))
    return om, om3, batch


@pytest.fixture(scope="module")
def jax_out(case):
    om, om3, batch = case
    out = {}
    for nd in (1, 8):
        m = jmesh.make_mesh(nd)
        step = jmesh.make_pipeline_step(m, jk.fwd_params(om),
                                        jk.msv_params(om),
                                        jk.fs3_params(om3))
        out[nd] = [np.asarray(a) for a in
                   step(*(jmesh.shard_batch(m, a) for a in batch))]
    return out


def port_params(om, om3):
    """The JAX package's parameters carried across: the Forward gate's
    (rfv, tr), the fs3 tables with their emissions rounded to bf16 as
    the JAX v1 gate rounds them; MSV from the port's own profile."""
    rfv, tr, _, _ = fwd_params_pallas(om)
    fp = tf.fwd_params_from_jax(np.asarray(rfv), np.asarray(tr), om.M)
    p3 = t3.fs3_params_from_jax(jk.fs3_domdec_params(om3))
    p3 = ProfileTensors(p3.rfv.to(torch.bfloat16).float(), p3.tr)
    return fp, ts.msv_params(om), p3


@pytest.fixture(scope="module")
def port_out(case):
    om, om3, batch = case
    params = port_params(om, om3)
    out = {}
    for n in (1, 2, 8):
        step = tmesh.make_pipeline_step(tmesh.make_mesh(n, "cpu"), *params)
        out[n] = [t.numpy() for t in step(*batch)]
    return out


@pytest.mark.parametrize("n", [1, 8])
def test_step_vs_jax(case, jax_out, port_out, n):
    fwd, msv, fs3, ctr = port_out[n]
    jfwd, jmsv, jfs3, jctr = jax_out[n]
    assert fwd.shape == msv.shape == fs3.shape == (B,)
    assert np.abs(fwd - jfwd).max() < FWD_TOL, (fwd, jfwd)
    assert np.array_equal(msv, jmsv), (msv, jmsv)
    assert np.abs(fs3 - jfs3).max() < FS3_TOL, (fs3, jfs3)
    assert fwd.max() > 10.0 and fs3.max() > 10.0   # the homologs pass
    _, _, batch = case
    assert ctr[0] == jctr[0] == batch[1].sum() + batch[3].sum()
    own = int((fwd > 0).sum() + (fs3 > 0).sum())
    near = [float(s) for s, tol in ((fwd, FWD_TOL), (fs3, FS3_TOL))
            for s in s[np.abs(s) < tol]]
    assert ctr[1] == own
    assert ctr[1] == jctr[1], (
        f"npass {ctr[1]} against JAX's {jctr[1]}; scores within the "
        f"tolerance of 0: {near}")


def test_port_shares_are_bit_identical(port_out):
    for n in (2, 8):
        for a, b in zip(port_out[1], port_out[n]):
            assert np.array_equal(a, b)


def test_each_stage_goes_out_to_every_share_first(case, port_out,
                                                  monkeypatch):
    """The step launches a stage on every share before it checks any
    share's next stage: each wrapper reads its inputs back from its
    device before it launches, which waits for that device's earlier
    work, so share by share each device would wait for the others'.
    The outputs stay bit for bit one share's."""
    om, om3, batch = case
    calls = []
    for name in ("fwd_score", "msv_ssv", "fs3_score"):
        def spy(*args, _f=getattr(tmesh, name), _name=name):
            calls.append(_name)
            return _f(*args)
        monkeypatch.setattr(tmesh, name, spy)
    step = tmesh.make_pipeline_step(tmesh.make_mesh(4, "cpu"),
                                    *port_params(om, om3))
    for a, b in zip(port_out[1], step(*batch)):
        assert np.array_equal(a, b.numpy())
    assert calls == ["fwd_score"] * 4 + ["msv_ssv"] * 4 + ["fs3_score"] * 4


def test_params_carried_from_jax_match_the_ports_own(case):
    """fwd_params_from_jax gives the port's own tensors; the bf16
    rounding is the only change made to the fs3 emissions."""
    om, om3, _ = case
    fp, _, p3 = port_params(om, om3)
    own = tf.fwd_params(om)
    assert torch.equal(fp.rfv, own.rfv) and torch.equal(fp.tr, own.tr)
    own3 = t3.fs3_params(om3)
    assert torch.equal(p3.rfv, own3.rfv.to(torch.bfloat16).float())


def test_mesh_helpers():
    mesh = tmesh.make_mesh(4, "cpu")
    assert mesh == [torch.device("cpu")] * 4
    shares = tmesh.shard_batch(mesh, np.arange(8).reshape(8, 1))
    assert [s.flatten().tolist() for s in shares] == [[0, 1], [2, 3],
                                                       [4, 5], [6, 7]]
    with pytest.raises(ValueError):
        tmesh.shard_batch(mesh, np.arange(6))
    with pytest.raises(ValueError):
        tmesh.make_mesh(torch.cuda.device_count() + 1)
