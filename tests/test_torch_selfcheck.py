"""The port's self-check entry points (``bath_tpu_torch/selfcheck.py``,
the twin of ``__graft_entry__.py``) on the CPU.

- ``entry(device="cpu")`` is the fs3 gate of a seeded model over 8
  seeded windows of 384 nt; it agrees with the JAX package's production
  gate ``fs3_score_batch_v4`` on the same model (its parameters built
  from the port's profile) and windows within 0.05 nats, the bound of
  ``tests/test_torch_fs3.py`` for the gates that round emissions to
  bf16, and its plain version is what the wrapper gives.
- ``dryrun_multichip(2, device="cpu")``: the sharded step over two CPU
  shares equals one share's bit for bit with exact counters, and the
  standard, ``--fs``, ``--splice`` and multi-query cascades over two
  shares print the bytes of one device and of ``--backend numpy``.
- With ``device="cuda"`` and no card (``torch.cuda.is_available``
  made false), both raise.
"""

import numpy as np
import pytest
import torch

from bath_tpu.ops.jaxk.fs3_v4 import fs3_params_v4, fs3_score_batch_v4
from bath_tpu_torch import selfcheck
from bath_tpu_torch.ops import fs3
from torch_threads import one_torch_thread  # noqa: F401

BF16_TOL = 0.05


def test_entry_agrees_with_the_production_jax_gate():
    fn, (dsq, lens) = selfcheck.entry(device="cpu")
    assert dsq.shape == (8, 384) and dsq.dtype == torch.int8
    assert lens.tolist() == [384] * 8
    got = fn(dsq, lens).numpy()
    assert got.shape == (8,) and np.isfinite(got).all()
    _, om3 = selfcheck.flagship()
    assert om3.M == selfcheck.ENTRY_M
    ref = np.asarray(fs3_score_batch_v4(dsq.numpy(), lens.numpy(),
                                        fs3_params_v4(om3), nj=1.0))[:8]
    assert np.abs(got - ref).max() < BF16_TOL, (got, ref)
    plain = fs3.fs3_score_ref(dsq, lens, fs3.fs3_params(om3), 1.0).numpy()
    assert np.array_equal(got, plain)


def test_dryrun_multichip_on_two_cpu_shares(tmp_path, capsys):
    rep = selfcheck.dryrun_multichip(2, device="cpu",
                                     fixture_dir=tmp_path / "fixtures")
    assert rep["devices"] == ["cpu", "cpu"]
    fwd, msv, fs3_out, counters = rep["step"]
    b = 4
    assert fwd.shape == (b,) and fs3_out.shape == (b,)
    assert counters[0] == b * (selfcheck.STEP_LA + selfcheck.STEP_LN)
    assert set(rep["mesh_items"]) == {"standard", "fs", "splice",
                                      "multiquery"}
    for mode, shares in rep["mesh_items"].items():
        assert shares and all(len(v) == 2 for v in shares.values()), mode
    out = capsys.readouterr().out
    assert out.count("byte-identical to one device and to numpy") == 4


def test_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        selfcheck.entry()
    with pytest.raises(RuntimeError):
        selfcheck.dryrun_multichip(2)
