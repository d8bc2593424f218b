"""The control at a size a test run holds: the reference in bfloat16
put in the device stages' place reads over the cell's limits, where
the program reads under them."""

import json

import pytest

from perfbench import control
from perfbench.tests.conftest import REPO


@pytest.mark.parametrize("cell,like", [("single400.tiny",
                                        "single400.std_dense")])
def test_control_fails_program_passes(tiny_root, cell, like, capsys):
    limits = json.loads((REPO / "perfbench" / "workloads"
                         / f"{like}.json").read_text())["limits"]
    rows = control.readings(cell, [3, 2**32 + 1], device="cpu",
                            root=tiny_root)
    capsys.readouterr()
    for row in rows:
        assert row["rc"] == 0 and row["fwd_items"] > 0
        assert all(row["program"][k] <= limits[k] for k in limits)
        assert any(row["control_bf16"][k] > limits[k]
                   for k in row["control_bf16"])
        assert row["control_bf16"]["fwd_gap_nats"] > \
            limits["fwd_gap_nats"]
        assert row["control_bf16"]["domdec_gap"] > limits["domdec_gap"]
        # decided as a run decides it
        assert row["program_correct"] is True
        assert row["control_correct"] is False
