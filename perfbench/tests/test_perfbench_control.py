"""The control at a size a test run holds: the reference in bfloat16
put in the device stages' place reads over the cell's limits, where
the program reads under them."""

import json

import pytest

from perfbench import control
from perfbench.tests.conftest import REPO


@pytest.mark.parametrize("cell,like", [("single400.tiny",
                                        "single400.std_dense"),
                                       ("fs84.tiny", None)])
def test_control_fails_program_passes(tiny_root, cell, like, capsys):
    """The standard cell's limits as committed; the frameshift cell's
    as the test checkout gives them, with its fs3 numbers failed by the
    control."""
    limits = json.loads(((REPO if like else tiny_root) / "perfbench"
                         / "workloads" / f"{like or cell}.json")
                        .read_text())["limits"]
    gaps = [k for k in limits if k.endswith(("_gap", "_gap_nats"))]
    rows = control.readings(cell, [3, 2**32 + 1], device="cpu",
                            root=tiny_root)
    capsys.readouterr()
    for row in rows:
        assert row["rc"] == 0 and row["fwd_items"] > 0
        assert set(row["program"]) == set(limits)
        assert all(row["program"][k] <= limits[k] for k in limits)
        for k in gaps:
            assert row["control_bf16"][k] > limits[k], k
        # decided as a run decides it
        assert row["program_correct"] is True
        assert row["control_correct"] is False
