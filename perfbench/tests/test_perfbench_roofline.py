"""The frozen roofline arithmetic on shapes whose counts are known."""

import pytest

from perfbench import roofline


def test_gate_bound_on_known_shape():
    items = [(250, 400)] * 16
    cells, nbytes = roofline.gate_work(items)
    assert cells == 16 * 250 * 400
    assert nbytes == 16 * 254 + 37 * 4 * 400
    s = roofline.bound_s("fwd_parser", cells, nbytes)
    assert s == pytest.approx(1.6e6 * 19 / 67e12)


def test_decoding_bound_and_bytes_side():
    cells, nbytes = roofline.decoding_work([(100, 60), (100, 1200)])
    assert cells == 100 * 60 + 100 * 1200
    assert nbytes == 2 * (100 + 12 * 101 + 1) + 37 * 4 * (60 + 1200)
    # a kernel that moves many bytes for little work is bound by bytes
    assert roofline.bound_s("domdec", 1, 3.35e12) == pytest.approx(1.0)
    assert roofline.OPS_PER_CELL["domdec"] == 37
