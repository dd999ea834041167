"""work.py's counts against values worked out by hand at n=38 and n=190."""

import pytest

from qpnbench import work


@pytest.mark.parametrize("n, per_pivot", [
    # 2·n·(3n+1) + 2·n·(3n+2)
    (38, 2 * 38 * 115 + 2 * 38 * 116),      # 8740 + 8816
    (190, 2 * 190 * 571 + 2 * 190 * 572),   # 216980 + 217360
])
def test_k1_flops(n, per_pivot):
    assert per_pivot in (17556, 434340)
    assert work.k1_flops(n, 256, 70.0) == 70.0 * 256 * per_pivot


@pytest.mark.parametrize("n, per_lane", [
    # in: tableau n(3n+2), three (3n+1) vectors, two n, four scalars (f32)
    # and the basis (i32); out: n + (3n+1) values, n + 2 ints
    (38, 4 * (38 * 116 + 3 * 115 + 76 + 4) + 4 * 38
     + 4 * (38 + 115) + 4 * 40),
    (190, 4 * (190 * 572 + 3 * 571 + 380 + 4) + 4 * 190
     + 4 * (190 + 571) + 4 * 192),
])
def test_k1_bytes(n, per_lane):
    assert per_lane in (20256, 447680)
    assert work.k1_bytes(n, 256) == 256 * per_lane


@pytest.mark.parametrize("n, per_step, per_lane_bytes", [
    (38, 2 * (2 * 38 * 38 + 5 * 38), 4 * (38 * 38 + 4 * 38 + 1 + 38)),
    (190, 2 * (2 * 190 * 190 + 5 * 190), 4 * (190 * 190 + 4 * 190 + 1 + 190)),
])
def test_k2(n, per_step, per_lane_bytes):
    assert (per_step, per_lane_bytes) in ((6156, 6540), (146300, 148204))
    assert work.k2_flops(n, 256, 20000) == 256 * 20000 * per_step
    assert work.k2_bytes(n, 256) == 256 * per_lane_bytes


def test_least_time_takes_the_longer_bound():
    flops, nbytes = 67e12 * 2e-3, 3.35e12 * 1e-3
    assert work.least_s(flops, nbytes) == pytest.approx(2e-3)
    assert work.least_s(flops / 4, nbytes) == pytest.approx(1e-3)
    # the flagship's K1: operations bound it
    f, b = work.k1_flops(38, 256, 69.0), work.k1_bytes(38, 256)
    assert f / 67e12 > b / 3.35e12
