"""The cost functions against counts worked out by hand at a small shape."""

import pytest

from benchmark import costs


def test_front_cost_by_hand():
    # C = 2 lanes, B = 8 rows, taps 3 / 5 / 7, d = 2, fanout, one Doppler row
    c, b, t1, t2, t3, d = 2, 8, 3, 5, 7, 2
    n2 = 4
    hist = (t1 - 1) * 2 * c + 2 * c + (t2 - 1) * c + (t3 - 1) * c  # 8 + 4 + 8 + 12 = 32
    assert hist == 32
    words = 2 * b + n2 * c + 2 * hist + t1 + t2 + t3 + 257  # 16 + 8 + 64 + 15 + 257
    words += 4 * 1 * c  # the four (1, C) tables
    flops = 2 * (b * 2 * c * t1 + n2 * c * t2) + 16 * b * c + 13 * n2 * c
    flops += 56 * b * c  # every lane-sample covered by its row
    assert (words, flops) == (368, 2 * (96 + 40) + 256 + 104 + 896)
    assert costs.front_cost(c, b, t1, t2, t3, d, fanout=True, s_rows=1, covered=b * c) == (4 * 368, flops)


def test_front_cost_time_major_reads_every_lane():
    fan = costs.front_cost(4, 16, 3, 3, 0, 1, fanout=True)[0]
    tm = costs.front_cost(4, 16, 3, 3, 0, 1, fanout=False)[0]
    assert tm - fan == 4 * (16 * 2 * 4 - 2 * 16)  # B x 2C words in place of one (2, B) stream


def test_front_cost_without_dc():
    _, flops = costs.front_cost(1, 4, 1, 1, 0, 1, fanout=True)
    assert flops == 2 * (4 * 2 * 1 + 4 * 1) + 16 * 4  # no DC term


def test_clock_cost_by_hand():
    # n = 100 rows, C = 2, suffix 64, 2 chunks of K = 30 slots, 40 symbols
    words = 100 * 2 + 64 * 2 + 4 * 2 + 129 * 8 + 2 * 30 * 2 + 2 * 2 + 4 * 2
    assert costs.clock_cost(100, 2, 64, 2, 30, 40) == (4 * words, 1200)


def test_step_cost_keeps_y3_on_the_chip():
    kw = dict(fanout=True, s_rows=0, covered=0.0)
    fb, ff = costs.front_cost(2, 8, 3, 3, 3, 2, **kw)
    sb, sf = costs.step_cost(2, 8, 3, 3, 3, 2, sfx=64, n_chunks=1, k=5, symbols=7, **kw)
    assert sf == ff + 30 * 7
    assert sb == fb - 4 * 4 * 2 + 4 * (2 * 64 * 2 + 8 * 2 + 129 * 8 + 5 * 2 + 2)


def test_bound_picks_the_larger():
    t, what = costs.bound_ms(3.35e9, 1.0)  # a GB at 3.35 TB/s: 1 ms
    assert what == "bytes" and t == pytest.approx(1.0)
    t, what = costs.bound_ms(1.0, 67e9)  # 67 GFLOP at 67 TFLOP/s: 1 ms
    assert what == "operations" and t == pytest.approx(1.0)
