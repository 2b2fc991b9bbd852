"""The frozen bounds and operation counts against counts worked by hand at
one shape each (the JSC-HLF layers at B = 16600, the PID chain at ctx 100
with its initial widths)."""

import pytest

from bench.counts import roofline as rl

B = 16600


def test_peaks():
    assert rl.HBM_BYTES_PER_S == 3.35e12 and rl.FP32_OPS_PER_S == 67e12
    assert rl.bound_s(3.35e12, 1.0) == (1.0, "bytes")
    assert rl.bound_s(1.0, 67e12) == (1.0, "operations")


def test_b1_at_layer0():
    # n = 16600 * 16 * 20 = 5,312,000 elements
    t, by = rl.b1_contiguous(B, 16, 20)
    assert by == "bytes" and t == pytest.approx((8 * 5_312_000 + 8 * 320) / 3.35e12)
    t, by = rl.b1_expand(B, 16, 20)
    assert by == "bytes" and t == pytest.approx((4 * 5_312_000 + 4 * B * 16 + 2560) / 3.35e12)
    assert t * 1e3 == pytest.approx(0.00666, abs=5e-6)


def test_b2_b3_at_layer1():
    # 20 -> 5, H = 8: 100 cells; forward 5*8 + 14 = 54 a cell, backward
    # 16*8 + 30 = 158 a cell
    t, by = rl.b2(B, 20, 5, 8)
    assert by == "operations" and t == pytest.approx(B * 100 * 54 / 67e12)
    t, by = rl.b3(B, 20, 5, 8)
    assert by == "operations" and t == pytest.approx(B * 100 * 158 / 67e12)
    assert t * 1e3 == pytest.approx(0.00391, abs=5e-6)
    # bytes: x, y and the eight arguments (3*20*8*5 + 5*100 elements)
    assert rl.b2(1, 20, 5, 8)[0] == pytest.approx(4 * (20 + 5 + 2400 + 500) / 3.35e12)


def test_train_ops_per_sample():
    # (16*20 + 20*5) cells * (54 + 158)
    assert rl.lut_stack_train_ops([16, 20, 5], 8) == 420 * 212 == 89_040


def test_pid_chain_ops_at_ctx100():
    stages = [{"kind": "mac", "sites": 5, "c_in": 20, "c_out": 8, "relu": True},
              {"kind": "lut", "sites": 5, "c_in": 24, "c_out": 8, "shift": 192},
              {"kind": "lut", "sites": 5, "c_in": 24, "c_out": 4, "shift": 0},
              {"kind": "lut", "sites": 5, "c_in": 4, "c_out": 1, "shift": 0},
              {"kind": "sum", "sites": 5, "c": 1}]
    # front 5*(20*10 + 8*(20*3 + 1 + 10)); lc1 5*(192*4 + 192*8 + 8);
    # lc2 5*(96*4 + 4); head 5*(4*4 + 1); sum 5
    assert rl.pid_chain_ops(stages) == 3840 + 11560 + 1940 + 85 + 5 == 17430
    with pytest.raises(ValueError):
        rl.pid_chain_ops([{"kind": "conv", "sites": 1}])


def test_b4_bound():
    t, by = rl.b4(1024, 3000, 1, 600_000, 522_900)
    assert by == "operations" and t == pytest.approx(522_900 * 1024 / 67e12)
    assert rl.pid_chain_bytes(2, 10, 1, 100) == 4 * 2 * 11 + 100
