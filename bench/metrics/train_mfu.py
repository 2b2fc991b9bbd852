"""The step's share of the H100's float32 peak: the operations one sample's
forward and backward need through every LUT-Dense layer (as kernels B2 and
B3 count them, ``bench/counts/roofline.py``) times the window's samples a
second, over 67 TFLOP/s, in percent."""

from bench.counts.roofline import FP32_OPS_PER_S


def read(run):
    if "samples" not in run or run["window_s"] <= 0:
        return None
    return run["ops_per_sample"] * run["samples"] / run["window_s"] / FP32_OPS_PER_S * 100
