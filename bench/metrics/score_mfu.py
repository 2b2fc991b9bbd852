"""The scored batch's share of the H100's float32 peak: the chain's integer
operations a row (``bench/counts/roofline.pid_chain_ops``) times the
window's rows a second, over 67 T op/s, in percent."""

from bench.counts.roofline import FP32_OPS_PER_S


def read(run):
    if "rows" not in run or run["window_s"] <= 0:
        return None
    return run["ops_per_row"] * run["rows"] / run["window_s"] / FP32_OPS_PER_S * 100
