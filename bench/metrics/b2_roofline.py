"""Kernel B2 (``csrc/lut_dense.cu``): its bound of one launch at the cell's
shapes over the mean time of its recorded events, in percent."""

from bench.metrics._roofline import share


def read(run):
    return share(run, "lut_dense", ("lut_dense_forward_kernel",))
