"""Kernel B4 (``csrc/lut_serve.cu``): its bound of one launch at the cell's
batch over the mean time of its recorded events, in percent."""

from bench.metrics._roofline import share


def read(run):
    return share(run, "lut_serve", ("lut_serve_chain_kernel",))
