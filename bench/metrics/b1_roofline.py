"""Kernel B1 (``csrc/fake_quant.cu``): its bound of one launch at the cell's
shapes over the mean time of its recorded events, in percent."""

from bench.metrics._roofline import share


def read(run):
    return share(run, "fake_quant", ("fq_column_kernel", "fq_general_kernel"))
