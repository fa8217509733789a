"""Kernel launches on the device per train step, in the traced slice."""
from perfbench import readers


def read(s):
    return readers.kernels_per_unit(s)
