"""Kernel launches on the device per segment request, in the traced
slice (the host's issue cost grows with them)."""
from perfbench import readers


def read(s):
    return readers.kernels_per_unit(s)
