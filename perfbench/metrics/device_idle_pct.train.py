"""The share of the traced slice in which no operation ran on the device."""
from perfbench import readers


def read(s):
    return readers.idle_pct(s)
