"""The share of the traced slice in which no operation ran on the device
(100 minus the union of the device events' intervals)."""
from perfbench import readers


def read(s):
    return readers.idle_pct(s)
