"""Device milliseconds per segment request of the kernels launched in
the expansion head's forward (``equss.head``: its three f32 GEMMs), each put down to the innermost span open when its launch
started (``readers.by_span``)."""
from perfbench import readers


def read(s):
    return readers.span_ms(s, "equss.head")
