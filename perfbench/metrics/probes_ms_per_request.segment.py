"""Device milliseconds per segment request of the kernels launched in
the probes at the input's resolution (``equss.probes``: the
linear and cluster logits, their resize to 224^2 and the argmaxes), each put down to the innermost span open when its launch
started (``readers.by_span``)."""
from perfbench import readers


def read(s):
    return readers.span_ms(s, "equss.probes")
