"""Device milliseconds per train step of the kernels launched in the
step's one backward (``equss.backward``: autograd's thread launches them
while the step's thread waits inside the span), by ``readers.by_span``."""
from perfbench import readers


def read(s):
    return readers.span_ms(s, "equss.backward")
