"""Device milliseconds per train step of the kernels launched in the
three Adams' steps and the clip (``equss.optimizer``), by
``readers.by_span``."""
from perfbench import readers


def read(s):
    return readers.span_ms(s, "equss.optimizer")
