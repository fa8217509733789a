"""Device milliseconds per segment request of the kernels launched in
the backbone's forward (``equss.backbone``: the ViT's GEMMs, LayerNorms,
GELU and the attention kernel), each put down to the innermost span open when its launch
started (``readers.by_span``)."""
from perfbench import readers


def read(s):
    return readers.span_ms(s, "equss.backbone")
