"""The attention kernel's share of its roofline in the serving forward:
one layer's attention over (batch, tokens, 3 d) per block and request
(``yardstick.attention_work``), over the device time of the kernels named
``attention_kernel``."""
from perfbench import readers, yardstick


def read(s):
    w = s["widths"]
    work = yardstick.attention_work(s["mix"]["batch"], readers.tokens(w), w["embed_dim"])
    return readers.roofline_pct(s, readers.ATTENTION_KERNELS, work, w["depth"] * s["units"])
