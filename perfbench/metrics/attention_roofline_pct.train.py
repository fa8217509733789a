"""The attention kernel's share of its roofline in the train step: the
backbone's pass over [img; img_pos], 2 b images, per block and step."""
from perfbench import readers, yardstick


def read(s):
    w = s["widths"]
    work = yardstick.attention_work(2 * s["mix"]["batch"], readers.tokens(w), w["embed_dim"])
    return readers.roofline_pct(s, readers.ATTENTION_KERNELS, work, w["depth"] * s["units"])
