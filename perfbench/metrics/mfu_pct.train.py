"""Model FLOPs of one train step (``yardstick.train_flops_per_step``) times
the steps a second of the traced run's untraced part, over the bf16
peak."""
from perfbench import readers, yardstick


def read(s):
    rate = readers.rest_rate(s, "units")
    if rate is None:
        return None
    flops = yardstick.train_flops_per_step(s["widths"], s["mix"]["batch"], s["classes"])
    return 100.0 * rate * flops / yardstick.PEAK_BF16_FLOPS
