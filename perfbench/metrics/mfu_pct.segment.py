"""Model FLOPs of the serving forward (``yardstick.segment_flops_per_image``)
times the images a second of the traced run's untraced part, over the
bf16 peak."""
from perfbench import readers, yardstick


def read(s):
    rate = readers.rest_rate(s, "images")
    if rate is None:
        return None
    return 100.0 * rate * yardstick.segment_flops_per_image(s["widths"]) \
        / yardstick.PEAK_BF16_FLOPS
