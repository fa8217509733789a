"""The PQ assignment's share of its roofline in the serving forward: one
assignment of every feature pixel of the request per request
(``yardstick.pq_work``), over the device time of the kernels whose name
holds ``pq_``."""
from perfbench import readers, yardstick


def read(s):
    w = s["widths"]
    work = yardstick.pq_work(s["mix"]["batch"] * readers.pixels(w), w["hidden"], w["num_pq"],
                             w["num_codebook"])
    return readers.roofline_pct(s, readers.PQ_KERNELS, work, s["units"])
