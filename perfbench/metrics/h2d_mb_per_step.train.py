"""Megabytes (1e6 bytes) per train step that the program copied from the
host to the card (its ``h2d_bytes`` counter, ``parallel.mesh.shard_batch``)
over the traced slice."""


def read(s):
    n = s["counters"].get("h2d_bytes", 0)
    return n / 1e6 / s["units"] if n > 0 else None
