"""Blocking runtime calls (``cuda{Stream,Device,Event}Synchronize``) per
train step, each holding the host until the card has drained: those
started inside a span (``readers.by_span``), so that the slice's own
closing synchronisation is not counted.  None without device events (no
card)."""
from perfbench import readers


def read(s):
    if not s["device_events"]:
        return None
    syncs = readers.by_span(s)["blocking_calls_by_span"]
    return sum(n for span, n in syncs.items() if span != "host")
