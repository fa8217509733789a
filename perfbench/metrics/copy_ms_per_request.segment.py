"""Device milliseconds of host<->device copies per segment request, in the
traced slice."""


def read(s):
    ms = sum(e - b for _, b, e, kind in s["device_events"] if kind == "memcpy") / 1e3
    return ms / s["units"] if ms > 0 else None
