"""What the per-layer readers (``metrics/*.py``) share.  A reader takes
the traced run's summary (``trace.profile_slice`` with the cell's
``widths``, ``mix``, ``classes`` and the untraced ``rest`` of the window)
and returns a number, or None where it finds nothing to read."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from perfbench import trace, yardstick

ATTENTION_KERNELS = ("attention_kernel",)
PQ_KERNELS = ("pq_",)


def kernels_per_unit(s: Dict[str, Any]) -> Optional[float]:
    n = sum(1 for e in s["device_events"] if e[3] == "kernel")
    return n / s["units"] if n else None


def idle_pct(s: Dict[str, Any]) -> Optional[float]:
    lo, hi = s["slice_range_us"]
    if hi <= lo or not s["device_events"]:
        return None
    return 100.0 * (1.0 - trace.busy_seconds(s) / ((hi - lo) / 1e6))


def rest_rate(s: Dict[str, Any], key: str) -> Optional[float]:
    """Images or units a second over the window's untraced part."""
    rest = s.get("rest") or {}
    return rest[key] / rest["seconds"] if rest.get("seconds", 0) > 0 and rest[key] else None


def roofline_pct(s: Dict[str, Any], needles: Tuple[str, ...], work: Dict[str, float],
                 count: int) -> Optional[float]:
    """``count`` times ``work``'s least time over the device time of the
    kernels matching ``needles``."""
    seconds, _ = trace.matching_seconds(s, needles)
    if seconds <= 0:
        return None
    return 100.0 * count * yardstick.least_time(work["flops"], work["bytes"]) / seconds


def tokens(w: Dict[str, int]) -> int:
    return (w["res"] // w["patch"]) ** 2 + 1


def pixels(w: Dict[str, int]) -> int:
    return (w["res"] // w["patch"]) ** 2
