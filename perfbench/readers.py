"""What the per-layer readers (``metrics/*.py``) share.  A reader takes
the traced run's summary (``trace.profile_slice`` with the cell's
``widths``, ``mix``, ``classes`` and the untraced ``rest`` of the window)
and returns a number, or None where it finds nothing to read.  Readers
of the program's spans read ``by_span``: ``spans.attribute``'s rule, the
one ``python3 -m perfbench.spans`` prints by."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from perfbench import cell as cells, spans, trace, yardstick

ATTENTION_KERNELS = ("attention_kernel",)
PQ_KERNELS = ("pq_",)


def by_span(s: Dict[str, Any]) -> Dict[str, Any]:
    """The slice per unit by span (``spans.attribute``): device ms by the
    innermost span, the benchmark's or the program's, open when its
    launch started (``unlinked`` where the launch was not seen), idle ms
    by the span open at the gap's middle, blocking calls by the span they
    started in."""
    device = [(n, b, e, at) for (n, b, e, _), at in zip(s["device_events"], s["launch_us"])]
    return spans.attribute(s["host_spans"] + s["program_spans"], device, s["blocking"],
                           s["slice_range_us"], s["units"])


def span_ms(s: Dict[str, Any], name: str) -> Optional[float]:
    """Device ms per unit launched inside span ``name``; None where none
    was."""
    ms = by_span(s)["device_ms_by_span"].get(name)
    return ms if ms else None


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


def tokens(w: Dict[str, Any]) -> int:
    """The tokens one image puts through attention, by its backbone."""
    return cells.backbone(w).tokens(w)


def pixels(w: Dict[str, int]) -> int:
    return (w["res"] // w["patch"]) ** 2
