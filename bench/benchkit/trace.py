"""Reduction of a profiler trace of the traced stretch to the numbers the
per-layer readers and the result's ``device`` and ``breakdown`` carry.

Input: the stretch's bounds and two lists of ``(name, start_ns, end_ns)``,
the device's operations (kernels, copies, fills) and the harness's host
spans.  All figures are seconds; nothing is rounded.
"""
from __future__ import annotations

from collections import defaultdict

TOP = 10


def _clip(events, lo: int, hi: int):
    return [(n, max(s, lo), min(e, hi)) for n, s, e in events if e > lo and s < hi]


def _union(events) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for _, s, e in sorted(events, key=lambda t: t[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _label(gap: tuple[int, int], spans) -> str:
    """The host span that overlaps the gap most; ``host`` where none does
    (the harness's own loop between spans)."""
    best, name = 0, "host"
    for n, s, e in spans:
        overlap = min(e, gap[1]) - max(s, gap[0])
        if overlap > best:
            best, name = overlap, n
    return name


def reduce(lo_ns: int, hi_ns: int, device, spans) -> dict:
    """``busy_s`` (the union of the device's operations), ``window_s``,
    ``device_s`` (the sum of their durations), ``device_ops`` (the ten
    names that took most time) and ``idle_gaps`` (the ten longest gaps,
    each named by the host span it fell in)."""
    device = _clip(device, lo_ns, hi_ns)
    spans = _clip(spans, lo_ns, hi_ns)
    busy = _union(device)
    by_name: dict[str, int] = defaultdict(int)
    for n, s, e in device:
        by_name[n] += e - s
    edges = [lo_ns] + [t for iv in busy for t in iv] + [hi_ns]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    return {
        "window_s": (hi_ns - lo_ns) * 1e-9,
        "busy_s": sum(e - s for s, e in busy) * 1e-9,
        "device_s": sum(by_name.values()) * 1e-9,
        "device_ops": [[n, t * 1e-9] for n, t in
                       sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:TOP]],
        "idle_gaps": [[_label(g, spans), (g[1] - g[0]) * 1e-9] for g in gaps[:TOP]],
    }
