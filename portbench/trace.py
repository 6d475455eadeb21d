"""Reduction of a ``torch.profiler`` trace to the device's busy time, its
idle gaps and its operations.

Busy time is the union of the device operations' intervals (kernels,
copies, sets) inside the traced window, so that operations overlapping on
several streams are counted once.  An idle gap is a stretch of the window
in which no device operation ran; it is named by the innermost host
operation that covered its middle (on any thread), or "host: no traced op"
where none did.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence, Tuple

#: The host span, recorded by the harness around the traced feeds, that
#: bounds the traced window.
WINDOW_SPAN = "portbench.traced_window"

Interval = Tuple[int, int]


def union(intervals: Sequence[Interval], lo: int, hi: int) -> List[Interval]:
    """The merged, sorted intervals of ``intervals`` clipped to [lo, hi]."""
    out: List[Interval] = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def gaps(busy: Sequence[Interval], lo: int, hi: int) -> List[Interval]:
    """The stretches of [lo, hi] that no interval of ``busy`` (merged,
    sorted) covers."""
    out: List[Interval] = []
    t = lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def name_gaps(gap_list: Sequence[Interval],
              host: Sequence[Tuple[int, int, str]]) -> List[str]:
    """For each gap, the innermost host operation ``(start, end, name)``
    covering its middle: of those that started before the middle and end
    after it, the one that started last."""
    order = sorted(range(len(gap_list)),
                   key=lambda i: gap_list[i][0] + gap_list[i][1])
    events = sorted(host)
    names = ["host: no traced op"] * len(gap_list)
    heap: List[Tuple[int, int, str]] = []
    j = 0
    for i in order:
        mid2 = gap_list[i][0] + gap_list[i][1]   # twice the middle
        while j < len(events) and 2 * events[j][0] <= mid2:
            s, e, n = events[j]
            heapq.heappush(heap, (-s, e, n))
            j += 1
        while heap and 2 * heap[0][1] < mid2:
            heapq.heappop(heap)
        if heap:
            names[i] = heap[0][2]
    return names


def top(totals: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]


class Trace:
    """Device and host events of one profiled window.

    ``device``: ``(name, start_ns, end_ns)`` of every device operation;
    ``host``: ``(start_ns, end_ns, name)`` of every host operation;
    ``window``: the traced window's ``(start_ns, end_ns)``.
    """

    def __init__(self, device: List[Tuple[str, int, int]],
                 host: List[Tuple[int, int, str]], window: Interval):
        self.device = device
        self.host = host
        self.window = window
        lo, hi = window
        self.busy = union([(s, e) for _, s, e in device], lo, hi)

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        from torch.autograd import DeviceType

        device, host = [], []
        window: Optional[Interval] = None
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            s, d = e.start_ns(), e.duration_ns()
            if name == WINDOW_SPAN:
                if e.device_type() != DeviceType.CUDA:
                    window = (s, s + d)
            elif e.device_type() == DeviceType.CUDA:
                # A host span's mirror on the device's timeline is an
                # annotation, not work.
                if not getattr(e, "is_user_annotation", lambda: False)():
                    device.append((name, s, s + d))
            else:
                host.append((s, s + d, name))
        if window is None:
            raise RuntimeError(f"trace has no {WINDOW_SPAN!r} span")
        return cls(device, host, window)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-9

    def ops(self, *substrings: str) -> List[Tuple[str, int, int]]:
        """Device operations inside the window whose name contains any of
        ``substrings``."""
        lo, hi = self.window
        return [ev for ev in self.device
                if lo <= ev[1] and ev[2] <= hi
                and any(k in ev[0] for k in substrings)]

    def breakdown(self, n: int = 10) -> dict:
        """The device operations that took most time and the host activity
        under the device's idle time, each as ``[name, seconds]``."""
        lo, hi = self.window
        by_op: Dict[str, float] = {}
        for name, s, e in self.device:
            s, e = max(s, lo), min(e, hi)
            if e > s:
                by_op[name[:160]] = by_op.get(name[:160], 0.0) + (e - s) * 1e-9
        gap_list = gaps(self.busy, lo, hi)
        by_host: Dict[str, float] = {}
        for (s, e), name in zip(gap_list, name_gaps(gap_list, self.host)):
            by_host[name[:160]] = by_host.get(name[:160], 0.0) + (e - s) * 1e-9
        return {"device_ops": top(by_op, n), "idle_gaps": top(by_host, n)}
