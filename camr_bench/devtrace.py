"""The device trace of a short sub-window, reduced to a few numbers.

``torch.profiler`` records the host's ops and the card's kernels and
copies over a few steps; nothing is written to disk. From the raw
events this module takes the window's length (the span of one host-side
annotation around the steps), the seconds in which any device operation
ran (the union of their intervals), the device operations with the most
time, and the idle gaps of the device, each named by the innermost host
op that was running at its middle and summed by that name.
"""

from __future__ import annotations

import heapq
from collections import defaultdict
from dataclasses import dataclass

import torch
from torch.profiler import ProfilerActivity, profile, record_function

__all__ = ["Trace", "trace_steps", "reduce_events", "short_name"]

WINDOW = "camr_bench.traced_window"
#: entries in each list of the breakdown
TOP = 10
#: host events that name no host work of their own: the runtime and
#: driver calls under an op, the profiler's own buffers, and the
#: window's annotation
_NOT_HOST_OPS = ("cuda", "cu", "Activity Buffer", WINDOW)
#: longest name of a device op kept in the breakdown
NAME_CHARS = 120


@dataclass
class Trace:
    window_s: float
    busy_s: float
    device_ops: list     # [[name, seconds], ...], most time first
    idle_gaps: list      # [[host op, seconds], ...], most time first
    device_events: int

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s


def trace_steps(step, n: int, device: torch.device) -> Trace:
    """Run ``step()`` ``n`` times under the profiler, the device
    synchronised at both ends of the window."""
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            for _ in range(n):
                step()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    return reduce_events(prof.profiler.kineto_results.events())


def _union(intervals: list, lo: int, hi: int) -> list:
    """Disjoint sorted intervals covering ``intervals`` within ``[lo,
    hi)``."""
    out = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_events(events) -> Trace:
    """The :class:`Trace` of raw kineto events (``start_ns``,
    ``duration_ns``, ``name``, ``device_type``)."""
    cuda = torch.autograd.DeviceType.CUDA
    lo = hi = None
    host, dev = [], []
    for e in events:
        start, end, name = e.start_ns(), e.start_ns() + e.duration_ns(), e.name()
        if name == WINDOW or e.is_user_annotation():
            if e.device_type() != cuda and name == WINDOW:
                lo, hi = start, end
        elif e.device_type() == cuda:
            dev.append((start, end, short_name(name)))
        elif not name.startswith(_NOT_HOST_OPS):
            host.append((start, end, name))
    if lo is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} annotation")
    busy = _union([(a, b) for a, b, _ in dev], lo, hi)
    per_op: dict = defaultdict(int)
    for a, b, name in dev:
        per_op[name] += b - a
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = b
    if hi > t:
        gaps.append((t, hi))
    idle = _name_gaps(gaps, host)
    top = lambda d: [[k, v / 1e9] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return Trace(window_s=(hi - lo) / 1e9,
                 busy_s=sum(b - a for a, b in busy) / 1e9,
                 device_ops=top(per_op), idle_gaps=top(idle),
                 device_events=len(dev))


def short_name(name: str) -> str:
    """A kernel's name without its return type and argument list, cut to
    :data:`NAME_CHARS`."""
    name = name.removeprefix("void ").replace("(anonymous namespace)",
                                              "{anonymous}")
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i > 0:
            name = name[:i].rstrip()
            break
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


def _name_gaps(gaps: list, host: list) -> dict:
    """Idle nanoseconds by the innermost host op (the latest started of
    those still running, on any thread) at each gap's middle."""
    host.sort()
    out: dict = defaultdict(int)
    active: list = []          # max-heap on start: (-start, end, name)
    i = 0
    for a, b in gaps:          # gaps are in time order
        mid = (a + b) // 2
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(active, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        while active and active[0][1] <= mid:
            heapq.heappop(active)
        out[active[0][2] if active else "host: no op running"] += b - a
    return out
