"""The traced window: ``torch.profiler`` with device activity around one
call, reduced to device intervals, kernel time by name, busy and idle time
and what the host was doing while the device idled.

Only device activity is recorded (kernels, copies and fills on the card,
and the CUDA runtime calls the host made), not the CPU operators: the
operator events cost far more to record and to read at the thousands of
launches an iteration of the batched loops makes.  On a machine without a
card the same reduction runs over whatever the profiler gives and finds no
device interval.
"""

from __future__ import annotations

import dataclasses
import re


@dataclasses.dataclass
class Trace:
    """The reduced trace of one window (times in seconds)."""

    window_s: float
    busy_s: float
    kernels: list  # (name, duration_s) of every kernel launch, in start order
    idle_by_host: dict  # host activity during device idle -> seconds
    device_by_name: dict  # kernel or copy name -> device seconds

    def kernel_s(self, pattern: str) -> tuple[int, float]:
        """(launches, device seconds) of the kernels whose name matches."""
        rx = re.compile(pattern)
        hits = [d for name, d in self.kernels if rx.search(name)]
        return len(hits), float(sum(hits))


def _events(prof):
    """(name, is_device, start_ns, end_ns) of every profiler event."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        out.append((e.name(), e.device_type() == cuda, start, start + e.duration_ns()))
    return out


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def reduce(events, t0_ns: int, t1_ns: int) -> Trace:
    """The :class:`Trace` of ``events`` (see :func:`_events`) clipped to the
    window [t0_ns, t1_ns] on the profiler's clock."""
    dev = [(n, max(s, t0_ns), min(e, t1_ns)) for n, d, s, e in events
           if d and e > t0_ns and s < t1_ns]
    host = sorted((s, e, n) for n, d, s, e in events
                  if not d and n.startswith("cu") and e > t0_ns and s < t1_ns)
    busy = _union((s, e) for _, s, e in dev)
    by_name = {}
    kernels = []
    for n, s, e in sorted(dev, key=lambda t: t[1]):
        by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-9
        if not n.startswith(("Memcpy", "Memset")):
            kernels.append((n, (e - s) * 1e-9))
    # Idle gaps, each put down to the runtime call in progress at its
    # middle (a synchronize or a copy back is the host waiting; a launch is
    # the host issuing; none is Python between calls).
    gaps, prev = [], t0_ns
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if t1_ns > prev:
        gaps.append((prev, t1_ns))
    idle = {}
    j = 0
    for gs, ge in gaps:
        mid = (gs + ge) // 2
        while j < len(host) and host[j][1] < mid:
            j += 1
        what = "host: no CUDA call (Python, the loop's own work)"
        for s, e, n in host[j:j + 64]:
            if s > mid:
                break
            if s <= mid <= e:
                what = n
                break
        idle[what] = idle.get(what, 0.0) + (ge - gs) * 1e-9
    return Trace(window_s=(t1_ns - t0_ns) * 1e-9,
                 busy_s=sum(e - s for s, e in busy) * 1e-9,
                 kernels=kernels, idle_by_host=idle, device_by_name=by_name)


def traced(fn, device: str):
    """``(fn(), Trace)``: one call of ``fn`` under the profiler, the window
    from the profiler clock's reading at the call's start to its end."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    on_card = str(device).startswith("cuda")
    activity = ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU
    with profile(activities=[activity]) as prof:
        if on_card:
            torch.cuda.synchronize()
        t0 = time.time_ns()
        out = fn()
        if on_card:
            torch.cuda.synchronize()
        t1 = time.time_ns()
    events = _events(prof)
    # The profiler stamps its events on the wall clock in ns, where the
    # window is read.
    starts = sorted(s for _, _, s, _ in events)
    if starts and not t0 <= starts[len(starts) // 2] <= t1:
        raise RuntimeError("the profiler's events fall outside the window read on the"
                           " wall clock: the traced window cannot be placed")
    return out, reduce(events, t0, t1)
