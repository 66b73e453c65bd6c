"""Reading a torch.profiler trace of a window: device busy time, time by
kernel, and the longest idle gaps by what the host was doing in them.

Times come from the profiler's events (CUPTI on the card), in microseconds
on one timeline for host and device. Every device activity counts as busy:
kernels, copies and fills.
"""
from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict

TOP = 10
GAP_SCAN = 4000      # host ops looked back at, per gap, for the innermost one


@dataclasses.dataclass
class Trace:
    window_s: float                  # host seconds the profiler ran
    busy_s: float                    # union of device activity, seconds
    kernel_s: dict                   # name -> device seconds
    kernel_n: dict                   # name -> launches
    device_ops: list                 # [[name, s]] the TOP longest in total
    idle_gaps: list                  # [[host op, s]] idle time by host op, TOP


def _events(prof):
    """(device, host) lists of (name, start_us, end_us)."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        item = (e.name, float(tr.start), float(tr.end))
        if e.device_type == DeviceType.CUDA:
            dev.append(item)
        elif e.device_type == DeviceType.CPU:
            host.append(item)
    return dev, host


def _union(intervals):
    """Merged (start, end) intervals of a list sorted by start."""
    out = []
    for a, b in intervals:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _host_label(host, starts, t, next_kernel):
    """What the host did during an idle gap around time t: the recorded host
    call that covers t and started last (the deepest nested), else its
    untraced work before it launched the kernel that ends the gap."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 1 - GAP_SCAN), -1):
        if host[j][2] >= t:
            return host[j][0]
    return f"host work, then {next_kernel[:120]}"


def read(prof, window_s: float) -> Trace:
    """Summarise the device activity of a profile that ran window_s host
    seconds; its first and last events bound it."""
    dev, host = _events(prof)
    if not dev and not host:
        return Trace(window_s, 0.0, {}, {}, [], [])
    t0_us = min(s for _, s, _ in host + dev)
    t1_us = max(e for _, _, e in host + dev)
    dev = sorted((n, max(s, t0_us), min(e, t1_us)) for n, s, e in dev if e > t0_us and s < t1_us)
    dev.sort(key=lambda x: x[1])
    kernel_s, kernel_n = defaultdict(float), defaultdict(int)
    for n, s, e in dev:
        kernel_s[n] += (e - s) / 1e6
        kernel_n[n] += 1
    busy = _union([(s, e) for _, s, e in dev])
    busy_s = sum(b - a for a, b in busy) / 1e6
    host.sort(key=lambda x: x[1])
    starts = [s for _, s, _ in host]
    gaps = defaultdict(float)
    edges = [t0_us] + [x for ab in busy for x in ab] + [t1_us]
    dev_starts = [s for _, s, _ in dev]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            k = bisect.bisect_left(dev_starts, b)
            nxt = dev[k][0] if k < len(dev) else "the end of the trace"
            gaps[_host_label(host, starts, (a + b) / 2, nxt)] += (b - a) / 1e6
    top_ops = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return Trace(window_s, busy_s, dict(kernel_s), dict(kernel_n),
                 [[n[:200], s] for n, s in top_ops], [[n[:200], s] for n, s in top_gaps])


def launches_of(trace: Trace, fragment: str) -> tuple[int, float]:
    """(launches, device seconds) of the kernels whose name holds `fragment`."""
    n = sum(c for k, c in trace.kernel_n.items() if fragment in k)
    s = sum(v for k, v in trace.kernel_s.items() if fragment in k)
    return n, s
