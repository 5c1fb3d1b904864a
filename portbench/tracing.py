"""Spans and the profiler: what a traced run reads from the device.

``span(name)`` marks a call into the program: with tracing on it is a
``torch.profiler.record_function`` (so the trace names the host's time)
and a pair of CUDA events recorded in the stream (so the device's time of
the call is read after the window, with no synchronisation inside it).
With tracing off it does nothing.

``reduce_trace`` turns a ``torch.profiler`` run over one window into the
numbers the per-layer readers take: the device's busy seconds (the union
of its operations' intervals inside the window), its idle gaps named by
what the host was doing at their start, device seconds by host operator
(self time: aten ops, the program's custom ops) and by kernel name. The interval arithmetic is in plain
functions, so it is tested on fixed inputs.
"""
from __future__ import annotations

import contextlib
import heapq
from collections import defaultdict

WINDOW_SPAN = "portbench::window"
SMALL_GAP_US = 10.0
SMALL_GAP_NAME = "_gaps_under_10_us_"
HOST_IDLE_NAME = "_host_outside_any_op_"


def union_intervals(spans):
    """Sorted, merged (start, end) intervals of ``spans``."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(spans, lo, hi):
    return [(max(a, lo), min(b, hi)) for a, b in spans if b > lo and a < hi]


def busy_time(spans, lo, hi):
    """Length of the union of ``spans`` inside [lo, hi]."""
    return sum(b - a for a, b in union_intervals(clip(spans, lo, hi)))


def gaps(spans, lo, hi):
    """The intervals of [lo, hi] that no span covers."""
    out, t = [], lo
    for a, b in union_intervals(clip(spans, lo, hi)):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if t < hi:
        out.append((t, hi))
    return out


def name_gaps(gap_list, host_events):
    """Seconds of idle gap by the name of what the host was doing at each
    gap's start: the host event (start, end, name), of any thread, that
    started last among those still open then. Gaps under
    ``SMALL_GAP_US`` are counted together."""
    ev = sorted(host_events)
    by = defaultdict(float)
    open_, i = [], 0
    for a, b in sorted(gap_list):
        if b - a < SMALL_GAP_US:
            by[SMALL_GAP_NAME] += (b - a) / 1e6
            continue
        while i < len(ev) and ev[i][0] <= a:
            heapq.heappush(open_, (-ev[i][0], ev[i][1], ev[i][2]))
            i += 1
        while open_ and open_[0][1] < a:
            heapq.heappop(open_)
        by[open_[0][2] if open_ else HOST_IDLE_NAME] += (b - a) / 1e6
    return dict(by)


def top(d, n=10):
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def reduce_trace(prof):
    """The traced window's readings from a finished ``torch.profiler``
    run whose window was wrapped in ``record_function(WINDOW_SPAN)``.
    Times in seconds."""
    from torch.autograd import DeviceType
    device, host, window = [], [], None
    kernels = defaultdict(float)
    for ev in prof.events():
        a, b = ev.time_range.start, ev.time_range.end
        if ev.device_type == DeviceType.CPU:
            if ev.name == WINDOW_SPAN:
                window = (a, b)
            host.append((a, b, ev.name))
        elif ev.device_type == DeviceType.CUDA:
            if getattr(ev, "is_user_annotation", False) \
                    or ev.name.startswith("portbench::"):
                continue
            device.append((a, b))
            kernels[ev.name] += (b - a) / 1e6
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    lo, hi = window
    host = [h for h in host if h[2] != WINDOW_SPAN]
    ops = defaultdict(float)
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU \
                and not e.key.startswith("portbench::"):
            ops[e.key] += getattr(e, "self_device_time_total", 0.0) / 1e6
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": busy_time(device, lo, hi) / 1e6,
        "device_events": len(device),
        "ops": {k: v for k, v in ops.items() if v > 0},
        "kernels": dict(kernels),
        "idle_gaps": name_gaps(gaps(device, lo, hi), host),
    }


class Spans:
    """Named spans around calls into the program (see the module
    docstring). ``ms(name)`` gives each span's device milliseconds once
    the window has been synchronised."""

    def __init__(self, torch, on, device):
        self.torch, self.on = torch, on
        self.cuda = on and device.type == "cuda"
        self.events = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name):
        if not self.on:
            yield
            return
        with self.torch.profiler.record_function(name):
            if self.cuda:
                a = self.torch.cuda.Event(enable_timing=True)
                b = self.torch.cuda.Event(enable_timing=True)
                a.record()
                yield
                b.record()
                self.events[name].append((a, b))
            else:
                yield

    def ms(self, name):
        return [a.elapsed_time(b) for a, b in self.events.get(name, [])]
