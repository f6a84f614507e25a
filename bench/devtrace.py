"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over a steady
span of the window, started and stopped at step boundaries after a
``torch.cuda.synchronize()``, and what the per-layer readers take from it.

``Tracer`` is driven by the traffic driver through ``Run.boundary``; the
probes (``bench/probes``) record the launches of the port's kernels while it
runs.  ``DeviceTrace`` holds the device's events (kernels, copies, sets) and
the host's, on the profiler's clock, cut to the span of the
``bench.traced`` annotation: its busy seconds (the union of device
intervals), each kernel's time by name, the idle gaps and what the host was
doing in each.  Nothing here runs at import.
"""
from __future__ import annotations

import heapq
import time
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

TRACED = "bench.traced"     # the annotation that spans the traced window
ANNOTATION = "bench."       # the prefix of the drivers' annotations


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def warm(device) -> None:
    """Start and stop a profiler once: the first start initialises the
    tracing library, which can take seconds that belong to set-up."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    _sync(device)
    with profile(activities=activities):
        pass


class Tracer:
    """Profiles the window from ``after_s`` after its start for ``span_s``
    seconds (rounded up to whole steps: it starts and stops at boundaries)."""

    def __init__(self, device, after_s: float, span_s: float, probes):
        self.device, self.after_s, self.span_s = device, after_s, span_s
        self.probes = probes
        self.state = "waiting"          # → "on" → "done"
        self._prof = self._span = None
        self.t_start = self.t_stop = None

    @property
    def on(self) -> bool:
        return self.state == "on"

    def boundary(self, now: float, window_start: float) -> None:
        if self.state == "waiting" and now - window_start >= self.after_s:
            self._start()
        elif self.state == "on" and now - self.t_start >= self.span_s:
            self.stop()

    def _start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        _sync(self.device)
        self._prof = profile(activities=activities)
        self._prof.start()
        self._span = torch.profiler.record_function(TRACED)
        self._span.__enter__()
        self.probes.active = True
        self.t_start = time.perf_counter()
        self.state = "on"

    def stop(self) -> None:
        if self.state != "on":
            return
        _sync(self.device)
        self.t_stop = time.perf_counter()
        self.probes.active = False
        self._span.__exit__(None, None, None)
        self._prof.stop()
        self.state = "done"

    def trace(self) -> Optional["DeviceTrace"]:
        if self.state != "done":
            return None
        return DeviceTrace.from_profile(self._prof)


def _kineto_events(prof) -> Iterable[Tuple[str, bool, int, int, bool]]:
    """(name, on the device, start ns, end ns, a user annotation) of every
    event the profiler kept."""
    from torch.autograd import DeviceType
    for e in prof.profiler.kineto_results.events():
        if hasattr(e, "start_ns"):
            start, dur = e.start_ns(), e.duration_ns()
        else:                                   # older torch: microseconds
            start, dur = e.start_us() * 1000, e.duration_us() * 1000
        yield (e.name(), e.device_type() != DeviceType.CPU, int(start),
               int(start + dur), e.name().startswith(ANNOTATION))


def union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Sorted, merged intervals."""
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class DeviceTrace:
    """Device and host events of the traced window (nanoseconds on the
    profiler's clock), cut to ``[lo, hi)``."""

    def __init__(self, device: List[Tuple[str, int, int]],
                 host: List[Tuple[str, int, int, bool]], lo: int, hi: int):
        self.lo, self.hi = lo, hi
        self.device = [(n, max(s, lo), min(e, hi)) for n, s, e in device
                       if e > lo and s < hi and "Activity Buffer" not in n]
        self.host = host
        self.window_s = (hi - lo) / 1e9
        self.busy = union([(s, e) for _, s, e in self.device if e > s])

    @classmethod
    def from_profile(cls, prof) -> "DeviceTrace":
        device, host = [], []
        lo = hi = None
        for name, on_device, s, e, note in _kineto_events(prof):
            if on_device:
                if not note:    # an annotation's span on the device: no op
                    device.append((name, s, e))
            else:
                host.append((name, s, e, note))
                if name == TRACED:
                    lo, hi = s, e
        if lo is None:          # no annotation kept: the events' own span
            spans = [(s, e) for _, s, e in device] + \
                [(s, e) for _, s, e, _ in host]
            lo, hi = min(s for s, _ in spans), max(e for _, e in spans)
        return cls(device, host, lo, hi)

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e9

    def kernel_seconds(self, names: Iterable[str]) -> Tuple[float, int]:
        """Device seconds and event count of the kernels whose name holds
        any of ``names``."""
        names = tuple(names)
        hits = [e - s for n, s, e in self.device
                if any(x in n for x in names)]
        return sum(hits) / 1e9, len(hits)

    def device_ops(self, top: int = 10) -> List[list]:
        by: Dict[str, int] = defaultdict(int)
        for n, s, e in self.device:
            by[n[:120]] += e - s
        rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[n, ns / 1e9] for n, ns in rows]

    def gaps(self) -> List[Tuple[int, int]]:
        """The idle gaps: the window less the device's busy intervals."""
        out, t = [], self.lo
        for s, e in self.busy:
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.hi > t:
            out.append((t, self.hi))
        return out

    def idle_gaps(self, top: int = 10) -> List[list]:
        """Idle seconds summed by what the host was doing at each gap's
        midpoint: the innermost ``bench.`` annotation and the outermost
        operator running then."""
        gaps = sorted(self.gaps(), key=lambda g: g[0] + g[1])
        host = sorted(self.host, key=lambda h: h[1])
        by: Dict[str, int] = defaultdict(int)
        active: list = []           # heap by end of the host events begun
        i = 0
        for g0, g1 in gaps:
            mid = (g0 + g1) // 2
            while i < len(host) and host[i][1] <= mid:
                name, s, e, note = host[i]
                heapq.heappush(active, (e, s, name, note))
                i += 1
            while active and active[0][0] < mid:
                heapq.heappop(active)
            notes = [(s, n) for _, s, n, note in active
                     if note and n != TRACED]
            ops = [(s, n) for _, s, n, note in active if not note]
            label = max(notes)[1] if notes else "host"
            if ops:
                label += " > " + min(ops)[1][:60]
            by[label] += g1 - g0
        rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[n, ns / 1e9] for n, ns in rows]
