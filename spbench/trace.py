"""A steady window of the cell's own work under torch.profiler, and what the
per-layer readers take from it: each device operation's name, start and
end, the window's length, the device's busy seconds, and what the host
was doing in each idle gap.

The capture follows the port's utils/device_time.py (copied, not
imported: the yardstick stays with the benchmark): the profiler drops
some launches' records, the first calls' most of all, so a capture runs
one warm step of the same work first and drops it; and a window in which
it recorded no device operation at all is taken again, at most WINDOWS
times."""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, List, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function, schedule

WINDOWS = 3
WINDOW_SPAN = "spbench.window"
TOP = 10


def kernel_name(key: str) -> str:
    """A profiler key's function name, without namespace, template and
    arguments: 'void (anonymous namespace)::dia_spmv_kernel<double>(...)'
    -> 'dia_spmv_kernel' (utils/device_time.py's kernel_name)."""
    base = key.replace("(anonymous namespace)", "").split("(")[0].split("<")[0]
    parts = base.replace("::", " ").split()
    return parts[-1] if parts else key[:40]


@dataclasses.dataclass
class Trace:
    ops: List[Tuple[float, float, str]]      # device operations (µs, µs, key)
    host: List[Tuple[float, float, str]]     # the main thread's host events
    start: float                             # the window, µs
    end: float

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def busy(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, clipped to the
        window."""
        merged: List[Tuple[float, float]] = []
        for s, e, _ in sorted(self.ops):
            s, e = max(s, self.start), min(e, self.end)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((s, e))
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) * 1e-6

    def by_name(self):
        """{short kernel name: (seconds, operations recorded)}."""
        out = collections.defaultdict(lambda: [0.0, 0])
        for s, e, key in self.ops:
            rec = out[kernel_name(key)]
            rec[0] += (e - s) * 1e-6
            rec[1] += 1
        return {k: tuple(v) for k, v in out.items()}

    def gaps(self) -> List[Tuple[float, float]]:
        edges, t = [], self.start
        for s, e in self.busy():
            if s > t:
                edges.append((t, s))
            t = max(t, e)
        if self.end > t:
            edges.append((t, self.end))
        return edges

    def breakdown(self):
        """The device operations that took most time, and the idle gaps
        summed by what the host was doing in them, each as [[name,
        seconds]], at most TOP entries, longest first."""
        ops = sorted(((n, s) for n, (s, _) in self.by_name().items()),
                     key=lambda r: -r[1])[:TOP]
        gaps = self.gaps()
        names = host_at(self.host, [(s + e) / 2 for s, e in gaps])
        idle = collections.defaultdict(float)
        for (s, e), name in zip(gaps, names):
            idle[name] += (e - s) * 1e-6
        idle_rows = sorted(idle.items(), key=lambda r: -r[1])[:TOP]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in idle_rows]}


def host_at(events, times):
    """For each time (ascending), the innermost host event that covers it,
    as 'parent > event' where the event is a CUDA runtime call; 'host
    between events' where none does.  events are one thread's, so they
    nest."""
    ev = sorted(events, key=lambda e: (e[0], -e[1]))
    out, stack, i = [], [], 0
    for t in sorted(times):
        while i < len(ev) and ev[i][0] <= t:
            while stack and stack[-1][1] < ev[i][0]:
                stack.pop()
            stack.append(ev[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        if not stack:
            out.append("host between events")
        elif stack[-1][2].startswith("cuda") and len(stack) > 1:
            out.append(f"{stack[-2][2]} > {stack[-1][2]}")
        else:
            out.append(stack[-1][2])
    return out


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def capture(step: Callable[[], object]):
    """(trace, what the traced call of step returned): step runs once as the
    dropped warm step and once inside the window, each followed by a
    synchronize.  (None, result) where nothing ran on a CUDA device."""
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    for _ in range(WINDOWS if torch.cuda.is_available() else 1):
        _sync()
        with profile(activities=acts,
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            step()
            _sync()
            prof.step()
            with record_function(WINDOW_SPAN):
                result = step()
                _sync()
            prof.step()
        trace = _parse(prof.events())
        if trace is not None and trace.ops:
            return trace, result
    return None, result


def _parse(events):
    window = [e for e in events if e.name == WINDOW_SPAN
              and e.device_type != DeviceType.CUDA]
    if not window:
        return None
    w = window[-1]
    start, end, thread = w.time_range.start, w.time_range.end, w.thread
    ops, host = [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith(("ProfilerStep", WINDOW_SPAN)) \
                    and s >= start and s < end:
                ops.append((s, t, e.name))
        elif e.thread == thread and s >= start and t <= end \
                and e.name != WINDOW_SPAN:
            host.append((s, t, e.name))
    return Trace(ops=ops, host=host, start=start, end=end)
