"""The traced run's device record: ``torch.profiler`` over the window,
reduced to busy time, time by kind, the top device operations and the
longest idle gaps with what the host was doing in each.

Kinds of device time: ``kernel`` (the program's CUDA kernels, by name),
``h2d`` and ``d2h`` (copies between host and card), ``other``.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict

import torch

KERNEL_NAMES = ("gf256_matmul", "bitmatrix_encode", "mod2_matmul")
WINDOW = "portbench.window"


def kind_of(name: str) -> str:
    if any(k in name for k in KERNEL_NAMES):
        return "kernel"
    if "HtoD" in name:
        return "h2d"
    if "DtoH" in name:
        return "d2h"
    return "other"


def merge(intervals: list) -> list:
    """Union of ``(start, end)`` intervals, sorted."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Tracer:
    """``with Tracer(on):`` profiles its body when ``on``; ``mark(name)``
    is a host span that shows in the trace (a no-op when off)."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.prof.__exit__(*exc)
        return False

    def mark(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def summary(self) -> dict:
        """Device time inside the window span, in microseconds."""
        from torch.autograd import DeviceType

        device, host, window = [], [], None
        for evt in self.prof.events():
            span = (evt.time_range.start, evt.time_range.end)
            if getattr(evt, "is_user_annotation", False) \
                    or evt.name.startswith("portbench."):
                # The harness's spans, which the profiler also draws on the
                # device's timeline: host work, never device time.
                if evt.device_type != DeviceType.CUDA:
                    if evt.name == WINDOW:
                        window = span
                    else:
                        host.append((evt.name, *span))
                continue
            if evt.device_type == DeviceType.CUDA:
                device.append((evt.name, *span))
            else:
                host.append((evt.name, *span))
        return reduce(device, host, window)


def reduce(device: list, host: list, window, top: int = 10) -> dict:
    """``device`` and ``host`` are ``(name, start_us, end_us)`` events,
    ``window`` the ``(start_us, end_us)`` of the measured window."""
    lo, hi = window
    by_kind: dict = defaultdict(float)
    by_name: dict = defaultdict(float)
    spans = []
    for name, s, e in device:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        by_kind[kind_of(name)] += e - s
        by_name[name] += e - s
        spans.append((s, e))
    busy = merge(spans)
    edges = [lo] + [x for s, e in busy for x in (s, e)] + [hi]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:top]
    return {
        "window_us": hi - lo,
        "busy_us": sum(e - s for s, e in busy),
        "by_kind": {k: by_kind.get(k, 0.0)
                    for k in ("kernel", "h2d", "d2h", "other")},
        "device_ops": [[name, us / 1e6] for name, us in
                       sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[host_at(host, (s + e) / 2), us / 1e6]
                      for us, s, e in gaps],
    }


def host_at(host: list, t: float) -> str:
    """What the host was doing at ``t``: the innermost harness span and
    the shortest operator around it."""
    around = [(e - s, name) for name, s, e in host if s <= t <= e]
    marks = sorted(x for x in around if x[1].startswith("portbench."))
    ops = sorted(x for x in around if not x[1].startswith("portbench."))
    parts = [marks[0][1]] if marks else []
    parts.append(ops[0][1] if ops else "host code outside torch")
    return " / ".join(parts)
