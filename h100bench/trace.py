"""A short profiled span inside the window, reduced to what the per-layer
readers take: the device's busy time (the union of its kernels'
intervals, as the port's ``utils/profiling.py::busy_ms`` takes it), device
time by kernel name, and the longest idle gaps named by what the host was
doing in them.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, Tuple

Span = Tuple[float, float, str]


def union_s(spans: List[Span]) -> float:
    total, end = 0.0, float("-inf")
    for a, b, _ in sorted(spans):
        total += max(0.0, b - max(a, end))
        end = max(end, b)
    return total / 1e6


def gaps(spans: List[Span]) -> List[Tuple[float, float]]:
    """(start us, end us) of each stretch with no kernel running."""
    out, end = [], None
    for a, b, _ in sorted(spans):
        if end is not None and a > end:
            out.append((end, a))
        end = b if end is None else max(end, b)
    return out


def idle_by_host_op(kernels: List[Span], host: List[Span],
                    top: int = 10, longest: int = 400) -> List[list]:
    """The ``longest`` idle gaps between kernels, each named by the
    innermost host operation running at its middle, summed by that name:
    [[name, seconds], ...], the ``top`` largest."""
    host = sorted(host)
    starts = [h[0] for h in host]
    by_name: Dict[str, float] = defaultdict(float)
    for a, b in sorted(gaps(kernels), key=lambda g: g[0] - g[1])[:longest]:
        mid, name = (a + b) / 2, "no host op"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 5000, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        by_name[name] += (b - a) / 1e6
    return [[n, s] for n, s in sorted(by_name.items(),
                                      key=lambda kv: -kv[1])[:top]]


class Profiled:
    """``start()`` and ``stop()`` a torch.profiler span of CPU and CUDA
    activity; ``stop`` synchronises and reduces it (``result``)."""

    def __init__(self, cuda: bool = True):
        self.cuda = cuda
        self.prof = None
        self.result: Dict = {}
        self.t0 = 0.0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.cuda:
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.monotonic()

    @property
    def active(self) -> bool:
        return self.prof is not None

    def stop(self) -> None:
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        span_s = time.monotonic() - self.t0
        self.prof.__exit__(None, None, None)
        kernels, host = [], []
        for e in self.prof.events():
            if getattr(e, "is_user_annotation", False):
                continue
            s = (e.time_range.start, e.time_range.end, e.name)
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if "#" not in e.name:
                    kernels.append(s)
            else:
                host.append(s)
        self.prof = None
        by_name: Dict[str, float] = defaultdict(float)
        for a, b, n in kernels:
            by_name[n] += (b - a) / 1e6
        self.result = {
            "span_s": span_s,
            "busy_s": union_s(kernels),
            "kernel_s": dict(by_name),
            "device_ops": [[n, s] for n, s in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": idle_by_host_op(kernels, host),
        }
