"""Profiling and step timing: the port's counterpart of
``objgan_tpu/utils/profiling.py``.

* ``trace(log_dir)``: a region under ``torch.profiler``, written to
  ``log_dir`` as a Chrome trace (``*.pt.trace.json``) that TensorBoard's
  profiler plugin and Perfetto load;
* ``StepTimer``: wall-clock step times fenced by ``torch.cuda.synchronize``
  on the devices of the step's outputs, with a percentile summary;
* ``device_profile(fn)``: one call of ``fn`` under the profiler, its wall
  time and the device's busy time (the union of the kernels' intervals).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace("/tmp/trace"):`` profiles the block (the CPU, and the
    card where there is one) and writes its trace under ``log_dir``."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def _cuda_devices(tree, found: Set[torch.device]) -> Set[torch.device]:
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            found.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, found)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, found)
    return found


def fence(tree) -> None:
    """Wait for the devices that hold the tensors of ``tree`` (nested
    lists, tuples and dicts) to finish their queued work."""
    for device in _cuda_devices(tree, set()):
        torch.cuda.synchronize(device)


class StepTimer:
    """Step times in seconds (``times``), summarised in ms."""

    def __init__(self):
        self.times: List[float] = []

    @contextlib.contextmanager
    def step(self, result_holder: Optional[list] = None):
        """Time a step. Put the step's outputs into ``result_holder``
        inside the block and the clock stops once their devices have
        finished; without a holder the recorded time is only the launch
        (PyTorch returns before the card finishes), which says nothing of
        the device."""
        t0 = time.perf_counter()
        yield
        if result_holder:
            fence(result_holder)
        self.times.append(time.perf_counter() - t0)

    def timed(self, fn, *args, warmup: int = 2, iters: int = 10):
        """Time ``fn(*args)`` ``iters`` times after ``warmup`` calls, each
        fenced on its output's devices; returns the last output."""
        out = None
        for _ in range(warmup):
            out = fn(*args)
            fence(out)
        self.times.clear()
        for _ in range(iters):
            t0 = time.perf_counter()
            out = fn(*args)
            fence(out)
            self.times.append(time.perf_counter() - t0)
        return out

    def summary(self) -> Dict[str, float]:
        a = np.asarray(self.times)
        if a.size == 0:
            return {}
        return {"mean_ms": float(a.mean() * 1e3),
                "p50_ms": float(np.percentile(a, 50) * 1e3),
                "p95_ms": float(np.percentile(a, 95) * 1e3),
                "min_ms": float(a.min() * 1e3)}


Span = Tuple[float, float, str]


def busy_ms(spans: Iterable[Span]) -> float:
    """ms of the union of the (start us, end us, name) intervals."""
    total_us, end = 0.0, float("-inf")
    for a, b, _ in sorted(spans):
        total_us += max(0.0, b - max(a, end))
        end = max(end, b)
    return total_us / 1000.0


def device_profile(fn) -> Tuple[float, float, List[Span]]:
    """(wall ms, device-busy ms, [(start us, end us, kernel name)]) of one
    call of ``fn`` under torch.profiler, synchronised; busy is the union of
    the device intervals. Raises RuntimeError when the profiler saw no
    device activity (no card, or a profiler that does not trace it)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1000.0 * (time.perf_counter() - t0)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and "#" not in e.name)
    if not spans:
        raise RuntimeError("the profiler saw no device activity")
    return wall_ms, busy_ms(spans), spans


def graph_kernel_nodes(raw_graph, names: Sequence[str] = ()
                       ) -> Tuple[int, int, Dict[str, int]]:
    """(kernel nodes, all nodes, {name: kernel nodes whose function's name
    holds it}) of a captured CUDA graph (``raw_cuda_graph()`` of a
    ``torch.cuda.CUDAGraph(keep_graph=True)``): libcuda's cuGraphGetNodes
    and cuGraphNodeGetType count the nodes, and the names come from the
    graph's verbose DOT print (cuGraphDebugDotPrint), one record per
    node."""
    import ctypes
    import re
    import tempfile

    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int)]
    cu.cuGraphDebugDotPrint.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.c_uint]
    count = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(raw_graph, None, ctypes.byref(count)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    if cu.cuGraphGetNodes(raw_graph, nodes, ctypes.byref(count)):
        raise RuntimeError("cuGraphGetNodes failed")
    kernels = 0
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(node, ctypes.byref(kind)):
            raise RuntimeError("cuGraphNodeGetType failed")
        kernels += kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    found = {name: 0 for name in names}
    if names:
        with tempfile.NamedTemporaryFile(suffix=".dot") as f:
            if cu.cuGraphDebugDotPrint(raw_graph, f.name.encode(), 1):
                raise RuntimeError("cuGraphDebugDotPrint failed")
            text = open(f.name, errors="replace").read()
        # one node record from each node's name to the next's
        for record in re.split(r'\n\s*"?graph_\d+_node_\d+"?\s*\[', text):
            for name in names:
                found[name] += name in record
    return kernels, len(nodes), found
