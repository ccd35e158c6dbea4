"""Profiling, and the program's own spans and counters: the port's
counterpart of ``objgan_tpu/utils/profiling.py``.

* ``trace(log_dir)``: a region under ``torch.profiler``, written to
  ``log_dir`` as a Chrome trace (``*.pt.trace.json``) that TensorBoard's
  profiler plugin and Perfetto load, with the program's spans of the
  region added (category ``program_span``), the feed producer's too;
* the recorder: ``span`` and ``side_span`` time a stretch of the K-step
  training loop, ``device_timed`` the device's work of one call and of its
  gradient's way back, ``count`` sets a counter, ``recorded()`` reads
  them;
* ``device_profile(fn)``: one call of ``fn`` under the profiler, its wall
  time and the device's busy time (the union of the kernels' intervals);
* ``graph_nodes``, ``graph_kernel_nodes``: a captured CUDA graph's nodes.

The recorder keeps its spans in memory, and only while a torch profiler
runs on the loop's thread, which is when they can be read beside the
kernels: ``trace`` and the benchmark's ``--trace 1`` both turn it on. The
profiler's state is per thread, so a span opened with ``span`` asks
``torch.autograd._profiler_enabled()``, and one opened with ``side_span``
on a thread the profiler does not see (the feed's producer) follows the
last answer of the loop's thread. Off, a span is that check and a shared
object that does nothing: no allocation, no CUDA event. Each turn from off
to on starts the buffer anew, as does each K-step loop that starts under
a profiler (``restart``), so a process reads its newest traced stretch. A
``span`` also enters a ``record_function`` range of its name, so the
profiler's own trace holds it. Times are ``time.time_ns()``, the
profiler's host clock: an event's ``trace_start_ns() + time_range.start *
1000`` (``prof.profiler.kineto_results``) and a Chrome trace's
``baseTimeNanoseconds + ts * 1000`` are on it. Counters are plain
integers, always kept, across restarts too.

A span of ``device_timed`` is the device's time alone, between two timing
events on the stream. Inside the capture of a K-step CUDA graph
(``capturing``) its events are captured as event-record nodes, always,
since the recorder is off while set-up captures: every replay records
them anew, and a replay under the recorder adds one span per name with
the K steps' device time (``replayed``). The next traced replay records
over the same events, so its spans replace the last one's: a traced
stretch keeps its last replay's, and no traced replay waits for the card.
They are read by ``recorded()`` or, waiting for the card once, before
the first replay after the stretch (``settle``). Off and outside a
capture a span costs one check; inside a graph, its nodes.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
from torch.autograd import _profiler_enabled


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace("/tmp/trace"):`` profiles the block (the CPU, and the
    card where there is one) and writes its trace under ``log_dir``, named
    as ``tensorboard_trace_handler`` names it, with the program's spans
    that began in the block."""
    from torch.profiler import ProfilerActivity, profile

    since = time.time_ns()

    def write(prof):
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, f"{socket.gethostname()}_"
                            f"{os.getpid()}.{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
        doc["traceEvents"] += _chrome_events(
            [s for s in recorded()["spans"] if s["start_ns"] >= since],
            doc.get("baseTimeNanoseconds", 0))
        with open(path, "w") as f:
            json.dump(doc, f)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=write):
        yield


def _chrome_events(spans: List[Dict], base_ns: int) -> List[Dict]:
    """``recorded()`` spans as Chrome trace events ("X") on the process's
    rows, each on its thread's, ``ts`` in µs after ``base_ns``."""
    return [{"ph": "X", "cat": "program_span", "name": s["name"],
             "pid": os.getpid(), "tid": s["tid"],
             "ts": (s["start_ns"] - base_ns) / 1e3,
             "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
             "args": {k: s[k] for k in ("parent", "steps", "device_ms")
                      if s[k] is not None}}
            for s in spans]


class _Recorder:
    """The process's spans and counters (module-level ``_REC``): ``on`` is
    the loop thread's last answer, ``current`` its innermost open span."""

    def __init__(self):
        self.on = False
        self.spans: List[_Span] = []
        self.current: Optional[_Span] = None
        self.counters: Dict[str, int] = {}
        self.capture: Optional[List[_GraphMark]] = None
        self.unsettled: List[_Span] = []


class _Off:
    """What a span is while the recorder is off."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def close(self) -> None:
        pass

    def device_start(self) -> None:
        pass

    def device_end(self) -> None:
        pass

    def start(self) -> None:
        pass

    def end(self) -> None:
        pass


_OFF = _Off()


def _timing_event(external: bool = False):
    return torch.cuda.Event(enable_timing=True, external=external)


class _Span:
    """A span being recorded: opened when made, closed by ``close()`` (or
    the end of its ``with`` block), and kept in the buffer from then."""

    __slots__ = ("name", "steps", "start_ns", "end_ns", "thread", "tid",
                 "parent", "device", "device_ms", "_range", "_loop")

    def __init__(self, name: str, steps: int, loop: bool):
        self.name, self.steps, self._loop = name, steps, loop
        t = threading.current_thread()
        self.thread, self.tid = t.name, threading.get_native_id()
        self.parent = _REC.current
        self.device = None  # [(start event, end event)], summed
        self.device_ms = None
        if loop:
            _REC.current = self
            self._range = torch.autograd.profiler.record_function(name)
            self._range.__enter__()
        self.start_ns = time.time_ns()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def close(self) -> None:
        self.end_ns = time.time_ns()
        if self._loop:
            self._range.__exit__(None, None, None)
            _REC.current = self.parent
        elif not _REC.on:
            return  # it outlived the traced stretch (the profiler's stop)
        _REC.spans.append(self)

    def device_start(self) -> None:
        """Record the start of the device time on the current stream."""
        self.device = [(_timing_event(), _timing_event())]
        self.device[0][0].record()

    def device_end(self) -> None:
        """Record its end; ``recorded()`` resolves the pair."""
        self.device[0][1].record()

    def start(self) -> None:
        """Open a span of ``_device_span``: now, and on a card a timing
        event on the current stream (the span was made with a device
        list)."""
        self.start_ns = time.time_ns()
        if self.device is not None:
            self.device_start()

    def end(self) -> None:
        if self.device is not None:
            self.device_end()
        self.close()

    def settle(self) -> None:
        """``device_ms`` from the events, waited for (once)."""
        if self.device and self.device_ms is None:
            for _, end in self.device:
                end.synchronize()
            self.device_ms = sum(a.elapsed_time(b) for a, b in self.device)


class _GraphMark:
    """A span of device time inside a CUDA-graph capture: two timing
    events that the capture holds as event-record nodes, so that every
    replay records them anew. ``done`` counts its ends recorded at the
    capture."""

    __slots__ = ("name", "events", "done")

    def __init__(self, name: str):
        self.name = name
        self.events = (_timing_event(True), _timing_event(True))
        self.done = 0

    def start(self) -> None:
        self.events[0].record()
        self.done += 1

    def end(self) -> None:
        self.events[1].record()
        self.done += 1


_REC = _Recorder()


def _ask() -> bool:
    """The loop thread's question: is a profiler on here? A turn to on
    starts the buffer anew."""
    on = _profiler_enabled()
    if on != _REC.on:
        _REC.on = on
        if on:
            _REC.spans, _REC.current = [], None
    return on


def span(name: str, steps: int = 0):
    """A span of the loop's thread: ``with span("exec", k) as s:``. Asks
    the profiler; recorded, and entered as a ``record_function`` range,
    only while it is on."""
    return _Span(name, steps, True) if _ask() else _OFF


def side_span(name: str, steps: int = 0):
    """A span of a thread the profiler does not see, open from now until
    its ``close()``: recorded where the loop thread's last answer is on at
    both ends (a stretch that the profiler's stop cut into, which can hold
    the interpreter lock for seconds, is left out). Its parent is the loop
    thread's innermost span open now."""
    return _Span(name, steps, False) if _REC.on else _OFF


def _device_span(name: str, cuda: bool):
    """A span of device time alone, from its ``start()`` to its
    ``end()``, which autograd may call in the backward pass: inside a
    capture (``capturing``) a ``_GraphMark``; else, while the recorder is
    on (asked now, on the loop's thread), a span of one step, timed by
    events on a card (``cuda``); else the shared do-nothing object."""
    if _REC.capture is not None:
        mark = _GraphMark(name)
        _REC.capture.append(mark)
        return mark
    if not _ask():
        return _OFF
    s = _Span(name, 1, False)
    s.device = [] if cuda else None
    return s


class _OnGrad(torch.autograd.Function):
    """Identity forward; in the backward, ``fn()`` once every gradient
    of the outputs has arrived, then the gradients on unchanged."""

    @staticmethod
    def forward(ctx, fn, *xs):
        ctx.fn = fn
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.fn()
        return (None, *grads)


def device_timed(name: str, fn, x: torch.Tensor):
    """``fn(x)``, a tuple of tensors, with two spans of device time
    (``_device_span``): ``name``, its forward, and where a gradient flows,
    ``name + ".grad"``, the gradient's way back from the outputs to ``x``
    (identity marks on both ends, whose backward records the events).
    Without a span, ``fn(x)`` alone, with no mark."""
    fwd = _device_span(name, x.is_cuda)
    if fwd is _OFF:
        return fn(x)
    grad = x.requires_grad and torch.is_grad_enabled()
    if grad:
        back = _device_span(name + ".grad", x.is_cuda)
        (x,) = _OnGrad.apply(back.end, x)
    fwd.start()
    out = fn(x)
    fwd.end()
    if grad and any(t.requires_grad for t in out):
        out = _OnGrad.apply(back.start, *out)
    return out


@contextlib.contextmanager
def capturing():
    """While a K-step graph is captured: ``with capturing() as marks``
    collects the graph's spans of device time; those that met both ends
    are the graph's (``replayed``)."""
    marks: List[_GraphMark] = []
    _REC.capture = marks
    try:
        yield marks
    finally:
        _REC.capture = None
        marks[:] = [m for m in marks if m.done == 2]


def replayed(marks: Sequence[_GraphMark]) -> None:
    """After a replay of the graph that holds ``marks``: while the
    recorder is on (the loop thread's last answer), one span per name,
    its ``steps`` the name's marks (one a step), its device time theirs
    summed, and its host times the call's, in place of the last replay's
    spans, whose events this replay records over."""
    if not _REC.on:
        return
    while _REC.unsettled:  # one at a time: the producer thread appends
        s = _REC.unsettled.pop()
        if s in _REC.spans:
            _REC.spans.remove(s)
    by_name: Dict[str, list] = {}
    for m in marks:
        by_name.setdefault(m.name, []).append(m.events)
    for name, pairs in by_name.items():
        s = _Span(name, len(pairs), False)
        s.device = pairs
        s.close()
        _REC.unsettled.append(s)


def settle() -> None:
    """Before a replay outside a traced stretch: read the device time of
    the last traced replay's spans (``replayed``), waiting for it, before
    this replay records their events anew."""
    if not _REC.on:
        while _REC.unsettled:
            _REC.unsettled.pop().settle()


def restart() -> None:
    """A new stretch: ask the profiler now, on the loop's thread, and
    start the buffer anew if it is on. Each K-step loop calls it as it
    starts, so a second profiled loop in one process replaces the first's
    spans, and the feed's producer follows from its first stack."""
    _REC.on = False
    _ask()


def count(name: str, value: int) -> None:
    """Set counter ``name`` (kept whether or not the recorder is on)."""
    _REC.counters[name] = int(value)


def recorded() -> Dict:
    """The newest traced stretch and the counters: ``{"spans": [...],
    "counters": {name: int}}``, each closed span a dict of ``name``,
    ``start_ns``, ``end_ns`` (``time.time_ns()``), ``thread`` (its name),
    ``tid`` (its native id), ``parent`` (the index in this list of the
    span it began in, or None), ``steps`` (0 where none was given) and
    ``device_ms`` (the device time between ``device_start`` and
    ``device_end``, or summed over a replay's K steps, waited for here;
    None where there is none)."""
    spans = list(_REC.spans)
    index = {id(s): i for i, s in enumerate(spans)}
    out = []
    for s in spans:
        s.settle()
        out.append({"name": s.name, "start_ns": s.start_ns,
                    "end_ns": s.end_ns, "thread": s.thread, "tid": s.tid,
                    "parent": index.get(id(s.parent)), "steps": s.steps,
                    "device_ms": s.device_ms})
    return {"spans": out, "counters": dict(_REC.counters)}


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


def _libcuda():
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int)]
    cu.cuGraphDebugDotPrint.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.c_uint]
    return cu


def graph_nodes(raw_graph) -> int:
    """All nodes of a captured CUDA graph (``raw_cuda_graph()`` of a
    ``torch.cuda.CUDAGraph(keep_graph=True)``): one cuGraphGetNodes call
    with a null array."""
    import ctypes

    count = ctypes.c_size_t(0)
    if _libcuda().cuGraphGetNodes(raw_graph, None, ctypes.byref(count)):
        raise RuntimeError("cuGraphGetNodes failed")
    return count.value


def graph_kernel_nodes(raw_graph, names: Sequence[str] = ()
                       ) -> Tuple[int, int, Dict[str, int]]:
    """(kernel nodes, all nodes, {name: kernel nodes whose function's name
    holds it}) of a captured CUDA graph (as ``graph_nodes`` takes it):
    libcuda's cuGraphGetNodes and cuGraphNodeGetType count the nodes, and
    the names come from the graph's verbose DOT print
    (cuGraphDebugDotPrint), one record per node."""
    import ctypes
    import re
    import tempfile

    cu = _libcuda()
    count = ctypes.c_size_t(graph_nodes(raw_graph))
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
