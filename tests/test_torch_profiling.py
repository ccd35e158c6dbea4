"""The port's profiling module (objgan_tpu_torch/utils/profiling.py): ``trace``
writes a trace file on the CPU, ``busy_ms`` takes the union of overlapping
device intervals, and the recorder's spans in a tiny K = 2 ``_run_loop``:
none without a profiler, the loop's rows unchanged; under one, each span
on its thread with its parent, on the profiler's clock, a second traced
loop replacing the first; ``trace`` writing them, the producer's
included, into its Chrome trace."""

import glob
import json
import time

import numpy as np
import pytest
import torch
import torch.nn as nn
from torch.profiler import ProfilerActivity, profile

from objgan_tpu_torch import cli
from objgan_tpu_torch.core.config import tiny_test_config
from objgan_tpu_torch.train.common import Trainer
from objgan_tpu_torch.utils import profiling

torch.set_num_threads(2)

K = 2
LOOP = {"feed.wait", "exec", "loop.row"}


def test_trace_writes_a_loadable_file_on_the_cpu(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_busy_is_the_union_of_intervals():
    spans = [(0.0, 1000.0, "a"), (500.0, 1500.0, "b"), (3000.0, 3500.0, "c"),
             (3100.0, 3200.0, "d")]
    assert profiling.busy_ms(spans) == pytest.approx(2.0)
    assert profiling.busy_ms([]) == 0.0


# -- the recorder in the K-step loop -------------------------------------------


class Slow(Trainer):
    """A trainer whose step takes ``step_s`` and returns the batch's value,
    so the producer's stacks overlap the loop's executions."""

    def __init__(self, step_s):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(1))
        self.step_s = step_s

    def optimizers(self):
        return []

    def step_noise(self, batch, generator):
        return (torch.rand((), generator=generator),)

    def train_step(self, batch, u):
        time.sleep(self.step_s)
        self.step += 1
        return {"loss": torch.as_tensor(np.asarray(batch["x"])).float()
                .mean()}


class _Manager:
    def save(self, step, module):
        pass


class _Writer:
    def __init__(self):
        self.rows = []

    def write(self, step, metrics):
        self.rows.append((step, metrics))

    def close(self):
        pass


def _feed(n, pull_s):
    for i in range(n):
        time.sleep(pull_s)
        yield {"x": np.full((2, 2), i, np.float32)}


def _loop(n=8, step_s=0.0, pull_s=0.0):
    """A K = 2 ``_run_loop`` over ``n`` batches, a row each execution; its
    rows without ``steps_per_sec``."""
    cfg = tiny_test_config().merged(
        {"DTYPE": "float32", "TRAIN": {"STEPS_PER_EXECUTION": K,
                                       "SNAPSHOT_STEPS": 10 ** 9}})
    writer = _Writer()
    cli._run_loop(cfg, Slow(step_s), _feed(n, pull_s), writer, _Manager(),
                  10 ** 9, "cpu", log_every=K)
    return [(step, {k: v for k, v in m.items() if k != "steps_per_sec"})
            for step, m in writer.rows]


def _traced(**kw):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rows = _loop(**kw)
    return rows, profiling.recorded()["spans"], prof


def test_loop_without_a_profiler_records_no_span():
    before = profiling.recorded()["spans"]
    rows = _loop()
    assert profiling.recorded()["spans"] == before
    want = [(2 * (i + 1), {"loss": float(2 * i + 0.5)}) for i in range(4)]
    assert rows == want
    assert _traced()[0] == want  # and the same rows under the profiler


def test_traced_loop_records_its_spans_on_their_threads():
    rows, spans, _ = _traced(n=8, step_s=0.03, pull_s=0.005)
    assert len(rows) == 4
    by_name = {}
    for s in spans:
        by_name.setdefault(s["name"], []).append(s)
        assert s["start_ns"] <= s["end_ns"]
    assert set(by_name) == LOOP | {"feed.produce"}
    loop_thread = by_name["exec"][0]["thread"]
    for name in LOOP:
        assert {s["thread"] for s in by_name[name]} == {loop_thread}
    assert {s["thread"] for s in by_name["feed.produce"]} == {"prefetch-feed"}
    assert len(by_name["exec"]) == 4
    assert {s["steps"] for s in by_name["exec"]} == {K}
    assert {s["steps"] for s in by_name["feed.produce"]} == {K}
    assert len(by_name["feed.wait"]) >= 4 and len(by_name["loop.row"]) == 4
    assert all(s["device_ms"] is None for s in spans)  # no card
    # the loop's spans open one after another; a stack's production began
    # inside the loop-thread span its parent names
    assert all(s["parent"] is None for name in LOOP for s in by_name[name])
    parents = [s["parent"] for s in by_name["feed.produce"]]
    assert any(p is not None for p in parents)
    for s, p in zip(by_name["feed.produce"], parents):
        if p is not None:
            up = spans[p]
            assert up["thread"] == loop_thread
            assert up["start_ns"] <= s["start_ns"] <= up["end_ns"]

    # a second traced loop in the process replaces the first's spans
    _, again, _ = _traced(n=4)
    assert len([s for s in again if s["name"] == "exec"]) == 2
    assert min(s["start_ns"] for s in again) > max(
        s["end_ns"] for s in spans)


def test_loop_spans_lie_on_the_profilers_clock():
    """Each loop-thread span within 1 ms of the profiler's own
    ``record_function`` event of its name, on ``trace_start_ns() +
    time_range``."""
    _, spans, prof = _traced(n=6, step_s=0.005)
    base = prof.profiler.kineto_results.trace_start_ns()
    events = {}
    for e in prof.events():
        if e.name in LOOP and e.is_user_annotation:
            events.setdefault(e.name, []).append(
                (base + e.time_range.start * 1000,
                 base + e.time_range.end * 1000))
    for name in LOOP:
        mine = sorted((s["start_ns"], s["end_ns"]) for s in spans
                      if s["name"] == name)
        theirs = sorted(events[name])
        assert len(mine) == len(theirs) > 0, name
        for (a, b), (c, d) in zip(mine, theirs):
            assert abs(a - c) < 1e6 and abs(b - d) < 1e6, (name, a - c, b - d)


def test_trace_writes_the_program_spans(tmp_path):
    """``trace`` adds the region's spans, the producer's too, to its Chrome
    trace, with ``ts`` on the file's ``baseTimeNanoseconds``."""
    t0 = time.time_ns()
    with profiling.trace(str(tmp_path)):
        _loop(n=6, step_s=0.01, pull_s=0.002)
    t1 = time.time_ns()
    [path] = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    mine = [e for e in doc["traceEvents"]
            if e.get("cat") == "program_span"]
    assert {e["name"] for e in mine} == LOOP | {"feed.produce"}
    spans = profiling.recorded()["spans"]
    assert len(mine) == len(spans)
    for e, s in zip(mine, spans):
        assert e["name"] == s["name"] and e["tid"] == s["tid"]
        assert t0 <= base + e["ts"] * 1000 <= t1
        assert abs(base + e["ts"] * 1000 - s["start_ns"]) < 1e3
        assert e["dur"] * 1000 == pytest.approx(s["end_ns"] - s["start_ns"],
                                                abs=1e3)
    execs = [e for e in mine if e["name"] == "exec"]
    assert len(execs) == 3 and {e["args"]["steps"] for e in execs} == {K}


def test_side_span_cut_by_the_profilers_stop_is_left_out():
    """A producer's span is kept where the loop thread's answer is on at
    both its ends: one that the profiler's stop cut into is left out."""
    profiling.restart()  # as a K-step loop starts
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("exec", K):  # the loop thread asks: on
            kept = profiling.side_span("feed.produce", K)
        kept.close()
        cut = profiling.side_span("feed.produce", K)
    with profiling.span("feed.wait"):  # asks again: off
        pass
    cut.close()
    spans = profiling.recorded()["spans"]
    assert [(s["name"], s["parent"]) for s in spans] == [
        ("exec", None), ("feed.produce", 0)]
