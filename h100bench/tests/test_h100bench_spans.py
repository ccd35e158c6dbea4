"""The four readers of the program's own spans and counter in a traced
run of the tiny cell on the CPU: the feed's wait and production read
numbers, the replay's device time and the graph's nodes None (no card, no
graph); and without a recorder in the program every reader gives None."""

import json
import os
import time

import pytest
import torch

from h100bench import harness, program
from h100bench.tests import tiny_root

NEW = {"train.feed_wait_ms": ("ms", "program_span", "host feed"),
       "train.feed_produce_ms": ("ms", "program_span", "host feed"),
       "train.replay_device_ms": ("ms", "program_span",
                                  "train step (graph replay)"),
       "train.graph_nodes": ("nodes/step", "program_counter",
                             "train step (graph replay)")}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    torch.set_num_threads(2)
    saved = tiny_root.TINY["DTYPE"]
    # fp32 on the CPU: the program then matches the reference to rounding
    tiny_root.TINY["DTYPE"] = "float32"
    try:
        root = tiny_root.make_tiny_root(
            str(tmp_path_factory.mktemp("spans")))
    finally:
        tiny_root.TINY["DTYPE"] = saved
    bench_path = os.path.join(root, "BENCHMARK.json")
    bench = json.load(open(bench_path))
    for name, (unit, source, layer) in NEW.items():
        bench["per_layer"].append({
            "name": name, "unit": unit, "better": "lower", "source": source,
            "layer": layer, "moves": "train_step_ms",
            "workloads": [tiny_root.CELL]})
    json.dump(bench, open(bench_path, "w"))
    # two executions under the profiler, as the card's cell traces four:
    # the second's wait for its stack, and the stacks made meanwhile
    mix_path = os.path.join(root, "h100bench", "traffic", "tiny_k2.json")
    mix = json.load(open(mix_path))
    mix["trace_span"] = [1, 2]
    json.dump(mix, open(mix_path, "w"))
    return root


def test_traced_run_reads_the_program_spans(tiny):
    ctx = harness.make_context(tiny_root.CELL, 2 ** 31 + 77, 1.0, True,
                               time.monotonic(), root=tiny)
    ctx.require_cuda = False
    line = harness.run_cell(ctx)
    assert line["correct"], line["checks"]
    got = line["metrics"]
    for name in ("train.feed_wait_ms", "train.feed_produce_ms"):
        assert got[name]["unit"] == "ms" and got[name]["value"] >= 0, name
    assert got["train.feed_produce_ms"]["value"] > 0
    assert "train.replay_device_ms" not in got
    assert "train.graph_nodes" not in got
    execs = program.spans("exec")
    assert len(execs) == 2 and {s["steps"] for s in execs} == {2}


def test_readers_without_a_recorder_give_none(tiny, monkeypatch):
    """A program whose profiling module has no ``recorded``: each reader
    gives None, raising nothing."""
    import objgan_tpu_torch.utils.profiling as profiling

    monkeypatch.delattr(profiling, "recorded")
    for name in NEW:
        assert harness.reader(name, tiny)({}) is None, name
