"""Whole runs at a CPU test's size, the card's look skipped: a cell, mix
and metric dropped in as files run with no edit; the check passes a sound
run and fails each fault the training cells can have (one of them only in
the K-step executions that replay the graph on a card, one only in
ROI-align's backward); the float8 control fails it; the command without a
card prints no result."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from h100bench import harness
from h100bench.tests import tiny_root

ROOT = harness.ROOT


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    torch.set_num_threads(2)
    saved = tiny_root.TINY["DTYPE"]
    # fp32 on the CPU: the program then matches the reference to rounding
    tiny_root.TINY["DTYPE"] = "float32"
    try:
        root = tiny_root.make_tiny_root(str(tmp_path_factory.mktemp("tiny")))
    finally:
        tiny_root.TINY["DTYPE"] = saved
    return root


def _run(root, faults=None, cell=tiny_root.CELL, trace=True):
    ctx = harness.make_context(cell, 2 ** 31 + 99, 1.0, trace,
                               time.monotonic(), root=root)
    ctx.require_cuda = False
    ctx.faults = faults or {}
    return harness.run_cell(ctx)


def test_dropped_in_files_run_without_an_edit(tiny):
    """A new configuration, traffic mix and per-layer metric, each only a
    file (and its entries in BENCHMARK.json), are found by name and run."""
    bench_dir = os.path.join(tiny, "h100bench")
    cfg = json.load(open(os.path.join(bench_dir, "configs", "tiny.json")))
    cfg["config"]["GAN"]["R_NUM"] = 1
    json.dump(cfg, open(os.path.join(bench_dir, "configs", "tiny_r1.json"),
                        "w"))
    mix = json.load(open(os.path.join(bench_dir, "traffic", "tiny_k2.json")))
    mix["config"]["TRAIN"]["STEPS_PER_EXECUTION"] = 1
    mix["limits"] = {k: v for k, v in mix["limits"].items()
                     if not k.startswith("replay_")}  # no K-step replay
    json.dump(mix, open(os.path.join(bench_dir, "traffic", "tiny_k1.json"),
                        "w"))
    with open(os.path.join(bench_dir, "metrics", "steps_seen.py"), "w") as f:
        f.write("def read(rec):\n    return float(rec['steps'])\n")
    bench = json.load(open(os.path.join(tiny, "BENCHMARK.json")))
    bench["configs"].append(dict(bench["configs"][0], name="tiny_r1",
                                 file="h100bench/configs/tiny_r1.json"))
    bench["workloads"].append({"name": "tiny_r1.k1", "config": "tiny_r1",
                               "traffic": "tiny_k1", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "steps_seen", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "loop", "moves": "train_step_ms",
                               "workloads": ["tiny_r1.k1"]})
    json.dump(bench, open(os.path.join(tiny, "BENCHMARK.json"), "w"))
    line = _run(tiny, cell="tiny_r1.k1")
    assert line["correct"], line["checks"]
    assert line["metrics"]["steps_seen"]["value"] == line["attempted"] > 0
    assert "train.feed_ms" in line["metrics"]


def test_sound_run_is_correct(tiny):
    line = _run(tiny, trace=False)
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"train_step_ms", "setup_s"}
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("fault", ["frozen_state", "half_batch",
                                   "altered_loss", "stale_inputs",
                                   "roi_grad_half"])
def test_faults_are_caught(tiny, fault):
    line = _run(tiny, {fault: True}, trace=False)
    assert not line["correct"], line["checks"]


def test_lower_precision_controls_are_caught(tiny):
    """The controls, the reference in float8 and in int8 put in the
    program's place, fail the cell's limits."""
    from h100bench.calibrate import readings

    sound, controls = readings(tiny_root.CELL, 2 ** 31 + 5, control=True,
                               require_cuda=False, root=tiny)
    limits = json.load(open(os.path.join(
        tiny, "h100bench", "traffic", "tiny_k2.json")))["limits"]
    assert all(sound[k] <= v for k, v in limits.items()), sound
    assert set(controls) == {"fp8", "int8"}
    for got in controls.values():
        assert any(got[k] > v for k, v in limits.items()), got


def test_command_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run(
        [sys.executable, "h100bench/run.py", "--workload",
         harness.bench_file()["workloads"][0]["name"], "--seed",
         str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr
