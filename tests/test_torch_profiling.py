"""The port's profiling module (objgan_tpu_torch/utils/profiling.py) against
the JAX package's (objgan_tpu/utils/profiling.py): ``StepTimer.summary()``
gives JAX's numbers under JAX's keys on the same recorded times, the timer
records steps and timed calls, ``trace`` writes a trace file on the CPU,
and ``busy_ms`` takes the union of overlapping device intervals."""

import glob
import json

import numpy as np
import pytest
import torch

from objgan_tpu.utils.profiling import StepTimer as JStepTimer
from objgan_tpu_torch.utils import profiling

torch.set_num_threads(2)


def test_summary_matches_jax():
    times = list(np.random.default_rng(0).uniform(1e-3, 5e-2, 37))
    got, want = profiling.StepTimer(), JStepTimer()
    got.times[:], want.times[:] = times, times
    assert got.summary() == want.summary()
    assert set(got.summary()) == {"mean_ms", "p50_ms", "p95_ms", "min_ms"}
    assert profiling.StepTimer().summary() == JStepTimer().summary() == {}


def test_step_and_timed_record_times():
    timer = profiling.StepTimer()
    for _ in range(3):
        holder = []
        with timer.step(holder):
            holder.append(torch.ones(4) * 2)
    with timer.step():
        pass
    assert len(timer.times) == 4 and min(timer.times) >= 0
    calls = []
    out = timer.timed(lambda x: calls.append(1) or {"y": [x + 1]},
                      torch.zeros(2), warmup=2, iters=5)
    assert len(calls) == 7 and len(timer.times) == 5
    assert torch.equal(out["y"][0], torch.ones(2))


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
