"""The inception Stage-C cell at a CPU test's size: a tiny root as
``tiny_root`` writes it, with ``TEXT.CNN_BACKBONE: inception`` in float32
and the driver ``train_loop_inception``. The check passes a sound run and
fails the planted ``img_enc_grad_cut`` (the backbone's features
detached); a program whose encoder passes no gradient stops the run
before anything is built; the two readers of the encoder's spans read a
canned record, and nothing without one."""

import copy
import json
import os
import time

import pytest
import torch

from h100bench import harness, program
from h100bench.tests import tiny_root

CELL = tiny_root.CELL
LIMITS = {"img_enc_gap": 1e-4, "img_enc_grad_gap": 1e-4}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    torch.set_num_threads(2)
    saved = tiny_root.TINY
    tiny_root.TINY = copy.deepcopy(saved)
    # fp32 on the CPU: the program then matches the reference to rounding
    tiny_root.TINY.update(DTYPE="float32")
    tiny_root.TINY["TRAIN"]["BATCH_SIZE"] = 2
    tiny_root.TINY["TEXT"]["CNN_BACKBONE"] = "inception"
    try:
        root = tiny_root.make_tiny_root(
            str(tmp_path_factory.mktemp("inception")), n_records=8)
    finally:
        tiny_root.TINY = saved
    path = os.path.join(root, "h100bench", "traffic", "tiny_k2.json")
    mix = json.load(open(path))
    mix["driver"] = "train_loop_inception"
    mix["limits"].update(LIMITS)
    json.dump(mix, open(path, "w"))
    return root


def _run(root, faults=None):
    ctx = harness.make_context(CELL, 2 ** 31 + 4099, 0.5, False,
                               time.monotonic(), root=root)
    ctx.require_cuda = False
    ctx.faults = faults or {}
    return harness.run_cell(ctx)


def test_sound_run_is_correct(tiny):
    line = _run(tiny)
    assert line["correct"], line["checks"]
    checks = line["checks"]
    assert set(LIMITS) <= set(checks)
    # one float32 graph on the CPU's kernels in both: equal to rounding
    assert checks["img_enc_gap"]["value"] <= 1e-5, checks
    assert checks["img_enc_grad_gap"]["value"] <= 1e-5, checks


def test_cut_image_gradient_is_caught(tiny):
    line = _run(tiny, {"img_enc_grad_cut": True})
    assert not line["correct"], line["checks"]
    assert line["checks"]["img_enc_grad_gap"]["value"] == 1.0


def test_program_without_the_gradient_stops_the_run(tiny, monkeypatch):
    """An encoder that detaches its backbone's features (the port before
    the gradient was let through) raises before set-up, so a checkout
    without it fails the cell at once."""
    from objgan_tpu_torch.models import inception_v3

    inner = inception_v3.InceptionV3.forward
    monkeypatch.setattr(inception_v3.InceptionV3, "forward", lambda self, x: {
        k: v.detach() for k, v in inner(self, x).items()})
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="passes no gradient"):
        _run(tiny)
    assert time.monotonic() - t0 < 30


NAMES = {"img_enc.fwd_device_ms": "damsm.img_enc",
         "img_enc.grad_device_ms": "damsm.img_enc.grad"}


def _span(name, steps, device_ms):
    return {"name": name, "start_ns": 0, "end_ns": 1, "thread": "t",
            "tid": 1, "parent": 0, "steps": steps, "device_ms": device_ms}


@pytest.mark.parametrize("metric", sorted(NAMES))
def test_reader_on_canned_record(metric, monkeypatch):
    name = NAMES[metric]
    spans = [_span("exec", 8, 400.0), _span(name, 8, 48.0),
             _span(name, 8, 56.0), _span(name, 1, None),
             _span("damsm.other", 8, 1e3)]
    monkeypatch.setattr(program, "recorded",
                        lambda: {"spans": spans, "counters": {}})
    read = harness.reader(metric)
    assert read({}) == pytest.approx((48.0 + 56.0) / 16)
    spans[:] = [_span(name, 1, None)]  # on the CPU: no device time
    assert read({}) is None
    monkeypatch.setattr(program, "recorded", lambda: None)  # no recorder
    assert read({}) is None


@pytest.mark.parametrize("metric", sorted(NAMES))
def test_declared_for_the_inception_cell(metric):
    [m] = [m for m in harness.bench_file()["per_layer"]
           if m["name"] == metric]
    assert m == {"name": metric, "unit": "ms", "better": "lower",
                 "source": "program_span", "layer": "DAMSM image encoder",
                 "moves": "train_step_ms",
                 "workloads": ["coco_objgan_inception.train_k8_wire"]}
