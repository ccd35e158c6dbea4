"""The yardstick at tiny shapes: the frozen kernel work against hand
counts, the FLOP count of the reference, each metric reader on a canned
record, the reference against the port on the CPU, and the imports of
every part a run loads."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from h100bench import harness, work
from h100bench.reference import stagec as ref

ROOT = harness.ROOT


def test_k1_work_by_hand():
    # x (2, 8, 8, 16) bf16, GLU: 2048 elements of 2 bytes read, 1024 of 2
    # written, scale and bias 2 x 16 fp32 read; 8 operations an element
    assert work.k1_work(2048, 2, 16, True) == (4096 + 2048 + 128, 16384)
    assert work.k1_work(2048, 4, 16, False) == (8192 + 8192 + 128, 16384)
    b, f = work.k1_work(10 ** 6, 2, 64, False)
    assert work.bound_s(b, f) == pytest.approx(b / 3.35e12)


def test_roi_work_by_hand():
    # one box over the whole 4 x 4 map, out 2, 2 samples a bin: every pixel
    # touched; each output row weighs two source rows (nnz 2 per bin row,
    # 4 in all), so terms = (2 bins x 2 rows) ** 2 = 16
    boxes = torch.tensor([[[0.0, 0.0, 1.0, 1.0]]])
    touched, terms = work.roi_work(boxes, (1, 4, 4, 3), 2)
    assert touched == 16 and terms == 16
    fb, ff = work.roi_fwd_work(boxes, (1, 4, 4, 3), 2, 2)
    assert (fb, ff) == (16 * 3 * 2 + 2 * 2 * 3 * 2 + 16, 2 * 16 * 3)
    bb, bf = work.roi_bwd_work(boxes, (1, 4, 4, 3), 2, 2)
    assert (bb, bf) == (2 * 2 * 3 * 2 + 16 * 3 * 2 + 16, 2 * 16 * 3)
    # a box in one corner touches only its footprint
    corner = torch.tensor([[[0.0, 0.0, 0.25, 0.25]]])
    assert work.roi_work(corner, (1, 8, 8, 1), 2)[0] <= 9


def test_flop_count_by_hand():
    num = ref.Numerics()
    conv = ref.Conv(num, 4, 8, 3)
    dense = ref.Dense(num, 8, 5)
    for p in (conv.weight, dense.weight):
        torch.nn.init.normal_(p)
    x = torch.randn(2, 6, 6, 4)
    with FlopCounterMode(display=False) as fc:
        dense(conv(x).mean((1, 2))).sum().backward()
    fwd = 2 * (2 * 6 * 6) * 8 * (4 * 9) + 2 * 2 * 8 * 5
    # backward: input and weight gradients of the dense layer and the
    # weight gradient of the conv (its input takes no gradient)
    bwd = 2 * (2 * 2 * 8 * 5) + 2 * (2 * 6 * 6) * 8 * (4 * 9)
    assert fc.get_total_flops() == fwd + bwd


CANNED = {
    "setup_s": 12.5, "step_ms": 75.0, "unprofiled_step_ms": 80.0,
    "feed_ms": 4.0, "busy_s": 0.6, "span_s": 1.0, "span_steps": 8,
    "model_flops": 3.0e12, "kernel_s": {"void gn_fused_kernel<x>": 0.016,
                                        "roi_fwd_kernel": 0.001,
                                        "roi_bwd_kernel": 0.002},
    "k1_calls": [(2 ** 20, 2, 64, True)],
    "span_boxes": [np.array([[[0.1, 0.1, 0.5, 0.5]] * 2] * 2,
                            np.float32)],
    "roi_f_shape": (2, 32, 32, 256), "roi_size": 7,
}


def _expected(name):
    c = CANNED
    roi = 3 * sum(work.bound_s(*w(torch.as_tensor(c["span_boxes"][0]),
                                  c["roi_f_shape"], 2, 7))
                  for w in (work.roi_fwd_work, work.roi_bwd_work))
    return {
        "setup_s": 12.5, "train_step_ms": 75.0, "train.feed_ms": 4.0,
        "train.idle_share": 40.0, "train.device_ms": 75.0,
        "train_mfu": 100 * 3e12 / 0.08 / 989e12,
        "k1_roofline.train": 100 * 8 * work.k1_bound_s(c["k1_calls"]) / 0.016,
        "roi_roofline.train": 100 * roi / 0.003,
    }[name]


@pytest.mark.parametrize("metric", [
    m["name"] for m in harness.bench_file()["end_to_end"]
    + harness.bench_file()["per_layer"]])
def test_reader_on_canned_record(metric):
    got = harness.reader(metric)(CANNED)
    assert got == pytest.approx(_expected(metric), rel=1e-9)
    # a traced quantity that the run did not trace reads nothing, never 0
    bare = {k: CANNED[k] for k in ("setup_s", "step_ms", "feed_ms")}
    assert harness.reader(metric)(bare) in (None, _expected(metric))


def test_reference_matches_the_port_on_the_cpu():
    """One Stage-C step of the port's GanTrainer and of the reference from
    the same weights, batch and noise, fp32 on the CPU: losses and every
    gradient agree to rounding."""
    from h100bench import weights
    from h100bench.tests.tiny_root import TINY
    from objgan_tpu_torch.core.config import Config
    from objgan_tpu_torch.data.synthetic import synthetic_batch
    from objgan_tpu_torch.train.gan import GanTrainer

    torch.manual_seed(0)
    tree = json.loads(json.dumps(TINY))
    tree["DTYPE"] = "float32"
    cfg = Config().merged(tree)
    flat = ref.flat_config(tree)
    model = ref.StageC(flat, ref.Numerics())
    w = weights.draw(model, 11, "cpu")
    weights.load_into(model, w)
    trainer = GanTrainer(cfg)
    weights.load_into(trainer, w, lambda n: "g_net." + n[6:]
                      if n.startswith("ema_g.") else n)
    batch = synthetic_batch(cfg, torch.Generator().manual_seed(3), batch=4)
    batch = {k: (v if isinstance(v, torch.Tensor) else
                 [torch.as_tensor(x) for x in v] if isinstance(v, list)
                 else torch.as_tensor(v)) for k, v in batch.items()}
    z, eps = ref.step_noise(flat, 5, 0, 4, "cpu")
    grads, metrics = trainer.grads(batch, z, eps)
    d, g, rgrads = model.grads(batch, z, eps)
    assert float(metrics["d_loss"]) == pytest.approx(d, rel=1e-5)
    assert float(metrics["g_loss"]) == pytest.approx(g, rel=1e-5)
    assert set(rgrads) == set(grads)
    for n, r in rgrads.items():
        scale = max(float(r.norm()), 1e-3)
        assert float((grads[n] - r).norm()) / scale < 1e-3, n


def test_reference_noise_is_the_ports():
    from objgan_tpu_torch.core.config import Config
    from objgan_tpu_torch.train.common import step_generator
    from objgan_tpu_torch.train.gan import train_noise

    cfg = Config()
    seed = 2 ** 31 + 17
    noise = train_noise(cfg, 4, step_generator(seed, 3, "cpu"), "cpu")
    z, eps = ref.step_noise({"Z_DIM": 100, "CONDITION_DIM": 100}, seed, 3,
                            4, "cpu")
    assert torch.equal(noise["z"], z) and torch.equal(noise["ca_eps"], eps)


_GUARD = r"""
import sys
sys.path.insert(0, {root!r})
import importlib
for m in {mods!r}:
    importlib.import_module(m)
from h100bench import harness
bench = harness.bench_file()
for m in bench["end_to_end"] + bench["per_layer"]:
    harness.reader(m["name"])
for w in bench["workloads"]:
    t = harness.load_json(harness.os.path.join(
        harness.ROOT, "h100bench", "traffic", w["traffic"] + ".json"))
    harness.driver(t["driver"])
print(sorted({{k.split(".")[0] for k in sys.modules}}))
"""


def _loaded(mods):
    p = subprocess.run([sys.executable, "-c",
                        _GUARD.format(root=ROOT, mods=mods)],
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, USE_FLAX="0"))
    assert p.returncode == 0, p.stderr
    return set(eval(p.stdout.strip().splitlines()[-1]))


def test_no_jax_anywhere_a_run_reaches():
    """The drivers, the reference and every metric reader, imported with
    the port, load no JAX and nothing of the JAX package (whole top-level
    names: objgan_tpu_torch is not objgan_tpu)."""
    loaded = _loaded(["objgan_tpu_torch.cli", "objgan_tpu_torch.data.feed",
                      "h100bench.calibrate", "h100bench.trace"])
    assert not loaded & set(harness.FORBIDDEN), loaded
    assert "objgan_tpu_torch" in loaded


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded(["h100bench.reference.stagec",
                      "h100bench.reference.feed", "h100bench.weights",
                      "h100bench.work"])
    assert not loaded & (set(harness.FORBIDDEN) | {"objgan_tpu_torch"})
