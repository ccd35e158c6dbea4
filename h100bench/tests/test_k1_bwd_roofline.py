"""The reader of ``k1_bwd_roofline.train`` on canned records: the frozen
byte count by hand, the share over the device time of the kernels named
gn_bwd, and nothing where a run has no such kernel (a program without K1
backward) or was not traced."""

import pytest

from h100bench import harness, work

READ = harness.reader("k1_bwd_roofline.train")
CALLS = [(2 ** 20, 2, 64, True), (4096, 4, 32, False)]


def test_bwd_work_by_hand():
    mod = harness._load(
        harness.os.path.join(harness.ROOT, "h100bench", "metrics",
                             "k1_bwd_roofline.train.py"), "k1_bwd")
    # bf16 GLU: x 2 MiB read, dout 1 MiB read, dx 2 MiB written; scale
    # read, dscale and dbias written, 64 fp32 each
    assert mod.bwd_work(2 ** 20, 2, 64, True) == (
        2 * 2 ** 21 + 2 ** 20 + 3 * 256, 12 * 2 ** 20)
    assert mod.bwd_work(4096, 4, 32, False) == (3 * 16384 + 384, 12 * 4096)


def test_share_of_the_gn_bwd_kernels():
    rec = {"span_steps": 8, "k1_calls": CALLS,
           "kernel_s": {"void gn_fused_kernel<x>": 0.5,
                        "void (anonymous namespace)::gn_bwd_kernel<y>": 0.012,
                        "gn_bwd_param_kernel": 0.004,
                        "roi_bwd_kernel": 0.3}}
    bound = (work.bound_s(2 * 2 ** 21 + 2 ** 20 + 768, 12 * 2 ** 20)
             + work.bound_s(3 * 16384 + 384, 12 * 4096))
    assert READ(rec) == pytest.approx(100 * 8 * bound / 0.016, rel=1e-12)
    assert 0 < READ(rec) <= 100


@pytest.mark.parametrize("rec", [
    {"span_steps": 8, "k1_calls": CALLS,
     "kernel_s": {"void gn_fused_kernel<x>": 0.5}},  # no K1 backward
    {"span_steps": 8, "k1_calls": CALLS, "kernel_s": {}},
    {"setup_s": 12.5, "step_ms": 75.0},               # untraced
])
def test_nothing_to_read(rec):
    assert READ(rec) is None


def test_declared_for_the_train_cell():
    [m] = [m for m in harness.bench_file()["per_layer"]
           if m["name"] == "k1_bwd_roofline.train"]
    assert m == {"name": "k1_bwd_roofline.train", "unit": "%",
                 "better": "higher", "source": "device_trace",
                 "layer": "kernel K1 backward", "moves": "train_step_ms",
                 "workloads": ["coco_objgan.train_k8_wire"]}
