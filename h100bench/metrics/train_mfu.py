"""Model FLOP utilisation, %: the matmul and convolution FLOPs of one step,
counted by a FLOP counter over the reference's step at the cell's shapes
(forward and both gradients), over the time per step of the window's
steps outside the profiled span, over the dense bf16 peak of an H100
(989 TFLOP/s)."""

from h100bench.work import PEAK_BF16_FLOPS


def read(rec):
    if "model_flops" not in rec:
        return None
    step_s = rec["unprofiled_step_ms"] / 1e3
    return 100.0 * rec["model_flops"] / step_s / PEAK_BF16_FLOPS
