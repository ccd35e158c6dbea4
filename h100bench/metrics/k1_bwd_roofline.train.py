"""% of the roofline of K1 backward (GroupNorm(+GLU)'s gradients) in the
train step: the bound of one backward per K1 call of a step, counted from
the reference's GroupNorm calls at the configured dtypes, over the device
time of the kernels whose names hold gn_bwd in the profiled span, per step.

The count is frozen here. Per call of ``numel`` elements of ``itemsize``
bytes over ``channels`` channels: x read once, the output's cotangent read
once (half of x under GLU), dx written once, the fp32 scale read once, and
the fp32 dscale and dbias written once; 12 operations an element. A call's
bound is the larger of its bytes at 3.35 TB/s and its operations at the
fp32 peak."""

from h100bench.work import bound_s


def bwd_work(numel, itemsize, channels, use_glu):
    """(bytes, flops) of one K1 backward call."""
    x_bytes = numel * itemsize
    dy_bytes = x_bytes // 2 if use_glu else x_bytes
    return 2 * x_bytes + dy_bytes + 3 * channels * 4, 12 * numel


def read(rec):
    t = sum(s for n, s in rec.get("kernel_s", {}).items() if "gn_bwd" in n)
    if not t or not rec.get("k1_calls"):
        return None
    bound = sum(bound_s(*bwd_work(*c)) for c in rec["k1_calls"])
    return 100.0 * rec["span_steps"] * bound / t
