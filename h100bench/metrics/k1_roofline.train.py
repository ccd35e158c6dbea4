"""% of kernel K1's roofline in the train step: the bound of its launches
(each input byte read once, each output byte written once, at 3.35 TB/s;
or its operations at the fp32 peak, whichever is larger), counted from the
reference's GroupNorm calls of one step at the configured dtypes, over the
device time of the kernels named gn_fused_kernel in the profiled span, per
step."""

from h100bench.work import k1_bound_s


def read(rec):
    t = sum(s for n, s in rec.get("kernel_s", {}).items()
            if "gn_fused_kernel" in n)
    if not t or not rec.get("k1_calls"):
        return None
    return 100.0 * rec["span_steps"] * k1_bound_s(rec["k1_calls"]) / t
