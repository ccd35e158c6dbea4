"""% of the roofline of kernels K2 and K3 (ROI-align forward and backward)
in the train step: their bounds summed (each step runs three of each, on
its batch's boxes, on bf16 features of the object discriminator) over
their device time summed, in the profiled span."""

from h100bench.work import bound_s, roi_bwd_work, roi_fwd_work


def read(rec):
    import torch

    t = sum(s for n, s in rec.get("kernel_s", {}).items()
            if "roi_fwd_kernel" in n or "roi_bwd_kernel" in n)
    if not t or not rec.get("span_boxes"):
        return None
    f, r = rec["roi_f_shape"], rec["roi_size"]
    bound = 0.0
    for boxes in rec["span_boxes"]:
        b = torch.as_tensor(boxes)
        bound += 3 * (bound_s(*roi_fwd_work(b, f, 2, r))
                      + bound_s(*roi_bwd_work(b, f, 2, r)))
    return 100.0 * bound / t
