"""ms of device time per step in the profiled span: the union of the
kernels' intervals over the steps it holds."""


def read(rec):
    if "busy_s" not in rec or not rec.get("span_steps"):
        return None
    return 1000.0 * rec["busy_s"] / rec["span_steps"]
