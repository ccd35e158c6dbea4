"""% of the profiled span in which no operation ran on the card: one less
the union of the device intervals over the span's wall time."""


def read(rec):
    if "busy_s" not in rec:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["span_s"])
