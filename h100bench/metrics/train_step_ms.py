"""ms per train step at K = 8: the whole window over every step completed
in it (inner steps of an execution count one each), the window closed by a
synchronise after the last execution."""


def read(rec):
    return rec["step_ms"]
