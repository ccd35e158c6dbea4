"""ms of host CPU per batch that the wire feed spends handing the loop its
next batch: the CPU time of the pulling thread inside each pull of the
feed iterator (the benchmark's span), over the window's batches."""


def read(rec):
    return rec.get("feed_ms")
