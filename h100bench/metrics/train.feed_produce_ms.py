"""ms per step that the feed's producer thread spends making a stack: the
program's ``feed.produce`` spans in the traced span (from the first pull
of a stack's K batches to the stack shipped: the pulls, stacking, pinning,
the copy issued, the noise drawn, the ready event; not the wait for room
in the queue), their mean over the steps of a stack."""

from h100bench import program


def read(rec):
    found = program.spans("feed.produce")
    k = max((s["steps"] for s in found), default=0)
    if not found or not k:
        return None
    return program.mean_ms(found) / k
