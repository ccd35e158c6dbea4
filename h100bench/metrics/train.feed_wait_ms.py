"""ms per step that the K-step loop waits for its feed: the program's
``feed.wait`` spans in the traced span (asking ``cli.PrefetchFeed`` for
the next stack until it is in hand, the stream's wait for its copy
included), their mean over the steps of an execution."""

from h100bench import program


def read(rec):
    waits = program.spans("feed.wait")
    k = max((s["steps"] for s in program.spans("exec")), default=0)
    if not waits or not k:
        return None
    return program.mean_ms(waits) / k
