"""ms of device time per step inside the K-step graph's replays: the
program's ``exec`` spans in the traced span that timed their replay with a
pair of CUDA events on the stream around ``graph.replay()`` (from the
stream reaching the first, after the inputs' copies, to the replay's last
node: the graph's launch and the gaps between its nodes included),
summed, over the steps they hold. None where no replay was timed (no
card)."""

from h100bench import program


def read(rec):
    timed = [s for s in program.spans("exec") if s["device_ms"] is not None]
    steps = sum(s["steps"] for s in timed)
    if not steps:
        return None
    return sum(s["device_ms"] for s in timed) / steps
