"""ms of device time per step of the DAMSM image encoder's forward on G's
finest fake (the frozen Inception-v3 and its projections): the program's
``damsm.img_enc`` spans in the traced span, each a replay's K steps timed
by pairs of CUDA events captured into the K-step graph around the
encoder's call, summed, over the steps they hold. None where no span was
timed (no card, or a program without the span)."""

from h100bench import program


def read(rec):
    timed = [s for s in program.spans("damsm.img_enc")
             if s["device_ms"] is not None]
    steps = sum(s["steps"] for s in timed)
    if not steps:
        return None
    return sum(s["device_ms"] for s in timed) / steps
