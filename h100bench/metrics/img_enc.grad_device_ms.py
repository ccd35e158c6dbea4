"""ms of device time per step of the gradient's way back through the DAMSM
image encoder, from its outputs (regions and global feature) to G's
finest fake: the program's ``damsm.img_enc.grad`` spans in the traced
span, each a replay's K steps timed by pairs of CUDA events that identity
marks on the encoder's outputs and input record in the backward pass,
captured into the K-step graph, summed, over the steps they hold. None
where no span was timed (no card, or a program without the span)."""

from h100bench import program


def read(rec):
    timed = [s for s in program.spans("damsm.img_enc.grad")
             if s["device_ms"] is not None]
    steps = sum(s["steps"] for s in timed)
    if not steps:
        return None
    return sum(s["device_ms"] for s in timed) / steps
