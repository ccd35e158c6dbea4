"""The rules that hold the port's kernels to their twins
(``objgan_tpu_torch/ops/twin_rules.py``), on the CPU: for each branch (K1
in fp32 and bf16; K1 backward's dx, its dscale and dbias, and both under
GLU in bf16; K2 and K3 in fp32 and bf16) the twin's own output passes,
an output just inside the limit passes, and one just past it, or a NaN,
fails. The card tests and ``chip_smoke.py`` hold the kernels to these
rules; here the numbers are pinned."""

import pytest
import torch

from objgan_tpu_torch.ops import twin_rules
from objgan_tpu_torch.ops.groupnorm import (group_norm_backward_reference,
                                            group_norm_reference)
from objgan_tpu_torch.ops.roi_align import (roi_align_backward_reference,
                                            roi_align_reference)

torch.set_num_threads(2)

F32, BF16 = torch.float32, torch.bfloat16
GROUPS, EPS = 4, 1e-6

# (what, x's dtype, GLU, atol, rtol, atol scaled by the largest |want|)
BRANCHES = [
    ("k1", F32, False, 1e-4, 0.0, False),
    ("k1", BF16, True, 3e-2, 2e-2, False),
    ("dx", F32, True, 1e-4, 0.0, False),
    ("dx", BF16, False, 3e-2, 2e-2, False),
    ("dscale", F32, False, 1e-4, 0.0, True),
    ("dbias", BF16, False, 1e-4, 0.0, True),
    ("dscale", F32, True, 1e-4, 0.0, True),
    ("dscale", BF16, True, 3e-2, 2e-2, True),
    ("dbias", BF16, True, 3e-2, 2e-2, True),
    ("k2", F32, False, 1e-4, 0.0, False),
    ("k2", BF16, False, 1e-2, 1e-2, False),
    ("k3", F32, False, 1e-4, 0.0, False),
    ("k3", BF16, False, 1e-2, 1e-2, False),
]
IDS = [f"{w}-{str(d)[6:]}{'-glu' if g else ''}" for w, d, g, *_ in BRANCHES]


def _case(what, dtype, glu):
    """(the twin's output, what the rule holds a kernel's to, the rule as a
    function of (got, want))."""
    gen = torch.Generator().manual_seed(0)
    if what in ("k2", "k3"):
        boxes = twin_rules.adversarial_boxes()
        f = torch.randn(3, 8, 8, 16, generator=gen).to(dtype)

        def rule(got, want):
            return twin_rules.roi(got, want, dtype)

        if what == "k2":
            return (roi_align_reference(f, boxes, 4, 2),
                    roi_align_reference(f.float(), boxes, 4, 2), rule)
        g = torch.randn(3, 10, 4, 4, 16, generator=gen).to(dtype)
        return (roi_align_backward_reference(boxes, g, f.shape, dtype, 4, 2),
                roi_align_backward_reference(boxes, g.float(), f.shape, F32,
                                             4, 2), rule)
    x = (torch.randn(2, 64, 16, generator=gen) * 1.5 + 0.3).to(dtype)
    scale = torch.rand(16, generator=gen) + 0.5
    bias = torch.randn(16, generator=gen) * 0.2
    if what == "k1":
        return (group_norm_reference(x, scale, bias, GROUPS, EPS, glu),
                twin_rules.k1_twin(x, scale, bias, GROUPS, EPS, glu),
                lambda got, want: twin_rules.k1(got, want, dtype))
    gy = torch.randn(2, 64, 8 if glu else 16, generator=gen).to(dtype)
    i = ("dx", "dscale", "dbias").index(what)
    got = group_norm_backward_reference(x, scale, bias, GROUPS, EPS, glu,
                                        gy)[i]
    want = group_norm_backward_reference(
        x.double(), scale.double(), bias.double(), GROUPS, EPS, glu,
        gy.double())[i]
    return got, want, lambda g, w: twin_rules.k1_grad(what, g, w, dtype, glu)


@pytest.mark.parametrize("what,dtype,glu,atol,rtol,scaled", BRANCHES,
                         ids=IDS)
def test_the_twins_own_output_passes(what, dtype, glu, atol, rtol, scaled):
    got, want, rule = _case(what, dtype, glu)
    assert got.dtype == (dtype if what in ("k1", "dx", "k2", "k3") else F32)
    err, ok = rule(got, want)
    assert ok, (what, err)
    assert err == float((got.double() - want.double()).abs().max()) / (
        max(1.0, float(want.abs().max())) if scaled else 1.0)


@pytest.mark.parametrize("what,dtype,glu,atol,rtol,scaled", BRANCHES,
                         ids=IDS)
def test_an_output_just_past_the_limit_fails(what, dtype, glu, atol, rtol,
                                             scaled):
    """One element moved from the value it is held to by 0.99 of its limit
    passes, by 1.01 fails, and a NaN fails; at the element of the largest
    magnitude, where rtol counts most."""
    _, want, rule = _case(what, dtype, glu)
    want = want.double().contiguous()
    span = max(1.0, float(want.abs().max())) if scaled else 1.0
    idx = int(want.abs().argmax())
    limit = atol * span + rtol * float(want.view(-1)[idx].abs())
    for share, passes in ((0.99, True), (1.01, False)):
        got = want.clone()
        got.view(-1)[idx] -= share * limit
        err, ok = rule(got, want)
        assert ok == passes, (share, err)
        assert err == pytest.approx(share * limit / span, rel=1e-9)
    got = want.clone()
    got.view(-1)[idx] = float("nan")
    assert not rule(got, want)[1]


def test_a_dtype_without_a_rule_raises():
    with pytest.raises(ValueError, match="no tolerance"):
        twin_rules.roi(torch.zeros(2), torch.zeros(2), torch.float16)


def test_the_adversarial_boxes():
    """Three images of ten boxes; object 1 of image 0 is a zero (padded)
    box, which the card tests hold to return the top-left pixel."""
    boxes = twin_rules.adversarial_boxes()
    assert boxes.shape == (3, 10, 4) and boxes.dtype == F32
    assert not bool(boxes[0, 1].any())
    assert bool((boxes[1, :, :2] + boxes[1, :, 2:] > 1.0).any())
    assert bool((boxes[1, :, :2] >= 1.0).any())  # wholly off the frame
