"""The port's kernels against their plain PyTorch twins on the card: K1
(objgan_tpu_torch/csrc/groupnorm.cu) at the shapes the served model, a
DAMSM step and a Stage-B step give it and under autograd (with tiny
Stage-C, DAMSM and Stage-B steps on the card against the CPU), K2 and K3
(objgan_tpu_torch/csrc/roi_align.cu) at the train step's shapes and under
autograd, and all three with every input ending at an unmapped page
(``tools/guard_pages.py``); the K-step CUDA graph against eager steps,
with the inception DAMSM encoder too, and its spans of device time
against the profiler (``marks_against_profiler``). Card-only: marked
``cuda`` and skipped without a CUDA device. This file imports neither JAX
nor the parity helpers, so on a GPU host it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The kernels are held to their twins by the rules of
``objgan_tpu_torch/ops/twin_rules.py``."""

import pytest
import torch

from objgan_tpu_torch.models.common import gn, gn_glu
from objgan_tpu_torch.ops import groupnorm, twin_rules

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, n, c, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, n, c, generator=g, device=dev) * 1.5 + 0.3
    scale = torch.rand(c, generator=g, device=dev) + 0.5
    bias = torch.randn(c, generator=g, device=dev) * 0.2
    return x.to(dtype), scale, bias


# (B, N, C, dtype, use_glu): Stage C bf16 shapes of the served batch of 16,
# Stage B fp32 shapes (160 objects), and odd widths that take the scalar
# (non-vector) path
SHAPES = [
    (16, 65536, 64, torch.bfloat16, True),   # 256px UpBlock, the largest
    (16, 16384, 64, torch.bfloat16, True),   # 128px UpBlock
    (16, 4096, 192, torch.bfloat16, True),   # ResBlock gn_glu, cg 6
    (16, 4096, 96, torch.bfloat16, False),   # ResBlock gn, cg 3
    (16, 64, 512, torch.bfloat16, True),     # InitStageG up0, cg 16
    (16, 1024, 128, torch.bfloat16, False),  # LayoutEncoder
    (160, 4096, 64, torch.float32, False),   # ShapeGenerator _Up_2
    (160, 64, 256, torch.float32, False),    # Shape G and D _Down_2
    (160, 256, 128, torch.float32, False),   # Shape G and D _Down_1, _Up_0
    (160, 1024, 64, torch.float32, False),   # ShapeGenerator _Up_1
    (3, 37, 6, torch.float32, False),        # C % 4 != 0: scalar path
    (2, 100, 12, torch.bfloat16, True),      # C/2 % 8 != 0: scalar path
    # the fp32 image encoder of a DAMSM step (cfg/damsm_coco.yml, B = 48);
    # C = 32 is one channel per group
    (48, 16384, 32, torch.float32, False),
    (48, 4096, 64, torch.float32, False),
    (48, 1024, 128, torch.float32, False),
    (48, 256, 256, torch.float32, False),
    (48, 64, 512, torch.float32, False),
    (48, 16, 512, torch.float32, False),
]


def _groups(c):
    return 32 if c % 32 == 0 else 2 if c % 2 == 0 else 1


def _k1_matches_twin(x, scale, bias, use_glu):
    groups = _groups(x.shape[-1])
    before = groupnorm.launches
    got = groupnorm.group_norm_cuda(x, scale, bias, groups, 1e-6, use_glu)
    torch.cuda.synchronize()
    assert groupnorm.launches == before + 1
    want = twin_rules.k1_twin(x, scale, bias, groups, 1e-6, use_glu)
    assert got.dtype == x.dtype and got.shape == want.shape
    err, ok = twin_rules.k1(got, want, x.dtype)
    assert ok, err


@pytest.mark.parametrize("b,n,c,dtype,use_glu", SHAPES)
def test_k1_matches_twin(dev, b, n, c, dtype, use_glu):
    x, scale, bias = _inputs(b, n, c, dtype, dev)
    _k1_matches_twin(x, scale, bias, use_glu)


def test_k1_statistics_of_an_offset_slice(dev):
    """K1's statistics at (48, 16384, 32) fp32, the DAMSM step's largest
    call, with every channel's mean six standard deviations from 0:
    against GroupNorm in fp64 within 1e-5. E[x^2] - E[x]^2 taken in fp32
    as it stands loses a factor 1 + mean^2 / var = 37 of fp32's precision
    here; K1 sums about a pivot."""
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(48, 16384, 32, generator=g, device=dev) + 6.0
    scale = torch.rand(32, generator=g, device=dev) + 0.5
    bias = torch.randn(32, generator=g, device=dev) * 0.2
    got = groupnorm.group_norm_cuda(x, scale, bias, 32, 1e-6, False)
    xd = x.double()
    mean = xd.mean(dim=1, keepdim=True)
    var = (xd * xd).mean(dim=1, keepdim=True) - mean * mean
    want = (xd - mean) * torch.rsqrt(var + 1e-6) * scale.double() \
        + bias.double()
    assert float((got.double() - want).abs().max()) <= 1e-5


# (B, N, C, dtype, use_glu, regime, cluster): just below and just above the
# resident/streaming threshold (ops/groupnorm.py::_plan) for the bf16
# vector, fp32 vector and fp32 scalar paths, each cluster size the plan
# picks for (2, N, 256) bf16, 16 over several waves, and a ring
PLAN_SHAPES = [
    (2, 9924, 64, torch.bfloat16, True, "resident", 12),
    (2, 9925, 64, torch.bfloat16, True, "streaming", 12),
    (2, 3408, 96, torch.float32, False, "resident", 12),
    (2, 3409, 96, torch.float32, False, "streaming", 12),
    (1, 57216, 6, torch.float32, False, "resident", 12),
    (1, 57217, 6, torch.float32, False, "streaming", 12),
    (2, 64, 256, torch.bfloat16, False, "resident", 1),
    (2, 128, 256, torch.bfloat16, False, "resident", 2),
    (2, 512, 256, torch.bfloat16, False, "resident", 4),
    (2, 1024, 256, torch.bfloat16, False, "resident", 8),
    (2, 2048, 256, torch.bfloat16, False, "resident", 12),
    (160, 4096, 64, torch.float32, False, "resident", 16),
    (2, 65536, 64, torch.bfloat16, True, "streaming", 12),  # with a ring
]


@pytest.mark.parametrize("b,n,c,dtype,use_glu,regime,cluster", PLAN_SHAPES)
def test_k1_plans_match_twin(dev, b, n, c, dtype, use_glu, regime, cluster):
    x, scale, bias = _inputs(b, n, c, dtype, dev, seed=1)
    plan = groupnorm.plan_for(x, use_glu)
    assert (plan.regime, plan.cluster) == (regime, cluster)
    _k1_matches_twin(x, scale, bias, use_glu)


@pytest.mark.parametrize("b,n,c,use_glu", [
    (16, 4096, 96, False),    # resident, cluster 8
    (16, 16384, 96, False),   # streaming, cluster 12
    (16, 65536, 64, True),    # streaming through the ring, cluster 12
])
def test_k1_is_bit_reproducible(dev, b, n, c, use_glu):
    x, scale, bias = _inputs(b, n, c, torch.bfloat16, dev, seed=3)
    a = groupnorm.group_norm_cuda(x, scale, bias, 32, 1e-6, use_glu)
    b = groupnorm.group_norm_cuda(x, scale, bias, 32, 1e-6, use_glu)
    assert torch.equal(a, b)


def _graph_nodes(fn):
    """(kernel nodes, all nodes) of a CUDA graph captured around one call
    of ``fn`` (``utils/profiling.py::graph_kernel_nodes``)."""
    from objgan_tpu_torch.utils.profiling import graph_kernel_nodes

    fn()  # first use: build, attributes
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    kernels, nodes, _ = graph_kernel_nodes(graph.raw_cuda_graph())
    graph.reset()
    return kernels, nodes


def test_k1_is_one_kernel_per_call(dev):
    """A CUDA graph captured around one call holds one node, a kernel."""
    x, scale, bias = _inputs(16, 65536, 64, torch.bfloat16, dev, seed=4)
    assert _graph_nodes(lambda: groupnorm.group_norm_cuda(
        x, scale, bias, 32, 1e-6, True)) == (1, 1)


def test_k1_rejects_bad_input(dev):
    x, scale, bias = _inputs(2, 16, 64, torch.float32, dev)
    with pytest.raises(TypeError):
        groupnorm.group_norm_cuda(x.half(), scale, bias, 32, 1e-6, False)
    with pytest.raises(ValueError, match="contiguous"):
        groupnorm.group_norm_cuda(x.transpose(1, 2), scale, bias, 32, 1e-6,
                                  False)
    with pytest.raises(ValueError, match="fp32"):
        groupnorm.group_norm_cuda(x, scale.cpu(), bias, 32, 1e-6, False)


@pytest.mark.parametrize("make", [gn, gn_glu])
def test_module_on_card_matches_cpu(dev, make):
    """The module on the card (K1) against itself on the CPU (the fp32
    twin), by K1's fp32 rule."""
    m = make(96)
    with torch.no_grad():
        m.weight.uniform_(0.5, 1.5)
        m.bias.normal_(0, 0.2)
    x = torch.randn(4, 8, 8, 96)
    want = m(x)
    got = m.to(dev)(x.to(dev))
    assert twin_rules.k1(got, want, torch.float32)[1]


def test_k1_function_gradient_matches_twin(dev):
    """On the card ``group_norm`` runs K1 inside ``GroupNormFunction``; its
    gradients against the twin's in fp64: dx by K1 backward's rule
    (``twin_rules.k1_grad``), dscale and dbias (sums of 128 rows here) by
    K1's fp32 rule (``twin_rules.k1``), absolute, stricter than
    ``k1_grad``'s scaled by their magnitude."""
    for use_glu in (False, True):
        x, scale, bias = _inputs(2, 64, 96, torch.float32, dev, seed=4)
        g = torch.randn(2, 64, 48 if use_glu else 96, device=dev)
        grads = []
        for fn, dtype in ((groupnorm.group_norm, torch.float32),
                          (groupnorm.group_norm_reference, torch.float64)):
            leaves = [v.detach().to(dtype).requires_grad_()
                      for v in (x, scale, bias)]
            before = groupnorm.launches
            y = fn(*leaves, 32, 1e-6, use_glu)
            assert (groupnorm.launches - before
                    == (fn is groupnorm.group_norm))
            grads.append(torch.autograd.grad(y, leaves, g.to(dtype)))
        (dx, *params), (dx_want, *params_want) = grads
        assert twin_rules.k1_grad("dx", dx, dx_want, torch.float32,
                                  use_glu)[1]
        for got, want in zip(params, params_want):
            assert twin_rules.k1(got, want, torch.float32)[1]


# Stage B's four K1 shapes (B * O = 160 objects of cfg/shape_coco.yml, fp32)
STAGE_B = [(160, 4096, 64), (160, 1024, 64), (160, 256, 128),
           (160, 64, 256)]


@pytest.mark.parametrize("b,n,c", STAGE_B)
def test_k1_gradient_at_stage_b_shapes(dev, b, n, c):
    """Under autograd at Stage B's shapes (the shape trainer's G and D):
    K1's output against the twin in fp64 by K1's rule
    (``twin_rules.k1``), and the gradients (dx, dscale, dbias) against
    the twin's in fp64 by K1 backward's (``twin_rules.k1_grad``; dscale
    and dbias sum 655,360 rows here, to magnitudes of ~1e3)."""
    x, scale, bias = _inputs(b, n, c, torch.float32, dev, seed=5)
    g = torch.randn(b, n, c, device=dev)
    outs = []
    for fn, dtype in ((groupnorm.group_norm, torch.float32),
                      (groupnorm.group_norm_reference, torch.float64)):
        leaves = [v.detach().to(dtype).requires_grad_()
                  for v in (x, scale, bias)]
        before = groupnorm.launches
        y = fn(*leaves, 32, 1e-6, False)
        assert groupnorm.launches - before == (fn is groupnorm.group_norm)
        outs.append((y.detach(), *torch.autograd.grad(y, leaves,
                                                      g.to(dtype))))
    (y, *grads), (y_want, *grads_want) = outs
    assert twin_rules.k1(y, y_want, torch.float32)[1]
    for name, got, want in zip(("dx", "dscale", "dbias"), grads, grads_want):
        assert twin_rules.k1_grad(name, got, want, torch.float32, False)[1]


# -- K1 backward ---------------------------------------------------------------

# (B, N, C) of the GroupNorm calls of a coco_objgan train step at batch 16
# (cfg/coco_objgan.yml; B = 160 for the object discriminator's 10 objects
# per image)
K1_TRAIN_SHAPES = [
    (16, 65536, 64), (16, 16384, 192), (16, 16384, 96), (16, 16384, 64),
    (16, 16384, 32), (16, 4096, 192), (16, 4096, 128), (16, 4096, 96),
    (16, 4096, 64), (16, 1024, 256), (16, 1024, 128), (16, 256, 512),
    (16, 256, 256), (16, 256, 128), (16, 64, 512), (16, 64, 256),
    (16, 16, 512), (16, 16, 256), (160, 16, 512),
]
# (dx, dscale, dbias) as autograd asks for them: all (G and the
# discriminators), dx alone (the frozen image encoder), and the parameters
# alone (a first layer whose input takes no gradient)
NEEDS = [(True, True, True), (True, False, False), (False, True, True)]


def _cotangent(x, use_glu, seed):
    b, n, c = x.shape
    g = torch.Generator(device=x.device).manual_seed(seed)
    return torch.randn(b, n, c // 2 if use_glu else c, generator=g,
                       device=x.device).to(x.dtype)


def _twin_vjp(x, scale, bias, use_glu, gy):
    """The twin's VJP in fp64 on the CPU: (dx, dscale, dbias), on all of
    the host's cores."""
    import os

    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or threads)
    try:
        return groupnorm.group_norm_backward_reference(
            x.cpu().double(), scale.cpu().double(), bias.cpu().double(),
            _groups(x.shape[-1]), 1e-6, use_glu, gy.cpu().double())
    finally:
        torch.set_num_threads(threads)


def _k1_bwd_matches_twin(x, scale, bias, use_glu, seed=0):
    gy = _cotangent(x, use_glu, seed + 100)
    want = _twin_vjp(x, scale, bias, use_glu, gy)
    for needs in NEEDS:
        before = groupnorm.bwd_launches
        got = groupnorm.group_norm_backward_cuda(
            x, scale, bias, _groups(x.shape[-1]), 1e-6, use_glu, gy, needs)
        torch.cuda.synchronize()
        assert groupnorm.bwd_launches == before + 1
        for name, g, w, want_it in zip(("dx", "dscale", "dbias"), got, want,
                                       needs):
            assert (g is None) == (not want_it), (name, needs)
            if g is not None:
                assert g.dtype == (x.dtype if name == "dx" else torch.float32)
                assert g.shape == w.shape and g.device == x.device
                err, ok = twin_rules.k1_grad(name, g, w, x.dtype, use_glu)
                assert ok, (name, err)


@pytest.mark.parametrize("use_glu", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,n,c", K1_TRAIN_SHAPES)
def test_k1_backward_matches_twin(dev, b, n, c, dtype, use_glu):
    """K1 backward at each train-step shape, in bf16 and fp32, with and
    without GLU, under each needs pattern, against the twin's VJP in fp64
    on the CPU."""
    x, scale, bias = _inputs(b, n, c, dtype, dev, seed=6)
    _k1_bwd_matches_twin(x, scale, bias, use_glu)


@pytest.mark.parametrize("b,n,c,dtype,use_glu", [
    (48, 16384, 32, torch.float32, False),  # the DAMSM step's largest
    (16, 4096, 192, torch.bfloat16, True),
    (3, 37, 6, torch.float32, False),       # C % 4 != 0: scalar path
    (2, 100, 12, torch.bfloat16, True),     # C/2 % 4 != 0: scalar path
    (160, 4096, 64, torch.float32, False),  # Stage B's largest
])
def test_k1_backward_of_an_offset_slice(dev, b, n, c, dtype, use_glu):
    """|mean| six standard deviations from 0 (the sums about the pivot
    keep fp32 from cancelling), at the DAMSM and Stage-B shapes and the
    scalar paths."""
    x, scale, bias = _inputs(b, n, c, torch.float32, dev, seed=7)
    _k1_bwd_matches_twin((x / 1.5 + 6.0).to(dtype), scale, bias, use_glu)


@pytest.mark.parametrize("use_glu", [False, True])
def test_k1_backward_of_an_unaligned_slice(dev, use_glu):
    """x and the cotangent one element past a 16-byte boundary: the plan
    takes the scalar path, and the result is the twin's."""
    b, n, c = 4, 1024, 64
    buf = torch.randn(b * n * c + 1, device=dev).bfloat16()
    x = buf[1:].view(b, n, c)
    gbuf = torch.randn(b * n * (c // 2 if use_glu else c) + 1,
                       device=dev).bfloat16()
    gy = gbuf[1:].view(b, n, -1)
    _, scale, bias = _inputs(b, n, c, torch.float32, dev, seed=8)
    assert groupnorm.bwd_plan_for(x, gy, use_glu, NEEDS[0]).vec == 1
    got = groupnorm.group_norm_backward_cuda(x, scale, bias, 32, 1e-6,
                                             use_glu, gy)
    for name, g, w in zip(("dx", "dscale", "dbias"), got,
                          _twin_vjp(x, scale, bias, use_glu, gy)):
        err, ok = twin_rules.k1_grad(name, g, w, x.dtype, use_glu)
        assert ok, (name, err)


@pytest.mark.parametrize("b,n,c,use_glu", [
    (16, 4096, 64, True),     # resident
    (16, 16384, 96, False),   # streaming
    (16, 65536, 64, True),    # streaming, the largest
])
def test_k1_backward_is_bit_reproducible(dev, b, n, c, use_glu):
    x, scale, bias = _inputs(b, n, c, torch.bfloat16, dev, seed=9)
    gy = _cotangent(x, use_glu, 9)
    a = groupnorm.group_norm_backward_cuda(x, scale, bias, 32, 1e-6,
                                           use_glu, gy)
    b_ = groupnorm.group_norm_backward_cuda(x, scale, bias, 32, 1e-6,
                                            use_glu, gy)
    assert all(torch.equal(u, v) for u, v in zip(a, b_))


@pytest.mark.parametrize("needs,kernels", [((True, True, True), 2),
                                           ((True, False, False), 1)])
def test_k1_backward_in_a_graph(dev, needs, kernels):
    """Captured in a CUDA graph: one call is the main kernel and, for
    dscale and dbias, the kernel that sums their partials, and no other
    node (no memset, no copy); the replay equals the eager call to the
    bit."""
    x, scale, bias = _inputs(16, 16384, 64, torch.bfloat16, dev, seed=10)
    gy = _cotangent(x, True, 10)

    def call():
        return groupnorm.group_norm_backward_cuda(x, scale, bias, 32, 1e-6,
                                                  True, gy, needs)

    assert _graph_nodes(call) == (kernels, kernels)
    eager = call()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    graph.replay()
    torch.cuda.synchronize()
    for u, v in zip(eager, captured):
        assert (u is None and v is None) or torch.equal(u, v)


def test_k1_backward_rejects_bad_input(dev):
    x, scale, bias = _inputs(2, 16, 64, torch.float32, dev)
    gy = torch.randn(2, 16, 64, device=dev)
    with pytest.raises(ValueError, match="cotangent"):
        groupnorm.group_norm_backward_cuda(x, scale, bias, 32, 1e-6, True, gy)
    with pytest.raises(ValueError, match="cotangent"):
        groupnorm.group_norm_backward_cuda(x, scale, bias, 32, 1e-6, False,
                                           gy.bfloat16())
    with pytest.raises(ValueError, match="CUDA"):
        groupnorm.group_norm_backward_cuda(x.cpu(), scale, bias, 32, 1e-6,
                                           False, gy)
    with pytest.raises(ValueError, match="no gradient"):
        groupnorm.group_norm_backward_cuda(x, scale, bias, 32, 1e-6, False,
                                           gy, (False, False, False))


@pytest.mark.parametrize("stage", ["gan", "damsm", "shape"])
def test_tiny_step_on_card_matches_cpu(dev, stage):
    """A tiny fp32 step (``grads``) of each trainer that runs K1, on the
    card against the CPU's (the twins), through
    ``card_check.tiny_step_on_card``: metrics within 1e-4 relative and
    every parameter's gradient within 1e-3 relative norm; and each stage's
    launches. Stage C (G, the discriminators, the frozen image encoder):
    K2, K3, and as many K1 backward calls as K1 launches; DAMSM's image
    encoder: K1 8 times; Stage B: K1 11 times."""
    from objgan_tpu_torch.ops import roi_align
    from objgan_tpu_torch.train import card_check

    def counts():
        return (groupnorm.launches, groupnorm.bwd_launches,
                roi_align.launches["fwd"], roi_align.launches["bwd"])

    before = counts()
    r = card_check.tiny_step_on_card(stage, dev)
    k1, k1b, k2, k3 = (a - b for a, b in zip(counts(), before))
    if stage == "gan":
        assert k1 > 0 and k1b == k1 and k2 > 0 and k3 > 0, (k1, k1b, k2, k3)
    else:
        assert k1 == {"damsm": 8, "shape": 11}[stage]
    assert r["metric_err"] <= card_check.METRIC_RTOL == 1e-4
    assert r["grad_err"] <= card_check.GRAD_RTOL == 1e-3, r["worst"]


def _roi_inputs(b, h, w, c, o, dtype, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    f = torch.randn(b, h, w, c, generator=gen, device=dev).to(dtype)
    xy = torch.rand(b, o, 2, generator=gen, device=dev) * 0.7
    wh = torch.rand(b, o, 2, generator=gen, device=dev) * 0.2 + 0.1
    boxes = torch.cat([xy, wh], -1)
    boxes[:, -1] = 0.0  # a padded (all-zero) box in every image
    boxes[0, 0] = torch.tensor([0.0, 0.0, 1.0, 1.0])  # the full frame
    return f, boxes


# (B, H, W, C, O, R, dtype, q): the train step's shape (16 images, 256 px
# / 8, 10 objects, ROI 7), fp32 at that shape, a tiny one, odd channel
# counts that take the scalar (non-vector) path, and other sampling ratios
# (K2's instance for any q)
ROI_SHAPES = [
    (16, 32, 32, 256, 10, 7, torch.bfloat16, 2),
    (16, 32, 32, 256, 10, 7, torch.float32, 2),
    (2, 8, 8, 32, 3, 4, torch.float32, 2),
    (3, 9, 7, 5, 4, 3, torch.float32, 2),
    (2, 8, 8, 12, 3, 4, torch.bfloat16, 2),
    (3, 9, 7, 5, 4, 3, torch.float32, 3),
    (2, 16, 16, 64, 5, 7, torch.bfloat16, 1),
]


@pytest.mark.parametrize("b,h,w,c,o,r,dtype,q", ROI_SHAPES)
def test_k2_k3_match_twins(dev, b, h, w, c, o, r, dtype, q):
    """K2 against ``roi_align_reference`` and K3 against
    ``roi_align_backward_reference`` (``twin_rules.roi``)."""
    from objgan_tpu_torch.ops import roi_align as ra

    f, boxes = _roi_inputs(b, h, w, c, o, dtype, dev)
    before = dict(ra.launches)
    got = ra.roi_align_cuda(f, boxes, r, q)
    want = ra.roi_align_reference(f, boxes, r, q)
    assert got.dtype == dtype and got.shape == want.shape
    assert twin_rules.roi(got, want, dtype)[1]
    # the padded box returns the top-left pixel everywhere
    assert torch.equal(got[:, -1], f[:, None, None, 0, 0, :].expand_as(
        got[:, -1]))
    g = torch.randn(got.shape, device=dev).to(dtype)
    dfg = ra.roi_align_backward_cuda(boxes, g, f.shape, r, q)
    dfw = ra.roi_align_backward_reference(boxes, g, f.shape, dtype, r, q)
    assert dfg.dtype == dtype and dfg.shape == f.shape
    assert twin_rules.roi(dfg, dfw, dtype)[1]
    assert ra.launches == {"fwd": before["fwd"] + 1,
                           "bwd": before["bwd"] + 1}


def test_k3_is_bit_reproducible(dev):
    from objgan_tpu_torch.ops import roi_align as ra

    f, boxes = _roi_inputs(16, 32, 32, 256, 10, torch.bfloat16, dev, seed=5)
    g = torch.randn(16, 10, 7, 7, 256, device=dev).bfloat16()
    a = ra.roi_align_backward_cuda(boxes, g, f.shape, 7, 2)
    assert torch.equal(a, ra.roi_align_backward_cuda(boxes, g, f.shape, 7, 2))


def test_k3_takes_a_wide_frame(dev):
    """W = 256 at O = 10, which the previous K3 refused for its 48 KiB of
    shared memory: it launches once and matches the twin."""
    from objgan_tpu_torch.ops import roi_align as ra

    f, boxes = _roi_inputs(1, 8, 256, 8, 10, torch.float32, dev, seed=7)
    g = torch.randn(1, 10, 7, 7, 8, device=dev)
    before = dict(ra.launches)
    got = ra.roi_align_backward_cuda(boxes, g, f.shape, 7, 2)
    want = ra.roi_align_backward_reference(boxes, g, f.shape, torch.float32,
                                           7, 2)
    assert ra.launches == {"fwd": before["fwd"], "bwd": before["bwd"] + 1}
    assert twin_rules.roi(got, want, torch.float32)[1]


@pytest.mark.parametrize("c,dtype", [(256, torch.bfloat16),
                                     (64, torch.float32),
                                     (12, torch.bfloat16)])
def test_k2_k3_match_twins_on_adversarial_boxes(dev, c, dtype):
    from objgan_tpu_torch.ops import roi_align as ra

    gen = torch.Generator(device=dev).manual_seed(8)
    boxes = twin_rules.adversarial_boxes(dev)
    f = torch.randn(len(boxes), 32, 32, c, generator=gen,
                    device=dev).to(dtype)
    got = ra.roi_align_cuda(f, boxes, 7, 2)
    assert twin_rules.roi(got, ra.roi_align_reference(f, boxes, 7, 2),
                          dtype)[1]
    assert torch.equal(got[0, 1], f[0, 0, 0].expand_as(got[0, 1]))
    g = torch.randn(got.shape, generator=gen, device=dev).to(dtype)
    dfg = ra.roi_align_backward_cuda(boxes, g, f.shape, 7, 2)
    dfw = ra.roi_align_backward_reference(boxes, g, f.shape, dtype, 7, 2)
    assert twin_rules.roi(dfg, dfw, dtype)[1]


def test_k2_is_bit_reproducible(dev):
    from objgan_tpu_torch.ops import roi_align as ra

    f, boxes = _roi_inputs(16, 32, 32, 256, 10, torch.bfloat16, dev, seed=5)
    a = ra.roi_align_cuda(f, boxes, 7, 2)
    assert torch.equal(a, ra.roi_align_cuda(f, boxes, 7, 2))


def test_k2_k3_are_one_kernel_per_call(dev):
    from objgan_tpu_torch.ops import roi_align as ra

    f, boxes = _roi_inputs(16, 32, 32, 256, 10, torch.bfloat16, dev, seed=9)
    g = torch.randn(16, 10, 7, 7, 256, device=dev).bfloat16()
    assert _graph_nodes(lambda: ra.roi_align_cuda(f, boxes, 7, 2)) == (1, 1)
    assert _graph_nodes(lambda: ra.roi_align_backward_cuda(
        boxes, g, f.shape, 7, 2)) == (1, 1)


def test_roi_align_autograd_on_card_matches_twin(dev):
    """``roi_align`` on a CUDA tensor: K2 forward, K3 backward, the boxes
    without a gradient; against autograd through the twin
    (``twin_rules.roi``)."""
    from objgan_tpu_torch.ops import roi_align as ra

    f, boxes = _roi_inputs(2, 16, 16, 64, 5, torch.float32, dev, seed=6)
    g = torch.randn(2, 5, 7, 7, 64, device=dev)
    outs = []
    for fn in (ra.roi_align, ra.roi_align_reference):
        leaf = f.clone().requires_grad_()
        y = fn(leaf, boxes, 7, 2)
        outs.append((y, torch.autograd.grad(y, leaf, g)[0]))
    (y, df), (y_want, df_want) = outs
    assert twin_rules.roi(y, y_want, torch.float32)[1]
    assert twin_rules.roi(df, df_want, torch.float32)[1]


def test_kernels_launch_on_the_tensors_card(dev):
    """K1, K2 and K3 launch on the card that holds their tensors, whichever
    card is current (a data-parallel rank's tensors on ``cuda:r``): on
    every card, with the next card current. On one card the current card
    is the tensors' own; against the twins by ``twin_rules``."""
    from objgan_tpu_torch.ops import roi_align as ra

    count = torch.cuda.device_count()
    for idx in range(count):
        card = torch.device("cuda", idx)
        x, scale, bias = _inputs(2, 64, 32, torch.float32, card)
        f, boxes = _roi_inputs(2, 8, 8, 32, 3, torch.float32, card)
        g = torch.randn(2, 3, 4, 4, 32, device=card)
        with torch.cuda.device((idx + 1) % count):
            y = groupnorm.group_norm_cuda(x, scale, bias, 8, 1e-6, False)
            r = ra.roi_align_cuda(f, boxes, 4, 2)
            df = ra.roi_align_backward_cuda(boxes, g, f.shape, 4, 2)
        torch.cuda.synchronize(card)
        want = twin_rules.k1_twin(x, scale, bias, 8, 1e-6, False)
        assert y.device == card
        assert twin_rules.k1(y, want, torch.float32)[1]
        assert twin_rules.roi(r, ra.roi_align_reference(f, boxes, 4, 2),
                              torch.float32)[1]
        dfw = ra.roi_align_backward_reference(boxes, g, f.shape,
                                              torch.float32, 4, 2)
        assert twin_rules.roi(df, dfw, torch.float32)[1]


def test_kernel_hw_check_passes(dev):
    """``python -m objgan_tpu_torch.tools.kernel_hw_check``: K1 (fp32, bf16,
    with and without GLU) and K2 + K3 (fp32, bf16) against their plain
    versions, at its default shapes and at a narrow one, each check
    passing and launching its kernels once (``kernel_hw_check.checked``)."""
    from objgan_tpu_torch.tools import kernel_hw_check

    for argv in ([], ["--c", "64", "--o", "3"]):
        assert kernel_hw_check.checked(argv)["passed"] == 6


def test_device_profile_sees_the_kernels(dev):
    """``utils/profiling.device_profile``: the busy time is the union of the
    device intervals, within the wall time, and K1 appears by name."""
    from objgan_tpu_torch.utils import profiling

    x, scale, bias = _inputs(16, 4096, 64, torch.bfloat16, dev)
    wall, busy, spans = profiling.device_profile(
        lambda: [groupnorm.group_norm_cuda(x, scale, bias, 32, 1e-5, True)
                 for _ in range(5)])
    assert 0 < busy <= wall
    assert busy == profiling.busy_ms(spans)
    assert sum("gn_fused_kernel" in name for *_, name in spans) == 5


def test_kernels_read_nothing_past_their_inputs(dev):
    """K1 (both plans, the ring, the scalar paths), K1 backward, K2 and K3
    with every input ending at an unmapped page, each against its twin and
    launched once, in a process of its own (a fault poisons the CUDA
    context); and its control: a plain read one element past a guarded
    tensor faults (``guard_pages.checked``)."""
    from objgan_tpu_torch.tools import guard_pages

    checks = guard_pages.checked()["checks"]
    assert len(checks) == sum(guard_pages.LAUNCHES.values())


# -- K train steps as one CUDA-graph replay (TRAIN.STEPS_PER_EXECUTION) --------

def _tiny_cfg():
    from objgan_tpu_torch.core.config import tiny_test_config

    return tiny_test_config().merged({"DTYPE": "float32"})


K_STAGES = ["gan", "damsm", "box", "shape"]


@pytest.mark.parametrize("stage", K_STAGES)
def test_k_step_graph_equals_eager_steps(dev, stage):
    """Two steps as one replay against two eager steps with the same
    (capturable) Adam, in PyTorch's default mode: equal to the bit where
    two eager runs are, else within the state limits of a restored step
    (``card_check.STATE_ATOL`` / ``STATE_RTOL``); against Adam as K = 1
    runs it, within those limits; the metric means equal to the bit with
    the state, else within 1e-5."""
    from objgan_tpu_torch.train import card_check

    r = card_check.graph_against_eager(stage, _tiny_cfg(), k=2, device=dev)
    assert r["graph"].multi_step().graph() is not None
    assert r["graph"].step == r["eager"].step == r["k1"].step == 4
    e = r["eager_err"]
    assert e["bitwise"] or not r["spread"]["bitwise"], e
    assert not e["misfits"], e
    assert not r["k1_err"]["misfits"], r["k1_err"]
    assert r["metric_err"] <= (0.0 if e["bitwise"] else 1e-5), r[
        "metric_err"]


@pytest.fixture(scope="module")
def deterministic_agreement():
    """The four trainers' replays against eager steps at the tiny config
    in bf16, K = 2, in a process under
    ``torch.use_deterministic_algorithms``
    (``card_check.deterministic_agreement``)."""
    from objgan_tpu_torch.core.config import tiny_test_config
    from objgan_tpu_torch.train import card_check

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tiny = tiny_test_config().merged({"DTYPE": "bfloat16"})
    return card_check.deterministic_agreement(
        {stage: tiny for stage in K_STAGES}, 2)


@pytest.mark.parametrize("stage", K_STAGES)
def test_k_step_graph_equals_eager_steps_to_the_bit(dev,
                                                    deterministic_agreement,
                                                    stage):
    """Under deterministic algorithms two eager runs agree to the bit, and
    the replay equals them: state and metric means. In bf16, where in
    the default mode two eager runs of Stage C part far past the state
    limits within two steps (atomics, amplified by the steps)."""
    r = deterministic_agreement[stage]
    assert r["spread"]["bitwise"], r
    assert r["eager_err"]["bitwise"] and r["metric_err"] == 0.0, r


def test_k_step_graph_holds_the_kernels(dev):
    """The tiny Stage-C graph of K = 2 steps holds twice one eager step's
    K1, K1 backward, K2 and K3 launches as kernel nodes, named in its DOT
    print, and each wrapper counted them once while the graph was
    captured."""
    from objgan_tpu_torch.ops import roi_align
    from objgan_tpu_torch.train import card_check
    from objgan_tpu_torch.train.common import index_stack
    from objgan_tpu_torch.utils.profiling import graph_kernel_nodes

    r = card_check.graph_against_eager("gan", _tiny_cfg(), k=2, device=dev)
    before = (groupnorm.launches, dict(roi_align.launches),
              groupnorm.bwd_launches)
    batches, noises = r["inputs"]
    r["eager"].train_step(index_stack(batches, 0), *index_stack(noises, 0))
    per_step = {"K1": groupnorm.launches - before[0],
                "K1 backward": groupnorm.bwd_launches - before[2],
                "K2": roi_align.launches["fwd"] - before[1]["fwd"],
                "K3": roi_align.launches["bwd"] - before[1]["bwd"]}
    assert all(per_step.values()), per_step
    kernels, nodes, found = graph_kernel_nodes(
        r["graph"].multi_step().graph().raw_cuda_graph(),
        list(twin_rules.KERNEL_NAMES.values()))
    want = {k: 2 * v for k, v in per_step.items()}
    assert r["captured"] == want
    assert {k: found[name]
            for k, name in twin_rules.KERNEL_NAMES.items()} == want
    assert sum(want.values()) < kernels <= nodes


def test_k_step_replay_spans_on_a_card(dev):
    """The program's record of a K = 2 replay of the tiny Stage C: the
    capture's counter ``exec.graph_nodes`` is the graph's nodes over K;
    under the profiler the ``exec`` span's device time is above 0 and
    within the host's wall between the synchronises around it, and its
    range on the device's timeline is a user annotation, which the
    benchmark's kernel union (``h100bench/trace.py``) and
    ``device_profile`` leave out."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from objgan_tpu_torch.train import card_check
    from objgan_tpu_torch.utils import profiling

    cfg = _tiny_cfg()
    trainer = card_check.fresh("gan", cfg, dev)
    inputs = card_check.stacked_inputs("gan", cfg, trainer, 0, 2, dev)
    trainer.multi_train_step(*inputs)  # eager
    trainer.multi_train_step(*inputs)  # captured, then replayed
    nodes = profiling.graph_kernel_nodes(
        trainer.multi_step().graph().raw_cuda_graph())[1]
    assert profiling.recorded()["counters"]["exec.graph_nodes"] == round(
        nodes / 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.multi_train_step(*inputs)
        torch.cuda.synchronize()
        wall_ms = 1000.0 * (time.perf_counter() - t0)
    [span] = [s for s in profiling.recorded()["spans"] if s["name"] == "exec"]
    assert span["steps"] == 2
    assert 0 < span["device_ms"] <= wall_ms, (span["device_ms"], wall_ms)
    on_device = [e for e in prof.events() if e.name == "exec"
                 and e.device_type == torch.autograd.DeviceType.CUDA]
    assert all(e.is_user_annotation for e in on_device)


def marks_against_profiler(trainer):
    """One replay of ``trainer``'s K-step graph alone, under the profiler
    and between two timing events of the stream: for each name of the
    graph's spans of device time (``profiling.device_timed``), (the
    events' device ms, the profiler's ms from the first device operation
    inside the marks to the last one's end, the profiler's busy ms of the
    operations inside), each summed over the K steps. The events are put
    on the profiler's clock by the replay's ends: the time from the first
    event to the replay's first operation is taken equal to that from its
    last operation to the second event."""
    from torch.profiler import ProfilerActivity, profile

    from objgan_tpu_torch.utils.profiling import busy_ms

    ms = trainer.multi_step()
    graph, marks = ms.graph(), ms._marks
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ends[0].record()
        graph.replay()
        ends[1].record()
        torch.cuda.synchronize()
    # every operation on the card, ms on the profiler's clock; names with
    # "#" are kernels too (ATen's elementwise lambdas, "{lambda(float)#1}")
    ops = [(e.time_range.start / 1e3, e.time_range.end / 1e3)
           for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    first, last = min(a for a, _ in ops), max(b for _, b in ops)
    lead = (ends[0].elapsed_time(ends[1]) - (last - first)) / 2
    origin = first - lead  # the first event on the profiler's clock
    out = {}
    for m in marks:
        a = origin + ends[0].elapsed_time(m.events[0])
        b = origin + ends[0].elapsed_time(m.events[1])
        inside = [(max(s, a), min(e, b)) for s, e in ops if e > a and s < b]
        got = out.setdefault(m.name, [0.0, 0.0, 0.0])
        got[0] += b - a
        got[1] += max(e for _, e in inside) - min(s for s, _ in inside)
        got[2] += busy_ms((1e3 * s, 1e3 * e, "") for s, e in inside)
    return out


_INCEPTION_TINY = {"TEXT": {"CNN_BACKBONE": "inception"},
                   "TRAIN": {"GENERATOR_LR": 0.0, "DISCRIMINATOR_LR": 0.0}}

_MARKS = """
import importlib.util, json, sys
import torch
from objgan_tpu_torch.core.precision import true_fp32
from objgan_tpu_torch.train import card_check
spec = importlib.util.spec_from_file_location("card_tests", sys.argv[1])
tests = importlib.util.module_from_spec(spec)
spec.loader.exec_module(tests)
true_fp32()
cfg = tests._tiny_cfg().merged(tests._INCEPTION_TINY)
dev = torch.device("cuda")
trainer = card_check.fresh("gan", cfg, dev)
inputs = card_check.stacked_inputs("gan", cfg, trainer, trainer.step, 8, dev)
for _ in range(3):  # eager, captured, replayed
    trainer.multi_train_step(*inputs)
print(json.dumps(tests.marks_against_profiler(trainer)))
"""


def test_k_step_graph_with_the_inception_encoder(dev):
    """K = 8 steps of the tiny Stage C with the inception DAMSM encoder
    (its gradient through the frozen backbone to the fake) as one replay
    against 8 eager steps, held as ``test_k_step_graph_equals_eager_steps``
    holds K = 2, at learning rates 0: in PyTorch's default mode atomics
    (the pools' and the resize's backward among them) part two eager runs
    by O(1) within a few steps at the configured rates, while at rate 0
    the parameters stay put and Adam's moments sum each step's gradient,
    so the 8 steps' gradients are compared. Under the profiler a replay
    records the spans of the encoder's forward and of its gradient's way
    back, 8 steps each, with device time above 0 and within the replay's.
    In a process of its own (``_MARKS``), each span's events read within
    10 % of the profiler's device time from the first operation inside
    its marks to the last one's end. There, on an H100, they agreed
    within 0.1 %; in this process, after the file's earlier card tests,
    the profiler has seen the gradient's operations over only 43-79 % of
    its events, while the forward's agreed (an open question: the
    benchmark reads the spans in a process of their own).
    """
    import json
    import os
    import subprocess
    import sys
    import time

    from torch.profiler import ProfilerActivity, profile

    from objgan_tpu_torch.train import card_check
    from objgan_tpu_torch.utils import profiling

    cfg = _tiny_cfg().merged(_INCEPTION_TINY)
    r = card_check.graph_against_eager("gan", cfg, k=8, device=dev)
    e = r["eager_err"]
    assert e["bitwise"] or not r["spread"]["bitwise"], e
    assert not e["misfits"], e
    assert not r["k1_err"]["misfits"], r["k1_err"]
    assert r["metric_err"] <= (0.0 if e["bitwise"] else 1e-5), r[
        "metric_err"]
    trainer = r["graph"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        t0 = time.perf_counter()
        trainer.multi_train_step(*r["inputs"])
        torch.cuda.synchronize()
        wall_ms = 1000.0 * (time.perf_counter() - t0)
    spans = {s["name"]: s for s in profiling.recorded()["spans"]}
    replay = spans["exec"]["device_ms"]
    assert 0 < replay <= wall_ms
    for name in ("damsm.img_enc", "damsm.img_enc.grad"):
        assert spans[name]["steps"] == 8, spans[name]
        assert 0 < spans[name]["device_ms"] < replay, (name, spans[name])
    assert spans["damsm.img_enc"]["parent"] is not None
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", _MARKS, os.path.abspath(__file__)], cwd=root,
        env=dict(os.environ, PYTHONPATH=root), capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    marks = json.loads(proc.stdout.strip().splitlines()[-1])
    for name, (events, interval, busy) in marks.items():
        assert abs(events - interval) <= 0.1 * interval, (
            name, events, interval, busy)


def test_k_step_graph_refuses_a_replaced_trainer(dev):
    """A restore after the capture (new Adam state tensors) is refused, not
    replayed against stale memory; so is a new optimiser."""
    from objgan_tpu_torch.train import card_check

    r = card_check.graph_against_eager("box", _tiny_cfg(), k=2, device=dev)
    graph = r["graph"]
    graph.load_state_dict(r["eager"].state_dict())
    with pytest.raises(RuntimeError, match="replaced after"):
        graph.multi_train_step(*r["inputs"])
    r["eager"].multi_train_step(*r["inputs"])  # its warm-up: eager
    r["eager"].multi_train_step(*r["inputs"])  # captured
    r["eager"].reset_optimizers()
    with pytest.raises(RuntimeError, match="replaced after"):
        r["eager"].multi_train_step(*r["inputs"])


def test_k_step_on_a_card_refuses_a_gloo_group(dev):
    """gloo's collectives run on the host: no graph can hold them, so K > 1
    on a card under gloo raises instead of running eagerly."""
    import socket

    import torch.distributed as dist

    from objgan_tpu_torch.train import card_check

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        cfg = _tiny_cfg()
        trainer = card_check.fresh("box", cfg, dev)
        inputs = card_check.stacked_inputs("box", cfg, trainer, 0, 2, dev)
        with pytest.raises(RuntimeError, match="gloo"):
            trainer.multi_train_step(*inputs)
        assert trainer.step == 0
    finally:
        dist.destroy_process_group()


def test_k_step_loop_on_a_card(dev, tmp_path):
    """``cli.train_shape`` with K = 2 on the card: two executions (the
    eager warm-up, then the replay) and the ragged tail's single step,
    fed by the prefetching thread; saved at the last step, the graph
    captured, the state finite."""
    from objgan_tpu_torch import cli
    from objgan_tpu_torch.core.checkpoint import load_latest

    cfg = _tiny_cfg().merged({"OUTPUT_DIR": str(tmp_path), "TRAIN": {
        "STEPS_PER_EXECUTION": 2}})
    trainer = cli.train_shape(cfg, max_steps=5, device=dev, log_every=1)
    assert trainer.step == 5 and trainer.multi_step().graph() is not None
    step, sd = load_latest(str(tmp_path / f"{cfg.CONFIG_NAME}_shape"
                               / "ckpt"))
    assert step == 5
    assert all(torch.isfinite(v).all() for v in sd.values()
               if v.is_floating_point())
