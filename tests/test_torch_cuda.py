"""The port's kernels against their plain PyTorch twins on the card: K1
(objgan_tpu_torch/csrc/groupnorm.cu) at the shapes the served model gives
it and under autograd, K2 and K3 (objgan_tpu_torch/csrc/roi_align.cu) at
the train step's shapes and under autograd. Card-only: marked ``cuda`` and
skipped without a CUDA device. This file imports neither JAX nor the
parity helpers, so on a GPU host it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: fp32 atol 1e-4 (another summation order); K1 in bf16 atol
3e-2, rtol 2e-2 (a fp32 difference can round to the neighbouring bf16
value, and the GLU rounds three times); K2/K3 in bf16 atol 1e-2, rtol
1e-2 (fp32 sums, one rounding)."""

import pytest
import torch

from objgan_tpu_torch.models.common import gn, gn_glu
from objgan_tpu_torch.ops import groupnorm

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
    (160, 64, 256, torch.float32, False),    # ShapeGenerator _Down_2
    (3, 37, 6, torch.float32, False),        # C % 4 != 0: scalar path
    (2, 100, 12, torch.bfloat16, True),      # C/2 % 8 != 0: scalar path
]


def _groups(c):
    return 32 if c % 32 == 0 else 2 if c % 2 == 0 else 1


def _k1_matches_twin(x, scale, bias, use_glu):
    groups = _groups(x.shape[-1])
    before = groupnorm.launches
    got = groupnorm.group_norm_cuda(x, scale, bias, groups, 1e-6, use_glu)
    torch.cuda.synchronize()
    assert groupnorm.launches == before + 1
    want = groupnorm.group_norm_reference(x, scale, bias, groups, 1e-6,
                                          use_glu)
    assert got.dtype == x.dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs()
    if x.dtype == torch.float32:
        assert float(err.max()) <= 1e-4
    else:
        assert not bool((err > 3e-2 + 2e-2 * want.float().abs()).any())


@pytest.mark.parametrize("b,n,c,dtype,use_glu", SHAPES)
def test_k1_matches_twin(dev, b, n, c, dtype, use_glu):
    x, scale, bias = _inputs(b, n, c, dtype, dev)
    _k1_matches_twin(x, scale, bias, use_glu)


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


def test_k1_is_one_kernel_per_call(dev):
    """A CUDA graph captured around one call holds one node, a kernel
    (counted with libcuda's cuGraphGetNodes and cuGraphNodeGetType)."""
    import ctypes

    x, scale, bias = _inputs(16, 65536, 64, torch.bfloat16, dev, seed=4)
    groupnorm.group_norm_cuda(x, scale, bias, 32, 1e-6, True)  # first use
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        groupnorm.group_norm_cuda(x, scale, bias, 32, 1e-6, True)
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int)]
    count = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(graph.raw_cuda_graph(), None,
                              ctypes.byref(count)) == 0
    assert count.value == 1
    node = (ctypes.c_void_p * 1)()
    assert cu.cuGraphGetNodes(graph.raw_cuda_graph(), node,
                              ctypes.byref(count)) == 0
    kind = ctypes.c_int(-1)
    assert cu.cuGraphNodeGetType(node[0], ctypes.byref(kind)) == 0
    assert kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    graph.reset()


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
    m = make(96)
    with torch.no_grad():
        m.weight.uniform_(0.5, 1.5)
        m.bias.normal_(0, 0.2)
    x = torch.randn(4, 8, 8, 96)
    want = m(x)
    got = m.to(dev)(x.to(dev))
    assert float((got.cpu() - want).abs().max()) <= 1e-4


def test_k1_function_gradient_matches_twin(dev):
    """On the card ``group_norm`` runs K1 inside ``GroupNormFunction``; its
    gradients (dx, dscale, dbias) are the twin's, fp32 atol 1e-4."""
    for use_glu in (False, True):
        x, scale, bias = _inputs(2, 64, 96, torch.float32, dev, seed=4)
        g = torch.randn(2, 64, 48 if use_glu else 96, device=dev)
        grads = []
        for fn in (groupnorm.group_norm, groupnorm.group_norm_reference):
            leaves = [v.clone().requires_grad_() for v in (x, scale, bias)]
            before = groupnorm.launches
            y = fn(*leaves, 32, 1e-6, use_glu)
            assert (groupnorm.launches - before
                    == (fn is groupnorm.group_norm))
            grads.append(torch.autograd.grad(y, leaves, g))
        for got, want in zip(*grads):
            assert float((got - want).abs().max()) <= 1e-4


def _roi_inputs(b, h, w, c, o, dtype, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    f = torch.randn(b, h, w, c, generator=gen, device=dev).to(dtype)
    xy = torch.rand(b, o, 2, generator=gen, device=dev) * 0.7
    wh = torch.rand(b, o, 2, generator=gen, device=dev) * 0.2 + 0.1
    boxes = torch.cat([xy, wh], -1)
    boxes[:, -1] = 0.0  # a padded (all-zero) box in every image
    boxes[0, 0] = torch.tensor([0.0, 0.0, 1.0, 1.0])  # the full frame
    return f, boxes


def _roi_close(got, want, dtype):
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        return float(err.max()) <= 1e-4
    return not bool((err > 1e-2 + 1e-2 * want.float().abs()).any())


# (B, H, W, C, O, R, dtype): the train step's shape (16 images, 256 px /
# 8, 10 objects, ROI 7), fp32 at that shape, a tiny one, and odd channel
# counts that take the scalar (non-vector) path
ROI_SHAPES = [
    (16, 32, 32, 256, 10, 7, torch.bfloat16),
    (16, 32, 32, 256, 10, 7, torch.float32),
    (2, 8, 8, 32, 3, 4, torch.float32),
    (3, 9, 7, 5, 4, 3, torch.float32),
    (2, 8, 8, 12, 3, 4, torch.bfloat16),
]


@pytest.mark.parametrize("b,h,w,c,o,r,dtype", ROI_SHAPES)
def test_k2_k3_match_twins(dev, b, h, w, c, o, r, dtype):
    """K2 against ``roi_align_reference`` and K3 against
    ``roi_align_backward_reference``: fp32 atol 1e-4; bf16 atol 1e-2, rtol
    1e-2 (fp32 sums in another order, then one rounding to bf16)."""
    from objgan_tpu_torch.ops import roi_align as ra

    f, boxes = _roi_inputs(b, h, w, c, o, dtype, dev)
    before = dict(ra.launches)
    got = ra.roi_align_cuda(f, boxes, r, 2)
    want = ra.roi_align_reference(f, boxes, r, 2)
    assert got.dtype == dtype and got.shape == want.shape
    assert _roi_close(got, want, dtype)
    # the padded box returns the top-left pixel everywhere
    assert torch.equal(got[:, -1], f[:, None, None, 0, 0, :].expand_as(
        got[:, -1]))
    g = torch.randn(got.shape, device=dev).to(dtype)
    dfg = ra.roi_align_backward_cuda(boxes, g, f.shape, r, 2)
    dfw = ra.roi_align_backward_reference(boxes, g, f.shape, dtype, r, 2)
    assert dfg.dtype == dtype and dfg.shape == f.shape
    assert _roi_close(dfg, dfw, dtype)
    assert ra.launches == {"fwd": before["fwd"] + 1,
                           "bwd": before["bwd"] + 1}


def test_k3_is_bit_reproducible(dev):
    from objgan_tpu_torch.ops import roi_align as ra

    f, boxes = _roi_inputs(16, 32, 32, 256, 10, torch.bfloat16, dev, seed=5)
    g = torch.randn(16, 10, 7, 7, 256, device=dev).bfloat16()
    a = ra.roi_align_backward_cuda(boxes, g, f.shape, 7, 2)
    assert torch.equal(a, ra.roi_align_backward_cuda(boxes, g, f.shape, 7, 2))


def test_k3_rejects_shared_memory_overflow(dev):
    """O·R·W beyond K3's 48 KiB of shared memory: the C entry launches
    nothing and the wrapper raises, counting no launch."""
    from objgan_tpu_torch.ops import roi_align as ra

    f, boxes = _roi_inputs(1, 8, 256, 8, 10, torch.float32, dev, seed=7)
    g = torch.randn(1, 10, 7, 7, 8, device=dev)
    before = dict(ra.launches)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        ra.roi_align_backward_cuda(boxes, g, f.shape, 7, 2)
    assert ra.launches == before


def test_roi_align_autograd_on_card_matches_twin(dev):
    """``roi_align`` on a CUDA tensor: K2 forward, K3 backward, the boxes
    without a gradient; fp32 atol 1e-4 against autograd through the twin."""
    from objgan_tpu_torch.ops import roi_align as ra

    f, boxes = _roi_inputs(2, 16, 16, 64, 5, torch.float32, dev, seed=6)
    g = torch.randn(2, 5, 7, 7, 64, device=dev)
    outs = []
    for fn in (ra.roi_align, ra.roi_align_reference):
        leaf = f.clone().requires_grad_()
        y = fn(leaf, boxes, 7, 2)
        outs.append((y, torch.autograd.grad(y, leaf, g)[0]))
    (y, df), (y_want, df_want) = outs
    assert float((y - y_want).abs().max()) <= 1e-4
    assert float((df - df_want).abs().max()) <= 1e-4
