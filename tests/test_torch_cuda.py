"""Kernel K1 (objgan_tpu_torch/csrc/groupnorm.cu) against its plain PyTorch
twin on the card, at the shapes the served model gives it. Card-only:
marked ``cuda`` and skipped without a CUDA device. This file imports
neither JAX nor the parity helpers, so on a GPU host it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: fp32 atol 1e-4 (another summation order); bf16 atol 3e-2,
rtol 2e-2 (a fp32 difference can round to the neighbouring bf16 value,
and the GLU rounds three times)."""

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


@pytest.mark.parametrize("b,n,c,dtype,use_glu", SHAPES)
def test_k1_matches_twin(dev, b, n, c, dtype, use_glu):
    x, scale, bias = _inputs(b, n, c, dtype, dev)
    groups = 32 if c % 32 == 0 else 2 if c % 2 == 0 else 1
    before = groupnorm.launches
    got = groupnorm.group_norm_cuda(x, scale, bias, groups, 1e-6, use_glu)
    torch.cuda.synchronize()
    assert groupnorm.launches == before + 1
    want = groupnorm.group_norm_reference(x, scale, bias, groups, 1e-6,
                                          use_glu)
    assert got.dtype == dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert float(err.max()) <= 1e-4
    else:
        assert not bool((err > 3e-2 + 2e-2 * want.float().abs()).any())


def test_k1_is_bit_reproducible(dev):
    x, scale, bias = _inputs(16, 16384, 64, torch.bfloat16, dev, seed=3)
    a = groupnorm.group_norm_cuda(x, scale, bias, 32, 1e-6, True)
    b = groupnorm.group_norm_cuda(x, scale, bias, 32, 1e-6, True)
    assert torch.equal(a, b)


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
