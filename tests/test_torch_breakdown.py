"""The port's per-stage breakdown (objgan_tpu_torch/utils/breakdown.py) on
the CPU at tiny_test_config size: the keys are exactly those the JAX
package's ``utils/breakdown.py`` names for this config (spelled out here
from its naming, not run: JAX compiles a program per stage), the sums and
differences add up, ``_gbps`` is ``_mbytes`` over the rounded ``_ms``, the
CA-net's flops are its one matmul's 2*B*in*out, the materialised stages
chain to ``GanTrainer.sample``'s images bit for bit, and the kernels' work
formulas count each input read once and each output written once. The
numbers mean something only on a card (``chip_smoke.py`` phase
``breakdown``)."""

import pytest
import torch

from objgan_tpu_torch.data.synthetic import synthetic_batch
from objgan_tpu_torch.ops import groupnorm
from objgan_tpu_torch.train.gan import GanTrainer, train_noise
from objgan_tpu_torch.utils import breakdown
from tests.torch_parity import ttiny

torch.set_num_threads(2)

# JAX's names for BASE_SIZE 16 and BRANCH_NUM 3 (breakdown.py:272-310)
SAMPLING_STAGES = ["text_encoder", "ca_net", "layout_paste",
                   "layout_encoder", "init_stage_16", "attn_stage1_16to32",
                   "attn_stage2_32to64", "image_heads"]
TRAIN_KEYS = {"loss_fwd_ms", "g_grad_ms", "d_grad_ms", "g_bwd_only_ms",
              "d_bwd_only_ms", "decomposed_step_ms"}


@pytest.fixture(scope="module")
def setup():
    cfg = ttiny()
    gen = torch.Generator().manual_seed(0)
    trainer = GanTrainer(cfg).init_state(gen)
    batch = synthetic_batch(cfg, gen)
    noise = train_noise(cfg, cfg.TRAIN.BATCH_SIZE, gen, "cpu")
    return cfg, trainer, batch, noise["z"], noise["ca_eps"]


def test_sampling_keys_and_sum(setup):
    out = breakdown.sampling_breakdown(*setup, n_loop=2)
    assert set(out) == {f"{s}_ms" for s in SAMPLING_STAGES} | {
        "stage_sum_ms"}
    assert all(v >= 0 for v in out.values()) and out["stage_sum_ms"] > 0
    parts = sum(out[f"{s}_ms"] for s in SAMPLING_STAGES)
    assert out["stage_sum_ms"] == pytest.approx(parts, abs=1e-9)


def test_sampling_analyze_costs(setup):
    cfg, trainer = setup[:2]
    out = breakdown.sampling_breakdown(*setup, n_loop=1, analyze=True)
    want = {f"{s}_{k}" for s in SAMPLING_STAGES
            for k in ("ms", "gflops", "mbytes", "gbps")}
    assert set(out) == want | {"stage_sum_ms"}
    for s in SAMPLING_STAGES:
        assert out[f"{s}_mbytes"] > 0
        # from the same rounded ms, so only gbps's own rounding is slack
        assert out[f"{s}_gbps"] == pytest.approx(
            out[f"{s}_mbytes"] / out[f"{s}_ms"], abs=0.051)
    # the CA-net's one matmul: (B, EMBEDDING_DIM) @ (EMBEDDING_DIM, 4 c)
    b, d = cfg.TRAIN.BATCH_SIZE, cfg.TEXT.EMBEDDING_DIM
    assert out["ca_net_gflops"] == 2 * b * d * 4 * cfg.GAN.CONDITION_DIM / 1e9
    assert out["init_stage_16_gflops"] > out["ca_net_gflops"]
    assert out["stage_sum_ms"] == round(
        sum(out[f"{s}_ms"] for s in SAMPLING_STAGES), 3)


def test_train_keys_and_arithmetic(setup):
    out = breakdown.train_breakdown(*setup, n_loop=1, analyze=True)
    assert set(out) == TRAIN_KEYS | {
        f"{s}_{k}" for s in ("loss_fwd", "g_grad", "d_grad")
        for k in ("gflops", "mbytes", "gbps")}
    assert out["decomposed_step_ms"] == pytest.approx(
        out["g_grad_ms"] + out["d_grad_ms"] - out["loss_fwd_ms"], abs=0.002)
    assert out["g_bwd_only_ms"] == pytest.approx(
        out["g_grad_ms"] - out["loss_fwd_ms"], abs=0.001)
    # a gradient does the forward's work and more
    for s in ("g_grad", "d_grad"):
        assert out[f"{s}_gflops"] > out["loss_fwd_gflops"] > 0
        assert out[f"{s}_mbytes"] > out["loss_fwd_mbytes"]


def test_materialized_stages_chain_to_sample(setup):
    cfg, trainer, batch, z, ca_eps = setup
    want = trainer.sample(batch, z, ca_eps)["images"]
    mt = breakdown.materialize(cfg, trainer, batch, z, ca_eps)
    stages = breakdown.sampling_stages(cfg, trainer, batch, z, ca_eps)
    assert list(stages) == SAMPLING_STAGES
    assert torch.equal(stages["layout_encoder"](), mt["layout4"])
    assert torch.equal(stages["init_stage_16"](), mt["h"][16])
    assert torch.equal(stages["attn_stage1_16to32"]()[0], mt["h"][32])
    assert torch.equal(stages["attn_stage2_32to64"]()[0], mt["h"][64])
    heads = stages["image_heads"]()
    assert len(heads) == len(want)
    for got, w in zip(heads, want):
        assert torch.equal(got, w)


def test_kernel_work_formulas():
    x3 = torch.zeros(2, 10, 8, dtype=torch.bfloat16)
    scale, bias = torch.ones(8), torch.zeros(8)
    nbytes, flops = breakdown.kernel_work(
        "K1", (x3, scale, bias, 4, 1e-5, True))
    assert nbytes == 2 * 10 * 8 * 2 * 3 // 2 + 2 * 8 * 4
    assert flops == 8 * x3.numel()
    assert breakdown.kernel_work("K1", (x3, scale, bias, 4, 1e-5, False)
                                 )[0] == 2 * 10 * 8 * 2 * 2 + 2 * 8 * 4
    # one box over the whole 8x8 map: every pixel touched
    boxes = torch.tensor([[[0.0, 0.0, 1.0, 1.0]]])
    feats = torch.zeros(1, 8, 8, 4)
    k2 = breakdown.kernel_work("K2", (feats, boxes, 2, 2))
    out_bytes = 1 * 1 * 2 * 2 * 4 * 4
    assert k2[0] == 8 * 8 * 4 * 4 + out_bytes + 4 * 4
    g = torch.zeros(1, 1, 2, 2, 4)
    k3 = breakdown.kernel_work("K3", (boxes, g, (1, 8, 8, 4), 2, 2))
    assert k3 == (out_bytes + 8 * 8 * 4 * 4 + 4 * 4, k2[1])
    assert k2[1] > 0 and k2[1] % (2 * 4) == 0


def test_kernel_launches_are_recorded_and_restored():
    original = groupnorm.group_norm_cuda
    x3 = torch.zeros(1, 4, 8)
    with breakdown._kernel_calls() as calls:
        assert groupnorm.group_norm_cuda is not original
        with pytest.raises(ValueError, match="needs a CUDA tensor"):
            groupnorm.group_norm_cuda(x3, torch.ones(8), torch.zeros(8), 4,
                                      1e-5, False)
    assert groupnorm.group_norm_cuda is original
    assert [k for k, _ in calls] == ["K1"]


def test_byte_counter_counts_operands_and_results_not_views():
    a, b = torch.ones(4, 8), torch.ones(8, 3)
    with breakdown._ByteCounter() as bc:
        y = (a @ b).t().contiguous().view(-1)  # a copy, then a view
    assert y.shape == (12,)
    # the matmul's operands and result, then the copy's read and write
    assert bc.bytes == (32 + 24 + 12 + 2 * 12) * 4
