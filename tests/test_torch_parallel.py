"""``objgan_tpu_torch/parallel/sharding.py``: the rank layout, and the
losses that couple the global batch on 2 gloo ranks.

* The layout, as ``tests/test_parallel.py`` holds JAX's: a rank's slice of
  the global batch and of the records, the (data, model) mesh at model 1
  and 2 on 8 ranks, and the errors at a batch or a model axis that does
  not divide (the rank and world are patched in: no group is made).
* Without a group every collective is a no-op that returns its input, and
  a masked mean is bitwise the one-process expression.
* On 2 spawned gloo ranks (one spawn for the file, 1 thread each), on the
  rows of global inputs made with numpy: ``_masked_mean``'s shares,
  ``roll_sent`` and ``damsm_loss`` against the same functions on the
  global batch in this process. The mean of the ranks' losses is the
  global loss, and each rank's gradient with respect to its rows, divided
  by the world size (the average the trainers take), is the global
  gradient's rows: fp32 rtol 1e-5, atol 1e-6. The control: the ranks'
  local-only losses (their own count, their own B x B matching) differ
  from the global ones by more than 1e-2, so the comparison can fail.
"""

import numpy as np
import pytest
import torch

from objgan_tpu_torch.core.config import tiny_test_config
from objgan_tpu_torch.losses import damsm_loss as tdl
from objgan_tpu_torch.losses import gan_loss as tgl
from objgan_tpu_torch.parallel import dryrun, sharding
from tests import torch_ddp_ranks

TOL = dict(rtol=1e-5, atol=1e-6)
WORLD = 2


def _as(monkeypatch, rank, world):
    monkeypatch.setattr(sharding, "rank_and_world", lambda: (rank, world))


@pytest.mark.parametrize("rank,world,batch,want", [
    (0, 1, 16, (0, 16)), (0, 8, 16, (0, 2)), (3, 8, 16, (6, 2)),
    (7, 8, 16, (14, 2)), (1, 2, 4, (2, 2))])
def test_process_local_batch_slice(monkeypatch, rank, world, batch, want):
    _as(monkeypatch, rank, world)
    assert sharding.process_local_batch_slice(batch) == want


def test_process_local_batch_slice_raises(monkeypatch):
    _as(monkeypatch, 0, 8)
    with pytest.raises(ValueError, match="not divisible by 8"):
        sharding.process_local_batch_slice(9)


@pytest.mark.parametrize("rank,world", [(0, 1), (0, 3), (2, 3), (5, 8)])
def test_process_local_records(monkeypatch, rank, world):
    _as(monkeypatch, rank, world)
    records = [{"id": i} for i in range(10)]
    got = sharding.process_local_records(records)
    assert list(got) == records[rank::world]
    if world == 1:
        assert got is records


@pytest.mark.parametrize("mp,rank,want", [
    (1, 0, (0, 8, 0, 1)), (1, 5, (5, 8, 0, 1)),
    (2, 0, (0, 4, 0, 2)), (2, 1, (0, 4, 1, 2)), (2, 5, (2, 4, 1, 2))])
def test_make_mesh_layout(monkeypatch, mp, rank, want):
    """The model axis innermost: the ranks of one model group are adjacent
    and read one data shard."""
    _as(monkeypatch, rank, 8)
    mesh = sharding.make_mesh(mp)
    assert tuple(mesh) == want
    assert sharding.local_batch_size(16, mesh) == 16 // mesh.data_size


def test_make_mesh_and_local_batch_raise(monkeypatch):
    _as(monkeypatch, 0, 8)
    with pytest.raises(ValueError, match="not divisible by model=3"):
        sharding.make_mesh(3)
    assert sharding.local_batch_size(16) == 2
    with pytest.raises(ValueError, match="TRAIN.BATCH_SIZE=9 is not "
                                         "divisible by the data-parallel"):
        sharding.local_batch_size(9)


def test_without_a_group_everything_is_a_no_op(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert sharding.maybe_initialize_distributed("cpu") is False
    assert sharding.rank_and_world() == (0, 1) and sharding.is_main()
    assert sharding.rank_device("cuda") == torch.device("cuda")
    x = torch.randn(4, 3)
    for fn in (sharding.all_gather_with_grad, sharding.global_sum,
               sharding.local_rows):
        assert fn(x) is x
    metrics = {"a": torch.tensor(1.5)}
    assert sharding.all_reduce_metrics(metrics) is metrics
    grads = {"w": x.clone()}
    sharding.all_reduce_grads_(grads)
    assert torch.equal(grads["w"], x)
    assert sharding.broadcast_object(7) == 7
    sharding.barrier()
    assert sharding.global_batch(3) == 3
    mask = (torch.rand(4, 3) > 0.5).float()
    assert torch.equal(tgl._masked_mean(x, mask),
                       (x * mask).sum() / torch.clamp(mask.sum(), min=1.0))


def test_rank_device_under_torchrun(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert sharding.rank_device("cuda") == torch.device("cuda", 3)
    assert sharding.rank_device("cuda:0") == torch.device("cuda", 0)
    assert sharding.rank_device("cpu") == torch.device("cpu")


# -- 2 ranks ---------------------------------------------------------------------


def _inputs():
    r = np.random.default_rng(7)
    b = 2 * WORLD
    f32 = np.float32
    # rank 0's rows hold 5 valid entries, rank 1's 1: the local-only
    # masked means weigh them alike, the global one by count
    mask = np.zeros((b, 3), f32)
    mask[:2] = [[1, 1, 1], [1, 1, 0]]
    mask[2, 0] = 1
    return {k: torch.from_numpy(v) for k, v in {
        "x": r.normal(size=(b, 3)).astype(f32) + 3 * mask, "mask": mask,
        "regions": r.normal(size=(b, 16, 8)).astype(f32),
        "global": r.normal(size=(b, 8)).astype(f32),
        "words": r.normal(size=(b, 6, 8)).astype(f32),
        "sent": r.normal(size=(b, 8)).astype(f32),
        "lens": np.array([6, 3, 4, 2], np.int64),
        "ids": np.array([0, 1, 2, 0], np.int64)}.items()}


@pytest.fixture(scope="module")
def ranks():
    smooth = tiny_test_config().TRAIN.SMOOTH
    inputs = _inputs()
    return inputs, smooth, dryrun.spawn(
        WORLD, torch_ddp_ranks.losses_on_ranks, (inputs, smooth), "cpu",
        "gloo")


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               **TOL)


def test_masked_mean_takes_the_global_count(ranks):
    inputs, _, got = ranks
    x = inputs["x"].clone().requires_grad_(True)
    want = tgl._masked_mean(x, inputs["mask"])
    (dx,) = torch.autograd.grad(want, x)
    _close(torch.stack([r["masked"] for r in got]).mean(), want)
    _close(torch.cat([r["masked_grad"] for r in got]) / WORLD, dx)


def test_roll_sent_rolls_the_global_batch(ranks):
    inputs, _, got = ranks
    assert torch.equal(torch.cat([r["roll"] for r in got]),
                       tgl.roll_sent(inputs["sent"]))
    # rank 1's first wrong caption is rank 0's last
    assert torch.equal(got[1]["roll"][0], inputs["sent"][1])


def test_damsm_loss_matches_the_global_batch(ranks):
    inputs, smooth, got = ranks
    feats = [inputs[k].clone().requires_grad_(True)
             for k in ("regions", "global", "words", "sent")]
    want, parts = tdl.damsm_loss(*feats, inputs["lens"], inputs["ids"],
                                 smooth)
    grads = torch.autograd.grad(want, feats)
    for r in got:  # every rank holds the global loss itself
        _close(r["damsm"], want)
        for k, v in parts.items():
            _close(r["damsm_parts"][k], v)
    for i, g in enumerate(grads):
        _close(torch.cat([r["damsm_grads"][i] for r in got]) / WORLD, g)
        assert float(g.abs().max()) > 0


def test_local_only_losses_differ(ranks):
    """The control: without the collectives the ranks would train another
    objective; the difference is far above the tolerance."""
    inputs, smooth, got = ranks
    want = tgl._masked_mean(inputs["x"], inputs["mask"])
    local = torch.stack([r["masked_local"] for r in got]).mean()
    assert abs(float(local - want)) > 1e-2 * abs(float(want))
    damsm, _ = tdl.damsm_loss(*(inputs[k] for k in ("regions", "global",
                                                    "words", "sent")),
                              inputs["lens"], inputs["ids"], smooth)
    local = torch.stack([r["damsm_local"] for r in got]).mean()
    assert abs(float(local - damsm)) > 1e-2 * abs(float(damsm))
