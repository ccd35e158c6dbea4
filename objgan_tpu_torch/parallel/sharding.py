"""Data parallelism over ``torch.distributed``: the port's counterpart of
``objgan_tpu/parallel/sharding.py``.

Under ``jit`` the JAX package computes each step's losses over the global
batch, sharded over a ``data`` mesh axis, with the parameters replicated.
Here each rank is one process with its own card (``torchrun`` starts
them; ``maybe_initialize_distributed`` joins the group), holds the whole
model and feeds its rows of the global batch, and the collectives below
make the step equal to one process's step on the global batch.

The convention, for every loss of the four trainers: **a rank's loss is
its share, and the mean of the shares over the ranks is the loss of the
global batch.** Gradients and metrics are therefore *averaged* over the
ranks (``all_reduce_grads_``, ``all_reduce_metrics``):

* a mean over the rank's rows (every rank holds as many) is a share as it
  stands;
* a masked mean, whose denominator counts the valid entries of the global
  batch, is ``world`` x the local masked sum / the global count
  (``masked_mean_share``);
* a loss that couples rows (DAMSM's B x B matching, the mismatched-caption
  roll) is computed on the global batch, gathered with
  ``all_gather_with_grad``: every rank then holds the global loss itself.
  The gather's backward sums the cotangents of all ranks, so a rank's
  gradient through it is ``world`` times its part of the global gradient,
  and the average divides that out.

Without a process group every function here is a no-op that returns its
input, and one process runs exactly as it did before data parallelism was
added. Only ``all_reduce``, ``broadcast`` and ``barrier`` are used (a
gather is an ``all_reduce`` of a zero-padded buffer), the collectives that
gloo runs on CUDA tensors as well as on CPU ones; under NCCL a CPU tensor
goes through the rank's card.
"""

from __future__ import annotations

import os
from typing import (Any, Callable, Dict, List, NamedTuple, Sequence,
                    Tuple)

import torch
import torch.distributed as dist


def _ready() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank_and_world() -> Tuple[int, int]:
    """(rank, world size) of the process group; (0, 1) without one."""
    if _ready():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_main() -> bool:
    """True on rank 0, the rank that writes checkpoints, metrics and
    grids; True without a group."""
    return rank_and_world()[0] == 0


def rank_device(device) -> torch.device:
    """``device`` as this rank uses it: a bare ``cuda`` under torchrun's
    environment (``WORLD_SIZE`` and ``LOCAL_RANK`` set) is
    ``cuda:LOCAL_RANK``; any other device, and every device outside such an
    environment, as given."""
    device = torch.device(device)
    env = os.environ
    if (device.type == "cuda" and device.index is None
            and "WORLD_SIZE" in env and "LOCAL_RANK" in env):
        return torch.device("cuda", int(env["LOCAL_RANK"]))
    return device


def maybe_initialize_distributed(device="cuda",
                                 backend: str | None = None) -> bool:
    """Join the process group that torchrun's environment describes
    (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``); True when a group is up. Without ``WORLD_SIZE`` it
    does nothing and returns False, so one process runs as before.

    On a CUDA device the rank's card (``rank_device``) becomes the current
    device *before* the group is made and before anything is allocated on
    a card: the kernels' launches and NCCL's communicator use the current
    device. ``backend``: NCCL for a CUDA device and gloo for the CPU unless
    the caller names one (the dry run puts two gloo ranks on one card).
    Idempotent."""
    if _ready():
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    device = rank_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend or ("nccl" if device.type == "cuda" else "gloo"),
        init_method="env://")
    return True


class Mesh(NamedTuple):
    """The rank layout of a (data, model) mesh: rank = data_index *
    model_size + model_index, as JAX's ``reshape(n // mp, mp)``."""
    data_index: int
    data_size: int
    model_index: int
    model_size: int


def make_mesh(model_parallelism: int = 1) -> Mesh:
    """The (data, model) layout of the ranks: the model axis innermost, so
    the ranks of one model group are adjacent and read the same shard. The
    parameters are replicated over both axes, as in the JAX package (no
    parameter is sharded over the model axis), so a step's arithmetic is
    that of data parallelism over every rank."""
    rank, world = rank_and_world()
    if world % model_parallelism:
        raise ValueError(f"{world} ranks not divisible by "
                         f"model={model_parallelism}")
    return Mesh(rank // model_parallelism, world // model_parallelism,
                rank % model_parallelism, model_parallelism)


def local_batch_size(global_batch: int, mesh: Mesh | None = None) -> int:
    """The rows of ``global_batch`` that one data shard holds; raises when
    the data axis does not divide it."""
    n = (mesh or make_mesh()).data_size
    if global_batch % n:
        raise ValueError(
            f"TRAIN.BATCH_SIZE={global_batch} is not divisible by the "
            f"data-parallel mesh axis ({n} ranks); the batch is sharded over "
            f"ranks, so raise BATCH_SIZE to a multiple of {n} (per-rank "
            f"batch = BATCH_SIZE / {n})")
    return global_batch // n


def process_local_batch_slice(global_batch: int) -> Tuple[int, int]:
    """(start, size) of this rank's rows of the global batch."""
    rank, world = rank_and_world()
    if global_batch % world:
        raise ValueError(f"batch {global_batch} not divisible by {world} "
                         "ranks")
    per = global_batch // world
    return rank * per, per


def process_local_records(records: Sequence[Any]) -> Sequence[Any]:
    """This rank's strided part of the dataset, ``records[rank::world]``
    (the lineage's DistributedSampler contract): ranks never serve one
    another's records. ``records`` itself without a group."""
    rank, world = rank_and_world()
    if world == 1:
        return records
    return list(records)[rank::world]


def local_rows(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's rows (along ``dim``) of a tensor drawn for the global
    batch: the noise of a step is drawn for every row of the global batch
    and each rank takes its slice, so a row's draws do not depend on the
    world size."""
    if not _ready():
        return x
    start, size = process_local_batch_slice(x.shape[dim])
    return x.narrow(dim, start, size)


def global_batch(local: int) -> int:
    """The global batch that ``local`` rows per rank make."""
    return local * rank_and_world()[1]


# -- collectives ---------------------------------------------------------------


def _flat_(tensors: Sequence[torch.Tensor],
           op: Callable[[torch.Tensor], None]) -> None:
    """Apply the in-place collective ``op`` to ``tensors`` through one flat
    buffer per (dtype, device), and write the result back into them."""
    buckets: Dict[Tuple[torch.dtype, torch.device],
                  List[torch.Tensor]] = {}
    for t in tensors:
        buckets.setdefault((t.dtype, t.device), []).append(t)
    nccl = dist.get_backend() == "nccl"
    for group in buckets.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        home = flat.device
        if nccl and home.type != "cuda":
            flat = flat.to(torch.device("cuda", torch.cuda.current_device()))
        op(flat)
        flat = flat.to(home)
        for t, piece in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(piece.view_as(t))


def _mean_(flat: torch.Tensor) -> None:
    dist.all_reduce(flat)
    flat.div_(dist.get_world_size())


def all_reduce_grads_(grads: Dict[str, torch.Tensor]) -> None:
    """Average ``grads`` (by parameter name) over the ranks, in place: one
    flat all-reduce per dtype."""
    if _ready():
        _flat_(list(grads.values()), _mean_)


def all_reduce_metrics(metrics: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """The step's 0-d metrics averaged over the ranks (fp32), in one
    all-reduce; ``metrics`` itself without a group."""
    if not _ready():
        return metrics
    flat = torch.stack([v.detach().float().reshape(())
                        for v in metrics.values()])
    _flat_([flat], _mean_)
    return dict(zip(metrics, flat.unbind()))


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks (no gradient): the global count of a
    masked mean."""
    if not _ready():
        return x
    y = x.detach().clone()
    _flat_([y], dist.all_reduce)
    return y


def masked_mean_share(total: torch.Tensor,
                      count: torch.Tensor) -> torch.Tensor:
    """This rank's share of a masked mean over the global batch: ``world``
    x ``total`` (the rank's masked sum) / max(global ``count``, 1).
    Without a group, ``total / max(count, 1)``."""
    if not _ready():
        return total / torch.clamp(count, min=1.0)
    return (dist.get_world_size() * total
            / torch.clamp(global_sum(count), min=1.0))


class _Gather(torch.autograd.Function):
    """All-gather along dim 0 (rank order) as an all-reduce of a
    zero-padded buffer; the backward sums the cotangents of every rank and
    returns this rank's rows."""

    @staticmethod
    def forward(ctx, x):
        rank, world = rank_and_world()
        b = x.shape[0]
        ctx.rows = (rank * b, b)
        out = x.new_zeros((world * b, *x.shape[1:]))
        out[rank * b:(rank + 1) * b] = x
        _flat_([out], dist.all_reduce)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _flat_([g], dist.all_reduce)
        start, b = ctx.rows
        return g[start:start + b]


def all_gather_with_grad(x: torch.Tensor) -> torch.Tensor:
    """The global batch of ``x`` (every rank's rows, in rank order) on
    every rank, differentiable: the gradient of a rank's rows is the sum of
    every rank's cotangent for them. ``x`` itself without a group."""
    if not _ready():
        return x
    return _Gather.apply(x)


def broadcast_object(obj: Any) -> Any:
    """Rank 0's ``obj`` (picklable) on every rank."""
    if not _ready():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def broadcast_module_(module: torch.nn.Module) -> None:
    """Rank 0's state on every rank, in place: parameters, buffers and,
    for a trainer (``train/common.py``), every Adam moment and step count
    and the step. The counterpart of ``replicate``: called after a trainer
    is built or restored."""
    if not _ready():
        return
    state = module.state_dict()
    _flat_(list(state.values()), lambda flat: dist.broadcast(flat, 0))
    module.load_state_dict(state)


def check_capturable() -> None:
    """Raise unless this group's collectives can be captured in a CUDA
    graph (``train/common.py::MultiStep``): NCCL's run on the card and can,
    gloo's run on the host and cannot. Nothing to check without a
    group."""
    if _ready() and dist.get_backend() != "nccl":
        raise RuntimeError(
            f"TRAIN.STEPS_PER_EXECUTION > 1 on a CUDA device captures the "
            f"steps in a CUDA graph, and a {dist.get_backend()} process "
            f"group's collectives cannot be captured: use NCCL, or "
            f"STEPS_PER_EXECUTION 1")


def prepare_capture() -> None:
    """One all-reduce on the current stream, before a CUDA graph captures
    the gradients' and metrics' all-reduces: NCCL sets up its
    communicator and stream at a first collective, which cannot happen
    inside a capture. Nothing without an NCCL group."""
    if _ready() and dist.get_backend() == "nccl":
        dist.all_reduce(torch.zeros(1, device=torch.device(
            "cuda", torch.cuda.current_device())))


def shutdown() -> None:
    """Leave the process group, if this process joined one: an entry
    point's last act."""
    if _ready():
        dist.destroy_process_group()


def barrier() -> None:
    """Wait for every rank (on the rank's card under NCCL)."""
    if not _ready():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
