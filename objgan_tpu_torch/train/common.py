"""What the port's trainers share: Adam as the JAX package sets it up, the
checkpointable trainer state, optax's global-norm clip, the per-step
random streams and ``MultiStep``, K train steps per execution
(``TRAIN.STEPS_PER_EXECUTION``; JAX's ``make_multi_step``).

``Trainer.state_dict`` holds, beside ``nn.Module``'s parameters and
buffers, every optimiser's Adam state under ``optim.<parameter
name>.<step | exp_avg | exp_avg_sq>`` and the trainer's ``step``: one flat
dict of tensors, which ``core/checkpoint.py`` saves and restores.

Under data parallelism (``parallel/sharding.py``) ``grads_of`` returns the
rank's own gradients and the metrics averaged over the ranks, and
``apply_grads`` averages the gradients over the ranks before the clip, so
a global-norm clip sees the gradient of the global batch and every rank
takes the same Adam step. The reduction is explicit, not
``DistributedDataParallel``'s: ``torch.autograd.grad`` bypasses its
reducer.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from objgan_tpu_torch.parallel import sharding
from objgan_tpu_torch.utils import profiling

_ADAM_KEYS = ("step", "exp_avg", "exp_avg_sq")


def adam(params, lr: float, b1: float = 0.5) -> torch.optim.Adam:
    """optax.adam(lr, b1=b1, b2=0.999) (eps 1e-8); the GAN stages and
    DAMSM take b1 0.5, Stage A optax's default 0.9. ``MultiStep`` makes it
    capturable on a card (``set_capturable``)."""
    return torch.optim.Adam(params, lr=lr, betas=(b1, 0.999), eps=1e-8)


def set_capturable(opt: torch.optim.Optimizer, capturable: bool) -> None:
    """Adam as a CUDA graph can hold it, or back: ``capturable``, each step
    count on its parameter's card, so the bias corrections are computed
    there at every replay (and not baked into the graph from the host's
    count); else the counts on the CPU. The arithmetic is Adam's either
    way, in another rounding order."""
    opt.defaults["capturable"] = capturable
    for group in opt.param_groups:
        group["capturable"] = capturable
        for p in group["params"]:
            state = opt.state.get(p)
            if state:
                state["step"] = state["step"].to(
                    p.device if capturable else "cpu")


def step_generator(seed: int, step: int, device, stream: int = 0,
                   rank: int = 0) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, step, stream): the
    port's counterpart of ``jax.random.fold_in(PRNGKey(seed), step)``. A
    step's draws depend on its number only, so a resumed run draws what an
    unbroken one would. A draw that differs between the ranks (each rank's
    synthetic batch) adds the rank, as JAX folds in the process index: rank
    0 draws what one process draws."""
    entropy = [seed, step, stream] + ([rank] if rank else [])
    state = np.random.SeedSequence(entropy).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]) >> 1)


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: with the global norm n of
    ``grads``, each g stays g if n < max_norm, else becomes
    (g / n) * max_norm. Returns n. (``torch.nn.utils.clip_grad_norm_`` is
    another rule: it scales by max_norm / (n + 1e-6), clamped at 1.)"""
    norms = torch._foreach_norm(grads)
    total = torch.stack(norms).square().sum().sqrt()
    keep = total < max_norm
    one = torch.ones_like(total)
    torch._foreach_div_(grads, torch.where(keep, one, total))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))
    return total


class Trainer(nn.Module):
    """A module that owns Adam optimisers (``optimizers()``) and a step
    count ``step``, checkpointed together by ``state_dict`` and
    ``load_state_dict``. ``train_step(batch, *noise)`` takes one step,
    ``step_noise(batch, generator)`` draws its noise arguments and
    ``multi_train_step`` takes K steps in one execution (``MultiStep``)."""

    step: int = 0
    _multi_step: Optional["MultiStep"] = None

    def step_noise(self, batch: Dict, generator: torch.Generator
                   ) -> Tuple[Optional[torch.Tensor], ...]:
        """The noise arguments of ``train_step`` for ``batch`` (numpy or
        tensors; only its shapes are read), drawn from ``generator`` on its
        device."""
        raise NotImplementedError

    def multi_train_step(self, batches: Dict, noises: Sequence
                         ) -> Dict[str, torch.Tensor]:
        """K train steps in one execution: ``batches`` is K batches stacked
        on a leading axis (each level of "images" stacked), ``noises`` the
        noise arguments of ``train_step`` stacked likewise (None stays
        None). Returns the K-axis mean of each metric. The counterpart of
        the JAX trainers' ``multi_train_step``; ``multi_step()`` holds the
        executor."""
        return self.multi_step()(batches, noises)

    def multi_step(self) -> "MultiStep":
        """This trainer's K-step executor, made at the first call."""
        if self._multi_step is None:
            self._multi_step = MultiStep(self)
        return self._multi_step

    def optimizers(self) -> List[torch.optim.Optimizer]:
        raise NotImplementedError

    def trained_parameters(self) -> Dict[str, nn.Parameter]:
        """The parameters that take gradients, by name: all but frozen
        backbones (``requires_grad`` off)."""
        return {n: p for n, p in self.named_parameters() if p.requires_grad}

    @staticmethod
    def grads_of(losses: Sequence[Tuple[torch.Tensor,
                                        Dict[str, nn.Parameter]]],
                 metrics: Dict[str, torch.Tensor]
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """Each (loss, {name: parameter}) pair's gradients by name (zeros
        where the loss does not reach a parameter; this rank's), and
        ``metrics`` detached and averaged over the ranks."""
        grads = {}
        for loss, params in losses:
            got = torch.autograd.grad(loss, list(params.values()),
                                      allow_unused=True)
            for (name, p), g in zip(params.items(), got):
                grads[name] = torch.zeros_like(p) if g is None else g
        return grads, sharding.all_reduce_metrics(
            {k: v.detach() for k, v in metrics.items()})

    def clip_(self, grads: Dict[str, torch.Tensor]) -> None:
        """Clips ``grads`` in place before ``apply_grads``' Adam steps;
        none by default."""

    @torch.no_grad()
    def apply_grads(self, grads: Dict[str, torch.Tensor]) -> None:
        """The average of ``grads`` (by parameter name) over the ranks,
        ``clip_``, then one Adam step of every optimiser."""
        sharding.all_reduce_grads_(grads)
        self.clip_(grads)
        for name, p in self.named_parameters():
            if name in grads:
                p.grad = grads[name]
        for opt in self.optimizers():
            opt.step()
            opt.zero_grad(set_to_none=True)
        self.step += 1

    def _adam_entries(self) -> Iterator[Tuple[str, torch.optim.Optimizer,
                                              nn.Parameter]]:
        names = {p: n for n, p in self.named_parameters()}
        for opt in self.optimizers():
            for group in opt.param_groups:
                for p in group["params"]:
                    yield f"optim.{names[p]}.", opt, p

    def state_dict(self, *args, **kwargs) -> Dict[str, torch.Tensor]:
        """nn.Module's keys, the Adam state (zeros at step 0 before a
        parameter's first update, as Adam would create it; each step count
        fp32 on the CPU, capturable or not) and ``step``."""
        sd = super().state_dict(*args, **kwargs)
        prefix = kwargs.get("prefix", "")
        for key, opt, p in self._adam_entries():
            state = opt.state.get(p) or {
                "step": torch.tensor(0.0), "exp_avg": torch.zeros_like(p),
                "exp_avg_sq": torch.zeros_like(p)}
            sd[prefix + key + "step"] = state["step"].detach().to(
                "cpu", torch.float32)
            for k in _ADAM_KEYS[1:]:
                sd[prefix + key + k] = state[k].detach()
        sd[prefix + "step"] = torch.tensor(self.step, dtype=torch.int64)
        return sd

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        """Copies every tensor of ``state_dict`` (on any device) into this
        trainer on its own device; Adam's step counts fp32 on the CPU, where
        Adam keeps them, or on the parameter's card for a capturable Adam.
        Its new Adam state refuses a graph captured before
        (``MultiStep``)."""
        sd = dict(state_dict)
        step = sd.pop("step")
        adam_state = {k: sd.pop(k) for k in list(sd) if k.startswith(
            "optim.")}
        result = super().load_state_dict(sd, strict=strict, assign=assign)
        for key, opt, p in self._adam_entries():
            home = p.device if opt.defaults["capturable"] else "cpu"
            opt.state[p] = {
                "step": adam_state[key + "step"].to(home, torch.float32,
                                                    copy=True),
                **{k: adam_state[key + k].to(p.device, p.dtype, copy=True)
                   for k in _ADAM_KEYS[1:]}}
        self.step = int(step)
        return result


# -- K train steps per execution ------------------------------------------------


def tensor_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in tensor_leaves(x)]
    return []


def _map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def _layout(tree) -> Any:
    """What a capture fixes of a tree: its structure, and each tensor's
    shape, dtype and device."""
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype, tree.device)
    if isinstance(tree, dict):
        return tuple((k, _layout(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return tuple(_layout(v) for v in tree)
    return tree


def index_stack(tree, i: int):
    """Entry ``i`` of the leading axis of every tensor of a stacked tree
    (views)."""
    return _map(lambda t: t[i], tree)


class MultiStep:
    """K train steps of ``trainer`` in one execution: the counterpart of
    JAX's ``make_multi_step`` (a ``lax.scan`` of the step), for
    ``TRAIN.STEPS_PER_EXECUTION`` = K. ``self(batches, noises)`` runs
    ``trainer.train_step(batches[k], *noises[k])`` for k < K and returns
    the K-axis mean of each metric (fp32, 0-d).

    On the CPU that is a plain loop over the stack. On a card the first
    call runs the loop eagerly on a side stream: a real execution, and the
    warm-up before the capture (Adam's state, made capturable first with
    its step counts on the card; the kernels' builds and one-time
    attributes; NCCL's communicator). The second call captures the loop,
    and the K-mean of the metrics, in a CUDA graph around static copies
    of the inputs and replays it; every later call copies its inputs into
    them and replays. ``trainer.step`` is counted here: the capture runs
    the host code of K steps and a replay none.

    Nothing falls back. The graph reads the trainer's tensors where they
    lay at the capture, so a call after one of them was replaced (a
    restore, ``reset_optimizers``, ``.to``) raises, as does a call whose
    shapes differ from the first call's (``fits`` asks first), a capture
    that fails, and K > 1 on a card under a gloo group, whose collectives
    no graph can hold. A copy of the trainer starts without a graph.

    Each call is the span ``exec`` (``utils/profiling.py``), with
    ``steps`` K, and on a card its replay's device time, between two
    timing events on the current stream; each capture sets the counter
    ``exec.graph_nodes``, the graph's nodes over K. The spans of device
    time that the steps open (``profiling.device_timed``) are captured
    with the graph, and a replay under the recorder adds them beside
    ``exec`` (``profiling.replayed``)."""

    def __init__(self, trainer: Trainer):
        self.trainer = trainer
        self._layout = None
        self._warm = False
        self._stream = None
        self._graph = None
        self._static = None
        self._out = None
        self._keys: List[str] = []
        self._fingerprint = None
        self._marks: List = []

    def __deepcopy__(self, memo):
        return None  # the graph belongs to the original's tensors

    def graph(self) -> Optional[torch.cuda.CUDAGraph]:
        """The captured graph (its ``raw_cuda_graph()`` kept for
        inspection), or None before the capture."""
        return self._graph

    def fits(self, batches: Dict, noises: Sequence) -> bool:
        """Whether ``batches`` and ``noises`` have the shapes of the first
        call (and so of the graph)."""
        return self._layout in (None, _layout((batches, tuple(noises))))

    def __call__(self, batches: Dict, noises: Sequence
                 ) -> Dict[str, torch.Tensor]:
        noises = tuple(noises)
        if not self.fits(batches, noises):
            raise ValueError("K-step inputs whose shapes differ from the "
                             "first execution's: take them as single "
                             "steps")
        self._layout = _layout((batches, noises))
        device = next(self.trainer.parameters()).device
        k = self._k(batches)
        with profiling.span("exec", k) as span:
            if device.type != "cuda":
                return self._loop(batches, noises)
            if not self._warm:
                return self._warm_up(batches, noises, device)
            if self._fingerprint != self._take_fingerprint():
                raise RuntimeError(
                    "the trainer's tensors were replaced after its K-step "
                    "CUDA graph was captured (a restore, reset_optimizers, "
                    ".to or load_state_dict): the graph would read stale "
                    "memory; make a new trainer, or restore before the "
                    "first K-step call")
            if self._graph is None:
                self._capture(batches, noises, device)
            for dst, src in zip(tensor_leaves(self._static),
                                tensor_leaves((batches, noises))):
                dst.copy_(src)
            start = self.trainer.step
            profiling.settle()
            span.device_start()
            self._graph.replay()
            span.device_end()
            profiling.replayed(self._marks)
            self.trainer.step = start + k
            return dict(zip(self._keys, self._out.clone().unbind()))

    @staticmethod
    def _k(batches: Dict) -> int:
        return tensor_leaves(batches)[0].shape[0]

    def _loop(self, batches: Dict, noises: Tuple
              ) -> Dict[str, torch.Tensor]:
        rows = [self.trainer.train_step(index_stack(batches, i),
                                        *index_stack(noises, i))
                for i in range(self._k(batches))]
        return {k: torch.stack([r[k].float() for r in rows]).mean(0)
                for k in rows[0]}

    def _take_fingerprint(self) -> Tuple:
        """Where every tensor that the graph reads or writes lies: the
        parameters, the buffers, the optimisers and their Adam state."""
        t = self.trainer
        marks = [x.data_ptr() for x in t.parameters()]
        marks += [x.data_ptr() for x in t.buffers()]
        for opt in t.optimizers():
            marks.append(id(opt))
            for group in opt.param_groups:
                for p in group["params"]:
                    marks += [v.data_ptr() for v in
                              opt.state.get(p, {}).values()
                              if isinstance(v, torch.Tensor)]
        return tuple(marks)

    def _warm_up(self, batches: Dict, noises: Tuple,
                 device: torch.device) -> Dict[str, torch.Tensor]:
        sharding.check_capturable()
        for opt in self.trainer.optimizers():
            set_capturable(opt, True)
        current = torch.cuda.current_stream(device)
        self._stream = torch.cuda.Stream(device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            metrics = self._loop(batches, noises)
            sharding.prepare_capture()
        current.wait_stream(self._stream)
        self._warm = True
        self._fingerprint = self._take_fingerprint()
        return metrics

    def _capture(self, batches: Dict, noises: Tuple,
                 device: torch.device) -> None:
        self._static = _map(torch.empty_like, (batches, noises))
        batches, noises = self._static
        start = self.trainer.step
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        self._stream.wait_stream(torch.cuda.current_stream(device))
        try:
            # thread_local: the feed's producer thread goes on copying to
            # the card on its own stream meanwhile
            with torch.cuda.graph(graph, stream=self._stream,
                                  capture_error_mode="thread_local"), \
                    profiling.capturing() as marks:
                means = self._loop(batches, noises)
                self._out = torch.stack(list(means.values()))
        except Exception as e:
            raise RuntimeError("capturing K train steps in a CUDA graph "
                               "failed") from e
        finally:
            self.trainer.step = start
        self._keys = list(means)
        self._graph = graph
        self._marks = marks
        profiling.count("exec.graph_nodes", round(profiling.graph_nodes(
            graph.raw_cuda_graph()) / self._k(batches)))
