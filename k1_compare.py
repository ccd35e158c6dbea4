#!/usr/bin/env python3
"""Kernel K1 of this checkout against K1 of another checkout, on one GPU.

    git archive <commit> | tar -x -C <dir>      # e.g. the parent commit
    python3 k1_compare.py --other <dir>

Records every K1 call of one served batch (``cfg/eval_coco.yml``, batch 16)
and of one train step (``cfg/coco_objgan.yml``), with fresh weights from
``RNG_SEED``, as ``chip_smoke.py`` does. Then, for each distinct call shape,
it times both kernels in turns (other, this, this, other), each turn the
device time of one call per CUDA-graph replay (``chip_smoke.py``'s ``ms``)
and of ten calls captured in one graph, per call (its ``ms_10_per_graph``),
and checks both against this checkout's plain PyTorch twin. It prints the
card's ``name, power.limit``, a line per shape (the min/max of each
kernel's two turns) and the totals per served batch and per train step. The
other
checkout is only read: its ``objgan_tpu_torch/csrc/groupnorm.cu`` is built
with this checkout's nvcc flags into this checkout's ``_build/`` (named by
the source's hash) and driven through its own ``ops/groupnorm.py``.
"""

import argparse
import ctypes
import hashlib
import os
import subprocess
import sys
import types

ROOT = os.path.dirname(os.path.abspath(__file__))


def load_other(other):
    """The other checkout's K1 wrapper module, bound to its own kernel. Its
    files are read, never written."""
    from objgan_tpu_torch.ops import _build

    pkg = os.path.join(os.path.abspath(other), "objgan_tpu_torch")
    src = os.path.join(pkg, "csrc", "groupnorm.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    lib_path = _build.BUILD / f"libgroupnorm-other-{digest}.so"
    if not lib_path.exists():
        _build.BUILD.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                        str(lib_path), src], check=True, capture_output=True)
    wrapper = os.path.join(pkg, "ops", "groupnorm.py")
    with open(wrapper) as f:
        code = compile(f.read(), wrapper, "exec")
    mod = types.ModuleType("other_groupnorm")
    mod.__file__ = wrapper
    sys.modules[mod.__name__] = mod  # for its NamedTuple and annotations
    exec(code, mod.__dict__)  # no bytecode cache written beside it
    lib = ctypes.CDLL(str(lib_path))
    mod._build = types.SimpleNamespace(load=lambda name: lib)
    return mod


def record_calls():
    """{"served batch": records, "train step": records}: every K1 call's
    (layer, input) of one served batch and of one train step."""
    import torch

    import chip_smoke as cs
    from objgan_tpu_torch import cli
    from objgan_tpu_torch.core.config import cfg_from_file
    from objgan_tpu_torch.data.tokenizer import Vocab
    from objgan_tpu_torch.pipeline_e2e import ObjGanPipeline, draw_noise

    cfg = cfg_from_file(os.path.join(ROOT, "cfg", "eval_coco.yml"))
    pipe = ObjGanPipeline.fresh(cfg, cfg.RNG_SEED, "cuda")
    vocab = Vocab.build(cs.CAPTIONS)
    ids, lens = vocab.encode_batch(cs.CAPTIONS[:16], cfg.TEXT.WORDS_NUM)
    noise = draw_noise(cfg, 16, torch.Generator("cuda").manual_seed(1),
                       "cuda")
    served, hooks = cs._record_gn(pipe)
    with torch.no_grad():
        pipe.generate(torch.from_numpy(ids).long().cuda(),
                      torch.from_numpy(lens).long().cuda(), noise)
    for h in hooks:
        h.remove()
    del pipe
    train_cfg = cfg_from_file(os.path.join(ROOT, "cfg", "coco_objgan.yml"))
    trainer = cli.make_trainer(train_cfg, "cuda")
    train, _, _, _ = cs._record_train_step(train_cfg, trainer)
    del trainer
    torch.cuda.synchronize()
    return {"served batch": served, "train step": train}


def compare(name, records, other):
    import torch

    import chip_smoke as cs
    from objgan_tpu_torch.ops import groupnorm as this

    shapes = {}
    for mod, x in records:
        x3 = x.reshape(x.shape[0], -1, x.shape[-1]).contiguous()
        args = (mod.weight, mod.bias, mod.num_groups, mod.eps, mod.use_glu)
        key = (tuple(x3.shape), str(x3.dtype).replace("torch.", ""),
               mod.use_glu)
        shapes.setdefault(key, [x3, args, 0])[2] += 1
    kinds = [(k, calls) for calls in (1, 10) for k in ("other", "this")]
    tot = {kind: [0.0, 0.0] for kind in kinds}

    def span(kind, v, fmt=".1f"):
        return f"{kind[0]} {min(v):{fmt}}-{max(v):{fmt}}"

    for (shape, dt, glu), (x3, args, n) in shapes.items():
        fns = {"other": lambda: other.group_norm_cuda(x3, *args),
               "this": lambda: this.group_norm_cuda(x3, *args)}
        want = this.group_norm_reference(x3, *args).float()
        errs = {k: float((f().float() - want).abs().max())
                for k, f in fns.items()}
        times = {kind: [] for kind in kinds}
        for calls in (1, 10):
            for k in ("other", "this", "this", "other"):
                times[(k, calls)].append(
                    1000 * cs.time_ms(fns[k], calls=calls)[0])
        for kind, v in times.items():
            tot[kind][0] += n * min(v)
            tot[kind][1] += n * max(v)
        print(f"[{name}] {shape} {dt} {'GN+GLU' if glu else 'GN'} x{n}: "
              f"max err other {errs['other']:.3g}, this {errs['this']:.3g} "
              f"| us, one call per graph: "
              + ", ".join(span(kind, times[kind]) for kind in kinds[:2])
              + " | ten per graph: "
              + ", ".join(span(kind, times[kind]) for kind in kinds[2:]),
              flush=True)
    print(f"[{name}] {sum(s[2] for s in shapes.values())} calls, device ms "
          f"per {name}, one call per graph: "
          + ", ".join(span(kind, [t / 1000 for t in tot[kind]], ".3f")
                      for kind in kinds[:2])
          + " | ten per graph: "
          + ", ".join(span(kind, [t / 1000 for t in tot[kind]], ".3f")
                      for kind in kinds[2:]),
          flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", required=True,
                        help="root of the checkout whose K1 to compare")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k1_compare: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from objgan_tpu_torch.core.precision import true_fp32

    true_fp32()
    card, _ = cs.phase_device()
    print(card, flush=True)
    other = load_other(args.other)
    for name, records in record_calls().items():
        with torch.no_grad():
            compare(name, records, other)
    return 0


if __name__ == "__main__":
    sys.exit(main())
