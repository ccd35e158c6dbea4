#!/usr/bin/env python3
"""The kernels of this checkout against those of another checkout, on one
GPU.

    git archive <commit> | tar -x -C <dir>      # e.g. the parent commit
    python3 kernel_compare.py --other <dir> [--kernels k1,roi]

Records, with fresh weights from ``RNG_SEED`` as ``chip_smoke.py`` does,
every K1 call of one served batch (``cfg/eval_coco.yml``, batch 16) and of
one train step (``cfg/coco_objgan.yml``), and the 3 K2 and 3 K3 calls of
that step (replayed with the recorded boxes, then with the padded
objects' boxes zeroed, as real batches give them). Then it times both checkouts' kernels in turns (other, this,
this, other), each turn the device time of one call per CUDA-graph replay
(``chip_smoke.py``'s ``ms``) and of ten calls captured in one graph, per
call (its ``ms_10_per_graph``), and checks both against this checkout's
plain PyTorch twin. It prints the card's ``name, power.limit``, a line per
K1 shape and per K2/K3 call (the min/max of each kernel's two turns) and the
totals per served batch and per train step. The other checkout is only
read: its ``objgan_tpu_torch/csrc/<name>.cu`` is built with this checkout's
nvcc flags into this checkout's ``_build/`` (named by the source's hash)
and driven through its own ``ops/<name>.py``.
"""

import argparse
import ctypes
import hashlib
import os
import subprocess
import sys
import types

ROOT = os.path.dirname(os.path.abspath(__file__))


def load_other(other, name):
    """The other checkout's wrapper module ``ops/<name>.py``, bound to its
    own kernel ``csrc/<name>.cu``. Its files are read, never written."""
    from objgan_tpu_torch.ops import _build

    pkg = os.path.join(os.path.abspath(other), "objgan_tpu_torch")
    src = os.path.join(pkg, "csrc", f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    lib_path = _build.BUILD / f"lib{name}-other-{digest}.so"
    if not lib_path.exists():
        _build.BUILD.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                        str(lib_path), src], check=True, capture_output=True)
    wrapper = os.path.join(pkg, "ops", f"{name}.py")
    with open(wrapper) as f:
        code = compile(f.read(), wrapper, "exec")
    mod = types.ModuleType(f"other_{name}")
    mod.__file__ = wrapper
    sys.modules[mod.__name__] = mod  # for its NamedTuple and annotations
    exec(code, mod.__dict__)  # no bytecode cache written beside it
    lib = ctypes.CDLL(str(lib_path))
    mod._build = types.SimpleNamespace(load=lambda _: lib)
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
    train, fwd, bwd, pad = cs._record_train_step(train_cfg, trainer)
    del trainer
    torch.cuda.synchronize()
    return {"served batch": served, "train step": train}, fwd, bwd, pad


def _span(kind, v, fmt=".1f"):
    return f"{kind[0]} {min(v):{fmt}}-{max(v):{fmt}}"


KINDS = [(k, calls) for calls in (1, 10) for k in ("other", "this")]


def _turns(fns):
    """{(kind, calls): [us, us]}: each kernel timed in turns (other, this,
    this, other), one and ten calls per graph."""
    import chip_smoke as cs

    times = {kind: [] for kind in KINDS}
    for calls in (1, 10):
        for k in ("other", "this", "this", "other"):
            times[(k, calls)].append(1000 * cs.time_ms(fns[k],
                                                       calls=calls)[0])
    return times


def _total_line(name, what, n, tot):
    print(f"[{name}] {n} calls, device ms per {what}, one call per graph: "
          + ", ".join(_span(kind, [t / 1000 for t in tot[kind]], ".4f")
                      for kind in KINDS[:2])
          + " | ten per graph: "
          + ", ".join(_span(kind, [t / 1000 for t in tot[kind]], ".4f")
                      for kind in KINDS[2:]),
          flush=True)


def compare_roi(fwd, bwd, pad, other):
    """Each K2 and K3 call of the train step, this checkout's kernel
    against the other's, both checked against this checkout's twin: with
    the recorded boxes, then with the padded objects' boxes zeroed, as
    real batches give them."""
    from objgan_tpu_torch.ops import roi_align as this

    def zeroed(boxes):
        return boxes.masked_fill(pad[..., None], 0.0)

    for name, calls in (
            ("K2", fwd), ("K3", bwd),
            ("K2, padded boxes zeroed",
             [(f, zeroed(bx), r, q) for f, bx, r, q in fwd]),
            ("K3, padded boxes zeroed",
             [(zeroed(bx), g, fs, r, q) for bx, g, fs, r, q in bwd])):
        tot = {kind: [0.0, 0.0] for kind in KINDS}
        for n_call, call in enumerate(calls):
            if name.startswith("K2"):
                f, boxes, r, q = call
                fns = {m: (lambda m=m: m.roi_align_cuda(f, boxes, r, q))
                       for m in (this, other)}
                want = this.roi_align_reference(f, boxes, r, q).float()
            else:
                boxes, g, f_shape, r, q = call
                fns = {m: (lambda m=m: m.roi_align_backward_cuda(
                    boxes, g, f_shape, r, q)) for m in (this, other)}
                want = this.roi_align_backward_reference(
                    boxes, g, f_shape, g.dtype, r, q).float()
            fns = {"this": fns[this], "other": fns[other]}
            errs = {k: float((fn().float() - want).abs().max())
                    for k, fn in fns.items()}
            times = _turns(fns)
            for kind, v in times.items():
                tot[kind][0] += min(v)
                tot[kind][1] += max(v)
            print(f"[train step] {name} call {n_call + 1}: max err other "
                  f"{errs['other']:.3g}, this {errs['this']:.3g} | us, one "
                  f"call per graph: "
                  + ", ".join(_span(kind, times[kind]) for kind in KINDS[:2])
                  + " | ten per graph: "
                  + ", ".join(_span(kind, times[kind]) for kind in KINDS[2:]),
                  flush=True)
        _total_line(f"train step {name}", "train step", len(calls), tot)


def compare_k1(name, records, other):
    from objgan_tpu_torch.ops import groupnorm as this

    shapes = {}
    for mod, x in records:
        x3 = x.reshape(x.shape[0], -1, x.shape[-1]).contiguous()
        args = (mod.weight, mod.bias, mod.num_groups, mod.eps, mod.use_glu)
        key = (tuple(x3.shape), str(x3.dtype).replace("torch.", ""),
               mod.use_glu)
        shapes.setdefault(key, [x3, args, 0])[2] += 1
    tot = {kind: [0.0, 0.0] for kind in KINDS}
    for (shape, dt, glu), (x3, args, n) in shapes.items():
        fns = {"other": lambda: other.group_norm_cuda(x3, *args),
               "this": lambda: this.group_norm_cuda(x3, *args)}
        want = this.group_norm_reference(x3, *args).float()
        errs = {k: float((f().float() - want).abs().max())
                for k, f in fns.items()}
        times = _turns(fns)
        for kind, v in times.items():
            tot[kind][0] += n * min(v)
            tot[kind][1] += n * max(v)
        print(f"[{name}] {shape} {dt} {'GN+GLU' if glu else 'GN'} x{n}: "
              f"max err other {errs['other']:.3g}, this {errs['this']:.3g} "
              f"| us, one call per graph: "
              + ", ".join(_span(kind, times[kind]) for kind in KINDS[:2])
              + " | ten per graph: "
              + ", ".join(_span(kind, times[kind]) for kind in KINDS[2:]),
              flush=True)
    _total_line(name, name, sum(s[2] for s in shapes.values()), tot)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", required=True,
                        help="root of the checkout whose kernels to compare")
    parser.add_argument("--kernels", default="k1,roi",
                        help="comma-separated: k1 (GroupNorm), roi (K2/K3)")
    args = parser.parse_args()
    which = set(args.kernels.split(","))
    if not which or which - {"k1", "roi"}:
        parser.error(f"--kernels takes k1 and/or roi, got {args.kernels}")
    import torch

    if not torch.cuda.is_available():
        print("kernel_compare: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from objgan_tpu_torch.core.precision import true_fp32

    true_fp32()
    card, _ = cs.phase_device()
    print(card, flush=True)
    gn, fwd, bwd, pad = record_calls()
    with torch.no_grad():
        if "k1" in which:
            other = load_other(args.other, "groupnorm")
            for name, records in gn.items():
                compare_k1(name, records, other)
        if "roi" in which:
            compare_roi(fwd, bwd, pad, load_other(args.other, "roi_align"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
