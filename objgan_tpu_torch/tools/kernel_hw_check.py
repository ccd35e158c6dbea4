"""The port's kernels on the card against their plain versions: the
counterpart of ``objgan_tpu/tools/kernel_hw_check.py``.

    python -m objgan_tpu_torch.tools.kernel_hw_check [--c 256] [--o 10] \
        [--out_size 7] [--q 2]

Each check runs a kernel through the port's autograd Function at a shape
of the train step and compares it with its plain PyTorch version on the
same card:

* K2 + K3 (``csrc/roi_align.cu`` through ``RoiAlignFunction``), the value
  of ``sum(roi_align(f)^2)`` and its gradient with respect to the features
  (B 4, 16 x 16, C ``--c``, ``--o`` boxes): fp32 with distinct boxes (rtol
  and atol 1e-4: the same sums in another order), then bf16 with every box
  overlapping, so each feature's gradient sums ``--o`` contributions, in
  fp32 (rtol 0.01, atol 0.05: one final bf16 rounding);
* K1 (``csrc/groupnorm.cu`` through ``GroupNormFunction``) at (2, 128 *
  128, 128) with 16 groups, with and without GLU: fp32 against the plain
  version evaluated in fp64 (rtol and atol 1e-5), bf16 against it in bf16
  (1e-2).

One PASS or FAIL line per check, then the kernels' launches; exits 0 when
every check passes, 1 otherwise, and 2 without a CUDA device (the plain
versions against themselves would prove nothing). ``checked(argv)`` runs
the checks in the caller's process and raises unless each passed and
launched its kernels once; ``chip_smoke.py`` and the card test call it.
"""

from __future__ import annotations

import argparse
import sys

import torch


def _report(name: str, ok: bool, detail: str) -> bool:
    print(f"{'PASS' if ok else 'FAIL'} {name}: {detail}", flush=True)
    return ok


def check_roi(name, feats, boxes, out_size, q, rtol, atol) -> bool:
    """K2 + K3 against the plain version: the value of sum(out^2) and its
    gradient with respect to the features."""
    from objgan_tpu_torch.ops import roi_align as ra

    def value_and_grad(fn):
        f = feats.detach().clone().requires_grad_(True)
        y = fn(f, boxes, out_size, q).float().pow(2).sum()
        (g,) = torch.autograd.grad(y, f)
        return float(y), g.float()

    yk, gk = value_and_grad(ra.RoiAlignFunction.apply)
    yp, gp = value_and_grad(ra.roi_align_reference)
    fwd_rel = abs(yk - yp) / max(abs(yp), 1e-12)
    diff = (gk - gp).abs()
    tol = atol + rtol * gp.abs()
    ok = fwd_rel <= max(rtol, 1e-5) and bool((diff <= tol).all())
    return _report(name, ok, f"fwd_rel={fwd_rel:.3e} grad_max_abs_diff="
                   f"{float(diff.max()):.3e} worst_over_tol="
                   f"{float((diff - tol).max()):.3e}")


def check_groupnorm(dtype: torch.dtype, use_glu: bool, device) -> bool:
    """K1 on (2, 128 * 128, 128), 16 groups, against the plain version
    (in fp64 for an fp32 input)."""
    from objgan_tpu_torch.ops import groupnorm as gn

    b, n, c, groups, eps = 2, 128 * 128, 128, 16, 1e-5
    gen = torch.Generator(device).manual_seed(1)
    x = (torch.randn(b, n, c, generator=gen, device=device) * 3 + 1)
    scale = torch.randn(c, generator=gen, device=device)
    bias = torch.randn(c, generator=gen, device=device)
    got = gn.GroupNormFunction.apply(x.to(dtype), scale, bias, groups, eps,
                                     use_glu).float()
    if dtype == torch.float32:
        want = gn.group_norm_reference(x.double(), scale.double(),
                                       bias.double(), groups, eps, use_glu)
        rtol = atol = 1e-5
    else:
        want = gn.group_norm_reference(x.to(dtype), scale, bias, groups,
                                       eps, use_glu)
        rtol = atol = 1e-2
    want = want.float()
    diff = (got - want).abs()
    tol = atol + rtol * want.abs()
    name = (f"groupnorm{'+glu' if use_glu else ''} "
            f"{'fp32' if dtype == torch.float32 else 'bf16'}")
    return _report(name, bool((diff <= tol).all()),
                   f"max_abs_diff={float(diff.max()):.3e} worst_over_tol="
                   f"{float((diff - tol).max()):.3e}")


# the launches of one run: each check launches its kernels once
LAUNCHES = {"K1": 4, "K2": 2, "K3": 2}


def run(argv=None) -> dict:
    """Every check at the shapes ``argv`` (this tool's options) gives, in
    this process, each printing its PASS or FAIL line: {"passed": n,
    "failed": n, "launches": the wrappers' launches meanwhile}. Raises
    RuntimeError without a CUDA device."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--c", type=int, default=256,
                    help="ROI-align channels (4 * DF_DIM on the train step)")
    ap.add_argument("--o", type=int, default=10, help="objects per image")
    ap.add_argument("--out_size", type=int, default=7)
    ap.add_argument("--q", type=int, default=2, help="sampling ratio")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; the kernels run only on a card, "
                           "and their plain versions against themselves "
                           "would prove nothing")
    from objgan_tpu_torch.core.precision import true_fp32
    from objgan_tpu_torch.ops import groupnorm, roi_align

    def counts():
        return (groupnorm.launches, roi_align.launches["fwd"],
                roi_align.launches["bwd"])

    true_fp32()
    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    before = counts()
    gen = torch.Generator(dev).manual_seed(0)
    b, h, w = 4, 16, 16
    feats = torch.randn(b, h, w, args.c, generator=gen, device=dev)
    xy = torch.rand(b, args.o, 2, generator=gen, device=dev) * 0.5
    distinct = torch.cat([xy, torch.full_like(xy, 0.4)], dim=-1)
    # every box over the same region: an o-way sum per feature gradient
    overlap = torch.tensor([0.1, 0.1, 0.8, 0.8], device=dev).expand(
        b, args.o, 4).contiguous()

    oks = [check_roi("roi fp32 distinct-boxes", feats, distinct,
                     args.out_size, args.q, rtol=1e-4, atol=1e-4),
           check_roi("roi bf16 overlapping-boxes (fp32 accum)",
                     feats.bfloat16(), overlap, args.out_size, args.q,
                     rtol=0.01, atol=0.05)]
    for use_glu in (False, True):
        for dtype in (torch.float32, torch.bfloat16):
            oks.append(check_groupnorm(dtype, use_glu, dev))
    torch.cuda.synchronize()
    launches = dict(zip(LAUNCHES, (a - b for a, b in zip(counts(),
                                                         before))))
    return {"passed": sum(oks), "failed": len(oks) - sum(oks),
            "launches": launches}


def checked(argv=None) -> dict:
    """``run``; raises RuntimeError unless every check passed and each
    launched its kernels once (``LAUNCHES``)."""
    r = run(argv)
    if r["failed"] or r["launches"] != LAUNCHES:
        raise RuntimeError(f"kernel_hw_check: {r['failed']} checks failed; "
                           f"launches {r['launches']}, not {LAUNCHES}")
    return r


def main(argv=None) -> int:
    try:
        r = run(argv)
    except RuntimeError as e:
        print(f"kernel_hw_check: {e}", file=sys.stderr)
        return 2
    n = r["launches"]
    print(f"launches: K1 {n['K1']}, K2 {n['K2']}, K3 {n['K3']}", flush=True)
    return 0 if not r["failed"] else 1


if __name__ == "__main__":
    sys.exit(main())
