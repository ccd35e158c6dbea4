"""Stage-A evaluation: held-out NLL and layout statistics of the box
generator. Port of ``objgan_tpu/utils/box_eval.py``.

* ``heldout_nll``: the teacher-forced label CE and box GMM NLL on held-out
  batches (no scheduled sampling);
* ``layout_stats``: layouts decoded for held-out captions (temperature
  sampling from injected noise, or beam search) against their ground
  truth: the label histograms' total-variation distance, greedy
  same-class matching by IoU (mean IoU over matches, match rate) and the
  mean object counts.

The trainer runs on its device; the statistics are numpy on the host.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.is_floating_point() else x).numpy()
    return np.asarray(x)


@torch.no_grad()
def heldout_nll(trainer, batches: Iterable[Dict]) -> Dict[str, float]:
    """Mean teacher-forced metrics over ``batches`` (on the trainer's
    device), as ``heldout_<name>``."""
    totals: Dict[str, List[float]] = {}
    for batch in batches:
        _, aux = trainer.loss(batch)
        for k, v in aux.items():
            totals.setdefault(k, []).append(float(v))
    if not totals:
        raise ValueError("no held-out batches")
    return {f"heldout_{k}": float(np.mean(v)) for k, v in totals.items()}


def label_histogram(labels, valid, num_classes: int) -> np.ndarray:
    """Normalised class histogram over valid objects; zeros if none."""
    lab = np.asarray(labels).reshape(-1).astype(np.int64)
    v = np.asarray(valid).reshape(-1) > 0
    counts = np.bincount(lab[v], minlength=num_classes).astype(np.float64)
    return counts / max(counts.sum(), 1.0)


def box_iou(a, b) -> float:
    """IoU of two (x0, y0, w, h) boxes in normalised coordinates."""
    ax0, ay0, aw, ah = [float(x) for x in a]
    bx0, by0, bw, bh = [float(x) for x in b]
    ix = max(0.0, min(ax0 + aw, bx0 + bw) - max(ax0, bx0))
    iy = max(0.0, min(ay0 + ah, by0 + bh) - max(ay0, by0))
    inter = ix * iy
    union = max(aw, 0.0) * max(ah, 0.0) + max(bw, 0.0) * max(bh, 0.0) - inter
    return inter / union if union > 0 else 0.0


def matched_label_iou(gt_labels, gt_boxes, gt_valid, sm_labels, sm_boxes,
                      sm_valid) -> Dict[str, float]:
    """Per image, each valid ground-truth object in order takes the
    unmatched valid sampled object of its class with the largest IoU.
    Returns the mean IoU over matches, the share of ground-truth objects
    matched and their count."""
    gt_labels, sm_labels = np.asarray(gt_labels), np.asarray(sm_labels)
    gt_boxes, sm_boxes = np.asarray(gt_boxes), np.asarray(sm_boxes)
    gt_valid, sm_valid = np.asarray(gt_valid), np.asarray(sm_valid)
    ious, n_gt, n_match = [], 0, 0
    for i in range(gt_labels.shape[0]):
        taken = np.zeros(sm_labels.shape[1], bool)
        for j in range(gt_labels.shape[1]):
            if gt_valid[i, j] <= 0:
                continue
            n_gt += 1
            best, best_k = -1.0, -1
            for k in range(sm_labels.shape[1]):
                if (taken[k] or sm_valid[i, k] <= 0
                        or int(sm_labels[i, k]) != int(gt_labels[i, j])):
                    continue
                iou = box_iou(gt_boxes[i, j], sm_boxes[i, k])
                if iou > best:
                    best, best_k = iou, k
            if best_k >= 0:
                taken[best_k] = True
                n_match += 1
                ious.append(best)
    return {
        "matched_iou": float(np.mean(ious)) if ious else 0.0,
        "match_rate": n_match / n_gt if n_gt else 0.0,
        "n_gt_objects": float(n_gt),
    }


def layout_stats(trainer, batches: Sequence[Dict], num_classes: int,
                 noises: Optional[Sequence[Dict]] = None,
                 use_beam: bool = False) -> Dict[str, float]:
    """Decode layouts for the held-out captions of ``batches`` (on the
    trainer's device) and score them against their ground truth. Batch i
    is sampled with ``noises[i]`` (``train/box.py::box_noise``); beam
    search takes none."""
    gt_hist = np.zeros(num_classes)
    sm_hist = np.zeros(num_classes)
    agg: Dict[str, List[float]] = {"matched_iou": [], "match_rate": []}
    counts: Dict[str, List[float]] = {"gt": [], "sampled": []}
    for i, batch in enumerate(batches):
        caps, lens = batch["captions"], batch["cap_lens"]
        out = (trainer.beam_sample(caps, lens) if use_beam
               else trainer.sample(caps, lens, noises[i]))
        sm_labels, sm_boxes, sm_valid = (_np(out["labels"]),
                                         _np(out["boxes"]),
                                         _np(out["obj_valid"]))
        labels, boxes, valid = (_np(batch["labels"]), _np(batch["boxes"]),
                                _np(batch["obj_valid"]))
        gt_hist += label_histogram(labels, valid, num_classes)
        sm_hist += label_histogram(sm_labels, sm_valid, num_classes)
        m = matched_label_iou(labels, boxes, valid, sm_labels, sm_boxes,
                              sm_valid)
        agg["matched_iou"].append(m["matched_iou"])
        agg["match_rate"].append(m["match_rate"])
        counts["gt"].append(float((valid > 0).sum(-1).mean()))
        counts["sampled"].append(float((sm_valid > 0).sum(-1).mean()))
    if not agg["matched_iou"]:
        raise ValueError("layout_stats got an empty batches iterable")
    n = len(agg["matched_iou"])
    gt_hist, sm_hist = gt_hist / n, sm_hist / n
    return {
        "matched_iou": float(np.mean(agg["matched_iou"])),
        "match_rate": float(np.mean(agg["match_rate"])),
        "label_tv_distance": 0.5 * float(np.abs(gt_hist - sm_hist).sum()),
        "mean_objects_gt": float(np.mean(counts["gt"])),
        "mean_objects_sampled": float(np.mean(counts["sampled"])),
    }
