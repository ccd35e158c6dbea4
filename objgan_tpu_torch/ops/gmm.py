"""Gaussian-mixture box distribution of the Stage-A decoder: parameter
splits, the log-density and its masked NLL (training), the mixture mean
(beam search) and temperature sampling from injected noise. Port of
``objgan_tpu/ops/gmm.py`` (both "diag" and "corr" covariance modes).

Layout of the last dim: [K logits | K*4 means | K*4 log_sigmas], and in
corr mode [... | K*2 rho_raw] with rho = 0.99 * tanh(rho_raw).

``sample`` takes its randomness as tensors: a Gumbel draw for the mixture
component and a standard-normal draw for the box, so that a test can hand
it exactly the draws JAX made (``jax.random.categorical(k, l)`` is
``argmax(l + gumbel(k, l.shape))``).
"""

from __future__ import annotations

from typing import Optional

import torch

from objgan_tpu_torch.parallel.sharding import masked_mean_share

BOX_DIM = 4
_LOG_2PI = 1.8378770664093453  # log(2 pi)
_PAIRS = ((0, 1), (2, 3))  # correlated (x, y) and (w, h) blocks
_RHO_MAX = 0.99
_MODES = ("diag", "corr")


def _check_mode(mode: str) -> None:
    if mode not in _MODES:
        raise ValueError(f"unknown GMM mode {mode!r} (known: {_MODES})")


def param_size(num_components: int, mode: str = "diag") -> int:
    _check_mode(mode)
    per = 1 + 2 * BOX_DIM + (len(_PAIRS) if mode == "corr" else 0)
    return num_components * per


def split_params(params: torch.Tensor, num_components: int):
    """(..., K*9) -> (logits (..., K), mu (..., K, 4),
    log_sigma (..., K, 4))."""
    k = num_components
    lead = params.shape[:-1]
    logits = params[..., :k]
    mu = params[..., k:k + k * BOX_DIM].reshape(*lead, k, BOX_DIM)
    log_sigma = params[..., k + k * BOX_DIM:].reshape(*lead, k, BOX_DIM)
    return logits, mu, torch.clamp(log_sigma, -7.0, 7.0)


def split_params_corr(params: torch.Tensor, num_components: int):
    """corr layout -> (logits, mu, log_sigma, rho (..., K, 2))."""
    k = num_components
    diag_sz = k * (1 + 2 * BOX_DIM)
    logits, mu, log_sigma = split_params(params[..., :diag_sz], k)
    rho_raw = params[..., diag_sz:].reshape(*params.shape[:-1], k,
                                            len(_PAIRS))
    return logits, mu, log_sigma, _RHO_MAX * torch.tanh(rho_raw)


def _split(params: torch.Tensor, num_components: int, mode: str):
    """(logits, mu, log_sigma, rho or None) of either layout."""
    _check_mode(mode)
    if mode == "corr":
        return split_params_corr(params, num_components)
    return (*split_params(params, num_components), None)


def _comp_ll_corr(z: torch.Tensor, log_sigma: torch.Tensor,
                  rho: torch.Tensor) -> torch.Tensor:
    """Per-component log-density from standardised residuals z (..., K, 4)
    with the block-diagonal correlations rho (..., K, 2)."""
    ll = 0.0
    for p, (i, j) in enumerate(_PAIRS):
        zi, zj, r = z[..., i], z[..., j], rho[..., p]
        one_m_r2 = 1.0 - r * r
        q = (zi * zi - 2.0 * r * zi * zj + zj * zj) / one_m_r2
        ll = (ll - 0.5 * q - _LOG_2PI - 0.5 * torch.log(one_m_r2)
              - log_sigma[..., i] - log_sigma[..., j])
    return ll


def log_prob(params: torch.Tensor, box: torch.Tensor, num_components: int,
             mode: str = "diag") -> torch.Tensor:
    """log p(box | params): box (..., 4) -> (...,)."""
    logits, mu, log_sigma, rho = _split(params, num_components, mode)
    log_mix = torch.log_softmax(logits, dim=-1)
    z = (box[..., None, :] - mu) * torch.exp(-log_sigma)  # (..., K, 4)
    if rho is not None:
        comp_ll = _comp_ll_corr(z, log_sigma, rho)
    else:
        comp_ll = (-0.5 * (z * z + _LOG_2PI).sum(-1)
                   - log_sigma.sum(-1))
    return torch.logsumexp(log_mix + comp_ll, dim=-1)


def nll(params: torch.Tensor, box: torch.Tensor, num_components: int,
        valid: Optional[torch.Tensor] = None,
        mode: str = "diag") -> torch.Tensor:
    """Mean negative log-likelihood, over the steps where ``valid`` is set
    when it is given: then over the global batch (a rank's share under data
    parallelism, ``parallel/sharding.py``)."""
    ll = log_prob(params, box, num_components, mode=mode)
    if valid is None:
        return -ll.mean()
    valid = valid.to(ll.dtype)
    return -masked_mean_share((ll * valid).sum(), valid.sum())


def mean(params: torch.Tensor, num_components: int,
         mode: str = "diag") -> torch.Tensor:
    """The mixture mean (..., 4): beam search's deterministic box."""
    logits, mu, _, _ = _split(params, num_components, mode)
    w = torch.softmax(logits, dim=-1)
    return (mu * w[..., None]).sum(-2)


def sample(params: torch.Tensor, comp_gumbel: torch.Tensor,
           eps: torch.Tensor, num_components: int, temperature: float = 1.0,
           mode: str = "diag") -> torch.Tensor:
    """Temperature sample a box (..., 4). comp_gumbel (..., K) picks the
    component as argmax(logits / T + gumbel); eps (..., 4) is N(0, 1).
    Temperature scales the logits (1/T) and the sigmas (sqrt(T))."""
    logits, mu, log_sigma, rho = _split(params, num_components, mode)
    # a CPU scalar tensor: an operand of the device ops without a copy to
    # the device (which would wait for the stream)
    t = torch.tensor(temperature, dtype=logits.dtype)
    comp = torch.argmax(comp_gumbel + logits / torch.clamp(t, min=1e-6),
                        dim=-1)
    # gather picks the component's entries exactly (the one-hot sum of the
    # JAX package); one_hot would check its input on the host, a sync

    def pick(v):
        idx = comp[..., None, None].expand(*comp.shape, 1, v.shape[-1])
        return v.gather(-2, idx).squeeze(-2)

    sel_mu = pick(mu)
    sel_sigma = pick(torch.exp(log_sigma))
    if rho is not None:
        sel_rho = pick(rho)
        cols = []
        for p, (i, j) in enumerate(_PAIRS):
            r = sel_rho[..., p]
            cols.append(eps[..., i])
            cols.append(r * eps[..., i]
                        + torch.sqrt(1.0 - r * r) * eps[..., j])
        eps = torch.stack(cols, dim=-1)
    return sel_mu + sel_sigma * torch.sqrt(t) * eps
