"""Gaussian-mixture box distribution of the Stage-A decoder: parameter
splits and temperature sampling from injected noise. Port of
``objgan_tpu/ops/gmm.py`` (both "diag" and "corr" covariance modes).

Layout of the last dim: [K logits | K*4 means | K*4 log_sigmas], and in
corr mode [... | K*2 rho_raw] with rho = 0.99 * tanh(rho_raw).

``sample`` takes its randomness as tensors: a Gumbel draw for the mixture
component and a standard-normal draw for the box, so that a test can hand
it exactly the draws JAX made (``jax.random.categorical(k, l)`` is
``argmax(l + gumbel(k, l.shape))``).
"""

from __future__ import annotations

import torch

BOX_DIM = 4
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


def sample(params: torch.Tensor, comp_gumbel: torch.Tensor,
           eps: torch.Tensor, num_components: int, temperature: float = 1.0,
           mode: str = "diag") -> torch.Tensor:
    """Temperature sample a box (..., 4). comp_gumbel (..., K) picks the
    component as argmax(logits / T + gumbel); eps (..., 4) is N(0, 1).
    Temperature scales the logits (1/T) and the sigmas (sqrt(T))."""
    _check_mode(mode)
    if mode == "corr":
        logits, mu, log_sigma, rho = split_params_corr(params,
                                                       num_components)
    else:
        logits, mu, log_sigma = split_params(params, num_components)
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
    if mode == "corr":
        sel_rho = pick(rho)
        cols = []
        for p, (i, j) in enumerate(_PAIRS):
            r = sel_rho[..., p]
            cols.append(eps[..., i])
            cols.append(r * eps[..., i]
                        + torch.sqrt(1.0 - r * r) * eps[..., j])
        eps = torch.stack(cols, dim=-1)
    return sel_mu + sel_sigma * torch.sqrt(t) * eps
