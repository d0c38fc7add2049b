"""Log-density functions of the PERT model (port of ``ops/dists.py``).

Parameterisations follow torch.distributions, as the JAX module does:
``NegativeBinomial(total_count=delta, probs=lamb)`` counts successes
before ``delta`` failures (mean = delta * lamb / (1 - lamb));
``Gamma(concentration, rate)``.
"""

from __future__ import annotations

import math

import torch

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def nb_log_prob(k, total_count, log_lamb, log1m_lamb):
    """log NB(k | delta, lamb) = lgamma(k+delta) - lgamma(delta)
    - lgamma(k+1) + delta*log(1-lamb) + k*log(lamb)."""
    return (
        torch.lgamma(k + total_count)
        - torch.lgamma(total_count)
        - torch.lgamma(k + 1.0)
        + total_count * log1m_lamb
        + k * log_lamb
    )


def gamma_log_prob(x, concentration, rate):
    return (
        concentration * math.log(rate)
        - math.lgamma(concentration)
        + (concentration - 1.0) * torch.log(x)
        - rate * x
    )


def normal_log_prob(x, loc, scale):
    z = (x - loc) / scale
    scale = torch.as_tensor(scale, dtype=x.dtype, device=x.device)
    return -0.5 * z * z - torch.log(scale) - _HALF_LOG_2PI


def beta_log_prob(x, alpha, beta):
    alpha = torch.as_tensor(alpha, dtype=x.dtype, device=x.device)
    beta = torch.as_tensor(beta, dtype=x.dtype, device=x.device)
    return (
        torch.xlogy(alpha - 1.0, x)
        + torch.xlogy(beta - 1.0, 1.0 - x)
        + torch.lgamma(alpha + beta)
        - torch.lgamma(alpha)
        - torch.lgamma(beta)
    )


def bernoulli_log_prob(x, p):
    """Bernoulli log pmf for x in {0., 1.} with probability p."""
    return torch.xlogy(x, p) + torch.xlogy(1.0 - x, 1.0 - p)
