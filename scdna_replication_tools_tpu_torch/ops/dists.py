"""Log-density functions of the PERT model (port of ``ops/dists.py``).

Parameterisations follow torch.distributions, as the JAX module does:
``NegativeBinomial(total_count=delta, probs=lamb)`` counts successes
before ``delta`` failures (mean = delta * lamb / (1 - lamb));
``Gamma(concentration, rate)``.

A Python-number argument becomes a float32 device scalar through
``torch.full`` (a fill on the device), never ``torch.as_tensor`` (a
blocking host-to-device copy inside every fit iteration).
"""

from __future__ import annotations

import math

import torch

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def _scalar_like(v, x: torch.Tensor) -> torch.Tensor:
    """``v`` as a tensor of ``x``'s dtype on its device, with no host
    copy."""
    if torch.is_tensor(v):
        return v.to(dtype=x.dtype, device=x.device)
    return torch.full((), float(v), dtype=x.dtype, device=x.device)


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
    scale = _scalar_like(scale, x)
    return -0.5 * z * z - torch.log(scale) - _HALF_LOG_2PI


def beta_log_prob(x, alpha, beta):
    alpha = _scalar_like(alpha, x)
    beta = _scalar_like(beta, x)
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


def nb_sample(total_count: torch.Tensor, lamb: torch.Tensor, num: int,
              generator: torch.Generator) -> torch.Tensor:
    """``num`` independent draws of NB(total_count, probs=lamb), stacked
    on a new leading axis: the Gamma-Poisson mixture y ~
    Poisson(Gamma(total_count, 1) * lamb / (1 - lamb)), whose mean is
    total_count * lamb / (1 - lamb).  float32, drawn on ``generator``
    (which lies on total_count's device)."""
    conc = total_count.expand((num,) + tuple(total_count.shape))
    rate = torch._standard_gamma(conc.contiguous(), generator=generator) \
        * (lamb / (1.0 - lamb))
    return torch.poisson(rate, generator=generator).to(torch.float32)


def seed_of(seed: int, salt: int) -> int:
    """The generator seed of the pair ``(seed, salt)``."""
    return (int(seed) * 1_000_003 + int(salt)) % (1 << 63)


def seeded_generator(seed: int, salt: int, device) -> torch.Generator:
    """A generator on ``device`` seeded by the pair ``(seed, salt)``:
    the port's counterpart of ``fold_in(PRNGKey(seed), salt)`` (its own
    stream; JAX's draws are not reproduced)."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(seed_of(seed, salt))
    return gen
