"""Skewed keys: a Zipf draw reduced modulo a key space, made on the device.

BASELINE.json config 5's probe keys are ``zipf(s) % modulus`` (s = 1.3,
modulus 4096: numpy's ``Generator.zipf``, as
``scripts/torch_baseline_configs.py`` ``config5_probe`` draws them on the
host).  Here each key is drawn by inversion of the exact law of that
residue, so a row costs one uniform draw on the device and no row is made
on the host:

    P(key = r) = sum over x >= 1 with x = r (mod M) of x^-s / zeta(s)
               = M^-s zeta(s, q_r) / zeta(s),   q_0 = 1, q_r = r / M,

with ``zeta(s, q)`` Hurwitz's zeta function.  (numpy's sampler rejects
draws past 2^63, a share of about 2e-6 at s = 1.3 spread over every
residue; this law keeps them.)  Key 1 takes 1 / zeta(1.3) of the rows,
about 25.4%.

Rank ``r`` of a mesh draws its rows from its own stream of the run's seed,
so every rank makes its shard on its own card, and any rank can make the
whole table again (:func:`global_keys`) from the seed alone.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import seeds

# Bernoulli numbers B_2, B_4, ..., B_14 for the Euler-Maclaurin remainder
_B2K = (1 / 6, -1 / 30, 1 / 42, -1 / 30, 5 / 66, -691 / 2730, 7 / 6)


def hurwitz_zeta(s: float, q, terms: int = 16) -> np.ndarray:
    """zeta(s, q) = sum over n >= 0 of (q + n)^-s, for s > 1 and q > 0:
    ``terms`` terms summed, the rest by Euler-Maclaurin (error far below
    float64's rounding for q >= 1e-4 and s near 1)."""
    q = np.asarray(q, dtype=np.float64)
    total = sum((q + n) ** -s for n in range(terms))
    a = q + terms
    total = total + a ** (1 - s) / (s - 1) + a ** -s / 2
    rising = s  # s (s + 1) ... (s + 2k - 2)
    for k, b in enumerate(_B2K, start=1):
        total = total + b / math.factorial(2 * k) * rising * a ** (
            -s - 2 * k + 1)
        rising *= (s + 2 * k - 1) * (s + 2 * k)
    return total


def residue_pmf(s: float, modulus: int) -> np.ndarray:
    """P(zipf(s) % modulus = r) for r in [0, modulus), float64."""
    q = np.arange(modulus, dtype=np.float64) / modulus
    q[0] = 1.0
    w = hurwitz_zeta(s, q)
    return w / w.sum()


def _cdf(s: float, modulus: int, device) -> torch.Tensor:
    cdf = np.cumsum(residue_pmf(s, modulus))
    cdf[-1] = 1.0  # a uniform draw in [0, 1) never passes the last key
    return torch.tensor(cdf, dtype=torch.float32, device=device)


def keys(n: int, s: float, modulus: int, seed: int, rank: int,
         device, out: torch.Tensor | None = None) -> torch.Tensor:
    """Rank ``rank``'s ``n`` keys as uint32 on ``device``, the same for the
    same seed and rank; written into ``out`` (int32, ``n`` rows) if
    given."""
    gen = seeds.generator(device, seed, "zipf", rank)
    u = torch.rand(n, generator=gen, dtype=torch.float32, device=device)
    cdf = _cdf(s, modulus, device)
    if out is None:
        out = torch.empty(n, dtype=torch.int32, device=device)
    torch.searchsorted(cdf, u, right=True, out_int32=True, out=out)
    return out.view(torch.uint32)


def global_keys(n_per_rank: int, ranks: int, s: float, modulus: int,
                seed: int, device) -> torch.Tensor:
    """Every rank's keys in rank order (``ranks * n_per_rank`` uint32 on
    ``device``), each rank's made as :func:`keys` makes them."""
    out = torch.empty(ranks * n_per_rank, dtype=torch.int32, device=device)
    for r in range(ranks):
        keys(n_per_rank, s, modulus, seed, r, device,
             out=out[r * n_per_rank:(r + 1) * n_per_rank])
    return out.view(torch.uint32)
