"""Flow-matching ODE path (counterpart of ``models/odes.py``).

Functions over complex spectra (B, T, F); ``t`` is a per-batch vector (B,).

  mean_t    = (1-t) x0 + t y
  std_t     = (1-t) sigma_min + t sigma_max
  prior x_T = y + sigma_max * z,  z complex standard normal (re/im each
              N(0, 1/2))
  der_mean  = y - x0
  der_std   = sigma_max - sigma_min

Random draws come from an explicit ``torch.Generator``; they differ from
JAX's for the same seed, so tests hand both packages the same noise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from urgent2026_challenge_track1_tpu_torch import tracing

__all__ = ["FlowMatching", "complex_normal", "complex_normal_like"]


def complex_normal(shape, device, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Complex normal of ``shape`` with unit complex variance, drawn on the
    generator's device and moved to ``device``."""
    dev = generator.device if generator is not None else device
    re = torch.randn(shape, generator=generator, device=dev)
    im = torch.randn(shape, generator=generator, device=dev)
    return (torch.complex(re, im) * 0.5 ** 0.5).to(device)


def complex_normal_like(x: torch.Tensor, generator: Optional[torch.Generator] = None,
                        rows=None) -> torch.Tensor:
    """Complex normal of x's shape (``complex_normal``).  ``rows`` (n,
    slice): x is that slice of an n-row batch; the draw is the n rows',
    cut to the slice."""
    if rows is None:
        return complex_normal(x.shape, x.device, generator)
    n, sl = rows
    return complex_normal((n,) + tuple(x.shape[1:]), x.device, generator)[sl]


def _bcast(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """(B,) -> (B, 1, ..., 1) to broadcast against (B, T, F)."""
    return t.reshape(t.shape + (1,) * (ndim - 1))


@dataclasses.dataclass(frozen=True)
class FlowMatching:
    sigma_min: float = 0.0
    sigma_max: float = 0.5
    T_rev: float = 1.0

    def mean(self, x0, t, y):
        tb = _bcast(t, x0.ndim)
        return (1.0 - tb) * x0 + tb * y

    def std(self, t):
        return (1.0 - t) * self.sigma_min + t * self.sigma_max

    def marginal_prob(self, x0, t, y):
        return self.mean(x0, t, y), self.std(t)

    @tracing.spanned(tracing.FLOW_PRIOR)
    def prior_sampling(self, y, generator: Optional[torch.Generator] = None, rows=None):
        """x_T = y + sigma_max * z.  Returns (x_T, z).  ``rows``: see
        ``complex_normal_like``."""
        z = complex_normal_like(y, generator, rows)
        std = self.std(torch.ones((y.shape[0],), device=y.device))
        return y + z * _bcast(std, y.ndim), z

    def der_mean(self, x0, t, y):
        return y - x0

    def der_std(self, t):
        return torch.full_like(t, self.sigma_max - self.sigma_min)
