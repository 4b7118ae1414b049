"""Score-based diffusion SE (SGMSE) on the conditional BSRNN (counterpart of
``models/sgmse.py``).

The OUVE SDE (Ornstein-Uhlenbeck variance exploding, the published SGMSE
recipe):

  drift      f(x, t) = theta (y - x)
  diffusion  g(t)    = sigma_min (sigma_max / sigma_min)^t
                       sqrt(2 log(sigma_max / sigma_min))
  mean_t  = exp(-theta t) x0 + (1 - exp(-theta t)) y
  std_t^2 = sigma_min^2 ((sigma_max / sigma_min)^(2t) - exp(-2 theta t))
            log(sigma_max / sigma_min) / (theta + log(sigma_max / sigma_min))

The score network is the flow family's ``FlowDNN`` at n_fft 1536 / hop 384
(score = -dnn(x, y, t)); ``sgmse_loss`` is the likelihood-weighted
denoising score-matching loss, ``sgmse_enhance`` the predictor-corrector
sampler (annealed Langevin corrections, then one reverse-diffusion
prediction per step over ``linspace(T, t_eps, N)``).  The JAX sampler is
one ``lax.scan``; here it is a Python loop over the N steps.

Random draws come from an explicit ``torch.Generator``: ``sgmse_loss``
draws t, then z; ``sgmse_enhance`` draws the prior z, then per step the
corrector noises and the predictor noise.  Each function also takes its
draws injected, so that tests feed both packages the same numbers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

from urgent2026_challenge_track1_tpu_torch import resolve_device
from urgent2026_challenge_track1_tpu_torch.dsp import stft as dsp
from urgent2026_challenge_track1_tpu_torch.models import bsrnn as B
from urgent2026_challenge_track1_tpu_torch.models import bsrnn_flowse as FM
from urgent2026_challenge_track1_tpu_torch.models.odes import complex_normal_like

__all__ = ["OUVESDE", "SGMSEConfig", "init_sgmse", "score_fn", "sgmse_loss", "sgmse_enhance"]


def _bcast(t: torch.Tensor, ndim: int) -> torch.Tensor:
    return t.reshape(t.shape + (1,) * (ndim - 1))


@dataclasses.dataclass(frozen=True)
class OUVESDE:
    """Ornstein-Uhlenbeck variance-exploding SDE; ``t`` is a tensor."""

    theta: float = 1.5
    sigma_min: float = 0.05
    sigma_max: float = 0.5
    N: int = 1000
    T: float = 1.0

    @property
    def _logsig(self) -> float:
        return math.log(self.sigma_max / self.sigma_min)

    def diffusion(self, t):
        return (self.sigma_min * (self.sigma_max / self.sigma_min) ** t
                * math.sqrt(2.0 * self._logsig))

    def drift(self, x, t, y):
        return self.theta * (y - x)

    def mean(self, x0, t, y):
        e = _bcast(torch.exp(-self.theta * t), x0.ndim)
        return e * x0 + (1.0 - e) * y

    def std(self, t):
        ls = self._logsig
        var = (self.sigma_min ** 2
               * ((self.sigma_max / self.sigma_min) ** (2 * t) - torch.exp(-2 * self.theta * t))
               * ls / (self.theta + ls))
        return torch.sqrt(torch.clamp(var, min=0.0))

    def marginal_prob(self, x0, t, y):
        return self.mean(x0, t, y), self.std(t)

    def prior_sampling(self, y, generator: Optional[torch.Generator] = None,
                       z: Optional[torch.Tensor] = None):
        """x_T = y + std(T) z.  Returns (x_T, z); ``z`` replaces the draw."""
        z = complex_normal_like(y, generator) if z is None else z
        std = self.std(torch.full((y.shape[0],), self.T, dtype=torch.float32, device=y.device))
        return y + _bcast(std, y.ndim) * z, z


@dataclasses.dataclass(frozen=True)
class SGMSEConfig:
    n_fft: int = 1536
    hop_length: int = 384
    spec_abs_exponent: float = 0.667
    spec_factor: float = 0.065
    bsrnn_hidden: int = 196
    num_layer: int = 6
    theta: float = 1.5
    sigma_min: float = 0.05
    sigma_max: float = 0.5
    t_eps: float = 3e-2
    likelihood_weighting: bool = True
    compute_dtype: str = "float32"  # the recurrences' products, as FlowSEConfig's

    @property
    def stft_cfg(self) -> dsp.STFTConfig:
        return dsp.STFTConfig(n_fft=self.n_fft, hop_length=self.hop_length,
                              spec_transform_type="exponent",
                              spec_abs_exponent=self.spec_abs_exponent,
                              spec_factor=self.spec_factor)

    @property
    def flow_cfg(self) -> FM.FlowSEConfig:
        """The flow config whose network is the score network."""
        return FM.FlowSEConfig(n_fft=self.n_fft, hop_length=self.hop_length,
                               bsrnn_hidden=self.bsrnn_hidden, num_layer=self.num_layer,
                               compute_dtype=self.compute_dtype)

    @property
    def dnn_cfg(self) -> B.BSRNNConfig:
        return self.flow_cfg.dnn_cfg

    @property
    def sde(self) -> OUVESDE:
        return OUVESDE(self.theta, self.sigma_min, self.sigma_max)


def init_sgmse(cfg: SGMSEConfig, seed: int = 0, device="cuda") -> FM.FlowDNN:
    """A randomly initialised score network (``init_flowse`` at this width)
    on the card, or on the CPU where the caller asks for it; ``score_fn``,
    ``sgmse_loss`` and ``sgmse_enhance`` run where the network is."""
    return FM.init_flowse(cfg.flow_cfg, seed=seed, device=resolve_device(device))


def score_fn(model: FM.FlowDNN, cfg: SGMSEConfig, x, t, y, fs: int) -> torch.Tensor:
    """score = -dnn(x, y, t)."""
    return -model(x, y, t, fs)


def sgmse_loss(model: FM.FlowDNN, cfg: SGMSEConfig, clean: torch.Tensor, noisy: torch.Tensor,
               fs: int, t: Optional[torch.Tensor] = None, z: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The denoising score-matching loss of (B, T) waveforms: with
    ``likelihood_weighting`` 0.5 * mean |score + z / std|^2 weighted by
    g(t)^2, else 0.5 * mean |score std + z|^2, each mean over (T, F), then
    over the batch.  ``t`` (B,) and ``z`` (B, T, F) complex replace the draws
    from ``generator`` (t, uniform in [t_eps, T), first, then z)."""
    stft_cfg = cfg.stft_cfg
    x0 = dsp.stft_encode(clean, fs, stft_cfg)
    y = dsp.stft_encode(noisy, fs, stft_cfg)
    sde = cfg.sde
    Bsz = x0.shape[0]
    if t is None:
        dev = generator.device if generator is not None else x0.device
        u = torch.rand((Bsz,), generator=generator, device=dev).to(x0.device)
        t = u * (sde.T - cfg.t_eps) + cfg.t_eps
    mean, std = sde.marginal_prob(x0, t, y)
    z = complex_normal_like(x0, generator) if z is None else z
    sigmas = _bcast(std, x0.ndim)
    xt = mean + sigmas * z
    score = score_fn(model, cfg, xt, t, y, fs)
    if cfg.likelihood_weighting:
        g2 = sde.diffusion(t) ** 2
        losses = (score + z / sigmas).abs().square()
        return (0.5 * losses.reshape(Bsz, -1).mean(dim=-1) * g2).mean()
    losses = (score * sigmas + z).abs().square()
    return (0.5 * losses.reshape(Bsz, -1).mean(dim=-1)).mean()


def _flat_norm(v: torch.Tensor) -> torch.Tensor:
    """The per-item L2 norm over the non-batch axes, then the batch mean (a
    whole-batch norm would couple the Langevin step across utterances)."""
    return v.reshape(v.shape[0], -1).abs().square().sum(dim=-1).sqrt().mean()


@torch.no_grad()
def sgmse_enhance(model: FM.FlowDNN, cfg: SGMSEConfig, noisy: torch.Tensor, fs: int,
                  N: int = 50, snr: float = 0.3, corrector_steps: int = 1,
                  generator: Optional[torch.Generator] = None,
                  prior_z: Optional[torch.Tensor] = None,
                  noises: Optional[Sequence[Sequence[torch.Tensor]]] = None) -> torch.Tensor:
    """Predictor-corrector reverse sampling, (B, T) -> (B, T).

    ``prior_z`` (B, T, F) complex replaces the prior draw, and ``noises[i]``
    the draws of step i: ``corrector_steps`` corrector noises, then the
    predictor's noise."""
    stft_cfg = cfg.stft_cfg
    y = dsp.stft_encode(noisy, fs, stft_cfg)
    sde = cfg.sde
    Bsz = y.shape[0]
    x, _ = sde.prior_sampling(y, generator, prior_z)
    ts = torch.linspace(sde.T, cfg.t_eps, N, dtype=torch.float32)
    dt = -(sde.T - cfg.t_eps) / (N - 1)

    def draw(i, k):
        return complex_normal_like(x, generator) if noises is None else noises[i][k]

    for i in range(N):
        t = ts[i].to(y.device)
        vec_t = t.expand(Bsz)
        for k in range(corrector_steps):  # annealed Langevin dynamics
            grad = score_fn(model, cfg, x, vec_t, y, fs)
            noise = draw(i, k)
            eps = 2.0 * (snr * _flat_norm(noise) / torch.clamp(_flat_norm(grad), min=1e-12)) ** 2
            x = x + eps * grad + torch.sqrt(2.0 * eps) * noise
        g = sde.diffusion(t)  # reverse-diffusion predictor
        score = score_fn(model, cfg, x, vec_t, y, fs)
        drift = sde.drift(x, vec_t, y) - g ** 2 * score
        x = x + drift * dt + g * math.sqrt(-dt) * draw(i, corrector_steps)
    return dsp.stft_decode(x, fs, stft_cfg, length=noisy.shape[-1])
