"""Conditional BSRNN vector-field network and the FlowSE model (counterpart of
``models/bsrnn_flowse.py``).

  x_t, y (B, T, F) complex, t (B,)
    -> BandSplit(x_t) || BandSplit_y(y) -> condition_fc -> (B, T, K, N)
    -> num_layer x DualPathLayer with the Gaussian-Fourier t-embedding
    -> GradDecoder x 2: per-band GroupNorm, 1x1 projection and tanh, then a
       shared 5x5 conv + GLU over (frequency, time) -> complex (mask, residual)
    -> g = mask * x_t + residual;  vector field = -g

Specs stay (B, T, F) complex end to end, as in the JAX package; parameters
keep its band-stacked layout (``utils/params.py`` bridges the two).  The
GradDecoder and the condition projection compute in float32 in both
compute dtypes, as the JAX package does; the 5x5 conv goes to
``F.conv2d`` (the JAX package leaves it to XLA).  On the card cuDNN would
run that float32 conv in TF32, so the conv alone runs under
``torch.backends.cudnn.flags(allow_tf32=False)``.

Random draws (the CFM noise and t, the sampler's prior) come from an
explicit ``torch.Generator``; ``flowse_loss`` takes ``noise``/``t`` and
``flowse_enhance`` a prior ``x0`` instead, so that tests can feed both
packages the same numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from urgent2026_challenge_track1_tpu_torch import resolve_device, tracing
from urgent2026_challenge_track1_tpu_torch.dsp import stft as dsp
from urgent2026_challenge_track1_tpu_torch.models import bsrnn as B
from urgent2026_challenge_track1_tpu_torch.models.odes import (
    FlowMatching, complex_normal, complex_normal_like)
from urgent2026_challenge_track1_tpu_torch.sampling import sample_flow
from urgent2026_challenge_track1_tpu_torch.train.losses import frame_mask

__all__ = [
    "FlowSEConfig",
    "GradDecoderHead",
    "FlowDNN",
    "init_flowse",
    "vector_field",
    "draw_t",
    "cfm_draws",
    "flowse_loss",
    "flowse_enhance",
]


@dataclasses.dataclass(frozen=True)
class FlowSEConfig:
    """conf/models/BSRNN_flowse.yaml defaults."""

    n_fft: int = 1536
    hop_length: int = 384
    spec_abs_exponent: float = 0.667
    spec_factor: float = 0.065
    bsrnn_hidden: int = 384
    num_layer: int = 6
    sigma_min: float = 0.05
    sigma_max: float = 0.5
    t_eps: float = 0.03
    T_rev: float = 1.0
    loss_type: str = "mse"  # "mse" | "mae"
    sub_channel: int = 16
    compute_dtype: str = "float32"

    @property
    def stft_cfg(self) -> dsp.STFTConfig:
        return dsp.STFTConfig(n_fft=self.n_fft, hop_length=self.hop_length,
                              spec_transform_type="exponent",
                              spec_abs_exponent=self.spec_abs_exponent,
                              spec_factor=self.spec_factor)

    @property
    def dnn_cfg(self) -> B.BSRNNConfig:
        return B.BSRNNConfig(input_dim=self.n_fft // 2 + 1, num_channel=self.bsrnn_hidden,
                             num_layer=self.num_layer, with_condition=True,
                             sub_channel=self.sub_channel, compute_dtype=self.compute_dtype)

    @property
    def ode(self) -> FlowMatching:
        return FlowMatching(self.sigma_min, self.sigma_max, self.T_rev)


# ---------------------------------------------------------------------------
# GradDecoder
# ---------------------------------------------------------------------------


class GradDecoderHead(nn.Module):
    """One head (mask or residual), (B, T, K, N) -> (B, T, n_bins) complex:
    per band GroupNorm(1, C) over (C, T), a 1x1 projection C -> sc x sub and
    tanh; the bands' rows concatenated along frequency; Conv2d(sc -> 4, 5x5,
    padding 2) over (frequency, time) and GLU.  ``conv_w`` is HWIO (5, 5,
    sc, 4), the JAX layout."""

    def __init__(self, cfg: B.BSRNNConfig):
        super().__init__()
        self.cfg = cfg
        K, C, sc, SM = len(cfg.subbands), cfg.num_channel, cfg.sub_channel, cfg.max_sub
        self.norm_scale = nn.Parameter(torch.ones(K, C))
        self.norm_bias = B._zeros(K, C)
        self.w = B._zeros(K, C, sc, SM)
        self.b = B._zeros(K, sc, SM)
        self.conv_w = B._zeros(5, 5, sc, 4)
        self.conv_b = B._zeros(4)

    @tracing.spanned(tracing.MODEL_DECODER)
    def forward(self, z: torch.Tensor, n_bands: int, n_bins: int,
                fm: Optional[torch.Tensor] = None) -> torch.Tensor:
        Bb, T, K, N = z.shape
        cfg = self.cfg
        sc, SM = cfg.sub_channel, cfg.max_sub
        # every row of the K bands, the last band's overhang past n_bins
        # included: the conv sees it before the output is cut to n_bins
        flat_full = torch.from_numpy(np.concatenate(
            [np.arange(s) + i * SM for i, s in enumerate(cfg.subbands[:n_bands])])).to(z.device)
        if fm is None:
            mean = z.mean(dim=(1, 3), keepdim=True)
            var = (z - mean).square().mean(dim=(1, 3), keepdim=True)
        else:
            m4 = fm[:, :, None, None]
            denom = m4.sum(dim=1, keepdim=True) * N
            mean = (z * m4).sum(dim=(1, 3), keepdim=True) / denom
            var = ((z - mean).square() * m4).sum(dim=(1, 3), keepdim=True) / denom
        h = (z - mean) / torch.sqrt(var + cfg.norm_eps)
        h = h * self.norm_scale[:n_bands][None, None] + self.norm_bias[:n_bands][None, None]
        h = torch.tanh(torch.einsum("btkc,kcsm->btksm", h, self.w[:n_bands])
                       + self.b[:n_bands][None, None])  # (B, T, K, sc, SM)
        if fm is not None:
            # zeroed padded frames: the conv's +-2-frame window sees what an
            # exact-length conv padding would
            h = h * fm[:, :, None, None, None]
        flat = h.permute(0, 1, 3, 2, 4).reshape(Bb, T, sc, K * SM)[..., flat_full]
        img = flat.permute(0, 2, 3, 1)  # (B, sc, F_total, T): NCHW, H = F, W = T
        cudnn = torch.backends.cudnn
        # a float32 conv, as in JAX: no TF32 for this call, the other flags kept
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            out = nn.functional.conv2d(img, self.conv_w.permute(3, 2, 0, 1), self.conv_b,
                                       padding=2)  # (B, 4, F_total, T)
        out = out[:, :2] * torch.sigmoid(out[:, 2:])  # GLU over the channels
        cplx = torch.complex(out[:, 0], out[:, 1])  # (B, F_total, T)
        return cplx[:, :n_bins].transpose(1, 2)


# ---------------------------------------------------------------------------
# Vector-field network
# ---------------------------------------------------------------------------


class FlowDNN(nn.Module):
    """The conditional BSRNN: ``forward(x_spec, y_spec, t, fs, frames=None)``
    returns g = m * x_spec + r for (B, T, F) complex spectra at rate fs and
    the flow time t (B,)."""

    def __init__(self, cfg: B.BSRNNConfig):
        super().__init__()
        if not cfg.with_condition:
            raise ValueError("FlowDNN needs a BSRNNConfig with with_condition=True")
        self.cfg = cfg
        N = cfg.num_channel
        self.band_split = B.BandSplit(cfg)
        self.band_split_y = B.BandSplit(cfg)
        self.condition_fc_w = B._zeros(2 * N, N)
        self.condition_fc_b = B._zeros(N)
        self.layers = nn.ModuleList(B.DualPathLayer(cfg) for _ in range(cfg.num_layer))
        self.grad_decoder = nn.ModuleDict(
            {"mask": GradDecoderHead(cfg), "residual": GradDecoderHead(cfg)})

    @tracing.spanned(tracing.MODEL_FORWARD)
    def forward(self, x_spec: torch.Tensor, y_spec: torch.Tensor, t: torch.Tensor, fs: int,
                frames: Optional[torch.Tensor] = None, shard=None) -> torch.Tensor:
        _, T, F = x_spec.shape
        cfg = self.cfg
        K = B.band_count(cfg.input_dim, cfg.target_fs, fs, F)
        fm = None if frames is None else dsp.frames_mask(frames, T)
        with tracing.span(tracing.MODEL_BAND_SPLIT):  # and the condition projection
            zx = self.band_split(x_spec, K, fm)
            zy = self.band_split_y(y_spec, K, fm)
            z = torch.cat([zx, zy], dim=-1) @ self.condition_fc_w + self.condition_fc_b
        z = B.run_layers(self.layers, z, cfg, frames, fm, t, shard=shard)
        m = self.grad_decoder["mask"](z, K, F, fm)
        r = self.grad_decoder["residual"](z, K, F, fm)
        return m * x_spec + r


def init_flowse(cfg: FlowSEConfig, seed: int = 0, device="cuda") -> FlowDNN:
    """A randomly initialised network (the distributions of the JAX
    ``init_flowse``, drawn from a torch.Generator) on the card, or on the
    CPU where the caller asks for it."""
    device = resolve_device(device)
    dnn_cfg = cfg.dnn_cfg
    gen = torch.Generator().manual_seed(seed)
    u = B.uniform_sampler(gen)
    model = FlowDNN(dnn_cfg)
    C, sc, N = dnn_cfg.num_channel, dnn_cfg.sub_channel, dnn_cfg.num_channel
    with torch.no_grad():
        B.init_band_split(model.band_split, u)
        B.init_layers(model.layers, u, gen)
        B.init_band_split(model.band_split_y, u)
        model.condition_fc_w.copy_(u((2 * N, N), 2 * N))
        for head in model.grad_decoder.values():
            for i, sub in enumerate(dnn_cfg.subbands):
                # Conv1d(C, sc * sub, 1) weight (sc * sub, C), output channel
                # s_c * sub + s_b
                wfull = u((sc * sub, C), C).reshape(sc, sub, C)
                head.w[i, :, :, :sub] = wfull.permute(2, 0, 1)
                head.b[i, :, :sub] = u((sc * sub,), C).reshape(sc, sub)
            head.conv_w.copy_(u((5, 5, sc, 4), sc * 25))
            head.conv_b.copy_(u((4,), sc * 25))
    return model.to(device)


def vector_field(model: FlowDNN, x: torch.Tensor, t: torch.Tensor, y: torch.Tensor, fs: int,
                 frames: Optional[torch.Tensor] = None, shard=None) -> torch.Tensor:
    """VF(x, t, y) = -dnn(x, y, t); ``shard``: the row sharder of
    ``parallel/model_parallel.py``."""
    return -model(x, y, t, fs, frames, shard)


# ---------------------------------------------------------------------------
# Training loss and enhancement
# ---------------------------------------------------------------------------


def draw_t(cfg: FlowSEConfig, n: int, device, generator: Optional[torch.Generator] = None):
    """The CFM times of n rows: (1 - U[0, 1)) * (T_rev - t_eps) + t_eps, in
    (t_eps, T_rev], drawn on the generator's device and moved to ``device``."""
    dev = generator.device if generator is not None else device
    u = torch.rand((n,), generator=generator, device=dev).to(device)
    return torch.clamp((1.0 - u) * (cfg.T_rev - cfg.t_eps) + cfg.t_eps, max=cfg.T_rev)


def cfm_draws(cfg: FlowSEConfig, shape, rows: slice, device,
              generator: Optional[torch.Generator] = None):
    """``flowse_loss``'s draws (t, then the noise) for a global batch of
    spectra of ``shape`` (B, T, F), of which this rank keeps ``rows``:
    (noise[rows], t[rows])."""
    t = draw_t(cfg, shape[0], device, generator)
    noise = complex_normal(shape, device, generator)
    return noise[rows], t[rows]



def flowse_loss(model: FlowDNN, cfg: FlowSEConfig, clean: torch.Tensor, noisy: torch.Tensor,
                fs: int, lengths: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None, t: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, shard=None) -> torch.Tensor:
    """Conditional-flow-matching loss of (B, T) waveforms: 0.5 * the sum over
    (T, F) of |VF(x_t) - (der_std z + y - x0)|^2 (or | |), mean over the
    batch.  With ``lengths`` (B,) the whole step is length-exact (reflect
    tails, the masked network, the sum over each utterance's valid frames).
    ``noise`` (B, T, F) complex and ``t`` (B,) replace the draws from
    ``generator`` (t first, then the noise; ``cfm_draws``).  ``shard``: the
    row sharder of ``parallel/model_parallel.py``."""
    clean = torch.nan_to_num(clean)
    noisy = torch.nan_to_num(noisy)
    stft_cfg = cfg.stft_cfg
    n_fft, _, hop = stft_cfg.geometry(fs)
    if lengths is not None:
        lengths = lengths.to(clean.device)
        clean = dsp.reflect_tail(clean, lengths, n_fft // 2)
        noisy = dsp.reflect_tail(noisy, lengths, n_fft // 2)
    x0 = dsp.stft_encode(clean, fs, stft_cfg)
    y = dsp.stft_encode(noisy, fs, stft_cfg)
    Bsz = x0.shape[0]
    if t is None:
        t = draw_t(cfg, Bsz, x0.device, generator)
    ode = cfg.ode
    mean, std = ode.marginal_prob(x0, t, y)
    z = complex_normal_like(x0, generator) if noise is None else noise
    xt = mean + std.reshape(-1, 1, 1) * z
    cond_vf = ode.der_std(t).reshape(-1, 1, 1) * z + ode.der_mean(x0, t, y)
    frames = None if lengths is None else dsp.valid_frames(lengths, n_fft, hop)
    vf = vector_field(model, xt, t, y, fs, frames, shard)
    with tracing.span(tracing.MODEL_LOSS):
        err = vf - cond_vf
        if cfg.loss_type == "mse":
            losses = err.abs().square()
        elif cfg.loss_type == "mae":
            losses = err.abs()
        else:
            raise ValueError(cfg.loss_type)
        if lengths is not None:
            losses = losses * frame_mask(lengths, n_fft, hop, losses.shape[1])[..., None]
        return (0.5 * losses.reshape(Bsz, -1).sum(dim=-1)).mean()


def flowse_enhance(model: FlowDNN, cfg: FlowSEConfig, noisy: torch.Tensor, fs: int,
                   N: int = 15, solver: str = "euler", lengths: Optional[torch.Tensor] = None,
                   scale_norm: bool = True, generator: Optional[torch.Generator] = None,
                   x0: Optional[torch.Tensor] = None, prior_rows=None,
                   shard=None) -> torch.Tensor:
    """Sampler-based enhancement, (B, T) -> (B, T).

    ``scale_norm`` peak-normalises each input to 0.9 before sampling and
    undoes the scale after (the training data's scale; a no-op for inputs
    already at 0.9).  With ``lengths`` the network runs length-exact and the
    iSTFT uses the masked envelope; the prior is drawn at the padded shape.
    ``x0`` (B, T, F) complex replaces the prior drawn from ``generator``.
    ``prior_rows`` (n, rows): the rows are ``rows`` of a global batch of n,
    and the prior noise is drawn for all n and cut to ``rows``, as every
    rank of ``parallel/model_parallel.make_sharded_flow_enhance`` does.
    ``shard``: the row sharder of ``parallel/model_parallel.py``."""
    if scale_norm:
        # the padding is zero, so the global max is the valid region's
        peak = noisy.abs().amax(dim=-1, keepdim=True)
        scale = 0.9 / torch.clamp(peak, min=1e-6)
        noisy = noisy * scale
    stft_cfg = cfg.stft_cfg
    frames = fm = None
    if lengths is not None:
        lengths = lengths.to(noisy.device)
        n_fft, _, hop = stft_cfg.geometry(fs)
        y = dsp.stft_encode(dsp.reflect_tail(noisy, lengths, n_fft // 2), fs, stft_cfg)
        frames = dsp.valid_frames(lengths, n_fft, hop)
        fm = dsp.frames_mask(frames, y.shape[1])
    else:
        y = dsp.stft_encode(noisy, fs, stft_cfg)

    def vf_fn(x, t, y_):
        return vector_field(model, x, t, y_, fs, frames, shard)

    if x0 is None and prior_rows is not None:
        x0 = cfg.ode.prior_sampling(y, generator, rows=prior_rows)[0]
    sample, _ = sample_flow(vf_fn, cfg.ode, y, solver=solver, N=N, T_rev=cfg.T_rev,
                            t_eps=cfg.t_eps, generator=generator, x0=x0)
    wav = dsp.stft_decode(sample, fs, stft_cfg, length=noisy.shape[-1], frame_mask=fm)
    if lengths is not None:
        t_idx = torch.arange(wav.shape[-1], device=wav.device)
        wav = wav * (t_idx[None, :] < lengths.to(wav.device)[:, None])
    if scale_norm:
        wav = wav / scale
    return wav
