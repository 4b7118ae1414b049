"""Plain PyTorch building blocks of the benchmark's reference models.

The reference follows the URGENT 2026 Track 1 baseline (espnet's BSRNN
and the FlowSE network of ``baseline_code/models``) one utterance at a
time, at its exact length: no padding, no masks, no batching, no kernels.
The LSTMs are ``torch._VF.lstm`` (cuDNN on the card, ATen on the CPU).

Every matrix product goes through a ``Precision``: float32 with TF32 off
is the reference; ``tf32`` and ``fp8`` round the operands of every product
(weights and activations, the LSTMs' inputs and weights included) to the
lower precision, which is the control that a comparison has to reject.

Nothing here imports the program under test.
"""

from __future__ import annotations

import contextlib
import math
import warnings

import numpy as np
import torch

EPS = 1e-8  # espnet choose_norm "GN" eps, every norm of both models


# ---------------------------------------------------------------------------
# Precision of the products
# ---------------------------------------------------------------------------


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, round to nearest even)."""
    b = x.detach().float().contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & -0x2000
    return b.view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x scaled per tensor to the e4m3 range, rounded to float8_e4m3fn and
    scaled back (the usual per-tensor-scaled fp8 product operand)."""
    xd = x.detach().float()
    amax = xd.abs().amax()
    scale = torch.where(amax > 0, 448.0 / amax, torch.ones_like(amax))
    return (xd * scale).to(torch.float8_e4m3fn).float() / scale


class Precision:
    """How the reference rounds the operands of its products.

    ``float32``: not at all, TF32 off for matmuls, convolutions and cuDNN's
    RNNs (the reference); ``tf32``: TF32 operands, TF32 allowed; ``fp8``:
    per-tensor-scaled e4m3 operands.  Rounding passes gradients straight
    through."""

    MODES = ("float32", "tf32", "fp8")

    def __init__(self, mode: str = "float32"):
        if mode not in self.MODES:
            raise ValueError(f"precision {mode!r}: expected one of {self.MODES}")
        self.mode = mode

    def r(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "float32":
            return x
        q = round_tf32(x) if self.mode == "tf32" else round_fp8(x)
        return x + (q - x).detach() if x.requires_grad else q

    def mm(self, x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
        y = self.r(x) @ self.r(w)
        return y if b is None else y + b

    @contextlib.contextmanager
    def flags(self):
        """TF32 on for the ``tf32`` control, off otherwise; restored after."""
        cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
        old = (cuda.allow_tf32, cudnn.allow_tf32)
        on = self.mode == "tf32"
        cuda.allow_tf32 = on
        cudnn.allow_tf32 = on
        try:
            yield
        finally:
            cuda.allow_tf32, cudnn.allow_tf32 = old


# ---------------------------------------------------------------------------
# Band layout of the BSRNN band split (espnet BandSplit at target_fs 48 kHz)
# ---------------------------------------------------------------------------


def subbands(input_dim: int) -> tuple[int, ...]:
    """Band widths in bins at 48 kHz for the two published STFT sizes."""
    if input_dim == 481:  # n_fft 960
        return tuple([5] + [4] * 19 + [10] * 6 + [40] * 7 + [60])
    if input_dim == 769:  # n_fft 1536
        return tuple([5] + [4] * 26 + [10] * 10 + [50] * 10 + [60])
    raise ValueError(f"no band layout for input_dim={input_dim}")


def n_bands(input_dim: int, fs: int, n_bins: int) -> int:
    """Bands the split keeps at rate ``fs`` with ``n_bins`` input bins: it
    stops once the bins are used up or a band's upper edge reaches fs/2."""
    subs = subbands(input_dim)
    n_fft = (input_dim - 1) * 2
    edge = (np.cumsum(subs) - 1) * (48000 / n_fft)
    used = 0
    for k, sub in enumerate(subs):
        used += sub
        if used >= n_bins or edge[k] >= fs / 2:
            return k + 1
    return len(subs)


# ---------------------------------------------------------------------------
# STFT with the fs-scaled geometry of the baseline (espnet STFTEncoder)
# ---------------------------------------------------------------------------


def geometry(n_fft: int, hop: int, fs: int) -> tuple[int, int]:
    """(n_fft, hop) at rate fs, scaled from 48 kHz by floor division."""
    if fs == 48000:
        return n_fft, hop
    return n_fft * fs // 48000, hop * fs // 48000


def frames(n_samples: int, n_fft: int, hop: int) -> int:
    """Frames of a center-padded STFT of ``n_samples`` samples."""
    return 1 + (n_samples + 2 * (n_fft // 2) - n_fft) // hop


def _window(n_fft: int, device) -> torch.Tensor:
    return torch.hann_window(n_fft, periodic=True, dtype=torch.float32, device=device)


def stft(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(..., T) -> (..., frames, bins) complex: Hann, center, reflect pad."""
    lead = x.shape[:-1]
    s = torch.stft(x.reshape(-1, x.shape[-1]), n_fft, hop, n_fft, _window(n_fft, x.device),
                   center=True, pad_mode="reflect", return_complex=True)
    return s.transpose(-1, -2).reshape(lead + (s.shape[-1], s.shape[-2]))


def istft(spec: torch.Tensor, n_fft: int, hop: int, length: int) -> torch.Tensor:
    """(frames, bins) complex -> (length,): weighted overlap-add divided by
    the summed squared window, the center pad dropped."""
    w = _window(n_fft, spec.device)
    fr = torch.fft.irfft(spec, n=n_fft, dim=-1) * w  # (T, n_fft)
    T = fr.shape[0]
    total = hop * (T - 1) + n_fft
    out = torch.zeros(total, device=spec.device, dtype=fr.dtype)
    env = torch.zeros(total, device=spec.device, dtype=fr.dtype)
    idx = (torch.arange(T, device=spec.device)[:, None] * hop
           + torch.arange(n_fft, device=spec.device)[None, :])
    out = out.index_add(0, idx.reshape(-1), fr.reshape(-1))
    env = env.index_add(0, idx.reshape(-1), (w * w).expand(T, n_fft).reshape(-1))
    out = out / torch.clamp(env, min=1e-11)
    out = out[n_fft // 2:][:length]
    if out.shape[0] < length:
        out = torch.nn.functional.pad(out, (0, length - out.shape[0]))
    return out


def compress(spec: torch.Tensor, exponent: float, factor: float) -> torch.Tensor:
    """Magnitude compression |s|^e with the phase kept, times ``factor``
    (espnet ``spec_transform_func``, type "exponent")."""
    mag = spec.abs()
    safe = torch.where(mag > 0, mag, torch.ones_like(mag))
    return spec * torch.where(mag > 0, safe ** (exponent - 1.0), torch.zeros_like(mag)) * factor


def decompress(spec: torch.Tensor, exponent: float, factor: float) -> torch.Tensor:
    spec = spec / factor
    mag = spec.abs()
    safe = torch.where(mag > 0, mag, torch.ones_like(mag))
    return spec * torch.where(mag > 0, safe ** (1.0 / exponent - 1.0), torch.zeros_like(mag))


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def norm(x: torch.Tensor, scale=None, bias=None) -> torch.Tensor:
    """Single-group GroupNorm over every entry of x (espnet "GN")."""
    mean = x.mean()
    var = (x - mean).square().mean()
    y = (x - mean) / torch.sqrt(var + EPS)
    return y if scale is None else y * scale + bias


def bilstm(p: dict, pre: str, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Bidirectional LSTM (torch.nn.LSTM layout, gates i, f, g, o) over
    (rows, steps, in) -> (rows, steps, 2H), forward ++ backward."""
    ws = []
    for sfx in ("", "_reverse"):
        ws += [prec.r(p[f"{pre}.w_ih{sfx}"]), prec.r(p[f"{pre}.w_hh{sfx}"]),
               p[f"{pre}.b_ih{sfx}"], p[f"{pre}.b_hh{sfx}"]]
    H = ws[1].shape[1]
    h0 = x.new_zeros(2, x.shape[0], H)
    with warnings.catch_warnings():  # cuDNN copies the separate weights: fine here
        warnings.filterwarnings("ignore", message="RNN module weights")
        out, _, _ = torch._VF.lstm(prec.r(x).contiguous(), (h0, h0), ws, True, 1, 0.0,
                                   torch.is_grad_enabled(), True, True)
    return out


def dual_path_layer(p: dict, pre: str, z: torch.Tensor, prec: Precision,
                    t: torch.Tensor | None = None) -> torch.Tensor:
    """One BSRNN dual-path block on (T, K, N): norm, time BLSTM over T per
    band, projection, residual; norm, band BLSTM over K per frame,
    projection, residual.  ``t``: the flow time, whose Gaussian-Fourier
    embedding joins after the time path's norm."""
    out = norm(z, p[f"{pre}.norm_time_scale"], p[f"{pre}.norm_time_bias"])
    if t is not None:
        proj = t * p[f"{pre}.t_proj_w"] * (2.0 * math.pi)
        out = out + torch.cat([torch.sin(proj), torch.cos(proj)])
    h = bilstm(p, f"{pre}.rnn_time", out.permute(1, 0, 2), prec)  # (K, T, 2H)
    h = prec.mm(h, p[f"{pre}.fc_time_w"], p[f"{pre}.fc_time_b"])
    z = z + h.permute(1, 0, 2)
    out = norm(z, p[f"{pre}.norm_freq_scale"], p[f"{pre}.norm_freq_bias"])
    h = bilstm(p, f"{pre}.rnn_freq", out, prec)  # rows T, steps K
    return z + prec.mm(h, p[f"{pre}.fc_freq_w"], p[f"{pre}.fc_freq_b"])


def band_split(p: dict, pre: str, spec: torch.Tensor, subs, K: int,
               prec: Precision) -> torch.Tensor:
    """(T, F) complex -> (T, K, N): band k's bins as (re, im) pairs, its
    GroupNorm over (T, 2 sub_k) and its 1x1 projection to N.  A last band
    cut short by F is padded with zero bins."""
    T, F = spec.shape
    out, off = [], 0
    for k in range(K):
        sub = subs[k]
        seg = spec[:, off:off + sub]
        if seg.shape[1] < sub:
            seg = torch.nn.functional.pad(seg, (0, sub - seg.shape[1]))
        x = torch.view_as_real(seg).reshape(T, 2 * sub)
        x = norm(x, p[f"{pre}.norm_scale"][k, :2 * sub], p[f"{pre}.norm_bias"][k, :2 * sub])
        out.append(prec.mm(x, p[f"{pre}.w"][k, :2 * sub], p[f"{pre}.b"][k]))
        off += sub
    return torch.stack(out, dim=1)


def head_norm(p: dict, pre: str, zk: torch.Tensor, k: int) -> torch.Tensor:
    """A decoder head's per-band GroupNorm over (T, N)."""
    return norm(zk, p[f"{pre}.norm_scale"][k], p[f"{pre}.norm_bias"][k])


# ---------------------------------------------------------------------------
# Seeded parameters, made on the device in a few large draws
# ---------------------------------------------------------------------------


class Draws:
    """Slices of one uniform draw, each scaled to U(-1/sqrt(fan), 1/sqrt(fan))."""

    def __init__(self, total: int, gen: torch.Generator, device):
        self.u = torch.rand(total, generator=gen, device=device) * 2 - 1
        self.at = 0

    def take(self, shape, fan) -> torch.Tensor:
        n = int(np.prod(shape))
        out = self.u[self.at:self.at + n].reshape(shape)
        self.at += n
        if isinstance(fan, torch.Tensor):
            return out * torch.rsqrt(fan.float())
        return out / math.sqrt(fan)


def band_rows(subs, width_of, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(K, W) validity mask of band-stacked slots and (K, 1) fan-ins, where
    band k uses ``width_of(sub_k)`` of the W slots."""
    W = max(width_of(s) for s in subs)
    mask = torch.zeros(len(subs), W, device=device)
    for k, s in enumerate(subs):
        mask[k, :width_of(s)] = 1.0
    fan = torch.tensor([width_of(s) for s in subs], device=device, dtype=torch.float32)
    return mask, fan[:, None]


def lstm_params(d: Draws, pre: str, n_in: int, hidden: int) -> dict:
    out = {}
    for sfx in ("", "_reverse"):
        out[f"{pre}.w_ih{sfx}"] = d.take((4 * hidden, n_in), hidden)
        out[f"{pre}.w_hh{sfx}"] = d.take((4 * hidden, hidden), hidden)
        out[f"{pre}.b_ih{sfx}"] = d.take((4 * hidden,), hidden)
        out[f"{pre}.b_hh{sfx}"] = d.take((4 * hidden,), hidden)
    return out


def layer_params(d: Draws, pre: str, N: int, device, gen=None) -> dict:
    """One dual-path layer (hidden H = 2N); with ``gen`` the flow model's
    Gaussian-Fourier projection (N/2,), drawn N(0, 1)."""
    H = 2 * N
    p = {f"{pre}.norm_time_scale": torch.ones(N, device=device),
         f"{pre}.norm_time_bias": torch.zeros(N, device=device)}
    p.update(lstm_params(d, f"{pre}.rnn_time", N, H))
    p[f"{pre}.fc_time_w"] = d.take((2 * H, N), 2 * H)
    p[f"{pre}.fc_time_b"] = d.take((N,), 2 * H)
    p[f"{pre}.norm_freq_scale"] = torch.ones(N, device=device)
    p[f"{pre}.norm_freq_bias"] = torch.zeros(N, device=device)
    p.update(lstm_params(d, f"{pre}.rnn_freq", N, H))
    p[f"{pre}.fc_freq_w"] = d.take((2 * H, N), 2 * H)
    p[f"{pre}.fc_freq_b"] = d.take((N,), 2 * H)
    if gen is not None:
        p[f"{pre}.t_proj_w"] = torch.randn(N // 2, generator=gen, device=device)
    return p


def layer_numel(N: int) -> int:
    """Uniform draws of one dual-path layer."""
    H = 2 * N
    return 2 * 2 * (4 * H * N + 4 * H * H + 8 * H) + 2 * (2 * H * N + N)


def band_split_params(d: Draws, pre: str, subs, N: int, device) -> dict:
    mask, fan = band_rows(subs, lambda s: 2 * s, device)
    K, W = mask.shape
    return {f"{pre}.norm_scale": mask.clone(),
            f"{pre}.norm_bias": torch.zeros(K, W, device=device),
            f"{pre}.w": d.take((K, W, N), fan[:, :, None]) * mask[:, :, None],
            f"{pre}.b": d.take((K, N), fan)}


def band_split_numel(subs, N: int) -> int:
    K, W = len(subs), 2 * max(subs)
    return K * W * N + K * N


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)
