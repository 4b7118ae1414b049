"""Plain reference of the flow-matching BSRNN (FlowSE) of the URGENT 2026
Track 1 baseline (``conf/models/BSRNN_flowse.yaml``), one utterance at its
exact length: the conditional vector-field network, the conditional flow
matching loss and the Euler sampler.

  x_t, y (T, F) complex, t
    -> BandSplit(x_t) ++ BandSplit_y(y) -> condition_fc -> (T, K, N)
    -> num_layer dual-path layers, each adding the Fourier embedding of t
    -> GradDecoder x 2: per band norm, 1x1 projection to (sc, sub), tanh;
       the bands along frequency; Conv2d(sc -> 4, 5x5) over (F, T), GLU
    -> g = mask * x_t + residual; the vector field is -g

Paths: mean_t = (1 - t) x0 + t y, std_t = (1 - t) sigma_min + t sigma_max,
prior x_T = y + sigma_max z with z complex normal of unit variance.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from port_bench.reference import common as C

INPUT_DIM = 769  # bins at 48 kHz (n_fft 1536)


def param_numel(cfg: dict) -> int:
    subs = C.subbands(INPUT_DIM)
    N, sc, K, SM = cfg["bsrnn_hidden"], cfg["sub_channel"], len(subs), max(subs)
    head = K * N * sc * SM + K * sc * SM + 25 * sc * 4 + 4
    return (2 * C.band_split_numel(subs, N) + 2 * N * N
            + cfg["num_layer"] * C.layer_numel(N) + 2 * head)


def init_params(cfg: dict, seed: int, device) -> dict:
    gen = C.generator(seed, device)
    d = C.Draws(param_numel(cfg), gen, device)
    subs = C.subbands(INPUT_DIM)
    N, sc = cfg["bsrnn_hidden"], cfg["sub_channel"]
    p = C.band_split_params(d, "band_split", subs, N, device)
    p.update(C.band_split_params(d, "band_split_y", subs, N, device))
    p["condition_fc_w"] = d.take((2 * N, N), 2 * N)
    p["condition_fc_b"] = torch.zeros(N, device=device)
    for i in range(cfg["num_layer"]):
        p.update(C.layer_params(d, f"layers.{i}", N, device, gen))
    mask, _ = C.band_rows(subs, lambda s: s, device)
    K, SM = mask.shape
    for head in ("mask", "residual"):
        pre = f"grad_decoder.{head}"
        p[f"{pre}.norm_scale"] = torch.ones(K, N, device=device)
        p[f"{pre}.norm_bias"] = torch.zeros(K, N, device=device)
        p[f"{pre}.w"] = d.take((K, N, sc, SM), N) * mask[:, None, None, :]
        p[f"{pre}.b"] = d.take((K, sc, SM), N) * mask[:, None, :]
        p[f"{pre}.conv_w"] = d.take((5, 5, sc, 4), sc * 25)
        p[f"{pre}.conv_b"] = d.take((4,), sc * 25)
    return p


def _head(p: dict, pre: str, z: torch.Tensor, subs, F: int, prec: C.Precision):
    """GradDecoder head -> (T, F) complex.  ``conv_w`` is HWIO (5, 5, sc, 4)."""
    T, K, _ = z.shape
    rows = []
    for k in range(K):
        h = C.head_norm(p, pre, z[:, k], k)
        w = p[f"{pre}.w"][k, :, :, :subs[k]]  # (N, sc, sub)
        h = prec.mm(h, w.reshape(w.shape[0], -1)).reshape(T, w.shape[1], subs[k])
        rows.append(torch.tanh(h + p[f"{pre}.b"][k, :, :subs[k]]))
    img = torch.cat(rows, dim=2).permute(1, 2, 0)[None]  # (1, sc, F_total, T)
    out = torch.nn.functional.conv2d(prec.r(img), prec.r(p[f"{pre}.conv_w"].permute(3, 2, 0, 1)),
                                     p[f"{pre}.conv_b"], padding=2)[0]  # (4, F_total, T)
    out = out[:2] * torch.sigmoid(out[2:])
    return torch.complex(out[0], out[1])[:F].transpose(0, 1)


def vector_field(p: dict, cfg: dict, x: torch.Tensor, y: torch.Tensor, t: torch.Tensor,
                 fs: int, prec: C.Precision) -> torch.Tensor:
    """VF(x_t, t, y) = -(mask * x_t + residual) for (T, F) spectra, t a scalar."""
    subs = C.subbands(INPUT_DIM)
    F = x.shape[1]
    K = C.n_bands(INPUT_DIM, fs, F)
    zx = C.band_split(p, "band_split", x, subs, K, prec)
    zy = C.band_split(p, "band_split_y", y, subs, K, prec)
    z = prec.mm(torch.cat([zx, zy], dim=-1), p["condition_fc_w"], p["condition_fc_b"])
    for i in range(cfg["num_layer"]):
        z = C.dual_path_layer(p, f"layers.{i}", z, prec, t)
    m = _head(p, "grad_decoder.mask", z, subs, F, prec)
    r = _head(p, "grad_decoder.residual", z, subs, F, prec)
    return -(m * x + r)


def _encode(cfg: dict, wav: torch.Tensor, fs: int) -> torch.Tensor:
    n_fft, hop = C.geometry(cfg["n_fft"], cfg["hop_length"], fs)
    return C.compress(C.stft(wav, n_fft, hop), cfg["spec_abs_exponent"], cfg["spec_factor"])


def _decode(cfg: dict, spec: torch.Tensor, fs: int, length: int) -> torch.Tensor:
    n_fft, hop = C.geometry(cfg["n_fft"], cfg["hop_length"], fs)
    return C.istft(C.decompress(spec, cfg["spec_abs_exponent"], cfg["spec_factor"]),
                   n_fft, hop, length)


def prior_noise(shape, seed: int, device) -> torch.Tensor:
    """The sampler's prior draw z (complex normal, unit variance) of a
    padded batch ``shape`` (B, T, F), from a generator seeded with ``seed``
    on ``device``: real parts, then imaginary parts."""
    gen = C.generator(seed, device)
    re = torch.randn(shape, generator=gen, device=device)
    im = torch.randn(shape, generator=gen, device=device)
    return torch.complex(re, im) * math.sqrt(0.5)


def enhance(p: dict, cfg: dict, wav: torch.Tensor, fs: int, z: torch.Tensor,
            prec: C.Precision) -> torch.Tensor:
    """One utterance (L,) -> (L,): peak to 0.9, the Euler sampler of
    ``cfg["nfe"]`` steps over linspace(T_rev, t_eps, N) from x_T = y +
    sigma_max z (``z`` at least as many frames as the utterance has), the
    scale undone."""
    scale = 0.9 / torch.clamp(wav.abs().max(), min=1e-6)
    y = _encode(cfg, wav * scale, fs)
    x = y + cfg["sigma_max"] * z[:y.shape[0]]
    N = cfg["nfe"]
    ts = np.linspace(cfg["T_rev"], cfg["t_eps"], N, dtype=np.float32)
    steps = np.append(ts[:-1] - ts[1:], ts[-1])
    for t, step in zip(ts.tolist(), steps.tolist()):
        tt = torch.tensor(t, dtype=torch.float32, device=wav.device)
        x = x - step * vector_field(p, cfg, x, y, tt, fs, prec)
    return _decode(cfg, x, fs, wav.shape[0]) / scale


def item_loss(p: dict, cfg: dict, item: dict, fs: int, prec: C.Precision) -> torch.Tensor:
    """Conditional flow matching loss of one utterance: 0.5 sum over (T, F)
    of |VF(x_t) - ((sigma_max - sigma_min) z + y - x0)|^2; ``item`` has
    ``clean``, ``noisy`` (L,), ``noise`` (>= frames, F) complex and ``t``."""
    x0 = _encode(cfg, item["clean"], fs)
    y = _encode(cfg, item["noisy"], fs)
    t = item["t"]
    z = item["noise"][:x0.shape[0]]
    std = (1 - t) * cfg["sigma_min"] + t * cfg["sigma_max"]
    xt = (1 - t) * x0 + t * y + std * z
    target = (cfg["sigma_max"] - cfg["sigma_min"]) * z + (y - x0)
    err = vector_field(p, cfg, xt, y, t, fs, prec) - target
    return 0.5 * err.abs().square().sum()


def dims(cfg: dict) -> dict:
    """The sizes the yardstick counts with."""
    return {"N": cfg["bsrnn_hidden"], "layers": cfg["num_layer"], "n_fft": cfg["n_fft"],
            "hop": cfg["hop_length"], "input_dim": cfg["n_fft"] // 2 + 1,
            "sub_channel": cfg["sub_channel"]}


def prior(cfg: dict, fs: int, bucket: int, rows: int, seed: int, device) -> torch.Tensor:
    """The prior draw of a batch of ``rows`` utterances padded to ``bucket``
    samples: (rows, frames, bins)."""
    n_fft, hop = C.geometry(cfg["n_fft"], cfg["hop_length"], fs)
    return prior_noise((rows, C.frames(bucket, n_fft, hop), n_fft // 2 + 1), seed, device)


def enhance_item(p: dict, cfg: dict, item: dict, fs: int, prec: C.Precision) -> torch.Tensor:
    return enhance(p, cfg, item["noisy"], fs, item["z"], prec)
