"""Plain reference of the discriminative BSRNN of the URGENT 2026 Track 1
baseline (``conf/models/BSRNN_baseline.yaml``: espnet's BSRNNSeparator
between an fs-scaled STFT encoder and decoder, trained on the
multi-resolution L1 spectral loss), one utterance at its exact length.

Parameters are a flat dict in the band-stacked layout that the program
also loads (band k of a (K, W, ...) tensor uses its first 2 sub_k slots);
``init_params`` makes them on the device from a seed.
"""

from __future__ import annotations

import torch

from port_bench.reference import common as C

INPUT_DIM = 481  # bins at 48 kHz (n_fft 960)
N_FFT, HOP = 960, 480


def param_numel(cfg: dict) -> int:
    subs = C.subbands(INPUT_DIM)
    N, K, W = cfg["num_channel"], len(subs), 2 * max(subs)
    head = K * N * 4 * N + K * 4 * N + 2 * K * 4 * N * W + 2 * K * W
    return C.band_split_numel(subs, N) + cfg["num_layer"] * C.layer_numel(N) + 2 * head


def init_params(cfg: dict, seed: int, device) -> dict:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) weights and biases, unit norm
    scales, zero norm biases, zero padding slots; one draw on ``device``."""
    gen = C.generator(seed, device)
    d = C.Draws(param_numel(cfg), gen, device)
    subs = C.subbands(INPUT_DIM)
    N = cfg["num_channel"]
    p = C.band_split_params(d, "band_split", subs, N, device)
    for i in range(cfg["num_layer"]):
        p.update(C.layer_params(d, f"layers.{i}", N, device))
    mask, _ = C.band_rows(subs, lambda s: 2 * s, device)
    K, W = mask.shape
    for head in ("mask", "residual"):
        pre = f"mask_decoder.{head}"
        p[f"{pre}.norm_scale"] = torch.ones(K, N, device=device)
        p[f"{pre}.norm_bias"] = torch.zeros(K, N, device=device)
        p[f"{pre}.w1"] = d.take((K, N, 4 * N), N)
        p[f"{pre}.b1"] = d.take((K, 4 * N), N)
        p[f"{pre}.wv"] = d.take((K, 4 * N, W), 4 * N) * mask[:, None, :]
        p[f"{pre}.wg"] = d.take((K, 4 * N, W), 4 * N) * mask[:, None, :]
        p[f"{pre}.bv"] = d.take((K, W), 4 * N) * mask
        p[f"{pre}.bg"] = d.take((K, W), 4 * N) * mask
    return p


def _head(p: dict, pre: str, z: torch.Tensor, subs, F: int, prec: C.Precision):
    """espnet MaskDecoder head: per band norm, Linear(N, 4N), tanh,
    Linear(4N, 2 x 2 sub) and GLU -> (T, F) complex."""
    T, K, _ = z.shape
    out = []
    for k in range(K):
        h = C.head_norm(p, pre, z[:, k], k)
        h = torch.tanh(prec.mm(h, p[f"{pre}.w1"][k], p[f"{pre}.b1"][k]))
        cw = 2 * subs[k]
        val = prec.mm(h, p[f"{pre}.wv"][k, :, :cw], p[f"{pre}.bv"][k, :cw])
        gate = prec.mm(h, p[f"{pre}.wg"][k, :, :cw], p[f"{pre}.bg"][k, :cw])
        o = (val * torch.sigmoid(gate)).reshape(T, subs[k], 2)
        out.append(torch.complex(o[..., 0], o[..., 1]))
    return torch.cat(out, dim=1)[:, :F]


def forward(p: dict, cfg: dict, spec: torch.Tensor, fs: int, prec: C.Precision):
    """(T, F) complex spectrum at rate fs -> mask * spec + residual."""
    subs = C.subbands(INPUT_DIM)
    F = spec.shape[1]
    K = C.n_bands(INPUT_DIM, fs, F)
    z = C.band_split(p, "band_split", spec, subs, K, prec)
    for i in range(cfg["num_layer"]):
        z = C.dual_path_layer(p, f"layers.{i}", z, prec)
    m = _head(p, "mask_decoder.mask", z, subs, F, prec)
    r = _head(p, "mask_decoder.residual", z, subs, F, prec)
    return m * spec + r


def enhance(p: dict, cfg: dict, wav: torch.Tensor, fs: int, prec: C.Precision) -> torch.Tensor:
    """One utterance (L,) -> enhanced (L,)."""
    n_fft, hop = C.geometry(N_FFT, HOP, fs)
    spec = C.stft(wav, n_fft, hop)
    return C.istft(forward(p, cfg, spec, fs, prec), n_fft, hop, wav.shape[0])


def mr_l1_loss(target: torch.Tensor, estimate: torch.Tensor) -> torch.Tensor:
    """espnet MultiResL1SpecLoss(window_sz=[256, 512, 768, 1024], eps=1e-6,
    normalize_variance=True, time_domain_weight=0.5) of one utterance."""
    target = target / target.std()
    estimate = estimate / estimate.std()
    scale = (estimate * target).sum() / ((estimate * estimate).sum() + 1e-6)
    est = estimate * scale
    time_loss = (est - target).abs().mean()
    spec = 0.0
    for w in (256, 512, 768, 1024):
        st, se = C.stft(target, w, w // 2), C.stft(est, w, w // 2)
        mt = torch.sqrt(st.real.square() + st.imag.square() + 1e-6)
        me = torch.sqrt(se.real.square() + se.imag.square() + 1e-6)
        spec = spec + (me - mt).abs().mean()
    return 0.5 * time_loss + 0.5 * spec / 4


def item_loss(p: dict, cfg: dict, item: dict, fs: int, prec: C.Precision) -> torch.Tensor:
    """The training loss of one utterance: ``item`` has ``clean`` and
    ``noisy`` (L,) tensors at their exact length."""
    return mr_l1_loss(item["clean"], enhance(p, cfg, item["noisy"], fs, prec))


def dims(cfg: dict) -> dict:
    """The sizes the yardstick counts with."""
    return {"N": cfg["num_channel"], "layers": cfg["num_layer"], "n_fft": N_FFT, "hop": HOP,
            "input_dim": INPUT_DIM, "sub_channel": None}


def prior(cfg: dict, fs: int, bucket: int, rows: int, seed: int, device):
    """The discriminative model draws nothing."""
    return None


def enhance_item(p: dict, cfg: dict, item: dict, fs: int, prec: C.Precision) -> torch.Tensor:
    return enhance(p, cfg, item["noisy"], fs, prec)
