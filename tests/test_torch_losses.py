"""The port's training losses against ``train/losses.py``: the
multi-resolution L1 spectral loss and SI-SNR, with and without lengths, at 8
and 48 kHz.  CPU, float32, 1e-5 relative (same arithmetic, other FFT and
summation order).  The loss gradient with respect to the estimate is held
too, since training differentiates it, at 1e-4 relative (as max|d| /
max|reference|): XLA fuses the backward of the 4 STFTs and the norms into
other sums than autograd's, which leaves ~1.4e-5 in f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from urgent2026_challenge_track1_tpu.train import losses as jlosses
from urgent2026_challenge_track1_tpu_torch.train import losses as tlosses

torch.set_num_threads(1)
RTOL, GRAD_RTOL = 1e-5, 1e-4


def _signals(fs, seed):
    rng = np.random.default_rng(seed)
    T = fs // 2  # a 0.5 s bucket
    t = np.arange(T) / fs
    clean = (0.3 * np.sin(2 * np.pi * 220.0 * t)[None] + 0.05 * rng.standard_normal((3, T)))
    est = clean + 0.1 * rng.standard_normal((3, T))
    lengths = np.array([T, T - fs // 10, T // 2 + 7], np.int32)
    return clean.astype(np.float32), est.astype(np.float32), lengths


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("with_lengths", [False, True])
@pytest.mark.parametrize("fs", [8000, 48000])
def test_multi_res_l1_spec_loss_matches_jax(fs, with_lengths):
    clean, est, lengths = _signals(fs, fs)
    jl = jnp.asarray(lengths) if with_lengths else None
    tl = torch.from_numpy(lengths) if with_lengths else None
    ref_vec, vjp = jax.vjp(
        jax.jit(lambda e: jlosses.multi_res_l1_spec_loss(jnp.asarray(clean), e, jl)),
        jnp.asarray(est))
    (ref_grad,) = vjp(jnp.ones_like(ref_vec))
    est_t = torch.from_numpy(est).requires_grad_()
    got = tlosses.multi_res_l1_spec_loss(torch.from_numpy(clean), est_t, tl)
    got.sum().backward()
    assert got.shape == (3,)
    assert _rel(got.detach(), ref_vec) < RTOL
    assert _rel(est_t.grad, ref_grad) < GRAD_RTOL


@pytest.mark.parametrize("with_lengths", [False, True])
@pytest.mark.parametrize("fs", [8000, 48000])
def test_si_snr_matches_jax(fs, with_lengths):
    clean, est, lengths = _signals(fs, fs + 1)
    jl = jnp.asarray(lengths) if with_lengths else None
    tl = torch.from_numpy(lengths) if with_lengths else None
    ref = jlosses.si_snr(jnp.asarray(clean), jnp.asarray(est), jl)
    got = tlosses.si_snr(torch.from_numpy(clean), torch.from_numpy(est), tl)
    assert _rel(got, ref) < RTOL
    neg = tlosses.si_snr_loss(torch.from_numpy(clean), torch.from_numpy(est), tl)
    assert _rel(neg, -np.asarray(ref)) < RTOL


def test_masked_loss_ignores_the_padding():
    """With lengths, the value is that of the exact-length signals."""
    clean, est, lengths = _signals(8000, 3)
    L = int(lengths[2])
    padded = tlosses.multi_res_l1_spec_loss(torch.from_numpy(clean[2:]),
                                            torch.from_numpy(est[2:]),
                                            torch.from_numpy(lengths[2:]))
    exact = tlosses.multi_res_l1_spec_loss(torch.from_numpy(clean[2:, :L]),
                                           torch.from_numpy(est[2:, :L]))
    assert _rel(padded, exact) < RTOL
