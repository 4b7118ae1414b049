"""The port's discriminative BSRNN (STFT -> model -> iSTFT) against the JAX
package's bsrnn_se_apply on the CPU, float32, with and without lengths.

The JAX side runs its scan recurrences (use_pallas_lstm=False), which its
own tests pin to the Pallas kernels; the port runs the plain versions of its
CUDA kernels.  Both get the same parameter tree through from_jax_params and
the same numpy input; valid samples agree within 2e-4 (the full-forward
precedent of PARITY.md:148-151)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from urgent2026_challenge_track1_tpu.dsp.stft import STFTConfig as JaxSTFT
from urgent2026_challenge_track1_tpu.models import bsrnn as jbsrnn
from urgent2026_challenge_track1_tpu_torch.dsp.stft import STFTConfig
from urgent2026_challenge_track1_tpu_torch.models import bsrnn as tbsrnn
from urgent2026_challenge_track1_tpu_torch.utils.params import from_jax_params

torch.set_num_threads(1)
ATOL = 2e-4
CFG = jbsrnn.BSRNNConfig(input_dim=481, num_channel=16, num_layer=2, remat=False)


@pytest.fixture(scope="module")
def models():
    params = jbsrnn.init_bsrnn(jax.random.PRNGKey(0), CFG)
    return params, from_jax_params(jax.tree.map(np.asarray, params))


def _input(fs, seed):
    rng = np.random.default_rng(seed)
    T = fs // 2
    x = (0.1 * rng.standard_normal((2, T))).astype(np.float32)
    return x, np.array([T, T - fs // 7], np.int32)


@pytest.mark.parametrize("with_lengths", [False, True])
@pytest.mark.parametrize("fs", [8000, 16000, 48000])
def test_bsrnn_se_apply_matches_jax(models, fs, with_lengths):
    params, model = models
    x, lengths = _input(fs, fs)
    j_len = jnp.asarray(lengths) if with_lengths else None
    t_len = torch.from_numpy(lengths) if with_lengths else None
    ref, ref_spec = jax.jit(
        lambda p, w, n: jbsrnn.bsrnn_se_apply(p, CFG, JaxSTFT(), w, fs, lengths=n)
    )(params, jnp.asarray(x), j_len)
    with torch.inference_mode():
        got, got_spec = tbsrnn.bsrnn_se_apply(model, STFTConfig(), torch.from_numpy(x), fs, t_len)
    ref, got = np.asarray(ref), got.numpy()
    assert got.shape == ref.shape and got_spec.shape == ref_spec.shape
    if with_lengths:
        for b, n in enumerate(lengths):
            np.testing.assert_allclose(got[b, :n], ref[b, :n], atol=ATOL, rtol=0)
            assert not got[b, n:].any()  # the padding comes out zero
    else:
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("fs", [8000, 16000, 22050, 32000, 44100, 48000])
def test_band_count_matches_jax(fs):
    n_bins = STFTConfig().n_bins(fs)
    assert tbsrnn.band_count(481, 48000, fs, n_bins) == jbsrnn.band_count(481, 48000, fs, n_bins)


def test_bfloat16_compute_stays_near_float32(models):
    """The card's dtype path (bf16 products and recurrences, f32 norms and
    state) run with the plain kernels: finite and within 5e-2 of float32
    (the bf16 kernel tolerance of scripts/check_pallas_tpu.py)."""
    import dataclasses

    _, model = models
    bf16 = tbsrnn.BSRNN(dataclasses.replace(model.cfg, compute_dtype="bfloat16"))
    bf16.load_state_dict(model.state_dict())
    x, lengths = _input(16000, 3)
    with torch.inference_mode():
        ref, _ = tbsrnn.bsrnn_se_apply(model, STFTConfig(), torch.from_numpy(x), 16000,
                                       torch.from_numpy(lengths))
        got, _ = tbsrnn.bsrnn_se_apply(bf16, STFTConfig(), torch.from_numpy(x), 16000,
                                       torch.from_numpy(lengths))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert float((got - ref).abs().max()) < 5e-2


def test_padding_does_not_change_valid_output(models):
    """Length-exact path: one utterance alone and inside a longer bucket."""
    _, model = models
    fs = 16000
    x, lengths = _input(fs, 1)
    n = int(lengths[1])
    with torch.inference_mode():
        alone, _ = tbsrnn.bsrnn_se_apply(model, STFTConfig(), torch.from_numpy(x[1:, :n]),
                                         fs, torch.tensor([n]))
        padded, _ = tbsrnn.bsrnn_se_apply(model, STFTConfig(), torch.from_numpy(x),
                                          fs, torch.from_numpy(lengths))
    np.testing.assert_allclose(padded[1, :n].numpy(), alone[0].numpy(), atol=1e-5, rtol=0)
