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


def _bf16_np(a: torch.Tensor) -> np.ndarray:
    """a rounded to bfloat16, as float64 numpy."""
    return a.to(torch.bfloat16).double().numpy()


@pytest.mark.parametrize("eq, a_shape, b_shape", [
    ("mm", (5, 7, 96), (96, 24)),                         # fc after each BLSTM
    ("btkw,kwc->btkc", (2, 6, 5, 20), (5, 20, 24)),       # band split
    ("btkc,kcd->btkd", (2, 6, 5, 24), (5, 24, 96)),       # mask decoder, first conv
    ("btkd,kdw->btkw", (2, 6, 5, 96), (5, 96, 20)),       # mask decoder, value/gate
])
def test_bfloat16_products_have_float32_outputs(eq, a_shape, b_shape):
    """A bf16 x bf16 product sums in f32 and is not rounded to bf16 after
    (JAX: preferred_element_type=float32).  Reference: the float64 product of
    the bf16-rounded operands; rounding the output to bf16 would miss it by
    ~2e-3 relative."""
    rng = np.random.default_rng(11)
    a = torch.from_numpy(rng.standard_normal(a_shape).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(b_shape).astype(np.float32))
    if eq == "mm":
        bias = torch.from_numpy(rng.standard_normal(b_shape[-1]).astype(np.float32))
        got = tbsrnn._mm(a, b, bias, torch.bfloat16)
        ref = _bf16_np(a) @ _bf16_np(b) + bias.double().numpy()
    else:
        got = tbsrnn._einsum(eq, a, b, torch.bfloat16)
        ref = np.einsum(eq, _bf16_np(a), _bf16_np(b))
    assert got.dtype == torch.float32
    err = np.abs(got.double().numpy() - ref).max() / np.abs(ref).max()
    assert err <= 1e-5
    rounded = got.to(torch.bfloat16).double().numpy()
    assert np.abs(rounded - ref).max() / np.abs(ref).max() > 1e-4  # the old fault


def test_band_split_bfloat16_has_float32_outputs(models, monkeypatch):
    """The band-split module in bf16 equals its norm output times the
    weights, both rounded to bf16, summed in float64."""
    _, model = models
    bs = tbsrnn.BandSplit(tbsrnn.BSRNNConfig(num_channel=16, num_layer=2,
                                             compute_dtype="bfloat16"))
    bs.load_state_dict(model.band_split.state_dict())
    rng = np.random.default_rng(12)
    F, T = 161, 9  # 16 kHz bins
    spec = torch.complex(*(torch.from_numpy(rng.standard_normal((2, T, F)).astype(np.float32))
                           for _ in range(2)))
    K = tbsrnn.band_count(481, 48000, 16000, F)
    captured = {}
    real_norm = tbsrnn.masked_group_norm

    def spy(*a, **kw):
        captured["h"] = real_norm(*a, **kw)
        return captured["h"]

    monkeypatch.setattr(tbsrnn, "masked_group_norm", spy)
    with torch.no_grad():
        got = bs(spec, K)
    ref = np.einsum("btkw,kwc->btkc", _bf16_np(captured["h"]), _bf16_np(bs.w[:K].detach()))
    ref = ref + bs.b[:K].detach().double().numpy()[None, None]
    assert got.dtype == torch.float32
    assert np.abs(got.double().numpy() - ref).max() / np.abs(ref).max() <= 1e-5
