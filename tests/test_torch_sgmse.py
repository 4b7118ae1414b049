"""The port's SGMSE (``models/sgmse.py``) against the JAX package's on the
CPU, at 16 channels x 2 layers with the n_fft 1536 / hop 384 layout (769
bins at 48 kHz, 48 bands; fs-scaled to 8 kHz here), 0.5 s at 8 kHz, B = 2,
float32.

* the OUVE SDE: ``mean``, ``std``, ``diffusion``, ``marginal_prob`` and
  ``prior_sampling`` with the JAX draw injected;
* ``score_fn``;
* ``sgmse_loss`` with and without likelihood weighting, t and z made by
  JAX's own key splits and handed to the port, and its gradients against
  ``jax.grad``;
* ``sgmse_enhance`` at N = 3 with 1 and 2 corrector steps, every draw (the
  prior and each step's corrector and predictor noises) made by JAX's key
  splits and handed to the port, with a control: one step's corrector
  noise left out must exceed the bounds tenfold.

Tolerances are ``tests/test_torch_flowse.py``'s: forward outputs and
samples 2e-4 absolute, the loss 1e-5 relative, gradients 1e-4 relative
per leaf (max|d| / max|reference|).  The sample is compared as the
compressed spectrum of the enhanced waveform (the sampler's own domain,
as the flow samplers' samples are), and the waveform itself within 1e-5
relative (read: 2.4e-5 to 3.2e-5 and 3.3e-7; the control 5.9 and 0.1)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from urgent2026_challenge_track1_tpu.dsp import stft as jdsp
from urgent2026_challenge_track1_tpu.models import sgmse as jsg
from urgent2026_challenge_track1_tpu.models.odes import complex_normal_like as jcnormal
from urgent2026_challenge_track1_tpu_torch.dsp import stft as tdsp
from urgent2026_challenge_track1_tpu_torch.models import sgmse as tsg
from urgent2026_challenge_track1_tpu_torch.utils.params import from_jax_params

torch.set_num_threads(1)
FWD_ATOL, LOSS_RTOL, GRAD_RTOL = 2e-4, 1e-5, 1e-4
WAVE_RTOL = 1e-5  # the enhanced waveform, max|d| / max|reference|
JCFG = jsg.SGMSEConfig(bsrnn_hidden=16, num_layer=2)
TCFG = tsg.SGMSEConfig(bsrnn_hidden=16, num_layer=2)
FS, T, B = 8000, 4000, 2


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30))


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _waves(seed):
    rng = np.random.default_rng(seed)
    t = np.arange(T) / FS
    clean = (0.3 * np.sin(2 * np.pi * rng.uniform(150, 400) * t)[None]
             + 0.05 * rng.standard_normal((B, T))).astype(np.float32)
    noisy = (clean + 0.1 * rng.standard_normal((B, T))).astype(np.float32)
    return clean, noisy


@pytest.fixture(scope="module")
def setup():
    params = jax.tree.map(np.asarray, jsg.init_sgmse(jax.random.PRNGKey(0), JCFG))
    model = from_jax_params(params)
    assert model.cfg == TCFG.dnn_cfg
    return params, model


def test_config_and_sde_match_jax():
    for f in dataclasses.fields(jsg.SGMSEConfig):
        assert getattr(TCFG, f.name) == getattr(JCFG, f.name), f.name
    assert TCFG.stft_cfg.geometry(FS) == jdsp.STFTConfig.geometry(JCFG.stft_cfg, FS)
    jsde, tsde = JCFG.sde, TCFG.sde
    t = np.array([0.0, 0.03, 0.41, 0.77, 1.0], np.float32)
    rng = np.random.default_rng(1)
    x0 = (rng.standard_normal((5, 3, 4)) + 1j * rng.standard_normal((5, 3, 4))).astype(np.complex64)
    y = (rng.standard_normal((5, 3, 4)) + 1j * rng.standard_normal((5, 3, 4))).astype(np.complex64)
    jt = jnp.asarray(t)
    assert np.abs(tsde.std(_t(t)).numpy() - np.asarray(jsde.std(jt))).max() < 1e-7
    assert tsde.std(_t(t))[0] == 0.0  # clamped at 0, not the root of a rounding negative
    assert np.abs(tsde.diffusion(_t(t)).numpy() - np.asarray(jsde.diffusion(jt))).max() < 1e-7
    mean, std = tsde.marginal_prob(_t(x0), _t(t), _t(y))
    jmean, jstd = jsde.marginal_prob(jnp.asarray(x0), jt, jnp.asarray(y))
    assert np.abs(mean.numpy() - np.asarray(jmean)).max() < 1e-6
    assert np.abs(std.numpy() - np.asarray(jstd)).max() < 1e-7
    assert np.array_equal(tsde.drift(_t(x0), _t(t), _t(y)).numpy(),
                          np.asarray(jsde.drift(jnp.asarray(x0), jt, jnp.asarray(y))))
    key = jax.random.PRNGKey(5)
    jx, jz = jsde.prior_sampling(key, jnp.asarray(y))
    x, z = tsde.prior_sampling(_t(y), z=_t(np.asarray(jz)))
    assert np.array_equal(z.numpy(), np.asarray(jz))
    assert np.abs(x.numpy() - np.asarray(jx)).max() < 1e-6
    # a drawn prior: the generator's draw, at the SDE's std(T)
    gx, gz = tsde.prior_sampling(_t(y), generator=torch.Generator().manual_seed(0))
    assert np.abs((gx - _t(y)).numpy() - (tsde.std(torch.ones(1)) * gz).numpy()).max() < 1e-6


def test_score_fn_matches_jax(setup):
    params, model = setup
    rng = np.random.default_rng(2)
    shape = (B, 11, 129)
    x = (0.3 * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))).astype(np.complex64)
    y = (0.3 * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))).astype(np.complex64)
    t = np.array([0.9, 0.2], np.float32)
    ref = jsg.score_fn(params, JCFG, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y), FS)
    with torch.no_grad():
        got = tsg.score_fn(model, TCFG, _t(x), _t(t), _t(y), FS)
    assert np.abs(got.numpy() - np.asarray(ref)).max() < FWD_ATOL


def _loss_draws(key, x0_shape):
    """t and z as JAX's ``sgmse_loss`` draws them from ``key``."""
    kt, kz = jax.random.split(key)
    t = jax.random.uniform(kt, (x0_shape[0],), jnp.float32) * (1.0 - JCFG.t_eps) + JCFG.t_eps
    return np.asarray(t), np.asarray(jcnormal(kz, jnp.zeros(x0_shape, jnp.complex64)))


@pytest.mark.parametrize("weighting", [True, False], ids=["likelihood", "unweighted"])
def test_sgmse_loss_and_grads_match_jax(setup, weighting):
    params, _ = setup
    jcfg = dataclasses.replace(JCFG, likelihood_weighting=weighting)
    tcfg = dataclasses.replace(TCFG, likelihood_weighting=weighting)
    clean, noisy = _waves(3)
    key = jax.random.PRNGKey(7)
    x0_shape = jdsp.stft_encode(jnp.asarray(clean), FS, jcfg.stft_cfg).shape
    t, z = _loss_draws(key, x0_shape)

    def jloss(p):
        return jsg.sgmse_loss(p, jcfg, key, jnp.asarray(clean), jnp.asarray(noisy), FS)

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(params)
    model = from_jax_params(params)
    loss = tsg.sgmse_loss(model, tcfg, _t(clean), _t(noisy), FS, t=_t(t), z=_t(z))
    loss.backward()
    assert _rel(loss.detach(), ref_loss) < LOSS_RTOL
    ref = _leaves(jax.tree.map(np.asarray, ref_grads))
    for name, p in model.named_parameters():
        parts = name.split(".")
        r = (ref["layers." + ".".join(parts[2:])][int(parts[1])] if parts[0] == "layers"
             else ref[name])
        if np.abs(r).max() == 0:
            assert float(p.grad.abs().max()) == 0.0, name
        else:
            assert _rel(p.grad, r) < GRAD_RTOL, name


def _spec_err(wav, ref) -> float:
    """max |d| between the compressed spectra of two waveforms: the domain
    the sampler works in, where FWD_ATOL applies (the decode raises each
    magnitude to the power 1 / 0.667 after dividing by 0.065, so a random
    network's samples reach waveform values in the hundreds)."""
    enc = tdsp.stft_encode(torch.stack([torch.as_tensor(wav), torch.from_numpy(np.array(ref))]), FS,
                           TCFG.stft_cfg)
    return float((enc[0] - enc[1]).abs().max())


def _enhance_draws(key, spec_shape, N, corrector_steps):
    """The prior z and every step's noises as JAX's ``sgmse_enhance`` draws
    them from ``key``."""
    k0, key = jax.random.split(key)
    zeros = jnp.zeros(spec_shape, jnp.complex64)
    prior = np.asarray(jcnormal(k0, zeros))
    steps = []
    for _ in range(N):
        draws = []
        for _ in range(corrector_steps + 1):  # the corrections, then the prediction
            key, kz = jax.random.split(key)
            draws.append(_t(np.asarray(jcnormal(kz, zeros))))
        steps.append(draws)
    return prior, steps


@pytest.mark.parametrize("corrector_steps", [1, 2])
def test_sgmse_enhance_matches_jax(setup, corrector_steps):
    params, model = setup
    _, noisy = _waves(4)
    key = jax.random.PRNGKey(11)
    spec_shape = jdsp.stft_encode(jnp.asarray(noisy), FS, JCFG.stft_cfg).shape
    prior, steps = _enhance_draws(key, spec_shape, 3, corrector_steps)
    ref = jsg.sgmse_enhance(params, JCFG, key, jnp.asarray(noisy), FS, N=3,
                            corrector_steps=corrector_steps)
    got = tsg.sgmse_enhance(model, TCFG, _t(noisy), FS, N=3, corrector_steps=corrector_steps,
                            prior_z=_t(prior), noises=steps)
    ref = np.asarray(ref)
    assert got.shape == ref.shape == noisy.shape
    assert _spec_err(got, ref) < FWD_ATOL
    assert _rel(got, ref) < WAVE_RTOL
    # a control: one step's corrector noise left out moves the sample past it
    dropped = [list(s) for s in steps]
    dropped[1][0] = torch.zeros_like(dropped[1][0])
    other = tsg.sgmse_enhance(model, TCFG, _t(noisy), FS, N=3, corrector_steps=corrector_steps,
                              prior_z=_t(prior), noises=dropped)
    assert _spec_err(other, ref) > 10 * FWD_ATOL and _rel(other, ref) > 10 * WAVE_RTOL


def test_sgmse_enhance_draws_from_its_generator(setup):
    _, model = setup
    _, noisy = _waves(5)
    runs = [tsg.sgmse_enhance(model, TCFG, _t(noisy), FS, N=2,
                              generator=torch.Generator().manual_seed(s)) for s in (0, 0, 1)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    assert bool(torch.isfinite(runs[0]).all())


def test_init_sgmse_is_on_the_card_unless_the_cpu_is_asked_for(setup):
    params, _ = setup
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tsg.init_sgmse(TCFG)
    model = tsg.init_sgmse(TCFG, seed=3, device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    # the flow family's network at this width: the bridge's keys and shapes
    ref = from_jax_params(params).state_dict()
    got = model.state_dict()
    assert got.keys() == ref.keys()
    assert all(got[k].shape == ref[k].shape for k in ref)
