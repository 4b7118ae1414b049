"""The port's flow-matching family against the JAX package's, on the CPU at a
tiny configuration (16 channels x 2 layers, n_fft 960 / hop 480 as
``tests/test_flowse.py``, 8-16 kHz, at most 0.5 s, float32):

* the conditional BSRNN's vector field, with and without frame counts;
* ``flowse_loss``: value and gradients, the CFM noise and t injected;
* ``sample_flow`` with each solver and ``flowse_enhance`` with and without
  lengths, the prior taken from the JAX ``FlowMatching.prior_sampling``;
* a 5-step flow training trajectory (losses, parameters, EMA, the frozen
  ``t_proj_w``) against the JAX trainer's step (``_step_core``, AdamW,
  clipping, EMA), each step's gradients fresh (two steps from one state
  equal), and the port's ``Trainer`` on a toy set with validation,
  checkpoints and a resume;
* a FlowSE ``.ckpt`` (with EMA) converted by both packages.

Tolerances: forward outputs and samples 2e-4 absolute (f32; the
``PARITY.md`` precedent); the loss 1e-5 relative and one step's gradients
1e-4 relative per leaf, as max|d| / max|reference| (f32, other summation
orders through two stacked recurrences); the 5-step trajectory's losses
1e-3 relative and its parameters and EMA 1e-3 absolute."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from urgent2026_challenge_track1_tpu.config import Config as JConfig
from urgent2026_challenge_track1_tpu.dsp import stft as jdsp
from urgent2026_challenge_track1_tpu.models import bsrnn_flowse as jflow
from urgent2026_challenge_track1_tpu.sampling import sample_flow as jsample_flow
from urgent2026_challenge_track1_tpu.train import trainer as jtrainer
from urgent2026_challenge_track1_tpu.utils import checkpoint as jckpt
from urgent2026_challenge_track1_tpu.utils.export_torch import save_lightning_ckpt
from urgent2026_challenge_track1_tpu_torch.config import Config
from urgent2026_challenge_track1_tpu_torch.dsp import stft as tdsp
from urgent2026_challenge_track1_tpu_torch.models import bsrnn_flowse as tflow
from urgent2026_challenge_track1_tpu_torch.sampling import get_white_box_solver, sample_flow
from urgent2026_challenge_track1_tpu_torch.train import trainer as ttrainer
from urgent2026_challenge_track1_tpu_torch.utils import checkpoint as tckpt
from urgent2026_challenge_track1_tpu_torch.utils.params import from_jax_params, to_numpy_tree

torch.set_num_threads(1)
FWD_ATOL, LOSS_RTOL, GRAD_RTOL = 2e-4, 1e-5, 1e-4
TRAJ_LOSS_RTOL, TRAJ_ATOL, TRAJ_GNORM_RTOL = 1e-3, 1e-3, 1e-5
JCFG = jflow.FlowSEConfig(n_fft=960, hop_length=480, bsrnn_hidden=16, num_layer=2)
TCFG = tflow.FlowSEConfig(n_fft=960, hop_length=480, bsrnn_hidden=16, num_layer=2)
FS, T, B = 16000, 8000, 2
N_FFT, _, HOP = TCFG.stft_cfg.geometry(FS)
SPEC = (B, T // HOP + 1, N_FFT // 2 + 1)  # the STFT of a (B, T) batch
KEY = jax.random.PRNGKey(0)  # split but unused by flowse_loss when noise and t are given


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


def _waves(seed, n=T, fs=FS):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    clean = (0.3 * np.sin(2 * np.pi * rng.uniform(150, 400) * t)[None]
             + 0.05 * rng.standard_normal((B, n))).astype(np.float32)
    noisy = (clean + 0.1 * rng.standard_normal((B, n))).astype(np.float32)
    lengths = np.array([n, int(0.7 * n)], np.int32)
    clean[1, lengths[1]:] = 0.0
    noisy[1, lengths[1]:] = 0.0
    return clean, noisy, lengths


def _spec_pair(seed, frames=17, bins=161):
    rng = np.random.default_rng(seed)
    shape = (B, frames, bins)
    x = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    y = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return 0.3 * x, 0.3 * y


@pytest.fixture(scope="module")
def setup():
    params = jax.tree.map(np.asarray, jflow.init_flowse(jax.random.PRNGKey(0), JCFG))
    return params, from_jax_params(params)


@pytest.mark.parametrize("with_frames", [False, True], ids=["full", "frames"])
def test_vector_field_matches_jax(setup, with_frames):
    params, model = setup
    x, y = _spec_pair(1)
    t = np.array([0.9, 0.35], np.float32)
    frames = np.array([17, 12], np.int32) if with_frames else None
    ref = jflow.vector_field(params, JCFG, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y), FS,
                             None if frames is None else jnp.asarray(frames))
    with torch.no_grad():
        got = tflow.vector_field(model, _t(x), _t(t), _t(y), FS,
                                 None if frames is None else _t(frames))
    ref = np.asarray(ref)
    if with_frames:  # padded frames are unspecified
        got, ref = got[1, :12], ref[1, :12]
    assert np.abs(got.numpy() - ref).max() < FWD_ATOL


def _cfm_draws(seed, x_shape):
    rng = np.random.default_rng(seed)
    noise = ((rng.standard_normal(x_shape) + 1j * rng.standard_normal(x_shape))
             * np.sqrt(0.5)).astype(np.complex64)
    return noise, rng.uniform(0.03, 1.0, (x_shape[0],)).astype(np.float32)


def test_flowse_loss_value_and_grads_match_jax(setup):
    params, _ = setup
    clean, noisy, lengths = _waves(2)
    noise, t = _cfm_draws(3, SPEC)

    def jloss(p):
        return jflow.flowse_loss(p, JCFG, KEY, jnp.asarray(clean), jnp.asarray(noisy), FS,
                                 lengths=jnp.asarray(lengths), noise=jnp.asarray(noise),
                                 t=jnp.asarray(t))

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(params)
    model = from_jax_params(params)
    loss = tflow.flowse_loss(model, TCFG, _t(clean), _t(noisy), FS, _t(lengths),
                             noise=_t(noise), t=_t(t))
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


@pytest.mark.parametrize("solver", ["euler", "midpoint", "heun"])
def test_sample_flow_matches_jax(setup, solver):
    params, model = setup
    _, y = _spec_pair(4)
    key = jax.random.PRNGKey(5)
    prior, _ = JCFG.ode.prior_sampling(key, jnp.asarray(y))

    def jvf(x, t, y_):
        return jflow.vector_field(params, JCFG, x, t, y_, FS)

    ref, nfe = jsample_flow(jvf, JCFG.ode, key, jnp.asarray(y), solver=solver, N=3)
    with torch.no_grad():
        got, tnfe = sample_flow(lambda x, t, y_: tflow.vector_field(model, x, t, y_, FS),
                                TCFG.ode, _t(y), solver=solver, N=3, x0=_t(prior))
    assert tnfe == nfe
    assert np.abs(got.numpy() - np.asarray(ref)).max() < FWD_ATOL
    if solver == "euler":  # the reference-signature factory runs the same loop
        with torch.no_grad():
            run = get_white_box_solver(solver, TCFG.ode, lambda x, t, y_: tflow.vector_field(
                model, x, t, y_, FS), _t(y), N=3)
            again, steps = run(x0=_t(prior))
        assert steps == 3 and torch.equal(again, got)


@pytest.mark.parametrize("with_lengths", [False, True], ids=["full", "lengths"])
def test_flowse_enhance_matches_jax(setup, with_lengths):
    params, model = setup
    _, noisy, lengths = _waves(6)
    if not with_lengths:
        noisy, lengths = noisy[:1], None
    key = jax.random.PRNGKey(7)
    ref = jflow.flowse_enhance(params, JCFG, key, jnp.asarray(noisy), FS, N=4,
                               lengths=None if lengths is None else jnp.asarray(lengths))
    # the prior JAX draws inside: prior_sampling(key, y) of the scaled input
    scaled = noisy * (0.9 / np.maximum(np.abs(noisy).max(-1, keepdims=True), 1e-6))
    x = jnp.asarray(scaled)
    if lengths is not None:
        x = jdsp.reflect_tail(x, jnp.asarray(lengths), N_FFT // 2)
    y = jdsp.stft_encode(x, FS, JCFG.stft_cfg)
    prior, _ = JCFG.ode.prior_sampling(key, y)
    with torch.no_grad():
        got = tflow.flowse_enhance(model, TCFG, _t(noisy), FS, N=4,
                                   lengths=None if lengths is None else _t(lengths),
                                   x0=_t(prior))
    assert got.shape == noisy.shape
    assert np.abs(got.numpy() - np.asarray(ref)).max() < FWD_ATOL
    if lengths is not None:
        assert float(got[1, lengths[1]:].abs().max()) == 0.0


def test_flow_training_trajectory_matches_jax(setup):
    """5 steps of AdamW + clipping + EMA from the same parameters, fed the
    same batches, noise and t."""
    params, _ = setup
    jcfg = JConfig(model_type="flowse", n_fft=960, hop_length=480, bsrnn_hidden=16,
                   num_layer=2, use_pallas_lstm="false")
    optimizer = jtrainer.make_optimizer(jcfg)

    def loss_and_metrics(p, draws, clean, noisy, lengths):
        noise, t = draws
        return jflow.flowse_loss(p, JCFG, KEY, clean, noisy, FS, lengths=lengths,
                                 noise=noise, t=t), {}

    core = jax.jit(jtrainer._step_core(loss_and_metrics, optimizer, jcfg.ema_decay))
    jp = jax.tree.map(jnp.asarray, params)
    jopt, jema = optimizer.init(jp), jax.tree.map(jnp.copy, jp)

    cfg = Config(model_type="flowse", n_fft=960, hop_length=480, bsrnn_hidden=16,
                 num_layer=2, device="cpu")
    bundle = ttrainer.build_model(cfg)
    assert bundle.model_cfg == TCFG
    model = from_jax_params(params)
    ema = from_jax_params(params).requires_grad_(False)
    opt = ttrainer.make_optimizer(cfg, model)
    step = ttrainer.make_train_step(bundle, cfg, FS)
    for i in range(5):
        clean, noisy, lengths = _waves(10 + i)
        noise, t = _cfm_draws(20 + i, SPEC)
        jp, jopt, jema, jm = core(jp, jopt, jema, (jnp.asarray(noise), jnp.asarray(t)),
                                  jnp.asarray(clean), jnp.asarray(noisy), jnp.asarray(lengths))
        m = step(model, opt, _t(clean), _t(noisy), _t(lengths), ema=ema, noise=_t(noise),
                 t=_t(t))
        assert _rel(m["loss"], jm["loss"]) < TRAJ_LOSS_RTOL, i
        assert _rel(m["grad_norm"], jm["grad_norm"]) < TRAJ_GNORM_RTOL, i
    for mine, ref in ((model, jp), (ema, jema)):
        got, want = _leaves(to_numpy_tree(mine)), _leaves(jax.tree.map(np.asarray, ref))
        assert got.keys() == want.keys()
        for k in want:
            assert np.abs(got[k] - want[k]).max() < TRAJ_ATOL, k
    frozen = _leaves(params)["layers.t_proj_w"]
    np.testing.assert_array_equal(_leaves(to_numpy_tree(model))["layers.t_proj_w"], frozen)
    np.testing.assert_array_equal(np.asarray(jp["layers"]["t_proj_w"]), frozen)
    moved = _leaves(to_numpy_tree(model))["layers.fc_time_w"] - _leaves(params)["layers.fc_time_w"]
    assert np.abs(moved).max() > 1e-3  # the trained leaves did move


def test_flow_step_starts_from_zero_gradients(setup):
    """The frozen ``t_proj_w``, which AdamW does not hold, gets a fresh
    gradient every step, as jax.grad gives it: two steps from the same
    state on the same batch leave the same gradients and grad norm (a
    gradient summed over steps would grow the norm that clips every
    update)."""
    params, _ = setup
    cfg = Config(model_type="flowse", n_fft=960, hop_length=480, bsrnn_hidden=16,
                 num_layer=2, device="cpu")
    bundle = ttrainer.build_model(cfg)
    model = from_jax_params(params)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    step = ttrainer.make_train_step(bundle, cfg, FS)
    clean, noisy, lengths = _waves(30)
    noise, t = _cfm_draws(31, SPEC)
    runs = []
    for _ in range(2):
        model.load_state_dict(init)
        m = step(model, ttrainer.make_optimizer(cfg, model), _t(clean), _t(noisy), _t(lengths),
                 noise=_t(noise), t=_t(t))
        runs.append((float(m["grad_norm"]),
                     {n: p.grad.clone() for n, p in model.named_parameters()}))
    assert runs[0][0] == runs[1][0]
    for name, g in runs[0][1].items():
        assert torch.equal(g, runs[1][1][name]), name


def _write_split(root, seconds, seed, fs=8000):
    from urgent2026_challenge_track1_tpu_torch.utils import audio_io

    root.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    lines = {k: [] for k in ("spk1.scp", "wav.scp", "utt2fs", "speech_length.scp")}
    for i, sec in enumerate(seconds):
        n = int(sec * fs)
        clean = 0.3 * np.sin(2 * np.pi * rng.uniform(150, 400) * np.arange(n) / fs)
        noisy = clean + 0.1 * rng.standard_normal(n)
        uid = f"{root.name}{i:02d}"
        for name, wav in (("spk1.scp", clean), ("wav.scp", noisy)):
            path = root / f"{uid}_{name[:3]}.wav"
            audio_io.write(str(path), wav, fs)
            lines[name].append(f"{uid} {path}")
        lines["utt2fs"].append(f"{uid} {fs}")
        lines["speech_length.scp"].append(f"{uid} {n}")
    for name, ls in lines.items():
        (root / name).write_text("\n".join(ls) + "\n")


def test_flow_trainer_validates_saves_and_resumes(tmp_path, monkeypatch):
    """``train_se.run`` with model_type=flowse: EMA differs from the params,
    validation logs the sampler's SI-SNR, a resume continues at the saved
    step, and the inference loader reads the saved checkpoint's EMA."""
    from urgent2026_challenge_track1_tpu_torch import train_se

    _write_split(tmp_path / "train", (0.5, 0.45, 0.4, 0.35), 1)
    _write_split(tmp_path / "valid", (0.5, 0.4), 2)
    monkeypatch.chdir(tmp_path)
    kw = dict(model_type="flowse", n_fft=960, hop_length=480, bsrnn_hidden=8, num_layer=1,
              train_set_path=str(tmp_path / "train"), valid_set_path=str(tmp_path / "valid"),
              train_set_dynamic_mixing=False, batch_size=2, num_worker=1, device="cpu",
              num_train_epochs=1, val_check_interval=2, log_every_steps=1, seed=3,
              train_tag="t", train_name="flow")
    state = train_se.run(Config(**kw))
    assert (state.step, state.epoch) == (2, 1)
    sd, ema = state.model.state_dict(), state.ema.state_dict()
    assert not torch.equal(sd["layers.0.fc_time_w"], ema["layers.0.fc_time_w"])
    init = ttrainer.init_params(3, ttrainer.build_model(Config(**kw)), "cpu").state_dict()
    assert torch.equal(sd["layers.0.t_proj_w"], init["layers.0.t_proj_w"])
    assert not torch.equal(ema["layers.0.fc_time_w"], init["layers.0.fc_time_w"])
    exp = tmp_path / "exp" / "t" / "flow" / "version_0"
    recs = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
    val = [r for r in recs if "val_loss" in r]
    assert len(val) == 1 and np.isfinite(val[0]["val_sisnr"]) and "val_sisnr_8000" in val[0]
    resumed = train_se.run(Config(**{**kw, "num_train_epochs": 2}))
    assert (resumed.step, resumed.epoch) == (4, 2)
    kind, loaded, fcfg, _ = tckpt.load_model_for_inference(
        str(exp / "checkpoints" / "step_4.pt"), device="cpu")
    assert kind == "flowse" and fcfg.bsrnn_hidden == 8
    for k, v in resumed.ema.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


def test_flowse_ckpt_converted_by_both_packages(tmp_path):
    cfg = jflow.FlowSEConfig(bsrnn_hidden=8, num_layer=2)  # n_fft 1536: 48 bands
    params = jflow.init_flowse(jax.random.PRNGKey(8), cfg)
    ema = jax.tree.map(lambda a: a + 0.01, params)
    ema["layers"]["t_proj_w"] = params["layers"]["t_proj_w"]  # frozen: no EMA record
    path = tmp_path / "flow.ckpt"
    save_lightning_ckpt(str(path), "flowse", params, cfg.dnn_cfg, ema_params=ema)
    jkind, jparams, _, _ = jckpt.load_model_for_inference(str(path))
    kind, model, fcfg, stft_cfg = tckpt.load_model_for_inference(str(path), device="cpu")
    assert kind == jkind == "flowse"
    assert dataclasses.replace(fcfg, compute_dtype="float32") == tflow.FlowSEConfig(
        bsrnn_hidden=8, num_layer=2)
    assert stft_cfg == tdsp.STFTConfig(n_fft=1536, hop_length=384,
                                       spec_transform_type="exponent",
                                       spec_abs_exponent=0.667, spec_factor=0.065)
    ref, got = _leaves(jparams), _leaves(to_numpy_tree(model))
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_array_equal(got["layers.fc_freq_b"], np.asarray(ema["layers"]["fc_freq_b"]))


def test_port_flow_file_keeps_the_ema(tmp_path):
    """``save_model`` of a flow model writes its config and EMA weights; the
    inference loader returns the EMA weights."""
    cfg = tflow.FlowSEConfig(n_fft=960, hop_length=480, bsrnn_hidden=4, num_layer=1)
    model, ema = (tflow.init_flowse(cfg, seed=1, device="cpu"),
                  tflow.init_flowse(cfg, seed=2, device="cpu"))
    path = tckpt.save_model(str(tmp_path / "flow.pt"), model, cfg.stft_cfg, flow_cfg=cfg,
                            ema=ema)
    kind, loaded, fcfg, stft_cfg = tckpt.load_model_for_inference(path, device="cpu")
    assert (kind, fcfg, stft_cfg) == ("flowse", cfg, cfg.stft_cfg)
    for k, v in ema.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
