"""The port's causal streaming runtime against the JAX package's, on the CPU
at the JAX tests' tiny causal size (16 channels x 2 layers, 16 and 22.05
kHz), float32.

The JAX side runs its scan recurrences (``use_pallas_lstm`` False); the
port runs the plain versions of its kernels (K2 with its carry).  Both get
the same parameter tree (``from_jax_params``) and the same numpy inputs.
Tolerances: the cumulative norm 1e-5 and the carried LSTM 1e-6 absolute
(one op of f32 arithmetic apart); the causal forward 2e-4 absolute, as
``test_torch_bsrnn.py``; the stream against the port's own offline forward
rtol 1e-4 / atol 2e-5, JAX's streaming tolerance
(``tests/test_streaming_causal.py``); a causal train step's loss and
gradients with ``test_torch_trainer.py``'s 1e-5 and 1e-4 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from urgent2026_challenge_track1_tpu.dsp import stft as jdsp
from urgent2026_challenge_track1_tpu.models import bsrnn as jbsrnn
from urgent2026_challenge_track1_tpu.models import streaming_causal as jsc
from urgent2026_challenge_track1_tpu.ops import lstm as jlstm
from urgent2026_challenge_track1_tpu.ops import norms as jnorms
from urgent2026_challenge_track1_tpu.train import losses as jlosses
from urgent2026_challenge_track1_tpu_torch.config import Config
from urgent2026_challenge_track1_tpu_torch.dsp.stft import STFTConfig
from urgent2026_challenge_track1_tpu_torch.models import bsrnn as tbsrnn
from urgent2026_challenge_track1_tpu_torch.models import streaming_causal as tsc
from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm
from urgent2026_challenge_track1_tpu_torch.ops import lstm as tlstm
from urgent2026_challenge_track1_tpu_torch.ops import norms as tnorms
from urgent2026_challenge_track1_tpu_torch.train import trainer as ttrainer
from urgent2026_challenge_track1_tpu_torch.utils import checkpoint as tckpt
from urgent2026_challenge_track1_tpu_torch.utils.params import from_jax_params

torch.set_num_threads(1)
ATOL = 2e-4
JSTFT, TSTFT = jdsp.STFTConfig(n_fft=960, hop_length=480), STFTConfig(n_fft=960, hop_length=480)


@pytest.fixture(scope="module")
def tiny_causal():
    cfg = jbsrnn.BSRNNConfig(input_dim=481, num_channel=16, num_layer=2, causal=True,
                             streaming_norm=True, remat=False)
    params = jbsrnn.init_bsrnn(jax.random.PRNGKey(5), cfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), streaming_norm=True).eval()
    return cfg, params, model


# ---------------------------------------------------------------------------
# cumulative_group_norm and the carried LSTM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["full", "chunked", "masked"])
def test_cumulative_group_norm_matches_jax(case):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 12, 3, 4)).astype(np.float32)
    s = (1.0 + 0.3 * rng.standard_normal(4)).astype(np.float32)
    b = (0.2 * rng.standard_normal(4)).astype(np.float32)
    mask = None
    if case == "masked":
        mask = (rng.random((1, 1, 3, 4)) > 0.3).astype(np.float32)
    ref = jnorms.cumulative_group_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
                                       axes=(2, 3), mask=None if mask is None
                                       else jnp.asarray(mask))
    tm = None if mask is None else torch.from_numpy(mask)
    if case != "chunked":
        got = tnorms.cumulative_group_norm(torch.from_numpy(x), torch.from_numpy(s),
                                           torch.from_numpy(b), axes=(2, 3), mask=tm)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
        return
    jstate = tuple(jnp.zeros((2, 1, 1, 1)) for _ in range(3))
    tstate = tuple(torch.zeros((2, 1, 1, 1)) for _ in range(3))
    outs = []
    for lo, hi in ((0, 5), (5, 9), (9, 12)):
        _, jstate = jnorms.cumulative_group_norm(jnp.asarray(x[:, lo:hi]), jnp.asarray(s),
                                                 jnp.asarray(b), axes=(2, 3), state=jstate)
        y, tstate = tnorms.cumulative_group_norm(torch.from_numpy(x[:, lo:hi]),
                                                 torch.from_numpy(s), torch.from_numpy(b),
                                                 axes=(2, 3), state=tstate)
        outs.append(y.numpy())
        for a, r in zip(tstate, jstate):
            np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(np.concatenate(outs, axis=1), np.asarray(ref), atol=1e-5, rtol=0)


def test_lstm_carry_matches_jax_and_one_call():
    rng = np.random.default_rng(4)
    N, H, T = 6, 10, 9
    jp = jlstm.init_lstm(jax.random.PRNGKey(1), N, H)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = rng.standard_normal((3, T, N)).astype(np.float32)
    h0 = (0.5 * rng.standard_normal((3, H))).astype(np.float32)
    c0 = (0.5 * rng.standard_normal((3, H))).astype(np.float32)
    ref, (rh, rc) = jlstm.lstm(jp, jnp.asarray(x), initial_state=(jnp.asarray(h0),
                                                                  jnp.asarray(c0)),
                               return_state=True)
    cuda_lstm.reset_launch_counts()
    state = (torch.from_numpy(h0), torch.from_numpy(c0))
    outs = []
    for lo, hi in ((0, 4), (4, 5), (5, 9)):
        y, state = tlstm.lstm(tp, torch.from_numpy(x[:, lo:hi]), initial_state=state,
                              return_state=True)
        outs.append(y.numpy())
    assert cuda_lstm.launch_counts()["lstm_scan"] == 0  # plain versions on the CPU
    np.testing.assert_allclose(np.concatenate(outs, axis=1), np.asarray(ref), atol=1e-6, rtol=0)
    np.testing.assert_allclose(state[0].numpy(), np.asarray(rh), atol=1e-6, rtol=0)
    np.testing.assert_allclose(state[1].numpy(), np.asarray(rc), atol=1e-6, rtol=0)
    # no carry in: the same as the call without a carry
    full, (fh, _) = tlstm.lstm(tp, torch.from_numpy(x), return_state=True)
    np.testing.assert_array_equal(full.numpy(), tlstm.lstm(tp, torch.from_numpy(x)).numpy())
    np.testing.assert_array_equal(fh.numpy(), full[:, -1].numpy())


# ---------------------------------------------------------------------------
# the causal model, offline and streamed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("streaming_norm", [False, True])
@pytest.mark.parametrize("fs", [16000, 22050])
def test_causal_bsrnn_se_apply_matches_jax(fs, streaming_norm):
    cfg = jbsrnn.BSRNNConfig(input_dim=481, num_channel=16, num_layer=2, causal=True,
                             streaming_norm=streaming_norm, remat=False)
    params = jbsrnn.init_bsrnn(jax.random.PRNGKey(2), cfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), streaming_norm=streaming_norm)
    assert model.cfg.causal and model.cfg.streaming_norm == streaming_norm
    assert "w_ih_reverse" not in dict(model.layers[0].rnn_time)
    rng = np.random.default_rng(fs)
    T = fs // 2
    x = (0.1 * rng.standard_normal((2, T))).astype(np.float32)
    lengths = np.array([T, T - fs // 7], np.int32)
    ref, _ = jax.jit(lambda p, w, n: jbsrnn.bsrnn_se_apply(p, cfg, JSTFT, w, fs, lengths=n))(
        params, jnp.asarray(x), jnp.asarray(lengths))
    with torch.inference_mode():
        got, _ = tbsrnn.bsrnn_se_apply(model, TSTFT, torch.from_numpy(x), fs,
                                       torch.from_numpy(lengths))
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(got.numpy()[b, :n], np.asarray(ref)[b, :n], atol=ATOL, rtol=0)


def test_init_model_states_match_jax(tiny_causal):
    cfg, params, model = tiny_causal
    ref = jax.tree.map(np.asarray, jsc.init_model_states(params, cfg, 2, 20))
    got = tsc.init_model_states(model, model.cfg, 2, 20)
    flat_r, tree_r = jax.tree.flatten(ref)
    flat_g = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), got))
    assert len(flat_r) == len(flat_g)
    for r, g in zip(flat_r, flat_g):
        assert r.shape == g.shape and r.dtype == g.dtype and not g.any()


@pytest.mark.parametrize("fs, chunk_frames, feeds", [
    (16000, 2, (161, 200, 319)),   # the priming window: chunk 320, pad 160
    (22050, 3, (1000,)),           # n_fft 441, hop 220
])
def test_streaming_session_matches_jax_and_offline(tiny_causal, fs, chunk_frames, feeds):
    cfg, params, model = tiny_causal
    rng = np.random.default_rng(chunk_frames)
    L = 6000 if fs == 16000 else 13011
    noisy = (0.1 * rng.standard_normal((1, L))).astype(np.float32)
    with torch.inference_mode():
        offline, _ = tbsrnn.bsrnn_se_apply(model, TSTFT, torch.from_numpy(noisy), fs)
    offline = offline.numpy()
    for feed in feeds:
        ref = jsc.StreamingSession(params, cfg, JSTFT, fs, chunk_frames=chunk_frames).process(
            noisy, feed_size=feed)
        got = tsc.StreamingSession(model, model.cfg, TSTFT, fs,
                                   chunk_frames=chunk_frames).process(noisy, feed_size=feed)
        assert got.shape == noisy.shape
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0, err_msg=f"feed {feed}")
        np.testing.assert_allclose(got, offline, rtol=1e-4, atol=2e-5, err_msg=f"feed {feed}")


def test_streaming_session_feed_and_flush_contract(tiny_causal):
    _, _, model = tiny_causal
    sess = tsc.StreamingSession(model, model.cfg, TSTFT, 16000, chunk_frames=2)
    assert sess.latency_samples == 2 * 160 + 160  # two hops and the center pad at 16 kHz
    assert sess.feed(np.zeros((1, 100), np.float32)).shape == (1, 0)  # priming
    with pytest.raises(ValueError, match="batch"):
        sess.feed(np.zeros((2, 10), np.float32))
    with pytest.raises(ValueError, match="too short"):
        sess.flush()
    with pytest.raises(RuntimeError, match="flushed"):
        sess.feed(np.zeros((1, 10), np.float32))
    with pytest.raises(ValueError, match="streaming requires"):
        tsc.make_streaming_step(dataclasses.replace(model.cfg, streaming_norm=False), TSTFT,
                                16000)


# ---------------------------------------------------------------------------
# training and checkpoints
# ---------------------------------------------------------------------------


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30))


def test_causal_train_step_loss_and_grads_match_jax():
    """One causal streaming_norm train step (remat on) from the same
    parameters: the loss within 1e-5 and every gradient leaf within 1e-4
    relative of ``jax.value_and_grad``; the time path trains through
    LSTMDirTrain (K4/K5's plain versions here)."""
    fs, T = 8000, 4000
    mc = {"num_channel": 8, "num_layer": 2, "causal": True, "streaming_norm": True}
    bundle = ttrainer.build_model(Config(model_configs=mc, device="cpu"))
    assert bundle.model_cfg.causal and bundle.model_cfg.streaming_norm and bundle.model_cfg.remat
    # remat changes nothing in the JAX gradients, and compiles faster without
    jcfg = jbsrnn.BSRNNConfig(input_dim=481, num_channel=8, num_layer=2, causal=True,
                              streaming_norm=True, remat=False)
    params = jbsrnn.init_bsrnn(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(1)
    clean = (0.2 * rng.standard_normal((2, T))).astype(np.float32)
    noisy = (clean + 0.1 * rng.standard_normal((2, T))).astype(np.float32)
    lengths = np.array([T, 3100], np.int32)
    noisy[1, 3100:] = clean[1, 3100:] = 0.0

    def jloss_fn(p, c, n, ln):
        wav, _ = jbsrnn.bsrnn_se_apply(p, jcfg, JSTFT, n, fs, lengths=ln)
        return jlosses.multi_res_l1_spec_loss(c, wav, ln).mean()

    jloss, jgrads = jax.jit(jax.value_and_grad(jloss_fn))(
        params, jnp.asarray(clean), jnp.asarray(noisy), jnp.asarray(lengths))
    model = from_jax_params(jax.tree.map(np.asarray, params), streaming_norm=True)
    assert dataclasses.replace(model.cfg, remat=True) == bundle.model_cfg
    loss, _ = ttrainer.loss_and_metrics(bundle, fs, model, torch.from_numpy(clean),
                                         torch.from_numpy(noisy), torch.from_numpy(lengths))
    loss.backward()
    assert _rel(loss.detach(), jloss) < 1e-5
    ref = _flat(jax.tree.map(np.asarray, jgrads))
    for key, p in model.named_parameters():
        parts = key.split(".")
        r = (ref["layers." + ".".join(parts[2:])][int(parts[1])] if parts[0] == "layers"
             else ref[key])
        if np.abs(r).max() == 0:
            assert float(p.grad.abs().max()) == 0.0, key
        else:
            assert _rel(p.grad, r) < 1e-4, key


def test_causal_checkpoint_keeps_its_architecture(tiny_causal, tmp_path):
    _, _, model = tiny_causal
    path = tckpt.save_model(str(tmp_path / "causal.pt"), model, TSTFT)
    kind, loaded, cfg, stft = tckpt.load_model_for_inference(path, device="cpu")
    assert kind == "discriminative" and cfg.causal and cfg.streaming_norm
    assert stft == TSTFT and cfg.compute_dtype == "float32"
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


def test_causal_reference_state_dict_converts_as_jax(tiny_causal):
    """A causal reference state dict (the JAX exporter's: no ``_reverse``
    keys in ``rnn_time``) converts with ``not cfg.causal`` into the JAX
    tree, leaf for leaf, and the tree into a causal model."""
    from urgent2026_challenge_track1_tpu.utils import export_torch as jexport
    from urgent2026_challenge_track1_tpu_torch.utils import convert as tconvert

    cfg, params, model = tiny_causal
    sd = jexport.export_discriminative_state_dict(params, cfg)
    assert not any("rnn_time" in k and "_reverse" in k for k in sd)
    tree = tconvert.convert_discriminative_state_dict(sd, model.cfg)
    ref = jax.tree.map(np.asarray, params)
    flat_r, tree_r = jax.tree.flatten(ref)
    flat_g, tree_g = jax.tree.flatten(tree)
    assert tree_r == tree_g
    for r, g in zip(flat_r, flat_g):
        np.testing.assert_array_equal(np.asarray(g), r)
    assert from_jax_params(tree, streaming_norm=True).cfg == model.cfg
