"""The port's last three LSTM kernels (K8 ``lstm_train_fwd_streamin``, K9
``lstm_train_fwd2``, K10 ``lstm_train_bwd2``) in their plain versions, the
autograd Functions built on them (``LSTMDirStreamIn``, ``BiLSTMTrain``) and
the two experiment toggles, against the JAX package's Pallas kernels and
VJPs run in interpret mode with the JAX toggles set the same way.  CPU,
float32.  Each test sets the toggles of both packages and restores them.

The launch counts of one discriminative train step under each toggle
setting are checked here too, by counting the calls of the wrappers (which
take their plain versions on the CPU): one call per launch on the card.

Tolerances (scripts/check_pallas_tpu.py:29-34): forward max abs 2e-4;
gradients 1e-3 relative, as max|d| / max|reference| per tensor."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from urgent2026_challenge_track1_tpu.ops import lstm as jlstm
from urgent2026_challenge_track1_tpu.ops import pallas_lstm as jpl
from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm
from urgent2026_challenge_track1_tpu_torch.ops import lstm as tlstm

torch.set_num_threads(1)
FWD_ATOL, GRAD_RTOL = 2e-4, 1e-3
B, T, N, H = 6, 9, 16, 32
LENGTHS = np.array([1, T, 4, 7, T - 1, 2], np.int32)
TOGGLES = [(False, False), (True, False), (False, True), (True, True)]
TOGGLE_IDS = ["default", "stream", "fused", "both"]


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-12))


def _set_toggles(monkeypatch, stream, fused):
    for mod in (jpl, cuda_lstm):
        monkeypatch.setattr(mod, "STREAM_INPUT_TRAIN", stream)
        monkeypatch.setattr(mod, "FUSED_BIDIR_TRAIN", fused)


def _streamin_inputs(seed):
    rng = np.random.default_rng(seed)
    return ((0.5 * rng.standard_normal((B, T, N))).astype(np.float32),
            (0.2 * rng.standard_normal((N, 4 * H))).astype(np.float32),
            (0.2 * rng.standard_normal((4 * H,))).astype(np.float32),
            (0.2 * rng.standard_normal((H, 4 * H))).astype(np.float32),
            rng.standard_normal((B, T, H)).astype(np.float32))


def test_toggles_default_off_in_both_packages():
    assert (cuda_lstm.STREAM_INPUT_TRAIN, cuda_lstm.FUSED_BIDIR_TRAIN) == (False, False)
    assert (jpl.STREAM_INPUT_TRAIN, jpl.FUSED_BIDIR_TRAIN) == (False, False)


@pytest.mark.parametrize("reverse", [False, True])
def test_streamin_plain_matches_pallas(reverse):
    x, wi, b, wh, _ = _streamin_inputs(0)
    ref = jpl._train_forward_streamin(jnp.asarray(x), jnp.asarray(wi), jnp.asarray(b)[None],
                                      jnp.asarray(wh), reverse, 0, True)
    got = cuda_lstm.lstm_train_fwd_streamin(_t(x), _t(wi), _t(b), _t(wh), reverse)
    for g, r in zip(got, ref):  # h, gates, c; time-major in the Pallas kernel
        np.testing.assert_allclose(g.numpy(), np.swapaxes(np.asarray(r), 0, 1),
                                   atol=FWD_ATOL, rtol=0)


def test_fused_bidir_plain_match_pallas():
    rng = np.random.default_rng(1)
    xf, xb = (0.5 * rng.standard_normal((2, B, T, 4 * H))).astype(np.float32)
    wf, wb = (0.2 * rng.standard_normal((2, H, 4 * H))).astype(np.float32)
    df, db = rng.standard_normal((2, B, T, H)).astype(np.float32)
    ref = jpl._train_forward2(*map(jnp.asarray, (xf, xb, wf, wb)), 0, True)
    got = cuda_lstm.lstm_train_fwd2(_t(xf), _t(xb), _t(wf), _t(wb))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.swapaxes(np.asarray(r), 0, 1),
                                   atol=FWD_ATOL, rtol=0)
    res_f = tuple(ref[:3]) + (jnp.asarray(wf),)
    res_b = tuple(ref[3:]) + (jnp.asarray(wb),)
    ref_bwd = jpl._lstm_train_bwd2(res_f, res_b, jnp.asarray(df), jnp.asarray(db), 0, True)
    got_bwd = cuda_lstm.lstm_train_bwd2(got[:3], got[3:], _t(df), _t(db), _t(wf), _t(wb))
    for g, r in zip(got_bwd, ref_bwd):  # dxp_f, dW_f, dxp_b, dW_b
        assert _rel(g, r) < GRAD_RTOL
    # K9 and K10 are K4 and K5 per direction (bitwise on the card; the same
    # plain loops here)
    single = (*cuda_lstm.lstm_train_fwd(_t(xf), _t(wf), False),
              *cuda_lstm.lstm_train_fwd(_t(xb), _t(wb), True))
    assert all(torch.equal(a, s) for a, s in zip(got, single))


def test_lstm_dir_streamin_matches_pallas_vjp():
    x, wi, b, wh, dout = _streamin_inputs(2)
    args = tuple(map(jnp.asarray, (x, wi, b[None], wh)))
    ref, vjp = jax.vjp(lambda *a: jpl.lstm_dir_pallas_streamin(*a, 0, True), *args)
    ref_grads = vjp(jnp.asarray(dout))
    ins = [_t(a).requires_grad_() for a in (x, wi, b, wh)]
    out = cuda_lstm.lstm_dir_streamin(*ins)
    out.backward(_t(dout))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=FWD_ATOL, rtol=0)
    for g, r in zip(ins, ref_grads):  # dx, dW_ih^T, db, dW_hh^T
        assert _rel(g.grad, np.asarray(r).reshape(g.shape)) < GRAD_RTOL
    with torch.no_grad():  # without autograd the same K8 walk
        np.testing.assert_array_equal(cuda_lstm.lstm_dir_streamin(*ins).numpy(),
                                      out.detach().numpy())


def _lstm_params(seed):
    jp = jlstm.init_lstm(jax.random.PRNGKey(seed), N, H, bidirectional=True)
    return jp, {k: _t(v).requires_grad_() for k, v in jp.items()}


@pytest.mark.parametrize("stream,fused", TOGGLES, ids=TOGGLE_IDS)
def test_bilstm_train_matches_pallas_under_each_toggle(monkeypatch, stream, fused):
    """``BiLSTMTrain`` (the band path under autograd) against the VJP of
    ``bilstm_pallas_train`` with the same toggles."""
    _set_toggles(monkeypatch, stream, fused)
    rng = np.random.default_rng(3)
    jp, tp = _lstm_params(3)
    x = (0.5 * rng.standard_normal((B, T, N))).astype(np.float32)
    cot = rng.standard_normal((B, T, 2 * H)).astype(np.float32)
    ref, vjp = jax.vjp(lambda p, a: jpl.bilstm_pallas_train(p, a, interpret=True), jp,
                       jnp.asarray(x))
    ref_gp, ref_gx = vjp(jnp.asarray(cot))
    x_t = _t(x).requires_grad_()
    out = tlstm.bilstm(tp, x_t)
    out.backward(_t(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=FWD_ATOL, rtol=0)
    assert _rel(x_t.grad, ref_gx) < GRAD_RTOL
    for k in tp:
        assert _rel(tp[k].grad, ref_gp[k]) < GRAD_RTOL, k


def test_bilstm_masked_streams_the_input_under_the_toggle(monkeypatch):
    """``bilstm_masked`` under STREAM_INPUT_TRAIN (K8 on x and on the
    length-reversed x) against the JAX ``bilstm_masked(use_pallas=True)``
    with the toggle set: outputs at valid steps and every gradient."""
    _set_toggles(monkeypatch, True, False)
    calls = []
    streamin = cuda_lstm.lstm_train_fwd_streamin
    monkeypatch.setattr(cuda_lstm, "lstm_train_fwd_streamin",
                        lambda *a: calls.append(1) or streamin(*a))
    rng = np.random.default_rng(4)
    jp, tp = _lstm_params(4)
    x = (0.5 * rng.standard_normal((B, T, N))).astype(np.float32)
    valid = np.arange(T)[None, :] < LENGTHS[:, None]
    cot = rng.standard_normal((B, T, 2 * H)).astype(np.float32) * valid[..., None]
    lengths = jnp.asarray(LENGTHS)
    ref, vjp = jax.vjp(lambda p, a: jlstm.bilstm_masked(p, a, lengths, use_pallas=True,
                                                        interpret=True), jp, jnp.asarray(x))
    ref_gp, ref_gx = vjp(jnp.asarray(cot))
    x_t = _t(x).requires_grad_()
    out = tlstm.bilstm_masked(tp, x_t, torch.from_numpy(LENGTHS))
    assert len(calls) == 2  # both directions on K8
    out.backward(_t(cot))
    np.testing.assert_allclose(out.detach().numpy()[valid], np.asarray(ref)[valid],
                               atol=FWD_ATOL, rtol=0)
    assert _rel(x_t.grad, ref_gx) < GRAD_RTOL
    for k in tp:
        assert _rel(tp[k].grad, ref_gp[k]) < GRAD_RTOL, k
    with torch.no_grad():  # the primal walks K8 too, as the JAX primal does
        tlstm.bilstm_masked(tp, x_t, torch.from_numpy(LENGTHS))
    assert len(calls) == 4


@pytest.mark.parametrize("stream,fused", TOGGLES, ids=TOGGLE_IDS)
def test_train_step_launches_each_kernel_as_planned(monkeypatch, stream, fused):
    """One discriminative train step calls each wrapper as often as
    ``bsrnn.TRAIN_LAUNCHES_PER_LAYER`` says, per layer."""
    from urgent2026_challenge_track1_tpu_torch.config import Config
    from urgent2026_challenge_track1_tpu_torch.models.bsrnn import TRAIN_LAUNCHES_PER_LAYER
    from urgent2026_challenge_track1_tpu_torch.train import trainer

    _set_toggles(monkeypatch, stream, fused)
    calls = {fn.__name__: 0 for fn in cuda_lstm.KERNELS}

    def counted(fn):
        def wrapper(*args, **kwargs):
            calls[fn.__name__] += 1
            return fn(*args, **kwargs)
        return wrapper

    for fn in cuda_lstm.KERNELS:
        monkeypatch.setattr(cuda_lstm, fn.__name__, counted(fn))
    layers = 2
    cfg = Config(model_configs={"num_channel": 4, "num_layer": layers}, device="cpu")
    bundle = trainer.build_model(cfg)
    model = trainer.init_params(0, bundle, "cpu")
    step = trainer.make_train_step(bundle, cfg, 8000)
    rng = np.random.default_rng(5)
    noisy = _t(0.1 * rng.standard_normal((2, 1600)))
    m = step(model, trainer.make_optimizer(cfg, model), noisy * 0.5, noisy,
             torch.tensor([1600, 1200], dtype=torch.int32))
    assert np.isfinite(float(m["loss"])) and not m["nan_grad"]
    tag = TOGGLE_IDS[TOGGLES.index((stream, fused))]
    assert {k: v for k, v in calls.items() if v} == {
        k: v * layers for k, v in TRAIN_LAUNCHES_PER_LAYER[tag].items()}
