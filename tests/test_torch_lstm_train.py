"""The plain versions of the port's four LSTM training kernels (K4-K7) and
the two autograd Functions built on them, against the VJPs of the JAX
package's Pallas training kernels run in interpret mode, and the band-path
``bilstm`` gradients against ``bilstm_pallas_train``.  CPU, float32.

Tolerances (scripts/check_pallas_tpu.py:29-34): forward max abs 2e-4;
gradients 1e-3 relative, as max|d| / max|reference| per tensor.  Each plain
backward is also held against torch autograd through the plain forward at
1e-5 relative (same arithmetic, other summation order).  The CUDA kernels
themselves are held against the same plain versions on the card
(tests/test_torch_cuda_kernels.py and chip_smoke.py)."""

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
FWD_ATOL, GRAD_RTOL, AUTOGRAD_RTOL = 2e-4, 1e-3, 1e-5
B, T, N, H = 6, 9, 16, 32
LENGTHS = np.array([1, T, 4, 7, T - 1, 2], np.int32)  # includes 1 and T


def _inputs(seed):
    rng = np.random.default_rng(seed)
    xp = (0.5 * rng.standard_normal((B, T, 4 * H))).astype(np.float32)
    whh = (0.2 * rng.standard_normal((H, 4 * H))).astype(np.float32)
    dout = rng.standard_normal((B, T, H)).astype(np.float32)
    return xp, whh, dout


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-12))


def _valid():
    return np.arange(T)[None, :] < LENGTHS[:, None]


def _jax_vjp(fn, xp, whh, dout, *extra):
    out, vjp = jax.vjp(lambda a, b: fn(a, b, *extra), jnp.asarray(xp), jnp.asarray(whh))
    dxp, dw = vjp(jnp.asarray(dout))
    return np.asarray(out), np.asarray(dxp), np.asarray(dw)


@pytest.mark.parametrize("reverse", [False, True])
def test_train_kernels_plain_match_pallas_vjp(reverse):
    xp, whh, dout = _inputs(0)
    ref_out, ref_dxp, ref_dw = _jax_vjp(
        lambda a, b: jpl.lstm_pallas_train(a, b, reverse, 0, True), xp, whh, dout)
    out, gates, c = cuda_lstm.lstm_train_fwd(_t(xp), _t(whh), reverse)
    np.testing.assert_allclose(out.numpy(), ref_out, atol=FWD_ATOL, rtol=0)
    # the residuals equal the Pallas forward's (time-major there)
    j_out, j_gates, j_c = jpl._train_forward(jnp.asarray(xp), jnp.asarray(whh), reverse, 0, True)
    np.testing.assert_allclose(gates.numpy(), np.swapaxes(j_gates, 0, 1), atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(c.numpy(), np.swapaxes(j_c, 0, 1), atol=FWD_ATOL, rtol=0)
    dxp, dw = cuda_lstm.lstm_train_bwd(out, gates, c, _t(dout), _t(whh), reverse)
    assert _rel(dxp, ref_dxp) < GRAD_RTOL
    assert _rel(dw, ref_dw) < GRAD_RTOL


def test_revmasked_train_kernels_plain_match_pallas_vjp():
    xp, whh, dout = _inputs(1)
    lengths = jnp.asarray(LENGTHS)
    valid = _valid()
    dout = dout * valid[..., None]  # outputs past each length are unspecified
    ref_out, ref_dxp, ref_dw = _jax_vjp(
        lambda a, b: jpl.lstm_pallas_train_revmasked(a, b, lengths, 0, True), xp, whh, dout)
    out, gates, c = cuda_lstm.lstm_revmasked_train_fwd(_t(xp), _t(whh), torch.from_numpy(LENGTHS))
    np.testing.assert_allclose(out.numpy()[valid], ref_out[valid], atol=FWD_ATOL, rtol=0)
    dxp, dw = cuda_lstm.lstm_revmasked_bwd(out, gates, c, torch.from_numpy(LENGTHS),
                                           _t(dout), _t(whh))
    assert _rel(dxp, ref_dxp) < GRAD_RTOL
    assert _rel(dw, ref_dw) < GRAD_RTOL


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_dir_train_function_matches_pallas_vjp(reverse):
    xp, whh, dout = _inputs(2)
    ref_out, ref_dxp, ref_dw = _jax_vjp(
        lambda a, b: jpl.lstm_pallas_train(a, b, reverse, 0, True), xp, whh, dout)
    x_t, w_t = _t(xp).requires_grad_(), _t(whh).requires_grad_()
    out = cuda_lstm.lstm_dir(x_t, w_t, reverse)
    out.backward(_t(dout))
    np.testing.assert_allclose(out.detach().numpy(), ref_out, atol=FWD_ATOL, rtol=0)
    assert _rel(x_t.grad, ref_dxp) < GRAD_RTOL
    assert _rel(w_t.grad, ref_dw) < GRAD_RTOL


def test_lstm_revmasked_train_function_matches_pallas_vjp():
    xp, whh, dout = _inputs(3)
    valid = _valid()
    dout = dout * valid[..., None]
    ref_out, ref_dxp, ref_dw = _jax_vjp(
        lambda a, b: jpl.lstm_pallas_train_revmasked(a, b, jnp.asarray(LENGTHS), 0, True),
        xp, whh, dout)
    x_t, w_t = _t(xp).requires_grad_(), _t(whh).requires_grad_()
    lengths = torch.from_numpy(LENGTHS)
    out = cuda_lstm.lstm_dir_revmasked(x_t, w_t, lengths)
    out.backward(_t(dout))
    np.testing.assert_allclose(out.detach().numpy()[valid], ref_out[valid], atol=FWD_ATOL,
                               rtol=0)
    assert _rel(x_t.grad, ref_dxp) < GRAD_RTOL
    assert _rel(w_t.grad, ref_dw) < GRAD_RTOL
    assert lengths.grad is None


@pytest.mark.parametrize("case", ["fwd", "reverse", "revmasked"])
def test_plain_backward_matches_autograd_of_plain_forward(case):
    """The plain backward (K5/K7's arithmetic) equals torch autograd through
    the plain forward (K4/K6's arithmetic) in f32."""
    xp, whh, dout = _inputs(4)
    lengths = torch.from_numpy(LENGTHS)
    x_t, w_t = _t(xp).requires_grad_(), _t(whh).requires_grad_()
    if case == "revmasked":
        out, gates, c = cuda_lstm.lstm_revmasked_train_fwd_plain(x_t, w_t, lengths)
        dout = dout * _valid()[..., None]
    else:
        out, gates, c = cuda_lstm.lstm_train_fwd_plain(x_t, w_t, case == "reverse")
    out.backward(_t(dout))
    args = (out.detach(), gates.detach(), c.detach())
    if case == "revmasked":
        dxp, dw = cuda_lstm.lstm_revmasked_bwd_plain(*args, lengths, _t(dout), w_t.detach())
    else:
        dxp, dw = cuda_lstm.lstm_train_bwd_plain(*args, _t(dout), w_t.detach(),
                                                 case == "reverse")
    assert _rel(dxp, x_t.grad) < AUTOGRAD_RTOL
    assert _rel(dw, w_t.grad) < AUTOGRAD_RTOL


def test_bilstm_grads_match_bilstm_pallas_train():
    rng = np.random.default_rng(5)
    jp = jlstm.init_lstm(jax.random.PRNGKey(5), N, H, bidirectional=True)
    x = (0.5 * rng.standard_normal((B, T, N))).astype(np.float32)
    cot = rng.standard_normal((B, T, 2 * H)).astype(np.float32)
    ref, vjp = jax.vjp(lambda p, a: jpl.bilstm_pallas_train(p, a, interpret=True), jp,
                       jnp.asarray(x))
    ref_gp, ref_gx = vjp(jnp.asarray(cot))
    tp = {k: _t(v).requires_grad_() for k, v in jp.items()}
    x_t = _t(x).requires_grad_()
    cuda_lstm.reset_launch_counts()
    out = tlstm.bilstm(tp, x_t)
    out.backward(_t(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=FWD_ATOL, rtol=0)
    assert _rel(x_t.grad, ref_gx) < GRAD_RTOL
    for k in tp:
        assert _rel(tp[k].grad, ref_gp[k]) < GRAD_RTOL, k
    assert sum(cuda_lstm.launch_counts().values()) == 0  # the CPU runs no kernel


def test_bilstm_without_grad_stays_on_the_fused_kernel(monkeypatch):
    """Routing: outside autograd the band path runs K1's wrapper, under
    autograd the bidirectional training Function (``BiLSTMTrain``)."""
    calls = []
    monkeypatch.setattr(cuda_lstm, "fusedin_bilstm",
                        lambda *a: calls.append("k1") or cuda_lstm.fusedin_bilstm_plain(*a))
    monkeypatch.setattr(cuda_lstm.BiLSTMTrain, "apply",
                        lambda *a: calls.append("train") or torch.zeros(()))
    jp = jlstm.init_lstm(jax.random.PRNGKey(6), N, H, bidirectional=True)
    tp = {k: _t(v).requires_grad_() for k, v in jp.items()}
    x = _t(np.random.default_rng(6).standard_normal((B, T, N)))
    with torch.no_grad():
        tlstm.bilstm(tp, x)
    assert calls == ["k1"]
    tlstm.bilstm(tp, x)
    assert calls == ["k1", "train"]
