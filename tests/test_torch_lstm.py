"""The plain versions of the port's three LSTM kernels against the JAX
package's Pallas kernels run in interpret mode, and the port's LSTM layers
against ops/lstm.py; CPU, float32, atol 1e-5 (same arithmetic, other
summation order).  The CUDA kernels themselves are held against the same
plain versions on the card (tests/test_torch_cuda_kernels.py and
chip_smoke.py)."""

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
ATOL = 1e-5
B, T, N, H = 6, 9, 16, 32


def _rng(seed):
    return np.random.default_rng(seed)


def _xproj_whh(seed):
    rng = _rng(seed)
    xp = (0.5 * rng.standard_normal((B, T, 4 * H))).astype(np.float32)
    whh = (0.2 * rng.standard_normal((H, 4 * H))).astype(np.float32)
    return xp, whh


def _lengths():
    return np.array([1, T, 4, 7, T - 1, 2], np.int32)  # includes 1 and T


def _valid(lengths):
    return np.arange(T)[None, :] < lengths[:, None]


def _params(seed, n_in=N):
    p = jlstm.init_lstm(jax.random.PRNGKey(seed), n_in, H, bidirectional=True)
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _close(a, b, mask=None):
    a, b = np.asarray(a), np.asarray(b)
    if mask is not None:
        a, b = a[mask], b[mask]
    np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_plain_matches_pallas(reverse):
    xp, whh = _xproj_whh(0)
    ref = jpl.lstm_scan_pallas(jnp.asarray(xp), jnp.asarray(whh), reverse=reverse,
                               interpret=True)
    got = cuda_lstm.lstm_scan(torch.from_numpy(xp), torch.from_numpy(whh), reverse)
    _close(got, ref)


def test_revmasked_plain_matches_pallas():
    xp, whh = _xproj_whh(1)
    lengths = _lengths()
    ref = jpl._lean_forward_revmasked(jnp.asarray(xp), jnp.asarray(whh),
                                      jnp.asarray(lengths), b_block=0, interpret=True)
    got = cuda_lstm.lstm_revmasked(torch.from_numpy(xp), torch.from_numpy(whh),
                                   torch.from_numpy(lengths))
    _close(got, ref, _valid(lengths))


def test_fusedin_plain_matches_pallas():
    rng = _rng(2)
    x = (0.5 * rng.standard_normal((B, T, N))).astype(np.float32)
    w_ih = (0.2 * rng.standard_normal((2, N, 4 * H))).astype(np.float32)
    w_hh = (0.2 * rng.standard_normal((2, H, 4 * H))).astype(np.float32)
    b = (0.2 * rng.standard_normal((2, 1, 4 * H))).astype(np.float32)
    out_f, out_b = jpl._fusedin_forward(
        jnp.asarray(x), jnp.asarray(w_ih[0]), jnp.asarray(w_ih[1]), jnp.asarray(w_hh[0]),
        jnp.asarray(w_hh[1]), jnp.asarray(b[0]), jnp.asarray(b[1]), 0, True)
    ref = np.concatenate([np.swapaxes(np.asarray(out_f), 0, 1),
                          np.swapaxes(np.asarray(out_b), 0, 1)], axis=-1)
    got = cuda_lstm.fusedin_bilstm(torch.from_numpy(x), torch.from_numpy(w_ih),
                                   torch.from_numpy(w_hh), torch.from_numpy(b[:, 0]))
    _close(got, ref)


def test_bilstm_matches_jax():
    jp, tp = _params(3)
    x = (0.5 * _rng(3).standard_normal((B, T, N))).astype(np.float32)
    _close(tlstm.bilstm(tp, torch.from_numpy(x)), jlstm.bilstm(jp, jnp.asarray(x)))


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_matches_jax(reverse):
    jp, tp = _params(4)
    x = (0.5 * _rng(4).standard_normal((B, T, N))).astype(np.float32)
    _close(tlstm.lstm(tp, torch.from_numpy(x), reverse=reverse),
           jlstm.lstm(jp, jnp.asarray(x), reverse=reverse))


def test_bilstm_masked_matches_jax():
    """Valid positions only: past lengths[b] both are unspecified."""
    jp, tp = _params(5)
    x = (0.5 * _rng(5).standard_normal((B, T, N))).astype(np.float32)
    lengths = _lengths()
    ref = jlstm.bilstm_masked(jp, jnp.asarray(x), jnp.asarray(lengths))
    got = tlstm.bilstm_masked(tp, torch.from_numpy(x), torch.from_numpy(lengths))
    _close(got, ref, _valid(lengths))


def test_length_reverse_matches_jax():
    x = _rng(6).standard_normal((B, T, 3)).astype(np.float32)
    lengths = _lengths()
    got = tlstm.length_reverse(torch.from_numpy(x), torch.from_numpy(lengths))
    _close(got, jlstm.length_reverse(jnp.asarray(x), jnp.asarray(lengths)))
    _close(tlstm.length_reverse(got, torch.from_numpy(lengths)), x)


def test_cpu_tensors_take_the_plain_version_without_counting():
    xp, whh = _xproj_whh(7)
    cuda_lstm.reset_launch_counts()
    cuda_lstm.lstm_scan(torch.from_numpy(xp), torch.from_numpy(whh))
    cuda_lstm.lstm_revmasked(torch.from_numpy(xp), torch.from_numpy(whh),
                             torch.from_numpy(_lengths()))
    assert cuda_lstm.launch_counts() == {
        "fusedin_bilstm": 0, "lstm_scan": 0, "lstm_revmasked": 0}

