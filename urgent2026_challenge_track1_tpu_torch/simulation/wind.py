"""Physical wind-noise synthesis (counterpart of ``simulation/wind.py``).

The method of Mirabilii & Habets (IWAENC 2022):

  1. wind-speed profile: Weibull-sampled anchor speeds (count = gustiness),
     FFT-interpolated to the sample rate, plus Hann-smoothed Gaussian
     fluctuations;
  2. excitation: white noise x long-term gain (dB-domain polynomial
     regression of variance on speed) x GARCH short-term std (speed-dependent
     alpha/beta/omega polynomials), assembled OLA with 128-sample Hann
     windows;
  3. coloration: time-varying AR filtering; per 2048-sample OLA window the
     speed maps through an LSF regression to order-5 LPC coefficients
     (``lsf2poly``) and the excitation is filtered by 1/A(z);
  4. peak-normalise to 0.95.

Every draw comes from ``rng``, an explicit ``np.random.RandomState`` that
``start_seed`` seeds.  A RandomState seeded with s yields the stream of
``np.random.seed(s)``, and the draws are made in the JAX package's order, so
a seed gives its samples bit for bit and leaves ``rng`` where the JAX
generator leaves the global state.
"""

from __future__ import annotations

import numpy as np
import scipy.signal

__all__ = ["lsf2poly", "WindNoiseGenerator"]


def lsf2poly(lsf: np.ndarray) -> np.ndarray:
    """Line spectral frequencies -> LPC prediction polynomial a(z).

    Zeros on the unit circle split alternately into the sum/difference
    polynomials P and Q, completed with their known roots at z = +-1, and
    averaged (Kondoz, "Digital Speech").
    """
    lsf = np.asarray(lsf, dtype=float)
    if lsf.max() > np.pi or lsf.min() < 0:
        raise ValueError("LSFs must lie in [0, pi]")
    p = len(lsf)
    z = np.exp(1j * lsf)
    rQ = np.concatenate([z[0::2], z[0::2].conjugate()])
    rP = np.concatenate([z[1::2], z[1::2].conjugate()])
    Q = np.poly(rQ)
    P = np.poly(rP)
    if p % 2:
        P1 = np.convolve(P, [1, 0, -1])
        Q1 = Q
    else:
        P1 = np.convolve(P, [1, -1])
        Q1 = np.convolve(Q, [1, 1])
    a = 0.5 * (P1 + Q1)
    return a[:-1].real


# Regression constants of the published method (speed -> model parameters).
_LT_VAR_REGRESSION = np.array([8.00071114414022, -220.332082908370])
_GARCH_ALPHA = np.array(
    [-2.73244444508231e-05, 0.00141129711949206, -0.0274652794467908,
     0.257613241095714, -0.139824587447063]
)
_GARCH_BETA = np.array(
    [-9.75160902595897e-05, 0.00464300106846736, -0.0871968755558256,
     0.651013973757802]
)
_GARCH_OMEGA = np.array(
    [9.69585296574741e-05, -0.00231853830578967, 0.0124681159197788]
)
_LSF_REGRESSION = np.array(
    [
        [-2.63412497797108e-06, 5.93162248595821e-05, 0.000215613938043173,
         -0.000149723789407121, -0.000213703084399375],
        [9.50240139044154e-05, -0.00271741166649528, -0.0103783584000284,
         0.00483963669507075, 0.00931864887930701],
        [-0.000699199223507821, 0.0428714179385289, 0.177250839818556,
         -0.0329542145779793, -0.129910107562929],
        [0.0106849674771013, -0.234688122194936, -1.21337646113093,
         -0.168053225019258, 0.568371362156217],
        [-0.000966851130291645, 0.541693139684727, 3.24796925730457,
         2.54984352038733, 1.86097523205089],
    ]
)


class WindNoiseGenerator:
    """Single-channel wind-noise synthesizer (see the module docstring).

    ``rng``: the ``np.random.RandomState`` every draw comes from (a new one
    when None); ``start_seed``, when given, seeds it.
    """

    def __init__(
        self,
        fs: int = 48000,
        duration: float = 5,
        generate: bool = True,
        wind_profile=None,
        gustiness: float = 3,
        short_term_var: bool = True,
        start_seed=None,
        rng: np.random.RandomState | None = None,
    ):
        self.fs = fs
        self.duration = duration
        self.samples = int(fs * duration)
        self.generate = generate
        self.gustiness = gustiness
        self.wind_profile = wind_profile
        self.short_term_var = short_term_var
        self.rng = np.random.RandomState() if rng is None else rng
        if start_seed is not None:
            self.rng.seed(start_seed)

    def generate_wind_noise(self):
        profile = (
            self._speed_profile() if self.generate else self._imported_profile()
        )
        exc = self._excitation(profile)
        out = self._ar_color(exc, profile, 2048)
        out = 0.95 * out / np.max(np.abs(out))
        return out, profile

    def _speed_profile(self, b_par=2, a_par=2):
        anchors = b_par * self.rng.weibull(a_par, int(self.gustiness))
        profile = scipy.signal.resample(anchors, self.samples)
        return profile + self._fluctuations()

    def _imported_profile(self):
        profile = scipy.signal.resample(self.wind_profile, self.samples)
        return profile + self._fluctuations()

    def _fluctuations(self):
        fluctuations = 10 * self.rng.randn(self.samples)
        win = np.hanning(int(self.fs * 100e-3))
        win /= win.sum()
        return scipy.signal.lfilter(win, 1, fluctuations)

    def _long_term_gain(self, profile):
        var_db = np.polyval(_LT_VAR_REGRESSION, profile)
        return np.sqrt(np.abs(10 ** (var_db / 10)))

    def _garch_std(self, profile):
        window_size = 128
        hops = window_size // 2
        padded = np.concatenate(
            [2 * np.ones(window_size), profile, 2 * np.ones(window_size)]
        )
        num_windows = (len(padded) - window_size) // hops + 1
        st_var = np.zeros(num_windows)
        cond_var = np.zeros(num_windows)
        for t in range(num_windows):
            seg = padded[t * hops : t * hops + window_size]
            speed = np.clip(seg.mean(), 2, 18)
            alpha = np.polyval(_GARCH_ALPHA, speed)
            beta = np.polyval(_GARCH_BETA, speed)
            omega = np.polyval(_GARCH_OMEGA, speed)
            if alpha + beta > 1:
                beta = 0
            cond_var[t] = omega + alpha * st_var[t - 1] ** 2 + beta * cond_var[t - 1]
            st_var[t] = np.sqrt(np.abs(cond_var[t])) * self.rng.randn()
        return st_var / np.max(np.abs(st_var))

    def _excitation(self, profile):
        window_size = 128
        hops = window_size // 2
        win = np.hanning(window_size)
        wgn = np.concatenate(
            [np.zeros(window_size), self.rng.randn(self.samples), np.zeros(window_size)]
        )
        lt = np.concatenate(
            [np.zeros(window_size), self._long_term_gain(profile), np.zeros(window_size)]
        )
        cond = np.abs(self._garch_std(profile))
        num_windows = (len(wgn) - window_size) // hops + 1
        exc = np.zeros(len(wgn))
        for t in range(num_windows - 1):
            idx = slice(t * hops, t * hops + window_size)
            gain = lt[idx]
            if self.short_term_var:
                gain = gain * np.sqrt(cond[t])
            exc[idx] += gain * wgn[idx] * win
        return exc[window_size:-window_size]

    def _lpc_for_speed(self, speed):
        lsf = np.array(
            [np.polyval(_LSF_REGRESSION[:, k], speed) for k in range(5)]
        )
        return lsf2poly(lsf)

    def _ar_color(self, exc, profile, window_size):
        hops = window_size // 2
        win = np.hanning(window_size)
        padded_profile = np.concatenate(
            [2 * np.ones(window_size), profile, 2 * np.ones(window_size)]
        )
        exc = np.concatenate([np.zeros(window_size), exc, np.zeros(window_size)])
        num_windows = (len(exc) - window_size) // hops + 1
        out = np.zeros(len(exc))
        for t in range(num_windows):
            idx = slice(t * hops, t * hops + window_size)
            speed = np.clip(padded_profile[idx].mean(), 2, 18)
            a = self._lpc_for_speed(speed)
            out[idx] += scipy.signal.lfilter([1.0], a, exc[idx] * win)
        return out[window_size:-window_size]
