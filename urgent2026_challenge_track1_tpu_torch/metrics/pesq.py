"""PESQ (ITU-T P.862 / P.862.1 / P.862.2) — perceptual speech quality.

The reference scores PESQ through the ``pesq`` C extension
(the reference's ``calculate_intrusive_se_metrics.py:52-88``;
nb @8 kHz, wb @16 kHz, fs>16 kHz resampled to 16 kHz wb).  This is a
from-scratch implementation of the full published P.862 pipeline:

  zero-padding (SEARCHBUFFER + 320 ms datapadding) -> level alignment to
  1e7 in the 350-3250 Hz band -> input filtering (IRS receive @nb, 100 Hz
  IIR high-pass @wb) -> VAD -> utterance location -> crude (envelope) +
  fine (FFT-correlation histogram) per-utterance delay with confidence and
  utterance splitting -> 32 ms Hann frames -> Bark pitch-power densities ->
  partial frequency compensation (ref) and smoothed short-term gain
  compensation (deg, bounds [3e-4, 5]) -> Zwicker loudness (Sl, modified
  exponent below 4 Bark) -> centre-clipped disturbance (0.25 deadzone) +
  asymmetry factor ((pd+50)/(pr+50))^1.2, zeroed < 3, capped 12 ->
  frequency Lp (p=2 sym / p=1 asym) -> bad-interval realignment ->
  L6-over-20-frame-syllables / L2-over-time aggregation ->
  4.5 - 0.1*d - 0.0309*a -> MOS-LQO logistic (P.862.1 nb / P.862.2 wb).

DEVIATION NOTE: the algorithm structure and all scalar constants are the
published P.862 values; the four per-band grouping tables are reconstructed
from the standard's method rather than copied from the ITU source (see
metrics/pesq_tables.py, which is drop-in replaceable with the exact
arrays).  Scores are therefore structurally parity-grade but not proven
bit-exact against the C ``pesq`` package, which the project does not
use.  Regression is pinned by self-golden vectors in tests/test_metrics.py;
the port's copy is held equal to the JAX package's in
tests/test_torch_metrics.py.
"""

from __future__ import annotations

import numpy as np

from urgent2026_challenge_track1_tpu_torch.metrics.pesq_tables import Mode, get_mode
from urgent2026_challenge_track1_tpu_torch.simulation.dsp import resample

__all__ = ["pesq_metric"]

EPS = 1e-12
TARGET_POWER = 1e7
SEARCHBUFFER = 75          # in downsample (4 ms) units
DATAPADDING_MS = 320
MIN_GAIN, MAX_GAIN = 3.0e-4, 5.0
ZWICKER_POWER = 0.23
DEADZONE = 0.25
D_POW_F, D_POW_S, D_POW_T = 2.0, 6.0, 2.0
A_POW_F, A_POW_S, A_POW_T = 1.0, 6.0, 2.0
D_WEIGHT, A_WEIGHT = 0.1, 0.0309
FRAMES_PER_SYLLABLE = 20
BAD_FRAME_THRESHOLD = 30.0
MAX_DISTURBANCE = 45.0
# frequency-integration scales: the one element of the ITU code whose exact
# normalisation the standard's text does not give; calibrated so the white-noise SNR
# response matches the published C implementation's curve (see
# tests/test_metrics.py golden vectors / scripts/calibrate_pesq.py)
FREQ_SCALE_D = 13.2302
FREQ_SCALE_A = 2.9173

# piecewise (Hz, dB) response applied before power measurements: flat in the
# 350-3250 Hz band (P.862 level-alignment filter)
_ALIGN_FILTER_DB = np.array([
    (0, -500), (50, -500), (100, -500), (125, -500), (160, -500), (200, -500),
    (250, -500), (300, -500), (350, 0), (400, 0), (500, 0), (600, 0),
    (630, 0), (800, 0), (1000, 0), (1250, 0), (1600, 0), (2000, 0),
    (2500, 0), (3000, 0), (3250, 0), (3500, -500), (4000, -500),
    (5000, -500), (6300, -500), (8000, -500),
], np.float64)

# IRS receive characteristic (narrowband input filter), piecewise (Hz, dB)
_IRS_FILTER_DB = np.array([
    (0, -200), (50, -40), (100, -20), (125, -12), (160, -6), (200, 0),
    (250, 4), (300, 6), (350, 8), (400, 10), (500, 11), (600, 12),
    (700, 12), (800, 12), (1000, 12), (1300, 12), (1600, 12), (2000, 12),
    (2500, 12), (3000, 12), (3250, 12), (3500, 4), (4000, -200),
    (5000, -200), (6300, -200), (8000, -200),
], np.float64)

# wideband input filter: single biquad 100 Hz high-pass (P.862.2)
_WB_IIR_SOS = (2.6657628, -5.3315255, 2.6657628, -1.8890331, 0.89487434)


# ---------------------------------------------------------------------------
# filters / level
# ---------------------------------------------------------------------------


def _fft_filter(x: np.ndarray, fs: int, curve: np.ndarray) -> np.ndarray:
    """Zero-phase piecewise-linear magnitude filter in the DFT domain."""
    n = len(x)
    spec = np.fft.rfft(x)
    freqs = np.fft.rfftfreq(n, 1.0 / fs)
    gain_db = np.interp(freqs, curve[:, 0], curve[:, 1])
    spec *= 10.0 ** (gain_db / 20.0)
    return np.fft.irfft(spec, n)


def _iir_biquad(x: np.ndarray, sos) -> np.ndarray:
    from scipy.signal import lfilter

    b0, b1, b2, a1, a2 = sos
    return lfilter([b0, b1, b2], [1.0, a1, a2], x)


def _band_power(x: np.ndarray, fs: int, start: int, end: int) -> float:
    """Mean per-sample power in the 350-3250 Hz band over [start, end)."""
    seg = _fft_filter(x, fs, _ALIGN_FILTER_DB)[start:end]
    return float(np.mean(seg * seg)) if len(seg) else 0.0


# ---------------------------------------------------------------------------
# VAD / utterance location / alignment
# ---------------------------------------------------------------------------


def _calc_vad(x: np.ndarray, ds: int):
    """4 ms-grid VAD with iterative noise-floor threshold, burst pruning and
    gap joining (P.862 apply_VAD semantics); returns (vad, logvad)."""
    n = len(x) // ds
    frames = x[: n * ds].reshape(n, ds)
    vad = np.mean(frames * frames, axis=1)
    level_min = max(float(vad.max()) * 1e-4, 1e-10)
    vad = np.maximum(vad, level_min)
    # speech threshold: converge monotonically from the overall mean down to
    # 20x (13 dB over) the noise-floor estimate
    thresh = float(np.mean(vad))
    for _ in range(12):
        noise = vad[vad <= thresh]
        if len(noise) == 0:
            break
        new = min(20.0 * float(np.mean(noise)), thresh)
        if thresh - new < 1e-12:
            break
        thresh = new
    speech = vad > thresh
    # join speech runs separated by <= 200 ms, prune runs < 48 ms (12 windows
    # joined / 3+ windows kept on the 4 ms grid)
    speech = _morph_runs(speech, join_gap=50, min_run=3)
    logvad = np.where(speech, np.log(vad / thresh), 0.0)
    return speech, logvad


def _morph_runs(mask: np.ndarray, join_gap: int, min_run: int) -> np.ndarray:
    out = mask.copy()
    n = len(out)
    # join short gaps
    idx = np.flatnonzero(out)
    if idx.size == 0:
        return out
    for a, b in zip(idx[:-1], idx[1:]):
        if 1 < b - a <= join_gap:
            out[a:b] = True
    # prune short runs
    i = 0
    while i < n:
        if out[i]:
            j = i
            while j < n and out[j]:
                j += 1
            if j - i < min_run:
                out[i:j] = False
            i = j
        else:
            i += 1
    return out


def _crude_align(logvad_ref: np.ndarray, logvad_deg: np.ndarray, ds: int) -> int:
    """Whole-signal delay estimate (samples) via envelope cross-correlation."""
    n = max(len(logvad_ref), len(logvad_deg))
    nfft = 1 << int(np.ceil(np.log2(2 * n)))
    R = np.fft.rfft(logvad_ref, nfft)
    D = np.fft.rfft(logvad_deg, nfft)
    c = np.fft.irfft(D * np.conj(R), nfft)
    c = np.concatenate([c[-(n - 1):], c[:n]])  # lags -(n-1) .. n-1
    if c.max() <= 0.0:
        return 0
    lag = int(np.argmax(c)) - (n - 1)
    return lag * ds


def _utterances(speech: np.ndarray, ds: int, n_samples: int):
    """[(start_sample, end_sample)] of speech utterances on the 4 ms grid."""
    utts = []
    idx = np.flatnonzero(speech)
    if idx.size == 0:
        return utts
    start = idx[0]
    prev = idx[0]
    for i in idx[1:]:
        if i != prev + 1:
            utts.append((start, prev + 1))
            start = i
        prev = i
    utts.append((start, prev + 1))
    return [(max(0, (a - 1) * ds), min(n_samples, (b + 1) * ds)) for a, b in utts]


def _fine_align(ref: np.ndarray, deg: np.ndarray, start: int, end: int,
                delay_est: int, mode: Mode):
    """Fine delay within one utterance: per-frame FFT cross-correlation peaks
    accumulated in a triangular-kernel histogram (P.862 time_align).
    Returns (delay_samples, confidence)."""
    N = mode.align_nfft
    ds = mode.downsample
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(N) / N))
    hist = np.zeros(2 * N)
    kernel = 1.0 - np.abs(np.arange(-ds, ds + 1)) / (ds + 1)
    for startr in range(start, end - N + 1, N // 4):
        startd = startr + delay_est
        if startd < 0 or startd + N > len(deg):
            continue
        fr = ref[startr : startr + N] * window
        fd = deg[startd : startd + N] * window
        X1 = np.fft.rfft(fr, 2 * N)
        X2 = np.fft.rfft(fd, 2 * N)
        c = np.abs(np.fft.irfft(X2 * np.conj(X1), 2 * N))
        v_max = float(c.max())
        if v_max <= 0.0:
            continue
        # magnitude-compressed peak weighting; prune sub-threshold lobes
        c = np.where(c > 0.99 * v_max, c**0.125, 0.0)
        peak = int(np.argmax(c))
        w = v_max**0.125
        for k, kv in zip(range(peak - ds, peak + ds + 1), kernel):
            hist[k % (2 * N)] += w * kv * (c[peak] > 0)
    total = float(hist.sum())
    if total <= 0.0:
        return delay_est, 0.0
    peak = int(np.argmax(hist))
    # lags: index 0..N-1 = deg later by +lag; index 2N-1.. = negative
    lag = peak if peak < N else peak - 2 * N
    conf = float(hist[peak]) / total
    return delay_est + lag, conf


def _locate_and_align(ref, deg, mode: Mode):
    """Full alignment chain; returns [(start, end, delay)] per utterance."""
    ds = mode.downsample
    speech_r, logvad_r = _calc_vad(ref, ds)
    _, logvad_d = _calc_vad(deg, ds)
    global_delay = _crude_align(logvad_r, logvad_d, ds)
    utts = _utterances(speech_r, ds, len(ref))
    aligned = []
    for a, b in utts:
        # per-utterance crude re-estimate restricted to the utterance window
        wa, wb = a // ds, max(a // ds + 1, b // ds)
        seg = np.zeros_like(logvad_r)
        seg[wa:wb] = logvad_r[wa:wb]
        utt_delay = _crude_align(seg, logvad_d, ds)
        if abs(utt_delay - global_delay) > SEARCHBUFFER * ds:
            utt_delay = global_delay
        delay, conf = _fine_align(ref, deg, a, b, utt_delay, mode)
        # utterance splitting: if both halves align with higher confidence,
        # the delay changed inside the utterance (P.862 split_align)
        if b - a >= 4 * mode.align_nfft:
            mid = (a + b) // 2
            d1, c1 = _fine_align(ref, deg, a, mid, utt_delay, mode)
            d2, c2 = _fine_align(ref, deg, mid, b, utt_delay, mode)
            if c1 > conf and c2 > conf and abs(d1 - d2) > ds:
                aligned.append((a, mid, d1))
                aligned.append((mid, b, d2))
                continue
        aligned.append((a, b, delay))
    if not aligned:  # no speech detected: treat the whole file as one chunk
        aligned = [(0, len(ref), global_delay)]
    return aligned


# ---------------------------------------------------------------------------
# perceptual model
# ---------------------------------------------------------------------------


def _pitch_pow_dens(x: np.ndarray, mode: Mode, starts: np.ndarray) -> np.ndarray:
    """(n_frames, Nb) Bark pitch power densities at the given frame starts."""
    N = mode.Nf
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(N) / N))
    idx = starts[:, None] + np.arange(N)[None, :]
    frames = x[idx] * window
    spec = np.fft.rfft(frames, axis=-1)
    hz_pow = (spec.real**2 + spec.imag**2)[:, : N // 2]
    # group bins into Bark bands
    bounds = np.concatenate([[0], np.cumsum(mode.nr_of_hz_bands)])
    bands = np.add.reduceat(hz_pow, bounds[:-1], axis=1)
    return bands * mode.pow_dens_correction[None, :] * mode.Sp


def _total_audible(dens: np.ndarray, mode: Mode, factor: float) -> np.ndarray:
    """Per-frame power summed over bands above factor*threshold (band 0
    excluded, P.862 total_audible)."""
    thr = mode.abs_thresh_power[None, 1:] * factor
    d = dens[:, 1:]
    return np.sum(np.where(d > thr, d, 0.0), axis=1)


def _loudness(dens: np.ndarray, mode: Mode) -> np.ndarray:
    """Zwicker loudness with the modified exponent below 4 Bark."""
    thr = mode.abs_thresh_power[None, :]
    h = np.where(mode.centre_of_band < 4.0, 6.0 / (mode.centre_of_band + 2.0), 1.0)
    h = np.minimum(h, 2.0) ** 0.15
    gamma = ZWICKER_POWER * h[None, :]
    loud = mode.Sl * (thr / 0.5) ** gamma * ((0.5 + 0.5 * dens / thr) ** gamma - 1.0)
    return np.where(dens > thr, loud, 0.0)


def _pseudo_lp(d: np.ndarray, mode: Mode, p: float, scale: float) -> np.ndarray:
    """Width-weighted Lp mean over bands (band 0 excluded), per frame, times
    the mode's frequency-integration scale (see FREQ_SCALE_* notes)."""
    w = mode.width_of_band[None, 1:]
    tot = float(mode.width_of_band[1:].sum())
    return (np.sum(w * np.abs(d[:, 1:]) ** p, axis=1) / tot) ** (1.0 / p) * scale


def _frame_disturbance(pr: np.ndarray, pd: np.ndarray, mode: Mode):
    """(D_frame, DA_frame) symmetric/asymmetric disturbances per frame from
    compensated pitch power densities."""
    lr = _loudness(pr, mode)
    ld = _loudness(pd, mode)
    d = ld - lr
    m = DEADZONE * np.minimum(ld, lr)
    d = np.sign(d) * np.maximum(np.abs(d) - m, 0.0)
    h = ((pd + 50.0) / (pr + 50.0)) ** 1.2
    h = np.where(h < 3.0, 0.0, np.minimum(h, 12.0))
    d_frame = _pseudo_lp(d, mode, D_POW_F, FREQ_SCALE_D)
    da_frame = _pseudo_lp(d * h, mode, A_POW_F, FREQ_SCALE_A)
    return d_frame, da_frame


def _lpq_weight(fd: np.ndarray, tw: np.ndarray, p_syl: float, p_t: float) -> float:
    """L(p_syl) over 20-frame syllables (50% overlap), L(p_t) over time,
    frame-weighted (P.862 Lpq_weight)."""
    n = len(fd)
    if n == 0:
        return 0.0
    hop = FRAMES_PER_SYLLABLE // 2
    vals = []
    # every window start < n, including the final partial window — the ITU
    # loop runs while start_frame < stop_frame, so trailing frames get the
    # same two-window coverage as the rest
    for s in range(0, n, hop):
        seg = slice(s, min(s + FRAMES_PER_SYLLABLE, n))
        w = tw[seg]
        tot = float(w.sum())
        if tot <= 0.0:
            continue
        vals.append((float(np.sum(w * fd[seg] ** p_syl)) / tot) ** (1.0 / p_syl))
    if not vals:
        return 0.0
    v = np.asarray(vals)
    return float(np.mean(v**p_t) ** (1.0 / p_t))


def _pesq_raw(ref: np.ndarray, deg: np.ndarray, mode: Mode) -> float:
    ds = mode.downsample
    pad = SEARCHBUFFER * ds
    dpad = DATAPADDING_MS * mode.fs // 1000
    ref = np.concatenate([np.zeros(pad), ref, np.zeros(pad + dpad)])
    deg = np.concatenate([np.zeros(pad), deg, np.zeros(pad + dpad)])

    # level alignment to TARGET_POWER in the 350-3250 Hz band
    for x in (ref, deg):
        p = _band_power(x, mode.fs, pad, len(x) - pad)
        x *= np.sqrt(TARGET_POWER / max(p, EPS))

    # input filtering
    if mode.name == "nb":
        ref = _fft_filter(ref, mode.fs, _IRS_FILTER_DB)
        deg = _fft_filter(deg, mode.fs, _IRS_FILTER_DB)
    else:
        ref = _iir_biquad(ref, _WB_IIR_SOS)
        deg = _iir_biquad(deg, _WB_IIR_SOS)

    utts = _locate_and_align(ref, deg, mode)

    # frame table: every 50%-overlapped Nf frame, delay from its utterance
    N, hop = mode.Nf, mode.Nf // 2
    n_frames = (len(ref) - 2 * pad - N) // hop + 1
    if n_frames < 2:
        return np.nan
    starts_r = pad + hop * np.arange(n_frames)
    # each frame takes the delay of the utterance whose span covers it;
    # frames between utterances take the nearest utterance's delay (the
    # utterance table tiles the whole timeline in P.862)
    centre = starts_r + N // 2
    utt_mid = np.array([(a + b) / 2 for a, b, _ in utts])
    utt_delay = np.array([d for _, _, d in utts], np.int64)
    delays = utt_delay[np.argmin(np.abs(centre[:, None] - utt_mid[None, :]), axis=1)]
    for k, (a, b, d) in enumerate(utts):
        delays[(centre >= a) & (centre < b)] = d
    starts_d = np.clip(starts_r + delays, 0, len(deg) - N)

    pr = _pitch_pow_dens(ref, mode, starts_r)
    pd = _pitch_pow_dens(deg, mode, starts_d)

    # silent frames: inaudible reference content (excluded from averages
    # and from the final aggregation)
    audible_ref = _total_audible(pr, mode, 1.0)
    silent = _total_audible(pr, mode, 100.0) < 1e7
    active = ~silent
    if not np.any(active):
        return np.nan

    # partial frequency (linear response) compensation, applied to REF
    avg_r = np.mean(pr[active], axis=0)
    avg_d = np.mean(pd[active], axis=0)
    band_gain = np.clip((avg_d + 1000.0) / (avg_r + 1000.0), 0.01, 100.0)
    pr_eq = pr * band_gain[None, :]

    # smoothed short-term gain compensation, applied to DEG
    ratio = (_total_audible(pr_eq, mode, 1.0) + 5e3) / (
        _total_audible(pd, mode, 1.0) + 5e3
    )
    g = np.empty(n_frames)
    prev = 1.0
    for i in range(n_frames):
        prev = 0.2 * prev + 0.8 * ratio[i]
        g[i] = min(max(prev, MIN_GAIN), MAX_GAIN)
    pd_eq = pd * g[:, None]

    d_frame, da_frame = _frame_disturbance(pr_eq, pd_eq, mode)

    # bad-interval realignment: runs of frames whose symmetric disturbance
    # exceeds the threshold are re-searched over local delays
    bad = (d_frame > BAD_FRAME_THRESHOLD) & active
    i = 0
    while i < n_frames:
        if not bad[i]:
            i += 1
            continue
        j = i
        while j < n_frames and bad[j]:
            j += 1
        best_d = d_frame[i:j].sum()
        best = None
        for delta in range(-N // 2, N // 2 + 1, max(ds // 2, 1)):
            sd = np.clip(starts_d[i:j] + delta, 0, len(deg) - N)
            pd_try = _pitch_pow_dens(deg, mode, sd) * g[i:j, None]
            d_try, da_try = _frame_disturbance(pr_eq[i:j], pd_try, mode)
            if d_try.sum() < best_d:
                best_d = d_try.sum()
                best = (d_try, da_try)
        if best is not None:
            d_frame[i:j], da_frame[i:j] = best
        i = j

    # frame weighting and caps
    weight = ((audible_ref + 1e5) / 1e7) ** 0.04
    d_frame = np.minimum(d_frame / weight, MAX_DISTURBANCE)
    da_frame = np.minimum(da_frame / weight, MAX_DISTURBANCE)

    # aggregation runs over ALL frames (noise in speech pauses counts); the
    # silent-frame criterion above only gates the compensation averages
    tw = np.ones_like(d_frame)
    d_ind = _lpq_weight(d_frame, tw, D_POW_S, D_POW_T)
    a_ind = _lpq_weight(da_frame, tw, A_POW_S, A_POW_T)
    return 4.5 - D_WEIGHT * d_ind - A_WEIGHT * a_ind


def pesq_metric(ref: np.ndarray, inf: np.ndarray, fs: int = 8000):
    """PESQ MOS-LQO.  nb @8 kHz (P.862.1 map), wb @>=16 kHz (P.862.2 map);
    fs > 16 kHz inputs are resampled to 16 kHz like the reference CLI."""
    assert ref.shape == inf.shape
    ref = np.asarray(ref, np.float64)
    inf = np.asarray(inf, np.float64)
    if fs == 8000:
        mode = get_mode("nb")
    elif fs == 16000:
        mode = get_mode("wb")
    elif fs > 16000:
        ref = resample(ref[None], fs, 16000, "soxr_hq")[0]
        inf = resample(inf[None], fs, 16000, "soxr_hq")[0]
        mode = get_mode("wb")
    else:
        raise ValueError(
            f"sample rate must be 8000 or 16000+ for PESQ evaluation, but got {fs}"
        )
    if len(ref) < 2 * mode.Nf:
        return np.nan
    raw = _pesq_raw(ref, inf, mode)
    if np.isnan(raw):
        return np.nan
    if mode.name == "wb":
        # P.862.2 mapping
        return float(0.999 + 4.0 / (1.0 + np.exp(-1.3669 * raw + 3.8224)))
    # P.862.1 mapping
    return float(0.999 + 4.0 / (1.0 + np.exp(-1.4945 * raw + 4.6607)))
