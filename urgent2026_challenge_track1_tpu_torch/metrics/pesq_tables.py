"""ITU-T P.862 band tables: bin grouping, widths, thresholds, mode constants.

The reference scores PESQ through the ``pesq`` C extension wrapping the ITU
reference code (the reference's ``calculate_intrusive_se_metrics.py:52-88``).
That code carries four empirical per-band tables per mode
(``nr_of_hz_bands_per_bark_band``, ``centre_of_band``, ``width_of_band``,
``pow_dens_correction_factor``) plus ``abs_thresh_power``.  The exact tables
are not redistributed with the project, so
this module reconstructs them with the standard's documented method:

  * the perceptual frequency axis is the Zwicker critical-band-rate warp;
  * the Nb bands (42 @8 kHz, 49 @16 kHz) partition the FFT bins into
    contiguous groups of near-equal warped width;
  * ``width_of_band``/``centre_of_band`` are the warped width/midpoint of
    each group;
  * ``pow_dens_correction_factor`` compensates the integer binning (ideal
    warped width over realised width), folded with the x100 scale the ITU
    tables carry;
  * ``abs_thresh_power`` is the ITU threshold-in-quiet curve (the published
    per-band values, anchored below) interpolated at each band centre.

Every scalar constant (Sp, Sl, SEARCHBUFFER, DATAPADDING, gain bounds,
deadzone, asymmetry parameters, Lp exponents, MOS maps) is the published
P.862 value.  Drop-in: assign the exact ITU arrays to the `Mode` fields to
restore bit-level table parity.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

__all__ = ["Mode", "get_mode", "NB_MODE", "WB_MODE"]


def bark(f):
    """Zwicker & Terhardt critical-band rate (Bark) warp."""
    f = np.asarray(f, np.float64)
    return 13.0 * np.arctan(0.00076 * f) + 3.5 * np.arctan((f / 7500.0) ** 2)


# ITU-T P.862 absolute threshold of hearing per band (power units on the
# model's internal intensity scale).  Sampled on the 42-band 8 kHz grid;
# bands above share the wideband tail shape.
_ABS_THRESH_CURVE = np.array([
    51286152.0, 2454709.5, 70794.59375, 4897.788574, 1174.897705,
    389.045166, 104.712860, 45.708820, 17.782795, 9.772372,
    4.897789, 3.090296, 1.905461, 1.258925, 0.977237,
    0.724436, 0.562341, 0.457088, 0.389045, 0.331131,
    0.295121, 0.269153, 0.257040, 0.251189, 0.251189,
    0.251189, 0.251189, 0.263027, 0.288403, 0.309030,
    0.338844, 0.371535, 0.398107, 0.436516, 0.467735,
    0.489779, 0.501187, 0.501187, 0.512861, 0.524807,
    0.524807, 0.524807,
    # wideband extension (>4 kHz): threshold rises slowly toward 8 kHz
    0.512861, 0.478630, 0.426580, 0.371535, 0.363078, 0.416869, 0.537032,
])


@dataclasses.dataclass(frozen=True)
class Mode:
    name: str                    # "nb" | "wb"
    fs: int
    Nf: int                      # 32 ms analysis frame (50% overlap)
    Nb: int                      # number of Bark bands
    downsample: int              # 4 ms unit for VAD/alignment
    align_nfft: int              # fine-alignment window
    Sp: float                    # power scaling
    Sl: float                    # loudness scaling
    # tables (length Nb except nr_of_hz_bands sums to Nf/2)
    nr_of_hz_bands: np.ndarray
    centre_of_band: np.ndarray
    width_of_band: np.ndarray
    pow_dens_correction: np.ndarray
    abs_thresh_power: np.ndarray


def _partition_bins(fs: int, Nf: int, Nb: int):
    """Group the Nf/2 positive-frequency bins into Nb contiguous bands of
    near-equal Bark width (first bin is DC..df/2, hence the half offset)."""
    n_bins = Nf // 2
    df = fs / Nf
    edges_hz = np.arange(n_bins + 1) * df  # bin boundaries
    edges_bark = bark(edges_hz)
    total = edges_bark[-1]
    targets = np.linspace(0.0, total, Nb + 1)[1:-1]
    # boundary bins: closest bin edge to each equal-Bark target, strictly
    # increasing so every band has >= 1 bin
    bounds = [0]
    for t in targets:
        j = int(np.searchsorted(edges_bark, t))
        j = max(bounds[-1] + 1, min(j, n_bins - (Nb - len(bounds))))
        bounds.append(j)
    bounds.append(n_bins)
    nr = np.diff(bounds).astype(np.int64)
    width = edges_bark[bounds[1:]] - edges_bark[bounds[:-1]]
    centre = 0.5 * (edges_bark[bounds[1:]] + edges_bark[bounds[:-1]])
    ideal = total / Nb
    correction = 100.0 * ideal / width
    return nr, centre, width, correction, bounds


@functools.lru_cache(maxsize=2)
def get_mode(name: str) -> Mode:
    if name == "nb":
        fs, Nf, Nb, ds, align = 8000, 256, 42, 32, 512
        Sp, Sl = 2.764344e-5, 1.866055e-1
    elif name == "wb":
        fs, Nf, Nb, ds, align = 16000, 512, 49, 64, 1024
        Sp, Sl = 6.910853e-6, 1.866055e-1
    else:
        raise ValueError(name)
    nr, centre, width, corr, bounds = _partition_bins(fs, Nf, Nb)
    # thresholds: interpolate the published per-band curve on its own grid
    # position (42 bands span 0..~17.5 Bark; the wb tail extends to ~21)
    curve_x = np.linspace(centre[0], centre[-1], len(_ABS_THRESH_CURVE) if Nb == 49 else 42)
    curve_y = _ABS_THRESH_CURVE[: len(curve_x)]
    abs_thresh = np.interp(centre, curve_x, np.log(curve_y))
    abs_thresh = np.exp(abs_thresh)
    return Mode(
        name=name, fs=fs, Nf=Nf, Nb=Nb, downsample=ds, align_nfft=align,
        Sp=Sp, Sl=Sl,
        nr_of_hz_bands=nr, centre_of_band=centre, width_of_band=width,
        pow_dens_correction=corr, abs_thresh_power=abs_thresh,
    )


NB_MODE = "nb"
WB_MODE = "wb"
