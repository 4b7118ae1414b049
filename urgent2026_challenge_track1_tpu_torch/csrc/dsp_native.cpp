// Native DSP kernels for the host-side simulation engine.
//
// The reference shells out to ffmpeg for wind-noise ducking
// ("sidechaincompress...amix" filter graph, simulate_data_from_param.py:60-89)
// which costs a subprocess + two tmp-wav round-trips per sample.  Here the
// compressor is a native sequential kernel (the envelope follower is a
// data-dependent one-pole recurrence, unvectorizable in numpy), exposed via a
// C ABI for ctypes.
//
// Semantics follow ffmpeg's af_sidechaincompress defaults: RMS detection,
// average link, hard-ish knee (knee=1), makeup=1, mix=1:
//   attack_coeff  = min(1, 1 / (attack_ms  * fs / 4000))
//   release_coeff = min(1, 1 / (release_ms * fs / 4000))
//   power[n] tracks (sc*level_sc)^2 with attack/release smoothing
//   gain = (threshold / rms)^(1 - 1/ratio)  when rms > threshold else 1
//
// Build: g++ -O3 -shared -fPIC -o libdsp_native.so dsp_native.cpp

#include <cmath>
#include <cstdint>

extern "C" {

// y[n] = speech[n] * gain(sidechain up to n); mono, in-place safe.
void sidechain_compress(const double* speech, const double* sidechain,
                        int64_t n, double fs, double threshold, double ratio,
                        double attack_ms, double release_ms, double level_sc,
                        double* out) {
  double attack_coeff = 1.0 / (attack_ms * fs / 4000.0);
  if (attack_coeff > 1.0) attack_coeff = 1.0;
  double release_coeff = 1.0 / (release_ms * fs / 4000.0);
  if (release_coeff > 1.0) release_coeff = 1.0;
  const double delta = 1.0 - 1.0 / ratio;  // gain exponent
  const double thres2 = threshold * threshold;
  double lin_slope = 0.0;  // tracked power
  for (int64_t i = 0; i < n; ++i) {
    double det = sidechain[i] * level_sc;
    det *= det;  // RMS detection tracks power
    const double coeff = det > lin_slope ? attack_coeff : release_coeff;
    lin_slope += (det - lin_slope) * coeff;
    double gain = 1.0;
    if (lin_slope > thres2 && lin_slope > 0.0) {
      // (threshold / rms)^delta computed in log domain for stability
      gain = exp(0.5 * delta * (log(thres2) - log(lin_slope)));
    }
    out[i] = speech[i] * gain;
  }
}

// One-pole smoother with separate rise/fall coefficients (envelope follower).
void envelope_follow(const double* x, int64_t n, double rise, double fall,
                     double* out) {
  double state = 0.0;
  for (int64_t i = 0; i < n; ++i) {
    const double v = x[i];
    state += (v - state) * (v > state ? rise : fall);
    out[i] = state;
  }
}

}  // extern "C"
