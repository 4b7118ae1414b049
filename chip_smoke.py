#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. build the CUDA kernels from ``urgent2026_challenge_track1_tpu_torch/csrc``
     with nvcc and print the card's name, power limit and the build time;
  2. hold every kernel against its plain PyTorch version on the card at the
     main path's shapes, in float32 (TF32 off) and bfloat16;
  3. drive the main path through the port's inference CLI at full width
     (196 channels x 6 layers, random seeded weights) on 8-48 kHz WAVs:
     single-utterance, batched and long-form, and check that every kernel ran;
  4. compare a float32 forward on the card (kernels) with the same forward
     on the CPU (plain versions);
  5. time each kernel, its plain version and (for K1) cuDNN's LSTM, and the
     end-to-end forward at the JAX bench geometry.

The second line from the end is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a card, or without the port
package beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PKG = "urgent2026_challenge_track1_tpu_torch"

F32_TOL, BF16_TOL = 2e-4, 5e-2  # scripts/check_pallas_tpu.py:29-34
E2E_TOL = 1e-3                  # card (kernels) vs CPU (plain), float32 waveform
N_IN, HID = 196, 392            # BSRNN_baseline: num_channel 196, H = 2N
# main-path shapes (rows, steps) at 48 kHz (K = 34 bands): 4 s at B=1 and
# 2 s at B=4; time path rows B*K over the frames, band path rows B*frames
# over the bands
TIME_SHAPES = ((34, 401), (136, 201))
BAND_SHAPES = ((401, 34), (804, 34))
PEAK_BF16_FLOPS = 989e12        # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12            # HBM3


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def gpu_name_and_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------


def phase_build():
    from urgent2026_challenge_track1_tpu_torch.ops import _build

    res = _build.build()
    _build.load_library()
    print(f"[build] {res.path.name} built in {res.seconds:.1f} s")
    for line in res.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[build] {line.strip()}")
    print(gpu_name_and_power())
    return res


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------


def _lstm_weights(gen, n_in, hid, dtype, device):
    import torch

    bound = hid ** -0.5

    def u(*shape):
        return ((torch.rand(shape, generator=gen) * 2 - 1) * bound).to(device, dtype)

    return u(2, n_in, 4 * hid), u(2, hid, 4 * hid), u(2, 4 * hid)


def _kernel_inputs(R, T, dtype, device, seed):
    """Inputs of all three kernels at one shape, and lengths with 1 and T."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    x = (0.3 * torch.randn((R, T, N_IN), generator=gen)).to(device, dtype)
    w_ih_t, w_hh_t, bias = _lstm_weights(gen, N_IN, HID, dtype, device)
    xp = (0.3 * torch.randn((R, T, 4 * HID), generator=gen)).to(device, dtype)
    lengths = torch.randint(1, T + 1, (R,), generator=gen, dtype=torch.int32)
    lengths[0], lengths[-1] = 1, T
    return x, w_ih_t, w_hh_t, bias, xp, lengths.to(device)


def _err(a, b, valid=None):
    d = (a.float() - b.float()).abs()
    if valid is not None:
        d = d[valid]
    return float(d.max())


def phase_kernels(device):
    """max|kernel - plain| per kernel and dtype over the main-path shapes."""
    import torch
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K

    errs = {(k, dt): 0.0 for k in ("fusedin_bilstm", "lstm_scan", "lstm_revmasked")
            for dt in ("float32", "bfloat16")}
    for dt_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for R, T in TIME_SHAPES + BAND_SHAPES:
            x, w_ih_t, w_hh_t, bias, xp, lengths = _kernel_inputs(R, T, dtype, device, R * 1000 + T)
            got = K.fusedin_bilstm(x, w_ih_t, w_hh_t, bias)
            ref = K.fusedin_bilstm_plain(x, w_ih_t, w_hh_t, bias)
            torch.cuda.synchronize()
            e = _err(got, ref)
            errs["fusedin_bilstm", dt_name] = max(errs["fusedin_bilstm", dt_name], e)
            print(f"[kernels] fusedin_bilstm {dt_name} R={R} T={T}: max|d|={e:.3e}")
            if (R, T) in BAND_SHAPES:
                continue  # K2/K3 run on the time path only
            for reverse in (False, True):
                got = K.lstm_scan(xp, w_hh_t[0], reverse)
                ref = K.lstm_scan_plain(xp, w_hh_t[0], reverse)
                torch.cuda.synchronize()
                e = _err(got, ref)
                errs["lstm_scan", dt_name] = max(errs["lstm_scan", dt_name], e)
                print(f"[kernels] lstm_scan reverse={reverse} {dt_name} R={R} T={T}: max|d|={e:.3e}")
            got = K.lstm_revmasked(xp, w_hh_t[1], lengths)
            ref = K.lstm_revmasked_plain(xp, w_hh_t[1], lengths)
            torch.cuda.synchronize()
            valid = torch.arange(T, device=device)[None, :] < lengths[:, None]
            e = _err(got, ref, valid)
            errs["lstm_revmasked", dt_name] = max(errs["lstm_revmasked", dt_name], e)
            print(f"[kernels] lstm_revmasked {dt_name} R={R} T={T}: max|d| (t < len)={e:.3e}")
    for (name, dt_name), e in errs.items():
        tol = F32_TOL if dt_name == "float32" else BF16_TOL
        if not e < tol:
            fail(f"{name} {dt_name}: max|kernel - plain| {e:.3e} >= {tol}")
    return errs


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

# (uid, fs, seconds): 8-48 kHz, lengths that are not whole seconds
UTTERANCES = (("u48a", 48000, 3.7), ("u48b", 48000, 1.3), ("u22", 22050, 1.6),
              ("u16a", 16000, 2.45), ("u16b", 16000, 1.9), ("u8", 8000, 1.15))
LONG_UTTERANCES = (("long48", 48000, 2.5), ("long16", 16000, 2.5))


def _write_inputs(workdir: Path, items, name: str, seed: int) -> Path:
    import numpy as np
    from urgent2026_challenge_track1_tpu_torch.utils import audio_io

    rng = np.random.default_rng(seed)
    lines = []
    for uid, fs, sec in items:
        n = int(sec * fs)
        t = np.arange(n) / fs
        wav = 0.3 * np.sin(2 * np.pi * 220.0 * t) + 0.05 * rng.standard_normal(n)
        path = workdir / f"{uid}.wav"
        audio_io.write(str(path), wav, fs)
        lines.append(f"{uid} {path}")
    scp = workdir / name
    scp.write_text("\n".join(lines) + "\n")
    return scp


def _check_outputs(out_dir: Path, items) -> None:
    import numpy as np
    from urgent2026_challenge_track1_tpu_torch.utils import audio_io

    inf = dict(line.split() for line in (out_dir / "inf.scp").read_text().splitlines())
    for uid, fs, sec in items:
        y, yfs = audio_io.read(inf[uid])
        if yfs != fs or len(y) != int(sec * fs):
            fail(f"{uid}: got {len(y)} samples at {yfs} Hz, expected {int(sec * fs)} at {fs}")
        peak = float(np.abs(y).max())
        if not (np.isfinite(y).all() and 0.85 <= peak <= 0.901):
            fail(f"{uid}: output not finite or peak {peak} outside the 0.9 normalisation")


def phase_main_path(workdir: Path):
    """The port's inference CLI at full width; returns the launch counts of
    the three CLI runs together."""
    from urgent2026_challenge_track1_tpu_torch import inference
    from urgent2026_challenge_track1_tpu_torch.dsp.stft import STFTConfig
    from urgent2026_challenge_track1_tpu_torch.models.bsrnn import BSRNNConfig, init_bsrnn
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K
    from urgent2026_challenge_track1_tpu_torch.utils.checkpoint import save_model

    ckpt = workdir / "bsrnn_196x6.pt"
    save_model(str(ckpt), init_bsrnn(BSRNNConfig(num_channel=N_IN, num_layer=6), seed=0),
               STFTConfig())
    scp = _write_inputs(workdir, UTTERANCES, "in.scp", 0)
    scp_long = _write_inputs(workdir, LONG_UTTERANCES, "long.scp", 1)
    runs = (("single", scp, UTTERANCES, ["--batch_size", "1"]),
            ("batched", scp, UTTERANCES, ["--batch_size", "4"]),
            ("long-form", scp_long, LONG_UTTERANCES, ["--chunk_seconds", "1"]))
    K.reset_launch_counts()
    for name, run_scp, items, extra in runs:
        before = K.launch_counts()
        out_dir = workdir / f"out_{name}"
        t0 = time.perf_counter()
        inference.main(["--input_scp", str(run_scp), "--ckpt_path", str(ckpt),
                        "--output_dir", str(out_dir), "--device", "cuda", *extra])
        seconds = time.perf_counter() - t0
        _check_outputs(out_dir, items)
        delta = {k: v - before[k] for k, v in K.launch_counts().items()}
        print(f"[main path] {name}: {len(items)} files in {seconds:.2f} s, launches {delta}")
    counts = K.launch_counts()
    for name, n in counts.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
    print(f"[main path] launches over the three runs: {counts}")
    return counts


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------


def phase_card_vs_cpu(device) -> float:
    import copy

    import torch
    from urgent2026_challenge_track1_tpu_torch.dsp.stft import STFTConfig
    from urgent2026_challenge_track1_tpu_torch.models.bsrnn import (
        BSRNNConfig, bsrnn_se_apply, init_bsrnn)

    fs, n = 16000, 24000  # 1.5 s in a 2 s bucket
    cpu_model = init_bsrnn(BSRNNConfig(num_channel=N_IN, num_layer=6), seed=1)
    card_model = copy.deepcopy(cpu_model).to(device)
    gen = torch.Generator().manual_seed(2)
    x = torch.zeros((1, 2 * fs))
    x[0, :n] = 0.1 * torch.randn(n, generator=gen)
    lengths = torch.tensor([n], dtype=torch.int32)
    with torch.inference_mode():
        got, _ = bsrnn_se_apply(card_model, STFTConfig(), x.to(device), fs, lengths.to(device))
        ref, _ = bsrnn_se_apply(cpu_model, STFTConfig(), x, fs, lengths)
    err = float((got.cpu()[0, :n] - ref[0, :n]).abs().max())
    print(f"[card vs cpu] float32 196x6 forward, 1.5 s at 16 kHz: max|d|={err:.3e} "
          f"(tolerance {E2E_TOL}, peak {float(ref.abs().max()):.3f})")
    if not err < E2E_TOL:
        fail(f"card and CPU forwards differ by {err:.3e} >= {E2E_TOL}")
    return err


# ---------------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------------


def _time_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    """Median over ``reps`` runs of CUDA-event time around ``fn()``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _bounds(R, T, lengths_sum):
    """Least time (ms) for each kernel's bf16 work at one shape (each input
    byte read once, each output byte written once, the recurrent and input
    products as operations); K3 counts only the valid steps its outputs
    need."""
    N, H, b = N_IN, HID, 2
    return {
        "fusedin_bilstm": _bound(2 * 2 * R * (N + H) * 4 * H * T,
                                 b * (R * T * N + 2 * (N + H) * 4 * H + 2 * 4 * H
                                      + R * T * 2 * H)),
        "lstm_scan": _bound(2 * R * H * 4 * H * T,
                            b * (R * T * 4 * H + H * 4 * H + R * T * H)),
        "lstm_revmasked": _bound(2 * H * 4 * H * lengths_sum,
                                 b * (lengths_sum * 4 * H + H * 4 * H + lengths_sum * H)
                                 + 4 * R),
    }


def _row_tile_sweep(device):
    """K2 at the time path's B=1 and B=64 row counts with each row tile
    forced, beside the tile the wrapper picks (from R and the SM count)."""
    import torch
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K

    chooser = K.rows_per_block
    out = []
    for R in (TIME_SHAPES[0][0], 64 * TIME_SHAPES[0][0]):
        T = TIME_SHAPES[0][1]
        _, _, wh, _, xp, _ = _kernel_inputs(R, T, torch.bfloat16, device, R)
        picked = chooser(R, 1, device)
        for rows in (1, 2, 4, 8):
            K.rows_per_block = lambda *_, r=rows: r
            try:
                ms = _time_ms(lambda: K.lstm_scan(xp, wh[0]), reps=3, warmup=1)
            finally:
                K.rows_per_block = chooser
            out.append({"R": R, "T": T, "rows_per_block": rows, "picked": rows == picked,
                        "ms": ms})
    return out


def phase_times(device, main_counts, errs):
    import torch
    from urgent2026_challenge_track1_tpu_torch.dsp.stft import STFTConfig
    from urgent2026_challenge_track1_tpu_torch.models.bsrnn import (
        BSRNNConfig, bsrnn_se_apply, init_bsrnn)
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K

    bf16 = torch.bfloat16
    # main-path shapes at batch 1, 48 kHz, a 3.7 s input in a 4 s bucket:
    # band path R = 401 frames x T = 34 bands; time path R = 34 x T = 401
    # with 371 valid frames
    (band_R, band_T), (time_R, time_T), valid = BAND_SHAPES[0], TIME_SHAPES[0], 371
    xb, w_ih_t, w_hh_t, bias, _, _ = _kernel_inputs(band_R, band_T, bf16, device, 7)
    _, _, _, _, xp, _ = _kernel_inputs(time_R, time_T, bf16, device, 8)
    lengths = torch.full((time_R,), valid, dtype=torch.int32, device=device)
    # cuDNN's yardstick for K1; in bf16 flatten_parameters() is a no-op
    # (cudnn.is_acceptable excludes bf16), so each call compacts its weights
    lstm = torch.nn.LSTM(N_IN, HID, batch_first=True, bidirectional=True).to(device, bf16)
    timed = {
        "fusedin_bilstm": (lambda: K.fusedin_bilstm(xb, w_ih_t, w_hh_t, bias),
                           lambda: K.fusedin_bilstm_plain(xb, w_ih_t, w_hh_t, bias),
                           lambda: lstm(xb), (band_R, band_T)),
        "lstm_scan": (lambda: K.lstm_scan(xp, w_hh_t[0]),
                      lambda: K.lstm_scan_plain(xp, w_hh_t[0]), None, (time_R, time_T)),
        "lstm_revmasked": (lambda: K.lstm_revmasked(xp, w_hh_t[1], lengths),
                           lambda: K.lstm_revmasked_plain(xp, w_hh_t[1], lengths), None,
                           (time_R, time_T)),
    }

    # launches of one forward at the same geometry, with and without lengths
    model = init_bsrnn(BSRNNConfig(num_channel=N_IN, num_layer=6, compute_dtype="bfloat16"),
                       seed=3, device=device)
    wav = 0.1 * torch.randn((1, 4 * 48000), device=device)
    lens37 = torch.tensor([int(3.7 * 48000)], device=device)
    per_forward = {}
    with torch.inference_mode():
        for tag, lens in (("lengths", lens37), ("no_lengths", None)):
            K.reset_launch_counts()
            bsrnn_se_apply(model, STFTConfig(), wav, 48000, lens)
            per_forward[tag] = K.launch_counts()
        fwd_ms = _time_ms(lambda: bsrnn_se_apply(model, STFTConfig(), wav, 48000, lens37),
                          reps=3, warmup=1)
    print(f"[times] launches per forward (B=1, 48 kHz, 4 s bucket): {per_forward}")
    print(f"[times] forward with lengths, B=1, 3.7 s at 48 kHz, 196x6 bf16: {fwd_ms:.2f} ms")

    records = []
    with torch.inference_mode():
        for name, (kern, plain, library, (R, T)) in timed.items():
            ms = _time_ms(kern)
            plain_ms = _time_ms(plain, reps=3, warmup=1)
            library_ms = _time_ms(library) if library is not None else None
            bound_ms, bound_by = _bounds(R, T, R * valid)[name]
            rec = {
                "name": name, "route": "cuda",
                "source": f"{PKG}/csrc/lstm_kernels.cu",
                "replaces": REPLACES[name],
                "launches": main_counts[name],
                "max_abs_err": errs[name, "bfloat16"],
                "max_abs_err_f32": errs[name, "float32"],
                "tolerance": BF16_TOL, "tolerance_f32": F32_TOL,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms, "shape": {"R": R, "T": T, "N": N_IN, "H": HID},
                "dtype": "bfloat16",
                "launches_per_forward": per_forward["lengths"][name],
            }
            print(f"[times] {name} R={R} T={T} bf16: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                  f"library {library_ms} ms, bound {bound_ms:.4f} ms ({bound_by})")
            records.append(rec)
        # the same kernels at the JAX bench geometry (B=64, 4 s, 48 kHz)
        extra = []
        for name, R, T in (("fusedin_bilstm", 64 * 401, 34), ("fusedin_bilstm", 64 * 34, 401),
                           ("fusedin_bilstm", 34, 401), ("lstm_scan", 64 * 34, 401),
                           ("lstm_revmasked", 64 * 34, 401)):
            x, wi, wh, b, xq, _ = _kernel_inputs(R, T, bf16, device, R + T)
            lens = torch.full((R,), T, dtype=torch.int32, device=device)
            fn = {"fusedin_bilstm": lambda: K.fusedin_bilstm(x, wi, wh, b),
                  "lstm_scan": lambda: K.lstm_scan(xq, wh[0]),
                  "lstm_revmasked": lambda: K.lstm_revmasked(xq, wh[1], lens)}[name]
            ms = _time_ms(fn, reps=3, warmup=1)
            bound_ms, bound_by = _bounds(R, T, R * T)[name]
            extra.append({"name": name, "R": R, "T": T, "ms": ms, "bound_ms": bound_ms,
                          "bound_by": bound_by})
            del x, wi, wh, b, xq
        print("[times] " + json.dumps({"kernel_times_other_shapes": extra}))
        print("[times] " + json.dumps({"lstm_scan_row_tiles": _row_tile_sweep(device)}))

        # end-to-end forward at the JAX bench geometry (192 ch, B=64, 4 s, 48 kHz, bf16)
        model = init_bsrnn(BSRNNConfig(num_channel=192, num_layer=6, compute_dtype="bfloat16"),
                           seed=4, device=device)
        B, sec, fs = 64, 4, 48000
        wav = 0.1 * torch.randn((B, sec * fs), device=device)
        torch.cuda.reset_peak_memory_stats()
        e2e_ms = _time_ms(lambda: bsrnn_se_apply(model, STFTConfig(), wav, fs), reps=3, warmup=1)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[times] end-to-end forward B={B} x {sec} s at {fs} Hz, 192x6 bf16: {e2e_ms:.1f} ms, "
          f"RTF {B * sec / (e2e_ms / 1e3):.1f}x real time, peak memory {peak_gb:.2f} GB")
    return records


REPLACES = {
    "fusedin_bilstm": "urgent2026_challenge_track1_tpu/ops/pallas_lstm.py:196",
    "lstm_scan": "urgent2026_challenge_track1_tpu/ops/pallas_lstm.py:82",
    "lstm_revmasked": "urgent2026_challenge_track1_tpu/ops/pallas_lstm.py:1051",
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; no result", file=sys.stderr)
        return 2
    if not (REPO / PKG).is_dir():
        print(f"chip_smoke: {PKG}/ not found beside this script; no result", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)  # the timing inputs drawn on the card
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    phase_build()
    errs = phase_kernels(device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=REPO) as tmp:
        counts = phase_main_path(Path(tmp))
    phase_card_vs_cpu(device)
    records = phase_times(device, counts, errs)
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(gpu_name_and_power())
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
