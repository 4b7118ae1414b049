#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; each prints its seconds):
  1. build the CUDA kernels from ``urgent2026_challenge_track1_tpu_torch/csrc``
     with nvcc and print the card's name, power limit and the build time;
  2. hold every kernel against its plain PyTorch version on the card at the
     main paths' shapes, in float32 (TF32 off) and bfloat16: the inference
     kernels K1 (its walk) - K3, then the training kernels K4-K7 (h, gates,
     c, dx_proj, dW), at the discriminative width (H = 392) and at the flow
     model's (H = 768); then K8-K10 at both widths' training shapes, and
     K9/K10 against K4/K5 run per direction (bitwise equal); then K1p, K1's
     persistent bfloat16 route, against the plain version and the walk at
     the seven shapes where K1 runs, with its plan and its, the walk's and
     cuDNN's times (the k1_routes phase); then K2p and K3p, the persistent
     bfloat16 routes of K2 and K3, against the plain versions and the walks
     at every step at the five shapes where they run, with their plans, a
     planted stale-h fault, their, the walks' and the plain versions' times
     and an S sweep (the scan_routes phase); then K4p and K6p, the
     persistent routes of K4 and K6 in bfloat16 and in float32 (K4p-f32,
     K6p-f32: 3xTF32 products), against the plain versions (h, gates and
     c at every step) at the train steps' shapes and an odd H, with a
     planted stale-h fault (in float32 also the walk with one TF32 product,
     which the limit must refuse), two launches bitwise equal, K5 / K7 on their
     residuals against the plain chain, their plans (checked against the
     kernel's bytes) and their, the walks', the plain versions' and a
     one-direction torch.nn.LSTM training forward's times (the
     train_routes phase);
     then K5p and K7p, the persistent routes of K5 and K7 in bfloat16 and
     in float32 (K5p-f32, K7p-f32: 3xTF32 products and a float32 dW
     kernel), against the plain versions (dx_proj at every step) at the
     same shapes, their dW kernel against the float64 product of its own
     operands, with a planted stale-dgates fault (in float32 also the
     backward with one TF32 product, and the dW of TF32-rounded operands,
     which the limits must refuse), two launches bitwise equal, their
     plans, and their, the walks' (in float32 also the walk's dw_kernel
     alone), the dW kernel's, torch.mm's for dW, the plain versions' and
     a one-direction torch.nn.LSTM backward's times (the bwd_routes
     phase);
  3. drive the inference path through the port's CLI at full width (196
     channels x 6 layers, random seeded weights) on 8-48 kHz WAVs, and the
     training path through the port's ``train_se.run`` (196 x 6, batch 4,
     2 s at 48 kHz, 2 epochs of 2 steps with validation and checkpoints,
     then a resumed third epoch); then the flow-matching family: ``train_se.run``
     with model_type=flowse at 384 x 6 (batch 2, 2 s at 48 kHz, validation
     with the N = 10 sampler, EMA, a resume) and the inference CLI on its
     checkpoint with the euler and heun solvers; check that every kernel of
     each path ran, and that K1-K3 took K1p-K3p on the bfloat16 paths (the
     CLIs) and the walks on the float32 ones (the training runs'
     validations; a train step runs none of K1-K3), and that on the float32
     training runs K4-K7 took K4p-f32 - K7p-f32; the batched CLI run reads
     its inputs as FLAC; then the dynamic-mixing config
     (BSRNN_baseline_dm.yaml: 196 x 6, B=4, 2 s at 48 kHz, float32) through
     ``train_se.run`` for 2 steps and a validation, its batches rendered by
     two spawned workers from FLAC speech sources (K4p-f32 - K7p-f32, no
     walk of K4-K7; the steps' and the loader's times); a reference
     ``.ckpt`` at 196 x 6 warm-starts a trainer through ``init_from``
     (bitwise equal to the converted weights, then one step); one RK45
     flow enhancement (scipy solve_ivp, rtol = atol = 1e-5) from the flow
     training's checkpoint in bfloat16 (nfev K1p forwards); then one
     float32 train step at 510 channels (H = 1020, where no float32
     K4p/K6p plan fits) takes the walks of K4 and K6 and K5p-f32 / K7p-f32;
  4. the A/B arms of the two experiment toggles (default, STREAM_INPUT_TRAIN,
     FUSED_BIDIR_TRAIN, both, in alternating order) on one train step of
     each family: launches per kernel, loss and gradients against the
     default arm, step times; K8-K10 run here;
  5. compare a float32 forward, and one float32 train step's gradients, on
     the card (kernels) with the same on the CPU (plain versions), for both
     families;
  6. time each kernel, its plain version and (for K1) cuDNN's LSTM, the
     end-to-end forward at the JAX bench geometry, the train step at the
     baseline geometry in float32 and bfloat16 with its peak memory and
     launches per step and K4-K7's routes per dtype (K4p-K7p and their dW
     kernel in either dtype; no train step runs a walk),
     K1-K7 at the flow shapes,
     K8-K10 at both widths' training shapes, the flow train step and one
     flow enhancement.

The second line from the end is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a card, or without the port
package beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PKG = "urgent2026_challenge_track1_tpu_torch"

F32_TOL, BF16_TOL = 2e-4, 5e-2  # scripts/check_pallas_tpu.py:29-34
GRAD_TOL = 1e-3                 # f32 gradients, relative (max|d| / max|ref|), same source
E2E_TOL = 1e-3                  # card (kernels) vs CPU (plain), float32 waveform and grads
N_IN, HID = 196, 392            # BSRNN_baseline: num_channel 196, H = 2N
# main-path shapes (rows, steps) at 48 kHz (K = 34 bands): 4 s at B=1 and
# 2 s at B=4; time path rows B*K over the frames, band path rows B*frames
# over the bands
TIME_SHAPES = ((34, 401), (136, 201))
BAND_SHAPES = ((401, 34), (804, 34))
# the training step at the baseline geometry (B=4, 2 s at 48 kHz): time
# path rows 4 x 34 bands over 201 frames, band path rows 4 x 201 frames
# over 34 bands
TRAIN_TIME, TRAIN_BAND = (136, 201), (804, 34)
TRAIN_SECONDS = (2.0, 1.9, 1.8, 1.7)  # one batch of the training phase's data
# the flow model (conf/models/BSRNN_flowse.yaml): bsrnn_hidden 384, H = 2N;
# at 48 kHz n_fft 1536, hop 384, K = 48 bands; its training batch B=2 of 2 s
# buckets (T = 251 frames): time path rows 2 x 48 over 251 frames, band
# path rows 2 x 251 over 48 bands
FLOW_N, FLOW_H = 384, 768
FLOW_TIME, FLOW_BAND = (96, 251), (502, 48)
FLOW_SECONDS = (2.0, 1.9)  # one batch of the flow training phase's data
PEAK_BF16_FLOPS = 989e12        # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_TF32_FLOPS = 495e12        # H100 SXM dense TF32, same source
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


def _kernel_inputs(R, T, dtype, device, seed, n_in=None, hid=None):
    """Inputs of all three kernels at one shape (the discriminative widths
    unless given), and lengths with 1 and T."""
    import torch

    n_in, hid = n_in or N_IN, hid or HID
    gen = torch.Generator().manual_seed(seed)
    x = (0.3 * torch.randn((R, T, n_in), generator=gen)).to(device, dtype)
    w_ih_t, w_hh_t, bias = _lstm_weights(gen, n_in, hid, dtype, device)
    xp = (0.3 * torch.randn((R, T, 4 * hid), generator=gen)).to(device, dtype)
    lengths = torch.randint(1, T + 1, (R,), generator=gen, dtype=torch.int32)
    lengths[0], lengths[-1] = 1, T
    return x, w_ih_t, w_hh_t, bias, xp, lengths.to(device)


def _err(a, b, valid=None):
    d = (a.float() - b.float()).abs()
    if valid is not None:
        d = d[valid]
    return float(d.max())


INFERENCE_KERNELS = ("fusedin_bilstm", "lstm_scan", "lstm_revmasked")
# K4-K7: two routes each
TRAIN_ROUTED = ("lstm_train_fwd", "lstm_revmasked_train_fwd", "lstm_train_bwd",
                "lstm_revmasked_bwd")


def phase_kernels(device, n_in=N_IN, hid=HID, time_shapes=TIME_SHAPES, band_shapes=BAND_SHAPES):
    """max|kernel - plain| per kernel and dtype over the main-path shapes, for
    the walks of K1-K3 (their bfloat16 persistent routes: the k1_routes and
    scan_routes phases)."""
    import torch
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K

    errs = {(k, dt): 0.0 for k in INFERENCE_KERNELS for dt in ("float32", "bfloat16")}
    for dt_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for R, T in time_shapes + band_shapes:
            x, w_ih_t, w_hh_t, bias, xp, lengths = _kernel_inputs(R, T, dtype, device,
                                                                  R * 1000 + T, n_in, hid)
            got = K.fusedin_bilstm_walk(x, w_ih_t, w_hh_t, bias)
            ref = K.fusedin_bilstm_plain(x, w_ih_t, w_hh_t, bias)
            torch.cuda.synchronize()
            e = _err(got, ref)
            errs["fusedin_bilstm", dt_name] = max(errs["fusedin_bilstm", dt_name], e)
            print(f"[kernels] fusedin_bilstm (walk) {dt_name} R={R} T={T} H={hid}: "
                  f"max|d|={e:.3e}")
            if (R, T) in band_shapes:
                continue  # K2/K3 run on the time path only
            for reverse in (False, True):
                got = K.lstm_scan_walk(xp, w_hh_t[0], reverse)
                ref = K.lstm_scan_plain(xp, w_hh_t[0], reverse)
                torch.cuda.synchronize()
                e = _err(got, ref)
                errs["lstm_scan", dt_name] = max(errs["lstm_scan", dt_name], e)
                print(f"[kernels] lstm_scan (walk) reverse={reverse} {dt_name} R={R} T={T}: "
                      f"max|d|={e:.3e}")
            got = K.lstm_revmasked_walk(xp, w_hh_t[1], lengths)
            ref = K.lstm_revmasked_plain(xp, w_hh_t[1], lengths)
            torch.cuda.synchronize()
            valid = torch.arange(T, device=device)[None, :] < lengths[:, None]
            e = _err(got, ref, valid)
            errs["lstm_revmasked", dt_name] = max(errs["lstm_revmasked", dt_name], e)
            print(f"[kernels] lstm_revmasked (walk) {dt_name} R={R} T={T}: max|d| (t < len)="
                  f"{e:.3e}")
    for (name, dt_name), e in errs.items():
        tol = F32_TOL if dt_name == "float32" else BF16_TOL
        if not e < tol:
            fail(f"{name} {dt_name}: max|kernel - plain| {e:.3e} >= {tol}")
    return errs


def _rel(a, b):
    """max|a - b| / max|b|."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / (b.abs().max() + 1e-12))


def _frames_lengths(R, T, device, seconds=TRAIN_SECONDS, hop=480):
    """Valid frames of each time-path row for a training batch (``seconds``
    at 48 kHz, ``hop``), each utterance over its bands."""
    import torch

    frames = [1 + int(sec * 48000) // hop for sec in seconds]
    per_row = torch.tensor(frames, dtype=torch.int32).repeat_interleave(R // len(frames))
    return per_row.clamp(max=T).to(device)


def _error_table():
    """{(kernel, dtype): (max abs error, max relative error or None)} and the
    function that folds one comparison into it; forward kernels measure no
    relative error, so theirs stays None."""
    errs = {}

    def note(name, dt_name, e_abs, e_rel=None):
        old_abs, old_rel = errs.get((name, dt_name), (0.0, None))
        rel = old_rel if e_rel is None else max(old_rel or 0.0, e_rel)
        errs[name, dt_name] = (max(old_abs, e_abs), rel)

    return errs, note


def phase_train_kernels(device, hid=HID, shapes=(TRAIN_TIME, TRAIN_BAND),
                        seconds=TRAIN_SECONDS, hop=480):
    """K4-K7 against their plain versions at the training step's shapes
    (their walks; the persistent routes: the train_routes and bwd_routes
    phases): max abs error of h, gates, c (forward) and max
    relative error of dx_proj and dW (backward, each run on the plain
    forward's residuals).  Returns {(kernel, dtype): (abs error, relative
    error or None)}."""
    import torch
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K

    errs, note = _error_table()
    for dt_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for R, T in shapes:
            _, _, w_hh_t, _, xp, _ = _kernel_inputs(R, T, dtype, device, R * 7 + T, hid=hid)
            gen = torch.Generator().manual_seed(R + T)
            dout = torch.randn((R, T, hid), generator=gen).to(device, dtype)
            for reverse in (False, True):
                got = K.lstm_train_fwd_walk(xp, w_hh_t[0], reverse)
                ref = K.lstm_train_fwd_plain(xp, w_hh_t[0], reverse)
                torch.cuda.synchronize()
                note("lstm_train_fwd", dt_name, max(_err(g, r) for g, r in zip(got, ref)))
                got = K.lstm_train_bwd_walk(*ref, dout, w_hh_t[0], reverse)
                want = K.lstm_train_bwd_plain(*ref, dout, w_hh_t[0], reverse)
                torch.cuda.synchronize()
                note("lstm_train_bwd", dt_name, max(_err(g, r) for g, r in zip(got, want)),
                     max(_rel(g, r) for g, r in zip(got, want)))
            if (R, T) != shapes[0]:
                continue  # K6/K7 run on the time path only
            lengths = _frames_lengths(R, T, device, seconds, hop)
            valid = torch.arange(T, device=device)[None, :] < lengths[:, None]
            dmask = dout * valid[..., None]
            got = K.lstm_revmasked_train_fwd_walk(xp, w_hh_t[1], lengths)
            ref = K.lstm_revmasked_train_fwd_plain(xp, w_hh_t[1], lengths)
            torch.cuda.synchronize()
            note("lstm_revmasked_train_fwd", dt_name,
                 max(_err(g, r, valid) for g, r in zip(got, ref)))
            got = K.lstm_revmasked_bwd_walk(*ref, lengths, dmask, w_hh_t[1])
            want = K.lstm_revmasked_bwd_plain(*ref, lengths, dmask, w_hh_t[1])
            torch.cuda.synchronize()
            note("lstm_revmasked_bwd", dt_name, max(_err(g, r) for g, r in zip(got, want)),
                 max(_rel(g, r) for g, r in zip(got, want)))
    for (name, dt_name), (e_abs, e_rel) in sorted(errs.items()):
        backward = name.endswith("bwd")
        tol = BF16_TOL if dt_name == "bfloat16" else (GRAD_TOL if backward else F32_TOL)
        e = e_rel if backward else e_abs
        kind = "max rel|d| (dx_proj, dW)" if backward else "max|d| (h, gates, c)"
        print(f"[train kernels] {name} {dt_name} H={hid}: {kind}={e:.3e} (tolerance {tol}), "
              f"max|d|={e_abs:.3e}")
        if not e < tol:
            fail(f"{name} {dt_name}: kernel vs plain {e:.3e} >= {tol}")
    return errs


# ---------------------------------------------------------------------------
# K1's two routes (phase 2)
# ---------------------------------------------------------------------------

# the shapes where K1 runs, (what, R, T, N, H): one utterance's band path
# (B=1, 4 s at 48 kHz), the band path of a B=4, 2 s CLI batch, the bench
# forward's band and time paths (B=64, 4 s, 192 channels, no lengths), the
# band path of a B=2, 2 s flow batch (the flow training's validation, a flow
# CLI batch), one flow enhancement's band and time paths (B=1, 4 s); since
# remat runs the training kernels in both passes no train step runs K1
K1_ROUTE_SHAPES = (("disc band B=1", 401, 34, N_IN, HID),
                   ("B=4 band", 804, 34, N_IN, HID),
                   ("bench band B=64", 64 * 401, 34, 192, 384),
                   ("bench time B=64", 64 * 34, 401, 192, 384),
                   ("flow band B=2", 502, 48, FLOW_N, FLOW_H),
                   ("flow enhance band B=1", 501, 48, FLOW_N, FLOW_H),
                   ("flow enhance time B=1", 48, 501, FLOW_N, FLOW_H))


def phase_k1_routes(device):
    """K1p against the plain version and against the walk (itself held
    against the plain version) at the seven shapes where K1 runs, bfloat16:
    max abs differences, the plan (S, G, U, shared memory, checked against
    the kernel's own reckoning), K1p, walk and cuDNN bfloat16 ``nn.LSTM``
    ms (medians of ``_time_ms``), the weight pack's ms, the bound, and the
    route the rule takes.  Fails if K1p differs from either by the K1p limit
    (``persistent_checks.ulp_limit`` of the plain output) or more, if the
    walk differs from the plain version by BF16_TOL or more, or if the
    planted fault (a stale h, ``persistent_checks.fusedin_bilstm_stale_h``)
    stays under the limit."""
    import torch
    from urgent2026_challenge_track1_tpu_torch.ops import _build
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K
    from urgent2026_challenge_track1_tpu_torch.ops import persistent_checks as PC

    bf16 = torch.bfloat16
    sms = _sm_count(device)
    lib = _build.load_library()
    out = []
    for what, R, T, N, H in K1_ROUTE_SHAPES:
        x, wi, wh, b, _, _ = _kernel_inputs(R, T, bf16, device, R + T, N, H)
        plan = K.plan_persistent(R, N, H, sms)
        if plan is None:
            fail(f"K1p: no plan at {what} (R={R}, N={N}, H={H})")
        kernel_smem = lib.lstm_persistent_smem(N, H, plan.U, plan.rows, plan.chunk,
                                                int(plan.c_in_smem), 2)
        if kernel_smem != plan.smem:
            fail(f"K1p plan at {what}: {plan.smem} bytes, the kernel reckons {kernel_smem}")
        route = K.k1_route(bf16, R, N, H, sms)
        with torch.inference_mode():
            got = K.fusedin_bilstm_persistent(x, wi, wh, b, plan)
            walk = K.fusedin_bilstm_walk(x, wi, wh, b)
            ref = K.fusedin_bilstm_plain(x, wi, wh, b)
            torch.cuda.synchronize()
            e_plain, e_walk, e_walk_plain = _err(got, ref), _err(got, walk), _err(walk, ref)
            limit = PC.ulp_limit(ref)
            del got, walk
            e_stale = _err(PC.fusedin_bilstm_stale_h(x, wi, wh, b), ref)
            del ref
            k1p_ms = _time_ms(lambda: K.fusedin_bilstm_persistent(x, wi, wh, b, plan))
            pack_ms = _time_ms(lambda: K.pack_persistent_weights(wi, wh, b, plan))
            walk_ms = _time_ms(lambda: K.fusedin_bilstm_walk(x, wi, wh, b))
            lstm = torch.nn.LSTM(N, H, batch_first=True, bidirectional=True).to(device, bf16)
            cudnn_ms = _time_ms(lambda: lstm(x))
        bound_ms, bound_by = _bounds(R, T, 0, N, H)["fusedin_bilstm"]
        rec = {"what": what, "R": R, "T": T, "N": N, "H": H,
               "plan": {"S": plan.S, "G": plan.G, "U": plan.U, "rows": plan.rows,
                        "chunk": plan.chunk, "c_in_smem": plan.c_in_smem,
                        "smem_bytes": plan.smem, "ctas": plan.ctas},
               "route": "persistent" if route is not None else "walk",
               "max_abs_err_vs_plain": e_plain, "max_abs_err_vs_walk": e_walk,
               "walk_max_abs_err_vs_plain": e_walk_plain, "k1p_limit": limit,
               "planted_stale_h_err": e_stale,
               "k1p_ms": k1p_ms, "walk_ms": walk_ms, "cudnn_ms": cudnn_ms, "pack_ms": pack_ms,
               "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"[k1 routes] {what} R={R} T={T} N={N} H={H}: plan S={plan.S} G={plan.G} "
              f"U={plan.U} chunk={plan.chunk} smem={plan.smem} B ({plan.ctas} CTAs); K1p "
              f"{k1p_ms:.3f} ms (its weight pack {pack_ms:.4f} ms), walk {walk_ms:.3f} ms, "
              f"cuDNN {cudnn_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
              f"max|K1p - plain| {e_plain:.3e}, max|K1p - walk| {e_walk:.3e} (limit "
              f"{limit:.3e}), max|walk - plain| {e_walk_plain:.3e} (limit {BF16_TOL}); "
              f"planted stale h: max|d| {e_stale:.3e}; rule: {rec['route']}")
        for name, e, tol in (("K1p vs plain", e_plain, limit), ("K1p vs walk", e_walk, limit),
                             ("walk vs plain", e_walk_plain, BF16_TOL)):
            if not e < tol:
                fail(f"{what}: {name} {e:.3e} >= {tol:.3e}")
        if not e_stale >= limit:
            fail(f"{what}: a stale h moves the output by {e_stale:.3e}, under the K1p "
                 f"limit {limit:.3e}: the check cannot see a barrier fault")
        out.append(rec)
        del x, wi, wh, b, lstm
    return out


# ---------------------------------------------------------------------------
# K2's and K3's two routes (phase 2)
# ---------------------------------------------------------------------------

# the shapes where K2 and K3 run on the bfloat16 CLI, (what, R, T, H, valid
# frames of each utterance, its rows in order): one utterance at 48 kHz (B=1,
# 3.7 s in a 4 s bucket: 34 bands over 401 frames, 371 valid; the main
# path), a B=4 batch in a 2 s bucket (4 x 34 bands over 201 frames), one
# utterance at 16 kHz (B=1, 3.7 s in 4 s, hop 160: the bands ``band_count``
# gives at 16 kHz (None below) over 401 frames), the flow CLI (B=1, 3.7 s in 4 s at 48 kHz, hop 384: 48 bands
# over 501 frames, H = 768), and an odd H (2-byte copies of x_proj and h)
SCAN_ROUTE_SHAPES = (("disc one utterance B=1", 34, 401, HID, (371,)),
                     ("disc CLI batch B=4", 136, 201, HID, (201, 191, 181, 171)),
                     ("disc 16 kHz B=1", None, 401, HID, (371,)),
                     ("flow CLI B=1", 48, 501, FLOW_H, (463,)),
                     ("odd H", 20, 64, 197, (64, 40, 17, 1)))
# SM counts handed to the planner for the S sweep (fewer SMs, wider U)
S_SWEEP_SMS = (132, 66, 33, 14, 7)


def phase_scan_routes(device):
    """K2p and K3p against the plain versions and against the walks (each
    held against the plain version) at every step, padded ones included, at
    the shapes where K2 and K3 run on the bfloat16 CLI: max abs differences,
    the plan (checked against the kernel's own byte count), K2p/K3p, walk and
    plain ms, the weight pack's ms, the bound, the route the rule takes, a
    one-direction bf16 ``torch.nn.LSTM`` inference forward's ms (a superset),
    and at the one-utterance and flow shapes K2p/K3p ms for the plans of
    fewer SMs (a narrower S).  Fails if K2p or K3p differs from either by the ulp
    limit (``persistent_checks.ulp_limit`` of the plain output) or more, if
    a walk differs from the plain version by BF16_TOL or more, or if the
    planted fault (a stale h, ``persistent_checks.lstm_scan_stale_h``)
    stays under the limit."""
    import torch
    from urgent2026_challenge_track1_tpu_torch.ops import _build
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K
    from urgent2026_challenge_track1_tpu_torch.ops import persistent_checks as PC

    from urgent2026_challenge_track1_tpu_torch.models.bsrnn import BSRNNConfig, band_count

    bf16 = torch.bfloat16
    sms = _sm_count(device)
    lib = _build.load_library()
    low_rate_rows = band_count(BSRNNConfig().input_dim, 48000, 16000, 161)  # n_fft 320 at 16 kHz
    out = []
    for what, R, T, H, per_utt in SCAN_ROUTE_SHAPES:
        R = R or low_rate_rows
        _, _, wh, _, xp, _ = _kernel_inputs(R, T, bf16, device, R + T + H, hid=H)
        lengths = torch.tensor(per_utt, dtype=torch.int32).repeat_interleave(
            R // len(per_utt)).to(device)
        plan = K.plan_persistent(R, 0, H, sms, dirs=1)
        if plan is None:
            fail(f"K2p/K3p: no plan at {what} (R={R}, H={H})")
        kernel_smem = lib.lstm_persistent_smem(0, H, plan.U, plan.rows, plan.chunk,
                                                int(plan.c_in_smem), 2)
        if kernel_smem != plan.smem:
            fail(f"K2p/K3p plan at {what}: {plan.smem} bytes, the kernel reckons {kernel_smem}")
        route = K.scan_route(bf16, R, H, sms)
        bounds = _bounds(R, T, int(lengths.sum()), hid=H)
        rec = {"what": what, "R": R, "T": T, "H": H, "valid_steps": int(lengths.sum()),
               "plan": {"S": plan.S, "G": plan.G, "U": plan.U, "rows": plan.rows,
                        "chunk": plan.chunk, "c_in_smem": plan.c_in_smem,
                        "smem_bytes": plan.smem, "ctas": plan.ctas},
               "route": "persistent" if route is not None else "walk"}
        with torch.inference_mode():
            runs = {
                "lstm_scan": (lambda p=plan: K.lstm_scan_persistent(xp, wh[0], False, p),
                              lambda: K.lstm_scan_walk(xp, wh[0]),
                              lambda: K.lstm_scan_plain(xp, wh[0]),
                              lambda: PC.lstm_scan_stale_h(xp, wh[0], False)),
                "lstm_revmasked": (
                    lambda p=plan: K.lstm_revmasked_persistent(xp, wh[1], lengths, p),
                    lambda: K.lstm_revmasked_walk(xp, wh[1], lengths),
                    lambda: K.lstm_revmasked_plain(xp, wh[1], lengths),
                    lambda: PC.lstm_scan_stale_h(xp, wh[1], True, lengths)),
            }
            for name, (kern, walk_fn, plain_fn, stale_fn) in runs.items():
                got, walk, ref = kern(), walk_fn(), plain_fn()
                torch.cuda.synchronize()
                e_plain, e_walk, e_walk_plain = _err(got, ref), _err(got, walk), _err(walk, ref)
                limit = PC.ulp_limit(ref)
                e_stale = _err(stale_fn(), ref)
                del got, walk, ref
                ms = _time_ms(kern)
                bound_ms, bound_by = bounds[name]
                rec[name] = {"max_abs_err_vs_plain": e_plain, "max_abs_err_vs_walk": e_walk,
                             "walk_max_abs_err_vs_plain": e_walk_plain, "limit": limit,
                             "planted_stale_h_err": e_stale, "ms": ms,
                             "us_per_step": ms * 1e3 / T, "walk_ms": _time_ms(walk_fn),
                             "plain_ms": _time_ms(plain_fn, reps=3, warmup=1),
                             "bound_ms": bound_ms, "bound_by": bound_by}
                if H == HID and R == 34 or H == FLOW_H:
                    rec[name]["s_sweep"] = []
                    for cap in S_SWEEP_SMS:
                        p = K.plan_persistent(R, 0, H, cap, dirs=1)
                        if p is not None:
                            rec[name]["s_sweep"].append(
                                {"sms": cap, "S": p.S, "U": p.U, "ctas": p.ctas,
                                 "ms": _time_ms(lambda p=p: kern(p))})
                r = rec[name]
                print(f"[scan routes] {what} {name} R={R} T={T} H={H}: plan S={plan.S} "
                      f"G={plan.G} U={plan.U} chunk={plan.chunk} smem={plan.smem} B "
                      f"({plan.ctas} CTAs); persistent {r['ms']:.3f} ms "
                      f"({r['us_per_step']:.2f} us a step), walk {r['walk_ms']:.3f} ms, plain "
                      f"{r['plain_ms']:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
                      f"max|p - plain| {e_plain:.3e}, max|p - walk| {e_walk:.3e} (limit "
                      f"{limit:.3e}), max|walk - plain| {e_walk_plain:.3e} (limit {BF16_TOL}); "
                      f"planted stale h: max|d| {e_stale:.3e}; rule: {rec['route']}"
                      + (f"; S sweep {r['s_sweep']}" if "s_sweep" in r else ""))
                for check, e, tol in (("vs plain", e_plain, limit), ("vs walk", e_walk, limit),
                                      ("walk vs plain", e_walk_plain, BF16_TOL)):
                    if not e < tol:
                        fail(f"{what} {name}: {check} {e:.3e} >= {tol:.3e}")
                if not e_stale >= limit:
                    fail(f"{what} {name}: a stale h moves the output by {e_stale:.3e}, under "
                         f"the limit {limit:.3e}: the check cannot see a barrier fault")
            rec["pack_ms"] = _time_ms(lambda: K.pack_scan_weights(wh[0], plan))
        rec["nn_lstm_forward_ms"] = _lstm_forward_reference_ms(device, R, T, H, bf16, False)
        out.append(rec)
        del xp, wh
    return out


# ---------------------------------------------------------------------------
# K4's and K6's two routes (phase 2)
# ---------------------------------------------------------------------------

# the shapes where K4 and K6 run in a train step, (what, R, T, H, valid
# frames of each utterance or None): the disc step's time and band paths
# (B=4, 2 s at 48 kHz: 4 x 34 bands over 201 frames, 4 x 201 frames over 34
# bands), the flow step's (B=2, 2 s, hop 384: 2 x 48 bands over 251 frames,
# 2 x 251 frames over 48 bands, H = 768), and an odd H (2-byte copies in
# bfloat16, 4-byte ones in float32); K6 runs where there are lengths (the
# time paths)
TRAIN_ROUTE_SHAPES = (
    ("disc time B=4", *TRAIN_TIME, HID, tuple(1 + int(s * 48000) // 480 for s in TRAIN_SECONDS)),
    ("disc band B=4", *TRAIN_BAND, HID, None),
    ("flow time B=2", *FLOW_TIME, FLOW_H, tuple(1 + int(s * 48000) // 384 for s in FLOW_SECONDS)),
    ("flow band B=2", *FLOW_BAND, FLOW_H, None),
    ("odd H", 20, 64, 197, (64, 40, 17, 1)))
RESIDUALS = ("h", "gates", "c")
RUN_TAGS = ("lstm_train_fwd", "lstm_train_fwd_reverse", "lstm_revmasked_train_fwd")
# K4-K7 take their persistent routes in float32 too (K4p-f32 - K7p-f32);
# K1-K3 take their walks there
F32_PERSISTENT = ("lstm_train_fwd", "lstm_revmasked_train_fwd", "lstm_train_bwd",
                  "lstm_revmasked_bwd")


def _lstm_forward_reference_ms(device, R, T, H, dtype, train):
    """A one-direction ``torch.nn.LSTM`` forward (N = H / 2 inputs, as in
    both models) over R rows of T steps in ``dtype`` (TF32 off), recording
    for autograd when ``train`` (the training forward keeps its residuals):
    a superset of K2-K4's and K6's work (it adds the W_ih products)."""
    import torch

    N = max(1, H // 2)
    lstm = torch.nn.LSTM(N, H, batch_first=True).to(device, dtype).train(train)
    x = (0.3 * torch.randn((R, T, N), device=device)).to(dtype).requires_grad_(train)
    with torch.set_grad_enabled(train):
        ms = _time_ms(lambda: lstm(x))
    del lstm, x
    return ms


def phase_train_routes(device):
    """K4p (forward and reverse) and K6p against the plain versions at every
    step, padded ones included, at the shapes where K4 and K6 run in a train
    step, in bfloat16 and in float32 (K4p-f32 / K6p-f32, 3xTF32 products,
    TF32 off in the plain versions): h, gates and c each within
    ``persistent_checks.persistent_limit`` of its plain output (4 bf16 ulps
    at its peak; F32_LIMIT in float32); the planted fault
    (``persistent_checks.lstm_scan_stale_h`` with the residuals) must exceed
    that limit, and in float32 so must the plain walk with one TF32 product
    (``persistent_checks.lstm_scan_tf32``, the control that tells 3xTF32
    from a kernel below float32) in each output; two launches must be bitwise equal (remat runs the forward
    in both passes); K5 (K7 for K6p) on the kernel's residuals must stay
    within BF16_TOL (bfloat16; GRAD_TOL in float32) of K5's plain version on
    the plain forward's, relative.  Records per dtype the plan (checked
    against the kernel's own byte count), the route the rule takes, the
    kernel's, the walk's, the plain version's and a one-direction
    ``torch.nn.LSTM`` training forward's ms, and the bound."""
    import torch
    from urgent2026_challenge_track1_tpu_torch.ops import _build
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K
    from urgent2026_challenge_track1_tpu_torch.ops import persistent_checks as PC

    sms = _sm_count(device)
    lib = _build.load_library()
    out = []
    for dt_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        elem = torch.tensor([], dtype=dtype).element_size()
        grad_tol = BF16_TOL if dtype == torch.bfloat16 else GRAD_TOL
        for what, R, T, H, per_utt in TRAIN_ROUTE_SHAPES:
            _, _, wh, _, xp, _ = _kernel_inputs(R, T, dtype, device, R + T + H, hid=H)
            dout = (0.1 * torch.randn((R, T, H), generator=torch.Generator().manual_seed(R))).to(
                device, dtype)
            plan = K.plan_persistent(R, 0, H, sms, dirs=1, elem=elem)
            if plan is None:
                fail(f"K4p/K6p {dt_name}: no plan at {what} (R={R}, H={H})")
            kernel_smem = lib.lstm_persistent_smem(0, H, plan.U, plan.rows, plan.chunk,
                                                    int(plan.c_in_smem), elem)
            if kernel_smem != plan.smem:
                fail(f"K4p/K6p {dt_name} plan at {what}: {plan.smem} bytes, the kernel reckons "
                     f"{kernel_smem}")
            lengths = valid = None
            if per_utt is not None:
                lengths = torch.tensor(per_utt, dtype=torch.int32).repeat_interleave(
                    R // len(per_utt)).clamp(max=T).to(device)
                valid = torch.arange(T, device=device)[None, :] < lengths[:, None]
            valid_steps = R * T if lengths is None else int(lengths.sum())
            bounds = _train_bounds(R, T, valid_steps, H, dt_name)
            route = K.scan_route(dtype, R, H, sms, store=True)
            rec = {"what": what, "R": R, "T": T, "H": H, "dtype": dt_name,
                   "valid_steps": valid_steps,
                   "plan": {"S": plan.S, "G": plan.G, "U": plan.U, "rows": plan.rows,
                            "chunk": plan.chunk, "c_in_smem": plan.c_in_smem,
                            "smem_bytes": plan.smem, "ctas": plan.ctas, "elem": plan.elem},
                   "route": "persistent" if route == plan else "walk"}
            runs = {}
            for reverse, tag in ((False, "lstm_train_fwd"), (True, "lstm_train_fwd_reverse")):
                runs[tag] = (
                    lambda p=plan, r=reverse: K.lstm_train_fwd_persistent(xp, wh[0], r, p),
                    lambda r=reverse: K.lstm_train_fwd_walk(xp, wh[0], r),
                    lambda r=reverse: K.lstm_train_fwd_plain(xp, wh[0], r),
                    lambda r=reverse: PC.lstm_scan_stale_h(xp, wh[0], r, residuals=True),
                    lambda res, r=reverse: K.lstm_train_bwd(*res, dout, wh[0], r),
                    lambda res, r=reverse: K.lstm_train_bwd_plain(*res, dout, wh[0], r),
                    lambda r=reverse: PC.lstm_scan_tf32(xp, wh[0], r, residuals=True),
                    "lstm_train_fwd")
            if lengths is not None:
                dmask = dout * valid[..., None]
                runs["lstm_revmasked_train_fwd"] = (
                    lambda p=plan: K.lstm_revmasked_train_fwd_persistent(xp, wh[1], lengths, p),
                    lambda: K.lstm_revmasked_train_fwd_walk(xp, wh[1], lengths),
                    lambda: K.lstm_revmasked_train_fwd_plain(xp, wh[1], lengths),
                    lambda: PC.lstm_scan_stale_h(xp, wh[1], True, lengths, residuals=True),
                    lambda res: K.lstm_revmasked_bwd(*res, lengths, dmask, wh[1]),
                    lambda res: K.lstm_revmasked_bwd_plain(*res, lengths, dmask, wh[1]),
                    lambda: PC.lstm_scan_tf32(xp, wh[1], True, lengths, residuals=True),
                    "lstm_revmasked_train_fwd")
            for tag, (kern, walk_fn, plain_fn, stale_fn, bwd, bwd_plain, tf32_fn,
                      name) in runs.items():
                got, again, ref = kern(), kern(), plain_fn()
                torch.cuda.synchronize()
                limits = [PC.persistent_limit(r) for r in ref]
                e_plain = [_err(g, r) for g, r in zip(got, ref)]
                e_stale = [_err(f, r) for f, r in zip(stale_fn(), ref)]
                e_tf32 = ([_err(f, r) for f, r in zip(tf32_fn(), ref)]
                          if dtype == torch.float32 else None)
                bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
                e_grad = max(_rel(g, r) for g, r in zip(bwd(got), bwd_plain(ref)))
                del got, again, ref
                ms = _time_ms(kern)
                bound_ms, bound_by = bounds[name]
                rec[tag] = {
                    "max_abs_err_vs_plain": dict(zip(RESIDUALS, e_plain)),
                    "limit": dict(zip(RESIDUALS, limits)),
                    "max_err_over_limit": max(e / lim for e, lim in zip(e_plain, limits)),
                    "planted_stale_h_err": dict(zip(RESIDUALS, e_stale)),
                    "planted_stale_h_over_limit": min(e / lim for e, lim in zip(e_stale, limits)),
                    "tf32_control_err": e_tf32 and dict(zip(RESIDUALS, e_tf32)),
                    "tf32_control_over_limit": e_tf32 and min(
                        e / lim for e, lim in zip(e_tf32, limits)),
                    "bitwise_repeat": bitwise, "grad_chain_rel_err": e_grad,
                    "ms": ms, "us_per_step": ms * 1e3 / T,
                    "walk_ms": _time_ms(walk_fn),
                    "plain_ms": _time_ms(plain_fn, reps=3, warmup=1),
                    "bound_ms": bound_ms, "bound_by": bound_by}
                r = rec[tag]
                print(f"[train routes] {dt_name} {what} {tag} R={R} T={T} H={H}: plan S={plan.S} "
                      f"G={plan.G} U={plan.U} rows={plan.rows} chunk={plan.chunk} c_in_smem="
                      f"{plan.c_in_smem} smem={plan.smem} B ({plan.ctas} CTAs); persistent "
                      f"{ms:.3f} ms ({r['us_per_step']:.2f} us a step), walk {r['walk_ms']:.3f} "
                      f"ms, plain {r['plain_ms']:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
                      f"max|p - plain| h, gates, c {[f'{e:.3e}' for e in e_plain]} (limits "
                      f"{[f'{lim:.3e}' for lim in limits]}); planted stale h "
                      f"{[f'{e:.3e}' for e in e_stale]}; one TF32 product "
                      f"{[f'{e:.3e}' for e in e_tf32] if e_tf32 else 'n/a'}; "
                      f"two launches bitwise equal: {bitwise}; "
                      f"backward on its residuals max rel|d| {e_grad:.3e} (limit {grad_tol}); "
                      f"rule: {rec['route']}")
                for res_name, e, f, lim in zip(RESIDUALS, e_plain, e_stale, limits):
                    if not e < lim:
                        fail(f"{dt_name} {what} {tag}: {res_name} vs plain {e:.3e} >= {lim:.3e}")
                    if not f >= lim:
                        fail(f"{dt_name} {what} {tag}: a stale h moves {res_name} by {f:.3e}, "
                             f"under the limit {lim:.3e}: the check cannot see a barrier fault")
                for res_name, e, lim in zip(RESIDUALS, e_tf32 or (), limits):
                    if not e >= lim:
                        fail(f"{dt_name} {what} {tag}: one TF32 product moves {res_name} by "
                             f"{e:.3e}, under the limit {lim:.3e}: the check cannot tell 3xTF32 "
                             "from a kernel below float32")
                if not bitwise:
                    fail(f"{dt_name} {what} {tag}: two launches differ")
                if not e_grad < grad_tol:
                    fail(f"{dt_name} {what} {tag}: the backward on its residuals {e_grad:.3e} "
                         f">= {grad_tol}")
            if rec["route"] != "persistent":
                fail(f"{dt_name} {what}: the route rule takes the walk where a plan exists")
            if H != 197:  # the superset's time at the train steps' shapes
                rec["nn_lstm_train_forward_ms"] = _lstm_forward_reference_ms(device, R, T, H,
                                                                              dtype, True)
            out.append(rec)
            del xp, wh, dout
    return out


# ---------------------------------------------------------------------------
# K5's and K7's two routes (phase 2)
# ---------------------------------------------------------------------------

BWD_TAGS = ("lstm_train_bwd", "lstm_train_bwd_reverse", "lstm_revmasked_bwd")
DW_BOUND = 1e-4  # |dW - P| <= DW_BOUND (|h_prev|^T |dx_proj|) elementwise, P in float64


def _dw_check(K, h, dxp, dw32, reverse, lengths=None):
    """The dW kernel's f32 sum against P = h_prev^T dx_proj in float64 on the
    same inputs: (max over elements of |dW - P| / (|h_prev|^T |dx_proj|),
    with 0 / 0 read as 0, max |dW - P|, and max |dW - P| / max |P|)."""
    import torch

    hp = K._h_prev(h, reverse, lengths).double().reshape(-1, h.shape[-1])
    d = dxp.double().reshape(-1, dxp.shape[-1])
    P = hp.t() @ d
    err = (dw32.double() - P).abs()
    scale = hp.abs().t() @ d.abs()
    ratio = torch.where(scale > 0, err / scale.clamp_min(1e-300),
                        torch.where(err > 0, float("inf"), 0.0))
    return float(ratio.max()), float(err.max()), float(err.max() / P.abs().max())


def _dw_tf32_control(K, PC, h, dxp, reverse, lengths=None):
    """The float32 dW's control: h_prev^T dx_proj of operands rounded to
    TF32 (exact products, float32 sums), as a kernel of one TF32 product
    computes it."""
    H = h.shape[-1]
    hp = K._h_prev(h, reverse, lengths).reshape(-1, H)
    return PC.tf32(hp).t() @ PC.tf32(dxp.reshape(-1, 4 * H))


def _dw_bound(R, T, H, dtype="bfloat16"):
    """The dW kernel's least time (ms): 2 R T H 4H operations (bf16, or in
    float32 at the TF32 rate); reading h and dx_proj (2- or 4-byte
    elements), writing dW in f32."""
    b, peak = (2, PEAK_BF16_FLOPS) if dtype == "bfloat16" else (4, PEAK_TF32_FLOPS)
    return _bound(2 * R * T * H * 4 * H, b * R * T * (H + 4 * H) + 4 * H * 4 * H, peak)


def _dw_library_ms(K, h, dxp, reverse, lengths):
    """One PyTorch call that computes dW from the same operands: the product
    h_prev^T dx_proj with f32 output, bf16 operands (``torch.mm(...,
    out_dtype=)``) or f32 ones (``torch.mm``, TF32 off), h_prev shifted and
    masked beforehand (not timed)."""
    import torch

    H = h.shape[-1]
    hp = K._h_prev(h, reverse, lengths).to(dxp.dtype).reshape(-1, H)
    d = dxp.reshape(-1, 4 * H)
    if dxp.dtype == torch.float32:
        return _time_ms(lambda: torch.mm(hp.t(), d))
    return _time_ms(lambda: torch.mm(hp.t(), d, out_dtype=torch.float32))


def _walk_dw_kernel_ms(walk_fn, reps: int = 3) -> float:
    """The device time of the walk's ``dw_kernel`` alone (ms a call), read
    from ``torch.profiler`` over ``reps`` calls of the walk (its backward
    kernel and dw_kernel are one C call)."""
    import torch
    from urgent2026_challenge_track1_tpu_torch.profile_forward import _group

    walk_fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            walk_fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and _group(e.name).endswith("(dW)"))
    if us <= 0:
        fail("torch.profiler saw no dw_kernel in the walk")
    return us / 1e3 / reps


def _lstm_backward_reference_ms(device, R, T, H, dtype=None):
    """The backward of a one-direction ``torch.nn.LSTM`` in ``dtype``
    (bf16 by default; TF32 off) with N = H / 2 inputs, as in both models,
    over R rows of T steps, the input and weight gradients: a superset of
    K5's work (it adds the W_ih products)."""
    import torch

    dtype = dtype or torch.bfloat16
    N = max(1, H // 2)
    lstm = torch.nn.LSTM(N, H, batch_first=True).to(device, dtype).train()
    x = (0.3 * torch.randn((R, T, N), device=device)).to(dtype).requires_grad_()
    y, _ = lstm(x)
    g = torch.randn_like(y)
    params = [x, *lstm.parameters()]
    ms = _time_ms(lambda: torch.autograd.grad(y, params, g, retain_graph=True))
    del lstm, x, y, g
    return ms


def phase_bwd_routes(device):
    """K5p (the backward of the forward and of the reverse scan) and K7p
    against the plain versions at every step, padded ones included, at the
    shapes where K5 and K7 run in a train step (TRAIN_ROUTE_SHAPES), each on
    the plain training forward's residuals, in bfloat16 and in float32
    (K5p-f32 / K7p-f32: 3xTF32 products and the float32 dW kernel; TF32 off
    in the plain versions): dx_proj within ``persistent_checks.bwd_limit``
    of the plain one (4 bf16 ulps at its peak; F32_BWD_LIMIT of its peak in
    float32); the planted fault (``persistent_checks.lstm_train_bwd_stale_dg``)
    and, in float32, the plain backward with one TF32 product
    (``persistent_checks.lstm_train_bwd_tf32``) at or above that limit; dW
    of the dW kernel alone on the kernel's own dx_proj within DW_BOUND
    (bf16) or ``persistent_checks.DW_F32_BOUND`` (float32, where the product
    of TF32-rounded operands must exceed it) |h_prev|^T |dx_proj| of their
    float64 product, elementwise, the routed dW its rounding and within
    BF16_TOL (bf16) or F32_BWD_LIMIT (float32) of the plain dW, relative;
    two launches bitwise equal.  Records per dtype the plan (checked against
    the kernel's own byte count), the route the rule takes, and in ms
    K5p/K7p (walk + dW), the walk, in float32 its dw_kernel alone, the plain
    version, the dW kernel alone, one torch.mm for dW, the bounds, and the
    backward of a one-direction ``torch.nn.LSTM`` at the same R, T, H and
    dtype (a superset: it adds the W_ih products)."""
    import torch
    from urgent2026_challenge_track1_tpu_torch.ops import _build
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K
    from urgent2026_challenge_track1_tpu_torch.ops import persistent_checks as PC

    sms = _sm_count(device)
    lib = _build.load_library()
    out = []
    for dt_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        f32 = dtype == torch.float32
        elem = 4 if f32 else 2
        dw_bound, dw_tol = (PC.DW_F32_BOUND, PC.F32_BWD_LIMIT) if f32 else (DW_BOUND, BF16_TOL)
        for what, R, T, H, per_utt in TRAIN_ROUTE_SHAPES:
            _, _, wh, _, xp, _ = _kernel_inputs(R, T, dtype, device, R + 2 * T + H, hid=H)
            dout = (0.1 * torch.randn((R, T, H), generator=torch.Generator().manual_seed(R + 1))
                    ).to(device, dtype)
            plan = K.plan_backward(R, H, sms, elem=elem)
            if plan is None:
                fail(f"K5p/K7p {dt_name}: no plan at {what} (R={R}, H={H})")
            kernel_smem = lib.lstm_persistent_bwd_smem(H, plan.U, plan.rows, plan.chunk, plan.kt,
                                                        int(plan.dc_in_smem), elem)
            if kernel_smem != plan.smem:
                fail(f"K5p/K7p {dt_name} plan at {what}: {plan.smem} bytes, the kernel reckons "
                     f"{kernel_smem}")
            lengths = None
            runs = {tag: (K.lstm_train_fwd_plain(xp, wh[0], rev), dout, wh[0], None, rev)
                    for rev, tag in ((False, BWD_TAGS[0]), (True, BWD_TAGS[1]))}
            if per_utt is not None:
                lengths = torch.tensor(per_utt, dtype=torch.int32).repeat_interleave(
                    R // len(per_utt)).clamp(max=T).to(device)
                valid = torch.arange(T, device=device)[None, :] < lengths[:, None]
                runs[BWD_TAGS[2]] = (K.lstm_revmasked_train_fwd_plain(xp, wh[1], lengths),
                                     dout * valid[..., None], wh[1], lengths, True)
            valid_steps = R * T if lengths is None else int(lengths.sum())
            bounds = _train_bounds(R, T, valid_steps, H, dt_name)
            rec = {"what": what, "R": R, "T": T, "H": H, "dtype": dt_name,
                   "valid_steps": valid_steps,
                   "plan": {"S": plan.S, "G": plan.G, "U": plan.U, "rows": plan.rows,
                            "chunk": plan.chunk, "kt": plan.kt, "ntiles": plan.ntiles,
                            "dc_in_smem": plan.dc_in_smem, "smem_bytes": plan.smem,
                            "ctas": plan.ctas, "dw_split": plan.dw_split, "elem": plan.elem},
                   "route": ("persistent" if K.backward_route(dtype, R, H, sms) == plan
                             else "walk")}
            for tag, (res, do, w, lens, rev) in runs.items():
                name = "lstm_revmasked_bwd" if lens is not None else "lstm_train_bwd"
                if lens is None:
                    kern = lambda p=plan: K.lstm_train_bwd_persistent(*res, do, w, rev, p)
                    walk_fn = lambda: K.lstm_train_bwd_walk(*res, do, w, rev)
                    plain_fn = lambda: K.lstm_train_bwd_plain(*res, do, w, rev)
                else:
                    kern = lambda p=plan: K.lstm_revmasked_bwd_persistent(*res, lens, do, w, p)
                    walk_fn = lambda: K.lstm_revmasked_bwd_walk(*res, lens, do, w)
                    plain_fn = lambda: K.lstm_revmasked_bwd_plain(*res, lens, do, w)
                stale = PC.lstm_train_bwd_stale_dg(*res, do, w, rev, lens)[0]
                tf32 = PC.lstm_train_bwd_tf32(*res, do, w, rev, lens)[0] if f32 else None
                got, again, ref = kern(), kern(), plain_fn()
                dw32 = K.lstm_bwd_dw(res[0], got[0], rev, lens, plan.dw_split)
                torch.cuda.synchronize()
                limit = PC.bwd_limit(ref[0])
                e_dxp, e_stale = _err(got[0], ref[0]), _err(stale, ref[0])
                e_tf32 = _err(tf32, ref[0]) if f32 else None
                bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
                dw_ratio, dw_abs, dw_rel_peak = _dw_check(K, res[0], got[0], dw32, rev, lens)
                ctrl = (_dw_check(K, res[0], got[0],
                                  _dw_tf32_control(K, PC, res[0], got[0], rev, lens), rev, lens)
                        if f32 else None)
                dw_rounded = torch.equal(got[1], dw32.to(got[1].dtype))
                e_dw = _rel(got[1], ref[1])
                dxp_k = got[0]
                del got, again, ref, stale, tf32
                ms = _time_ms(kern)
                bound_ms, bound_by = bounds[name]
                dw_bound_ms, dw_bound_by = _dw_bound(R, T, H, dt_name)
                rec[tag] = {
                    "max_abs_err_vs_plain": e_dxp, "limit": limit,
                    "max_err_over_limit": e_dxp / limit,
                    "planted_stale_dg_err": e_stale, "planted_stale_dg_over_limit": e_stale / limit,
                    "tf32_control_err": e_tf32,
                    "tf32_control_over_limit": e_tf32 / limit if f32 else None,
                    "dw_bound_ratio": dw_ratio, "dw_max_abs_err_vs_f64": dw_abs,
                    "dw_max_err_over_peak_vs_f64": dw_rel_peak,
                    "dw_tf32_control_ratio": ctrl and ctrl[0],
                    "dw_tf32_control_over_peak": ctrl and ctrl[2],
                    "dw_rel_err_vs_plain": e_dw, "dw_is_its_rounding": dw_rounded,
                    "bitwise_repeat": bitwise, "ms": ms, "us_per_step": ms * 1e3 / T,
                    "dw_ms": _time_ms(lambda: K.lstm_bwd_dw(res[0], dxp_k, rev, lens,
                                                            plan.dw_split)),
                    "dw_plain_ms": _time_ms(lambda: K.lstm_bwd_dw_plain(res[0], dxp_k, rev, lens,
                                                                        plan.dw_split),
                                            reps=3, warmup=1),
                    "dw_library_ms": _dw_library_ms(K, res[0], dxp_k, rev, lens),
                    "dw_bound_ms": dw_bound_ms, "dw_bound_by": dw_bound_by,
                    "walk_ms": _time_ms(walk_fn, reps=3, warmup=1),
                    "walk_dw_kernel_ms": _walk_dw_kernel_ms(walk_fn) if f32 else None,
                    "plain_ms": _time_ms(plain_fn, reps=3, warmup=1),
                    "bound_ms": bound_ms, "bound_by": bound_by}
                r = rec[tag]
                print(f"[bwd routes] {dt_name} {what} {tag} R={R} T={T} H={H}: plan S={plan.S} "
                      f"G={plan.G} U={plan.U} rows={plan.rows} chunk={plan.chunk} kt={plan.kt} "
                      f"dc_in_smem={plan.dc_in_smem} smem={plan.smem} B ({plan.ctas} CTAs), dW "
                      f"split {plan.dw_split}; persistent {ms:.3f} ms (dW {r['dw_ms']:.3f} ms, "
                      f"torch.mm {r['dw_library_ms']:.3f} ms), walk {r['walk_ms']:.3f} ms "
                      f"(its dw_kernel {r['walk_dw_kernel_ms']} ms), plain {r['plain_ms']:.3f} "
                      f"ms, bound {bound_ms:.4f} ms ({bound_by}), dW bound {dw_bound_ms:.4f} ms "
                      f"({dw_bound_by}); max|dxp - plain| {e_dxp:.3e} (limit {limit:.3e}); "
                      f"planted stale dg {e_stale:.3e}; one TF32 product "
                      f"{'n/a' if e_tf32 is None else f'{e_tf32:.3e}'}; dW |d| / (|h|^T|dxp|) "
                      f"{dw_ratio:.3e} (limit {dw_bound}), |d| / max|P| {dw_rel_peak:.3e}, TF32 "
                      f"operands {ctrl and [f'{c:.3e}' for c in (ctrl[0], ctrl[2])]}; rel vs plain "
                      f"{e_dw:.3e} (limit {dw_tol}), its rounding: {dw_rounded}; two launches "
                      f"bitwise equal: {bitwise}; rule: {rec['route']}")
                if not e_dxp < limit:
                    fail(f"{dt_name} {what} {tag}: dx_proj vs plain {e_dxp:.3e} >= {limit:.3e}")
                if not e_stale >= limit:
                    fail(f"{dt_name} {what} {tag}: stale dgates move dx_proj by {e_stale:.3e}, "
                         f"under the limit {limit:.3e}: the check cannot see a barrier fault")
                if f32 and not e_tf32 >= limit:
                    fail(f"{dt_name} {what} {tag}: one TF32 product moves dx_proj by "
                         f"{e_tf32:.3e}, under the limit {limit:.3e}: the check cannot tell "
                         "3xTF32 from a kernel below float32")
                if not dw_ratio <= dw_bound:
                    fail(f"{dt_name} {what} {tag}: dW off its float64 product by {dw_ratio:.3e} "
                         f"of |h_prev|^T |dx_proj| > {dw_bound}")
                if f32 and not ctrl[0] > dw_bound:
                    fail(f"{dt_name} {what} {tag}: the dW of TF32-rounded operands is within "
                         f"{ctrl[0]:.3e} <= {dw_bound}: the bound cannot tell 3xTF32 from TF32")
                if not (dw_rounded and e_dw < dw_tol):
                    fail(f"{dt_name} {what} {tag}: the routed dW is not the dW kernel's rounding "
                         f"or is {e_dw:.3e} from plain (limit {dw_tol})")
                if not bitwise:
                    fail(f"{dt_name} {what} {tag}: two launches differ")
            if rec["route"] != "persistent":
                fail(f"{dt_name} {what}: the route rule takes the walk where a plan exists")
            rec["nn_lstm_backward_ms"] = _lstm_backward_reference_ms(device, R, T, H, dtype)
            out.append(rec)
            del xp, wh, dout, runs
    return out


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

# (uid, fs, seconds): 8-48 kHz, lengths that are not whole seconds
UTTERANCES = (("u48a", 48000, 3.7), ("u48b", 48000, 1.3), ("u22", 22050, 1.6),
              ("u16a", 16000, 2.45), ("u16b", 16000, 1.9), ("u8", 8000, 1.15))
LONG_UTTERANCES = (("long48", 48000, 2.5), ("long16", 16000, 2.5))


def _write_inputs(workdir: Path, items, name: str, seed: int, ext: str = "wav") -> Path:
    import numpy as np
    from urgent2026_challenge_track1_tpu_torch.utils import audio_io

    rng = np.random.default_rng(seed)
    lines = []
    for uid, fs, sec in items:
        n = int(sec * fs)
        t = np.arange(n) / fs
        wav = 0.3 * np.sin(2 * np.pi * 220.0 * t) + 0.05 * rng.standard_normal(n)
        path = workdir / f"{uid}.{ext}"
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
    # the same samples as FLAC (its 16-bit PCM equals the WAV's): the
    # batched run reads them, and plans its buckets from their headers
    scp_flac = _write_inputs(workdir, UTTERANCES, "in_flac.scp", 0, ext="flac")
    scp_long = _write_inputs(workdir, LONG_UTTERANCES, "long.scp", 1)
    runs = (("single", scp, UTTERANCES, ["--batch_size", "1"]),
            ("batched (FLAC)", scp_flac, UTTERANCES, ["--batch_size", "4"]),
            ("long-form", scp_long, LONG_UTTERANCES, ["--chunk_seconds", "1"]))
    K.reset_launch_counts()
    for name, run_scp, items, extra in runs:
        before = K.launch_counts()
        out_dir = workdir / f"out_{name.split()[0]}"
        t0 = time.perf_counter()
        inference.main(["--input_scp", str(run_scp), "--ckpt_path", str(ckpt),
                        "--output_dir", str(out_dir), "--device", "cuda", *extra])
        seconds = time.perf_counter() - t0
        _check_outputs(out_dir, items)
        delta = {k: v - before[k] for k, v in K.launch_counts().items()}
        print(f"[main path] {name}: {len(items)} files in {seconds:.2f} s, launches {delta}")
    counts, routes = K.launch_counts(), _routes()
    print(f"[main path] launches over the three runs: {counts}, routes {routes}")
    _check_routes("the bfloat16 inference path", "bfloat16", routes)
    return counts, routes


def _write_split(root: Path, seconds, seed: int, ext: str = "wav") -> Path:
    """A pre-simulated set at 48 kHz (spk1.scp, wav.scp, utt2fs,
    speech_length.scp) of synthetic clean/noisy pairs, as WAV or FLAC."""
    import numpy as np
    from urgent2026_challenge_track1_tpu_torch.utils import audio_io

    root.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    fs = 48000
    lines = {k: [] for k in ("spk1.scp", "wav.scp", "utt2fs", "speech_length.scp")}
    for i, sec in enumerate(seconds):
        n = int(sec * fs)
        t = np.arange(n) / fs
        clean = 0.3 * np.sin(2 * np.pi * rng.uniform(120, 400) * t) + 0.02 * rng.standard_normal(n)
        noisy = clean + 0.1 * rng.standard_normal(n)
        uid = f"{root.name}{i:02d}"
        for name, wav in (("spk1.scp", clean), ("wav.scp", noisy)):
            path = root / f"{uid}_{name[:3]}.{ext}"
            audio_io.write(str(path), wav, fs)
            lines[name].append(f"{uid} {path}")
        lines["utt2fs"].append(f"{uid} {fs}")
        lines["speech_length.scp"].append(f"{uid} {n}")
    for name, ls in lines.items():
        (root / name).write_text("\n".join(ls) + "\n")
    return root


def _train_config(workdir: Path, **over):
    from urgent2026_challenge_track1_tpu_torch.config import Config

    base = dict(  # the optimizer values of conf/models/BSRNN_baseline.yaml
        train_set_path=str(workdir / "train"), valid_set_path=str(workdir / "valid"),
        train_set_dynamic_mixing=False, batch_size=4, num_worker=2, max_duration=96000,
        learning_rate=1e-3, lr_step_size=1, lr_gamma=0.85, gradient_clip=0.5,
        weight_decay=1e-6, adam_epsilon=1e-8, seed=2024, save_top_k=5,
        model_configs={"num_channel": N_IN, "num_layer": 6}, device="cuda",
        num_train_epochs=2, val_check_interval=2, log_every_steps=1,
        train_tag="chip_smoke", train_name="baseline")
    base.update(over)
    return Config(**base)


def phase_training(workdir: Path):
    """The port's training entry point at the baseline geometry: 2 epochs of
    2 steps with validation and checkpoints every 2 steps, then a second
    run that resumes into a third epoch.  Returns the first run's launch
    counts."""
    import torch
    from urgent2026_challenge_track1_tpu_torch import train_se
    from urgent2026_challenge_track1_tpu_torch.models.bsrnn import BSRNNConfig, init_bsrnn
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K

    _write_split(workdir / "train", TRAIN_SECONDS + (1.6, 1.5, 1.4, 1.3), 10)
    _write_split(workdir / "valid", (2.0, 1.75, 1.5, 1.25), 11)
    cwd = os.getcwd()
    os.chdir(workdir)  # the trainer writes exp/ under the working directory
    try:
        K.reset_launch_counts()
        t0 = time.perf_counter()
        state = train_se.run(_train_config(workdir))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts, routes = K.launch_counts(), _routes()
        print(f"[training] 2 epochs x 2 steps (+ 2 validations, 2 saves) in {seconds:.1f} s, "
              f"launches {counts}, routes {routes}")
        if (state.step, state.epoch) != (4, 2):
            fail(f"training ended at step {state.step}, epoch {state.epoch}; expected 4, 2")
        init = init_bsrnn(BSRNNConfig(num_channel=N_IN, num_layer=6), seed=2024)
        trained = state.model.state_dict()
        changed = sum(not torch.equal(v, trained[k].cpu()) for k, v in init.state_dict().items())
        print(f"[training] {changed} of {len(trained)} parameter tensors changed")
        if changed < len(trained) // 2:
            fail("training left most parameters unchanged")
        exp = workdir / "exp" / "chip_smoke" / "baseline" / "version_0"
        records = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
        train_losses = [r["train_loss"] for r in records if "train_loss" in r]
        val_losses = [r["val_loss"] for r in records if "val_loss" in r]
        print(f"[training] train losses {train_losses}, val losses {val_losses}")
        if len(train_losses) != 4 or len(val_losses) != 2 or None in train_losses + val_losses:
            fail("training logged missing or non-finite losses")
        t0 = time.perf_counter()
        resumed = train_se.run(_train_config(workdir, num_train_epochs=3))
        print(f"[training] resumed run in {time.perf_counter() - t0:.1f} s: step "
              f"{resumed.step}, epoch {resumed.epoch}")
        if (resumed.step, resumed.epoch) != (6, 3):
            fail(f"the resumed run ended at step {resumed.step}, epoch {resumed.epoch}; "
                 "expected 6, 3")
    finally:
        os.chdir(cwd)
    # K1-K7; K8-K10 run under the toggles (phase_ab_arms); K1-K3 in validation
    for fn in K.KERNELS[:7]:
        if counts[fn.__name__] <= 0:
            fail(f"kernel {fn.__name__} was not launched on the training path")
    _check_routes("the float32 training path", "float32", routes,
                  INFERENCE_KERNELS + TRAIN_ROUTED)
    return counts, routes


WIDE_CHANNELS = 510  # H = 1020: no float32 K4p/K6p plan fits, so K4 and K6 take their walks
# (K5 and K7 have float32 plans there: S = 128 CTAs of 8 units, G = 1)
WIDE_WALKS = ("lstm_train_fwd", "lstm_revmasked_train_fwd")
WIDE_RUN = f"one float32 train step at {WIDE_CHANNELS} channels x 1 layer (B=1, 2 s at 48 kHz)"


def phase_walk_route(device):
    """One float32 train step of the discriminative model at a width where
    no float32 K4p/K6p plan fits (WIDE_CHANNELS, H = 1020; 1 layer, B=1,
    2 s at 48 kHz): K4 and K6 take their walks there; K5 and K7 take
    K5p-f32 / K7p-f32 (their float32 plans fit: the backward's slice needs
    no projection buffer), each with the float32 dW kernel; no K1-K3 runs.
    Returns the routes of that step (the counts set to 0 just before
    it)."""
    import torch
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K
    from urgent2026_challenge_track1_tpu_torch.train import trainer

    cfg = _train_config(Path("."), model_configs={"num_channel": WIDE_CHANNELS, "num_layer": 1})
    bundle = trainer.build_model(cfg)
    model = trainer.init_params(cfg.seed, bundle, device)
    step = trainer.make_train_step(bundle, cfg, 48000)
    H = 2 * WIDE_CHANNELS
    if K.scan_route(torch.float32, 34, H, _sm_count(device), store=True) is not None:
        fail(f"a float32 K4p plan fits at H = {H}: this phase cannot drive the walks")
    K.reset_launch_counts()
    m = step(model, trainer.make_optimizer(cfg, model), *_train_batch(device, B=1))
    torch.cuda.synchronize()
    counts, routes = K.launch_counts(), _routes()
    print(f"[walk route] {WIDE_RUN}: loss {float(m['loss']):.6g}, launches "
          f"{ {k: v for k, v in counts.items() if v} }, routes {routes}")
    if not bool(torch.isfinite(m["loss"])) or m["nan_grad"]:
        fail("the wide float32 train step gave a non-finite loss or gradient")
    _check_no_lean_kernels("the wide float32 train step", counts)
    for name in TRAIN_ROUTED:
        r, want = routes[name], "walk" if name in WIDE_WALKS else "persistent"
        if r[want] <= 0 or sum(r.values()) != r[want]:
            fail(f"the wide float32 train step: {name} routes {r}, expected {want} only")
        if want == "persistent" and K.backward_route(torch.float32, 34, H, _sm_count(device)) is None:
            fail(f"the wide float32 train step: no float32 K5p/K7p plan at H = {H}")
    _check_dw_launches("the wide float32 train step", routes)
    del model
    return routes


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


def phase_grads_card_vs_cpu(device) -> float:
    """One float32 train step's gradients at full width (196 x 6) on a short
    input, card (K1-K7) against CPU (plain versions): the largest of
    max|d| / max|cpu| over the parameter tensors."""
    import copy

    import torch
    from urgent2026_challenge_track1_tpu_torch.config import Config
    from urgent2026_challenge_track1_tpu_torch.models.bsrnn import BSRNNConfig, init_bsrnn
    from urgent2026_challenge_track1_tpu_torch.train import trainer

    fs, n = 16000, 8000
    bundle = trainer.build_model(Config(model_configs={"num_channel": N_IN, "num_layer": 6}))
    cpu_model = init_bsrnn(BSRNNConfig(num_channel=N_IN, num_layer=6), seed=6)
    card_model = copy.deepcopy(cpu_model).to(device)
    gen = torch.Generator().manual_seed(7)
    clean = 0.1 * torch.randn((2, n), generator=gen)
    noisy = clean + 0.05 * torch.randn((2, n), generator=gen)
    lengths = torch.tensor([n, 6000], dtype=torch.int32)
    noisy[1, 6000:] = 0.0
    for model, dev in ((card_model, device), (cpu_model, torch.device("cpu"))):
        loss, _ = trainer.loss_and_metrics(bundle, fs, model, clean.to(dev), noisy.to(dev),
                                           lengths.to(dev))
        loss.backward()
    cpu_grads = dict(cpu_model.named_parameters())
    worst, worst_name = 0.0, ""
    for name, p in card_model.named_parameters():
        ref = cpu_grads[name].grad
        if float(ref.abs().max()) == 0.0:
            continue
        e = _rel(p.grad.cpu(), ref)
        if e > worst:
            worst, worst_name = e, name
    print(f"[card vs cpu] float32 196x6 train-step gradients, 0.5 s at 16 kHz: "
          f"max rel|d|={worst:.3e} ({worst_name}; tolerance {E2E_TOL})")
    if not worst < E2E_TOL:
        fail(f"card and CPU gradients differ by {worst:.3e} >= {E2E_TOL}")
    return worst


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


def _sm_count(device) -> int:
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def _bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _bounds(R, T, lengths_sum, n_in=N_IN, hid=HID):
    """Least time (ms) for each kernel's bf16 work at one shape (each input
    byte read once, each output byte written once, the recurrent and input
    products as operations); K3 counts only the valid steps its outputs
    need."""
    N, H, b = n_in, hid, 2
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


def _train_bounds(R, T, valid_steps, hid=HID, dtype="bfloat16"):
    """Least time (ms) for each training kernel's work: forward 2 H 4H
    operations per valid (row, step), reading x_proj and W_hh and writing h,
    gates and c; backward 4 H 4H (the dh and dW products), reading gates, c,
    h, dout and W_hh and writing dx_proj and dW in f32.  The masked pair
    (K6, K7) counts the valid steps only, as K3; unmasked valid_steps = R T.
    bfloat16: 2-byte elements, bf16 operations at PEAK_BF16_FLOPS; float32:
    4-byte elements, the same operations at PEAK_TF32_FLOPS (the card's
    fastest rate for f32 operands; what 3xTF32 costs over that is the
    kernel's, not the function's)."""
    H, b = hid, (2 if dtype == "bfloat16" else 4)
    peak = PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_TF32_FLOPS
    out = {}
    for name, n, lens in (("lstm_train_fwd", R * T, 0), ("lstm_train_bwd", R * T, 0),
                          ("lstm_revmasked_train_fwd", valid_steps, 4 * R),
                          ("lstm_revmasked_bwd", valid_steps, 4 * R)):
        if name.endswith("fwd"):
            flops = 2 * n * H * 4 * H
            nbytes = b * (n * 4 * H + H * 4 * H + n * H + n * 4 * H + n * H) + lens
        else:
            flops = 4 * n * H * 4 * H
            nbytes = b * (n * 4 * H + 3 * n * H + H * 4 * H + n * 4 * H) + 4 * H * 4 * H + lens
        out[name] = _bound(flops, nbytes, peak)
    return out


def _train_batch(device, B=4, fs=48000):
    """A training batch at the baseline geometry: 2 s buckets, TRAIN_SECONDS
    of signal."""
    import torch

    gen = torch.Generator().manual_seed(12)
    T = 2 * fs
    clean = torch.zeros((B, T))
    noisy = torch.zeros((B, T))
    lengths = torch.tensor([int(sec * fs) for sec in TRAIN_SECONDS[:B]], dtype=torch.int32)
    for i, n in enumerate(lengths.tolist()):
        clean[i, :n] = 0.1 * torch.randn(n, generator=gen)
        noisy[i, :n] = clean[i, :n] + 0.05 * torch.randn(n, generator=gen)
    return clean.to(device), noisy.to(device), lengths.to(device)


def _routes():
    """{kernel: {route: launches}} of K1-K4 and K6 since the last reset."""
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K

    return {fn.__name__: K.route_counts(fn.__name__) for fn in K.ROUTED}


def _check_routes(what, dtype_name, routes, kernels=INFERENCE_KERNELS):
    """Each of ``kernels`` ran, on its persistent route only (K1p-K7p) in
    bfloat16; in float32 K4-K7 on theirs (K4p-f32 - K7p-f32) and K1-K3 on
    their walks only."""
    for name in kernels:
        persistent = dtype_name == "bfloat16" or name in F32_PERSISTENT
        want = "persistent" if persistent else "walk"
        r = routes[name]
        if r[want] <= 0 or sum(r.values()) != r[want]:
            fail(f"{what}: {name} routes {r}, expected {want} only")


def _check_dw_launches(what, routes):
    """The dW kernel ran once inside each K5p and K7p launch, and nowhere
    else; returns its count since the last reset."""
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K

    want = sum(routes[name]["persistent"] for name in ("lstm_train_bwd", "lstm_revmasked_bwd"))
    if K.lstm_bwd_dw.launches != want:
        fail(f"{what}: the dW kernel ran {K.lstm_bwd_dw.launches} times, K5p + K7p {want}")
    return K.lstm_bwd_dw.launches


def _check_no_lean_kernels(what, counts):
    """A train step runs the training kernels in both remat passes: none of
    K1-K3."""
    lean = {name: counts.get(name, 0) for name in INFERENCE_KERNELS}
    if any(lean.values()):
        fail(f"{what} launched the inference kernels {lean}")


def _train_step_times(device):
    """Median host-clock time of the train step (B=4, 2 s at 48 kHz, 196 x
    6) over 5 steps after 2 warm-up steps, in float32 and bfloat16, with the
    peak device memory and the kernel launches of one step (none of K1-K3:
    remat runs the training kernels in both passes) and K4-K7's routes
    there (K4p-K7p only, and the dW kernel once for each K5p/K7p, in either
    dtype)."""
    import torch
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K
    from urgent2026_challenge_track1_tpu_torch.train import trainer

    out = {}
    for compute_dtype in ("float32", "bfloat16"):
        cfg = _train_config(Path("."), compute_dtype=compute_dtype)
        bundle = trainer.build_model(cfg)
        model = trainer.init_params(cfg.seed, bundle, device)
        opt = trainer.make_optimizer(cfg, model)
        step = trainer.make_train_step(bundle, cfg, 48000)
        batch = _train_batch(device)
        K.reset_launch_counts()
        step(model, opt, *batch)
        per_step, routes = K.launch_counts(), _routes()
        _check_no_lean_kernels(f"train step {compute_dtype}", per_step)
        _check_routes(f"train step {compute_dtype}", compute_dtype, routes, TRAIN_ROUTED)
        dw_per_step = _check_dw_launches(f"train step {compute_dtype}", routes)
        step(model, opt, *batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            m = step(model, opt, *batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if m["nan_grad"]:
                fail("the timed train step hit a non-finite gradient")
        out[compute_dtype] = {"median_ms": statistics.median(times), "ms": times,
                              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                              "launches_per_step": per_step,
                              "routes_per_step": {k: routes[k] for k in TRAIN_ROUTED},
                              "dw_launches_per_step": dw_per_step}
        print(f"[times] train step {compute_dtype} (B=4, 2 s at 48 kHz, 196x6): median "
              f"{out[compute_dtype]['median_ms']:.1f} ms of {[round(t, 1) for t in times]}, "
              f"peak {out[compute_dtype]['peak_memory_gb']:.2f} GB, launches per step {per_step}, "
              f"K4-K7 routes {out[compute_dtype]['routes_per_step']}, dW kernel {dw_per_step}")
        del model, opt
    return out


def _row_tile_sweep(device):
    """K2's walk at the time path's B=1 and B=64 row counts with each row
    tile forced, beside the tile the wrapper picks (from R and the SM
    count)."""
    import torch
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K

    chooser = K.rows_per_block
    out = []
    for R in (TIME_SHAPES[0][0], 64 * TIME_SHAPES[0][0]):
        T = TIME_SHAPES[0][1]
        _, _, wh, _, xp, _ = _kernel_inputs(R, T, torch.bfloat16, device, R)
        picked = chooser(R, 1, device, HID)
        for rows in (1, 2, 4, 8):
            K.rows_per_block = lambda *_, r=rows: r
            try:
                ms = _time_ms(lambda: K.lstm_scan_walk(xp, wh[0]), reps=3, warmup=1)
            finally:
                K.rows_per_block = chooser
            out.append({"R": R, "T": T, "rows_per_block": rows, "picked": rows == picked,
                        "ms": ms})
    return out


def phase_times(device, main_counts, errs, train_errs, k1_routes, scan_routes,
                train_routes_rows, bwd_routes_rows, main_routes, train_routes, wide_routes):
    import torch
    from urgent2026_challenge_track1_tpu_torch.dsp.stft import STFTConfig
    from urgent2026_challenge_track1_tpu_torch.models.bsrnn import (
        BSRNNConfig, bsrnn_se_apply, init_bsrnn)
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K
    from urgent2026_challenge_track1_tpu_torch.ops import persistent_checks as PC

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
        "fusedin_bilstm": (lambda: K.fusedin_bilstm_walk(xb, w_ih_t, w_hh_t, bias),
                           lambda: K.fusedin_bilstm_plain(xb, w_ih_t, w_hh_t, bias),
                           lambda: lstm(xb), (band_R, band_T)),
        "lstm_scan": (lambda: K.lstm_scan_walk(xp, w_hh_t[0]),
                      lambda: K.lstm_scan_plain(xp, w_hh_t[0]), None, (time_R, time_T)),
        "lstm_revmasked": (lambda: K.lstm_revmasked_walk(xp, w_hh_t[1], lengths),
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
            per_forward[tag] = {**K.launch_counts(), "routes": _routes()}
        fwd_ms = _time_ms(lambda: bsrnn_se_apply(model, STFTConfig(), wav, 48000, lens37),
                          reps=3, warmup=1)
    print(f"[times] launches per forward (B=1, 48 kHz, 4 s bucket): {per_forward}")
    one = per_forward["lengths"]["routes"]
    for name in ("lstm_scan", "lstm_revmasked"):
        if one[name] != {"persistent": 6, "walk": 0}:
            fail(f"the one-utterance forward took {name}'s routes {one[name]}, expected the "
                 "persistent route once per layer")
    print(f"[times] forward with lengths, B=1, 3.7 s at 48 kHz, 196x6 bf16: {fwd_ms:.2f} ms")

    records = []
    with torch.inference_mode():
        for name, (kern, plain, library, (R, T)) in timed.items():
            ms = _time_ms(kern)
            plain_ms = _time_ms(plain, reps=3, warmup=1)
            library_ms = _time_ms(library) if library is not None else None
            bound_ms, bound_by = _bounds(R, T, R * valid)[name]
            # the walks run on the float32 paths: the training path's validations
            launches = train_routes[name]["walk"]
            run = "training path (float32 validation: the walk)"
            rec = {
                "name": name, "route": "cuda",
                "source": f"{PKG}/csrc/lstm_kernels.cu",
                "replaces": REPLACES[name],
                "launches": launches, "launches_run": run,
                "max_abs_err": errs[name, "bfloat16"],
                "max_abs_err_f32": errs[name, "float32"],
                "tolerance": BF16_TOL, "tolerance_f32": F32_TOL,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms, "shape": {"R": R, "T": T, "N": N_IN, "H": HID},
                "dtype": "bfloat16",
                "route_of_kernel": "walk",
                "launches_per_forward": per_forward["lengths"]["routes"][name]["walk"],
            }
            print(f"[times] {name} R={R} T={T} bf16: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                  f"library {library_ms} ms, bound {bound_ms:.4f} ms ({bound_by})")
            records.append(rec)
        # K1p: the same function at the same shape, K1's bfloat16 route
        walk_rec = records[0]
        disc = k1_routes[0]
        walk_rec["routes_ms"] = {"walk": walk_rec["ms"], "persistent": disc["k1p_ms"]}
        records.append({
            "name": "fusedin_bilstm_persistent", "route": "cuda", "route_of_kernel": "persistent",
            "source": f"{PKG}/csrc/lstm_persistent.cu", "replaces": REPLACES["fusedin_bilstm"],
            "launches": main_routes["fusedin_bilstm"]["persistent"],
            "launches_run": "inference path",
            "max_abs_err": max(r["max_abs_err_vs_plain"] for r in k1_routes),
            "max_abs_err_vs_walk": max(r["max_abs_err_vs_walk"] for r in k1_routes),
            "max_abs_err_f32": None,
            "tolerance": min(r["k1p_limit"] for r in k1_routes),
            "tolerance_rule": f"{PC.PERSISTENT_ULPS} bf16 ulps at max|plain| per shape",
            "planted_stale_h_err": min(r["planted_stale_h_err"] for r in k1_routes),
            "ms": disc["k1p_ms"], "plain_ms": walk_rec["plain_ms"],
            "bound_ms": disc["bound_ms"], "bound_by": disc["bound_by"],
            "library_ms": disc["cudnn_ms"], "shape": walk_rec["shape"], "dtype": "bfloat16",
            "plan": disc["plan"],
            "launches_per_forward":
                per_forward["lengths"]["routes"]["fusedin_bilstm"]["persistent"],
            "routes_ms": {"walk": walk_rec["ms"], "persistent": disc["k1p_ms"]},
            "route_table": k1_routes,
        })
        # K2p and K3p: the same functions at the same shape (the scan_routes
        # phase's one-utterance row), K2's and K3's bfloat16 routes
        one_utt = scan_routes[0]
        for name, walk_rec in ((n, next(r for r in records if r["name"] == n))
                               for n in ("lstm_scan", "lstm_revmasked")):
            p = one_utt[name]
            walk_rec["routes_ms"] = {"walk": walk_rec["ms"], "persistent": p["ms"]}
            records.append({
                "name": f"{name}_persistent", "route": "cuda", "route_of_kernel": "persistent",
                "source": f"{PKG}/csrc/lstm_persistent.cu", "replaces": REPLACES[name],
                "launches": main_routes[name]["persistent"], "launches_run": "inference path",
                "max_abs_err": max(r[name]["max_abs_err_vs_plain"] for r in scan_routes),
                "max_abs_err_vs_walk": max(r[name]["max_abs_err_vs_walk"] for r in scan_routes),
                "max_abs_err_f32": None,
                "tolerance": min(r[name]["limit"] for r in scan_routes),
                "tolerance_rule": f"{PC.PERSISTENT_ULPS} bf16 ulps at max|plain| per shape",
                "planted_stale_h_err": min(r[name]["planted_stale_h_err"] for r in scan_routes),
                "ms": p["ms"], "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"],
                "bound_by": p["bound_by"], "library_ms": None,
                "reference_ms": one_utt["nn_lstm_forward_ms"],
                "reference": "superset: adds the W_ih products (torch.nn.LSTM bfloat16, one "
                             "direction, N = H / 2: an inference forward)",
                "shape": {"R": one_utt["R"], "T": one_utt["T"], "H": one_utt["H"],
                          "valid_steps": one_utt["valid_steps"]},
                "dtype": "bfloat16", "plan": one_utt["plan"],
                "launches_per_forward": per_forward["lengths"]["routes"][name]["persistent"],
                "routes_ms": walk_rec["routes_ms"],
                "route_table": [{k: v for k, v in r.items()
                                 if k not in ("lstm_scan", "lstm_revmasked") or k == name}
                                for r in scan_routes],
            })
        # the same kernels at the JAX bench geometry (B=64, 4 s, 48 kHz)
        extra = []
        # (K1 at the bench geometry's band and time paths: the k1_routes phase)
        for name, R, T in (("fusedin_bilstm", 34, 401), ("lstm_scan", 64 * 34, 401),
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
            route = (K.k1_route(bf16, R, N_IN, HID, _sm_count(device)) if name == "fusedin_bilstm"
                     else K.scan_route(bf16, R, HID, _sm_count(device)))
            extra[-1]["route"] = "persistent" if route is not None else "walk"
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
    del model, wav

    steps = _train_step_times(device)
    per_step = steps["bfloat16"]["launches_per_step"]
    for rec in records:  # K1-K3 on either route: none (remat runs the training kernels)
        rec["launches_per_train_step"] = per_step.get(rec["name"].removesuffix("_persistent"), 0)
    # the K5/K7 walks: no entry point runs them (float32 and bfloat16 take
    # K5p/K7p wherever K5 and K7 run, the wide float32 step too); the count
    # is the float32 training path's, 0
    walk_launches = {name: (train_routes[name]["walk"],
                            "training path (float32): 0, every train step takes K5p/K7p")
                     for name in ("lstm_train_bwd", "lstm_revmasked_bwd")}
    walk_launches.update({name: (wide_routes[name]["walk"], WIDE_RUN) for name in WIDE_WALKS})
    records += _train_kernel_times(device, walk_launches, train_errs, steps)
    # the K5/K7 walks in float32 (the route float32 steps took before
    # K5p-f32/K7p-f32), their dw_kernel alone and torch.mm for that dW
    f32_disc = next(r for r in bwd_routes_rows
                    if r["dtype"] == "float32" and r["what"] == "disc time B=4")
    for rec in records:
        if rec["name"] in ("lstm_train_bwd", "lstm_revmasked_bwd"):
            r = f32_disc[BWD_TAGS[0] if rec["name"] == "lstm_train_bwd" else BWD_TAGS[2]]
            rec.update({"f32_ms": r["walk_ms"], "f32_dw_kernel_ms": r["walk_dw_kernel_ms"],
                        "f32_dw_library_ms": r["dw_library_ms"],
                        "f32_dw_library": "torch.mm(h_prev^T, dx_proj), f32, TF32 off"})
    records += _train_route_records(train_routes_rows, steps)
    records += _bwd_route_records(bwd_routes_rows, steps)
    print("[times] " + json.dumps({"train_step": steps}))
    return records


def _train_route_records(rows, steps):
    """K4p's and K6p's records from the train_routes phase, one per dtype
    (the float32 route's named ``*_persistent_f32``): times at the disc time
    path (the band path and the flow shapes beside it as band_* and flow_*
    keys), the worst error, limit ratio, planted fault and gradient chain
    over every shape; ``launches`` is K4's / K6's persistent route count over
    one disc train step in that dtype (the counts set to 0 before it and read
    after it); ``reference_ms`` a one-direction ``torch.nn.LSTM`` training
    forward at the same shape and dtype (a superset: it adds the W_ih
    products)."""
    from urgent2026_challenge_track1_tpu_torch.ops import persistent_checks as PC

    out = []
    for dt_name, suffix, tol_rule, grad_tol in (
            ("bfloat16", "", "4 bf16 ulps at max|plain| per output (h, gates, c) and shape",
             BF16_TOL),
            ("float32", "_f32", f"F32_LIMIT ({PC.F32_LIMIT:g}) per output (h, gates, c) and "
             "shape", GRAD_TOL)):
        dt_rows = [r for r in rows if r["dtype"] == dt_name]
        by_what = {r["what"]: r for r in dt_rows}
        disc, flow = by_what["disc time B=4"], by_what["flow time B=2"]
        run = f"one {dt_name} train step (B=4, 2 s at 48 kHz, 196 x 6)"
        for name, tags in (("lstm_train_fwd", ("lstm_train_fwd", "lstm_train_fwd_reverse")),
                           ("lstm_revmasked_train_fwd", ("lstm_revmasked_train_fwd",))):
            runs = [r[t] for r in dt_rows for t in tags if t in r]
            d, f = disc[tags[0]], flow[tags[0]]
            rec = {
                "name": f"{name}_persistent{suffix}", "route": "cuda",
                "route_of_kernel": "persistent",
                "source": f"{PKG}/csrc/lstm_persistent.cu", "replaces": REPLACES[name],
                "launches": steps[dt_name]["routes_per_step"][name]["persistent"],
                "launches_run": run,
                "max_abs_err": max(max(r["max_abs_err_vs_plain"].values()) for r in runs),
                "max_err_over_limit": max(r["max_err_over_limit"] for r in runs),
                "max_abs_err_f32": (max(max(r["max_abs_err_vs_plain"].values()) for r in runs)
                                    if suffix else None),
                "tolerance_rule": tol_rule,
                "planted_stale_h_over_limit": min(r["planted_stale_h_over_limit"] for r in runs),
                "tf32_control_over_limit": (min(r["tf32_control_over_limit"] for r in runs)
                                            if suffix else None),
                "bitwise_repeat": all(r["bitwise_repeat"] for r in runs),
                "grad_chain_rel_err": max(r["grad_chain_rel_err"] for r in runs),
                "grad_chain_tolerance": grad_tol,
                "ms": d["ms"], "plain_ms": d["plain_ms"], "walk_ms": d["walk_ms"],
                "bound_ms": d["bound_ms"], "bound_by": d["bound_by"], "library_ms": None,
                "reference_ms": disc["nn_lstm_train_forward_ms"],
                "reference": f"superset: adds the W_ih products (torch.nn.LSTM {dt_name}, one "
                             "direction, N = H / 2: a training forward)",
                "shape": {k: disc[k] for k in ("R", "T", "H", "valid_steps")}, "dtype": dt_name,
                "plan": disc["plan"], "launches_per_train_step": {
                    dt: steps[dt]["routes_per_step"][name] for dt in ("float32", "bfloat16")},
                "flow_ms": f["ms"], "flow_plain_ms": f["plain_ms"], "flow_walk_ms": f["walk_ms"],
                "flow_bound_ms": f["bound_ms"], "flow_bound_by": f["bound_by"],
                "flow_library_ms": None, "flow_reference_ms": flow["nn_lstm_train_forward_ms"],
                "flow_plan": flow["plan"],
                "flow_shape": {k: flow[k] for k in ("R", "T", "H", "valid_steps")},
                "route_table": [{k: v for k, v in r.items() if k not in RUN_TAGS or k in tags}
                                for r in dt_rows],
            }
            if name == "lstm_train_fwd":  # the band paths
                for key, what in (("band", "disc band B=4"), ("flow_band", "flow band B=2")):
                    b = by_what[what]
                    rec.update({f"{key}_ms": b[tags[0]]["ms"],
                                f"{key}_walk_ms": b[tags[0]]["walk_ms"],
                                f"{key}_bound_ms": b[tags[0]]["bound_ms"],
                                f"{key}_reference_ms": b["nn_lstm_train_forward_ms"],
                                f"{key}_plan": b["plan"]})
            out.append(rec)
    return out


def _bwd_route_records(rows, steps):
    """K5p's, K7p's and their dW kernel's records from the bwd_routes phase,
    one per dtype (the float32 route's named ``*_persistent_f32`` and
    ``lstm_bwd_dw_f32``): times at the disc time path (the band path and
    the flow shapes beside them as band_* and flow_* keys), the worst error,
    limit ratio, planted fault, TF32 control and dW bound over every shape;
    ``launches`` is K5's / K7's persistent route count (the dW kernel's
    count) over one disc train step in that dtype (the counts set to 0
    before it and read after it)."""
    from urgent2026_challenge_track1_tpu_torch.ops import persistent_checks as PC

    out = []
    for dt_name, suffix in (("bfloat16", ""), ("float32", "_f32")):
        f32 = dt_name == "float32"
        dt_rows = [r for r in rows if r["dtype"] == dt_name]
        by_what = {r["what"]: r for r in dt_rows}
        disc, flow = by_what["disc time B=4"], by_what["flow time B=2"]
        run = f"one {dt_name} train step (B=4, 2 s at 48 kHz, 196 x 6)"
        dx_rule = (f"dx_proj: F32_BWD_LIMIT ({PC.F32_BWD_LIMIT:g}) of max|plain| per shape" if f32
                   else "dx_proj: 4 bf16 ulps at max|plain| per shape")
        dw_bound, dw_tol = (PC.DW_F32_BOUND, PC.F32_BWD_LIMIT) if f32 else (DW_BOUND, BF16_TOL)
        for name, tags in (("lstm_train_bwd", BWD_TAGS[:2]), ("lstm_revmasked_bwd", BWD_TAGS[2:])):
            runs = [r[t] for r in dt_rows for t in tags if t in r]
            d, f = disc[tags[0]], flow[tags[0]]
            rec = {
                "name": f"{name}_persistent{suffix}", "route": "cuda",
                "route_of_kernel": "persistent",
                "source": f"{PKG}/csrc/lstm_persistent.cu", "replaces": REPLACES[name],
                "launches": steps[dt_name]["routes_per_step"][name]["persistent"],
                "launches_run": run,
                "max_abs_err": max(r["max_abs_err_vs_plain"] for r in runs),
                "max_err_over_limit": max(r["max_err_over_limit"] for r in runs),
                "max_abs_err_f32": max(r["max_abs_err_vs_plain"] for r in runs) if f32 else None,
                "tolerance_rule": f"{dx_rule}; dW: the dW kernel within {dw_bound} |h_prev|^T "
                                  f"|dx_proj| of the float64 product, and within {dw_tol} "
                                  "(relative) of plain",
                "planted_stale_dg_over_limit": min(r["planted_stale_dg_over_limit"] for r in runs),
                "tf32_control_over_limit": (min(r["tf32_control_over_limit"] for r in runs)
                                            if f32 else None),
                "dw_bound_ratio": max(r["dw_bound_ratio"] for r in runs),
                "dw_rel_err_vs_plain": max(r["dw_rel_err_vs_plain"] for r in runs),
                "bitwise_repeat": all(r["bitwise_repeat"] for r in runs),
                "ms": d["ms"], "plain_ms": d["plain_ms"], "walk_ms": d["walk_ms"],
                "walk_dw_kernel_ms": d["walk_dw_kernel_ms"],
                "dw_ms": d["dw_ms"], "bound_ms": d["bound_ms"], "bound_by": d["bound_by"],
                "library_ms": None,
                "reference_ms": disc["nn_lstm_backward_ms"],
                "reference": f"superset: adds the W_ih products (torch.nn.LSTM {dt_name}, one "
                             "direction, N = H / 2: its backward)",
                "shape": {k: disc[k] for k in ("R", "T", "H", "valid_steps")}, "dtype": dt_name,
                "plan": disc["plan"], "launches_per_train_step": {
                    dt: steps[dt]["routes_per_step"][name] for dt in ("float32", "bfloat16")},
                "flow_ms": f["ms"], "flow_plain_ms": f["plain_ms"], "flow_walk_ms": f["walk_ms"],
                "flow_walk_dw_kernel_ms": f["walk_dw_kernel_ms"],
                "flow_dw_ms": f["dw_ms"], "flow_bound_ms": f["bound_ms"],
                "flow_bound_by": f["bound_by"], "flow_library_ms": None,
                "flow_reference_ms": flow["nn_lstm_backward_ms"], "flow_plan": flow["plan"],
                "flow_shape": {k: flow[k] for k in ("R", "T", "H", "valid_steps")},
                "route_table": [{k: v for k, v in r.items() if k not in BWD_TAGS or k in tags}
                                for r in dt_rows],
            }
            if name == "lstm_train_bwd":  # the band paths
                for key, what in (("band", "disc band B=4"), ("flow_band", "flow band B=2")):
                    b = by_what[what]
                    rec.update({f"{key}_ms": b[tags[0]]["ms"],
                                f"{key}_walk_ms": b[tags[0]]["walk_ms"],
                                f"{key}_dw_ms": b[tags[0]]["dw_ms"],
                                f"{key}_bound_ms": b[tags[0]]["bound_ms"],
                                f"{key}_plan": b["plan"],
                                f"{key}_reference_ms": b["nn_lstm_backward_ms"]})
            out.append(rec)
        runs = [r[t] for r in dt_rows for t in BWD_TAGS if t in r]
        d, f = disc[BWD_TAGS[0]], flow[BWD_TAGS[0]]
        rec = {
            "name": f"lstm_bwd_dw{suffix}", "route": "cuda", "route_of_kernel": "persistent",
            "source": f"{PKG}/csrc/lstm_persistent.cu", "replaces": REPLACES["lstm_train_bwd"],
            "replaces_also": REPLACES["lstm_revmasked_bwd"],
            "launches": steps[dt_name]["dw_launches_per_step"], "launches_run": run,
            "max_abs_err": max(r["dw_max_abs_err_vs_f64"] for r in runs),
            "max_abs_err_f32": max(r["dw_max_abs_err_vs_f64"] for r in runs) if f32 else None,
            "tolerance_rule": f"|dW - P| <= {dw_bound} |h_prev|^T |dx_proj| elementwise, P the "
                              f"float64 product of the same {dt_name} operands",
            "dw_bound_ratio": max(r["dw_bound_ratio"] for r in runs),
            "dw_max_err_over_peak_vs_f64": max(r["dw_max_err_over_peak_vs_f64"] for r in runs),
            "ms": d["dw_ms"], "plain_ms": d["dw_plain_ms"], "bound_ms": d["dw_bound_ms"],
            "bound_by": d["dw_bound_by"], "library_ms": d["dw_library_ms"],
            "library": (f"torch.mm(h_prev^T, dx_proj), f32 operands, TF32 off" if f32 else
                        "torch.mm(h_prev^T, dx_proj, out_dtype=float32), bf16 operands"),
            "shape": {k: disc[k] for k in ("R", "T", "H")}, "dtype": dt_name,
            "split": disc["plan"]["dw_split"],
            "flow_ms": f["dw_ms"], "flow_plain_ms": f["dw_plain_ms"],
            "flow_bound_ms": f["dw_bound_ms"], "flow_bound_by": f["dw_bound_by"],
            "flow_library_ms": f["dw_library_ms"], "flow_split": flow["plan"]["dw_split"],
            "flow_shape": {k: flow[k] for k in ("R", "T", "H")},
        }
        if f32:
            rec.update({
                "tf32_control_ratio": min(r["dw_tf32_control_ratio"] for r in runs),
                "tf32_control_over_peak": min(r["dw_tf32_control_over_peak"] for r in runs),
                "tf32_control": "h_prev^T dx_proj of operands rounded to TF32 (float32 sums): "
                                "must exceed the bound at every shape"})
        out.append(rec)
    return out


def _train_kernel_times(device, walk_launches, train_errs, steps):
    """K4-K7 at the training step's shapes, bf16 (their walks: a float32
    step runs K4's and K6's only where no float32 plan fits, and no step
    runs K5's and K7's): kernel, plain version, bound.  K4/K5 are timed on the time path and on
    the band path (the record holds the time path, and the band path's ms
    and bound as band_* keys).  ``walk_launches``: {kernel: (walk launches,
    the run that drove them)}."""
    import torch
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K

    bf16 = torch.bfloat16
    records = []
    for R, T in (TRAIN_TIME, TRAIN_BAND):
        _, _, wh, _, xp, _ = _kernel_inputs(R, T, bf16, device, 13)
        dout = (0.1 * torch.randn((R, T, HID), device=device)).to(bf16)
        res = K.lstm_train_fwd(xp, wh[0])
        lengths = _frames_lengths(R, T, device) if (R, T) == TRAIN_TIME else None
        timed = {
            "lstm_train_fwd": (lambda: K.lstm_train_fwd_walk(xp, wh[0]),
                               lambda: K.lstm_train_fwd_plain(xp, wh[0])),
            "lstm_train_bwd": (lambda: K.lstm_train_bwd_walk(*res, dout, wh[0]),
                               lambda: K.lstm_train_bwd_plain(*res, dout, wh[0])),
        }
        if lengths is not None:
            res_m = K.lstm_revmasked_train_fwd(xp, wh[1], lengths)
            timed["lstm_revmasked_train_fwd"] = (
                lambda: K.lstm_revmasked_train_fwd_walk(xp, wh[1], lengths),
                lambda: K.lstm_revmasked_train_fwd_plain(xp, wh[1], lengths))
            timed["lstm_revmasked_bwd"] = (
                lambda: K.lstm_revmasked_bwd_walk(*res_m, lengths, dout, wh[1]),
                lambda: K.lstm_revmasked_bwd_plain(*res_m, lengths, dout, wh[1]))
        valid = int(lengths.sum()) if lengths is not None else R * T
        bounds = _train_bounds(R, T, valid)
        with torch.no_grad():
            for name, (kern, plain) in timed.items():
                ms = _time_ms(kern)
                plain_ms = _time_ms(plain, reps=3, warmup=1)
                bound_ms, bound_by = bounds[name]
                print(f"[times] {name} R={R} T={T} bf16: kernel {ms:.3f} ms, plain "
                      f"{plain_ms:.3f} ms, library none, bound {bound_ms:.4f} ms ({bound_by})")
                if (R, T) != TRAIN_TIME:  # the band path: beside the time path's record
                    rec = next(r for r in records if r["name"] == name)
                    rec.update({"band_ms": ms, "band_bound_ms": bound_ms,
                                "band_shape": {"R": R, "T": T, "H": HID}})
                    continue
                e_abs, e_rel = train_errs[name, "bfloat16"]
                # launches in one train step per dtype (their walk route)
                per_step = {dt: (steps[dt]["routes_per_step"][name]["walk"] if name in TRAIN_ROUTED
                                 else steps[dt]["launches_per_step"][name])
                            for dt in ("float32", "bfloat16")}
                records.append({
                    "name": name, "route": "cuda",
                    "source": f"{PKG}/csrc/lstm_kernels.cu",
                    "replaces": REPLACES[name],
                    **({"route_of_kernel": "walk"} if name in TRAIN_ROUTED else {}),
                    "launches": walk_launches[name][0],
                    "launches_run": walk_launches[name][1],
                    "max_abs_err": e_abs, "max_rel_err": e_rel,
                    "max_abs_err_f32": train_errs[name, "float32"][0],
                    "max_rel_err_f32": train_errs[name, "float32"][1],
                    "tolerance": BF16_TOL,
                    "tolerance_f32": GRAD_TOL if name.endswith("bwd") else F32_TOL,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": None,
                    "shape": {"R": R, "T": T, "H": HID, "valid_steps": valid},
                    "dtype": "bfloat16", "launches_per_train_step": per_step,
                })
        del xp, dout, res
    return records


# ---------------------------------------------------------------------------
# K8-K10 against plain (phase 2)
# ---------------------------------------------------------------------------

NEW_KERNELS = ("lstm_train_fwd_streamin", "lstm_train_fwd2", "lstm_train_bwd2")


def phase_new_kernels(device):
    """K8-K10 against their plain versions at the discriminative training
    shapes (N = 196, H = 392) and the flow training shapes (N = 384,
    H = 768), float32 and bfloat16: max abs error of the forward outputs,
    max relative error of the backward's (each on the plain forward's
    residuals).  K9 and K10 must equal K4 and K5 run per direction bit for
    bit (against K4's and K5's walks, their device code).  Returns {(kernel, dtype):
    (abs error, relative error or None)}."""
    import torch
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K

    errs, note = _error_table()
    for dt_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for n_in, hid, shapes in ((N_IN, HID, (TRAIN_TIME, TRAIN_BAND)),
                                  (FLOW_N, FLOW_H, (FLOW_TIME, FLOW_BAND))):
            for R, T in shapes:
                x, w_ih_t, w_hh_t, bias, xp, _ = _kernel_inputs(R, T, dtype, device, R + 3 * T,
                                                                n_in, hid)
                gen = torch.Generator().manual_seed(R * 3 + T)
                xp_b = (0.3 * torch.randn((R, T, 4 * hid), generator=gen)).to(device, dtype)
                dout = torch.randn((2, R, T, hid), generator=gen).to(device, dtype)
                for reverse in (False, True):
                    got = K.lstm_train_fwd_streamin(x, w_ih_t[0], bias[0], w_hh_t[0], reverse)
                    ref = K.lstm_train_fwd_streamin_plain(x, w_ih_t[0], bias[0], w_hh_t[0],
                                                          reverse)
                    torch.cuda.synchronize()
                    note(NEW_KERNELS[0], dt_name, max(_err(g, r) for g, r in zip(got, ref)))
                got = K.lstm_train_fwd2(xp, xp_b, w_hh_t[0], w_hh_t[1])
                ref = K.lstm_train_fwd2_plain(xp, xp_b, w_hh_t[0], w_hh_t[1])
                # K4's walk: K9's device code (bfloat16 K4 takes K4p)
                single = (*K.lstm_train_fwd_walk(xp, w_hh_t[0], False),
                          *K.lstm_train_fwd_walk(xp_b, w_hh_t[1], True))
                torch.cuda.synchronize()
                note(NEW_KERNELS[1], dt_name, max(_err(g, r) for g, r in zip(got, ref)))
                if not all(torch.equal(a, b) for a, b in zip(got, single)):
                    fail(f"lstm_train_fwd2 {dt_name} R={R} T={T}: not bitwise the K4 walk per "
                         "direction")
                got = K.lstm_train_bwd2(ref[:3], ref[3:], dout[0], dout[1], w_hh_t[0], w_hh_t[1])
                want = K.lstm_train_bwd2_plain(ref[:3], ref[3:], dout[0], dout[1], w_hh_t[0],
                                               w_hh_t[1])
                # K5's walk: K10's device code (bfloat16 K5 takes K5p)
                single = (*K.lstm_train_bwd_walk(*ref[:3], dout[0], w_hh_t[0], False),
                          *K.lstm_train_bwd_walk(*ref[3:], dout[1], w_hh_t[1], True))
                torch.cuda.synchronize()
                note(NEW_KERNELS[2], dt_name, max(_err(g, r) for g, r in zip(got, want)),
                     max(_rel(g, r) for g, r in zip(got, want)))
                if not all(torch.equal(a, b) for a, b in zip(got, single)):
                    fail(f"lstm_train_bwd2 {dt_name} R={R} T={T}: not bitwise the K5 walk per "
                         "direction")
                print(f"[new kernels] {dt_name} R={R} T={T} N={n_in} H={hid}: K9 == K4 walk x 2 "
                      "and K10 == K5 walk x 2 bit for bit")
    for (name, dt_name), (e_abs, e_rel) in sorted(errs.items()):
        backward = name.endswith("bwd2")
        tol = BF16_TOL if dt_name == "bfloat16" else (GRAD_TOL if backward else F32_TOL)
        e = e_rel if backward else e_abs
        kind = "max rel|d| (dx_proj, dW)" if backward else "max|d| (h, gates, c)"
        print(f"[new kernels] {name} {dt_name}: {kind}={e:.3e} (tolerance {tol}), "
              f"max|d|={e_abs:.3e}")
        if not e < tol:
            fail(f"{name} {dt_name}: kernel vs plain {e:.3e} >= {tol}")
    return errs


# ---------------------------------------------------------------------------
# the flow-matching family (phase 3)
# ---------------------------------------------------------------------------

FLOW_UTTERANCES = (("f48", 48000, 0.9), ("f16", 16000, 0.8))  # one 1 s bucket each


def _flow_config(workdir: Path, **over):
    from urgent2026_challenge_track1_tpu_torch.config import Config

    base = dict(  # the values of conf/models/BSRNN_flowse.yaml, 2 steps an epoch
        model_type="flowse", train_set_path=str(workdir / "flow_train"),
        valid_set_path=str(workdir / "flow_valid"), train_set_dynamic_mixing=False,
        batch_size=2, num_worker=2, max_duration=96000, learning_rate=1e-4, lr_step_size=1,
        lr_gamma=0.85, gradient_clip=0.5, weight_decay=1e-6, adam_epsilon=1e-8, seed=20250,
        save_top_k=5, ema_decay=0.999, bsrnn_hidden=FLOW_N, num_layer=6, device="cuda",
        num_train_epochs=2, val_check_interval=2, log_every_steps=1, train_tag="chip_smoke",
        train_name="flow")
    base.update(over)
    return Config(**base)


def phase_flow_training(workdir: Path):
    """``train_se.run`` with model_type=flowse at 384 x 6: 2 epochs of 2 steps
    (B=2, 2 s at 48 kHz) with validation (the N = 10 sampler) and checkpoints
    every 2 steps, then a run that resumes into a third epoch.  Checks the
    EMA, the frozen t_proj_w and the resume.  Returns the first run's
    routes and the newest checkpoint."""
    import torch
    from urgent2026_challenge_track1_tpu_torch import train_se
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K
    from urgent2026_challenge_track1_tpu_torch.train import trainer

    _write_split(workdir / "flow_train", FLOW_SECONDS + (1.8, 1.7), 20)
    _write_split(workdir / "flow_valid", (2.0, 1.75), 21)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        K.reset_launch_counts()
        t0 = time.perf_counter()
        state = train_se.run(_flow_config(workdir))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts, routes = K.launch_counts(), _routes()
        print(f"[flow training] 2 epochs x 2 steps (+ 2 validations with the sampler, 2 saves) "
              f"in {seconds:.1f} s, launches {counts}, routes {routes}")
        if (state.step, state.epoch) != (4, 2):
            fail(f"flow training ended at step {state.step}, epoch {state.epoch}; expected 4, 2")
        cfg = _flow_config(workdir)
        init = trainer.init_params(cfg.seed, trainer.build_model(cfg), "cpu").state_dict()
        params = {k: v.cpu() for k, v in state.model.state_dict().items()}
        ema = {k: v.cpu() for k, v in state.ema.state_dict().items()}
        frozen = [k for k in params if k.endswith("t_proj_w")]
        trained = [k for k in params if k not in frozen]
        moved = sum(not torch.equal(params[k], init[k]) for k in trained)
        ema_moved = sum(not torch.equal(ema[k], init[k]) for k in trained)
        ema_differs = sum(not torch.equal(ema[k], params[k]) for k in trained)
        print(f"[flow training] of {len(trained)} trained tensors: {moved} moved, EMA moved "
              f"{ema_moved} and differs from the parameters in {ema_differs}; "
              f"{len(frozen)} t_proj_w unchanged: "
              f"{all(torch.equal(params[k], init[k]) for k in frozen)}")
        if moved < len(trained) // 2 or ema_moved < len(trained) // 2 or ema_differs < moved:
            fail("flow training: the parameters or the EMA did not move as expected")
        if not frozen or not all(torch.equal(params[k], init[k]) for k in frozen):
            fail("flow training changed the frozen t_proj_w")
        exp = workdir / "exp" / "chip_smoke" / "flow" / "version_0"
        records = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
        train_losses = [r["train_loss"] for r in records if "train_loss" in r]
        vals = [(r["val_loss"], r.get("val_sisnr")) for r in records if "val_loss" in r]
        print(f"[flow training] train losses {train_losses}, val (loss, sampler SI-SNR) {vals}")
        if len(train_losses) != 4 or len(vals) != 2 or None in train_losses + sum(map(list, vals), []):
            fail("flow training logged missing or non-finite losses")
        t0 = time.perf_counter()
        resumed = train_se.run(_flow_config(workdir, num_train_epochs=3))
        print(f"[flow training] resumed run in {time.perf_counter() - t0:.1f} s: step "
              f"{resumed.step}, epoch {resumed.epoch}")
        if (resumed.step, resumed.epoch) != (6, 3):
            fail(f"the resumed flow run ended at step {resumed.step}, epoch {resumed.epoch}; "
                 "expected 6, 3")
    finally:
        os.chdir(cwd)
    for fn in K.KERNELS[:7]:
        if counts[fn.__name__] <= 0:
            fail(f"kernel {fn.__name__} was not launched on the flow training path")
    _check_routes("the float32 flow training path", "float32", routes,
                  INFERENCE_KERNELS + TRAIN_ROUTED)
    return routes, exp / "checkpoints" / "step_6.pt"


def phase_flow_cli(workdir: Path, ckpt: Path):
    """The port's inference CLI on the flow training's checkpoint (its EMA
    weights), with the default solver (euler, 15 steps) and with heun (8
    steps, 16 network calls)."""
    from urgent2026_challenge_track1_tpu_torch import inference
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K

    scp = _write_inputs(workdir, FLOW_UTTERANCES, "flow.scp", 2)
    K.reset_launch_counts()
    for name, extra in (("euler", []), ("heun", ["--solver", "heun", "--nfe", "8"])):
        before = K.launch_counts()
        out_dir = workdir / f"out_flow_{name}"
        t0 = time.perf_counter()
        inference.main(["--input_scp", str(scp), "--ckpt_path", str(ckpt),
                        "--output_dir", str(out_dir), "--device", "cuda", *extra])
        seconds = time.perf_counter() - t0
        _check_outputs(out_dir, FLOW_UTTERANCES)
        delta = {k: v - before[k] for k, v in K.launch_counts().items() if v - before[k]}
        print(f"[flow cli] {name}: {len(FLOW_UTTERANCES)} files in {seconds:.2f} s, "
              f"launches {delta}")
    counts, routes = K.launch_counts(), _routes()
    print(f"[flow cli] routes {routes}")
    _check_routes("the bfloat16 flow CLI", "bfloat16", routes)
    return counts, routes


# ---------------------------------------------------------------------------
# dynamic mixing, the init_from warm start and the RK45 sampler (phase 3)
# ---------------------------------------------------------------------------

DM_SECONDS = (2.9, 2.8, 2.7, 2.6, 2.5, 2.4, 2.3, 2.2)  # 8 speech sources, each over 2 s


def _write_dm_sources(root: Path, seed: int) -> Path:
    """A dynamic-mixing source corpus at 48 kHz: speech sources as FLAC,
    4 noises, 2 RIRs and 2 wind noises as WAV, and the JAX package's scp
    files (speech_sources.scp, noise_scoures.scp, rirs.scp,
    wind_noise_scoures.scp, source_length.scp)."""
    import numpy as np
    from urgent2026_challenge_track1_tpu_torch.utils import audio_io

    root.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    fs = 48000
    lines = {k: [] for k in ("speech_sources.scp", "noise_scoures.scp", "rirs.scp",
                             "wind_noise_scoures.scp", "source_length.scp")}

    def add(scp, uid, wav, ext):
        path = root / f"{uid}.{ext}"
        audio_io.write(str(path), wav, fs)
        lines[scp].append(f"{uid} {fs} {path}")

    for i, sec in enumerate(DM_SECONDS):
        n = int(sec * fs)
        t = np.arange(n) / fs
        gate = (np.sin(2 * np.pi * 1.5 * t) > -0.4).astype(np.float64)  # pauses
        wav = gate * 0.3 * np.sin(2 * np.pi * rng.uniform(120, 400) * t) \
            + 0.01 * rng.standard_normal(n)
        add("speech_sources.scp", f"speech{i}", wav, "flac")
        lines["source_length.scp"].append(f"speech{i} {n}")
    for i in range(4):
        add("noise_scoures.scp", f"noise{i}", 0.1 * rng.standard_normal(int((1.5 + i) * fs)),
            "wav")
    for i in range(2):
        h = rng.standard_normal(int(0.3 * fs)) * np.exp(-np.arange(int(0.3 * fs)) / (0.05 * fs))
        h[: 100 + 50 * i] = 0.0
        h[100 + 50 * i] = 1.0
        add("rirs.scp", f"rir{i}", 0.5 * h, "wav")
    for i in range(2):
        add("wind_noise_scoures.scp", f"wind_noise_{i}", 0.2 * rng.standard_normal(3 * fs), "wav")
    for name, ls in lines.items():
        (root / name).write_text("\n".join(ls) + "\n")
    return root


def _metrics(workdir: Path, name: str) -> list:
    exp = workdir / "exp" / "chip_smoke" / name / "version_0"
    return [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]


def phase_dm_training(workdir: Path):
    """``train_se.run`` on the values of conf/models/BSRNN_baseline_dm.yaml
    (196 x 6, B=4, max_duration 96000, num_worker 2, float32): dynamic
    mixing from FLAC speech sources, rendered by the spawned process pool,
    2 steps and one validation on a FLAC pre-simulated split.  Then the
    loader alone over one epoch, and the render of one item in this
    process.  Returns the run's routes and timings."""
    import torch
    from urgent2026_challenge_track1_tpu_torch import train_se
    from urgent2026_challenge_track1_tpu_torch.data.dataset import AudioDataModule
    from urgent2026_challenge_track1_tpu_torch.models.bsrnn import BSRNNConfig, init_bsrnn
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K

    root = _write_dm_sources(workdir / "dm_train", 30)
    _write_split(workdir / "dm_valid", (2.0, 1.75, 1.5, 1.25), 31, ext="flac")
    cfg = _train_config(workdir, train_set_path=str(root),
                        valid_set_path=str(workdir / "dm_valid"),
                        train_set_dynamic_mixing=True, use_high_pass=True, num_train_epochs=1,
                        val_check_interval=2, train_name="dm")
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        K.reset_launch_counts()
        t0 = time.perf_counter()
        state = train_se.run(cfg)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts, routes = K.launch_counts(), _routes()
        dw = _check_dw_launches("the dynamic-mixing training path", routes)
    finally:
        os.chdir(cwd)
    print(f"[dm training] 1 epoch x 2 steps (+ 1 validation, 1 save) in {seconds:.1f} s on "
          f"{os.cpu_count()} host CPUs, launches {counts}, routes {routes}, dW {dw}")
    if (state.step, state.epoch) != (2, 1):
        fail(f"dm training ended at step {state.step}, epoch {state.epoch}; expected 2, 1")
    records = _metrics(workdir, "dm")
    steps = [r for r in records if "train_loss" in r]
    vals = [r["val_loss"] for r in records if "val_loss" in r]
    step_s = [r["step_time"] for r in steps]
    wait_s = [r["data_time"] for r in steps]
    print(f"[dm training] train losses {[r['train_loss'] for r in steps]}, val losses {vals}, "
          f"step seconds {step_s}, loader wait seconds {wait_s}")
    if len(steps) != 2 or len(vals) != 1 or None in [r["train_loss"] for r in steps] + vals:
        fail("dm training logged missing or non-finite losses")
    init = init_bsrnn(BSRNNConfig(num_channel=N_IN, num_layer=6), seed=2024)
    trained = state.model.state_dict()
    changed = sum(not torch.equal(v, trained[k].cpu()) for k, v in init.state_dict().items())
    print(f"[dm training] {changed} of {len(trained)} parameter tensors changed")
    if changed < len(trained) // 2:
        fail("dm training left most parameters unchanged")
    for fn in K.KERNELS[:7]:
        if counts[fn.__name__] <= 0:
            fail(f"kernel {fn.__name__} was not launched on the dynamic-mixing training path")
    # K1-K3 on their float32 walks (validation), K4-K7 persistent only: no walk
    _check_routes("the dynamic-mixing training path", "float32", routes,
                  INFERENCE_KERNELS + TRAIN_ROUTED)
    presim = [r["step_time"] for r in _metrics(workdir, "baseline") if "train_loss" in r]
    # the loader alone: a fresh spawned pool over one epoch of 2 batches,
    # then one item rendered in this process
    dm = AudioDataModule(cfg)
    t0 = time.perf_counter()
    batch_s = []
    for _ in dm.train_dataloader(epoch=1):
        batch_s.append(time.perf_counter() - t0)
    item_s = []
    for i in range(4):
        t1 = time.perf_counter()
        dm.train_dataset[i]
        item_s.append(time.perf_counter() - t1)
    out = {"dm_step_s": step_s, "dm_loader_wait_s": wait_s,
           "dm_loader_share": sum(wait_s) / (sum(wait_s) + sum(step_s)),
           "presimulated_step_s": presim, "loader_epoch_batch_ready_s": batch_s,
           "render_item_s": item_s, "host_cpus": os.cpu_count(), "num_worker": cfg.num_worker}
    print("[dm training] " + json.dumps(out))
    return routes, out


def _reference_module():
    """tests/torch_ref_bsrnn.py: the reference BSRNN graphs in torch alone,
    whose state_dict keys are a Lightning checkpoint's."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("torch_ref_bsrnn",
                                                  REPO / "tests" / "torch_ref_bsrnn.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_init_from(workdir: Path, device):
    """A reference-layout Lightning ``.ckpt`` (SEModel keys, 196 x 6, random
    seeded weights) warm-starts a discriminative Trainer on the card: its
    parameters equal the converted state_dict bitwise before the first
    step; then one float32 train step."""
    import torch
    from urgent2026_challenge_track1_tpu_torch.train import trainer
    from urgent2026_challenge_track1_tpu_torch.utils.convert import load_init_from
    from urgent2026_challenge_track1_tpu_torch.utils.params import from_jax_params

    torch.manual_seed(40)
    ref = _reference_module().DiscriminativeBSRNN(481, N_IN, 6)
    ckpt = workdir / "reference_196x6.ckpt"
    torch.save({"state_dict": {f"se_model.bsrnn.bsrnn.{k}": v
                               for k, v in ref.state_dict().items()}}, ckpt)
    cfg = _train_config(workdir, init_from=str(ckpt), train_name="init_from")
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        tr = trainer.Trainer(cfg, None)
        state = tr.init_state()
    finally:
        os.chdir(cwd)
    expected = from_jax_params(load_init_from(str(ckpt))).state_dict()
    got = state.model.state_dict()
    unequal = [k for k, v in expected.items() if not torch.equal(got[k].cpu(), v)]
    print(f"[init_from] {len(expected) - len(unequal)} of {len(expected)} tensors equal the "
          f"converted checkpoint bitwise on {next(state.model.parameters()).device}")
    if unequal or next(state.model.parameters()).device.type != "cuda":
        fail(f"init_from: tensors {unequal[:5]} differ from the converted checkpoint")
    m = tr._get_train_step(48000)(state.model, state.optimizer, *_train_batch(device))
    torch.cuda.synchronize()
    print(f"[init_from] one step from the warm start: loss {float(m['loss']):.6g}")
    if not bool(torch.isfinite(m["loss"])) or m["nan_grad"]:
        fail("the step from the warm start gave a non-finite loss or gradient")


RK45_SECONDS = 0.5  # one input at 48 kHz


def phase_rk45(workdir: Path, ckpt: Path, device):
    """One RK45 enhancement (scipy solve_ivp at the JAX defaults rtol = atol
    = 1e-5) with the flow training's checkpoint at 384 x 6 in bfloat16 on
    the card: nfev model calls, each through K1p."""
    import numpy as np
    import torch
    from urgent2026_challenge_track1_tpu_torch.dsp import stft as dsp
    from urgent2026_challenge_track1_tpu_torch.models.bsrnn_flowse import vector_field
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K
    from urgent2026_challenge_track1_tpu_torch.sampling import get_black_box_solver
    from urgent2026_challenge_track1_tpu_torch.utils.checkpoint import load_model_for_inference

    kind, model, fcfg, stft_cfg = load_model_for_inference(str(ckpt), device.type)
    if kind != "flowse" or (device.type == "cuda" and fcfg.compute_dtype != "bfloat16"):
        fail(f"rk45: loaded a {kind} model in {fcfg.compute_dtype}")
    fs, n = 48000, int(RK45_SECONDS * 48000)
    rng = np.random.default_rng(60)
    t = np.arange(n) / fs
    wav = 0.3 * np.sin(2 * np.pi * 220.0 * t) + 0.05 * rng.standard_normal(n)
    noisy = torch.from_numpy((0.9 * wav / np.abs(wav).max()).astype(np.float32))[None].to(device)
    y = dsp.stft_encode(noisy, fs, stft_cfg)

    def vf(x, t_, y_):
        return vector_field(model, x, t_, y_, fs)

    K.reset_launch_counts()
    t0 = time.perf_counter()
    sample, nfev = get_black_box_solver(fcfg.ode, vf, y, T_rev=fcfg.T_rev, t_eps=fcfg.t_eps)(
        generator=torch.Generator(device=device).manual_seed(61))
    out = dsp.stft_decode(sample, fs, stft_cfg, length=n)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts, routes = K.launch_counts(), _routes()
    print(f"[rk45] {RK45_SECONDS} s at {fs} Hz: nfev {nfev} in {seconds:.2f} s "
          f"({1e3 * seconds / max(nfev, 1):.2f} ms per evaluation), sample {tuple(sample.shape)}, "
          f"launches { {k: v for k, v in counts.items() if v} }")
    if sample.shape != y.shape or not bool(torch.isfinite(torch.view_as_real(sample)).all()):
        fail("rk45: the sample is not finite or has the wrong shape")
    if out.shape != (1, n) or not bool(torch.isfinite(out).all()):
        fail("rk45: the decoded waveform is not finite or has the wrong length")
    _check_routes("the RK45 flow sampler", "bfloat16", routes, ("fusedin_bilstm",))
    return {"rk45_nfev": nfev, "rk45_s": seconds, "rk45_input_s": RK45_SECONDS}


# ---------------------------------------------------------------------------
# the A/B arms of the experiment toggles (phase 4)
# ---------------------------------------------------------------------------

ARMS = {"default": (False, False), "stream": (True, False), "fused": (False, True),
        "both": (True, True)}
ARM_ORDER = ("default", "stream", "fused", "both", "both", "fused", "stream", "default")
AB_LAYERS = 6  # both families' depth in the A/B arms


def _ab_model(device, family):
    """(bundle, cfg, model, batch) of one A/B family: the discriminative
    baseline (B=4, 2 s buckets at 48 kHz, 196 x 6, bf16; the geometry of
    scripts/bench_band_fused_ab.py) or the flow model (B=2, 2 s, 384 x 6,
    float32, the config's dtype)."""
    import torch
    from urgent2026_challenge_track1_tpu_torch.train import trainer

    if family == "disc":
        cfg = _train_config(Path("."), compute_dtype="bfloat16")
        batch = _train_batch(device)
    else:
        cfg = _flow_config(Path("."))
        clean, noisy, _ = _train_batch(device, B=2)
        batch = (clean, noisy, torch.tensor([int(s * 48000) for s in FLOW_SECONDS],
                                            dtype=torch.int32, device=device))
    bundle = trainer.build_model(cfg)
    return bundle, cfg, trainer.init_params(cfg.seed, bundle, device), batch


def phase_ab_arms(device):
    """One train step per visit of each arm, arms in alternating order, for
    each family; the toggles are restored whatever happens.  The launch
    counts are set to 0 once at the start of the phase: each step's
    launches are the counts' growth over it, and must be
    ``TRAIN_LAUNCHES_PER_LAYER`` times the depth.  Returns {family: {arm:
    {...}}} and the counts read at the end of the phase (its 2 warm-up and
    16 arm steps)."""
    import torch
    from urgent2026_challenge_track1_tpu_torch.models.bsrnn import TRAIN_LAUNCHES_PER_LAYER
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K
    from urgent2026_challenge_track1_tpu_torch.train import trainer

    expected = {arm: {k: v * AB_LAYERS for k, v in per_layer.items()}
                for arm, per_layer in TRAIN_LAUNCHES_PER_LAYER.items()}
    out = {}
    saved = (K.STREAM_INPUT_TRAIN, K.FUSED_BIDIR_TRAIN)
    K.reset_launch_counts()
    try:
        for family in ("disc", "flow"):
            bundle, cfg, model, batch = _ab_model(device, family)
            init = {k: v.clone() for k, v in model.state_dict().items()}
            step = trainer.make_train_step(bundle, cfg, 48000)
            step(model, trainer.make_optimizer(cfg, model), *batch,
                 generator=trainer.step_generator(cfg.seed, 0))  # warm-up, default arm
            arms = {}
            for arm in ARM_ORDER:
                K.STREAM_INPUT_TRAIN, K.FUSED_BIDIR_TRAIN = ARMS[arm]
                model.load_state_dict(init)
                opt = trainer.make_optimizer(cfg, model)
                before = K.launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = step(model, opt, *batch, generator=trainer.step_generator(cfg.seed, 0))
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                counts = {k: v - before[k] for k, v in K.launch_counts().items() if v - before[k]}
                rec = arms.setdefault(arm, {"ms": [], "launches": counts,
                                            "loss": float(m["loss"]),
                                            "grads": [p.grad.float().clone()
                                                      for p in model.parameters()]})
                rec["ms"].append(ms)
                if counts != expected[arm]:
                    fail(f"{family} {arm}: launches {counts}, expected {expected[arm]}")
            grads = {arm: rec.pop("grads") for arm, rec in arms.items()}
            ref = arms["default"]
            tol = BF16_TOL if cfg.compute_dtype == "bfloat16" else GRAD_TOL
            for arm, rec in arms.items():
                rec["median_ms"] = statistics.median(rec["ms"])
                rec["loss_rel_err"] = abs(rec["loss"] - ref["loss"]) / abs(ref["loss"])
                rec["grad_rel_err"] = max(_rel(g, r) for g, r in zip(grads[arm], grads["default"])
                                          if float(r.abs().max()) > 0)
                print(f"[a/b] {family} {cfg.compute_dtype} {arm}: step {rec['ms']} ms (median "
                      f"{rec['median_ms']:.1f}), loss {rec['loss']:.6g} (rel d vs default "
                      f"{rec['loss_rel_err']:.2e}), grads max rel d {rec['grad_rel_err']:.2e}, "
                      f"launches {rec['launches']}")
                if not (rec["loss_rel_err"] < tol and rec["grad_rel_err"] < tol):
                    fail(f"{family} {arm}: loss or gradients differ from the default arm by more "
                         f"than {tol}")
            out[family] = {"compute_dtype": cfg.compute_dtype, "arms": arms}
            del model
    finally:
        K.STREAM_INPUT_TRAIN, K.FUSED_BIDIR_TRAIN = saved
    total = K.launch_counts()
    print(f"[a/b] launches over the phase: {total}")
    for name in NEW_KERNELS:
        if total[name] <= 0:
            fail(f"kernel {name} was not launched by the A/B arms")
    return out, total


# ---------------------------------------------------------------------------
# flow card vs CPU (phase 5)
# ---------------------------------------------------------------------------


def phase_flow_card_vs_cpu(device):
    """The flow vector field's float32 forward and one flow train step's
    gradients at 384 x 6 on 0.5 s at 16 kHz (B=2, one row shorter), the
    CFM noise and t fixed: card (kernels) against CPU (plain versions)."""
    import copy

    import torch
    from urgent2026_challenge_track1_tpu_torch.dsp import stft as dsp
    from urgent2026_challenge_track1_tpu_torch.models import bsrnn_flowse as F

    fcfg = F.FlowSEConfig()
    fs, n = 16000, 8000
    cpu_model = F.init_flowse(fcfg, seed=9)
    card_model = copy.deepcopy(cpu_model).to(device)
    gen = torch.Generator().manual_seed(10)
    clean = 0.1 * torch.randn((2, n), generator=gen)
    noisy = clean + 0.05 * torch.randn((2, n), generator=gen)
    lengths = torch.tensor([n, 6000], dtype=torch.int32)
    noisy[1, 6000:] = clean[1, 6000:] = 0.0
    n_fft, _, hop = fcfg.stft_cfg.geometry(fs)
    y = dsp.stft_encode(noisy, fs, fcfg.stft_cfg)
    z = F.complex_normal_like(y, gen)
    t = torch.tensor([0.8, 0.3])
    frames = dsp.valid_frames(lengths, n_fft, hop)
    with torch.no_grad():
        got = F.vector_field(card_model, (y + 0.5 * z).to(device), t.to(device), y.to(device),
                             fs, frames.to(device)).cpu()
        ref = F.vector_field(cpu_model, y + 0.5 * z, t, y, fs, frames)
    valid = dsp.frames_mask(frames, y.shape[1]).bool()
    err = float((got - ref).abs()[valid].max())
    print(f"[card vs cpu] flow float32 384x6 vector field, 0.5 s at 16 kHz: max|d|={err:.3e} "
          f"(tolerance {E2E_TOL}, peak {float(ref.abs().max()):.3f})")
    if not err < E2E_TOL:
        fail(f"flow: card and CPU vector fields differ by {err:.3e} >= {E2E_TOL}")
    for model, dev in ((card_model, device), (cpu_model, torch.device("cpu"))):
        loss = F.flowse_loss(model, fcfg, clean.to(dev), noisy.to(dev), fs, lengths.to(dev),
                             noise=z.to(dev), t=t.to(dev))
        loss.backward()
    cpu_grads = dict(cpu_model.named_parameters())
    worst, worst_name = 0.0, ""
    for name, p in card_model.named_parameters():
        ref_g = cpu_grads[name].grad
        if float(ref_g.abs().max()) == 0.0:
            continue
        e = _rel(p.grad.cpu(), ref_g)
        if e > worst:
            worst, worst_name = e, name
    print(f"[card vs cpu] flow float32 384x6 train-step gradients: max rel|d|={worst:.3e} "
          f"({worst_name}; tolerance {E2E_TOL})")
    if not worst < E2E_TOL:
        fail(f"flow: card and CPU gradients differ by {worst:.3e} >= {E2E_TOL}")
    return err, worst


# ---------------------------------------------------------------------------
# flow and new-kernel times (phase 6)
# ---------------------------------------------------------------------------


def _new_kernel_bounds(R, T, n_in, hid):
    """Least time (ms) of K8-K10's bf16 work: K8 2 R T (N + H) 4H operations,
    reading x (N wide, not x_proj), W_ih, b and W_hh and writing h, gates and
    c; K9 and K10 twice the work of K4 and K5, so twice their bounds."""
    H, N, b = hid, n_in, 2
    train = _train_bounds(R, T, R * T, hid)
    (k4_ms, k4_by), (k5_ms, k5_by) = train["lstm_train_fwd"], train["lstm_train_bwd"]
    return {
        "lstm_train_fwd_streamin": _bound(
            2 * R * T * (N + H) * 4 * H,
            b * (R * T * N + N * 4 * H + 4 * H + H * 4 * H + 2 * R * T * H + R * T * 4 * H)),
        "lstm_train_fwd2": (2 * k4_ms, k4_by),
        "lstm_train_bwd2": (2 * k5_ms, k5_by),
    }


def _new_kernel_times(device, ab, ab_counts, new_errs):
    """K8 at the discriminative time path (R = 136, T = 201; the band path
    printed beside it) and K9/K10 at its band path (R = 804, T = 34), bf16:
    kernel, plain version and bound; no PyTorch call computes a
    residual-storing recurrence, so the library time is none.  ``launches``
    is the A/B phase's count (one reset, one read), and the launches of one
    train step are those measured in each family's first visit of each arm.
    The same at the flow training shapes (N = 384, H = 768: K8 at the time
    path R = 96, T = 251, its band path printed beside it, K9/K10 at the band
    path R = 502, T = 48), added as flow_* keys."""
    import torch
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K

    bf16 = torch.bfloat16
    records = {}
    for name, (R, T), n_in, hid in (
            ("lstm_train_fwd_streamin", TRAIN_TIME, N_IN, HID),
            ("lstm_train_fwd_streamin", TRAIN_BAND, N_IN, HID),
            ("lstm_train_fwd2", TRAIN_BAND, N_IN, HID), ("lstm_train_bwd2", TRAIN_BAND, N_IN, HID),
            ("lstm_train_fwd_streamin", FLOW_TIME, FLOW_N, FLOW_H),
            ("lstm_train_fwd_streamin", FLOW_BAND, FLOW_N, FLOW_H),
            ("lstm_train_fwd2", FLOW_BAND, FLOW_N, FLOW_H),
            ("lstm_train_bwd2", FLOW_BAND, FLOW_N, FLOW_H)):
        flow = hid == FLOW_H
        x, wi, wh, b, xp, _ = _kernel_inputs(R, T, bf16, device, R + T, n_in, hid)
        xp_b = xp.flip(1).contiguous()
        res = K.lstm_train_fwd2(xp, xp_b, wh[0], wh[1])
        dout = (0.1 * torch.randn((2, R, T, hid), device=device)).to(bf16)
        kern, plain = {
            "lstm_train_fwd_streamin": (lambda: K.lstm_train_fwd_streamin(x, wi[0], b[0], wh[0]),
                                        lambda: K.lstm_train_fwd_streamin_plain(x, wi[0], b[0],
                                                                                wh[0])),
            "lstm_train_fwd2": (lambda: K.lstm_train_fwd2(xp, xp_b, wh[0], wh[1]),
                                lambda: K.lstm_train_fwd2_plain(xp, xp_b, wh[0], wh[1])),
            "lstm_train_bwd2": (lambda: K.lstm_train_bwd2(res[:3], res[3:], dout[0], dout[1],
                                                          wh[0], wh[1]),
                                lambda: K.lstm_train_bwd2_plain(res[:3], res[3:], dout[0],
                                                                dout[1], wh[0], wh[1])),
        }[name]
        with torch.no_grad():
            ms = _time_ms(kern, reps=3 if flow else 5, warmup=1 if flow else 2)
            plain_ms = _time_ms(plain, reps=1 if flow else 3, warmup=1)
        bound_ms, bound_by = _new_kernel_bounds(R, T, n_in, hid)[name]
        print(f"[times] {name} R={R} T={T} N={n_in} H={hid} bf16: kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, library none, bound {bound_ms:.4f} ms ({bound_by})")
        del x, wi, wh, b, xp, xp_b, res, dout
        if name == "lstm_train_fwd_streamin" and (R, T) not in (TRAIN_TIME, FLOW_TIME):
            continue
        if flow:
            records[name].update({
                "flow_ms": ms, "flow_plain_ms": plain_ms, "flow_bound_ms": bound_ms,
                "flow_bound_by": bound_by, "flow_library_ms": None,
                "flow_shape": {"R": R, "T": T, "N": n_in, "H": hid}})
            continue
        e_abs, e_rel = new_errs[name, "bfloat16"]
        records[name] = {
            "name": name, "route": "cuda", "source": f"{PKG}/csrc/lstm_kernels.cu",
            "replaces": REPLACES[name], "launches": ab_counts[name],
            "launches_run": "a/b arms phase",
            "max_abs_err": e_abs, "max_rel_err": e_rel,
            "max_abs_err_f32": new_errs[name, "float32"][0],
            "max_rel_err_f32": new_errs[name, "float32"][1],
            "tolerance": BF16_TOL,
            "tolerance_f32": GRAD_TOL if name.endswith("bwd2") else F32_TOL,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "shape": {"R": R, "T": T, "N": n_in, "H": hid},
            "dtype": "bfloat16",
            "launches_per_train_step": {
                family: {arm: rec["launches"].get(name, 0) for arm, rec in fam["arms"].items()}
                for family, fam in ab.items()},
        }
    return list(records.values())


def _flow_kernel_times(device, records, flow_routes, wide_errs, wide_train_errs, k1_routes,
                       scan_routes, flow_cli_routes):
    """K1-K7 (their walks) at the flow training shapes (N = 384, H = 768),
    bf16: kernel, plain version and bound, added to the K1-K7 records
    as flow_* keys (flow_launches: the walk's launches on the float32 flow
    training path); K1p's and cuDNN's times there are the k1_routes phase's
    (flow band B=2), K2p's and K3p's the scan_routes phase's (flow CLI)."""
    import torch
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K

    bf16 = torch.bfloat16
    (tR, tT), (bR, bT) = FLOW_TIME, FLOW_BAND
    xb, wi, wh, b, _, _ = _kernel_inputs(bR, bT, bf16, device, 31, FLOW_N, FLOW_H)
    _, _, _, _, xp, _ = _kernel_inputs(tR, tT, bf16, device, 32, FLOW_N, FLOW_H)
    lengths = _frames_lengths(tR, tT, device, FLOW_SECONDS, 384)
    res = K.lstm_train_fwd(xp, wh[0])
    res_m = K.lstm_revmasked_train_fwd(xp, wh[1], lengths)
    dout = (0.1 * torch.randn((tR, tT, FLOW_H), device=device)).to(bf16)
    valid = int(lengths.sum())
    timed = {
        "fusedin_bilstm": (lambda: K.fusedin_bilstm_walk(xb, wi, wh, b),
                           lambda: K.fusedin_bilstm_plain(xb, wi, wh, b), (bR, bT)),
        "lstm_scan": (lambda: K.lstm_scan_walk(xp, wh[0]), lambda: K.lstm_scan_plain(xp, wh[0]),
                      (tR, tT)),
        "lstm_revmasked": (lambda: K.lstm_revmasked_walk(xp, wh[1], lengths),
                           lambda: K.lstm_revmasked_plain(xp, wh[1], lengths), (tR, tT)),
        "lstm_train_fwd": (lambda: K.lstm_train_fwd_walk(xp, wh[0]),
                           lambda: K.lstm_train_fwd_plain(xp, wh[0]), (tR, tT)),
        "lstm_train_bwd": (lambda: K.lstm_train_bwd_walk(*res, dout, wh[0]),
                           lambda: K.lstm_train_bwd_plain(*res, dout, wh[0]), (tR, tT)),
        "lstm_revmasked_train_fwd": (
            lambda: K.lstm_revmasked_train_fwd_walk(xp, wh[1], lengths),
            lambda: K.lstm_revmasked_train_fwd_plain(xp, wh[1], lengths), (tR, tT)),
        "lstm_revmasked_bwd": (lambda: K.lstm_revmasked_bwd_walk(*res_m, lengths, dout, wh[1]),
                               lambda: K.lstm_revmasked_bwd_plain(*res_m, lengths, dout, wh[1]),
                               (tR, tT)),
    }
    bounds = {**_bounds(bR, bT, 0, FLOW_N, FLOW_H),
              **_train_bounds(tR, tT, valid, FLOW_H)}
    bounds.update({k: v for k, v in _bounds(tR, tT, valid, FLOW_N, FLOW_H).items()
                   if k != "fusedin_bilstm"})
    by_name = {rec["name"]: rec for rec in records}
    with torch.no_grad():
        for name, (kern, plain, (R, T)) in timed.items():
            ms = _time_ms(kern, reps=3, warmup=1)
            plain_ms = _time_ms(plain, reps=1, warmup=1)
            bound_ms, bound_by = bounds[name]
            errs = wide_errs if name in INFERENCE_KERNELS else wide_train_errs
            e = errs[name, "bfloat16"]
            by_name[name].update({
                "flow_ms": ms, "flow_plain_ms": plain_ms, "flow_bound_ms": bound_ms,
                "flow_bound_by": bound_by, "flow_launches": flow_routes[name]["walk"],
                "flow_launches_run": "flow training path (float32)",
                "flow_shape": {"R": R, "T": T, "N": FLOW_N, "H": FLOW_H},
                "flow_max_abs_err": e if name in INFERENCE_KERNELS else e[0],
            })
            print(f"[times] {name} flow R={R} T={T} H={FLOW_H} bf16: kernel {ms:.3f} ms, plain "
                  f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        # K4 and K5 also run on the band path (2 of each layer's 3 K4 launches)
        _, _, _, _, xq, _ = _kernel_inputs(bR, bT, bf16, device, 33, FLOW_N, FLOW_H)
        band_res = K.lstm_train_fwd(xq, wh[0])
        band_dout = (0.1 * torch.randn((bR, bT, FLOW_H), device=device)).to(bf16)
        band_bounds = _train_bounds(bR, bT, bR * bT, FLOW_H)
        for name, kern in (("lstm_train_fwd", lambda: K.lstm_train_fwd_walk(xq, wh[0])),
                           ("lstm_train_bwd",
                            lambda: K.lstm_train_bwd_walk(*band_res, band_dout, wh[0]))):
            ms = _time_ms(kern, reps=3, warmup=1)
            by_name[name].update({"flow_band_ms": ms, "flow_band_bound_ms": band_bounds[name][0],
                                  "flow_band_shape": {"R": bR, "T": bT, "H": FLOW_H}})
            print(f"[times] {name} flow band R={bR} T={bT} H={FLOW_H} bf16: kernel {ms:.3f} ms, "
                  f"bound {band_bounds[name][0]:.4f} ms ({band_bounds[name][1]})")
    flow = next(r for r in k1_routes if (r["R"], r["T"], r["H"]) == (bR, bT, FLOW_H))
    by_name["fusedin_bilstm"]["flow_library_ms"] = flow["cudnn_ms"]
    walk = by_name["fusedin_bilstm"]
    by_name["fusedin_bilstm_persistent"].update({
        "flow_ms": flow["k1p_ms"], "flow_plain_ms": walk["flow_plain_ms"],
        "flow_bound_ms": flow["bound_ms"], "flow_bound_by": flow["bound_by"],
        "flow_library_ms": flow["cudnn_ms"],
        "flow_launches": flow_cli_routes["fusedin_bilstm"]["persistent"],
        "flow_launches_run": "flow inference CLI", "flow_shape": walk["flow_shape"],
        "flow_max_abs_err": flow["max_abs_err_vs_plain"], "flow_plan": flow["plan"],
    })
    flow = next(r for r in scan_routes if r["H"] == FLOW_H)
    for name in ("lstm_scan", "lstm_revmasked"):
        p = flow[name]
        by_name[f"{name}_persistent"].update({
            "flow_ms": p["ms"], "flow_plain_ms": p["plain_ms"], "flow_walk_ms": p["walk_ms"],
            "flow_bound_ms": p["bound_ms"], "flow_bound_by": p["bound_by"],
            "flow_library_ms": None, "flow_reference_ms": flow["nn_lstm_forward_ms"],
            "flow_launches": flow_cli_routes[name]["persistent"],
            "flow_launches_run": "flow inference CLI",
            "flow_shape": {"R": flow["R"], "T": flow["T"], "H": FLOW_H,
                           "valid_steps": flow["valid_steps"]},
            "flow_max_abs_err": p["max_abs_err_vs_plain"], "flow_plan": flow["plan"],
        })


def _flow_step_and_enhance_times(device):
    """The flow train step (B=2, 2 s at 48 kHz, 384 x 6) in float32 and
    bfloat16: median of 3 after 1 warm-up, peak memory, launches per step;
    then one enhancement (B=1, 4 s at 48 kHz, N = 15 euler, bf16 as the
    inference loader runs it on the card)."""
    import torch
    from urgent2026_challenge_track1_tpu_torch.models import bsrnn_flowse as F
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K
    from urgent2026_challenge_track1_tpu_torch.train import trainer

    out = {}
    for compute_dtype in ("float32", "bfloat16"):
        cfg = _flow_config(Path("."), compute_dtype=compute_dtype)
        bundle = trainer.build_model(cfg)
        model = trainer.init_params(cfg.seed, bundle, device)
        opt = trainer.make_optimizer(cfg, model)
        step = trainer.make_train_step(bundle, cfg, 48000)
        clean, noisy, _ = _train_batch(device, B=2)
        lengths = torch.tensor([int(s * 48000) for s in FLOW_SECONDS], dtype=torch.int32,
                               device=device)
        K.reset_launch_counts()
        step(model, opt, clean, noisy, lengths, generator=trainer.step_generator(cfg.seed, 0))
        per_step, routes = {k: v for k, v in K.launch_counts().items() if v}, _routes()
        _check_no_lean_kernels(f"flow train step {compute_dtype}", per_step)
        _check_routes(f"flow train step {compute_dtype}", compute_dtype, routes, TRAIN_ROUTED)
        dw_per_step = _check_dw_launches(f"flow train step {compute_dtype}", routes)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(3):
            t0 = time.perf_counter()
            m = step(model, opt, clean, noisy, lengths,
                     generator=trainer.step_generator(cfg.seed, i + 1))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if m["nan_grad"]:
                fail("the timed flow train step hit a non-finite gradient")
        out[compute_dtype] = {"median_ms": statistics.median(times), "ms": times,
                              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                              "launches_per_step": per_step,
                              "routes_per_step": {k: routes[k] for k in TRAIN_ROUTED},
                              "dw_launches_per_step": dw_per_step}
        print(f"[times] flow train step {compute_dtype} (B=2, 2 s at 48 kHz, 384x6): median "
              f"{out[compute_dtype]['median_ms']:.1f} ms of {[round(t, 1) for t in times]}, "
              f"peak {out[compute_dtype]['peak_memory_gb']:.2f} GB, launches per step "
              f"{per_step}, K4-K7 routes {out[compute_dtype]['routes_per_step']}, dW kernel "
              f"{dw_per_step}")
        del model, opt
    fcfg = F.FlowSEConfig(compute_dtype="bfloat16")
    model = F.init_flowse(fcfg, seed=11, device=device).eval()
    wav = 0.1 * torch.randn((1, 4 * 48000), device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    with torch.inference_mode():
        K.reset_launch_counts()
        F.flowse_enhance(model, fcfg, wav, 48000, N=15, generator=gen)
        launches = {k: v for k, v in K.launch_counts().items() if v}
        routes = _routes()
        _check_routes("flow enhance", "bfloat16", routes, ("fusedin_bilstm",))
        launches["k1_routes"] = routes["fusedin_bilstm"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = F.flowse_enhance(model, fcfg, wav, 48000, N=15, generator=gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    if not bool(torch.isfinite(y).all()) or y.shape != wav.shape:
        fail("the timed flow enhancement is not finite or has the wrong shape")
    out["enhance"] = {"ms": ms, "B": 1, "seconds": 4, "fs": 48000, "N": 15, "solver": "euler",
                      "dtype": "bfloat16", "launches": launches}
    print(f"[times] flow enhance B=1, 4 s at 48 kHz, N=15 euler, 384x6 bf16: {ms:.1f} ms "
          f"(RTF {4 / (ms / 1e3):.2f}x real time), launches {launches}")
    return out


REPLACES = {
    "fusedin_bilstm": "urgent2026_challenge_track1_tpu/ops/pallas_lstm.py:196",
    "lstm_scan": "urgent2026_challenge_track1_tpu/ops/pallas_lstm.py:82",
    "lstm_revmasked": "urgent2026_challenge_track1_tpu/ops/pallas_lstm.py:1051",
    "lstm_train_fwd": "urgent2026_challenge_track1_tpu/ops/pallas_lstm.py:563",
    "lstm_train_bwd": "urgent2026_challenge_track1_tpu/ops/pallas_lstm.py:647",
    "lstm_revmasked_train_fwd": "urgent2026_challenge_track1_tpu/ops/pallas_lstm.py:1105",
    "lstm_revmasked_bwd": "urgent2026_challenge_track1_tpu/ops/pallas_lstm.py:1189",
    "lstm_train_fwd_streamin": "urgent2026_challenge_track1_tpu/ops/pallas_lstm.py:491",
    "lstm_train_fwd2": "urgent2026_challenge_track1_tpu/ops/pallas_lstm.py:765",
    "lstm_train_bwd2": "urgent2026_challenge_track1_tpu/ops/pallas_lstm.py:865",
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

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"[phase] {name}: {time.perf_counter() - t:.1f} s")
        return out

    timed("build", phase_build)
    errs = timed("inference kernels", phase_kernels, device)
    train_errs = timed("training kernels", phase_train_kernels, device)
    wide_errs = timed("inference kernels H=768", phase_kernels, device, FLOW_N, FLOW_H,
                      (FLOW_TIME,), (FLOW_BAND,))
    wide_train_errs = timed("training kernels H=768", phase_train_kernels, device, FLOW_H,
                            (FLOW_TIME, FLOW_BAND), FLOW_SECONDS, 384)
    new_errs = timed("K8-K10", phase_new_kernels, device)
    k1_routes = timed("k1_routes", phase_k1_routes, device)
    scan_routes = timed("scan_routes", phase_scan_routes, device)
    train_routes_rows = timed("train_routes", phase_train_routes, device)
    bwd_routes_rows = timed("bwd_routes", phase_bwd_routes, device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=REPO) as tmp:
        counts, main_routes = timed("inference path", phase_main_path, Path(tmp))
        _, train_routes = timed("training path", phase_training, Path(tmp))
        flow_routes, flow_ckpt = timed("flow training path", phase_flow_training, Path(tmp))
        _, flow_cli_routes = timed("flow inference path", phase_flow_cli, Path(tmp), flow_ckpt)
        _, dm_times = timed("dynamic-mixing training path", phase_dm_training, Path(tmp))
        timed("init_from warm start", phase_init_from, Path(tmp), device)
        dm_times.update(timed("rk45 flow sampler", phase_rk45, Path(tmp), flow_ckpt, device))
    wide_routes = timed("walk route", phase_walk_route, device)
    ab, ab_counts = timed("a/b arms", phase_ab_arms, device)
    timed("card vs cpu forward", phase_card_vs_cpu, device)
    timed("card vs cpu gradients", phase_grads_card_vs_cpu, device)
    timed("flow card vs cpu", phase_flow_card_vs_cpu, device)
    records = timed("times", phase_times, device, counts, errs, train_errs, k1_routes,
                    scan_routes, train_routes_rows, bwd_routes_rows, main_routes, train_routes,
                    wide_routes)
    records += timed("times K8-K10", _new_kernel_times, device, ab, ab_counts, new_errs)
    timed("times K1-K7 flow shapes", _flow_kernel_times, device, records, flow_routes,
          wide_errs, wide_train_errs, k1_routes, scan_routes, flow_cli_routes)
    flow_times = timed("times flow", _flow_step_and_enhance_times, device)
    for rec in records:  # K4p-K7p and the dW kernel in one flow train step of their dtype
        if rec["name"] in (f"{n}_persistent{sfx}" for n in TRAIN_ROUTED for sfx in ("", "_f32")):
            dt = rec["dtype"]
            name = rec["name"].removesuffix("_f32").removesuffix("_persistent")
            rec["flow_launches"] = flow_times[dt]["routes_per_step"][name]["persistent"]
            rec["flow_launches_run"] = f"one {dt} flow train step (B=2, 2 s, 384 x 6)"
        elif rec["name"] in ("lstm_bwd_dw", "lstm_bwd_dw_f32"):
            dt = rec["dtype"]
            rec["flow_launches"] = flow_times[dt]["dw_launches_per_step"]
            rec["flow_launches_run"] = f"one {dt} flow train step (B=2, 2 s, 384 x 6)"
    print("[times] " + json.dumps({"ab_arms": ab, "flow": flow_times, "dm": dm_times}))
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(gpu_name_and_power())
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
