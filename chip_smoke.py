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
     model's (H = 768); then the walks of K8-K10 at the discriminative band
     path in both dtypes (K9's: K4's walk once a direction) and K8's walk at
     H = 1020 in float32 (where it is still the route), K10's walk against
     K5's run per direction (bitwise equal); then K8p (bfloat16 and float32: K8p-f32), K9p (two
     K4p / K4p-f32 launches) and K10p (bfloat16 and float32; at the flow
     band in float32 its one-direction pair, a K5p-f32 launch a direction),
     the persistent routes of K8-K10, against their plain versions with
     planted faults, TF32 controls and dW bounds, K9p against K4p and K10p
     and the pair against K5p run per direction (bitwise equal), and their,
     the walks', the default arm's and torch.nn.LSTM's times (the k8p/k10p
     routes phase); then K1p, K1's
     persistent bfloat16 route, against the plain version and the walk at
     the eight shapes where K1 runs, with its plan and its, the walk's and
     cuDNN's times (the k1_routes phase); then K1p-f32, K1's float32 route
     (3xTF32; one grid, or a launch a direction at the flow width), against
     the plain version within F32_LIMIT with the stale-h and one-TF32
     controls at the ten shapes where float32 K1 runs or that cover its
     copy paths, beside the float32 walk's and cuDNN's float32 times (the
     k1_routes f32 phase); then K2p and K3p, the persistent
     bfloat16 routes of K2 and K3, against the plain versions and the walks
     at every step at the five shapes where they run, with their plans, a
     planted stale-h fault, their, the walks' and the plain versions' times
     and an S sweep (the scan_routes phase); then K2p-f32 and K3p-f32, their
     float32 routes (3xTF32), within F32_LIMIT of the plain versions with the
     stale-h and one-TF32 controls, two launches bitwise, at those shapes
     and the flow validation's 96 x 251, with plans, times beside the f32
     walks' and a float32 nn.LSTM forward's, and an S sweep (the
     scan_routes f32 phase); then K4p and K6p, the
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
     CLIs) and K1p-f32, K2p-f32 and K3p-f32 on the float32 ones (the
     training runs' validations, one pass of each family timed; a train
     step runs none of K1-K3), and that on the float32 training runs K4-K7
     took K4p-f32 - K7p-f32; the batched CLI run reads
     its inputs as FLAC; then the dynamic-mixing config
     (BSRNN_baseline_dm.yaml: 196 x 6, B=4, 2 s at 48 kHz, float32) through
     ``train_se.run`` for 2 steps and a validation, its batches rendered by
     two spawned workers from FLAC speech sources (K4p-f32 - K7p-f32, no
     walk of K4-K7; the steps' and the loader's times); a reference
     ``.ckpt`` at 196 x 6 warm-starts a trainer through ``init_from``
     (bitwise equal to the converted weights, then one step); one RK45
     flow enhancement (scipy solve_ivp, rtol = atol = 1e-5) from the flow
     training's checkpoint in bfloat16 (nfev K1p forwards); the
     model-scored evaluation CLIs (phase_eval_clis: UTMOS, speaker
     similarity, LID and WER on seeded TorchScript stubs at --device cuda
     against --device cpu within EVAL_TOL, ``evaluation.eval_all`` end to
     end on the card with its produced and skipped lists, and
     ``average_checkpoints`` over the training phase's three checkpoints,
     bitwise their float64 mean, enhancing on the card); then one
     float32 train step at 510 channels (H = 1020, where no float32
     K4p/K6p plan fits) takes the walks of K4 and K6 and K5p-f32 / K7p-f32,
     the same step under STREAM_INPUT_TRAIN K8's walk, under
     FUSED_BIDIR_TRAIN K9's walk route (K4's walk once a direction) and
     K10's one-direction pair, and one
     float32 forward K1's (no float32 K8p / K1p plan fits there either);
     then the causal streaming path (phase_causal): a causal
     streaming_norm model at 196 x 6 trains 3 float32 steps (K4p-f32,
     K5p-f32, dW-f32; no K6/K7), is saved and loaded for inference
     (bfloat16), and a StreamingSession over 4 s at 48 kHz (8 frames a
     step: K2p with its carry, K1p on 8 band rows) equals the offline
     causal forward (float32, and bfloat16 within E2E_BF16_BOUND, which
     the stream with a dropped carry must exceed), on the card and against
     the CPU; then the server (phase_serving): 8 concurrent POST /enhance
     through the batching engine with max_retries=0 against
     make_enhance_fn, /stats, /healthz, and POST /stream against the
     StreamingSession; before these, K2 with a carry (K2p and the float32
     walk) against its plain version with a dropped-carry fault (the
     carry_routes phase); then the dynamic-mixing config with
     dynamic_mixing_on_device (phase_dm_device: 2 steps and a validation
     through ``train_se.run``, the batches rendered on the card inside the
     step, K4p-f32 - K7p-f32; one batch rendered on the card against the
     CPU render, with a control), after phase_dm_training renders one codec
     item where ``codecs_available()`` (printed after the build) is True;
     then SGMSE at 196 x 6 (phase_sgmse: score, DSM loss and gradients and
     an N = 3 enhancement in float32 against the CPU; a bf16 enhancement
     at N = 50 over 4 s at 48 kHz through K1p, its launches and wall time,
     against the float32 run of the same draws (K1p-f32), with a control);
  4. the A/B arms of the two experiment toggles (default, STREAM_INPUT_TRAIN,
     FUSED_BIDIR_TRAIN, both, in alternating order) on one train step of
     each family: launches per kernel, loss and gradients against the
     default arm (the fused arm's loss bit for bit, and in the flow family
     its gradients too), step times, and each step's K8, K9 and K10 routes
     against the route rules (K8p, K9p and K10p in bfloat16, K8p-f32,
     K9p-f32 and K10's one-direction pair in the flow float32 family; a
     discriminative float32 family runs the default and fused arms for
     K9p-f32 and K10p-f32; no K9 or K10 walk); K8-K10 run here;
  5. compare a float32 forward, and one float32 train step's gradients, on
     the card (kernels) with the same on the CPU (plain versions), for both
     families (the flow model at full width, two layers deep); then dp x mp
     parallelism (phase_parallel): over NCCL at a world of one, the
     collective helpers on CUDA tensors, and the "dp=-1" mesh's sharded
     enhancement and train step, with a row sharder over the world's one
     member, bit for bit the unsharded ones; then two processes on the one card over gloo (NCCL refuses two
     ranks on one device; this script started with ``--parallel-worker
     RANK PORT DIR DEVICE``), each with its launch counts: the "dp=1,mp=2"
     enhancement of both families against one process's, and float32
     "dp=2" / "dp=1,mp=2" train steps (loss, grad norm, parameters)
     against one process's step on the same global batch; then the
     evaluation path's ONNX executor (phase_onnx): the two stand-in DNSMOS
     graphs (``evaluation/dnsmos_standin.py``) at DNSMOS's input shapes on
     the card against the CPU within ONNX_TOL with the process's TF32 on
     around the calls (the session turns it off and restores it), its
     outputs CUDA tensors, the graph with its first conv's pads mirrored as
     the control that must exceed the limit, and ``dnsmos.score_one`` on a
     10 s signal with its time per 9.01 s window;
  6. time each kernel, its plain version and (for K1) cuDNN's LSTM, the
     end-to-end forward at the JAX bench geometry, the train step at the
     baseline geometry in float32 and bfloat16 with its peak memory and
     launches per step and K4-K7's routes per dtype (K4p-K7p and their dW
     kernel in either dtype; no train step runs a walk),
     K1-K7 at the flow shapes (K8-K10's times are the k8p/k10p routes
     phase's, with the nn.LSTM calls for their functions: K8 a
     one-direction training forward, K9/K10 the bidirectional forward and
     backward, supersets), the flow train step and one flow enhancement.

The second line from the end is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a card, or without the port
package beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import io
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

BF16_TOL = 5e-2  # scripts/check_pallas_tpu.py:29-34; float32: PC.WALK_F32_TOL
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
    from urgent2026_challenge_track1_tpu_torch.ops import persistent_checks as PC

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
        tol = PC.WALK_F32_TOL if dt_name == "float32" else BF16_TOL
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
    from urgent2026_challenge_track1_tpu_torch.ops import persistent_checks as PC

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
        tol = BF16_TOL if dt_name == "bfloat16" else (GRAD_TOL if backward else PC.WALK_F32_TOL)
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
                   ("flow enhance time B=1", 48, 501, FLOW_N, FLOW_H),
                   ("stream step band", 8, 34, N_IN, HID))


def phase_k1_routes(device):
    """K1p against the plain version and against the walk (itself held
    against the plain version) at the eight shapes where K1 runs, bfloat16:
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


# the shapes where float32 K1 runs, (what, R, T, N, H): a float32 trainer's
# validation (the disc band of one utterance and of a B=4 batch, the flow
# band of a B=2 batch), the time path without lengths (34 x 401: float32
# SGMSE), the bench band (H = 384) and one float32 flow enhancement's band
# and time paths (the flow width: a launch a direction); then odd N and H
# (x staged in 4-, 8- and 16-byte copies, h in L2-only 16-byte copies or
# plain L2 loads)
K1_F32_ROUTE_SHAPES = (("disc band B=1", 401, 34, N_IN, HID),
                       ("B=4 band", 804, 34, N_IN, HID),
                       ("disc time B=1", 34, 401, N_IN, HID),
                       ("bench band B=64", 64 * 401, 34, 192, 384),
                       ("flow band B=2", 502, 48, FLOW_N, FLOW_H),
                       ("flow enhance band B=1", 501, 48, FLOW_N, FLOW_H),
                       ("flow enhance time B=1", 48, 501, FLOW_N, FLOW_H),
                       ("odd N and H", 13, 7, 37, 46),
                       ("N = 2 mod 4", 21, 5, 38, 20),
                       ("H = 72", 13, 11, 40, 72))


def phase_k1_f32_routes(device):
    """K1p-f32 (K1's float32 route, 3xTF32) through the routed wrapper at
    K1_F32_ROUTE_SHAPES: the rule must take a float32 plan (one grid where
    a two-direction plan fits, else a launch a direction) and count it so;
    the plan against the kernel's bytes; the output within
    ``persistent_checks.F32_LIMIT`` of the plain version, which the planted
    stale h (``fusedin_bilstm_stale_h``) and the walk with one TF32 product
    each (``fusedin_bilstm_tf32``) must exceed; two calls bitwise equal;
    the float32 walk within WALK_F32_TOL of the plain version.  Times
    (medians of ``_time_ms``): K1p-f32 (its weight pack included), the
    pack alone, the float32 walk, the plain version, the bidirectional
    float32 cuDNN ``nn.LSTM`` inference forward (TF32 off), and the bound
    at PEAK_TF32_FLOPS."""
    import torch
    from urgent2026_challenge_track1_tpu_torch.ops import _build
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K
    from urgent2026_challenge_track1_tpu_torch.ops import persistent_checks as PC

    f32 = torch.float32
    sms = _sm_count(device)
    lib = _build.load_library()
    out = []
    for what, R, T, N, H in K1_F32_ROUTE_SHAPES:
        x, wi, wh, b, _, _ = _kernel_inputs(R, T, f32, device, R + 3 * T, N, H)
        plan = K.k1_route(f32, R, N, H, sms)
        if plan is None or plan.elem != 4:
            fail(f"K1p-f32: the rule takes no float32 plan at {what} (R={R}, N={N}, H={H})")
        kernel_smem = lib.lstm_persistent_smem(N, H, plan.U, plan.rows, plan.chunk,
                                                int(plan.c_in_smem), 4)
        if kernel_smem != plan.smem:
            fail(f"K1p-f32 plan at {what}: {plan.smem} bytes, the kernel reckons {kernel_smem}")
        route = "persistent" if plan.dirs == 2 else "persistent_split"
        with torch.inference_mode():
            K.reset_launch_counts()
            got = K.fusedin_bilstm(x, wi, wh, b)
            routes = K.route_counts()
            again = K.fusedin_bilstm(x, wi, wh, b)
            ref = K.fusedin_bilstm_plain(x, wi, wh, b)
            torch.cuda.synchronize()
            bitwise = torch.equal(got, again)
            e_plain = _err(got, ref)
            del got, again
            walk = K.fusedin_bilstm_walk(x, wi, wh, b)
            e_walk = _err(walk, ref)
            del walk
            e_stale = _err(PC.fusedin_bilstm_stale_h(x, wi, wh, b), ref)
            e_tf32 = _err(PC.fusedin_bilstm_tf32(x, wi, wh, b), ref)
            limit = PC.persistent_limit(ref)
            del ref
            big = R * T > 200000  # the bench band: one visit of the walk and the plain version
            k1p_ms = _time_ms(lambda: K.fusedin_bilstm(x, wi, wh, b))
            pack_ms = _time_ms(lambda: K.pack_persistent_weights(wi, wh, b, plan))
            walk_ms = _time_ms(lambda: K.fusedin_bilstm_walk(x, wi, wh, b), reps=1 if big else 3,
                               warmup=0 if big else 1)
            plain_ms = _time_ms(lambda: K.fusedin_bilstm_plain(x, wi, wh, b), reps=1,
                                warmup=0 if big else 1)
            lstm = torch.nn.LSTM(N, H, batch_first=True, bidirectional=True).to(device, f32)
            cudnn_ms = _time_ms(lambda: lstm(x))
        bound_ms, bound_by = _bounds(R, T, 0, N, H, "float32")["fusedin_bilstm"]
        rec = {"what": what, "R": R, "T": T, "N": N, "H": H, "dtype": "float32",
               "plan": {"dirs": plan.dirs, "S": plan.S, "G": plan.G, "U": plan.U,
                        "rows": plan.rows, "chunk": plan.chunk, "c_in_smem": plan.c_in_smem,
                        "smem_bytes": plan.smem, "ctas": plan.ctas},
               "route": route, "routes": routes, "max_abs_err_vs_plain": e_plain,
               "limit": limit, "max_err_over_limit": e_plain / limit,
               "planted_stale_h_over_limit": e_stale / limit,
               "tf32_control_over_limit": e_tf32 / limit, "bitwise_repeat": bitwise,
               "walk_max_abs_err_vs_plain": e_walk,
               "ms": k1p_ms, "pack_ms": pack_ms, "walk_ms": walk_ms, "plain_ms": plain_ms,
               "cudnn_ms": cudnn_ms, "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"[k1 routes f32] {what} R={R} T={T} N={N} H={H}: plan dirs={plan.dirs} "
              f"S={plan.S} G={plan.G} U={plan.U} rows={plan.rows} chunk={plan.chunk} "
              f"c_in_smem={plan.c_in_smem} smem={plan.smem} B ({plan.ctas} CTAs a launch); "
              f"routes {routes}; K1p-f32 {k1p_ms:.3f} ms (its weight pack {pack_ms:.4f} ms), "
              f"walk {walk_ms:.3f} ms, plain {plain_ms:.3f} ms, cuDNN f32 {cudnn_ms:.3f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}); max|K1p-f32 - plain| {e_plain:.3e} "
              f"(limit {limit:.1e}), stale h {e_stale:.3e}, one TF32 product {e_tf32:.3e}, "
              f"max|walk - plain| {e_walk:.3e} (limit {PC.WALK_F32_TOL}); two calls bitwise "
              f"equal: {bitwise}")
        want = {"persistent": 0, "walk": 0, "persistent_split": 0}
        want[route] = 1 if plan.dirs == 2 else 2
        if routes != want:
            fail(f"K1p-f32 {what}: the routed K1 took {routes}, expected {want}")
        if not e_plain < limit:
            fail(f"K1p-f32 {what}: vs plain {e_plain:.3e} >= {limit:.3e}")
        for name, e in (("a stale h", e_stale), ("one TF32 product", e_tf32)):
            if not e >= limit:
                fail(f"K1p-f32 {what}: {name} moves the output by {e:.3e}, under the limit "
                     f"{limit:.3e}: the check cannot see it")
        if not bitwise:
            fail(f"K1p-f32 {what}: two calls differ")
        if not e_walk < PC.WALK_F32_TOL:
            fail(f"K1 walk f32 {what}: vs plain {e_walk:.3e} >= {PC.WALK_F32_TOL}")
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


# the shapes where float32 K2 and K3 run or that cover their copy paths: the
# bfloat16 CLI's (SCAN_ROUTE_SHAPES; 34 x 401 is also the float32 offline
# forward's, 136 x 201 the disc validation pass's) and the flow validation
# pass's (B=2, 2 s at 48 kHz, hop 384: 2 x 48 bands over 251 frames, H = 768)
SCAN_F32_SHAPES = SCAN_ROUTE_SHAPES + (
    ("flow validation B=2", 96, 251, FLOW_H, tuple(1 + int(s * 48000) // 384
                                                  for s in FLOW_SECONDS)),)


def phase_scan_f32_routes(device):
    """K2p-f32 and K3p-f32 (K2's and K3's float32 routes, 3xTF32) through
    the routed wrappers at SCAN_F32_SHAPES: the rule must take the float32
    plan and count it so; the plan against the kernel's bytes; the output
    at every step, padded ones included, within ``persistent_checks.F32_LIMIT``
    of the plain version, which the planted stale h
    (``persistent_checks.lstm_scan_stale_h``) and the walk with one TF32
    product (``persistent_checks.lstm_scan_tf32``) must each exceed; two
    launches bitwise equal; the float32 walk (called by name) within
    WALK_F32_TOL of the plain version.  Times (medians of ``_time_ms``):
    the routed kernel (its weight pack included), the pack alone, the walk,
    the plain version, a one-direction float32 ``torch.nn.LSTM`` inference
    forward (TF32 off; a superset: it adds the W_ih products) and the bound
    at PEAK_TF32_FLOPS; at the one-utterance and flow shapes the kernel on
    the plans of fewer SMs (the S sweep)."""
    import torch
    from urgent2026_challenge_track1_tpu_torch.ops import _build
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K
    from urgent2026_challenge_track1_tpu_torch.ops import persistent_checks as PC

    from urgent2026_challenge_track1_tpu_torch.models.bsrnn import BSRNNConfig, band_count

    f32 = torch.float32
    sms = _sm_count(device)
    lib = _build.load_library()
    low_rate_rows = band_count(BSRNNConfig().input_dim, 48000, 16000, 161)
    out = []
    for what, R, T, H, per_utt in SCAN_F32_SHAPES:
        R = R or low_rate_rows
        _, _, wh, _, xp, _ = _kernel_inputs(R, T, f32, device, R + T + H + 1, hid=H)
        lengths = torch.tensor(per_utt, dtype=torch.int32).repeat_interleave(
            R // len(per_utt)).clamp(max=T).to(device)
        plan = K.scan_route(f32, R, H, sms)
        if plan is None or plan.elem != 4:
            fail(f"K2p-f32/K3p-f32: the rule takes no float32 plan at {what} (R={R}, H={H})")
        kernel_smem = lib.lstm_persistent_smem(0, H, plan.U, plan.rows, plan.chunk,
                                                int(plan.c_in_smem), 4)
        if kernel_smem != plan.smem:
            fail(f"K2p-f32/K3p-f32 plan at {what}: {plan.smem} bytes, the kernel reckons "
                 f"{kernel_smem}")
        bounds = _bounds(R, T, int(lengths.sum()), hid=H, dtype="float32")
        rec = {"what": what, "R": R, "T": T, "H": H, "dtype": "float32",
               "valid_steps": int(lengths.sum()),
               "plan": {"S": plan.S, "G": plan.G, "U": plan.U, "rows": plan.rows,
                        "chunk": plan.chunk, "c_in_smem": plan.c_in_smem,
                        "smem_bytes": plan.smem, "ctas": plan.ctas, "elem": plan.elem}}
        runs = {
            "lstm_scan": (lambda: K.lstm_scan(xp, wh[0]),
                          lambda p: K.lstm_scan_persistent(xp, wh[0], False, p),
                          lambda: K.lstm_scan_walk(xp, wh[0]),
                          lambda: K.lstm_scan_plain(xp, wh[0]),
                          lambda: PC.lstm_scan_stale_h(xp, wh[0], False),
                          lambda: PC.lstm_scan_tf32(xp, wh[0], False)),
            "lstm_revmasked": (lambda: K.lstm_revmasked(xp, wh[1], lengths),
                               lambda p: K.lstm_revmasked_persistent(xp, wh[1], lengths, p),
                               lambda: K.lstm_revmasked_walk(xp, wh[1], lengths),
                               lambda: K.lstm_revmasked_plain(xp, wh[1], lengths),
                               lambda: PC.lstm_scan_stale_h(xp, wh[1], True, lengths),
                               lambda: PC.lstm_scan_tf32(xp, wh[1], True, lengths)),
        }
        with torch.inference_mode():
            for name, (kern, on_plan, walk_fn, plain_fn, stale_fn, tf32_fn) in runs.items():
                K.reset_launch_counts()
                got = kern()
                routes = K.route_counts(name)
                again = kern()
                ref = plain_fn()
                torch.cuda.synchronize()
                bitwise = torch.equal(got, again)
                e_plain = _err(got, ref)
                walk = walk_fn()
                e_walk, e_walk_plain = _err(got, walk), _err(walk, ref)
                del got, again, walk
                limit = PC.persistent_limit(ref)
                e_stale, e_tf32 = _err(stale_fn(), ref), _err(tf32_fn(), ref)
                del ref
                bound_ms, bound_by = bounds[name]
                big = R * T > 20000  # the walk and the plain version: fewer visits
                rec[name] = {
                    "routes": routes, "max_abs_err_vs_plain": e_plain, "limit": limit,
                    "max_err_over_limit": e_plain / limit, "max_abs_err_vs_walk": e_walk,
                    "walk_max_abs_err_vs_plain": e_walk_plain,
                    "planted_stale_h_over_limit": e_stale / limit,
                    "tf32_control_over_limit": e_tf32 / limit, "bitwise_repeat": bitwise,
                    "ms": _time_ms(kern), "walk_ms": _time_ms(walk_fn, reps=3 if big else 5,
                                                              warmup=1),
                    "plain_ms": _time_ms(plain_fn, reps=1 if big else 3, warmup=1),
                    "bound_ms": bound_ms, "bound_by": bound_by}
                r = rec[name]
                r["us_per_step"] = r["ms"] * 1e3 / T
                if (H, R) == (HID, 34) or H == FLOW_H:
                    r["s_sweep"] = []
                    for cap in S_SWEEP_SMS:
                        p = K.plan_persistent(R, 0, H, cap, dirs=1, elem=4)
                        if p is not None:
                            r["s_sweep"].append({"sms": cap, "S": p.S, "G": p.G, "U": p.U,
                                                 "chunk": p.chunk, "ctas": p.ctas,
                                                 "ms": _time_ms(lambda p=p: on_plan(p))})
                print(f"[scan routes f32] {what} {name} R={R} T={T} H={H}: plan S={plan.S} "
                      f"G={plan.G} U={plan.U} rows={plan.rows} chunk={plan.chunk} c_in_smem="
                      f"{plan.c_in_smem} smem={plan.smem} B ({plan.ctas} CTAs); routes "
                      f"{routes}; {name}_persistent_f32 {r['ms']:.3f} ms "
                      f"({r['us_per_step']:.2f} us a step), walk {r['walk_ms']:.3f} ms, plain "
                      f"{r['plain_ms']:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
                      f"max|p - plain| {e_plain:.3e} (limit {limit:.1e}), max|p - walk| "
                      f"{e_walk:.3e}, stale h {e_stale:.3e}, one TF32 product {e_tf32:.3e}, "
                      f"max|walk - plain| {e_walk_plain:.3e} (limit {PC.WALK_F32_TOL}); two "
                      f"launches bitwise equal: {bitwise}"
                      + (f"; S sweep {r['s_sweep']}" if "s_sweep" in r else ""))
                if routes != {"persistent": 1, "walk": 0}:
                    fail(f"{what} {name} float32: the routed wrapper took {routes}, expected "
                         "the persistent route once")
                if not e_plain < limit:
                    fail(f"{what} {name} float32: vs plain {e_plain:.3e} >= {limit:.3e}")
                for fault, e in (("a stale h", e_stale), ("one TF32 product", e_tf32)):
                    if not e >= limit:
                        fail(f"{what} {name} float32: {fault} moves the output by {e:.3e}, "
                             f"under the limit {limit:.3e}: the check cannot see it")
                if not bitwise:
                    fail(f"{what} {name} float32: two launches differ")
                if not e_walk_plain < PC.WALK_F32_TOL:
                    fail(f"{what} {name} float32 walk: vs plain {e_walk_plain:.3e} >= "
                         f"{PC.WALK_F32_TOL}")
            rec["pack_ms"] = _time_ms(lambda: K.pack_scan_weights(wh[0], plan))
        rec["nn_lstm_forward_ms"] = _lstm_forward_reference_ms(device, R, T, H, f32, False)
        out.append(rec)
        del xp, wh
    print(f"[scan routes f32] card: {gpu_name_and_power()}")
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
# K2-K7 take their persistent routes in float32 too (K2p-f32 - K7p-f32; K1
# takes K1p-f32, one grid or a launch a direction)
F32_PERSISTENT = ("lstm_scan", "lstm_revmasked", "lstm_train_fwd", "lstm_revmasked_train_fwd",
                  "lstm_train_bwd", "lstm_revmasked_bwd")


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
            route = K.scan_route(dtype, R, H, sms)
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
    save_model(str(ckpt), init_bsrnn(BSRNNConfig(num_channel=N_IN, num_layer=6), seed=0,
                                      device="cpu"),
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


def _validation_pass(cfg, state):
    """One validation pass of a trained ``state`` through the trainer's own
    ``validate`` (after one warm-up pass): host ms around it, ending in a
    sync, and K1-K3's routes over it (the counts set to 0 just before)."""
    import torch
    from urgent2026_challenge_track1_tpu_torch.data.dataset import AudioDataModule
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K
    from urgent2026_challenge_track1_tpu_torch.train.trainer import Trainer

    tr = Trainer(cfg, AudioDataModule(cfg))
    tr.validate(state)
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = tr.validate(state)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return {"ms": ms, "val_loss": metrics["val_loss"],
            "routes": {name: K.route_counts(name) for name in INFERENCE_KERNELS}}


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
        init = init_bsrnn(BSRNNConfig(num_channel=N_IN, num_layer=6), seed=2024, device="cpu")
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
        validation = _validation_pass(_train_config(workdir), state)
        print(f"[training] one float32 validation pass (4 utterances, B=4): "
              f"{validation['ms']:.1f} ms, val_loss {validation['val_loss']:.6g}, K1-K3 routes "
              f"{validation['routes']}")
        _check_routes("the float32 validation pass", "float32", validation["routes"])
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
    return counts, routes, validation


WIDE_CHANNELS = 510  # H = 1020: no float32 K4p/K6p plan fits, so K4 and K6 take their walks
# (K5 and K7 have float32 plans there: S = 128 CTAs of 8 units, G = 1); nor
# does a float32 K1p / K8p plan, so K1 and K8 take theirs too
WIDE_WALKS = ("lstm_train_fwd", "lstm_revmasked_train_fwd")
WIDE_RUN = f"one float32 train step at {WIDE_CHANNELS} channels x 1 layer (B=1, 2 s at 48 kHz)"
WIDE_STREAM_RUN = WIDE_RUN + " under STREAM_INPUT_TRAIN"
WIDE_FUSED_RUN = WIDE_RUN + " under FUSED_BIDIR_TRAIN"
WIDE_FORWARD_RUN = (f"one float32 forward at {WIDE_CHANNELS} channels x 1 layer (B=1, 2 s at "
                    "48 kHz, no lengths)")
# K2 and K3 run on their walks only there (no float32 K2p/K3p plan fits at H = 1020)
WIDE_LENGTHS_RUN = (f"one float32 length-exact forward at {WIDE_CHANNELS} channels x 1 layer "
                    "(B=1, 1.9 s at 48 kHz in a 2 s bucket)")


def phase_walk_route(device):
    """One float32 train step of the discriminative model at a width where
    no float32 K4p/K6p plan fits (WIDE_CHANNELS, H = 1020; 1 layer, B=1,
    2 s at 48 kHz): K4 and K6 take their walks there; K5 and K7 take
    K5p-f32 / K7p-f32 (their float32 plans fit: the backward's slice needs
    no projection buffer), each with the float32 dW kernel; no K1-K3 runs.
    Then the same step under STREAM_INPUT_TRAIN (K8 on its walk: no
    float32 K8p plan fits either) and under FUSED_BIDIR_TRAIN (K9 on its
    walk, no float32 K4p plan; K10 on its one-direction pair: no float32
    dirs = 2 plan fits, K5p-f32's does), one float32 forward of that model
    without lengths (K1 on its walk, band and time paths) and one with
    lengths (the time path's K2 and K3 on their walks: no float32 K2p/K3p
    plan fits either).  Returns the routes of the first step (the counts
    set to 0 just before it), with K8's those of the second step, K9's and
    K10's those of the third, K1's
    those of the forward and K2's and K3's those of the length-exact
    forward (each likewise)."""
    import torch
    from urgent2026_challenge_track1_tpu_torch.models.bsrnn import bsrnn_se_apply
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K
    from urgent2026_challenge_track1_tpu_torch.train import trainer

    cfg = _train_config(Path("."), model_configs={"num_channel": WIDE_CHANNELS, "num_layer": 1})
    bundle = trainer.build_model(cfg)
    model = trainer.init_params(cfg.seed, bundle, device)
    step = trainer.make_train_step(bundle, cfg, 48000)
    H = 2 * WIDE_CHANNELS
    if K.scan_route(torch.float32, 34, H, _sm_count(device)) is not None:
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
    sms = _sm_count(device)
    if (K.streamin_route(torch.float32, 34, WIDE_CHANNELS, H, sms) is not None
            or K.k1_route(torch.float32, 201, WIDE_CHANNELS, H, sms) is not None):
        fail(f"a float32 K8p or K1p plan fits at H = {H}: this phase cannot drive their walks")
    saved = K.STREAM_INPUT_TRAIN
    K.STREAM_INPUT_TRAIN = True
    try:
        K.reset_launch_counts()
        m = step(model, trainer.make_optimizer(cfg, model), *_train_batch(device, B=1))
        torch.cuda.synchronize()
        routes["lstm_train_fwd_streamin"] = K.route_counts("lstm_train_fwd_streamin")
    finally:
        K.STREAM_INPUT_TRAIN = saved
    print(f"[walk route] {WIDE_STREAM_RUN}: loss {float(m['loss']):.6g}, K8 routes "
          f"{routes['lstm_train_fwd_streamin']}")
    if not bool(torch.isfinite(m["loss"])):
        fail("the wide float32 STREAM step gave a non-finite loss")
    r = routes["lstm_train_fwd_streamin"]
    if r["walk"] <= 0 or r["persistent"]:
        fail(f"the wide float32 STREAM step: K8 routes {r}, expected the walk only")
    saved = K.FUSED_BIDIR_TRAIN
    K.FUSED_BIDIR_TRAIN = True
    try:
        K.reset_launch_counts()
        m = step(model, trainer.make_optimizer(cfg, model), *_train_batch(device, B=1))
        torch.cuda.synchronize()
        for name in ("lstm_train_fwd2", "lstm_train_bwd2"):
            routes[name] = K.route_counts(name)
    finally:
        K.FUSED_BIDIR_TRAIN = saved
    print(f"[walk route] {WIDE_FUSED_RUN}: loss {float(m['loss']):.6g}, K9 routes "
          f"{routes['lstm_train_fwd2']}, K10 routes {routes['lstm_train_bwd2']}")
    r9, r10 = routes["lstm_train_fwd2"], routes["lstm_train_bwd2"]
    if (not bool(torch.isfinite(m["loss"])) or r9["walk"] <= 0 or r9["persistent"]
            or r10["persistent_split"] <= 0 or r10["walk"] or r10["persistent"]):
        fail(f"the wide float32 FUSED step: K9 routes {r9} (expected the walk only), K10 "
             f"routes {r10} (expected its one-direction pair only), or a non-finite loss")
    model.eval()
    with torch.inference_mode():
        K.reset_launch_counts()
        wav = 0.1 * torch.randn((1, 2 * 48000), device=device)
        out = bsrnn_se_apply(model, bundle.stft_cfg, wav, 48000)[0]
        torch.cuda.synchronize()
        routes["fusedin_bilstm"] = K.route_counts()
    print(f"[walk route] {WIDE_FORWARD_RUN}: K1 routes {routes['fusedin_bilstm']}")
    r = routes["fusedin_bilstm"]
    if not bool(torch.isfinite(out).all()) or r["walk"] <= 0 or sum(r.values()) != r["walk"]:
        fail(f"the wide float32 forward: K1 routes {r} (expected the walk only) or a "
             "non-finite output")
    if K.scan_route(torch.float32, 34, H, sms) is not None:
        fail(f"a float32 K2p/K3p plan fits at H = {H}: this phase cannot drive their walks")
    with torch.inference_mode():
        K.reset_launch_counts()
        lengths = torch.tensor([int(1.9 * 48000)], device=device)
        out = bsrnn_se_apply(model, bundle.stft_cfg, wav, 48000, lengths)[0]
        torch.cuda.synchronize()
        for name in ("lstm_scan", "lstm_revmasked"):
            routes[name] = K.route_counts(name)
    print(f"[walk route] {WIDE_LENGTHS_RUN}: K2 routes {routes['lstm_scan']}, K3 routes "
          f"{routes['lstm_revmasked']}")
    for name in ("lstm_scan", "lstm_revmasked"):
        r = routes[name]
        if not bool(torch.isfinite(out).all()) or r["walk"] <= 0 or r["persistent"]:
            fail(f"the wide float32 length-exact forward: {name} routes {r} (expected the "
                 "walk only) or a non-finite output")
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
    cpu_model = init_bsrnn(BSRNNConfig(num_channel=N_IN, num_layer=6), seed=1, device="cpu")
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
    cpu_model = init_bsrnn(BSRNNConfig(num_channel=N_IN, num_layer=6), seed=6, device="cpu")
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


def _bounds(R, T, lengths_sum, n_in=N_IN, hid=HID, dtype="bfloat16"):
    """Least time (ms) for each kernel's work at one shape (each input byte
    read once, each output byte written once, the recurrent and input
    products as operations); K3 counts only the valid steps its outputs
    need.  bfloat16: 2-byte elements at PEAK_BF16_FLOPS; float32: 4-byte
    elements at PEAK_TF32_FLOPS, as ``_train_bounds``."""
    N, H, b = n_in, hid, (2 if dtype == "bfloat16" else 4)
    peak = PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_TF32_FLOPS
    return {
        "fusedin_bilstm": _bound(2 * 2 * R * (N + H) * 4 * H * T,
                                 b * (R * T * N + 2 * (N + H) * 4 * H + 2 * 4 * H
                                      + R * T * 2 * H), peak),
        "lstm_scan": _bound(2 * R * H * 4 * H * T,
                            b * (R * T * 4 * H + H * 4 * H + R * T * H), peak),
        "lstm_revmasked": _bound(2 * H * 4 * H * lengths_sum,
                                 b * (lengths_sum * 4 * H + H * 4 * H + lengths_sum * H)
                                 + 4 * R, peak),
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
    """{kernel: {route: launches}} of the routed kernels (K1-K8, K10) since the
    last reset."""
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K

    return {fn.__name__: K.route_counts(fn.__name__) for fn in K.ROUTED}


def _check_routes(what, dtype_name, routes, kernels=INFERENCE_KERNELS):
    """Each of ``kernels`` ran, on its persistent route only (K1p-K7p) in
    bfloat16; in float32 K1 on K1p-f32 (one grid, or a launch a direction
    at the flow width) and K2-K7 on K2p-f32 - K7p-f32."""
    for name in kernels:
        if dtype_name == "bfloat16" or name in F32_PERSISTENT:
            want = ("persistent",)
        else:  # K1 in float32
            want = ("persistent", "persistent_split")
        r = routes[name]
        if sum(r[w] for w in want) <= 0 or sum(r.values()) != sum(r[w] for w in want):
            fail(f"{what}: {name} routes {r}, expected {' or '.join(want)} only")


def _check_dw_launches(what, routes):
    """The dW kernel ran once inside each K5p and K7p launch, twice inside
    each K10p launch (once a direction), and nowhere else; returns its
    count since the last reset."""
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K

    want = (sum(routes[name]["persistent"] for name in ("lstm_train_bwd", "lstm_revmasked_bwd"))
            + 2 * routes["lstm_train_bwd2"]["persistent"])
    if K.lstm_bwd_dw.launches != want:
        fail(f"{what}: the dW kernel ran {K.lstm_bwd_dw.launches} times, K5p + K7p + 2 K10p "
             f"{want}")
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
            # the walks run where no float32 plan fits (K1p-f32, K2p-f32 and
            # K3p-f32 take every float32 shape with a plan): the wide model's
            # forwards, K1's without lengths, K2's and K3's with them
            if name == "fusedin_bilstm":
                launches, run = wide_routes[name]["walk"], WIDE_FORWARD_RUN + " (the walk)"
            else:
                launches, run = wide_routes[name]["walk"], WIDE_LENGTHS_RUN + " (the walk)"
            rec = {
                "name": name, "route": "cuda",
                "source": f"{PKG}/csrc/lstm_kernels.cu",
                "replaces": REPLACES[name],
                "launches": launches, "launches_run": run,
                "max_abs_err": errs[name, "bfloat16"],
                "max_abs_err_f32": errs[name, "float32"],
                "tolerance": BF16_TOL, "tolerance_f32": PC.WALK_F32_TOL,
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
                "source": f"{PKG}/csrc/lstm_persistent_bwd.cu", "replaces": REPLACES[name],
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
            "source": f"{PKG}/csrc/lstm_persistent_bwd.cu",
            "replaces": REPLACES["lstm_train_bwd"],
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
    from urgent2026_challenge_track1_tpu_torch.ops import persistent_checks as PC

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
                    "tolerance_f32": GRAD_TOL if name.endswith("bwd") else PC.WALK_F32_TOL,
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
    """The walks of K8-K10 against their plain versions at the
    discriminative band path (R = 804, T = 34, N = 196, H = 392), float32
    and bfloat16, and K8's walk at H = 1020 in float32 (N = 510, the wide
    step's band path R = 201, T = 34), the one width where it is still the
    route (no float32 K8p plan fits): max abs error of the forward outputs,
    max relative error of the backward's (each on the plain forward's
    residuals).  K9's walk route is K4's walk once a direction, counted as
    K9 (its H = 1020 route: phase_walk_route); K10's walk must equal K5's
    walk run per direction bit for bit (its device code).  No shipped shape
    launches the K10 walk, and the K8 and K9 walks only at H = 1020; the
    card tests hold them at the other widths.  K8p, K9p and K10p against
    plain: phase_streamin_bwd2_routes.  Returns {(kernel, dtype): (abs
    error, relative error or None)}."""
    import torch
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K
    from urgent2026_challenge_track1_tpu_torch.ops import persistent_checks as PC

    errs, note = _error_table()
    sms = _sm_count(device)
    cases = (("float32", torch.float32, N_IN, HID, TRAIN_BAND),
             ("bfloat16", torch.bfloat16, N_IN, HID, TRAIN_BAND),
             ("float32", torch.float32, WIDE_CHANNELS, 2 * WIDE_CHANNELS, (201, 34)))
    for dt_name, dtype, n_in, hid, (R, T) in cases:
        wide = hid == 2 * WIDE_CHANNELS
        x, w_ih_t, w_hh_t, bias, xp, _ = _kernel_inputs(R, T, dtype, device, R + 3 * T,
                                                        n_in, hid)
        if wide and K.streamin_route(dtype, R, n_in, hid, sms) is not None:
            fail(f"a float32 K8p plan fits at H = {hid}: its walk is no route there")
        for reverse in (False, True):
            got = K.lstm_train_fwd_streamin_walk(x, w_ih_t[0], bias[0], w_hh_t[0], reverse)
            ref = K.lstm_train_fwd_streamin_plain(x, w_ih_t[0], bias[0], w_hh_t[0], reverse)
            torch.cuda.synchronize()
            note(NEW_KERNELS[0], dt_name, max(_err(g, r) for g, r in zip(got, ref)))
        if wide:
            del x, w_ih_t, w_hh_t, bias, xp, got, ref
            continue
        gen = torch.Generator().manual_seed(R * 3 + T)
        xp_b = (0.3 * torch.randn((R, T, 4 * hid), generator=gen)).to(device, dtype)
        dout = torch.randn((2, R, T, hid), generator=gen).to(device, dtype)
        got = (*K.lstm_train_fwd_walk(xp, w_hh_t[0], False, fn=K.lstm_train_fwd2),
               *K.lstm_train_fwd_walk(xp_b, w_hh_t[1], True, fn=K.lstm_train_fwd2))
        ref = K.lstm_train_fwd2_plain(xp, xp_b, w_hh_t[0], w_hh_t[1])
        torch.cuda.synchronize()
        note(NEW_KERNELS[1], dt_name, max(_err(g, r) for g, r in zip(got, ref)))
        got = K.lstm_train_bwd2_walk(ref[:3], ref[3:], dout[0], dout[1], w_hh_t[0], w_hh_t[1])
        want = K.lstm_train_bwd2_plain(ref[:3], ref[3:], dout[0], dout[1], w_hh_t[0],
                                       w_hh_t[1])
        # K5's walk: K10's device code (K5 itself takes K5p)
        single = (*K.lstm_train_bwd_walk(*ref[:3], dout[0], w_hh_t[0], False),
                  *K.lstm_train_bwd_walk(*ref[3:], dout[1], w_hh_t[1], True))
        torch.cuda.synchronize()
        note(NEW_KERNELS[2], dt_name, max(_err(g, r) for g, r in zip(got, want)),
             max(_rel(g, r) for g, r in zip(got, want)))
        if not all(torch.equal(a, b) for a, b in zip(got, single)):
            fail(f"lstm_train_bwd2 {dt_name} R={R} T={T}: not bitwise the K5 walk per "
                 "direction")
        print(f"[new kernels] {dt_name} R={R} T={T} N={n_in} H={hid}: K10's walk == K5 walk x 2 "
              "bit for bit")
        del x, w_ih_t, w_hh_t, bias, xp, xp_b, dout, ref, got, want, single
    for (name, dt_name), (e_abs, e_rel) in sorted(errs.items()):
        backward = name.endswith("bwd2")
        tol = BF16_TOL if dt_name == "bfloat16" else (GRAD_TOL if backward else PC.WALK_F32_TOL)
        e = e_rel if backward else e_abs
        kind = "max rel|d| (dx_proj, dW)" if backward else "max|d| (h, gates, c)"
        print(f"[new kernels] {name} {dt_name}: {kind}={e:.3e} (tolerance {tol}), "
              f"max|d|={e_abs:.3e}")
        if not e < tol:
            fail(f"{name} {dt_name}: kernel vs plain {e:.3e} >= {tol}")
    return errs


# ---------------------------------------------------------------------------
# K8p and K10p, the persistent routes of K8 and K10 (phase 2)
# ---------------------------------------------------------------------------

BENCH_N, BENCH_H = 192, 384  # the JAX bench's width (bench.py: 192 channels)
# (what, R, T, N, H): K8 on the time paths of both training steps (both
# directions: the masked time path walks the length-reversed input forward,
# the band layer both ways), on the disc band path (the one plan here whose
# groups walk several chunks a step, with c in global memory) and at the
# bench width
K8P_SHAPES = (("disc time B=4", *TRAIN_TIME, N_IN, HID),
              ("disc band B=4", *TRAIN_BAND, N_IN, HID),
              ("flow time B=2", *FLOW_TIME, FLOW_N, FLOW_H),
              ("bench width", *TRAIN_TIME, BENCH_N, BENCH_H))
# and K8p-f32 (float32) there, at the flow band path (502 x 48, where the
# flow family's STREAM arm also runs K8) and at odd N and H (x staged in 4-,
# 8- and 16-byte copies)
K8P_F32_SHAPES = K8P_SHAPES + (("flow band B=2", *FLOW_BAND, FLOW_N, FLOW_H),
                               ("odd N and H", 13, 7, 37, 46),
                               ("N = 2 mod 4", 21, 5, 38, 20))
# (what, R, T, H): K9 and K10 on the band paths, where FUSED_BIDIR_TRAIN
# runs them
K10P_SHAPES = (("disc band B=4", *TRAIN_BAND, HID),
               ("flow band B=2", *FLOW_BAND, FLOW_H),
               ("bench width", *TRAIN_BAND, BENCH_H))
K9P_SHAPES = K10P_SHAPES
K10P_DIRS = ("forward", "reverse")


def _k9p_rows(device, sms):
    """K9p (bfloat16 and float32) through the routed K9 at K9P_SHAPES: the
    rule takes ``scan_route``'s plan and launches K4p twice (counted in K9's
    persistent route, none in K4's); the pair equals two K4p launches on
    that plan bit for bit, two calls are bitwise equal, and each
    direction's h, gates and c are within 4 bf16 ulps at max|plain|
    (F32_LIMIT in float32), which the stale-h fault with the residuals
    (``persistent_checks.lstm_scan_stale_h``) and, in float32, one TF32
    product (``lstm_scan_tf32``) must exceed.  Times: K9p, K9's walk route
    (K4's walk once a direction, the route where no plan fits), the plain
    version, the bidirectional torch.nn.LSTM training forward (a superset),
    and the bound (twice K4's)."""
    import torch
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K
    from urgent2026_challenge_track1_tpu_torch.ops import persistent_checks as PC

    rows = []
    for what, R, T, H in K9P_SHAPES:
        for dt_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            f32 = dtype == torch.float32
            label = "K9p-f32" if f32 else "K9p"
            _, _, wh, _, xp, _ = _kernel_inputs(R, T, dtype, device, R + 11 * T + H, hid=H)
            gen = torch.Generator().manual_seed(R + 2 * T)
            xp_b = (0.3 * torch.randn((R, T, 4 * H), generator=gen)).to(device, dtype)
            args = (xp, xp_b, wh[0], wh[1])
            plan = K.scan_route(dtype, R, H, sms)
            if plan is None:
                fail(f"{label} at {what}: K4p has no plan")
            K.reset_launch_counts()
            got = K.lstm_train_fwd2(*args)
            routes, k4 = K.route_counts("lstm_train_fwd2"), K.lstm_train_fwd.launches
            again = K.lstm_train_fwd2(*args)
            pair = (*K.lstm_train_fwd_persistent(xp, wh[0], False, plan),
                    *K.lstm_train_fwd_persistent(xp_b, wh[1], True, plan))
            ref = K.lstm_train_fwd2_plain(*args)
            torch.cuda.synchronize()
            bitwise = all(torch.equal(u, v) for u, v in zip(got, again))
            equals_k4p = all(torch.equal(u, v) for u, v in zip(got, pair))
            del again, pair
            rec = {"what": what, "R": R, "T": T, "H": H, "dtype": dt_name, "routes": routes,
                   "plan": {"S": plan.S, "G": plan.G, "U": plan.U, "rows": plan.rows,
                            "chunk": plan.chunk, "c_in_smem": plan.c_in_smem,
                            "smem_bytes": plan.smem, "ctas": plan.ctas},
                   "bitwise_repeat": bitwise, "equals_k4p_per_direction": equals_k4p}
            for d, (x, w, rev) in enumerate(((xp, wh[0], False), (xp_b, wh[1], True))):
                mine, plain = got[3 * d:3 * d + 3], ref[3 * d:3 * d + 3]
                limits = [PC.persistent_limit(r) for r in plain]
                e_plain = [_err(g, r) for g, r in zip(mine, plain)]
                e_stale = [_err(f, r) for f, r in zip(PC.lstm_scan_stale_h(x, w, rev,
                                                                          residuals=True), plain)]
                e_tf32 = ([_err(f, r) for f, r in zip(PC.lstm_scan_tf32(x, w, rev,
                                                                        residuals=True), plain)]
                          if f32 else None)
                rec[K10P_DIRS[d]] = {
                    "max_abs_err_vs_plain": dict(zip(RESIDUALS, e_plain)),
                    "limit": dict(zip(RESIDUALS, limits)),
                    "max_err_over_limit": max(e / lim for e, lim in zip(e_plain, limits)),
                    "planted_stale_h_over_limit": min(e / lim for e, lim in zip(e_stale, limits)),
                    "tf32_control_over_limit": (min(e / lim for e, lim in zip(e_tf32, limits))
                                                if f32 else None)}
                print(f"[k9p] {dt_name} {what} {K10P_DIRS[d]} R={R} T={T} H={H}: max|p - plain| "
                      f"h, gates, c {[f'{e:.3e}' for e in e_plain]} (limits "
                      f"{[f'{lim:.3e}' for lim in limits]}); planted stale h "
                      f"{[f'{e:.3e}' for e in e_stale]}; one TF32 product "
                      f"{[f'{e:.3e}' for e in e_tf32] if f32 else 'n/a'}")
                for name, e, f, lim in zip(RESIDUALS, e_plain, e_stale, limits):
                    if not e < lim <= f:
                        fail(f"{label} {what} {K10P_DIRS[d]}: {name} vs plain {e:.3e}, stale h "
                             f"{f:.3e}, limit {lim:.3e}")
                for name, e, lim in zip(RESIDUALS, e_tf32 or (), limits):
                    if not e >= lim:
                        fail(f"{label} {what} {K10P_DIRS[d]}: one TF32 product moves {name} by "
                             f"{e:.3e}, under the limit {lim:.3e}")
            del got, ref
            if routes != {"persistent": 2, "walk": 0} or k4:
                fail(f"{label} {what}: the routed K9 took {routes} and {k4} K4 launches, "
                     "expected K4p twice in K9's count")
            if not (bitwise and equals_k4p):
                fail(f"{label} {what}: two calls differ ({not bitwise}) or the pair is not two "
                     f"K4p launches bit for bit ({not equals_k4p})")
            bound_ms, bound_by = _new_kernel_bounds(R, T, H // 2, H, dt_name)["lstm_train_fwd2"]
            slow = f32 and H == FLOW_H
            with torch.no_grad():
                rec.update({
                    "ms": _time_ms(lambda: K.lstm_train_fwd2(*args)),
                    "walk_ms": _time_ms(lambda: [K.lstm_train_fwd_walk(x, w, rev, fn=K.lstm_train_fwd2)
                                                 for x, w, rev in ((xp, wh[0], False),
                                                                   (xp_b, wh[1], True))],
                                        reps=3, warmup=1),
                    "plain_ms": _time_ms(lambda: K.lstm_train_fwd2_plain(*args), reps=1,
                                         warmup=0 if slow else 1),
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": _bilstm_reference_ms(device, R, T, H, dtype, False)})
            print(f"[k9p] {dt_name} {what} R={R} T={T} H={H}: plan S={plan.S} G={plan.G} "
                  f"U={plan.U} rows={plan.rows} chunk={plan.chunk} ({plan.ctas} CTAs); routes "
                  f"{routes}; {label} {rec['ms']:.3f} ms, walk {rec['walk_ms']:.3f} ms, plain "
                  f"{rec['plain_ms']:.3f} ms, nn.LSTM bidirectional training forward "
                  f"{rec['library_ms']:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}); two calls "
                  f"bitwise equal: {bitwise}; equal to K4p x 2: {equals_k4p}")
            rows.append(rec)
            del xp, xp_b, wh, args
    return rows


def phase_streamin_bwd2_routes(device):
    """K8p (bfloat16 and float32), K9p and K10p (bfloat16 and float32, K10
    also as its one-direction pair) against their plain versions at every
    step, each through its routed wrapper (its route rule must take the
    persistent route and count its launches there):

    K8p at K8P_SHAPES and K8p-f32 at K8P_F32_SHAPES, both directions: h,
    gates and c each within 4 bf16 ulps at max|plain|
    (``persistent_checks.ulp_limit``; F32_LIMIT in float32), which the
    planted fault (``persistent_checks.lstm_train_fwd_streamin_stale_h``,
    the plain walk fed h one step stale) and, in float32, the walk with one
    TF32 product each (``lstm_train_fwd_streamin_tf32``) must exceed; two
    launches bitwise equal; its plan checked against the kernel's byte
    count, and in each dtype one plan walks several chunks a group.  Times
    (forward walk): K8p, the walk, the plain version, a one-direction
    torch.nn.LSTM training forward in the same dtype (K8's function, N = H
    / 2; TF32 off) and what the default arm runs for the same function, the
    hoisted addmm and K4p (K4p-f32); the bound (float32 at
    PEAK_TF32_FLOPS).

    K10p at K10P_SHAPES on the plain training forward's residuals of both
    directions: dx_proj of each direction within ``persistent_checks.bwd_limit``
    (4 bf16 ulps; F32_BWD_LIMIT of max|plain| in float32), which the
    stale-dgates fault (``persistent_checks.lstm_train_bwd_stale_dg``) and,
    in float32, the backward with one TF32 product
    (``persistent_checks.lstm_train_bwd_tf32``) must exceed; the dW kernel
    on each direction's dx_proj within DW_BOUND (``DW_F32_BOUND``, which the
    product of TF32-rounded operands must exceed) |h_prev|^T |dx_proj| of
    the float64 product, the routed dW its rounding and within BF16_TOL
    (F32_BWD_LIMIT) of the plain dW; two launches bitwise equal; equal bit
    for bit to K5p launched per direction with K10p's plan.  A shape and
    dtype without a dirs = 2 plan (float32 at the flow band) must take the
    one-direction pair on ``backward_route``'s plan (two launches in
    ``route_counts(...)["persistent_split"]``), held the same way and equal
    to two K5p launches on that plan.  Times: K10p or the pair (with the dW
    kernel, ``lstm_bwd_dw``, once a direction), the walk, two K5p launches
    on K5p's own plans (what the default arm runs), the plain version, the
    bidirectional torch.nn.LSTM backward (a superset); the bound, twice
    K5's; where the planner moved dc to global memory for fewer K tiles,
    K10p at the plan that keeps dc in shared memory.

    K9p at K9P_SHAPES: ``_k9p_rows``.
    Returns {"k8p": [...], "k8p_f32": [...], "k9p": [...], "k10p": [...]}."""
    import dataclasses

    import torch
    from urgent2026_challenge_track1_tpu_torch.ops import _build
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K
    from urgent2026_challenge_track1_tpu_torch.ops import persistent_checks as PC

    sms = _sm_count(device)
    lib = _build.load_library()
    bf16 = torch.bfloat16
    out = {"k8p": [], "k8p_f32": [], "k9p": _k9p_rows(device, sms), "k10p": []}
    for dt_name, dtype, shapes in (("bfloat16", bf16, K8P_SHAPES),
                                   ("float32", torch.float32, K8P_F32_SHAPES)):
        f32 = dtype == torch.float32
        label, elem = ("K8p-f32", 4) if f32 else ("K8p", 2)
        for what, R, T, N, H in shapes:
            x, wi, wh, b, _, _ = _kernel_inputs(R, T, dtype, device, R + 5 * T + H, N, H)
            plan = K.plan_persistent(R, N, H, sms, dirs=1, elem=elem)
            if plan is None or K.streamin_route(dtype, R, N, H, sms) != plan:
                fail(f"{label}: no plan, or the rule does not take it, at {what} (R={R}, N={N}, "
                     f"H={H})")
            kernel_smem = lib.lstm_persistent_smem(N, H, plan.U, plan.rows, plan.chunk,
                                                    int(plan.c_in_smem), elem)
            if kernel_smem != plan.smem:
                fail(f"{label} plan at {what}: {plan.smem} bytes, the kernel reckons "
                     f"{kernel_smem}")
            rec = {"what": what, "R": R, "T": T, "N": N, "H": H, "dtype": dt_name,
                   "plan": {"S": plan.S, "G": plan.G, "U": plan.U, "rows": plan.rows,
                            "chunk": plan.chunk, "chunks_per_group": -(-plan.rows // plan.chunk),
                            "c_in_smem": plan.c_in_smem, "smem_bytes": plan.smem,
                            "ctas": plan.ctas}}
            for reverse in (False, True):
                K.reset_launch_counts()
                got = K.lstm_train_fwd_streamin(x, wi[0], b[0], wh[0], reverse)
                routes = K.route_counts("lstm_train_fwd_streamin")
                again = K.lstm_train_fwd_streamin(x, wi[0], b[0], wh[0], reverse)
                ref = K.lstm_train_fwd_streamin_plain(x, wi[0], b[0], wh[0], reverse)
                stale = PC.lstm_train_fwd_streamin_stale_h(x, wi[0], b[0], wh[0], reverse)
                torch.cuda.synchronize()
                limits = [PC.persistent_limit(r) for r in ref]
                e_plain = [_err(g, r) for g, r in zip(got, ref)]
                e_stale = [_err(f, r) for f, r in zip(stale, ref)]
                bitwise = all(torch.equal(u, v) for u, v in zip(got, again))
                del got, again, stale
                e_tf32 = ([_err(o, r) for o, r in zip(
                    PC.lstm_train_fwd_streamin_tf32(x, wi[0], b[0], wh[0], reverse), ref)]
                          if f32 else None)
                del ref
                tag = "reverse" if reverse else "forward"
                rec[tag] = {"routes": routes,
                            "max_abs_err_vs_plain": dict(zip(RESIDUALS, e_plain)),
                            "limit": dict(zip(RESIDUALS, limits)),
                            "max_err_over_limit": max(e / lim for e, lim in zip(e_plain, limits)),
                            "planted_stale_h_over_limit": min(
                                e / lim for e, lim in zip(e_stale, limits)),
                            "tf32_control_over_limit": (min(e / lim for e, lim in
                                                            zip(e_tf32, limits))
                                                        if f32 else None),
                            "bitwise_repeat": bitwise}
                print(f"[{label.lower()}] {what} {tag} R={R} T={T} N={N} H={H}: plan S={plan.S} "
                      f"G={plan.G} U={plan.U} rows={plan.rows} chunk={plan.chunk} c_in_smem="
                      f"{plan.c_in_smem} smem={plan.smem} B ({plan.ctas} CTAs); routes {routes}; "
                      f"max|p - plain| h, gates, c {[f'{e:.3e}' for e in e_plain]} (limits "
                      f"{[f'{lim:.3e}' for lim in limits]}); planted stale h "
                      f"{[f'{e:.3e}' for e in e_stale]}; one TF32 product "
                      f"{[f'{e:.3e}' for e in e_tf32] if f32 else 'n/a'}; two launches bitwise "
                      f"equal: {bitwise}")
                if routes != {"persistent": 1, "walk": 0}:
                    fail(f"{label} {what} {tag}: the routed K8 took {routes}, expected {label} "
                         "once")
                for name, e, f, lim in zip(RESIDUALS, e_plain, e_stale, limits):
                    if not e < lim:
                        fail(f"{label} {what} {tag}: {name} vs plain {e:.3e} >= {lim:.3e}")
                    if not f >= lim:
                        fail(f"{label} {what} {tag}: a stale h moves {name} by {f:.3e}, under "
                             f"the limit {lim:.3e}: the check cannot see a barrier fault")
                for name, e, lim in zip(RESIDUALS, e_tf32 or (), limits):
                    if not e >= lim:
                        fail(f"{label} {what} {tag}: one TF32 product moves {name} by {e:.3e}, "
                             f"under the limit {lim:.3e}")
                if not bitwise:
                    fail(f"{label} {what} {tag}: two launches differ")
            x2 = x.reshape(-1, N)
            bound_ms, bound_by = _new_kernel_bounds(R, T, N, H, dt_name)["lstm_train_fwd_streamin"]
            slow = f32 and H == FLOW_H  # the float32 walk and plain version at the flow width
            with torch.no_grad():
                rec.update({
                    "ms": _time_ms(lambda: K.lstm_train_fwd_streamin(x, wi[0], b[0], wh[0])),
                    "walk_ms": _time_ms(
                        lambda: K.lstm_train_fwd_streamin_walk(x, wi[0], b[0], wh[0]),
                        reps=1 if slow else 3, warmup=1),
                    "plain_ms": _time_ms(lambda: K.lstm_train_fwd_streamin_plain(
                        x, wi[0], b[0], wh[0]), reps=1, warmup=0 if slow else 1),
                    "k4p_addmm_ms": _time_ms(lambda: K.lstm_train_fwd(
                        torch.addmm(b[0], x2, wi[0]).reshape(R, T, 4 * H), wh[0])),
                    "bound_ms": bound_ms, "bound_by": bound_by})
            rec["library_ms"] = (_lstm_forward_reference_ms(device, R, T, H, dtype, True)
                                 if 2 * N == H else None)
            print(f"[{label.lower()}] {what} R={R} T={T} N={N} H={H} {dt_name}: {label} "
                  f"{rec['ms']:.3f} ms, walk {rec['walk_ms']:.3f} ms, plain "
                  f"{rec['plain_ms']:.3f} ms, addmm + K4p{'-f32' if f32 else ''} "
                  f"{rec['k4p_addmm_ms']:.3f} ms, nn.LSTM training forward {rec['library_ms']} "
                  f"ms, bound {bound_ms:.4f} ms ({bound_by})")
            out["k8p_f32" if f32 else "k8p"].append(rec)
            del x, wi, wh, b, x2
        if not any(r["plan"]["chunks_per_group"] > 1 for r in out["k8p_f32" if f32 else "k8p"]):
            fail(f"{label}: no shape's plan walks more than one chunk a group, so the residual "
                 "stores of a group's earlier chunks went unchecked")
    for what, R, T, H in K10P_SHAPES:
        for dt_name, dtype in (("bfloat16", bf16), ("float32", torch.float32)):
            f32 = dtype == torch.float32
            elem = 4 if f32 else 2
            dw_bound, dw_tol = ((PC.DW_F32_BOUND, PC.F32_BWD_LIMIT) if f32
                                else (DW_BOUND, BF16_TOL))
            _, _, wh, _, xp, _ = _kernel_inputs(R, T, dtype, device, R + 7 * T + H, hid=H)
            gen = torch.Generator().manual_seed(R + T)
            xp_b = (0.3 * torch.randn((R, T, 4 * H), generator=gen)).to(device, dtype)
            dout = (0.1 * torch.randn((2, R, T, H), generator=gen)).to(device, dtype)
            res = K.lstm_train_fwd2_plain(xp, xp_b, wh[0], wh[1])
            del xp, xp_b
            plan = K.backward2_route(dtype, R, H, sms)
            split = K.plan_backward(R, H, sms, elem=elem, dirs=2) is None
            label = "K10 pair" if split else "K10p"
            route = "walk" if plan is None else "persistent_split" if split else "persistent"
            rec = {"what": what, "R": R, "T": T, "H": H, "dtype": dt_name, "route": route}
            args = (res[:3], res[3:], dout[0], dout[1], wh[0], wh[1])
            if plan is None:
                K.reset_launch_counts()
                K.lstm_train_bwd2(*args)
                routes = K.route_counts("lstm_train_bwd2")
                rec.update({"plan": None, "routes": routes})
                print(f"[k10p] {dt_name} {what} R={R} T={T} H={H}: no plan on {sms} SMs; the "
                      f"routed K10 took {routes}")
                if routes != {"persistent": 0, "walk": 1, "persistent_split": 0}:
                    fail(f"K10 {dt_name} {what}: without a plan the rule must take the walk")
                out["k10p"].append(rec)
                del res, dout, wh, args
                continue
            kernel_smem = lib.lstm_persistent_bwd_smem(H, plan.U, plan.rows, plan.chunk, plan.kt,
                                                        int(plan.dc_in_smem), elem)
            if kernel_smem != plan.smem or (split and plan != K.backward_route(dtype, R, H, sms)):
                fail(f"{label} {dt_name} plan at {what}: {plan.smem} bytes, the kernel reckons "
                     f"{kernel_smem}; a pair must take backward_route's plan")
            K.reset_launch_counts()
            got = K.lstm_train_bwd2(*args)
            routes, dw_launches = K.route_counts("lstm_train_bwd2"), K.lstm_bwd_dw.launches
            again = K.lstm_train_bwd2(*args)
            ref = K.lstm_train_bwd2_plain(*args)
            single = (*K.lstm_train_bwd_persistent(*res[:3], dout[0], wh[0], False, plan),
                      *K.lstm_train_bwd_persistent(*res[3:], dout[1], wh[1], True, plan))
            torch.cuda.synchronize()
            bitwise = all(torch.equal(u, v) for u, v in zip(got, again))
            equals_k5p = all(torch.equal(u, v) for u, v in zip(got, single))
            del single, again
            rec.update({"plan": {"S": plan.S, "G": plan.G, "U": plan.U, "rows": plan.rows,
                                 "chunk": plan.chunk, "kt": plan.kt, "ntiles": plan.ntiles,
                                 "dc_in_smem": plan.dc_in_smem, "smem_bytes": plan.smem,
                                 "ctas": plan.ctas, "dw_split": plan.dw_split},
                        "routes": routes, "dw_launches": dw_launches,
                        "bitwise_repeat": bitwise, "equals_k5p_per_direction": equals_k5p})
            for d, rev in enumerate((False, True)):
                r3, do, w = res[3 * d:3 * d + 3], dout[d], wh[d]
                dxp_k, dw_k, dxp_r, dw_r = got[2 * d], got[2 * d + 1], ref[2 * d], ref[2 * d + 1]
                limit = PC.bwd_limit(dxp_r)
                e_dxp = _err(dxp_k, dxp_r)
                e_stale = _err(PC.lstm_train_bwd_stale_dg(*r3, do, w, rev)[0], dxp_r)
                e_tf32 = _err(PC.lstm_train_bwd_tf32(*r3, do, w, rev)[0], dxp_r) if f32 else None
                dw32 = K.lstm_bwd_dw(r3[0], dxp_k, rev, None, plan.dw_split)
                dw_ratio, dw_abs, _ = _dw_check(K, r3[0], dxp_k, dw32, rev)
                ctrl = (_dw_check(K, r3[0], dxp_k, _dw_tf32_control(K, PC, r3[0], dxp_k, rev),
                                  rev)[0] if f32 else None)
                dw_rounded = torch.equal(dw_k, dw32.to(dw_k.dtype))
                e_dw = _rel(dw_k, dw_r)
                tag = K10P_DIRS[d]
                rec[tag] = {"max_abs_err_vs_plain": e_dxp, "limit": limit,
                            "max_err_over_limit": e_dxp / limit,
                            "planted_stale_dg_over_limit": e_stale / limit,
                            "tf32_control_over_limit": e_tf32 / limit if f32 else None,
                            "dw_bound_ratio": dw_ratio, "dw_max_abs_err_vs_f64": dw_abs,
                            "dw_tf32_control_ratio": ctrl, "dw_rel_err_vs_plain": e_dw,
                            "dw_is_its_rounding": dw_rounded}
                print(f"[k10p] {label} {dt_name} {what} {tag} R={R} T={T} H={H}: max|dxp - plain| "
                      f"{e_dxp:.3e} (limit {limit:.3e}); planted stale dg {e_stale:.3e}; one "
                      f"TF32 product {'n/a' if e_tf32 is None else f'{e_tf32:.3e}'}; dW |d| / "
                      f"(|h|^T|dxp|) {dw_ratio:.3e} (limit {dw_bound}), TF32 operands "
                      f"{'n/a' if ctrl is None else f'{ctrl:.3e}'}; rel vs plain {e_dw:.3e} "
                      f"(limit {dw_tol}), its rounding: {dw_rounded}")
                if not e_dxp < limit:
                    fail(f"{label} {dt_name} {what} {tag}: dx_proj vs plain {e_dxp:.3e} >= "
                         f"{limit:.3e}")
                if not e_stale >= limit:
                    fail(f"{label} {dt_name} {what} {tag}: stale dgates move dx_proj by "
                         f"{e_stale:.3e}, under the limit {limit:.3e}")
                if f32 and not e_tf32 >= limit:
                    fail(f"{label} {dt_name} {what} {tag}: one TF32 product moves dx_proj by "
                         f"{e_tf32:.3e}, under the limit {limit:.3e}")
                if not dw_ratio <= dw_bound:
                    fail(f"{label} {dt_name} {what} {tag}: dW off its float64 product by "
                         f"{dw_ratio:.3e} of |h_prev|^T |dx_proj| > {dw_bound}")
                if f32 and not ctrl > dw_bound:
                    fail(f"{label} {dt_name} {what} {tag}: the dW of TF32-rounded operands is "
                         f"within {ctrl:.3e} <= {dw_bound}")
                if not (dw_rounded and e_dw < dw_tol):
                    fail(f"{label} {dt_name} {what} {tag}: the routed dW is not the dW kernel's "
                         f"rounding or is {e_dw:.3e} from plain (limit {dw_tol})")
            dxp = (got[0], got[2])
            del got, ref
            bound_ms = 2 * _train_bounds(R, T, R * T, H, dt_name)["lstm_train_bwd"][0]
            bound_by = _train_bounds(R, T, R * T, H, dt_name)["lstm_train_bwd"][1]
            rec.update({
                "ms": _time_ms(lambda: K.lstm_train_bwd2(*args)),
                "walk_ms": _time_ms(lambda: K.lstm_train_bwd2_walk(*args), reps=3, warmup=1),
                "k5p_pair_ms": _time_ms(lambda: (
                    K.lstm_train_bwd(*res[:3], dout[0], wh[0], False),
                    K.lstm_train_bwd(*res[3:], dout[1], wh[1], True))),
                "plain_ms": _time_ms(lambda: K.lstm_train_bwd2_plain(*args), reps=1, warmup=1),
                "bound_ms": bound_ms, "bound_by": bound_by})
            rec["library_ms"] = _bilstm_reference_ms(device, R, T, H, dtype, True)
            # where the planner moved dc out of shared memory for fewer K
            # tiles: K10p at the plan that keeps it there, for comparison
            kt_smem = K._backward_tile(H, plan.U, plan.chunk, plan.rows, True, K.SMEM_LIMIT,
                                       elem)
            if not (split or plan.dc_in_smem) and kt_smem is not None:
                alt = dataclasses.replace(plan, dc_in_smem=True, kt=kt_smem, smem=K.backward_smem(
                    H, plan.U, plan.chunk, kt_smem, plan.rows, True, elem))
                rec["dc_in_smem_plan"] = {"kt": alt.kt, "ntiles": alt.ntiles,
                                          "smem_bytes": alt.smem}
                rec["dc_in_smem_ms"] = _time_ms(lambda: K.lstm_train_bwd2_persistent(*args, alt))
            print(f"[k10p] {label} {dt_name} {what} R={R} T={T} H={H}: plan S={plan.S} G={plan.G} "
                  f"U={plan.U} rows={plan.rows} chunk={plan.chunk} kt={plan.kt} dc_in_smem="
                  f"{plan.dc_in_smem} smem={plan.smem} B ({plan.ctas} CTAs), dW split "
                  f"{plan.dw_split}; routes {routes}, dW launches {dw_launches}; {label} "
                  f"{rec['ms']:.3f} ms, walk {rec['walk_ms']:.3f} "
                  f"ms, K5p x 2 {rec['k5p_pair_ms']:.3f} ms, plain {rec['plain_ms']:.3f} ms, "
                  f"nn.LSTM bidirectional backward {rec['library_ms']:.3f} ms, bound "
                  f"{bound_ms:.4f} ms ({bound_by}); with dc in shared memory "
                  f"{rec.get('dc_in_smem_plan')} {rec.get('dc_in_smem_ms')} ms; two launches "
                  f"bitwise equal: {bitwise}; equal to K5p per direction at this plan: "
                  f"{equals_k5p}")
            want = {"persistent": 1 - split, "walk": 0, "persistent_split": 2 * split}
            if routes != want or dw_launches != 2:
                fail(f"{label} {dt_name} {what}: the routed K10 took {routes} with {dw_launches} "
                     f"dW launches, expected {want} and the dW kernel once a direction")
            if not bitwise:
                fail(f"{label} {dt_name} {what}: two launches differ")
            if not equals_k5p:
                fail(f"{label} {dt_name} {what}: not bitwise K5p per direction at its plan")
            out["k10p"].append(rec)
            del res, dout, wh, args, dxp
    return out


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
        validation = _validation_pass(_flow_config(workdir), state)
        print(f"[flow training] one float32 validation pass (2 utterances, B=2, the N = 10 "
              f"sampler on the first batch): {validation['ms']:.1f} ms, val_loss "
              f"{validation['val_loss']:.6g}, K1-K3 routes {validation['routes']}")
        _check_routes("the float32 flow validation pass", "float32", validation["routes"])
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
    return routes, exp / "checkpoints" / "step_6.pt", validation


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
    process; where a codec backend exists, one codec augmentation.  Returns
    the run's routes and timings."""
    import numpy as np
    import torch
    from urgent2026_challenge_track1_tpu_torch import train_se
    from urgent2026_challenge_track1_tpu_torch.data.dataset import AudioDataModule
    from urgent2026_challenge_track1_tpu_torch.models.bsrnn import BSRNNConfig, init_bsrnn
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K
    from urgent2026_challenge_track1_tpu_torch.simulation import dsp, render

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
    init = init_bsrnn(BSRNNConfig(num_channel=N_IN, num_layer=6), seed=2024, device="cpu")
    trained = state.model.state_dict()
    changed = sum(not torch.equal(v, trained[k].cpu()) for k, v in init.state_dict().items())
    print(f"[dm training] {changed} of {len(trained)} parameter tensors changed")
    if changed < len(trained) // 2:
        fail("dm training left most parameters unchanged")
    for fn in K.KERNELS[:7]:
        if counts[fn.__name__] <= 0:
            fail(f"kernel {fn.__name__} was not launched on the dynamic-mixing training path")
    # K1-K7 persistent only (K1-K3 in validation): no walk
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
    codec_s = None
    if dsp.codecs_available():  # one codec augmentation of a 48 kHz source, on the host
        speech, _ = render.read_audio(str(root / "speech0.flac"), force_1ch=True)
        t1 = time.perf_counter()
        coded = render.apply_augmentations(speech, 48000,
                                           "codec(format=mp3,encoder=None,qscale=3)")
        codec_s = time.perf_counter() - t1
        print(f"[dm training] one mp3 codec item ({speech.shape[-1]} samples) rendered in "
              f"{codec_s:.3f} s")
        if coded.shape != speech.shape or not np.isfinite(coded).all() or np.array_equal(
                coded, speech):
            fail("the codec augmentation returned a wrong-shaped, non-finite or unchanged item")
    out = {"dm_step_s": step_s, "dm_loader_wait_s": wait_s, "codec_item_s": codec_s,
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


SGMSE_SEED = 70
SGMSE_N = 50  # sgmse_enhance's default: 50 steps, one correction each, 100 network calls
# bf16 against f32 (the same weights and draws, N = 50, 4 s at 48 kHz): the
# relative gap of the enhanced waveforms' compressed spectra, max|d| / max|f32|.
# Read 7.3e-3 on an H100 at 700 W; the control (one step's corrector noise
# dropped) read 2.9e-2: the bound sits at twice the reading, half the control.
SGMSE_BF16_BOUND = 1.5e-2


def _spec_rel(wav, ref, fs, stft_cfg) -> float:
    """max|d| / max|ref| between the compressed spectra of two waveforms,
    the domain the SGMSE sampler works in."""
    from urgent2026_challenge_track1_tpu_torch.dsp import stft as dsp

    a = dsp.stft_encode(wav.float(), fs, stft_cfg)
    b = dsp.stft_encode(ref.float().to(wav.device), fs, stft_cfg)
    return float((a - b).abs().max() / (b.abs().max() + 1e-12))


def _sgmse_draws(y, N, corrector_steps, seed):
    """The prior z and each step's corrector and predictor noises of one
    enhancement of spectrum ``y``, drawn on its device from one seed."""
    import torch
    from urgent2026_challenge_track1_tpu_torch.models.odes import complex_normal_like

    gen = torch.Generator(device=y.device).manual_seed(seed)
    prior = complex_normal_like(y, gen)
    return prior, [[complex_normal_like(y, gen) for _ in range(corrector_steps + 1)]
                   for _ in range(N)]


def phase_sgmse(device, channels=N_IN, layers=6, seconds=(1.0, 4.0), N=SGMSE_N):
    """SGMSE at the full SGMSEConfig width (196 x 6, n_fft 1536, seeded
    weights).  (a) float32, 1 s at 48 kHz, B=1, card against the port's CPU
    path: score_fn, sgmse_loss with injected t and z and its gradients (the
    loss step's routes: K4p-f32, K5p-f32 and dW-f32, no K6/K7, none of
    K1-K3), sgmse_enhance at N = 3 with injected draws; each within
    E2E_TOL, the sample's as the relative gap of its compressed spectrum.
    (b) bfloat16 sgmse_enhance at N = 50, 4 s at 48 kHz, B=1: finite, exact
    length, its K1p launches and wall time, and its gap to the float32 card
    run of the same weights and draws within SGMSE_BF16_BOUND, which the
    bf16 run with one step's corrector noise dropped must exceed."""
    import copy

    import numpy as np
    import torch
    from urgent2026_challenge_track1_tpu_torch.dsp import stft as dsp
    from urgent2026_challenge_track1_tpu_torch.models import sgmse as S
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K

    fs = 48000
    cfg = S.SGMSEConfig(bsrnn_hidden=channels, num_layer=layers)
    model = S.init_sgmse(cfg, seed=SGMSE_SEED, device=device)
    cpu_model = copy.deepcopy(model).cpu()
    rng = np.random.default_rng(71)

    def waves(seconds):
        n = int(seconds * fs)
        t = np.arange(n) / fs
        clean = 0.3 * np.sin(2 * np.pi * 220.0 * t) * (np.sin(2 * np.pi * 2.0 * t) > -0.3)
        noisy = clean + 0.05 * rng.standard_normal(n)
        return (torch.from_numpy(clean.astype(np.float32))[None],
                torch.from_numpy(noisy.astype(np.float32))[None])

    # (a) float32, card against CPU
    clean, noisy = waves(seconds[0])
    y = dsp.stft_encode(noisy, fs, cfg.stft_cfg)
    gen = torch.Generator().manual_seed(72)
    x = y + 0.3 * torch.complex(torch.randn(y.shape, generator=gen),
                                torch.randn(y.shape, generator=gen))
    t = torch.tensor([0.6])
    with torch.no_grad():
        ref = S.score_fn(cpu_model, cfg, x, t, y, fs)
        got = S.score_fn(model, cfg, x.to(device), t.to(device), y.to(device), fs)
    score_err = float((got.cpu() - ref).abs().max())
    t_loss = torch.tensor([0.37])
    z = torch.complex(torch.randn(y.shape, generator=gen), torch.randn(y.shape, generator=gen))
    z = z * 0.5 ** 0.5
    losses = []
    for m, dev in ((cpu_model, torch.device("cpu")), (model, device)):
        if dev.type == "cuda":
            K.reset_launch_counts()
        loss = S.sgmse_loss(m, cfg, clean.to(dev), noisy.to(dev), fs, t=t_loss.to(dev),
                            z=z.to(dev))
        loss.backward()
        losses.append(float(loss.detach()))
    torch.cuda.synchronize()
    counts, routes = K.launch_counts(), _routes()
    loss_rel = abs(losses[1] - losses[0]) / abs(losses[0])
    cpu_grads = dict(cpu_model.named_parameters())
    grad_rel = max(_rel(p.grad.cpu(), cpu_grads[n].grad) for n, p in model.named_parameters()
                   if float(cpu_grads[n].grad.abs().max()) > 0)
    _check_no_lean_kernels("the SGMSE loss step", counts)
    _check_routes("the SGMSE loss step", "float32", routes, ("lstm_train_fwd", "lstm_train_bwd"))
    masked = {k: counts[k] for k in ("lstm_revmasked_train_fwd", "lstm_revmasked_bwd")}
    if any(masked.values()):
        fail(f"the SGMSE loss step (no lengths) launched the masked kernels {masked}")
    dw = _check_dw_launches("the SGMSE loss step", routes)
    loss_launches = {k: v for k, v in counts.items() if v}
    prior, noises = _sgmse_draws(y, 3, 1, 73)
    with torch.no_grad():
        ref = S.sgmse_enhance(cpu_model, cfg, noisy, fs, N=3, prior_z=prior, noises=noises)
        got = S.sgmse_enhance(model, cfg, noisy.to(device), fs, N=3, prior_z=prior.to(device),
                              noises=[[d.to(device) for d in s] for s in noises])
    enh_spec_rel = _spec_rel(got, ref, fs, cfg.stft_cfg)
    enh_wave_rel = _rel(got.cpu(), ref)
    print(f"[sgmse] f32 {channels}x{layers}, {seconds[0]} s at 48 kHz, card vs CPU: score max|d| "
          f"{score_err:.3e}, loss "
          f"{losses[1]:.6g} rel d {loss_rel:.3e}, grads max rel d {grad_rel:.3e}, N=3 enhance "
          f"spectrum rel d {enh_spec_rel:.3e} (waveform rel d {enh_wave_rel:.3e}, peak "
          f"{float(ref.abs().max()):.4g}); tolerance {E2E_TOL}; loss step launches "
          f"{loss_launches}, dW {dw}")
    for what, err in (("score", score_err), ("loss", loss_rel), ("gradients", grad_rel),
                      ("N=3 enhancement", enh_spec_rel)):
        if not err < E2E_TOL:
            fail(f"sgmse {what}: card and CPU differ by {err:.3e} >= {E2E_TOL}")
    del cpu_model, cpu_grads
    model.zero_grad(set_to_none=True)

    # (b) bfloat16, N = 50, 4 s, against float32 on the card
    _, noisy = waves(seconds[1])
    noisy = noisy.to(device)
    n = noisy.shape[-1]
    y = dsp.stft_encode(noisy, fs, cfg.stft_cfg)
    prior, noises = _sgmse_draws(y, N, 1, 74)
    bcfg = S.SGMSEConfig(bsrnn_hidden=channels, num_layer=layers, compute_dtype="bfloat16")
    bmodel = S.init_sgmse(bcfg, seed=SGMSE_SEED, device=device).eval()
    with torch.no_grad():
        S.sgmse_enhance(bmodel, bcfg, noisy, fs, N=2)  # warm-up at the timed shapes
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = S.sgmse_enhance(bmodel, bcfg, noisy, fs, N=N, prior_z=prior, noises=noises)
        torch.cuda.synchronize()
        bf16_s = time.perf_counter() - t0
        counts, routes = K.launch_counts(), _routes()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        out32 = S.sgmse_enhance(model.eval(), cfg, noisy, fs, N=N, prior_z=prior, noises=noises)
        torch.cuda.synchronize()
        f32_s = time.perf_counter() - t0
        routes32 = _routes()
        dropped = [list(step) for step in noises]
        dropped[N // 2][0] = torch.zeros_like(dropped[N // 2][0])
        control = S.sgmse_enhance(bmodel, bcfg, noisy, fs, N=N, prior_z=prior, noises=dropped)
    _check_routes("the bf16 SGMSE sampler", "bfloat16", routes, ("fusedin_bilstm",))
    _check_routes("the f32 SGMSE sampler", "float32", routes32, ("fusedin_bilstm",))
    k1p = routes["fusedin_bilstm"]["persistent"]
    k1p_f32 = routes32["fusedin_bilstm"]
    gap = _spec_rel(out, out32, fs, cfg.stft_cfg)
    control_gap = _spec_rel(control, out32, fs, cfg.stft_cfg)
    power = gpu_name_and_power()
    print(f"[sgmse] bf16 N={N} (1 correction a step), {seconds[1]} s at 48 kHz, B=1: "
          f"{bf16_s:.2f} s ({power}), K1p launches {k1p}, launches { {k: v for k, v in counts.items() if v} }; "
          f"f32 the same {f32_s:.2f} s (K1 routes {k1p_f32}); bf16 vs f32 spectrum rel d "
          f"{gap:.3e} (bound "
          f"{SGMSE_BF16_BOUND}), the corrector noise of step {N // 2} dropped "
          f"{control_gap:.3e}; peak {float(out32.abs().max()):.4g}")
    if out.shape != (1, n) or not bool(torch.isfinite(out).all()):
        fail("sgmse: the bf16 enhancement is not finite or has the wrong length")
    if k1p != 2 * layers * 2 * N:
        fail(f"sgmse: {k1p} K1p launches, expected {2 * layers * 2 * N} (2 a layer a call)")
    if sum(k1p_f32.values()) != 2 * layers * 2 * N * (1 if k1p_f32["persistent"] else 2):
        fail(f"sgmse: float32 K1 routes {k1p_f32}, expected 2 K1p-f32 calls a layer a call")
    if not gap < SGMSE_BF16_BOUND < control_gap:
        fail(f"sgmse: bf16 vs f32 {gap:.3e} and the control {control_gap:.3e} do not bracket "
             f"the bound {SGMSE_BF16_BOUND}")
    return {"sgmse_score_err": score_err, "sgmse_loss_rel_err": loss_rel,
            "sgmse_grad_rel_err": grad_rel, "sgmse_enhance_n3_spec_rel_err": enh_spec_rel,
            "sgmse_enhance_n3_wave_rel_err": enh_wave_rel, "sgmse_loss_launches": loss_launches,
            "sgmse_loss_dw_launches": dw, "sgmse_bf16_n50_s": bf16_s, "sgmse_f32_n50_s": f32_s,
            "sgmse_k1p_launches": k1p, "sgmse_f32_k1_routes": k1p_f32,
            "sgmse_bf16_vs_f32_spec_rel": gap,
            "sgmse_dropped_noise_spec_rel": control_gap, "card": power}


# card (cuFFT) against CPU (pocketfft), on outputs peak-normalised to 0.9
DM_DEVICE_RENDER_BOUND = 1e-5


def phase_dm_device(workdir: Path, device, host_dm):
    """The values of conf/models/BSRNN_baseline_dm.yaml with
    dynamic_mixing_on_device (196 x 6, B=4, max_duration 96000, num_worker
    2, float32) through ``train_se.run``: 2 steps and one validation, the
    batches' sources and recipes from two spawned workers, rendered on the
    card inside the step (K4p-f32 - K7p-f32 + dW-f32, no walk of K4-K7).
    Then the loader alone over the run's epoch, and 4 source items and
    their collation in this process.  Then one collated batch rendered on
    the card against the CPU render of the same batch, within
    DM_DEVICE_RENDER_BOUND; the control (the batch with every SNR 1 dB
    higher) must exceed it.  ``host_dm``:
    phase_dm_training's times, printed beside these."""
    import numpy as np
    import torch
    from urgent2026_challenge_track1_tpu_torch import train_se
    from urgent2026_challenge_track1_tpu_torch.data import dynamic_device as dd
    from urgent2026_challenge_track1_tpu_torch.data.dataset import AudioDataModule
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K

    root = _write_dm_sources(workdir / "dmdev_train", 33)
    _write_split(workdir / "dmdev_valid", (2.0, 1.75, 1.5, 1.25), 34, ext="flac")
    cfg = _train_config(workdir, train_set_path=str(root),
                        valid_set_path=str(workdir / "dmdev_valid"),
                        train_set_dynamic_mixing=True, dynamic_mixing_on_device=True,
                        use_high_pass=True, num_train_epochs=1, val_check_interval=2,
                        train_name="dm_device")
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        K.reset_launch_counts()
        t0 = time.perf_counter()
        state = train_se.run(cfg)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts, routes = K.launch_counts(), _routes()
        dw = _check_dw_launches("the on-device dm training path", routes)
    finally:
        os.chdir(cwd)
    print(f"[dm device] 1 epoch x 2 steps (+ 1 validation, 1 save) in {seconds:.1f} s, launches "
          f"{counts}, routes {routes}, dW {dw}")
    if (state.step, state.epoch) != (2, 1):
        fail(f"on-device dm training ended at step {state.step}, epoch {state.epoch}")
    records = _metrics(workdir, "dm_device")
    steps = [r for r in records if "train_loss" in r]
    vals = [r["val_loss"] for r in records if "val_loss" in r]
    if len(steps) != 2 or len(vals) != 1 or None in [r["train_loss"] for r in steps] + vals:
        fail("on-device dm training logged missing or non-finite losses")
    for fn in K.KERNELS[:7]:
        if counts[fn.__name__] <= 0:
            fail(f"kernel {fn.__name__} was not launched on the on-device dm training path")
    _check_routes("the on-device dm training path", "float32", routes,
                  INFERENCE_KERNELS + TRAIN_ROUTED)
    step_s = [r["step_time"] for r in steps]
    wait_s = [r["data_time"] for r in steps]
    # the loader alone over the run's epoch (its batches): when each batch
    # is ready after the spawn, and how many of its rows the host rendered;
    # then 4 items and their collation in this process
    batch_s, host_rows = [], []
    t0 = time.perf_counter()
    for b in AudioDataModule(cfg).train_dataloader(epoch=0):
        batch_s.append(time.perf_counter() - t0)
        host_rows.append(int(b["prerendered_mask"].sum()))
    ds = AudioDataModule(cfg).train_dataset
    ds.rng = np.random.RandomState(35)  # this batch's recipes: a fixed draw
    items, item_s = [], []
    for i in range(4):
        t1 = time.perf_counter()
        items.append(ds[i])
        item_s.append(time.perf_counter() - t1)
    t1 = time.perf_counter()
    batch = dd.collate_device_render(items, cfg.length_bucket_ms)
    collate_s = time.perf_counter() - t1
    if batch["prerendered_mask"].sum() == 4:
        fail("the on-device render check drew no row for the card to render")
    cpu = dd.render_on_device(batch, True, "cpu")
    card = dd.render_on_device(batch, True, device)
    err = max(float((c.cpu() - r).abs().max()) for c, r in zip(card, cpu))
    louder = dd.DeviceRenderBatch(batch, snr_db=batch["snr_db"] + 1.0)
    ctrl = dd.render_on_device(louder, True, device)
    control = float((ctrl[1].cpu() - cpu[1]).abs().max())
    render_ms = _time_ms(lambda: dd.render_on_device(batch, True, device), reps=3, warmup=1)
    out = {"dm_device_step_s": step_s, "dm_device_loader_wait_s": wait_s,
           "dm_device_render_ms": render_ms, "dm_device_render_err": err,
           "dm_device_render_control": control,
           "dm_device_prerendered_rows": int(batch["prerendered_mask"].sum()),
           "dm_device_bucket_T": int(batch["speech"].shape[-1]),
           "dm_device_loader_epoch_batch_ready_s": batch_s,
           "dm_device_loader_host_rendered_rows": host_rows,
           "dm_device_source_item_s": item_s, "dm_device_collate_s": collate_s}
    print(f"[dm device] step seconds {step_s} (host render: {host_dm['dm_step_s']}), loader wait "
          f"seconds {wait_s} (host render: {host_dm['dm_loader_wait_s']}); one batch (B=4, T="
          f"{out['dm_device_bucket_T']}, {out['dm_device_prerendered_rows']} rows rendered on the "
          f"host) rendered on the card in {render_ms:.3f} ms, card vs CPU max|d| {err:.3e} "
          f"(bound {DM_DEVICE_RENDER_BOUND}), SNR + 1 dB control {control:.3e}; the loader "
          f"alone: batches ready at {batch_s} s (host render: "
          f"{host_dm['loader_epoch_batch_ready_s']}), rows rendered on the host {host_rows}; "
          f"source items {item_s} s (host render's items: {host_dm['render_item_s']}), "
          f"collation {collate_s:.4f} s")
    if not err < DM_DEVICE_RENDER_BOUND < control:
        fail(f"on-device render: card vs CPU {err:.3e} and the control {control:.3e} do not "
             f"bracket the bound {DM_DEVICE_RENDER_BOUND}")
    return out


# ---------------------------------------------------------------------------
# the A/B arms of the experiment toggles (phase 4)
# ---------------------------------------------------------------------------

ARMS = {"default": (False, False), "stream": (True, False), "fused": (False, True),
        "both": (True, True)}
ARM_ORDER = ("default", "stream", "fused", "both", "both", "fused", "stream", "default")
# the arms each family visits: disc_f32 (the discriminative model in float32)
# runs the fused arm only, where K10p-f32 has its plan (the band path 804 x
# 34, H = 392); at the flow band (502 x 48, H = 768, float32) no K10p plan
# fits and K10 takes its one-direction pair (flow family)
FAMILY_ARMS = {"disc": ARM_ORDER, "flow": ARM_ORDER,
               "disc_f32": ("default", "fused", "fused", "default")}
AB_LAYERS = 6  # the families' depth in the A/B arms
# the kernels whose route the A/B arms check: K8 (K8p or its walk), K9 (K9p
# or K4's walk), K10 (K10p, its one-direction pair or its walk)
AB_ROUTED = ("lstm_train_fwd_streamin", "lstm_train_fwd2", "lstm_train_bwd2")
# launches per call of each route of K9 and K10 (K9: K4p or K4's walk once a
# direction; K10's pair: K5p once a direction); 1 elsewhere
AB_LAUNCHES_PER_CALL = {("lstm_train_fwd2", "persistent"): 2, ("lstm_train_fwd2", "walk"): 2,
                        ("lstm_train_bwd2", "persistent_split"): 2}


def _ab_model(device, family):
    """(bundle, cfg, model, batch) of one A/B family: the discriminative
    baseline (B=4, 2 s buckets at 48 kHz, 196 x 6, bf16; the geometry of
    scripts/bench_band_fused_ab.py; disc_f32 the same in float32) or the
    flow model (B=2, 2 s, 384 x 6, float32, the config's dtype)."""
    import torch
    from urgent2026_challenge_track1_tpu_torch.train import trainer

    if family in ("disc", "disc_f32"):
        cfg = _train_config(Path("."), compute_dtype="bfloat16" if family == "disc"
                            else "float32")
        batch = _train_batch(device)
    else:
        cfg = _flow_config(Path("."))
        clean, noisy, _ = _train_batch(device, B=2)
        batch = (clean, noisy, torch.tensor([int(s * 48000) for s in FLOW_SECONDS],
                                            dtype=torch.int32, device=device))
    bundle = trainer.build_model(cfg)
    return bundle, cfg, trainer.init_params(cfg.seed, bundle, device), batch


def _ab_expected_routes(K, family, dtype, sms):
    """The routes K8, K9 and K10 may take in one family's train step, by
    the rules applied at the family's shapes: K8 on K8p where
    ``streamin_route`` finds a plan at its time or its band path, on the
    walk where it finds none at one of them; K9 on K9p where ``scan_route``
    finds K4p a plan at the band path, else on K4's walk; K10 on K10p where
    ``backward2_route`` finds a two-direction plan at the band path, on its
    one-direction pair where it finds a one-direction plan, else on the
    walk."""
    import torch

    dt = getattr(torch, dtype)
    flow = family == "flow"
    N, H = (FLOW_N, FLOW_H) if flow else (N_IN, HID)
    time_path, band_path = (FLOW_TIME, FLOW_BAND) if flow else (TRAIN_TIME, TRAIN_BAND)

    def route(plan, split=False):
        return "walk" if plan is None else "persistent_split" if split else "persistent"

    bwd2 = K.backward2_route(dt, band_path[0], H, sms)
    return {"lstm_train_fwd_streamin": {route(K.streamin_route(dt, R, N, H, sms))
                                        for R, _ in (time_path, band_path)},
            "lstm_train_fwd2": {route(K.scan_route(dt, band_path[0], H, sms))},
            "lstm_train_bwd2": {route(bwd2, bwd2 is not None and bwd2.dirs == 1)}}


def phase_ab_arms(device):
    """One train step per visit of each arm, arms in alternating order, for
    each family (FAMILY_ARMS); the toggles are restored whatever happens.
    The launch counts are set to 0 once at the start of the phase: each
    step's launches are the counts' growth over it, and must be
    ``TRAIN_LAUNCHES_PER_LAYER`` times the depth (its wrapper calls; two
    launches a call on K9p and on K10's one-direction pair,
    AB_LAUNCHES_PER_CALL), and its K8, K9 and K10 launches must all take
    the route the rules give (``_ab_expected_routes``: K8p, K9p and K10p on
    the bfloat16 family, K9p-f32 and K10p-f32 on disc_f32, K8p-f32, K9p-f32
    and K10's pair on flow): no family runs a K9 or K10 walk.  Wherever the
    default arm's two visits give the same loss bit for bit, every fused
    visit must give it too (K9p is the default arm's K4p launches); in the
    flow family, where K10 takes the default arm's K5p-f32 launches, the
    default arm's two visits and the fused arm must give the same gradients
    bit for bit (cuDNN's deterministic algorithms for that family's steps
    only, timed ones included: the flow decoder's convolution weight
    gradients vary from call to call otherwise; the other families keep
    the default setting).  Returns {family: {arm: {...}, "routes": {K8, K9, K10:
    {route: launches}}}} and the counts read at the end of the phase (its
    warm-up and arm steps)."""
    import torch
    from urgent2026_challenge_track1_tpu_torch.models.bsrnn import TRAIN_LAUNCHES_PER_LAYER
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K
    from urgent2026_challenge_track1_tpu_torch.train import trainer

    expected = {arm: {k: v * AB_LAYERS for k, v in per_layer.items()}
                for arm, per_layer in TRAIN_LAUNCHES_PER_LAYER.items()}
    sms = _sm_count(device)
    out = {}
    saved = (K.STREAM_INPUT_TRAIN, K.FUSED_BIDIR_TRAIN, torch.backends.cudnn.deterministic)
    K.reset_launch_counts()
    try:
        for family, arm_order in FAMILY_ARMS.items():
            # the flow decoder's convolutions take cuDNN weight-gradient
            # algorithms that sum in no fixed order; fixed ones let the flow
            # family's visits agree bit for bit
            torch.backends.cudnn.deterministic = saved[2] or family == "flow"
            bundle, cfg, model, batch = _ab_model(device, family)
            want_route = _ab_expected_routes(K, family, cfg.compute_dtype, sms)
            per_call = {name: max(AB_LAUNCHES_PER_CALL.get((name, r), 1) for r in routes)
                        for name, routes in want_route.items()}
            want = {arm: {k: v * per_call.get(k, 1) for k, v in calls.items()}
                    for arm, calls in expected.items()}
            family_routes = {name: dict.fromkeys(K.route_counts(name), 0) for name in AB_ROUTED}
            init = {k: v.clone() for k, v in model.state_dict().items()}
            step = trainer.make_train_step(bundle, cfg, 48000)
            step(model, trainer.make_optimizer(cfg, model), *batch,
                 generator=trainer.step_generator(cfg.seed, 0))  # warm-up, default arm
            arms = {}
            for arm in arm_order:
                K.STREAM_INPUT_TRAIN, K.FUSED_BIDIR_TRAIN = ARMS[arm]
                model.load_state_dict(init)
                opt = trainer.make_optimizer(cfg, model)
                before = K.launch_counts()
                before_routes = {name: K.route_counts(name) for name in AB_ROUTED}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = step(model, opt, *batch, generator=trainer.step_generator(cfg.seed, 0))
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                counts = {k: v - before[k] for k, v in K.launch_counts().items() if v - before[k]}
                grads = [p.grad.float().clone() for p in model.parameters()]
                rec = arms.setdefault(arm, {"ms": [], "losses": [], "launches": counts,
                                            "loss": float(m["loss"]), "grads": grads,
                                            "grads_repeat_bitwise": []})
                rec["ms"].append(ms)
                rec["losses"].append(float(m["loss"]))
                if rec["grads"] is not grads:
                    rec["grads_repeat_bitwise"].append(
                        all(torch.equal(a, b) for a, b in zip(rec["grads"], grads)))
                del grads
                if counts != want[arm]:
                    fail(f"{family} {arm}: launches {counts}, expected {want[arm]}")
                for name in AB_ROUTED:
                    grown = {r: n - before_routes[name][r]
                             for r, n in K.route_counts(name).items()}
                    for r, n in grown.items():
                        family_routes[name][r] += n
                    if sum(grown[r] for r in want_route[name]) != counts.get(name, 0):
                        fail(f"{family} {arm}: {name} routes {grown}, expected "
                             f"{sorted(want_route[name])} only")
            for name in ("lstm_train_fwd2", "lstm_train_bwd2"):
                if family_routes[name]["walk"]:
                    fail(f"{family}: {name} took its walk {family_routes[name]['walk']} times")
            grads = {arm: rec.pop("grads") for arm, rec in arms.items()}
            ref = arms["default"]
            default_repeats = len(set(ref["losses"])) == 1
            fused_loss = all(v == ref["losses"][0] for v in arms["fused"]["losses"])
            default_grads_repeat = all(ref["grads_repeat_bitwise"])
            fused_grads = all(torch.equal(a, b) for a, b in zip(grads["fused"], grads["default"]))
            print(f"[a/b] {family}: default visits' losses {ref['losses']} (bitwise equal: "
                  f"{default_repeats}), fused {arms['fused']['losses']} (bitwise the default's: "
                  f"{fused_loss}); default visits' gradients bitwise equal: "
                  f"{default_grads_repeat}, fused gradients bitwise the default's: {fused_grads}")
            if default_repeats and not fused_loss:
                fail(f"{family}: the fused arm's loss is not the default arm's bit for bit")
            if family == "flow" and not (default_grads_repeat and fused_grads):
                fail("flow: the default arm's visits, or the fused arm and the default arm, "
                     "give other gradients bit for bit")
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
            print(f"[a/b] {family} {cfg.compute_dtype}: K8 and K10 routes over its arm steps "
                  f"{family_routes} (the rules: "
                  f"{ {k: sorted(v) for k, v in want_route.items()} })")
            out[family] = {"compute_dtype": cfg.compute_dtype, "arms": arms,
                           "routes": family_routes,
                           "default_visits_bitwise": {"loss": default_repeats,
                                                      "grads": default_grads_repeat},
                           "fused_bitwise_default": {"loss": fused_loss, "grads": fused_grads},
                           "expected_routes": {k: sorted(v) for k, v in want_route.items()}}
            del model
    finally:
        K.STREAM_INPUT_TRAIN, K.FUSED_BIDIR_TRAIN, torch.backends.cudnn.deterministic = saved
    total = K.launch_counts()
    print(f"[a/b] launches over the phase: {total}")
    for name in NEW_KERNELS:
        if total[name] <= 0:
            fail(f"kernel {name} was not launched by the A/B arms")
    for name, route, dtype in (
            ("lstm_train_fwd_streamin", "persistent", "bfloat16"),
            ("lstm_train_fwd2", "persistent", "bfloat16"),
            ("lstm_train_bwd2", "persistent", "bfloat16"),
            ("lstm_train_fwd_streamin", "persistent", "float32"),
            ("lstm_train_fwd2", "persistent", "float32"),
            ("lstm_train_bwd2", "persistent", "float32"),
            ("lstm_train_bwd2", "persistent_split", "float32")):
        if _ab_route_launches(out, name, route, dtype) <= 0:
            fail(f"the {route} route of {name} in {dtype} was not launched by the A/B arms")
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
    cpu_model = F.init_flowse(fcfg, seed=9, device="cpu")
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
# the ONNX executor and DNSMOS (the evaluation path)
# ---------------------------------------------------------------------------

ONNX_TOL = 1e-5   # card vs CPU, max|d| / max|CPU|: float32 graphs, TF32 off in the session
ONNX_SECONDS = 10.0  # the DNSMOS scoring input: one 9.01 s window (score_one's hop rule)


def _speechlike(rng, n, fs=16000):
    """A 16 kHz test signal: a 4 Hz-modulated 220 Hz tone and its harmonics
    over noise."""
    import numpy as np

    t = np.arange(n) / fs
    tone = sum(np.sin(2 * np.pi * 220 * k * t) / k for k in range(1, 6))
    return 0.2 * tone * (0.55 + 0.45 * np.sin(2 * np.pi * 4 * t)) + 0.01 * rng.standard_normal(n)


def _host_ms(fn) -> float:
    t = time.perf_counter()
    fn()
    return 1e3 * (time.perf_counter() - t)


def phase_onnx(device):
    """The evaluation path's ONNX executor on the card: the two stand-in
    DNSMOS graphs (``evaluation/dnsmos_standin.py``: conv SAME_UPPER at
    stride 2, BatchNormalization, MaxPool ceil_mode, the Shape idiom,
    GlobalAveragePool, Gemm, the opset-12 Softmax, one LSTM) at DNSMOS's
    input shapes, on the card against the CPU within ONNX_TOL, the
    process's TF32 flags turned on around the calls (the session must run at
    full float32 and restore them), its outputs CUDA tensors; the CPU graph
    with the first conv's pads mirrored (SAME_LOWER) must exceed the limit.
    Then ``dnsmos.score_one`` on a 10 s signal with the card sessions
    against the CPU ones, and its time per 9.01 s window (CUDA events,
    median of 5)."""
    import numpy as np
    import torch
    from urgent2026_challenge_track1_tpu_torch.evaluation import dnsmos
    from urgent2026_challenge_track1_tpu_torch.evaluation import dnsmos_standin as S
    from urgent2026_challenge_track1_tpu_torch.ops import onnx_torch

    rng = np.random.default_rng(19)
    audio = _speechlike(rng, int(ONNX_SECONDS * 16000))
    window = np.asarray(audio[: S.PRIMARY_SHAPE[1]], np.float32)
    feeds = {"primary": window[None], "p808": dnsmos.logmel_features(window[:-160])[None]}
    builds = {"primary": S.primary_graph, "p808": S.p808_graph}
    flags = (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32)
    card, cpu, result = {}, {}, {}
    torch.set_float32_matmul_precision("high")  # TF32 on for the process:
    torch.backends.cudnn.allow_tf32 = True      # the session turns it off for its calls
    try:
        for name, build in builds.items():
            card[name] = onnx_torch.InferenceSession(build(), device=device)
            cpu[name] = onnx_torch.InferenceSession(build(), device="cpu")
            feed = {"input_1": feeds[name]}
            outs = card[name].run_tensors(None, feed)
            if not all(isinstance(o, torch.Tensor) and o.device.type == device.type
                       for o in outs):
                fail(f"onnx {name}: the card session's outputs are not {device.type} tensors")
            if (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32) != (
                    "high", True):
                fail(f"onnx {name}: the session did not restore the TF32 flags")
            ref = cpu[name].run(None, feed)  # scores, logits, the head's features

            def rel(outputs):  # the worst output's max|d| / max|CPU|
                return max(float(np.abs(np.asarray(o) - r).max()) / float(np.abs(r).max())
                           for o, r in zip(outputs, ref))

            err = rel([o.cpu().numpy() for o in outs])
            mirrored = onnx_torch.InferenceSession(build(auto_pad="SAME_LOWER"), device="cpu")
            ctrl = rel(mirrored.run(None, feed))
            with torch.inference_mode():  # no scope: the process's TF32 (information only)
                tf32 = rel([o.cpu().numpy() for o in card[name]._exec(**feed)])
            print(f"[onnx] {name} {tuple(feeds[name].shape)} -> "
                  f"{[tuple(r.shape) for r in ref]}: card vs CPU max|d|/max|CPU| = {err:.3e} "
                  f"(limit {ONNX_TOL}); mirrored conv pads {ctrl:.3e} (must exceed); with the "
                  f"process's TF32 on {tf32:.3e}")
            if not err <= ONNX_TOL:
                fail(f"onnx {name}: card and CPU differ by {err:.3e} > {ONNX_TOL}")
            if not ctrl > ONNX_TOL:
                fail(f"onnx {name}: the mirrored-pad control {ctrl:.3e} is within {ONNX_TOL}")
            result[name] = {"rel_err": err, "mirrored_rel": ctrl, "tf32_rel": tf32,
                            "scores": ref[0].ravel().tolist()}
    finally:
        torch.set_float32_matmul_precision(flags[0])
        torch.backends.cudnn.allow_tf32 = flags[1]
    pair = (card["primary"], card["p808"])
    got = dnsmos.score_one(pair, audio, 16000)
    ref = dnsmos.score_one((cpu["primary"], cpu["p808"]), audio, 16000)
    windows = int(np.floor(len(audio) / 16000) - dnsmos.INPUT_LENGTH) + 1
    ms = _time_ms(lambda: dnsmos.score_one(pair, audio, 16000), reps=5, warmup=1) / windows
    cpu_ms = statistics.median(_host_ms(lambda: dnsmos.score_one(
        (cpu["primary"], cpu["p808"]), audio, 16000)) for _ in range(3)) / windows
    for k in dnsmos.METRICS:
        if not (np.isfinite(got[k]) and abs(got[k] - ref[k]) <= ONNX_TOL * abs(ref[k])):
            fail(f"dnsmos {k}: card {got[k]} vs CPU {ref[k]}")
    print(f"[onnx] dnsmos.score_one, {ONNX_SECONDS} s at 16 kHz ({windows} windows): card "
          f"{got}, CPU {ref}; {ms:.3f} ms a 9.01 s window on the card (CUDA events, median of 5), "
          f"CPU sessions {cpu_ms:.3f} ms (host clock, median of 3); {gpu_name_and_power()}")
    result["score_one"] = {"card": got, "cpu": ref, "ms_per_window": ms,
                           "cpu_ms_per_window": cpu_ms, "windows": windows}
    return result


EVAL_TOL = 1e-5  # card vs CPU, relative: the model-scored CLIs' float32 stubs, TF32 off
EVAL_LOUD = 2000.0  # sum |x| at 16 kHz: u0 (loud, English) lies above, u1 (quiet, German) below
EVAL_CLIS = (  # (module of evaluation/, stub, needs the reference, extra inputs, result scp)
    ("utmos", "mos_fs", False, (), "UTMOS"),
    ("speaker_similarity", "embed", True, (), "SpeakerSimilarity"),
    ("lid_accuracy", "lid", False, ("--meta_tsv", "utt2lang"), "LIDAccuracy"),
    ("wer", "asr", False, ("--meta_tsv", "text", "--utt2lang", "utt2lang"), "WER"),
)


def _eval_stub_models(workdir: Path) -> dict:
    """TorchScript stand-ins for the scoring models, with seeded weights so
    that ``map_location`` moves real parameters: a MOS predictor with and
    without the rate argument (a conv over the wave), an embedder (framed
    wave through a linear map), a scripted ASR and a LID model (a word
    chosen by the wave's energy on the device)."""
    import torch

    class Mos(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = torch.nn.Conv1d(1, 8, 64, stride=16)

        def forward(self, x: torch.Tensor, fs: int) -> torch.Tensor:
            h = torch.tanh(self.conv(x[:, None]))
            return 1.0 + 4.0 * torch.sigmoid(h.abs().mean(dim=(1, 2)) + 1e-6 * fs)

    class Mos16k(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = torch.nn.Conv1d(1, 8, 64, stride=16)

        def forward(self, x: torch.Tensor) -> torch.Tensor:
            return 1.0 + 4.0 * torch.sigmoid(torch.tanh(self.conv(x[:, None])).abs().mean(
                dim=(1, 2)))

    class Embed(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.proj = torch.nn.Linear(400, 32)

        def forward(self, x: torch.Tensor) -> torch.Tensor:
            frames = x[:, : (x.shape[1] // 400) * 400].reshape(x.shape[0], -1, 400)
            return torch.tanh(self.proj(frames)).mean(dim=1)

    class Asr(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.loud = EVAL_LOUD

        def forward(self, x: torch.Tensor, lang_sym: str, task_sym: str) -> str:
            if float(x.abs().sum()) > self.loud:
                return "the cat sat on the mat"
            return "die katze sass"

    class Lid(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.loud = EVAL_LOUD

        def forward(self, x: torch.Tensor, lang_sym: str, task_sym: str) -> str:
            if float(x.abs().sum()) > self.loud:
                return "<eng> the cat"
            return "<deu> die katze"

    torch.manual_seed(20)
    paths = {}
    for name, module in (("mos_fs", Mos()), ("mos", Mos16k()), ("embed", Embed()),
                         ("asr", Asr()), ("lid", Lid())):
        paths[name] = workdir / f"{name}.pt"
        torch.jit.script(module).save(str(paths[name]))
    return paths


def _eval_inputs(workdir: Path) -> dict:
    """Two utterances (u0 at 16 kHz, its reference itself; u1 a quieter
    noisy pair at 8 kHz, so the host resampling runs), transcripts,
    languages and a meta.tsv for the breakdown."""
    import numpy as np
    from urgent2026_challenge_track1_tpu_torch.utils import audio_io

    rng = np.random.default_rng(20)
    u0 = _speechlike(rng, 16000) * 2.5
    t1 = np.arange(8000) / 8000
    ref1 = 0.1 * np.sin(2 * np.pi * 200 * t1)
    files = {"u0": (u0, 16000), "u1_ref": (ref1, 8000),
             "u1_inf": (ref1 + 0.02 * rng.standard_normal(8000), 8000)}
    for name, (wav, fs) in files.items():
        audio_io.write(str(workdir / f"{name}.wav"), wav, fs)
    (workdir / "inf.scp").write_text(f"u0 {workdir / 'u0.wav'}\nu1 {workdir / 'u1_inf.wav'}\n")
    (workdir / "ref.scp").write_text(f"u0 {workdir / 'u0.wav'}\nu1 {workdir / 'u1_ref.wav'}\n")
    (workdir / "text").write_text("u0 the cat sat on the mat\nu1 die katze sitzt\n")
    (workdir / "utt2lang").write_text("u0 eng\nu1 deu\n")
    (workdir / "meta.tsv").write_text(
        "id\tfs\tsnr_dB\tlength\tspeech_sid\trir_uid\taugmentation\n"
        "u0\t16000\t5\t16000\tlibrispeech_0\trir_1\tnone\n"
        "u1\t8000\t10\t8000\tvctk_1\tnone\tclipping(min=0.1,max=0.9)\n")
    return {k: workdir / k for k in ("inf.scp", "ref.scp", "text", "utt2lang", "meta.tsv")}


def _scp_scores(path: Path) -> dict:
    out = {}
    for line in path.read_text().splitlines():
        uid, value = line.split(maxsplit=1)
        out[uid] = json.loads(value) if value.startswith("{") else float(value)
    return out


def phase_eval_clis(workdir: Path, device) -> dict:
    """The model-scored evaluation path on the card (``evaluation/``):
    (a) the TorchScript routes of UTMOS, speaker similarity, LID and WER at
    ``--device cuda`` and at ``--device cpu`` on the same two utterances,
    their scores within EVAL_TOL (TF32 off), the card run allocating on the
    card; (b) ``evaluation.eval_all`` end to end on the card with stub
    models for every TorchScript route and the stand-in DNSMOS graphs, its
    produced and skipped lists (no hub is reached: the hub routes read
    local caches only, so the transformers routes skip with 86);
    (c) ``average_checkpoints`` over the three checkpoints the training
    phase saved (steps 2, 4, 6), its means against a float64 mean of the
    three, then the inference CLI on the card from the averaged directory."""
    import numpy as np
    import torch
    from urgent2026_challenge_track1_tpu_torch import average_checkpoints, inference
    from urgent2026_challenge_track1_tpu_torch.evaluation import dnsmos_standin, eval_all

    root = workdir / "eval"
    root.mkdir()
    stubs = _eval_stub_models(root)
    inputs = _eval_inputs(root)
    result = {"card_vs_cpu": {}}
    for module, stub, need_ref, extra, metric in EVAL_CLIS:
        cli = __import__(f"{PKG}.evaluation.{module}", fromlist=["cli"]).cli
        argv = ["--inf_scp", str(inputs["inf.scp"]), "--model_path", str(stubs[stub])]
        if need_ref:
            argv += ["--ref_scp", str(inputs["ref.scp"])]
        argv += [extra[i] if i % 2 == 0 else str(inputs[extra[i]]) for i in range(len(extra))]
        scores = {}
        for dev in ("cuda", "cpu"):
            allocated = torch.cuda.memory_stats().get("allocation.all.allocated", 0)
            t = time.perf_counter()
            cli(argv + ["--device", dev, "--output_dir", str(root / f"{module}_{dev}")])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t
            on_card = torch.cuda.memory_stats().get("allocation.all.allocated", 0) - allocated
            if dev == "cuda" and on_card <= 0:
                fail(f"eval {module}: the --device cuda run allocated nothing on the card")
            scores[dev] = _scp_scores(root / f"{module}_{dev}" / f"{metric}.scp")
            print(f"[eval_clis] {module} --device {dev}: {scores[dev]} in {seconds:.2f} s "
                  f"({on_card} allocations on the card)")
        card, cpu = scores["cuda"], scores["cpu"]
        if isinstance(cpu["u0"], dict):
            if card != cpu:
                fail(f"eval {module}: card records {card} differ from the CPU's {cpu}")
            rel = 0.0
        else:
            rel = max(abs(card[u] - cpu[u]) / max(abs(cpu[u]), 1e-30) for u in cpu)
            if not all(np.isfinite(list(card.values()))) or rel > EVAL_TOL:
                fail(f"eval {module}: card {card} vs CPU {cpu}: rel {rel:.3e} > {EVAL_TOL}")
        result["card_vs_cpu"][module] = {"card": card, "cpu": cpu, "rel_err": rel}
    if result["card_vs_cpu"]["lid_accuracy"]["card"] != {"u0": 1.0, "u1": 1.0}:
        fail("eval lid_accuracy: the stub's languages were not scored as expected")

    for name, build in (("primary", dnsmos_standin.primary_graph),
                        ("p808", dnsmos_standin.p808_graph)):
        (root / f"{name}.onnx").write_bytes(build())
    env = {"inf_scp": str(inputs["inf.scp"]), "ref_scp": str(inputs["ref.scp"]),
           "output_dir": str(root / "suite"), "utt2lang": str(inputs["utt2lang"]),
           "text": str(inputs["text"]), "meta_tsv": str(inputs["meta.tsv"]), "nj": "1",
           "dnsmos_args": f"--primary_model {root / 'primary.onnx'} "
                          f"--p808_model {root / 'p808.onnx'}",
           "UTMOS_MODEL": str(stubs["mos_fs"]), "NISQA_MODEL": str(stubs["mos_fs"]),
           "SCOREQ_MODEL": str(stubs["mos"]), "SPK_MODEL": str(stubs["embed"]),
           "EMO_MODEL": str(stubs["embed"]), "LID_MODEL": str(stubs["lid"]),
           "WER_MODEL": str(stubs["asr"])}
    log = io.StringIO()  # the suite's output, breakdowns and all, goes to a file
    t = time.perf_counter()
    with contextlib.redirect_stdout(log):
        produced, skipped = eval_all.main([], environ=env)  # --device: cuda, the default
    seconds = time.perf_counter() - t
    (root / "eval_all.log").write_text(log.getvalue())
    print(f"[eval_clis] eval_all on the card in {seconds:.2f} s: produced {produced}, "
          f"skipped {skipped}")
    hub_only = ("speechbert_score", "phoneme_similarity")  # transformers routes, no stub
    expected = [name for name, *_ in eval_all.SUITE if name not in hub_only] + ["breakdown"]
    if [p for p in produced if p not in hub_only] != expected or not set(skipped) <= set(
            hub_only):
        fail(f"eval_all: produced {produced}, skipped {skipped}; expected {expected} and at "
             f"most {hub_only} skipped")
    suite_wer = _scp_scores(root / "suite" / "score" / "cer" / "WER.scp")
    if suite_wer != result["card_vs_cpu"]["wer"]["card"]:
        fail("eval_all: its WER records differ from the WER CLI's on the card")
    result["eval_all"] = {"produced": produced, "skipped": skipped, "seconds": seconds}

    ckpt_dir = workdir / "exp" / "chip_smoke" / "baseline" / "version_0" / "checkpoints"
    steps = sorted(int(p.stem[5:]) for p in ckpt_dir.glob("step_*.pt"))
    if len(steps) != 3:
        fail(f"average: the training phase left steps {steps} in {ckpt_dir}; expected three")
    info = average_checkpoints.main(["--ckpt_dir", str(ckpt_dir), "--output",
                                     str(root / "avg"), "--top_k", "3"])
    if info["steps"] != steps:
        fail(f"average: averaged {info['steps']} of {steps}")
    got = torch.load(info["path"], map_location="cpu", weights_only=True)["params"]
    states = [torch.load(ckpt_dir / f"step_{s}.pt", map_location="cpu",
                         weights_only=True)["params"] for s in steps]
    unequal = [k for k in got if not torch.equal(
        got[k], (sum(st[k].double() for st in states) / 3).to(got[k].dtype))]
    print(f"[eval_clis] averaged steps {info['steps']} -> {info['path']}: {len(got) - len(unequal)}"
          f" of {len(got)} tensors bitwise the float64 mean")
    if unequal:
        fail(f"average: {unequal[:3]} differ from the float64 mean of the three steps")
    items = (("avg16", 16000, 1.0),)
    scp = _write_inputs(root, items, "avg_in.scp", 20)
    t = time.perf_counter()
    inference.main(["--input_scp", str(scp), "--ckpt_path", str(root / "avg"),
                    "--output_dir", str(root / "avg_out"), "--device", "cuda"])
    torch.cuda.synchronize()
    _check_outputs(root / "avg_out", items)
    result["average"] = {"steps": info["steps"], "tensors": len(got),
                         "enhance_s": time.perf_counter() - t}
    print(f"[eval_clis] enhanced with the averaged checkpoint on the card in "
          f"{result['average']['enhance_s']:.2f} s; {gpu_name_and_power()}")
    return result


# ---------------------------------------------------------------------------
# flow and new-kernel times (phase 6)
# ---------------------------------------------------------------------------


def _bilstm_reference_ms(device, R, T, H, dtype, backward):
    """A bidirectional ``torch.nn.LSTM`` (N = H / 2 inputs, TF32 off) over R
    rows of T steps: its training forward, or (``backward``) the backward
    of its input and weight gradients; a superset of K9's or K10's work (it
    adds the W_ih products)."""
    import torch

    N = max(1, H // 2)
    lstm = torch.nn.LSTM(N, H, batch_first=True, bidirectional=True).to(device, dtype).train()
    x = (0.3 * torch.randn((R, T, N), device=device)).to(dtype).requires_grad_()
    if backward:
        y, _ = lstm(x)
        g = torch.randn_like(y)
        params = [x, *lstm.parameters()]
        ms = _time_ms(lambda: torch.autograd.grad(y, params, g, retain_graph=True), reps=3,
                      warmup=1)
        del y, g
    else:
        ms = _time_ms(lambda: lstm(x), reps=3, warmup=1)
    del lstm, x
    return ms


LIBRARY_K8_K10 = {
    "lstm_train_fwd_streamin": "torch.nn.LSTM one direction, training forward (K8's function)",
    "lstm_train_fwd2": "superset: bidirectional torch.nn.LSTM training forward (adds W_ih)",
    "lstm_train_bwd2": "superset: bidirectional torch.nn.LSTM backward, input and weight "
                       "gradients (adds W_ih)",
}


def _new_kernel_bounds(R, T, n_in, hid, dtype="bfloat16"):
    """Least time (ms) of K8-K10's work: K8 2 R T (N + H) 4H operations,
    reading x (N wide, not x_proj), W_ih, b and W_hh and writing h, gates and
    c; K9 and K10 twice the work of K4 and K5, so twice their bounds.
    ``dtype`` as ``_train_bounds``."""
    H, N, b = hid, n_in, (2 if dtype == "bfloat16" else 4)
    peak = PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_TF32_FLOPS
    train = _train_bounds(R, T, R * T, hid, dtype)
    (k4_ms, k4_by), (k5_ms, k5_by) = train["lstm_train_fwd"], train["lstm_train_bwd"]
    return {
        "lstm_train_fwd_streamin": _bound(
            2 * R * T * (N + H) * 4 * H,
            b * (R * T * N + N * 4 * H + 4 * H + H * 4 * H + 2 * R * T * H + R * T * 4 * H),
            peak),
        "lstm_train_fwd2": (2 * k4_ms, k4_by),
        "lstm_train_bwd2": (2 * k5_ms, k5_by),
    }


def _ab_route_launches(ab, name, route, dtype=None):
    """The launches of ``name`` on ``route`` over the A/B phase's arm steps
    (of the families in ``dtype``, or all)."""
    return sum(fam["routes"][name][route] for fam in ab.values()
               if dtype is None or fam["compute_dtype"] == dtype)


def _new_kernel_walk_records(rows, new_errs, wide_routes):
    """The records of K8's, K9's and K10's walks, bf16, from the times
    phase_streamin_bwd2_routes took beside K8p, K9p and K10p (the walk, the
    plain version, the PyTorch call: for K8 its function, a one-direction
    ``nn.LSTM`` training forward; for K9 and K10 a superset, the
    bidirectional one; the bound): K8 at the discriminative time path (R =
    136, T = 201), K9 and K10 at its band path (R = 804, T = 34), and the
    same at the flow training shapes (N = 384, H = 768: K8 at 96 x 251, K9
    and K10 at 502 x 48) as flow_* keys; the errors of phase_new_kernels.
    ``launches`` is the walk route's count in the wide float32 step
    (``phase_walk_route``, H = 1020): K8's under STREAM_INPUT_TRAIN, K9's
    and K10's under FUSED_BIDIR_TRAIN (K10 takes its one-direction pair
    there, so no step runs its walk)."""
    from urgent2026_challenge_track1_tpu_torch.ops import persistent_checks as PC

    def row(table, what, dt_name):
        return next(r for r in table if r["what"] == what and r["dtype"] == dt_name)

    out = []
    for name, table, disc, flow, run in (
            ("lstm_train_fwd_streamin", None, "disc time B=4", "flow time B=2",
             WIDE_STREAM_RUN),
            ("lstm_train_fwd2", rows["k9p"], "disc band B=4", "flow band B=2", WIDE_FUSED_RUN),
            ("lstm_train_bwd2", rows["k10p"], "disc band B=4", "flow band B=2",
             WIDE_FUSED_RUN + " (its one-direction pair there)")):
        bf16, f32 = ((rows["k8p"], rows["k8p_f32"]) if table is None else (table, table))
        d, f = row(bf16, disc, "bfloat16"), row(bf16, flow, "bfloat16")
        d32, f32r = row(f32, disc, "float32"), row(f32, flow, "float32")
        e_abs, e_rel = new_errs[name, "bfloat16"]
        out.append({
            "name": name, "route": "cuda", "source": f"{PKG}/csrc/lstm_kernels.cu",
            "replaces": REPLACES[name], "route_of_kernel": "walk",
            "launches": wide_routes[name]["walk"], "launches_run": run + " (the walk)",
            "max_abs_err": e_abs, "max_rel_err": e_rel,
            "max_abs_err_f32": new_errs[name, "float32"][0],
            "max_rel_err_f32": new_errs[name, "float32"][1],
            "tolerance": BF16_TOL,
            "tolerance_f32": GRAD_TOL if name.endswith("bwd2") else PC.WALK_F32_TOL,
            "ms": d["walk_ms"], "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
            "bound_by": d["bound_by"], "library_ms": d["library_ms"],
            "library_ms_f32": d32["library_ms"], "library": LIBRARY_K8_K10[name],
            "shape": {k: d[k] for k in ("R", "T", "N", "H") if k in d}, "dtype": "bfloat16",
            "flow_ms": f["walk_ms"], "flow_plain_ms": f["plain_ms"],
            "flow_bound_ms": f["bound_ms"], "flow_bound_by": f["bound_by"],
            "flow_library_ms": f["library_ms"], "flow_library_ms_f32": f32r["library_ms"],
            "flow_shape": {k: f[k] for k in ("R", "T", "N", "H") if k in f},
            "times_from": "k8p/k10p routes phase (the walk timed beside the persistent route)",
        })
    return out


def _k1_f32_record(rows, train_routes, flow_routes, validation, flow_validation):
    """K1p-f32's record from phase_k1_f32_routes: times at the disc band
    (the flow band's beside them as flow_* keys, where it runs a launch a
    direction), the worst error, limit ratio, planted fault and TF32
    control over every shape; ``launches`` is its count on the float32
    training path (its validations: one grid a call), ``flow_launches`` on
    the float32 flow training path (a launch a direction), and the timed
    validation passes' K1 routes."""
    from urgent2026_challenge_track1_tpu_torch.ops import persistent_checks as PC

    by_what = {r["what"]: r for r in rows}
    d, f = by_what["disc band B=1"], by_what["flow band B=2"]
    return {
        "name": "fusedin_bilstm_persistent_f32", "route": "cuda", "route_of_kernel": "persistent",
        "source": f"{PKG}/csrc/lstm_persistent.cu", "replaces": REPLACES["fusedin_bilstm"],
        "launches": train_routes["fusedin_bilstm"]["persistent"],
        "launches_run": "training path (float32 validation: K1p-f32, one grid a call)",
        "flow_launches": flow_routes["fusedin_bilstm"]["persistent_split"],
        "flow_launches_run": "flow training path (float32 validation: a launch a direction)",
        "validation_pass_routes": {"disc": validation["routes"]["fusedin_bilstm"],
                                   "flow": flow_validation["routes"]["fusedin_bilstm"]},
        "max_abs_err": max(r["max_abs_err_vs_plain"] for r in rows),
        "max_err_over_limit": max(r["max_err_over_limit"] for r in rows),
        "tolerance": PC.F32_LIMIT, "tolerance_rule": "F32_LIMIT, absolute, per shape",
        "planted_stale_h_over_limit": min(r["planted_stale_h_over_limit"] for r in rows),
        "tf32_control_over_limit": min(r["tf32_control_over_limit"] for r in rows),
        "bitwise_repeat": all(r["bitwise_repeat"] for r in rows),
        "ms": d["ms"], "plain_ms": d["plain_ms"], "walk_ms": d["walk_ms"],
        "bound_ms": d["bound_ms"], "bound_by": d["bound_by"], "library_ms": d["cudnn_ms"],
        "library": "torch.nn.LSTM bidirectional, float32, TF32 off (cuDNN), inference",
        "shape": {k: d[k] for k in ("R", "T", "N", "H")}, "dtype": "float32", "plan": d["plan"],
        **{f"flow_{k}": f[k] for k in ("ms", "plain_ms", "walk_ms", "bound_ms", "bound_by",
                                       "cudnn_ms", "plan")},
        "flow_shape": {k: f[k] for k in ("R", "T", "N", "H")},
        "route_table": rows,
    }


def _scan_f32_records(rows, train_routes, flow_routes, validation, flow_validation):
    """K2p-f32's and K3p-f32's records from phase_scan_f32_routes: times at
    the disc validation pass's time path (136 x 201; the flow validation
    pass's, 96 x 251, beside them as flow_* keys), the worst error, limit
    ratio, planted fault and TF32 control over every shape; ``launches`` is
    the count on the float32 training path (its validations),
    ``flow_launches`` on the float32 flow training path, and the timed
    validation passes' routes."""
    from urgent2026_challenge_track1_tpu_torch.ops import persistent_checks as PC

    by_what = {r["what"]: r for r in rows}
    d, f = by_what["disc CLI batch B=4"], by_what["flow validation B=2"]
    out = []
    for name in ("lstm_scan", "lstm_revmasked"):
        dn, fn = d[name], f[name]
        out.append({
            "name": f"{name}_persistent_f32", "route": "cuda", "route_of_kernel": "persistent",
            "source": f"{PKG}/csrc/lstm_persistent.cu", "replaces": REPLACES[name],
            "launches": train_routes[name]["persistent"],
            "launches_run": "training path (float32 validation)",
            "flow_launches": flow_routes[name]["persistent"],
            "flow_launches_run": "flow training path (float32 validation)",
            "validation_pass_routes": {"disc": validation["routes"][name],
                                       "flow": flow_validation["routes"][name]},
            "max_abs_err": max(r[name]["max_abs_err_vs_plain"] for r in rows),
            "max_err_over_limit": max(r[name]["max_err_over_limit"] for r in rows),
            "tolerance": PC.F32_LIMIT, "tolerance_rule": "F32_LIMIT, absolute, per shape",
            "planted_stale_h_over_limit": min(r[name]["planted_stale_h_over_limit"]
                                              for r in rows),
            "tf32_control_over_limit": min(r[name]["tf32_control_over_limit"] for r in rows),
            "bitwise_repeat": all(r[name]["bitwise_repeat"] for r in rows),
            "ms": dn["ms"], "plain_ms": dn["plain_ms"], "walk_ms": dn["walk_ms"],
            "bound_ms": dn["bound_ms"], "bound_by": dn["bound_by"], "library_ms": None,
            "reference_ms": d["nn_lstm_forward_ms"],
            "reference": "superset: adds the W_ih products (torch.nn.LSTM float32, TF32 off, "
                         "one direction, N = H / 2: an inference forward)",
            "shape": {"R": d["R"], "T": d["T"], "H": d["H"], "valid_steps": d["valid_steps"]},
            "dtype": "float32", "plan": d["plan"],
            **{f"flow_{k}": fn[k] for k in ("ms", "plain_ms", "walk_ms", "bound_ms", "bound_by")},
            "flow_reference_ms": f["nn_lstm_forward_ms"], "flow_plan": f["plan"],
            "flow_shape": {"R": f["R"], "T": f["T"], "H": f["H"], "valid_steps": f["valid_steps"]},
            "route_table": [{k: v for k, v in r.items()
                             if k not in ("lstm_scan", "lstm_revmasked") or k == name}
                            for r in rows],
        })
    return out


def _streamin_bwd2_records(rows, ab):
    """K8p's, K8p-f32's, K9p's, K9p-f32's, K10p's and K10p-f32's records
    from phase_streamin_bwd2_routes: times at the disc shape (the flow and
    bench-width shapes beside them as flow_* and bench_* keys, K8's band
    paths as band_* and flow_band_*), the worst error, limit ratio, planted
    fault, TF32 control and dW bound over every shape on that route; and a
    record of K10's one-direction pair at each shape that takes it (float32
    at the flow band).  ``launches`` is the route's count over the A/B
    phase's arm steps of the families in that dtype (one reset, one read),
    and the launches of one train step each family's first visit of each
    arm."""
    from urgent2026_challenge_track1_tpu_torch.ops import persistent_checks as PC

    per_step = {family: {arm: rec["launches"] for arm, rec in fam["arms"].items()}
                for family, fam in ab.items()}
    out = []
    for dt_name, suffix in (("bfloat16", ""), ("float32", "_f32")):
        f32 = dt_name == "float32"
        table = rows["k8p" + suffix]
        k8 = {r["what"]: r for r in table}
        runs = [r[tag] for r in table for tag in ("forward", "reverse")]
        d, f, w = k8["disc time B=4"], k8["flow time B=2"], k8["bench width"]
        others = [("band", k8["disc band B=4"]), ("flow", f), ("bench", w)]
        if f32:  # the flow family's band path, where its STREAM arm runs K8p-f32 too
            others.append(("flow_band", k8["flow band B=2"]))
        out.append({
            "name": f"lstm_train_fwd_streamin_persistent{suffix}", "route": "cuda",
            "route_of_kernel": "persistent", "source": f"{PKG}/csrc/lstm_persistent.cu",
            "replaces": REPLACES["lstm_train_fwd_streamin"],
            "launches": _ab_route_launches(ab, "lstm_train_fwd_streamin", "persistent", dt_name),
            "launches_run": f"a/b arms phase, {dt_name} families (K8p{suffix.replace('_', '-')} "
                            "route)",
            "max_abs_err": max(max(r["max_abs_err_vs_plain"].values()) for r in runs),
            "max_err_over_limit": max(r["max_err_over_limit"] for r in runs),
            "tolerance_rule": ("F32_LIMIT" if f32 else "4 bf16 ulps at max|plain|")
                              + " per output (h, gates, c), shape and direction",
            "planted_stale_h_over_limit": min(r["planted_stale_h_over_limit"] for r in runs),
            "tf32_control_over_limit": (min(r["tf32_control_over_limit"] for r in runs)
                                        if f32 else None),
            "bitwise_repeat": all(r["bitwise_repeat"] for r in runs),
            "ms": d["ms"], "plain_ms": d["plain_ms"], "walk_ms": d["walk_ms"],
            "k4p_addmm_ms": d["k4p_addmm_ms"], "bound_ms": d["bound_ms"],
            "bound_by": d["bound_by"], "library_ms": d["library_ms"],
            "library": LIBRARY_K8_K10["lstm_train_fwd_streamin"] + f", {dt_name}",
            "shape": {k: d[k] for k in ("R", "T", "N", "H")}, "dtype": dt_name, "plan": d["plan"],
            "launches_per_train_step": {fam: {arm: c.get("lstm_train_fwd_streamin", 0)
                                              for arm, c in arms.items()}
                                        for fam, arms in per_step.items()
                                        if ab[fam]["compute_dtype"] == dt_name},
            **{f"{key}_{k}": r[k] for key, r in others
               for k in ("ms", "plain_ms", "walk_ms", "k4p_addmm_ms", "bound_ms", "bound_by",
                         "library_ms", "plan")},
            **{f"{key}_shape": {k: r[k] for k in ("R", "T", "N", "H")} for key, r in others},
            "route_table": table,
        })
    for dt_name, suffix in (("bfloat16", ""), ("float32", "_f32")):
        f32 = dt_name == "float32"
        table = [r for r in rows["k9p"] if r["dtype"] == dt_name]
        runs = [r[tag] for r in table for tag in K10P_DIRS]
        by_what = {r["what"]: r for r in table}
        d = by_what["disc band B=4"]
        out.append({
            "name": f"lstm_train_fwd2_persistent{suffix}", "route": "cuda",
            "route_of_kernel": "persistent", "source": f"{PKG}/csrc/lstm_persistent.cu",
            "replaces": REPLACES["lstm_train_fwd2"],
            "kernel": "K4p's scan_persistent_kernel<T, REVERSE, false, true>, once a direction",
            "launches": _ab_route_launches(ab, "lstm_train_fwd2", "persistent", dt_name),
            "launches_run": f"a/b arms phase, {dt_name} families (K9p route, two a call)",
            "max_abs_err": max(max(r["max_abs_err_vs_plain"].values()) for r in runs),
            "max_err_over_limit": max(r["max_err_over_limit"] for r in runs),
            "tolerance_rule": ("F32_LIMIT" if f32 else "4 bf16 ulps at max|plain|")
                              + " per output (h, gates, c), shape and direction",
            "planted_stale_h_over_limit": min(r["planted_stale_h_over_limit"] for r in runs),
            "tf32_control_over_limit": (min(r["tf32_control_over_limit"] for r in runs)
                                        if f32 else None),
            "bitwise_repeat": all(r["bitwise_repeat"] for r in table),
            "equals_k4p_per_direction": all(r["equals_k4p_per_direction"] for r in table),
            "ms": d["ms"], "plain_ms": d["plain_ms"], "walk_ms": d["walk_ms"],
            "bound_ms": d["bound_ms"], "bound_by": d["bound_by"], "library_ms": d["library_ms"],
            "library": LIBRARY_K8_K10["lstm_train_fwd2"] + f", {dt_name}",
            "shape": {k: d[k] for k in ("R", "T", "H")}, "dtype": dt_name, "plan": d["plan"],
            "launches_per_train_step": {fam: {arm: c.get("lstm_train_fwd2", 0)
                                              for arm, c in arms.items()}
                                        for fam, arms in per_step.items()
                                        if ab[fam]["compute_dtype"] == dt_name},
            **{f"{key}_{k}": by_what[what][k] for key, what in (("flow", "flow band B=2"),
                                                               ("bench", "bench width"))
               for k in ("ms", "plain_ms", "walk_ms", "bound_ms", "bound_by", "library_ms",
                         "plan")},
            **{f"{key}_shape": {k: by_what[what][k] for k in ("R", "T", "H")}
               for key, what in (("flow", "flow band B=2"), ("bench", "bench width"))},
            "route_table": table,
        })
    for dt_name, suffix in (("bfloat16", ""), ("float32", "_f32")):
        f32 = dt_name == "float32"
        recs = [r for r in rows["k10p"] if r["dtype"] == dt_name]
        planned = [r for r in recs if r["route"] == "persistent"]
        runs = [r[tag] for r in planned for tag in K10P_DIRS]
        by_what = {r["what"]: r for r in recs}
        d = by_what["disc band B=4"]
        dw_bound = PC.DW_F32_BOUND if f32 else DW_BOUND
        rec = {
            "name": f"lstm_train_bwd2_persistent{suffix}", "route": "cuda",
            "route_of_kernel": "persistent", "source": f"{PKG}/csrc/lstm_persistent_bwd.cu",
            "replaces": REPLACES["lstm_train_bwd2"],
            "launches": _ab_route_launches(ab, "lstm_train_bwd2", "persistent", dt_name),
            "launches_run": f"a/b arms phase, {dt_name} families (K10p route)",
            "max_abs_err": max(r["max_abs_err_vs_plain"] for r in runs),
            "max_err_over_limit": max(r["max_err_over_limit"] for r in runs),
            "tolerance_rule": ("dx_proj: " + ("F32_BWD_LIMIT of max|plain|" if f32
                                              else "4 bf16 ulps at max|plain|")
                               + f" per direction and shape; dW: the dW kernel within {dw_bound} "
                               "|h_prev|^T |dx_proj| of the float64 product"),
            "planted_stale_dg_over_limit": min(r["planted_stale_dg_over_limit"] for r in runs),
            "tf32_control_over_limit": (min(r["tf32_control_over_limit"] for r in runs)
                                        if f32 else None),
            "dw_bound_ratio": max(r["dw_bound_ratio"] for r in runs),
            "dw_tf32_control_ratio": (min(r["dw_tf32_control_ratio"] for r in runs)
                                      if f32 else None),
            "dw_rel_err_vs_plain": max(r["dw_rel_err_vs_plain"] for r in runs),
            "bitwise_repeat": all(r["bitwise_repeat"] for r in planned),
            "equals_k5p_per_direction": all(r["equals_k5p_per_direction"] for r in planned),
            "ms": d["ms"], "plain_ms": d["plain_ms"], "walk_ms": d["walk_ms"],
            "k5p_pair_ms": d["k5p_pair_ms"],
            "bound_ms": d["bound_ms"], "bound_by": d["bound_by"], "library_ms": d["library_ms"],
            "library": LIBRARY_K8_K10["lstm_train_bwd2"] + f", {dt_name}",
            "shape": {k: d[k] for k in ("R", "T", "H")}, "dtype": dt_name, "plan": d["plan"],
            "launches_per_train_step": {fam: {arm: c.get("lstm_train_bwd2", 0)
                                              for arm, c in arms.items()}
                                        for fam, arms in per_step.items()
                                        if ab[fam]["compute_dtype"] == dt_name},
            "route_table": recs,
        }
        for key, what in (("flow", "flow band B=2"), ("bench", "bench width")):
            r = by_what[what]
            rec[f"{key}_route"] = r["route"]
            rec[f"{key}_shape"] = {k: r[k] for k in ("R", "T", "H")}
            for k in ("ms", "plain_ms", "walk_ms", "k5p_pair_ms", "bound_ms", "bound_by",
                      "library_ms", "plan"):
                rec[f"{key}_{k}"] = r.get(k) if r["route"] == "persistent" else None
        out.append(rec)
        for r in recs:  # K10's one-direction pair (float32 at the flow band)
            if r["route"] != "persistent_split":
                continue
            pair = [r[tag] for tag in K10P_DIRS]
            out.append({
                "name": f"lstm_train_bwd2_persistent_split{suffix}", "route": "cuda",
                "route_of_kernel": "persistent_split",
                "source": f"{PKG}/csrc/lstm_persistent_bwd.cu",
                "replaces": REPLACES["lstm_train_bwd2"],
                "kernel": "K5p's bwd_persistent_kernel<T, false> and the dW kernel, once a "
                          "direction on backward_route's plan",
                "launches": _ab_route_launches(ab, "lstm_train_bwd2", "persistent_split",
                                               dt_name),
                "launches_run": f"a/b arms phase, {dt_name} families (K10's one-direction "
                                "pair, two a call)",
                "max_abs_err": max(p["max_abs_err_vs_plain"] for p in pair),
                "max_err_over_limit": max(p["max_err_over_limit"] for p in pair),
                "tolerance_rule": rec["tolerance_rule"],
                "planted_stale_dg_over_limit": min(p["planted_stale_dg_over_limit"]
                                                   for p in pair),
                "tf32_control_over_limit": (min(p["tf32_control_over_limit"] for p in pair)
                                            if f32 else None),
                "dw_bound_ratio": max(p["dw_bound_ratio"] for p in pair),
                "dw_tf32_control_ratio": (min(p["dw_tf32_control_ratio"] for p in pair)
                                          if f32 else None),
                "dw_rel_err_vs_plain": max(p["dw_rel_err_vs_plain"] for p in pair),
                "bitwise_repeat": r["bitwise_repeat"],
                "equals_k5p_per_direction": r["equals_k5p_per_direction"],
                **{k: r[k] for k in ("ms", "plain_ms", "walk_ms", "k5p_pair_ms", "bound_ms",
                                     "bound_by", "library_ms", "plan")},
                "library": LIBRARY_K8_K10["lstm_train_bwd2"] + f", {dt_name}",
                "shape": {k: r[k] for k in ("R", "T", "H")}, "dtype": dt_name,
                "what": r["what"],
            })
    return out


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


# ---------------------------------------------------------------------------
# K2 with a carry, the causal streaming runtime and the server
# ---------------------------------------------------------------------------

# (what, R, T, H): the streaming step's time path (34 bands x 8 frames at
# 48 kHz, chunk_frames 8), the offline causal time path (34 x 401: 4 s),
# and the odd-H shapes of the card tests (2- and 4-byte copies of h0)
CARRY_SHAPES = (("stream step", 34, 8, HID), ("offline causal", 34, 401, HID),
                ("odd H", 13, 9, 37), ("H = 2 mod 4", 21, 7, 46))
# tag -> (dtype, route): K2p and K2p-f32 through the routed wrapper, and the
# float32 walk with a carry called by name (no shipped path below H = 1020
# takes it now)
CARRY_TAGS = {"lstm_scan_persistent_carry": ("bfloat16", "persistent"),
              "lstm_scan_persistent_carry_f32": ("float32", "persistent"),
              "lstm_scan_carry_f32": ("float32", "walk")}
BARRIER_US = 1.0  # one step's barrier round trip through L2 (PERF.md), the latency floor's unit


def _carry_bound(R, T, H, dtype):
    """Least time (ms) of K2 with a carry: ``_bounds``' K2 work plus the
    carry's bytes (h0 and hT in the compute dtype, c0 and cT float32);
    float32 at PEAK_TF32_FLOPS, as ``_train_bounds`` counts float32."""
    b = 2 if dtype == "bfloat16" else 4
    peak = PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_TF32_FLOPS
    return _bound(2 * R * H * 4 * H * T,
                  b * (R * T * 4 * H + H * 4 * H + R * T * H) + 2 * R * H * (b + 4), peak)


def _lstm_carry_reference_ms(device, R, T, H, dtype):
    """A one-direction ``torch.nn.LSTM`` inference forward from a given
    (h0, c0) (N = H / 2 inputs) over R rows of T steps in ``dtype``: a
    superset of K2 with a carry (it adds the W_ih products)."""
    import torch

    N = max(1, H // 2)
    lstm = torch.nn.LSTM(N, H, batch_first=True).to(device, dtype).eval()
    x = (0.3 * torch.randn((R, T, N), device=device)).to(dtype)
    h0 = (0.5 * torch.randn((1, R, H), device=device)).to(dtype)
    c0 = (0.5 * torch.randn((1, R, H), device=device)).to(dtype)
    with torch.inference_mode():
        ms = _time_ms(lambda: lstm(x, (h0, c0)))
    del lstm, x
    return ms


def phase_carry_routes(device):
    """K2 with a carry: K2p (bfloat16), K2p-f32 and the float32 walk, each
    started from a random (h0, c0) at the streaming step's, the offline
    causal and the odd-H shapes, held against the plain version by
    ``persistent_checks.scan_carry_report`` (h at every step, hT and cT
    within ``carry_limit``: 4 bf16 ulps on K2p, F32_LIMIT on K2p-f32, the K2
    walk's 2e-4 on the float32 walk; hT the kernel's own last h;
    ``lstm_scan_dropped_carry`` beyond the limit at every shape); ms of the
    kernel, its plain version and a one-direction ``nn.LSTM`` from (h0, c0)
    (a superset), the bound and the latency floor (T dependent steps); and
    whether 8-frame chunks chained through the carry give the one-launch
    offline result bitwise, which K2p and K2p-f32 must (their plans depend
    on R and H only)."""
    import torch
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K
    from urgent2026_challenge_track1_tpu_torch.ops import persistent_checks as PC

    sms = _sm_count(device)
    rows = []
    for what, R, T, H in CARRY_SHAPES:
        _, _, wh, _, xp, _ = _kernel_inputs(R, T, torch.bfloat16, device, R + T + H + 5, hid=H)
        gen = torch.Generator().manual_seed(R * T + H)
        h0, c0 = (0.5 * torch.randn((2, R, H), generator=gen)).unbind(0)
        rec = {"what": what, "R": R, "T": T, "H": H}
        for tag, (dt_name, route) in CARRY_TAGS.items():
            dtype = getattr(torch, dt_name)
            x, w = xp.to(dtype), wh[0].to(dtype).contiguous()
            carry = (h0.to(device, dtype), c0.to(device))
            plan = K.scan_route(dtype, R, H, sms)
            if plan is None:
                fail(f"K2 with a carry at {what}: the route rule takes the walk for {dt_name}")
            if route == "persistent":
                def kern(p=plan, x=x, w=w, carry=carry):
                    return K.lstm_scan_persistent(x, w, False, p, initial_state=carry,
                                                  return_state=True)

                def no_carry(p=plan, x=x, w=w):
                    return K.lstm_scan_persistent(x, w, False, p)
                fn = K.lstm_scan  # the route K2p / K2p-f32 serves
            else:
                def kern(x=x, w=w, carry=carry):
                    return K.lstm_scan_walk(x, w, False, carry, True)

                def no_carry(x=x, w=w):
                    return K.lstm_scan_walk(x, w)
                fn = K.lstm_scan_walk
            with torch.inference_mode():
                K.reset_launch_counts()
                got, state = kern()
                torch.cuda.synchronize()
                if K.route_counts("lstm_scan")[route] != 1:
                    fail(f"K2 with a carry ({tag}) at {what}: routes "
                         f"{K.route_counts('lstm_scan')}, expected one {route} launch")
                report = PC.scan_carry_report(got, state, x, w, False, carry,
                                              walk=route == "walk")
                bad = PC.carry_failures(report)
                if bad:
                    fail(f"K2 with a carry ({tag}) at {what}: " + "; ".join(bad))
                ms, ms_no_carry = _time_ms(kern), _time_ms(no_carry)
                plain_ms = _time_ms(lambda: K.lstm_scan_plain(x, w, False, carry, True), reps=3,
                                    warmup=1)
                # 8-frame chunks chained through the carry against one launch
                K.reset_launch_counts()
                one = fn(x, w)
                state_c, outs = None, []
                for t0 in range(0, T, 8):
                    y, state_c = fn(x[:, t0:t0 + 8].contiguous(), w, initial_state=state_c,
                                    return_state=True)
                    outs.append(y)
                chain_routes = K.route_counts("lstm_scan")
                chained = torch.cat(outs, dim=1)
                bitwise = bool(torch.equal(chained, one))
                chained_err = _err(chained, one)
                if chain_routes[route] != 1 + len(outs) or sum(chain_routes.values()) != (
                        1 + len(outs)):
                    fail(f"K2 with a carry ({tag}) at {what}: the chained chunks took "
                         f"{chain_routes}, expected {route} only")
                if route == "persistent" and not bitwise:
                    fail(f"K2 with a carry ({tag}) at {what}: 8-frame chunks chained through "
                         f"the carry differ from one launch by {chained_err:.3e}")
            bound_ms, bound_by = _carry_bound(R, T, H, dt_name)
            rec[tag] = {**report, "ms": ms, "ms_without_carry": ms_no_carry,
                        "us_per_step": ms * 1e3 / T, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "latency_floor_ms": T * BARRIER_US / 1e3 if route == "persistent" else None,
                        "reference_ms": _lstm_carry_reference_ms(device, R, T, H, dtype),
                        "chunks_of_8_bitwise_equal_one_launch": bitwise,
                        "chunks_of_8_max_abs_diff": chained_err,
                        "plan": None if route == "walk" else {
                            "S": plan.S, "G": plan.G, "U": plan.U, "rows": plan.rows,
                            "chunk": plan.chunk, "c_in_smem": plan.c_in_smem, "ctas": plan.ctas,
                            "elem": plan.elem}}
            r = rec[tag]
            print(f"[carry routes] {what} {tag} R={R} T={T} H={H}: {ms:.4f} ms "
                  f"({r['us_per_step']:.2f} us a step; without a carry {ms_no_carry:.4f} ms), "
                  f"plain {plain_ms:.3f} ms, bound "
                  f"{bound_ms:.5f} ms ({bound_by}), nn.LSTM (h0, c0) {r['reference_ms']:.4f} ms; "
                  f"max|h - plain| {report['h']:.3e}, |hT| {report['hT']:.3e}, |cT| "
                  f"{report['cT']:.3e} (limits {report['limit']:.3e}, {report['c_limit']:.3e}); "
                  f"dropped carry {report['dropped_carry']:.3e}; 8-frame chunks == one launch: "
                  f"{bitwise} (max|d| {chained_err:.3e})")
        rows.append(rec)
        del xp, wh
    print(f"[carry routes] card: {gpu_name_and_power()}")
    return rows


CAUSAL_MODEL = {"num_channel": N_IN, "num_layer": 6, "causal": True, "streaming_norm": True}
CAUSAL_SECONDS, CAUSAL_CHUNK = 4.0, 8  # 4 s at 48 kHz, 8 frames (80 ms) a step
CAUSAL_FEEDS = (4000, 7777, 480, 12345, 100, 9001)  # uneven feed sizes, cycled
STREAM_F32_RTOL, STREAM_F32_ATOL = 1e-4, 2e-5  # tests/test_streaming_causal.py:119
# two bfloat16 runs of one model on one input that differ only in the row
# counts the kernels see (a stream's 8-row band steps against the offline
# forward's 401; the server's padded batch against one request), max abs
# difference of the waveforms.  Each lies within the bf16-vs-f32 gap of the
# float32 output, so they differ by at most about twice that gap (5.9e-4
# offline on the H100, PERF.md); the bound doubles that again.  Each check
# also runs its control, a fault that the bound must see: the stream with
# layer 0's time-LSTM carry dropped at every step, the server's input
# enhanced without its length.
E2E_BF16_BOUND = 2e-3


def _stream(session, wav, feeds=CAUSAL_FEEDS):
    """``wav`` (1, n) through ``session`` in the uneven feed sizes, then the
    flush; returns the output (1, n)."""
    import numpy as np

    outs, i, k = [], 0, 0
    while i < wav.shape[-1]:
        n = feeds[k % len(feeds)]
        outs.append(session.feed(wav[:, i:i + n]))
        i, k = i + n, k + 1
    outs.append(session.flush())
    return np.concatenate(outs, axis=-1)


def _cuda_kernels_in(fn):
    """Device kernels one call of ``fn`` launches, by ``torch.profiler``
    (None when the trace holds no device events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    return n or None


def phase_causal(workdir: Path, device):
    """A causal ``streaming_norm`` model at full width (BSRNN_baseline.yaml,
    196 x 6, random seeded weights): 3 float32 train steps on the card
    (B=4, 2 s at 48 kHz; the time path through LSTMDirTrain: K4p-f32,
    K5p-f32 and dW-f32, no K6/K7, none of K1-K3), a checkpoint saved and
    loaded back for inference (bfloat16); a StreamingSession over 4 s at 48
    kHz in 8-frame chunks and uneven feeds against the offline causal
    forward, in float32 (rtol 1e-4, atol 2e-5, JAX's streaming tolerance)
    and in bfloat16 (E2E_BF16_BOUND: the same kernels, but the cumulative
    norms' sums run in another order in chunks, which moves bf16 roundings,
    and K1p walks 8 rows a step instead of 401; the control, the stream
    with layer 0's time-LSTM carry dropped at every step, must exceed it);
    the card against the CPU in float32
    for the offline and the streamed output of the first second; per-step
    wall time (median, p95) against the chunk's 80 ms and the launches a
    step.  Returns (checkpoint path, stream input, bfloat16 stream output,
    record)."""
    import copy

    import numpy as np
    import torch
    from urgent2026_challenge_track1_tpu_torch.dsp.stft import STFTConfig
    from urgent2026_challenge_track1_tpu_torch.models import bsrnn as B
    from urgent2026_challenge_track1_tpu_torch.models.streaming_causal import StreamingSession
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K
    from urgent2026_challenge_track1_tpu_torch.train import trainer
    from urgent2026_challenge_track1_tpu_torch.utils.checkpoint import (
        load_model_for_inference, save_model)

    rec = {}
    cfg = _train_config(workdir, model_configs=dict(CAUSAL_MODEL))
    bundle = trainer.build_model(cfg)
    if not (bundle.model_cfg.causal and bundle.model_cfg.streaming_norm):
        fail(f"the causal config built {bundle.model_cfg}")
    model = trainer.init_params(cfg.seed, bundle, device)
    step = trainer.make_train_step(bundle, cfg, 48000)
    opt = trainer.make_optimizer(cfg, model)
    batch = _train_batch(device, B=4)
    per_layer = B.CAUSAL_TRAIN_LAUNCHES_PER_LAYER
    steps = []
    for i in range(3):
        K.reset_launch_counts()
        t0 = time.perf_counter()
        m = step(model, opt, *batch)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts, routes = K.launch_counts(), _routes()
        if not bool(torch.isfinite(m["loss"])) or m["nan_grad"]:
            fail(f"causal train step {i}: loss {float(m['loss'])}, nan_grad {m['nan_grad']}")
        _check_no_lean_kernels("the causal train step", counts)
        for name in ("lstm_revmasked_train_fwd", "lstm_revmasked_bwd"):
            if counts[name]:
                fail(f"the causal train step launched {name} {counts[name]} times (no reverse "
                     "time direction)")
        for name in ("lstm_train_fwd", "lstm_train_bwd"):
            want = per_layer[name] * CAUSAL_MODEL["num_layer"]
            if routes[name] != {"persistent": want, "walk": 0}:
                fail(f"the causal f32 train step: {name} routes {routes[name]}, expected "
                     f"{want} on the persistent route (K4p-f32 / K5p-f32)")
        dw = _check_dw_launches("the causal train step", routes)
        steps.append({"loss": float(m["loss"]), "seconds": seconds,
                      "K4p_f32": routes["lstm_train_fwd"]["persistent"],
                      "K5p_f32": routes["lstm_train_bwd"]["persistent"], "dW_f32": dw})
    print(f"[causal] 3 float32 train steps (196 x 6 causal streaming_norm, B=4, 2 s at "
          f"48 kHz): {steps}")
    rec["train_steps"] = steps

    stft = STFTConfig()
    ckpt = workdir / "causal_196x6.pt"
    save_model(str(ckpt), model, stft)
    kind, served, scfg, sstft = load_model_for_inference(str(ckpt), "cuda")
    if not (kind == "discriminative" and scfg.causal and scfg.streaming_norm
            and scfg.compute_dtype == "bfloat16"):
        fail(f"the causal checkpoint loaded as {kind} {scfg}")
    model.eval()
    fs = 48000
    n = int(CAUSAL_SECONDS * fs)
    t = np.arange(n) / fs
    rng = np.random.default_rng(21)
    wav = (0.3 * np.sin(2 * np.pi * 220.0 * t) + 0.05 * rng.standard_normal(n)).astype(
        np.float32)[None]
    x = torch.from_numpy(wav).to(device)

    # float32: the trained model, streamed and offline on the card
    K.reset_launch_counts()
    with torch.inference_mode():
        off32 = B.bsrnn_se_apply(model, stft, x, fs)[0].cpu().numpy()
    rec["f32_offline_launches"] = _routes()["lstm_scan"]
    K.reset_launch_counts()
    f32_sess = StreamingSession(model, model.cfg, stft, fs, chunk_frames=CAUSAL_CHUNK)
    f32_step_ms = []
    f32_inner = f32_sess._step

    def f32_timed_step(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = f32_inner(*args)
        torch.cuda.synchronize()
        f32_step_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    f32_sess._step = f32_timed_step
    st32 = _stream(f32_sess, wav)
    # every K2 launch of a stream carries (h, c): the stream's lstm_scan routes
    rec["f32_launches"] = {**_routes()["lstm_scan"], "steps": len(f32_step_ms)}
    rec["f32_step_ms_median"] = statistics.median(f32_step_ms)
    rec["f32_step_ms_p95"] = float(np.percentile(f32_step_ms, 95))
    if st32.shape != wav.shape or not np.isfinite(st32).all():
        fail(f"the float32 stream gave {st32.shape}, finite {np.isfinite(st32).all()}")
    d32 = float(np.abs(st32 - off32).max())
    ok32 = np.allclose(st32, off32, rtol=STREAM_F32_RTOL, atol=STREAM_F32_ATOL)
    print(f"[causal] float32 stream vs offline on the card: max|d| {d32:.3e} (rtol "
          f"{STREAM_F32_RTOL}, atol {STREAM_F32_ATOL}), K2 launches {rec['f32_launches']}; "
          f"step wall time median {rec['f32_step_ms_median']:.2f} ms, p95 "
          f"{rec['f32_step_ms_p95']:.2f} ms ({gpu_name_and_power()})")
    if not ok32:
        fail(f"the float32 stream differs from the offline forward by {d32:.3e}")
    f32_carry, f32_steps = rec["f32_launches"], rec["f32_launches"]["steps"]
    if f32_carry["persistent"] != CAUSAL_MODEL["num_layer"] * f32_steps or f32_carry["walk"]:
        fail(f"the float32 stream ran K2 with a carry {f32_carry}; expected K2p-f32 once per "
             "layer and step")

    # bfloat16: the loaded checkpoint, as a server runs it
    sess = StreamingSession(served, scfg, sstft, fs, chunk_frames=CAUSAL_CHUNK)
    step_ms = []
    inner = sess._step

    def timed_step(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*args)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    sess._step = timed_step
    K.reset_launch_counts()
    st16 = _stream(sess, wav)
    counts, routes = K.launch_counts(), _routes()
    carry = routes["lstm_scan"]  # every K2 launch of a stream carries (h, c)
    n_steps = len(step_ms)
    K.reset_launch_counts()
    with torch.inference_mode():
        off16 = B.bsrnn_se_apply(served, sstft, x, fs)[0].cpu().numpy()
    rec["bf16_offline_launches"] = _routes()["lstm_scan"]
    d16 = float(np.abs(st16 - off16).max())
    d16_vs_f32 = float(np.abs(off16 - off32).max())
    # the control: the same stream with layer 0's time-LSTM carry dropped
    ctl = StreamingSession(served, scfg, sstft, fs, chunk_frames=CAUSAL_CHUNK)
    ctl_inner = ctl._step

    def dropped_carry_step(model, state, chunk, n_valid):
        with torch.inference_mode():
            h, c = state["model"]["layers"]["rnn_time"]
            rnn_time = (torch.cat([torch.zeros_like(h[:1]), h[1:]]),
                        torch.cat([torch.zeros_like(c[:1]), c[1:]]))
        layers = {**state["model"]["layers"], "rnn_time": rnn_time}
        return ctl_inner(model, {**state, "model": {**state["model"], "layers": layers}},
                         chunk, n_valid)

    ctl._step = dropped_carry_step
    d16_ctl = float(np.abs(_stream(ctl, wav) - off16).max())
    print(f"[causal] bfloat16 stream vs offline on the card: max|d| {d16:.3e} (bound "
          f"{E2E_BF16_BOUND}); control, layer 0's carry dropped at every step: max|d| "
          f"{d16_ctl:.3e}; bf16 offline vs f32 offline max|d| {d16_vs_f32:.3e}")
    if st16.shape != wav.shape or not np.isfinite(st16).all() or not d16 < E2E_BF16_BOUND:
        fail(f"the bfloat16 stream: shape {st16.shape}, max|d| vs offline {d16:.3e}")
    if not d16_ctl >= E2E_BF16_BOUND:
        fail(f"a dropped carry moves the bfloat16 stream by {d16_ctl:.3e}, under the bound "
             f"{E2E_BF16_BOUND}: the check cannot see a carry fault")
    if carry["persistent"] != CAUSAL_MODEL["num_layer"] * n_steps or carry["walk"]:
        fail(f"the bfloat16 stream ran K2 with a carry {carry} over {n_steps} steps; expected "
             f"K2p once per layer and step")
    if routes["lstm_scan"]["walk"] or routes["fusedin_bilstm"]["walk"]:
        fail(f"the bfloat16 stream took a walk: {routes}")
    if any(counts[name] for name in ("lstm_revmasked",) + TRAIN_ROUTED):
        fail(f"the bfloat16 stream launched {counts}")
    k1_plan = K.k1_route(torch.bfloat16, CAUSAL_CHUNK, N_IN, HID, _sm_count(device))
    med, p95 = statistics.median(step_ms), float(np.percentile(step_ms, 95))
    with torch.inference_mode():
        state = sess._state
        chunk = torch.zeros((1, CAUSAL_CHUNK * sess.hop), device=device)
        kernels_per_step = _cuda_kernels_in(lambda: inner(served, state, chunk, CAUSAL_CHUNK))
    chunk_ms = CAUSAL_CHUNK * sess.hop / fs * 1e3
    rec.update({"stream_steps": n_steps, "step_ms_median": med, "step_ms_p95": p95,
                "chunk_ms": chunk_ms, "bf16_stream_vs_offline": d16,
                "bf16_dropped_carry_vs_offline": d16_ctl,
                "f32_stream_vs_offline": d32, "bf16_vs_f32_offline": d16_vs_f32,
                "launches": {"K2p_carry": carry["persistent"],
                             "K1p": routes["fusedin_bilstm"]["persistent"],
                             "K1_walk": routes["fusedin_bilstm"]["walk"]},
                "launches_per_step": {"K2p_carry": carry["persistent"] / n_steps,
                                      "K1p": routes["fusedin_bilstm"]["persistent"] / n_steps,
                                      "K1_walk": routes["fusedin_bilstm"]["walk"] / n_steps,
                                      "cuda_kernels": kernels_per_step},
                "k1_band_plan_at_8_rows": None if k1_plan is None else {
                    "S": k1_plan.S, "G": k1_plan.G, "U": k1_plan.U, "chunk": k1_plan.chunk}})
    print(f"[causal] bfloat16 stream, 4 s at 48 kHz, 8 frames a step ({gpu_name_and_power()}): "
          f"{n_steps} steps, step wall time median {med:.2f} ms, p95 {p95:.2f} ms against the "
          f"chunk's {chunk_ms:.0f} ms; launches a step {rec['launches_per_step']}; K1p plan at 8 "
          f"rows: {rec['k1_band_plan_at_8_rows']}")

    # the card against the CPU, float32, over the first second
    cpu_model = copy.deepcopy(model).cpu()
    short = wav[:, :fs]
    with torch.inference_mode():
        off_card = B.bsrnn_se_apply(model, stft, torch.from_numpy(short).to(device), fs)[0]
        off_cpu = B.bsrnn_se_apply(cpu_model, stft, torch.from_numpy(short), fs)[0]
    e_off = float((off_card.cpu() - off_cpu).abs().max())
    st_card = _stream(StreamingSession(model, model.cfg, stft, fs, chunk_frames=CAUSAL_CHUNK),
                      short)
    st_cpu = _stream(StreamingSession(cpu_model, cpu_model.cfg, stft, fs,
                                      chunk_frames=CAUSAL_CHUNK), short)
    e_st = float(np.abs(st_card - st_cpu).max())
    print(f"[causal] card vs CPU, float32, 1 s at 48 kHz: offline max|d| {e_off:.3e}, streamed "
          f"max|d| {e_st:.3e} (tolerance {E2E_TOL})")
    if not (e_off < E2E_TOL and e_st < E2E_TOL):
        fail(f"the causal card and CPU outputs differ: offline {e_off:.3e}, streamed {e_st:.3e}")
    rec.update({"card_vs_cpu_offline": e_off, "card_vs_cpu_streamed": e_st})
    del model, cpu_model, served
    return ckpt, wav, st16, rec


# (fs, seconds, format) of the concurrent /enhance requests: two rates, two
# 1 s buckets at each, WAV and FLAC
SERVE_REQUESTS = ((48000, 1.3, "wav"), (48000, 0.7, "flac"), (48000, 1.6, "flac"),
                  (48000, 0.9, "wav"), (16000, 0.8, "flac"), (16000, 1.4, "wav"),
                  (16000, 0.6, "wav"), (16000, 1.7, "flac"))


def _post(port: int, path: str, body, headers=None):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request("POST", path, body=body, headers=headers or {},
                 encode_chunked=not isinstance(body, bytes))
    r = conn.getresponse()
    return r.status, dict(r.getheaders()), r.read()


def phase_serving(workdir: Path, device, causal):
    """The port's server (``serve.make_server`` on 127.0.0.1:0 in a thread)
    with the full-width discriminative checkpoint of the training phase and
    ``max_retries=0``: 8 concurrent POST /enhance (WAV and FLAC, 16 and 48
    kHz, two buckets at each rate) each against ``make_enhance_fn`` run
    directly on the decoded input (both peak-normalized, within
    E2E_BF16_BOUND: the same bf16 kernels on other row counts, while the
    input enhanced without its length, the control, must exceed it); /stats (a batch of more than
    one request, errors 0, retries 0); /healthz (CUDA and the card); then
    one POST /stream to a second server on the causal checkpoint, whose
    output must equal ``phase_causal``'s bfloat16 StreamingSession output.
    Returns the record."""
    import glob
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    from urgent2026_challenge_track1_tpu_torch import serve
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K
    from urgent2026_challenge_track1_tpu_torch.serving import BatchingEngine, make_enhance_fn
    from urgent2026_challenge_track1_tpu_torch.utils import audio_io, flac
    from urgent2026_challenge_track1_tpu_torch.utils.checkpoint import load_model_for_inference

    ckpts = sorted(glob.glob(str(workdir / "exp" / "chip_smoke" / "baseline" / "*" /
                                 "checkpoints_last" / "step_*.pt")))
    if not ckpts:
        fail("no checkpoint of the training phase to serve")
    name = torch.cuda.get_device_name(device)
    kind, model, mcfg, stft = load_model_for_inference(ckpts[-1], "cuda")
    enhance = make_enhance_fn(kind, model, mcfg, stft)
    engine = BatchingEngine(enhance, max_batch=8, max_wait_ms=200, max_retries=0)
    server = serve.make_server(engine, "127.0.0.1", 0, platform=str(device), device_name=name)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    rng = np.random.default_rng(31)
    bodies = []
    for fs, sec, fmt in SERVE_REQUESTS:
        n = int(sec * fs)
        w = (0.3 * np.sin(2 * np.pi * rng.uniform(150, 400) * np.arange(n) / fs)
             + 0.05 * rng.standard_normal(n)).astype(np.float32)
        bodies.append(flac.encode(w, fs, bits=16) if fmt == "flac"
                      else audio_io.write_bytes(w, fs, subtype="FLOAT"))
    rec = {}
    try:
        def one(body):
            t0 = time.perf_counter()
            status, headers, data = _post(port, "/enhance?subtype=FLOAT", body)
            return status, data, (time.perf_counter() - t0) * 1e3

        K.reset_launch_counts()
        with ThreadPoolExecutor(len(bodies)) as pool:
            results = list(pool.map(one, bodies))
        torch.cuda.synchronize()
        routes = _routes()
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read())
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        errs, ctl_errs = [], []

        def normalized(y):
            y = y.float().cpu().numpy()[0, :len(x)]
            return y / (np.abs(y).max() or 1.0) * 0.9

        for (fs, sec, fmt), body, (status, data, ms) in zip(SERVE_REQUESTS, bodies, results):
            if status != 200:
                fail(f"/enhance {fs} Hz {sec} s {fmt}: status {status}: {data[:200]!r}")
            y, yfs = audio_io.read_bytes(data)
            x, _ = audio_io.read_bytes(body)
            x = x.astype(np.float32)
            bucket = -(-len(x) // fs) * fs
            xb = np.zeros((1, bucket), np.float32)
            xb[0, :len(x)] = x
            xd = torch.from_numpy(xb).to(device)
            ref = normalized(enhance(xd, fs, torch.tensor([len(x)], dtype=torch.int32,
                                                          device=device)))
            ctl_errs.append(float(np.abs(normalized(enhance(xd, fs)) - ref).max()))
            if yfs != fs or y.shape != x.shape or not np.isfinite(y).all():
                fail(f"/enhance {fs} Hz {sec} s {fmt}: got {y.shape} at {yfs}")
            errs.append(float(np.abs(y - ref).max()))
        lat = [r[2] for r in results]
        rec = {"requests": len(results), "latency_ms_p50": float(np.median(lat)),
               "latency_ms_max": float(np.max(lat)), "max_abs_err_vs_direct": max(errs),
               "control_without_length_max_abs_err": max(ctl_errs),
               "stats": stats, "health": health, "routes": routes}
        print(f"[serving] ({gpu_name_and_power()}) {len(results)} concurrent /enhance: latency p50 "
              f"{rec['latency_ms_p50']:.1f} ms, max {rec['latency_ms_max']:.1f} ms; max|server "
              f"- direct| {max(errs):.3e} (bound {E2E_BF16_BOUND}; control, without the length: "
              f"{max(ctl_errs):.3e}); /stats {stats}; /healthz {health}; routes {routes}")
        if not max(errs) < E2E_BF16_BOUND:
            fail(f"/enhance outputs differ from make_enhance_fn by {max(errs):.3e}")
        if not max(ctl_errs) >= E2E_BF16_BOUND:
            fail(f"dropping the length moves /enhance by {max(ctl_errs):.3e}, under the bound "
                 f"{E2E_BF16_BOUND}: the check cannot see a length fault")
        if stats["errors"] or stats["retries"] or stats["requests"] != len(results):
            fail(f"/stats after the requests: {stats}")
        if not stats["batched_requests"] > stats["batches"]:
            fail(f"no batch of more than one request: {stats}")
        if "cuda" not in health["platform"] or health["device"] != name:
            fail(f"/healthz names {health}, not CUDA and {name}")
        _check_routes("the server's /enhance", "bfloat16", routes)
    finally:
        server.shutdown()
        server.server_close()
        engine.close()

    ckpt, wav, st16, _ = causal
    kind, cmodel, ccfg, cstft = load_model_for_inference(str(ckpt), "cuda")
    streamer = serve.make_streamer(kind, cmodel, ccfg, cstft)
    if streamer is None:
        fail("the causal checkpoint did not enable /stream")
    server = serve.make_server(_NoEngine(), "127.0.0.1", 0, platform=str(device),
                               device_name=name, streamer=streamer,
                               stream_chunk_frames=CAUSAL_CHUNK)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        raw = wav[0].astype("<f4").tobytes()
        parts = (raw[i:i + 19200] for i in range(0, len(raw), 19200))
        t0 = time.perf_counter()
        status, headers, data = _post(server.server_address[1],
                                      f"/stream?fs=48000&chunk_frames={CAUSAL_CHUNK}", parts,
                                      {"Transfer-Encoding": "chunked"})
        seconds = time.perf_counter() - t0
    finally:
        server.shutdown()
        server.server_close()
    if status != 200:
        fail(f"/stream: status {status}: {data[:200]!r}")
    out = np.frombuffer(data, "<f4")
    d = float(np.abs(out - st16[0]).max()) if out.shape == st16[0].shape else float("inf")
    print(f"[serving] POST /stream, 4 s at 48 kHz in {seconds:.2f} s: {out.shape[0]} samples, "
          f"max|d| vs the StreamingSession {d:.3e}")
    if not d <= 1e-6:
        fail(f"/stream output differs from the StreamingSession by {d:.3e}")
    rec.update({"stream_seconds": seconds, "stream_vs_session": d})
    return rec


class _NoEngine:
    """The /stream server's engine: /stream never batches."""

    def snapshot(self):
        return {}

    def enhance_sync(self, wav, fs, timeout=None):
        fail("/stream reached the batching engine")


def _carry_records(carry_rows, causal_rec):
    """The kernels line's records of K2 with a carry: K2p (bfloat16),
    K2p-f32 and the float32 walk; times at the streaming step's shape
    (``ms_offline`` at the offline causal one); launches from phase_causal's
    streams (the bf16 stream for K2p, the float32 stream for K2p-f32 and the
    walk, which no stream below H = 1020 takes now)."""
    stream, offline = carry_rows[0], carry_rows[1]
    out = []
    for tag, (dt_name, route) in CARRY_TAGS.items():
        s, o = stream[tag], offline[tag]
        persistent = route == "persistent"
        f32 = dt_name == "float32"
        launches = (causal_rec["f32_launches"][route] if f32
                    else causal_rec["launches"]["K2p_carry"])
        out.append({
            "name": tag, "route": "cuda", "route_of_kernel": route,
            "source": f"{PKG}/csrc/{'lstm_persistent.cu' if persistent else 'lstm_kernels.cu'}",
            "replaces": REPLACES["lstm_scan"],
            "launches": launches,
            "launches_run": ("the float32 StreamingSession, 4 s at 48 kHz, 8 frames a step"
                             if f32 else
                             "the bfloat16 StreamingSession, 4 s at 48 kHz, 8 frames a step"),
            "launches_per_stream_step": launches / (causal_rec["f32_launches"]["steps"] if f32
                                                    else causal_rec["stream_steps"]),
            # the offline causal forward runs K2 without a carry, on the same route
            "offline_causal_forward_launches_without_carry": causal_rec[
                "f32_offline_launches" if f32 else "bf16_offline_launches"],
            "max_abs_err": max(r[tag]["h"] for r in carry_rows),
            "max_abs_err_hT": max(r[tag]["hT"] for r in carry_rows),
            "max_abs_err_cT": max(r[tag]["cT"] for r in carry_rows),
            "tolerance": min(r[tag]["limit"] for r in carry_rows),
            "dropped_carry_err": min(r[tag]["dropped_carry"] for r in carry_rows),
            "ms": s["ms"], "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": None,
            "ms_without_carry": s["ms_without_carry"],
            "ms_offline_without_carry": o["ms_without_carry"],
            "reference_ms": s["reference_ms"],
            "reference": "superset: torch.nn.LSTM from (h0, c0), one direction, N = H / 2 "
                         "(adds the W_ih products)",
            "latency_floor_ms": s["latency_floor_ms"],
            "ms_offline": o["ms"], "plain_ms_offline": o["plain_ms"],
            "bound_ms_offline": o["bound_ms"], "reference_ms_offline": o["reference_ms"],
            "latency_floor_ms_offline": o["latency_floor_ms"],
            "chunks_of_8_bitwise_equal_one_launch": o["chunks_of_8_bitwise_equal_one_launch"],
            "shape": {"R": stream["R"], "T": stream["T"], "H": stream["H"],
                      "T_offline": offline["T"]},
            "dtype": dt_name, "plan": s["plan"],
            # the whole stream step's wall time (every layer, on the host's clock)
            "stream_step_ms_median": causal_rec["f32_step_ms_median" if f32
                                                else "step_ms_median"],
            "stream_step_ms_p95": causal_rec["f32_step_ms_p95" if f32 else "step_ms_p95"],
        })
    return out


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


# ---------------------------------------------------------------------------
# dp x mp parallelism (phase_parallel)
# ---------------------------------------------------------------------------

PAR_FS = 48000
PAR_SECONDS = (4.0, 3.7)    # the sharded enhancements' batch, with lengths
PAR_NFE = 15                # flow sampler steps of the sharded flow enhancement
PAR_F32_LIMIT = 1e-5        # float32 waveform, sharded vs one process: rows are independent
# one train step, sharded vs one process on the same global batch: the JAX
# test's limits (tests/test_model_parallel.py:129-134)
PAR_LOSS_RTOL, PAR_PARAM_ATOL = 1e-5, 2e-5
# and the grad norm, which sees a gradient scaled by a constant where
# AdamW's first update (about lr * sign(g)) does not: the limit of the CPU
# tests against the JAX step
PAR_GNORM_RTOL = 1e-5
# (b)'s checks, in the order every rank runs them: (name, mesh, family,
# dtype) for the enhancements, (name, mesh, family, global batch) for the
# float32 train steps
PAR_ENHANCE = (("disc f32", "dp=1,mp=2", "disc", "float32"),
               ("disc bf16", "dp=1,mp=2", "disc", "bfloat16"),
               ("flow bf16", "dp=1,mp=2", "flow", "bfloat16"))
PAR_TRAIN = (("disc step dp=2", "dp=2", "disc", 4),
             ("disc step mp=2", "dp=1,mp=2", "disc", 2),
             ("flow step dp=2", "dp=2", "flow", 2))


def _ran(routes) -> dict:
    """The launches of ``_routes()`` that happened: {kernel: {route: n > 0}}."""
    return {k: {r: n for r, n in v.items() if n} for k, v in routes.items() if any(v.values())}


def _par_batch(device):
    """The enhancement batch: B = 2 at 48 kHz, PAR_SECONDS of signal."""
    import torch

    gen = torch.Generator().manual_seed(21)
    noisy = torch.zeros((len(PAR_SECONDS), int(max(PAR_SECONDS) * PAR_FS)))
    lengths = torch.tensor([int(s * PAR_FS) for s in PAR_SECONDS], dtype=torch.int32)
    for i, n in enumerate(lengths.tolist()):
        noisy[i, :n] = 0.1 * torch.randn(n, generator=gen)
    return noisy.to(device), lengths.to(device)


def _par_model(device, family, dtype):
    """The full-width model of ``family`` (196 x 6, or the flow model's 384 x
    6) in ``dtype``, seeded weights; (model, model_cfg, stft_cfg)."""
    from urgent2026_challenge_track1_tpu_torch.dsp.stft import STFTConfig
    from urgent2026_challenge_track1_tpu_torch.models import bsrnn_flowse as F
    from urgent2026_challenge_track1_tpu_torch.models.bsrnn import BSRNNConfig, init_bsrnn

    if family == "flow":
        cfg = F.FlowSEConfig(bsrnn_hidden=FLOW_N, num_layer=6, compute_dtype=dtype)
        return F.init_flowse(cfg, seed=0, device=device), cfg, cfg.stft_cfg
    cfg = BSRNNConfig(num_channel=N_IN, num_layer=6, compute_dtype=dtype)
    return init_bsrnn(cfg, seed=0, device=device), cfg, STFTConfig()


def _par_enhance(device, family, dtype, mesh=None):
    """The enhancement of the batch: ``make_enhance_fn`` in one process, or
    on ``mesh`` the sharded builder; a flow prior from a generator seeded 5."""
    import torch

    from urgent2026_challenge_track1_tpu_torch.parallel import model_parallel as mpar
    from urgent2026_challenge_track1_tpu_torch.serving import make_enhance_fn

    model, cfg, stft_cfg = _par_model(device, family, dtype)
    noisy, lengths = _par_batch(device)
    gen = torch.Generator(device=device).manual_seed(5)
    kind = "flowse" if family == "flow" else "discriminative"
    if mesh is None:
        return make_enhance_fn(kind, model, cfg, stft_cfg, nfe=PAR_NFE)(noisy, PAR_FS, lengths,
                                                                         generator=gen)
    if family == "flow":
        return mpar.make_sharded_flow_enhance(mesh, model, cfg, PAR_FS, N=PAR_NFE,
                                              lengths=True)(noisy, lengths, generator=gen)
    return mpar.make_sharded_enhance(mesh, model, stft_cfg, PAR_FS, lengths=True)(noisy, lengths)


def _par_step(device, family, B, mesh=None, shard=None):
    """One float32 train step (remat, AdamW, clipping; the flow model's EMA
    and its draws from ``step_generator(0, 0)``) on ``_train_batch``'s B
    rows, of which a dp rank of ``mesh`` takes its block; (loss, grad norm,
    the parameters flattened on the CPU)."""
    import copy

    import torch

    from urgent2026_challenge_track1_tpu_torch.config import Config
    from urgent2026_challenge_track1_tpu_torch.train import trainer

    model, cfg, stft_cfg = _par_model(device, family, "float32")
    kind = "flowse" if family == "flow" else "discriminative"
    bundle = trainer.ModelBundle(kind, cfg, stft_cfg)
    tcfg = Config(device="cuda")
    ema = copy.deepcopy(model).requires_grad_(False) if kind == "flowse" else None
    clean, noisy, lengths = _train_batch(device, B=B)
    rows = slice(None) if mesh is None else mesh.dp_block(B)
    step = trainer.make_train_step(bundle, tcfg, PAR_FS, mesh, shard)
    m = step(model, trainer.make_optimizer(tcfg, model), clean[rows], noisy[rows],
             lengths[rows], ema=ema, generator=trainer.step_generator(0, 0))
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()]).cpu()
    return float(m["loss"]), float(m["grad_norm"]), flat


def _par_world_one(device) -> dict:
    """(a): one process, NCCL, a world of one.  The collective helpers on
    CUDA tensors through NCCL; the "dp=-1" mesh's sharded enhancement
    (bfloat16), through ``make_sharded_enhance`` (no split at mp = 1) and
    with a row sharder over the world's one member around every recurrence
    (its split and gather all-gather over NCCL), against
    ``make_enhance_fn``; one float32 train step on the mesh with that
    sharder (its gradients all-reduced over NCCL) against the default step;
    each bit for bit."""
    import socket

    import torch
    import torch.distributed as dist

    from urgent2026_challenge_track1_tpu_torch.models.bsrnn import bsrnn_se_apply
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K
    from urgent2026_challenge_track1_tpu_torch.parallel import mesh as pmesh
    from urgent2026_challenge_track1_tpu_torch.parallel.model_parallel import RowSharder

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1)
    saved = torch.backends.cudnn.deterministic
    try:
        mesh = pmesh.make_mesh("dp=-1", device=device)
        if (mesh.dp, mesh.mp, mesh.world_size) != (1, 1, 1):
            fail(f"parallel (a): mesh {mesh}")
        # the helpers through NCCL: an all-gather of one block, the world
        # mean of two gradients, a broadcast from rank 0
        x = torch.randn(3, 5, device=device)
        grads = [torch.randn(4, device=device), torch.randn(2, 3, device=device)]
        kept = [g.clone() for g in grads]
        pmesh.all_reduce_gradients(grads, mesh)
        b = x.clone()
        pmesh.broadcast_batch(b)
        if not (torch.equal(pmesh.all_gather_rows(x, None, 1), x) and torch.equal(b, x)
                and all(torch.equal(g, k) for g, k in zip(grads, kept))):
            fail("parallel (a): a collective helper changed its tensor over a world of one")
        one = RowSharder(None, 0, 1)  # the world's one member
        want = _par_enhance(device, "disc", "bfloat16")
        K.reset_launch_counts()
        got = _par_enhance(device, "disc", "bfloat16", mesh)
        routes = _routes()
        _check_routes("parallel (a) sharded enhancement", "bfloat16", routes)
        model, _, stft_cfg = _par_model(device, "disc", "bfloat16")
        noisy, lengths = _par_batch(device)
        K.reset_launch_counts()
        with torch.inference_mode():
            split = bsrnn_se_apply(model, stft_cfg, noisy, PAR_FS, lengths=lengths,
                                   shard=one)[0]
        split_routes = _routes()
        _check_routes("parallel (a) enhancement with the sharder", "bfloat16", split_routes)
        for what, out in (("make_sharded_enhance", got), ("the sharder", split)):
            if not torch.equal(out, want):
                fail(f"parallel (a): the world-of-one enhancement through {what} differs "
                     f"from make_enhance_fn by {float((out - want).abs().max())}")
        torch.backends.cudnn.deterministic = True
        K.reset_launch_counts()
        got = _par_step(device, "disc", 2, mesh, one)
        step_routes = _routes()
        _check_routes("parallel (a) train step", "float32", step_routes, TRAIN_ROUTED)
        _check_no_lean_kernels("parallel (a) train step", K.launch_counts())
        want = _par_step(device, "disc", 2)
        if got[:2] != want[:2] or not torch.equal(got[2], want[2]):
            fail(f"parallel (a): the world-of-one step differs from the default step: loss "
                 f"{got[0]} vs {want[0]}, grad norm {got[1]} vs {want[1]}, parameters by "
                 f"{float((got[2] - want[2]).abs().max())}")
        print(f"[parallel] (a) NCCL, world of one, mesh dp=-1 -> dp=1, mp=1: all_gather_rows, "
              f"all_reduce_gradients and broadcast_batch on CUDA tensors leave them as they "
              f"were; the bf16 enhancement (B=2, 4 s and 3.7 s at 48 kHz, 196 x 6) through "
              f"make_sharded_enhance and with the sharder around every recurrence (NCCL "
              f"all-gathers) equals make_enhance_fn bit for bit, routes {_ran(routes)} and "
              f"{_ran(split_routes)}; one f32 train step (B=2, 2 s) with the sharder and the "
              f"NCCL all-reduce equals the default step bit for bit (loss {got[0]:.6f}, grad "
              f"norm {got[1]:.6f}), routes {_ran(step_routes)}")
        return {"enhance_routes": _ran(routes), "sharder_routes": _ran(split_routes),
                "step_routes": _ran(step_routes)}
    finally:
        torch.backends.cudnn.deterministic = saved
        dist.destroy_process_group()


def _parallel_worker(rank: int, port: int, workdir: str, device: str) -> int:
    """One of (b)'s two ranks (``chip_smoke.py --parallel-worker RANK PORT
    DIR DEVICE``): gloo on the one card; runs PAR_ENHANCE and PAR_TRAIN in order,
    the launch counts set to 0 before each and read after it, and saves
    its outputs, routes and times to DIR/rank<RANK>.pt."""
    import hashlib

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    from urgent2026_challenge_track1_tpu_torch.ops import _build
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K
    from urgent2026_challenge_track1_tpu_torch.parallel.mesh import make_mesh
    from urgent2026_challenge_track1_tpu_torch.parallel.model_parallel import row_sharder

    if _build.build().seconds != 0.0:  # the build phase's library, not a new build
        fail(f"parallel rank {rank}: the kernel library was rebuilt")
    device = torch.device(device)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2)
    try:
        # gloo on CUDA tensors, before any kernel launch: the collectives
        # run on them directly (no staging through host memory)
        x = torch.full((4,), float(rank + 1), device=device)
        parts = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(parts, x)
        dist.all_reduce(x)
        dist.broadcast(x, 0)
        if torch.cat(parts).tolist() != [1.0] * 4 + [2.0] * 4 or x.tolist() != [3.0] * 4:
            fail(f"parallel rank {rank}: gloo collectives on CUDA tensors gave {parts}, {x}")
        # gloo's rate on the card's tensors: all-gather 64 MB a rank (after one warm-up)
        x = torch.randn(16 * 2**20, device=device)
        parts = [torch.empty_like(x) for _ in range(2)]
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            dist.all_gather(parts, x)
            torch.cuda.synchronize()
        gather_ms = (time.perf_counter() - t) * 1e3
        del x, parts
        meshes = {spec: make_mesh(spec, device=device) for spec in ("dp=1,mp=2", "dp=2")}
        out = {"coords": {k: (m.dp_index, m.mp_index) for k, m in meshes.items()},
               "allgather_64MB_ms": gather_ms}
        for name, spec, family, dtype in PAR_ENHANCE:
            torch.cuda.synchronize()
            t, start = time.perf_counter(), time.time()
            K.reset_launch_counts()
            wav = _par_enhance(device, family, dtype, meshes[spec])
            torch.cuda.synchronize()
            out[name] = {"wav": wav.float().cpu(), "routes": _routes(), "start": start,
                         "seconds": time.perf_counter() - t}
        for name, spec, family, B in PAR_TRAIN:
            torch.cuda.synchronize()
            t, start = time.perf_counter(), time.time()
            K.reset_launch_counts()
            loss, gnorm, flat = _par_step(device, family, B, meshes[spec],
                                          row_sharder(meshes[spec]))
            out[name] = {"loss": loss, "grad_norm": gnorm, "routes": _routes(),
                         "launches": K.launch_counts(), "dw": K.lstm_bwd_dw.launches,
                         "sha": hashlib.sha256(flat.numpy().tobytes()).hexdigest(),
                         "params": flat if rank == 0 else None, "start": start,
                         "seconds": time.perf_counter() - t}
        torch.save(out, Path(workdir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()
    return 0


def phase_parallel(device, workdir: Path) -> dict:
    """dp x mp parallelism (``parallel/``) on the one card.  (a) one
    process over NCCL, a world of one (``_par_world_one``).  (b) two
    processes on the card over gloo, because NCCL refuses two ranks on one
    device; the kernels still run on the card, and each rank's route counts
    show which ones it ran: at "dp=1,mp=2" the sharded enhancement of the
    B = 2 batch (4 s and 3.7 s at 48 kHz, lengths) in float32 and bfloat16
    at 196 x 6 and of the flow model (384 x 6, N = 15, bfloat16), against
    one process's ``make_enhance_fn`` (float32 within PAR_F32_LIMIT,
    bfloat16 within E2E_BF16_BOUND); a "dp=2" float32 step (2 s, B = 2 a
    rank) against one process's B = 4 step, a "dp=1,mp=2" step against
    mp = 1 (B = 2) and a "dp=2" flow step (B = 1 a rank) against one
    process's B = 2 step, each within PAR_LOSS_RTOL, PAR_GNORM_RTOL and
    PAR_PARAM_ATOL (the flow step draws its t and noise for the global batch).  The
    one-process references run while the ranks do."""
    import gc
    import socket

    import torch

    t0, wall0 = time.perf_counter(), time.time()
    # the ranks share the card with this process: hand back the blocks its
    # caching allocator keeps from the earlier phases
    gc.collect()
    held = torch.cuda.memory_reserved(device)
    torch.cuda.empty_cache()
    print(f"[parallel] this process: {torch.cuda.memory_allocated(device) / 2**30:.2f} GiB "
          f"allocated, {held / 2**30:.2f} GiB reserved before empty_cache, "
          f"{torch.cuda.memory_reserved(device) / 2**30:.2f} after")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    # the ranks start (import torch, reach the card, join gloo) while this
    # process runs (a) and the one-process references
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               "--parallel-worker", str(r), str(port), str(workdir),
                               str(device)],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    try:
        result = {"a": _par_world_one(device)}
        t_refs = time.time()
        saved = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            refs = {name: _par_enhance(device, family, dtype).float().cpu()
                    for name, _, family, dtype in PAR_ENHANCE}
            refs.update({name: _par_step(device, family, B)
                         for name, _, family, B in PAR_TRAIN})
        finally:
            torch.backends.cudnn.deterministic = saved
        result["timeline_s"] = {"a": round(t_refs - wall0, 2),
                                "references": round(time.time() - wall0, 2)}
        logs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (so, se)) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            fail(f"parallel rank {r} exited with {p.returncode}:\n{so[-2000:]}\n{se[-4000:]}")
    ranks = [torch.load(Path(workdir) / f"rank{r}.pt", weights_only=False) for r in range(2)]
    if [rk["coords"] for rk in ranks] != [{"dp=1,mp=2": (0, 0), "dp=2": (0, 0)},
                                          {"dp=1,mp=2": (0, 1), "dp=2": (1, 0)}]:
        fail(f"parallel (b): rank layout {[rk['coords'] for rk in ranks]}")
    print(f"[parallel] (b) gloo, two processes on {torch.cuda.get_device_name(0)} (NCCL "
          f"refuses two ranks on one device); gloo in PyTorch {torch.__version__} takes CUDA "
          f"tensors in all_gather, all_reduce and broadcast (checked on each rank before "
          f"any launch), so the collectives run on them with no staging through host "
          f"memory; an all-gather of 64 MB a rank took "
          f"{[round(rk['allgather_64MB_ms'], 1) for rk in ranks]} ms; each rank loaded the "
          f"build phase's library")
    result["allgather_64MB_ms"] = [rk["allgather_64MB_ms"] for rk in ranks]
    for name, spec, family, dtype in PAR_ENHANCE:
        limit = PAR_F32_LIMIT if dtype == "float32" else E2E_BF16_BOUND
        errs = [float((rk[name]["wav"] - refs[name]).abs().max()) for rk in ranks]
        for r, rk in enumerate(ranks):
            _check_routes(f"parallel (b) {name} rank {r}", dtype, rk[name]["routes"])
        if max(errs) > limit:
            fail(f"parallel (b) {name} at {spec}: max|sharded - one process| {errs} > {limit}")
        result[name] = {"max_abs_err": errs, "limit": limit,
                        "seconds": [rk[name]["seconds"] for rk in ranks],
                        "routes": [_ran(rk[name]["routes"]) for rk in ranks]}
        print(f"[parallel] (b) {spec} {name} enhancement: max|sharded - one process| "
              f"{max(errs):.3e} (limit {limit:g}); rank routes {result[name]['routes']}; "
              f"{max(rk[name]['seconds'] for rk in ranks):.2f} s")
    for name, spec, family, B in PAR_TRAIN:
        loss, gnorm, flat = refs[name]
        for r, rk in enumerate(ranks):
            what = f"parallel (b) {name} rank {r}"
            _check_routes(what, "float32", rk[name]["routes"], TRAIN_ROUTED)
            _check_no_lean_kernels(what, rk[name]["launches"])
        if len({rk[name]["sha"] for rk in ranks}) != 1:
            fail(f"parallel (b) {name}: the ranks' parameters differ")
        got = ranks[0][name]
        loss_rel = abs(got["loss"] - loss) / abs(loss)
        gnorm_rel = abs(got["grad_norm"] - gnorm) / abs(gnorm)
        param_err = float((got["params"] - flat).abs().max())
        if (loss_rel > PAR_LOSS_RTOL or gnorm_rel > PAR_GNORM_RTOL
                or param_err > PAR_PARAM_ATOL):
            fail(f"parallel (b) {name} at {spec}: loss {got['loss']} vs {loss} (rel "
                 f"{loss_rel:.2e}), grad norm {got['grad_norm']} vs {gnorm} (rel "
                 f"{gnorm_rel:.2e}), parameters by {param_err:.2e}")
        result[name] = {"loss_rel": loss_rel, "param_max_abs_err": param_err,
                        "grad_norm_rel": gnorm_rel, "grad_norm": [got["grad_norm"], gnorm],
                        "seconds": [rk[name]["seconds"] for rk in ranks],
                        "routes": [_ran(rk[name]["routes"]) for rk in ranks],
                        "dw": [rk[name]["dw"] for rk in ranks]}
        print(f"[parallel] (b) {spec} f32 {name} (global B={B}): loss rel {loss_rel:.2e} "
              f"(limit {PAR_LOSS_RTOL:g}), max|parameters - one process| {param_err:.2e} "
              f"(limit {PAR_PARAM_ATOL:g}), grad norm {got['grad_norm']:.6f} vs {gnorm:.6f} "
              f"(rel {gnorm_rel:.2e}, limit {PAR_GNORM_RTOL:g}), "
              f"both ranks' parameters equal; rank routes {result[name]['routes']}, dW launches "
              f"{[rk[name]['dw'] for rk in ranks]}; "
              f"{max(rk[name]['seconds'] for rk in ranks):.2f} s")
    for name in [e[0] for e in PAR_ENHANCE] + [t[0] for t in PAR_TRAIN]:
        result["timeline_s"][name] = [round(ranks[0][name]["start"] - wall0, 2),
                                      round(ranks[0][name]["start"] - wall0
                                            + ranks[0][name]["seconds"], 2)]
    result["seconds"] = time.perf_counter() - t0
    print(f"[parallel] timeline (s from the phase's start; (a) and the references end, "
          f"each of rank 0's checks starts and ends): {result['timeline_s']}")
    return result


def main() -> int:
    import torch

    if len(sys.argv) == 6 and sys.argv[1] == "--parallel-worker":  # phase_parallel's ranks
        return _parallel_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
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
    from urgent2026_challenge_track1_tpu_torch.simulation.dsp import codecs_available

    codec = codecs_available()  # the libavcodec shim builds here, or the ffmpeg CLI exists
    print(f"[codec] codecs_available() = {codec}")
    errs = timed("inference kernels", phase_kernels, device)
    train_errs = timed("training kernels", phase_train_kernels, device)
    wide_errs = timed("inference kernels H=768", phase_kernels, device, FLOW_N, FLOW_H,
                      (FLOW_TIME,), (FLOW_BAND,))
    wide_train_errs = timed("training kernels H=768", phase_train_kernels, device, FLOW_H,
                            (FLOW_TIME, FLOW_BAND), FLOW_SECONDS, 384)
    new_errs = timed("K8-K10", phase_new_kernels, device)
    streamin_bwd2 = timed("k8p/k10p routes", phase_streamin_bwd2_routes, device)
    k1_routes = timed("k1_routes", phase_k1_routes, device)
    k1_f32_routes = timed("k1_routes f32", phase_k1_f32_routes, device)
    scan_routes = timed("scan_routes", phase_scan_routes, device)
    scan_f32_routes = timed("scan_routes f32", phase_scan_f32_routes, device)
    train_routes_rows = timed("train_routes", phase_train_routes, device)
    bwd_routes_rows = timed("bwd_routes", phase_bwd_routes, device)
    carry_rows = timed("carry_routes", phase_carry_routes, device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=REPO) as tmp:
        counts, main_routes = timed("inference path", phase_main_path, Path(tmp))
        _, train_routes, validation = timed("training path", phase_training, Path(tmp))
        causal = timed("causal streaming path", phase_causal, Path(tmp), device)
        serving = timed("serving path", phase_serving, Path(tmp), device, causal)
        flow_routes, flow_ckpt, flow_validation = timed("flow training path",
                                                        phase_flow_training, Path(tmp))
        _, flow_cli_routes = timed("flow inference path", phase_flow_cli, Path(tmp), flow_ckpt)
        _, dm_times = timed("dynamic-mixing training path", phase_dm_training, Path(tmp))
        dm_times.update(timed("on-device dynamic-mixing training path", phase_dm_device,
                              Path(tmp), device, dm_times))
        timed("init_from warm start", phase_init_from, Path(tmp), device)
        dm_times.update(timed("rk45 flow sampler", phase_rk45, Path(tmp), flow_ckpt, device))
        eval_clis = timed("model-scored evaluation CLIs", phase_eval_clis, Path(tmp), device)
    sgmse = timed("sgmse", phase_sgmse, device)
    wide_routes = timed("walk route", phase_walk_route, device)
    ab, _ = timed("a/b arms", phase_ab_arms, device)
    timed("card vs cpu forward", phase_card_vs_cpu, device)
    timed("card vs cpu gradients", phase_grads_card_vs_cpu, device)
    timed("flow card vs cpu", phase_flow_card_vs_cpu, device)
    onnx = timed("onnx executor and dnsmos", phase_onnx, device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=REPO) as tmp:
        parallel = timed("parallel", phase_parallel, device, Path(tmp))
    records = timed("times", phase_times, device, counts, errs, train_errs, k1_routes,
                    scan_routes, train_routes_rows, bwd_routes_rows, main_routes, train_routes,
                    wide_routes)
    records += _new_kernel_walk_records(streamin_bwd2, new_errs, wide_routes)
    records += _streamin_bwd2_records(streamin_bwd2, ab)
    records.append(_k1_f32_record(k1_f32_routes, train_routes, flow_routes, validation,
                                  flow_validation))
    records += _scan_f32_records(scan_f32_routes, train_routes, flow_routes, validation,
                                 flow_validation)
    timed("times K1-K7 flow shapes", _flow_kernel_times, device, records, flow_routes,
          wide_errs, wide_train_errs, k1_routes, scan_routes, flow_cli_routes)
    flow_times = timed("times flow", _flow_step_and_enhance_times, device)
    records += _carry_records(carry_rows, causal[3])
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
    print("[times] " + json.dumps({"validation_f32": {"disc": validation,
                                                      "flow": flow_validation},
                                   "ab_arms": ab, "flow": flow_times, "dm": dm_times,
                                   "sgmse": sgmse, "codecs_available": codec,
                                   "causal": causal[3], "serving": serving,
                                   "parallel": parallel, "onnx": onnx,
                                   "eval_clis": eval_clis,
                                   "carry_routes": carry_rows}))
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(gpu_name_and_power())
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
