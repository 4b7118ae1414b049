"""The design choices of K5p-f32 and its float32 dW kernel, measured on the
card:

    python -m urgent2026_challenge_track1_tpu_torch.profile_bwd_f32

At the flow model's train shapes (H = 768: 96 x 251 and 502 x 48), K5p-f32
(with its dW) on the planner's plan (64 CTAs or more of one group at
H = 768, K tiles of at least ``BWD_MIN_TILE`` = 256 columns) and on the
plan with 64-wide K tiles, which fits two groups of narrower slices; then,
at the four train shapes, the float32 dW kernel alone against the float64
product of its own operands (max |dW - P| / max |P| and, elementwise,
|dW - P| / (|h_prev|^T |dx_proj|)) and its time beside ``torch.mm`` in
float32 (TF32 off) on the same operands.  Prints one JSON line per shape
and the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess

import torch

from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K

__all__ = ["main"]

SHAPES = ((136, 201, 392), (804, 34, 392), (96, 251, 768), (502, 48, 768))


def _ms(fn, reps: int = 5, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[reps // 2]


def _readings(dw, hp, d):
    P = hp.double().t() @ d.double()
    err = (dw.double() - P).abs()
    scale = hp.double().abs().t() @ d.double().abs()
    return float(err.max() / P.abs().max()), float((err / scale.clamp_min(1e-300)).max())


def _plan_with_tile(R, H, sms, min_tile):
    """``plan_backward``'s float32 plan with K tiles of at least
    ``min_tile`` columns."""
    saved = K.BWD_MIN_TILE
    K.BWD_MIN_TILE = min_tile
    K.plan_backward.cache_clear()
    try:
        return K.plan_backward(R, H, sms, elem=4)
    finally:
        K.BWD_MIN_TILE = saved
        K.plan_backward.cache_clear()


def main() -> list:
    if not torch.cuda.is_available():
        raise SystemExit("profile_bwd_f32: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = []
    for R, T, H in SHAPES:
        gen = torch.Generator().manual_seed(R + T + H)
        xp = (0.5 * torch.randn((R, T, 4 * H), generator=gen)).to(dev)
        w = (H ** -0.5 * torch.randn((H, 4 * H), generator=gen)).to(dev)
        dout = (0.1 * torch.randn((R, T, H), generator=gen)).to(dev)
        res = K.lstm_train_fwd_plain(xp, w)
        plan = K.plan_backward(R, H, sms, elem=4)
        dxp = K.lstm_train_bwd_persistent(*res, dout, w, False, plan)[0]
        hp = K._h_prev(res[0], False).reshape(-1, H)
        d = dxp.reshape(-1, 4 * H)
        rec = {"R": R, "T": T, "H": H,
               "plan": [plan.S, plan.G, plan.U, plan.chunk, plan.kt],
               "k5p_f32_ms": _ms(lambda: K.lstm_train_bwd_persistent(*res, dout, w, False, plan)),
               "dw_f32_readings": _readings(K.lstm_bwd_dw(res[0], dxp, False, None,
                                                           plan.dw_split), hp, d),
               "torch_mm_readings": _readings(hp.t() @ d, hp, d),
               "dw_f32_ms": _ms(lambda: K.lstm_bwd_dw(res[0], dxp, False, None, plan.dw_split)),
               "torch_mm_ms": _ms(lambda: torch.mm(hp.t(), d))}
        if H == 768:
            narrow = _plan_with_tile(R, H, sms, 64)
            got = K.lstm_train_bwd_persistent(*res, dout, w, False, narrow)[0]
            rec.update({
                "kt64_plan": [narrow.S, narrow.G, narrow.U, narrow.chunk, narrow.kt],
                "kt64_max_abs_diff": float((got - dxp).abs().max()),
                "kt64_k5p_f32_ms": _ms(
                    lambda: K.lstm_train_bwd_persistent(*res, dout, w, False, narrow)),
                "k5p_f32_ms_again": _ms(
                    lambda: K.lstm_train_bwd_persistent(*res, dout, w, False, plan))})
        print(json.dumps(rec), flush=True)
        out.append(rec)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return out


if __name__ == "__main__":
    main()
