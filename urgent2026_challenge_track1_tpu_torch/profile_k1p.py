"""Per-phase cycles of K1p (``csrc/lstm_persistent.cu``) on the card.

    python -m urgent2026_challenge_track1_tpu_torch.profile_k1p [--shape R,T,N,H ...]

Builds the kernels with ``-DK1P_PHASE_CLOCKS`` (each CTA sums its clock64
cycles per phase of a step) through ``ops._build``, runs the port's own
wrapper ``fusedin_bilstm_persistent`` on that library once to warm up and
once measured at each shape (by default the eight where K1 runs; seeded
random bfloat16 inputs at the LSTM init's scale), and prints per shape the plan, the
wrapper's CUDA-event time and each phase's cycles per chunk pass, averaged
over the CTAs.  The last line is one JSON record.  The counters exist only
in this measurement build.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from urgent2026_challenge_track1_tpu_torch import resolve_device
from urgent2026_challenge_track1_tpu_torch.ops import _build
from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K

__all__ = ["main"]

PHASES = ("c_load", "stage_x", "x_w_ih", "wait", "stage_h", "h_w_hh", "reduce", "cell",
          "arrive")
# (R, T, N, H): one utterance's band path, the disc train step's band path,
# the bench forward's band and time paths, the flow train step's band path,
# one flow enhancement's band and time paths, a causal streaming step's band
# path (8 frames, B = 1) (chip_smoke.K1_ROUTE_SHAPES)
ROUTE_SHAPES = ((401, 34, 196, 392), (804, 34, 196, 392), (25664, 34, 192, 384),
                (2176, 401, 192, 384), (502, 48, 384, 768), (501, 48, 384, 768),
                (48, 501, 384, 768), (8, 34, 196, 392))
PHASE_CLOCKS = ("K1P_PHASE_CLOCKS",)


def profile_shape(dll, dev, R, T, N, H, seed=0) -> dict:
    gen = torch.Generator().manual_seed(seed)
    scale = H ** -0.5
    x = (0.3 * torch.randn((R, T, N), generator=gen)).to(dev, torch.bfloat16)
    wi, wh, b = (((torch.rand(shape, generator=gen) * 2 - 1) * scale).to(dev, torch.bfloat16)
                 for shape in ((2, N, 4 * H), (2, H, 4 * H), (2, 4 * H)))
    plan = K.plan_persistent(R, N, H, torch.cuda.get_device_properties(dev).multi_processor_count)
    if plan is None:
        raise ValueError(f"no K1p plan for R={R}, N={N}, H={H}")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    K.fusedin_bilstm_persistent(x, wi, wh, b, plan, library=dll)
    torch.cuda.synchronize()
    start.record()
    K.fusedin_bilstm_persistent(x, wi, wh, b, plan, library=dll)
    end.record()
    torch.cuda.synchronize()
    cycles = np.zeros((plan.ctas, len(PHASES)), np.int64)
    err = dll.lstm_persistent_phase_cycles(cycles.ctypes.data, plan.ctas)
    if err != 0:
        raise RuntimeError(f"reading the phase counters failed with cudaError_t {err}")
    passes = T * -(-plan.rows // plan.chunk)  # chunk passes of the largest group
    per_pass = cycles.mean(0) / passes
    return {"R": R, "T": T, "N": N, "H": H, "ms": start.elapsed_time(end),
            "plan": {"S": plan.S, "G": plan.G, "U": plan.U, "rows": plan.rows,
                     "chunk": plan.chunk, "c_in_smem": plan.c_in_smem, "ctas": plan.ctas},
            "chunk_passes": passes, "cycles_per_pass": dict(zip(PHASES, per_pass.tolist())),
            "cycles_per_pass_total": float(per_pass.sum())}


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--shape", action="append", default=None,
                   help="R,T,N,H (repeatable; default: the eight shapes where K1 runs)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    shapes = ([tuple(int(v) for v in s.split(",")) for s in args.shape] if args.shape
              else ROUTE_SHAPES)
    dev = resolve_device("cuda")
    dll = _build.load_library(PHASE_CLOCKS)
    records = []
    for R, T, N, H in shapes:
        rec = profile_shape(dll, dev, R, T, N, H, args.seed)
        print(f"R={R} T={T} N={N} H={H}: {rec['ms']:.3f} ms, plan {rec['plan']}, "
              f"{rec['cycles_per_pass_total']:.0f} cycles per chunk pass: " + ", ".join(
                  f"{k} {v:.0f}" for k, v in rec["cycles_per_pass"].items()))
        records.append(rec)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "k1p_phases": records}))
    return records


if __name__ == "__main__":
    main()
