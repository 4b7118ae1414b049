"""Profile one forward of the port on the card: device time by kernel and the
device's idle share.

    python -m urgent2026_challenge_track1_tpu_torch.profile_forward \\
        [--batch 64] [--seconds 4] [--fs 48000] [--channels 192] [--lengths 0.925]

Builds a seeded random model (6 layers, bfloat16 compute), runs one warm-up
forward, then one forward under ``torch.profiler``.  ``--lengths f`` gives
every row the length ``f * seconds * fs`` (the length-exact path with the
masked time recurrence); without it the unmasked path runs.  Prints a table
of device time per kernel group and, as the last line, a JSON record.  Fails
if the profiler saw no device time.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from urgent2026_challenge_track1_tpu_torch import resolve_device
from urgent2026_challenge_track1_tpu_torch.dsp.stft import STFTConfig
from urgent2026_challenge_track1_tpu_torch.models.bsrnn import (
    BSRNNConfig, bsrnn_se_apply, init_bsrnn)

__all__ = ["main"]


def _group(name: str) -> str:
    """Kernel name -> the port kernel it belongs to, or its own name."""
    if "fusedin_kernel" in name:
        return "K1 fusedin_bilstm"
    if "recurrence_kernel" in name:
        masked = "Lb1E" in name or ", true>" in name  # mangled or demangled MASKED
        return "K3 lstm_revmasked" if masked else "K2 lstm_scan"
    return name[:80]


def _union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--fs", type=int, default=48000)
    p.add_argument("--channels", type=int, default=192)
    p.add_argument("--lengths", type=float, default=None,
                   help="valid fraction of every row (length-exact path)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    dev = resolve_device("cuda")
    model = init_bsrnn(BSRNNConfig(num_channel=args.channels, num_layer=6,
                                   compute_dtype="bfloat16"), seed=args.seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    n = int(args.seconds * args.fs)
    wav = 0.1 * torch.randn((args.batch, n), generator=gen, device=dev)
    lengths = None
    if args.lengths is not None:
        lengths = torch.full((args.batch,), int(args.lengths * n), dtype=torch.int32, device=dev)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode():
        bsrnn_se_apply(model, STFTConfig(), wav, args.fs, lengths)  # warm-up
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            bsrnn_se_apply(model, STFTConfig(), wav, args.fs, lengths)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("torch.profiler recorded no device time")
    by_group: dict[str, float] = {}
    for e in kernels:
        g = _group(e.name)
        by_group[g] = by_group.get(g, 0.0) + (e.time_range.end - e.time_range.start)
    busy_us = _union_us((e.time_range.start, e.time_range.end) for e in kernels)
    total = sum(by_group.values())
    print(f"{'kernel group':60s} {'ms':>10s} {'share':>7s}")
    for g, us in sorted(by_group.items(), key=lambda kv: -kv[1])[:15]:
        print(f"{g:60s} {us / 1e3:10.3f} {us / total:7.1%}")
    record = {
        "device": torch.cuda.get_device_name(0),
        "geometry": {"batch": args.batch, "seconds": args.seconds, "fs": args.fs,
                     "channels": args.channels, "lengths": args.lengths},
        "wall_ms_profiled": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / wall_us,
        "kernel_launches": len(kernels),
        "share_by_group": {g: us / total for g, us in by_group.items()
                           if g.startswith("K") or us / total >= 0.01},
    }
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
