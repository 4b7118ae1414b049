"""Profile one forward, or one train step, of the port on the card: device
time by kernel and the device's idle share.

    python -m urgent2026_challenge_track1_tpu_torch.profile_forward \
        [--batch 64] [--seconds 4] [--fs 48000] [--channels 192] [--lengths 0.925] \
        [--train [--render]] [--dtype bfloat16] [--flow [--nfe 15]] [--sgmse [--nfe 50]]

Builds a seeded random model (6 layers, ``--dtype`` compute), runs one
warm-up, then one forward (or, with ``--train``, one step of the trainer:
forward, backward, clipping and AdamW) under ``torch.profiler``.  With
``--flow`` the model is the flow-matching one (``--channels`` is its
``bsrnn_hidden``) and the forward is one ``flowse_enhance`` of ``--nfe``
euler steps.  With ``--sgmse`` the model is SGMSE's score network
(``SGMSEConfig`` at ``--channels``) and the forward is one
``sgmse_enhance`` of ``--nfe`` predictor-corrector steps (one correction
each: 2 network calls a step).  ``--train --render`` profiles the
dynamic-mixing step with the render on the card
(``make_train_step_rendered``; high-pass, reverb, SNR mixing, a bandwidth
limit, clipping and packet loss on every row).
``--lengths f`` gives every row the length ``f * seconds * fs`` (the
length-exact path with the masked time recurrence); without it the unmasked
path runs (a train step always passes lengths, as the trainer does).  Prints
a table of device time per kernel group and, as the last line, a JSON
record.  Fails if the profiler saw no device time.
"""

from __future__ import annotations

import argparse
import json
import re
import time

import numpy as np
import torch

from urgent2026_challenge_track1_tpu_torch import resolve_device
from urgent2026_challenge_track1_tpu_torch.config import Config
from urgent2026_challenge_track1_tpu_torch.dsp.stft import STFTConfig
from urgent2026_challenge_track1_tpu_torch.data import dynamic_device
from urgent2026_challenge_track1_tpu_torch.models import bsrnn_flowse as flow_mod
from urgent2026_challenge_track1_tpu_torch.models import sgmse as sgmse_mod
from urgent2026_challenge_track1_tpu_torch.models.bsrnn import bsrnn_se_apply
from urgent2026_challenge_track1_tpu_torch.train import trainer

__all__ = ["main"]


def _names(name: str, kernel: str) -> bool:
    """Whether a device kernel's name, mangled or demangled, is one of ours
    (``(anonymous namespace)::kernel<...>`` or ``..._<len>kernelI...``), not
    a library kernel whose name merely ends the same way."""
    return re.search(rf"(?:::|\d){kernel}[<I]", name) is not None


def _flags(name: str, kernel: str) -> list[bool]:
    """The bool template arguments of a kernel name, mangled (Lb0E / Lb1E)
    or demangled (false / true), in order."""
    tail = name[re.search(rf"(?:::|\d){kernel}[<I]", name).end():]
    found = re.findall(r"Lb([01])E|\b(true|false)\b", tail.split("(")[0])
    return [m[0] == "1" or m[1] == "true" for m in found]


def _group(name: str) -> str:
    """Kernel name -> the port kernel it belongs to, or its own name."""
    if _names(name, "fusedin_persistent_kernel"):  # <T, STORE>: K8p's instance stores
        group = ("K8p lstm_train_fwd_streamin_persistent"
                 if _flags(name, "fusedin_persistent_kernel") == [True]
                 else "K1p fusedin_persistent")
        f32 = re.search(r"fusedin_persistent_kernel(?:If|<float\b)", name) is not None
        return group.replace(" ", "-f32 ", 1) if f32 else group
    if _names(name, "bwd2_persistent_kernel"):  # <T>
        f32 = re.search(r"bwd2_persistent_kernel(?:If|<float\b)", name) is not None
        return "K10p-f32 lstm_train_bwd2_persistent" if f32 else "K10p lstm_train_bwd2_persistent"
    if _names(name, "scan_persistent_kernel"):  # <T, REVERSE, MASKED, STORE>
        _, masked, store = _flags(name, "scan_persistent_kernel")
        group = {(False, False): "K2p lstm_scan_persistent",
                 (True, False): "K3p lstm_revmasked_persistent",
                 (False, True): "K4p lstm_train_fwd_persistent",
                 (True, True): "K6p lstm_revmasked_train_fwd_persistent"}[masked, store]
        f32 = re.search(r"scan_persistent_kernel(?:If|<float\b)", name) is not None
        return group.replace(" ", "-f32 ", 1) if f32 else group
    if _names(name, "bwd_persistent_kernel"):  # <T, MASKED>
        masked, = _flags(name, "bwd_persistent_kernel")
        group = ("K7p lstm_revmasked_bwd_persistent" if masked
                 else "K5p lstm_train_bwd_persistent")
        f32 = re.search(r"bwd_persistent_kernel(?:If|<float\b)", name) is not None
        return group.replace(" ", "-f32 ", 1) if f32 else group
    if re.search(r"(?:::|\d)dw_tc_kernel(?:[(E]|$)", name):  # K5p's and K7p's
        return "K5p/K7p dW (dw_tc_kernel)"
    if re.search(r"(?:::|\d)dw_tf32_kernel(?:[(E]|$)", name):  # K5p-f32's and K7p-f32's
        return "K5p/K7p dW-f32 (dw_tf32_kernel)"
    if re.search(r"(?:::|\d)dw_sum_kernel(?:[(E]|$)", name):  # either dW kernel's split sum
        return "K5p/K7p dW part sum (dw_sum_kernel)"
    if _names(name, "fusedin_kernel"):
        stream = _flags(name, "fusedin_kernel") == [True]
        return "K8 lstm_train_fwd_streamin" if stream else "K1 fusedin_bilstm"
    if _names(name, "recurrence_kernel"):
        masked, store = _flags(name, "recurrence_kernel")
        return {(False, False): "K2 lstm_scan", (True, False): "K3 lstm_revmasked",
                (False, True): "K4 lstm_train_fwd",
                (True, True): "K6 lstm_revmasked_train_fwd"}[masked, store]
    if _names(name, "backward_kernel"):
        masked, = _flags(name, "backward_kernel")
        return "K7 lstm_revmasked_bwd (walk)" if masked else "K5 lstm_train_bwd (walk)"
    if _names(name, "dw_kernel"):
        masked, = _flags(name, "dw_kernel")
        return "K7 lstm_revmasked_bwd (dW)" if masked else "K5 lstm_train_bwd (dW)"
    return name[:80]


def _union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def _render_batch(wav: torch.Tensor, lengths: torch.Tensor, fs: int) -> list:
    """The RENDER_KEYS arrays of a DeviceRenderBatch whose rows are
    ``wav`` (speech, and its reversal as noise) with a decaying RIR, an SNR
    of 5 dB, a 16 kHz bandwidth limit, clipping and two lost packets."""
    speech = wav.cpu().numpy()
    chain = ("bandwidth_limitation-kaiser_best->16000/clipping(min=0.1,max=0.9)/"
             "packet_loss(packet_loss_indices=[3, 40],packet_duration_ms=20)")
    rir = np.exp(-np.arange(4800) / 480.0)
    rir[0] = 1.0
    items = [{"prerendered": False, "speech": row[:n], "noise": row[::-1][:n], "rir": rir,
              "fs": fs, "length": n, "snr_db": 5.0, "use_rir": 1.0,
              **dynamic_device.parse_augmentation_ops(chain, fs)}
             for row, n in zip(speech, lengths.tolist())]
    batch = dynamic_device.collate_device_render(items)
    return [np.ascontiguousarray(batch[k]) for k in dynamic_device.RENDER_KEYS]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--fs", type=int, default=48000)
    p.add_argument("--channels", type=int, default=192)
    p.add_argument("--lengths", type=float, default=None,
                   help="valid fraction of every row (length-exact path)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--train", action="store_true", help="profile one train step")
    p.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    p.add_argument("--flow", action="store_true", help="the flow-matching model")
    p.add_argument("--nfe", type=int, default=15,
                   help="euler steps of a flow forward, or SGMSE's sampler steps")
    p.add_argument("--sgmse", action="store_true", help="one SGMSE enhancement")
    p.add_argument("--render", action="store_true",
                   help="with --train: the dm step with the render on the card")
    args = p.parse_args(argv)
    if args.render and not args.train:
        p.error("--render profiles a train step: pass --train")

    dev = resolve_device("cuda")
    if args.flow:
        cfg = Config(model_type="flowse", bsrnn_hidden=args.channels, num_layer=6,
                     compute_dtype=args.dtype, seed=args.seed)
    else:
        cfg = Config(model_configs={"num_channel": args.channels, "num_layer": 6},
                     compute_dtype=args.dtype, seed=args.seed)
    if not args.sgmse:
        bundle = trainer.build_model(cfg)
        model = trainer.init_params(args.seed, bundle, dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    n = int(args.seconds * args.fs)
    wav = 0.1 * torch.randn((args.batch, n), generator=gen, device=dev)
    lengths = None
    if args.lengths is not None or args.train:
        valid = int((args.lengths or 1.0) * n)
        lengths = torch.full((args.batch,), valid, dtype=torch.int32, device=dev)
    if args.sgmse:
        scfg = sgmse_mod.SGMSEConfig(bsrnn_hidden=args.channels, compute_dtype=args.dtype)
        model = sgmse_mod.init_sgmse(scfg, seed=args.seed, device=dev).eval()

        def run():
            with torch.inference_mode():
                sgmse_mod.sgmse_enhance(model, scfg, wav, args.fs, N=args.nfe, generator=gen)
    elif args.render:
        opt = trainer.make_optimizer(cfg, model)
        train_step = trainer.make_train_step_rendered(bundle, cfg, args.fs)
        tensors = [torch.from_numpy(v).to(dev) for v in _render_batch(wav, lengths, args.fs)]

        def run():
            train_step(model, opt, *tensors)
    elif args.train:
        opt = trainer.make_optimizer(cfg, model)
        train_step = trainer.make_train_step(bundle, cfg, args.fs)
        clean = 0.8 * wav

        def run():
            train_step(model, opt, clean, wav, lengths,
                       generator=trainer.step_generator(args.seed, 0) if args.flow else None)
    elif args.flow:
        def run():
            with torch.inference_mode():
                flow_mod.flowse_enhance(model, bundle.model_cfg, wav, args.fs, N=args.nfe,
                                        lengths=lengths, generator=gen)
    else:
        def run():
            with torch.inference_mode():
                bsrnn_se_apply(model, STFTConfig(), wav, args.fs, lengths)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    run()  # warm-up
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
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
        "what": ("sgmse " if args.sgmse else "flow " if args.flow else "")
                + ("rendered " if args.render else "")
                + ("train step" if args.train else "forward"),
        "geometry": {"batch": args.batch, "seconds": args.seconds, "fs": args.fs,
                     "channels": args.channels, "lengths": args.lengths,
                     "dtype": args.dtype,
                     "nfe": args.nfe if (args.flow or args.sgmse) and not args.train else None},
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
