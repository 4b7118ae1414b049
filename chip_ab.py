#!/usr/bin/env python3
"""Same-card A/B of the port's end-to-end times across source trees.

    python3 chip_ab.py TREE [TREE ...]      e.g.  _tree_check . . _tree_check

Runs each tree in turn, in its own process, from that tree's own package
and ``chip_smoke.py``: builds its kernels, then times one length-exact
forward (B=1, 3.7 s at 48 kHz in a 4 s bucket, 196 x 6, bf16), the forward
at the JAX bench geometry (B=64, 4 s at 48 kHz, 192 x 6, bf16, no lengths),
the discriminative train step (``chip_smoke._train_step_times``: B=4, 2 s
at 48 kHz, 196 x 6, float32 and bfloat16, peak memory), one train step of
the disc bf16 and the flow f32 family under FUSED_BIDIR_TRAIN (K9 and K10
on the band path; median of 3 after 1 warm-up), the flow train
step and enhancement (``chip_smoke._flow_step_and_enhance_times``), the
enhancement again as the median of 5 (``flow_enhance5_ms``), K1p alone
(``fusedin_bilstm_persistent``, CUDA events) at each of
``chip_smoke.K1_ROUTE_SHAPES``, and K2p and K3p alone
(``lstm_scan_persistent``, ``lstm_revmasked_persistent``) at the
one-utterance time path (34 x 401, H = 392, 371 valid frames) and the flow
CLI's (48 x 501, H = 768, 463 valid); then float32: K2 and K3 through the
routed wrappers (whatever route each tree takes: the walk, or K2p-f32 /
K3p-f32) at the one-utterance, disc validation (136 x 201), flow validation
(96 x 251) and flow CLI time paths, one validation pass of each family
through the trainer (``chip_smoke._validation_pass``, random initial
weights, the chip_smoke data), and the float32 causal stream step
(``chip_smoke.CAUSAL_MODEL``, random initial weights, 4 s at 48 kHz in
8-frame chunks: median and p95 wall time).  Give the trees in an order
that brackets drift (parent, change, change, parent).
Prints one JSON line per visit (``[ab] {...}``, with the registers and
spill bytes ptxas reported for each persistent and dW kernel), then whether
each tree's persistent kernels that the first tree also has (K1p and K8p
and every ``scan_persistent_kernel`` instance (K2p-K6p), bf16 and f32, the
K5p/K7p instances of ``bwd_persistent_kernel``, K10p's
``bwd2_persistent_kernel``, and the dW kernels)
compiled to the first tree's instructions (``cuobjdump -sass``, addresses
and encodings dropped), and whether K1p's outputs at
``chip_smoke.K1_ROUTE_SHAPES``, K5p's and K10p's (with their dW) at the
disc band (804 x 34, bf16 and f32) and K8p's, K2p's, K3p's, K4p's, K6p's (bf16 and f32) and
K7p's at the disc time path (136 x 201), K2p's with a carry at the
stream step (34 x 8), and end to end one float32 disc train step's loss
and updated parameters (``e2e_train_step_f32``), the one-utterance
forward (``e2e_one_utterance_bf16``) and a bf16 flow enhancement
(``e2e_flow_enhance_bf16``), equal the first tree's bit for bit (sha256 of the
bytes, seeded inputs; K2p-f32's and K3p-f32's digests, where a tree has
them, are compared only between trees that do), then the card's name and
power limit, then a JSON summary of the medians per tree.  Needs one
card.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

_VISIT = r'''
import hashlib, json, os, re, statistics, sys, tempfile, time
from pathlib import Path
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke as cs
from urgent2026_challenge_track1_tpu_torch.dsp.stft import STFTConfig
from urgent2026_challenge_track1_tpu_torch.models.bsrnn import (
    BSRNNConfig, bsrnn_se_apply, init_bsrnn)

res = cs.phase_build()
device = torch.device("cuda", 0)
out = {"tree": sys.argv[1], "library": str(res.path), "ptxas": {}}
# registers and spill bytes of each persistent and dW kernel, from the
# build's ptxas report (the mangled name without its anonymous namespace)
entry = None
for line in res.log.splitlines():
    m = re.search(r"Compiling entry function '\S*?(fusedin_persistent_kernel|"
                  r"scan_persistent_kernel|bwd_persistent_kernel|dw_tc_kernel|dw_tf32_kernel)"
                  r"(\S*?)'", line)
    if "Compiling entry function" in line:
        entry = m.group(1) + m.group(2) if m else None
        if entry:
            out["ptxas"][entry] = {}
    elif entry and "spill stores" in line:
        out["ptxas"][entry]["spill_store_bytes"] = int(re.search(r"(\d+) bytes spill stores",
                                                                 line).group(1))
    elif entry and "Used" in line and "registers" in line:
        out["ptxas"][entry]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
with torch.inference_mode():
    model = init_bsrnn(BSRNNConfig(num_channel=196, num_layer=6, compute_dtype="bfloat16"),
                       seed=3, device=device)
    wav = 0.1 * torch.randn((1, 4 * 48000), device=device)
    lens = torch.tensor([int(3.7 * 48000)], device=device)
    out["one_utterance_ms"] = cs._time_ms(
        lambda: bsrnn_se_apply(model, STFTConfig(), wav, 48000, lens), reps=5, warmup=2)
    model = init_bsrnn(BSRNNConfig(num_channel=192, num_layer=6, compute_dtype="bfloat16"),
                       seed=4, device=device)
    wav = 0.1 * torch.randn((64, 4 * 48000), device=device)
    out["b64_forward_ms"] = cs._time_ms(lambda: bsrnn_se_apply(model, STFTConfig(), wav, 48000),
                                        reps=3, warmup=1)
    del model, wav
out["train_step"] = cs._train_step_times(device)
# one train step of each family under FUSED_BIDIR_TRAIN (K9 and K10 on the
# band path; disc bf16 and flow f32): median of 3 after 1 warm-up
from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K
from urgent2026_challenge_track1_tpu_torch.train import trainer
out["fused_step_ms"] = {}
K.FUSED_BIDIR_TRAIN = True
for fam, cfg in (("disc_bfloat16", cs._train_config(Path("."), compute_dtype="bfloat16")),
                 ("flow_float32", cs._flow_config(Path(".")))):
    bundle = trainer.build_model(cfg)
    model = trainer.init_params(cfg.seed, bundle, device)
    opt = trainer.make_optimizer(cfg, model)
    step = trainer.make_train_step(bundle, cfg, 48000)
    if fam.startswith("disc"):
        batch = cs._train_batch(device)
    else:
        clean, noisy, _ = cs._train_batch(device, B=2)
        batch = (clean, noisy, torch.tensor([int(s * 48000) for s in cs.FLOW_SECONDS],
                                            dtype=torch.int32, device=device))
    times = []
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(model, opt, *batch, generator=trainer.step_generator(cfg.seed, i))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out["fused_step_ms"][fam] = statistics.median(times[1:])
    del model, opt
K.FUSED_BIDIR_TRAIN = False
# one float32 train step of the disc model from seeded weights (its loss and
# the updated parameters are digested below, end to end)
cfg = cs._train_config(Path("."))
bundle = trainer.build_model(cfg)
model = trainer.init_params(cfg.seed, bundle, device)
m = trainer.make_train_step(bundle, cfg, 48000)(model, trainer.make_optimizer(cfg, model),
                                                *cs._train_batch(device))
step_state = [m["loss"].detach().reshape(1)] + [p.detach() for p in model.parameters()]
del model
out["flow"] = cs._flow_step_and_enhance_times(device)
from urgent2026_challenge_track1_tpu_torch.models import bsrnn_flowse as F
from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K
fcfg = F.FlowSEConfig(compute_dtype="bfloat16")
with torch.inference_mode():
    model = F.init_flowse(fcfg, seed=11, device=device).eval()
    wav = 0.1 * torch.randn((1, 4 * 48000), device=device)
    times = []
    for i in range(6):
        gen = torch.Generator(device=device).manual_seed(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        F.flowse_enhance(model, fcfg, wav, 48000, N=15, generator=gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out["flow_enhance5_ms"] = sorted(times[1:])[2]
    del model, wav
    sms = cs._sm_count(device)
    out["k1p_ms"], out["sha256"] = {}, {}

    def digest(*ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        return h.hexdigest()

    # end to end, bit for bit: that train step, the one-utterance forward
    # (bf16) and the flow enhancement (bf16, N = 15, its prior seeded 0)
    out["sha256"]["e2e_train_step_f32"] = digest(*step_state)
    model = init_bsrnn(BSRNNConfig(num_channel=196, num_layer=6, compute_dtype="bfloat16"),
                       seed=3, device=device)
    wav = (0.1 * torch.randn((1, 4 * 48000), generator=torch.Generator().manual_seed(31))).to(
        device)
    lens = torch.tensor([int(3.7 * 48000)], device=device)
    out["sha256"]["e2e_one_utterance_bf16"] = digest(
        bsrnn_se_apply(model, STFTConfig(), wav, 48000, lens)[0])
    model = F.init_flowse(fcfg, seed=11, device=device).eval()
    out["sha256"]["e2e_flow_enhance_bf16"] = digest(F.flowse_enhance(
        model, fcfg, wav, 48000, N=15, lengths=lens,
        generator=torch.Generator(device=device).manual_seed(0)))
    del model, wav, step_state

    for _, R, T, N, H in cs.K1_ROUTE_SHAPES:
        x, wi, wh, b, _, _ = cs._kernel_inputs(R, T, torch.bfloat16, device, R + T, N, H)
        plan = K.plan_persistent(R, N, H, sms)
        out["k1p_ms"][f"{R}x{T}"] = cs._time_ms(
            lambda: K.fusedin_bilstm_persistent(x, wi, wh, b, plan))
        out["sha256"][f"k1p_{R}x{T}"] = digest(K.fusedin_bilstm_persistent(x, wi, wh, b, plan))
        del x, wi, wh, b
    # K5p (and its dW kernel) on the plain forward's residuals, each dtype
    for dtype in (torch.bfloat16, torch.float32):
        R, T, H = 804, 34, 392
        _, _, wh, _, xp, _ = cs._kernel_inputs(R, T, dtype, device, R + T, hid=H)
        dout = (0.1 * torch.randn((R, T, H), generator=torch.Generator().manual_seed(R))).to(
            device, dtype)
        res = K.lstm_train_fwd_plain(xp, wh[0])
        out["sha256"][f"k5p_{dtype}_{R}x{T}"] = digest(*K.lstm_train_bwd(*res, dout, wh[0]))
        del xp, wh, dout, res
    # K10p (bf16 and f32, its dW kernels included) at the disc band on the
    # plain forward's residuals, on each tree's routed K10 (K10p there)
    for dtype in (torch.bfloat16, torch.float32):
        R, T, H = 804, 34, 392
        _, _, wh, _, xp, _ = cs._kernel_inputs(R, T, dtype, device, R + 2 * T, hid=H)
        gen = torch.Generator().manual_seed(R + 2)
        xp_b = (0.3 * torch.randn((R, T, 4 * H), generator=gen)).to(device, dtype)
        dout = (0.1 * torch.randn((2, R, T, H), generator=gen)).to(device, dtype)
        res = K.lstm_train_fwd2_plain(xp, xp_b, wh[0], wh[1])
        dt = "bf16" if dtype == torch.bfloat16 else "f32"
        out["sha256"][f"k10p_{dt}"] = digest(*K.lstm_train_bwd2_persistent(
            res[:3], res[3:], dout[0], dout[1], wh[0], wh[1]))
        del xp, xp_b, wh, dout, res
    # K8p (bf16), K2p / K3p (bf16), K4p / K6p (bf16 and f32) and K7p (bf16) at
    # the disc train step's time path, on each tree's persistent wrappers
    # with their default plans
    R, T, N, H = 136, 201, 196, 392
    for dtype in (torch.bfloat16, torch.float32):
        x, wi, wh, b, xp, lengths = cs._kernel_inputs(R, T, dtype, device, R + T + 1, N, H)
        dt = "bf16" if dtype == torch.bfloat16 else "f32"
        out["sha256"][f"k4p_{dt}"] = digest(*K.lstm_train_fwd_persistent(xp, wh[0], True))
        res = K.lstm_revmasked_train_fwd_persistent(xp, wh[1], lengths)
        out["sha256"][f"k6p_{dt}"] = digest(*res)
        if dt == "bf16":
            out["sha256"]["k8p"] = digest(
                *K.lstm_train_fwd_streamin_persistent(x, wi[0], b[0], wh[0], False),
                *K.lstm_train_fwd_streamin_persistent(x, wi[1], b[1], wh[1], True))
            out["sha256"]["k2p"] = digest(K.lstm_scan_persistent(xp, wh[0], False))
            out["sha256"]["k3p"] = digest(K.lstm_revmasked_persistent(xp, wh[1], lengths))
            dout = (0.1 * torch.randn((R, T, H), generator=torch.Generator().manual_seed(T))).to(
                device, dtype)
            out["sha256"]["k7p"] = digest(*K.lstm_revmasked_bwd_persistent(
                *res, lengths, dout, wh[1]))
        elif K.scan_route(dtype, R, H, sms) is not None:  # a tree with K2p-f32 / K3p-f32
            out["sha256"]["k2p_f32"] = digest(K.lstm_scan_persistent(xp, wh[0], True))
            out["sha256"]["k3p_f32"] = digest(K.lstm_revmasked_persistent(xp, wh[1], lengths))
        del x, wi, wh, b, xp, lengths, res
    # K2p with a carry at the stream step (and K2p-f32's, where a tree has it)
    for dtype in (torch.bfloat16, torch.float32):
        R, T, H = 34, 8, 392
        _, _, wh, _, xp, _ = cs._kernel_inputs(R, T, dtype, device, 77, hid=H)
        gen = torch.Generator().manual_seed(78)
        h0, c0 = (0.5 * torch.randn((2, R, H), generator=gen)).unbind(0)
        if K.scan_route(dtype, R, H, sms) is not None:
            y, (hT, cT) = K.lstm_scan_persistent(xp, wh[0], False, initial_state=(
                h0.to(device, dtype), c0.to(device)), return_state=True)
            key = "k2p_carry" if dtype == torch.bfloat16 else "k2p_f32_carry"
            out["sha256"][key] = digest(y, hT, cT)
        del xp, wh
    out["scan_p_ms"] = {}
    for R, T, H, valid in ((34, 401, 392, 371), (48, 501, 768, 463)):
        _, _, wh, _, xp, _ = cs._kernel_inputs(R, T, torch.bfloat16, device, R + T + H, hid=H)
        lengths = torch.full((R,), valid, dtype=torch.int32, device=device)
        plan = K.plan_persistent(R, 0, H, sms, dirs=1)
        out["scan_p_ms"][f"k2p_{R}x{T}"] = cs._time_ms(
            lambda: K.lstm_scan_persistent(xp, wh[0], False, plan))
        out["scan_p_ms"][f"k3p_{R}x{T}"] = cs._time_ms(
            lambda: K.lstm_revmasked_persistent(xp, wh[1], lengths, plan))
        del xp, wh
    # float32 K2 and K3 through the routed wrappers: the walk, or K2p-f32 / K3p-f32
    out["scan_f32_ms"], out["scan_f32_route"] = {}, {}
    for R, T, H, valid in ((34, 401, 392, 371), (136, 201, 392, 201), (96, 251, 768, 238),
                           (48, 501, 768, 463)):
        _, _, wh, _, xp, _ = cs._kernel_inputs(R, T, torch.float32, device, R + T + H, hid=H)
        lengths = torch.full((R,), valid, dtype=torch.int32, device=device)
        out["scan_f32_ms"][f"k2_f32_{R}x{T}"] = cs._time_ms(lambda: K.lstm_scan(xp, wh[0]),
                                                          reps=3, warmup=1)
        out["scan_f32_ms"][f"k3_f32_{R}x{T}"] = cs._time_ms(
            lambda: K.lstm_revmasked(xp, wh[1], lengths), reps=3, warmup=1)
        out["scan_f32_route"][f"{R}x{T}"] = (
            "walk" if K.scan_route(torch.float32, R, H, sms) is None else "persistent")
        del xp, wh
# one float32 validation pass of each family, and the float32 causal stream step
from urgent2026_challenge_track1_tpu_torch.data.dataset import AudioDataModule
from urgent2026_challenge_track1_tpu_torch.models.streaming_causal import StreamingSession
from urgent2026_challenge_track1_tpu_torch.train import trainer
cwd = os.getcwd()
with tempfile.TemporaryDirectory(prefix="chip_ab_", dir=sys.argv[1]) as tmp:
    work = Path(tmp)
    os.chdir(work)  # the trainer writes exp/ under the working directory
    try:
        cs._write_split(work / "train", cs.TRAIN_SECONDS, 10)
        cs._write_split(work / "valid", (2.0, 1.75, 1.5, 1.25), 11)
        cs._write_split(work / "flow_train", cs.FLOW_SECONDS, 20)
        cs._write_split(work / "flow_valid", (2.0, 1.75), 21)
        out["validation_f32_ms"], out["validation_f32_routes"] = {}, {}
        for fam, cfg in (("disc", cs._train_config(work)), ("flow", cs._flow_config(work))):
            state = trainer.Trainer(cfg, AudioDataModule(cfg)).init_state()
            v = cs._validation_pass(cfg, state)
            out["validation_f32_ms"][fam] = v["ms"]
            out["validation_f32_routes"][fam] = v["routes"]
            del state
        cfg = cs._train_config(work, model_configs=dict(cs.CAUSAL_MODEL))
        bundle = trainer.build_model(cfg)
        model = trainer.init_params(cfg.seed, bundle, device).eval()
        sess = StreamingSession(model, model.cfg, STFTConfig(), 48000,
                                chunk_frames=cs.CAUSAL_CHUNK)
        step_ms, inner = [], sess._step

        def timed_step(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = inner(*args)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return res

        sess._step = timed_step
        n = int(cs.CAUSAL_SECONDS * 48000)
        t = np.arange(n) / 48000
        rng = np.random.default_rng(21)
        wav = (0.3 * np.sin(2 * np.pi * 220.0 * t) + 0.05 * rng.standard_normal(n)).astype(
            np.float32)[None]
        K.reset_launch_counts()
        cs._stream(sess, wav)
        out["f32_stream_step"] = {"median_ms": statistics.median(step_ms),
                                  "p95_ms": float(np.percentile(step_ms, 95)),
                                  "steps": len(step_ms), "k2_routes": K.route_counts("lstm_scan")}
        del model
    finally:
        os.chdir(cwd)
print("[ab] " + json.dumps(out), flush=True)
'''


def _summary(visits):
    keys = {"one_utterance_ms": lambda v: v["one_utterance_ms"],
            "b64_forward_ms": lambda v: v["b64_forward_ms"]}
    for fam, part in (("disc", "train_step"), ("flow", "flow")):
        for dt in ("float32", "bfloat16"):
            keys[f"{fam}_step_{dt}_ms"] = lambda v, p=part, d=dt: v[p][d]["median_ms"]
            keys[f"{fam}_step_{dt}_peak_gb"] = lambda v, p=part, d=dt: v[p][d]["peak_memory_gb"]
    for fam in ("disc_bfloat16", "flow_float32"):
        keys[f"fused_step_{fam}_ms"] = lambda v, f=fam: v["fused_step_ms"][f]
    keys["flow_enhance_ms"] = lambda v: v["flow"]["enhance"]["ms"]
    keys["flow_enhance5_ms"] = lambda v: v["flow_enhance5_ms"]
    for shape in visits[0]["k1p_ms"]:
        keys[f"k1p_{shape}_ms"] = lambda v, s=shape: v["k1p_ms"][s]
    for shape in visits[0]["scan_p_ms"]:
        keys[f"{shape}_ms"] = lambda v, s=shape: v["scan_p_ms"][s]
    for shape in visits[0]["scan_f32_ms"]:
        keys[f"{shape}_ms"] = lambda v, s=shape: v["scan_f32_ms"][s]
    for fam in ("disc", "flow"):
        keys[f"validation_f32_{fam}_ms"] = lambda v, f=fam: v["validation_f32_ms"][f]
    for q in ("median_ms", "p95_ms"):
        keys[f"f32_stream_step_{q}"] = lambda v, q=q: v["f32_stream_step"][q]
    trees = {}
    for v in visits:
        for k, get in keys.items():
            trees.setdefault(v["tree"], {}).setdefault(k, []).append(get(v))
    return {tree: {k: {"each": vals, "median": statistics.median(vals)}
                   for k, vals in metrics.items()} for tree, metrics in trees.items()}


def _sass(library: str) -> dict:
    """{key: instructions} of the persistent kernels in a built library:
    the ``fusedin_persistent_kernel`` instances (K1p, K8p, K1p-f32,
    K8p-f32) keyed (kernel, "bf16" or "f32", STORE), the
    ``scan_persistent_kernel`` instances (K2p-K6p and their float32 routes)
    keyed (kernel, "bf16" or "f32", REVERSE, MASKED, STORE), the
    ``bwd_persistent_kernel`` instances keyed (kernel, "bf16" or "f32",
    MASKED), the ``bwd2_persistent_kernel`` instances (K10p) keyed (kernel,
    "bf16" or "f32"), and the dW kernels (dw_tc_kernel, dw_tf32_kernel)."""
    from urgent2026_challenge_track1_tpu_torch.ops._build import find_nvcc

    cuobjdump = Path(find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", library], capture_output=True, text=True,
                          check=True).stdout
    kernels, body = {}, None
    for line in text.splitlines():
        head = re.search(r"Function : \S*?(fusedin_persistent_kernel|scan_persistent_kernel|"
                         r"bwd2?_persistent_kernel|dw_tc_kernel|dw_tf32_kernel)"
                         r"(?:I(13__nv_bfloat16|f)?((?:Lb[01]E)*)E)?", line)
        if "Function :" in line:
            body = None
            if head:
                name, f32 = head.group(1), head.group(2) == "f"
                flags = tuple(int(f) for f in re.findall(r"Lb([01])E", head.group(3) or ""))
                if name in ("fusedin_persistent_kernel", "scan_persistent_kernel",
                            "bwd_persistent_kernel", "bwd2_persistent_kernel"):
                    body = kernels.setdefault((name, "f32" if f32 else "bf16", *flags), [])
                elif name in ("dw_tc_kernel", "dw_tf32_kernel"):
                    body = kernels.setdefault((name,), [])
            continue
        instr = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if body is not None and instr:
            body.append(instr.group(1))
    return kernels


def main(argv) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    visits = []
    for tree in argv:
        path = Path(tree).resolve()
        if not (path / "chip_smoke.py").is_file():
            print(f"chip_ab: {tree} holds no chip_smoke.py", file=sys.stderr)
            return 2
        proc = subprocess.run([sys.executable, "-c", _VISIT, str(path)], capture_output=True,
                              text=True, cwd=path)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("[ab] ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            print(f"chip_ab: the visit of {tree} failed ({proc.returncode})", file=sys.stderr)
            return 1
        print(lines[-1], flush=True)
        visits.append(json.loads(lines[-1][5:]))
    first = _sass(visits[0]["library"])
    for v in visits[1:]:
        other = _sass(v["library"])
        same = {" ".join(map(str, k)): other.get(k) == body for k, body in first.items()}
        print("[ab] sass " + json.dumps({"tree": v["tree"], "same_as_first_tree": same}))
        same = {k: v["sha256"].get(k) == h for k, h in visits[0]["sha256"].items()}
        print("[ab] outputs " + json.dumps({"tree": v["tree"], "bitwise_first_tree": same}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(json.dumps({"ab_summary": _summary(visits)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
