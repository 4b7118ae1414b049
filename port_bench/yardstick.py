"""The yardstick: the H100's peaks, the least time of a piece of work, the
model's operations counted from the traffic's shapes, and the grouping of
device kernels by name.

Copies, kept here so that a change to the program cannot move them:
``_names``, ``_flags``, ``_group`` and ``_union_us`` from
``urgent2026_challenge_track1_tpu_torch/profile_forward.py``; the peaks and
``_bound`` from ``chip_smoke.py``.  ``model_flops`` and ``lstm_least_s``
are the benchmark's own; ``lstm_least_s`` applies ``_bound`` to the whole
LSTM op's work, where ``chip_smoke.py``'s per-kernel bounds each count one
kernel's.
"""

from __future__ import annotations

import re

from port_bench.reference import common as C

PEAK_BF16_FLOPS = 989e12        # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_TF32_FLOPS = 495e12        # H100 SXM dense TF32, same source
PEAK_BYTES = 3.35e12            # HBM3


# --- the bound (copied from chip_smoke.py) ---


def _bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# --- kernel names (copied from profile_forward.py) ---


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


# --- the benchmark's own counts ---


def peak_flops(dtype: str) -> float:
    """The card's peak for a configuration's compute dtype: bf16, or TF32
    (the tensor-core rate of the port's 3xTF32 float32 kernels), so that
    no float32 share can pass 100 %."""
    return PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_TF32_FLOPS


def utterance_shape(dims: dict, fs: int, n_samples: int) -> tuple[int, int, tuple]:
    """(valid frames, bands, band widths) of one utterance."""
    n_fft, hop = C.geometry(dims["n_fft"], dims["hop"], fs)
    K = C.n_bands(dims["input_dim"], fs, n_fft // 2 + 1)
    return C.frames(n_samples, n_fft, hop), K, C.subbands(dims["input_dim"])[:K]


def lstm_step_flops(dims: dict) -> int:
    """Forward operations of one (row, step) of one direction of one BLSTM:
    the input and the recurrent product."""
    N, H = dims["N"], 2 * dims["N"]
    return 2 * 4 * H * (N + H)


def model_flops(dims: dict, fs: int, n_samples: int) -> int:
    """Forward operations of one network call on one utterance, counted
    over its valid frames: every product of the band split(s), the flow
    model's condition projection, each layer's two BLSTMs (input and
    recurrent products, both directions) and two projections, and the two
    decoder heads (the flow heads' 5x5 convolution included).  The STFTs,
    norms and nonlinearities are not counted."""
    T, K, subs = utterance_shape(dims, fs, n_samples)
    N, H = dims["N"], 2 * dims["N"]
    flow = dims["sub_channel"] is not None
    total = (2 if flow else 1) * 2 * T * N * sum(2 * s for s in subs)
    if flow:
        total += 2 * T * K * 2 * N * N
    layer = 2 * 2 * K * T * lstm_step_flops(dims) + 2 * 2 * K * T * 2 * H * N
    total += dims["layers"] * layer
    if flow:
        sc = dims["sub_channel"]
        head = sum(2 * T * N * sc * s for s in subs) + 2 * T * sum(subs) * 25 * sc * 4
    else:
        head = sum(2 * T * N * 4 * N + 2 * 2 * T * 4 * N * 2 * s for s in subs)
    return total + 2 * head


def lstm_least_s(dims: dict, fs: int, lengths, training: bool, dtype: str) -> float:
    """Least time (s) of the LSTM op's work on one batch of utterances of
    ``lengths`` samples at ``fs`` (real rows only, valid steps only): for
    each layer and each of its two BLSTMs (time and band, the same row-steps),
    the larger of operations over the peak and bytes over 3.35 TB/s.
    Forward: the input and recurrent products of both directions, reading
    x and the weights once and writing h.  Training adds the backward's dx,
    dh, dW_ih and dW_hh (twice the forward's operations), reading dh and
    writing dx and the float32 weight gradients."""
    N, H = dims["N"], 2 * dims["N"]
    steps = 0
    for n in lengths:
        T, K, _ = utterance_shape(dims, fs, n)
        steps += K * T
    b = 2 if dtype == "bfloat16" else 4
    weights = 2 * (4 * H * (N + H) + 4 * H)  # both directions
    ops = 2 * steps * lstm_step_flops(dims)
    nbytes = b * (steps * (N + 2 * H) + weights)
    if training:
        ops *= 3
        nbytes += b * steps * (2 * H + N) + 4 * weights
    one_ms, _ = _bound(ops, nbytes, peak_flops(dtype))
    return 2 * dims["layers"] * one_ms / 1e3
