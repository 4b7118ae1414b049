"""LSTM recurrence kernels: wrappers over ``csrc/lstm_kernels.cu`` and their
plain PyTorch versions (counterpart of ``ops/pallas_lstm.py``).

Each wrapper takes its plain version for tensors on the CPU and launches its
CUDA kernel for tensors on the card; there is no fallback from one to the
other.  Each wrapper counts its kernel launches in ``<wrapper>.launches``,
which only a launch increments.

Shapes (R rows, T steps, N inputs, H hidden units; dtype float32 or
bfloat16, h and c always float32):

  fusedin_bilstm  x (R, T, N), w_ih_t (2, N, 4H), w_hh_t (2, H, 4H),
                  bias (2, 4H)                        -> (R, T, 2H)
  lstm_scan       x_proj (R, T, 4H), w_hh_t (H, 4H)   -> (R, T, H)
  lstm_revmasked  x_proj (R, T, 4H), w_hh_t (H, 4H),
                  lengths (R,) int32                   -> (R, T, H)

Index 0 of the stacked K1 weights is the forward direction, 1 the backward.
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = [
    "fusedin_bilstm",
    "lstm_scan",
    "lstm_revmasked",
    "fusedin_bilstm_plain",
    "lstm_scan_plain",
    "lstm_revmasked_plain",
    "KERNELS",
    "reset_launch_counts",
    "launch_counts",
]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HIDDEN = 512  # one thread per hidden unit, at most 512 threads a block


# ---------------------------------------------------------------------------
# Plain versions (the arithmetic of the kernels, one step at a time)
# ---------------------------------------------------------------------------


def _cell(gates: torch.Tensor, c: torch.Tensor):
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def _recurrence_plain(x_proj, w_hh_t, reverse, lengths=None):
    """Shared loop of K2 and K3: gates = x_proj_t + round(h) W_hh^T in f32."""
    R, T, G = x_proj.shape
    H = G // 4
    dtype = x_proj.dtype
    w = w_hh_t.float()
    h = x_proj.new_zeros((R, H), dtype=torch.float32)
    c = torch.zeros_like(h)
    out = x_proj.new_empty((R, T, H))
    for s in range(T):
        t = T - 1 - s if reverse else s
        gates = x_proj[:, t].float() + h.to(dtype).float() @ w
        h, c = _cell(gates, c)
        out[:, t] = h.to(dtype)
        if lengths is not None:
            m = (t < lengths).to(torch.float32)[:, None]
            h, c = h * m, c * m
    return out


def lstm_scan_plain(x_proj: torch.Tensor, w_hh_t: torch.Tensor,
                    reverse: bool = False) -> torch.Tensor:
    """Plain version of ``lstm_scan``."""
    return _recurrence_plain(x_proj, w_hh_t, reverse)


def lstm_revmasked_plain(x_proj: torch.Tensor, w_hh_t: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """Plain version of ``lstm_revmasked``: the reverse walk that zeroes h and
    c after each step t >= lengths[r] (outputs there are unmasked)."""
    return _recurrence_plain(x_proj, w_hh_t, True, lengths.to(x_proj.device))


def fusedin_bilstm_plain(x: torch.Tensor, w_ih_t: torch.Tensor,
                         w_hh_t: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain version of ``fusedin_bilstm``: x W_ih^T + b in f32 for every step,
    then each direction's recurrence."""
    R, T, _ = x.shape
    H = w_hh_t.shape[1]
    dtype = x.dtype
    outs = []
    for d in range(2):
        # f32 sums of dtype products, like the kernel's in-step product
        xw = x.float() @ w_ih_t[d].float() + bias[d].float()
        w = w_hh_t[d].float()
        h = xw.new_zeros((R, H))
        c = torch.zeros_like(h)
        out = x.new_empty((R, T, H))
        for s in range(T):
            t = T - 1 - s if d else s
            h, c = _cell(xw[:, t] + h.to(dtype).float() @ w, c)
            out[:, t] = h.to(dtype)
        outs.append(out)
    return torch.cat(outs, dim=-1)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _kernel_args(x: torch.Tensor, H: int):
    if x.device.type != "cuda":
        raise ValueError(f"kernel input on unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"kernel input dtype {x.dtype}: float32 or bfloat16 only")
    if not 0 < H <= MAX_HIDDEN:
        raise ValueError(f"hidden size {H} outside 1..{MAX_HIDDEN}")
    return _DTYPES[x.dtype], ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def rows_per_block(R: int, grid_y: int, device: torch.device) -> int:
    """The largest row tile (8, 4, 2, 1) whose grid still covers every SM:
    few rows (the batch-1 time path) go to many small blocks, many rows to
    fewer blocks that share each weight read over more rows."""
    sms = _sm_count(device.index if device.index is not None else torch.cuda.current_device())
    for rows in (8, 4, 2):
        if -(-R // rows) * grid_y >= sms:
            return rows
    return 1


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def fusedin_bilstm(x: torch.Tensor, w_ih_t: torch.Tensor, w_hh_t: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """K1: bidirectional LSTM on the raw input; (R, T, N) -> (R, T, 2H)."""
    if x.device.type == "cpu":
        return fusedin_bilstm_plain(x, w_ih_t, w_hh_t, bias)
    R, T, N = x.shape
    H = w_hh_t.shape[1]
    dtype, stream = _kernel_args(x, H)
    _check("x", x, (R, T, N), x.dtype, x.device)
    _check("w_ih_t", w_ih_t, (2, N, 4 * H), x.dtype, x.device)
    _check("w_hh_t", w_hh_t, (2, H, 4 * H), x.dtype, x.device)
    _check("bias", bias, (2, 4 * H), x.dtype, x.device)
    out = torch.empty((R, T, 2 * H), dtype=x.dtype, device=x.device)
    if R == 0 or T == 0:
        return out
    from urgent2026_challenge_track1_tpu_torch.ops._build import load_library

    err = load_library().lstm_fusedin_bilstm(
        x.data_ptr(), w_ih_t.data_ptr(), w_hh_t.data_ptr(), bias.data_ptr(),
        out.data_ptr(), R, T, N, H, dtype, rows_per_block(R, 2, x.device), stream,
    )
    _raise_on(err, "fusedin_bilstm")
    fusedin_bilstm.launches += 1
    return out


def lstm_scan(x_proj: torch.Tensor, w_hh_t: torch.Tensor,
              reverse: bool = False) -> torch.Tensor:
    """K2: one direction over a hoisted projection; (R, T, 4H) -> (R, T, H)."""
    if x_proj.device.type == "cpu":
        return lstm_scan_plain(x_proj, w_hh_t, reverse)
    R, T, G = x_proj.shape
    H = G // 4
    dtype, stream = _kernel_args(x_proj, H)
    _check("x_proj", x_proj, (R, T, 4 * H), x_proj.dtype, x_proj.device)
    _check("w_hh_t", w_hh_t, (H, 4 * H), x_proj.dtype, x_proj.device)
    out = torch.empty((R, T, H), dtype=x_proj.dtype, device=x_proj.device)
    if R == 0 or T == 0:
        return out
    from urgent2026_challenge_track1_tpu_torch.ops._build import load_library

    err = load_library().lstm_scan(
        x_proj.data_ptr(), w_hh_t.data_ptr(), out.data_ptr(), R, T, H,
        int(bool(reverse)), dtype, rows_per_block(R, 1, x_proj.device), stream,
    )
    _raise_on(err, "lstm_scan")
    lstm_scan.launches += 1
    return out


def lstm_revmasked(x_proj: torch.Tensor, w_hh_t: torch.Tensor,
                   lengths: torch.Tensor) -> torch.Tensor:
    """K3: length-masked reverse walk; (R, T, 4H), (R,) -> (R, T, H).
    Outputs at t < lengths[r] equal a fresh reverse scan of the valid prefix;
    outputs at t >= lengths[r] are unspecified."""
    if x_proj.device.type == "cpu":
        return lstm_revmasked_plain(x_proj, w_hh_t, lengths)
    R, T, G = x_proj.shape
    H = G // 4
    dtype, stream = _kernel_args(x_proj, H)
    _check("x_proj", x_proj, (R, T, 4 * H), x_proj.dtype, x_proj.device)
    _check("w_hh_t", w_hh_t, (H, 4 * H), x_proj.dtype, x_proj.device)
    _check("lengths", lengths, (R,), torch.int32, x_proj.device)
    out = torch.empty((R, T, H), dtype=x_proj.dtype, device=x_proj.device)
    if R == 0 or T == 0:
        return out
    from urgent2026_challenge_track1_tpu_torch.ops._build import load_library

    err = load_library().lstm_revmasked(
        x_proj.data_ptr(), w_hh_t.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        R, T, H, dtype, rows_per_block(R, 1, x_proj.device), stream,
    )
    _raise_on(err, "lstm_revmasked")
    lstm_revmasked.launches += 1
    return out


KERNELS = (fusedin_bilstm, lstm_scan, lstm_revmasked)
for _fn in KERNELS:
    _fn.launches = 0


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNELS}
