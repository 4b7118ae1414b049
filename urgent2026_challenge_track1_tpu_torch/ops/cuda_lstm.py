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

  lstm_train_fwd            (K4) as lstm_scan      -> h, gates (R, T, 4H), c
  lstm_revmasked_train_fwd  (K6) as lstm_revmasked -> h, gates, c
  lstm_train_bwd            (K5) h, gates, c, dout (R, T, H), w_hh_t
                                                   -> dx_proj, dW_hh^T (H, 4H)
  lstm_revmasked_bwd        (K7) as K5, with lengths

Index 0 of the stacked K1 weights is the forward direction, 1 the backward.
``LSTMDirTrain`` (K4/K5) and ``LSTMRevMaskedTrain`` (K6/K7) are the autograd
Functions of the training path; ``lstm_dir`` and ``lstm_dir_revmasked``
route to them when autograd records and to the lean K2/K3 otherwise.
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
    "lstm_train_fwd",
    "lstm_train_bwd",
    "lstm_revmasked_train_fwd",
    "lstm_revmasked_bwd",
    "lstm_train_fwd_plain",
    "lstm_train_bwd_plain",
    "lstm_revmasked_train_fwd_plain",
    "lstm_revmasked_bwd_plain",
    "LSTMDirTrain",
    "LSTMRevMaskedTrain",
    "lstm_dir",
    "lstm_dir_revmasked",
    "needs_grad",
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
    """One cell update in f32: returns (h, c, post-activation gates i, f, g, o)."""
    i, f, g, o = gates.chunk(4, dim=-1)
    i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
    c = f * c + i * g
    return o * torch.tanh(c), c, torch.cat([i, f, g, o], dim=-1)


def _walk_plain(x_proj, w_hh_t, reverse, lengths=None):
    """Shared loop of K2/K3 and K4/K6: gates = x_proj_t + round(h) W_hh^T in
    f32; returns h, the post-activation gates and c, stored in x_proj's
    dtype (h and c unmasked).  Differentiable by autograd."""
    R, T, G = x_proj.shape
    H = G // 4
    dtype = x_proj.dtype
    w = w_hh_t.float()
    h = x_proj.new_zeros((R, H), dtype=torch.float32)
    c = torch.zeros_like(h)
    out = x_proj.new_empty((R, T, H))
    gates = x_proj.new_empty((R, T, G))
    cs = x_proj.new_empty((R, T, H))
    for s in range(T):
        t = T - 1 - s if reverse else s
        h, c, act = _cell(x_proj[:, t].float() + h.to(dtype).float() @ w, c)
        out[:, t] = h.to(dtype)
        gates[:, t] = act.to(dtype)
        cs[:, t] = c.to(dtype)
        if lengths is not None:
            m = (t < lengths).to(torch.float32)[:, None]
            h, c = h * m, c * m
    return out, gates, cs


def _backward_plain(h, gates, c, dout, w_hh_t, reverse, lengths=None):
    """Shared loop of K5 and K7: walks the scan backwards from the stored
    residuals; dgates is rounded to the residuals' dtype before both
    products, dW_hh^T is one f32 product over every (row, step) at the end."""
    R, T, G = gates.shape
    H = G // 4
    dtype = gates.dtype
    w4h = w_hh_t.float().t()  # (4H, H)
    dh = gates.new_zeros((R, H), dtype=torch.float32)
    dc = torch.zeros_like(dh)
    dxp = gates.new_empty((R, T, G))
    h_prev = gates.new_zeros((R, T, H), dtype=torch.float32)
    one = torch.ones((R, 1), device=gates.device)
    for s in range(T):
        t = s if reverse else T - 1 - s
        tp = t + 1 if reverse else t - 1
        i, f, g, o = gates[:, t].float().chunk(4, dim=-1)
        m = one if lengths is None else (t < lengths).to(torch.float32)[:, None]
        mp = one if lengths is None else (tp < lengths).to(torch.float32)[:, None]
        if 0 <= tp < T:
            cp = c[:, tp].float() * mp
            h_prev[:, t] = h[:, tp].float() * mp
        else:
            cp = torch.zeros_like(dc)
        tc = torch.tanh(f * cp + i * g)
        dhv = dout[:, t].float() + dh * m
        dcv = dc * m + dhv * o * (1.0 - tc * tc)
        dg = torch.cat([dcv * g * i * (1.0 - i), dcv * cp * f * (1.0 - f),
                        dcv * i * (1.0 - g * g), dhv * tc * o * (1.0 - o)], dim=-1).to(dtype)
        dxp[:, t] = dg
        dh = dg.float() @ w4h
        dc = dcv * f
    dw = h_prev.reshape(-1, H).t() @ dxp.reshape(-1, G).float()
    return dxp, dw.to(w_hh_t.dtype)


def lstm_scan_plain(x_proj: torch.Tensor, w_hh_t: torch.Tensor,
                    reverse: bool = False) -> torch.Tensor:
    """Plain version of ``lstm_scan``."""
    return _walk_plain(x_proj, w_hh_t, reverse)[0]


def lstm_revmasked_plain(x_proj: torch.Tensor, w_hh_t: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """Plain version of ``lstm_revmasked``: the reverse walk that zeroes h and
    c after each step t >= lengths[r] (outputs there are unmasked)."""
    return _walk_plain(x_proj, w_hh_t, True, lengths.to(x_proj.device))[0]


def lstm_train_fwd_plain(x_proj: torch.Tensor, w_hh_t: torch.Tensor,
                         reverse: bool = False):
    """Plain version of ``lstm_train_fwd``: (h, gates, c)."""
    return _walk_plain(x_proj, w_hh_t, reverse)


def lstm_revmasked_train_fwd_plain(x_proj: torch.Tensor, w_hh_t: torch.Tensor,
                                   lengths: torch.Tensor):
    """Plain version of ``lstm_revmasked_train_fwd``: (h, gates, c)."""
    return _walk_plain(x_proj, w_hh_t, True, lengths.to(x_proj.device))


def lstm_train_bwd_plain(h: torch.Tensor, gates: torch.Tensor, c: torch.Tensor,
                         dout: torch.Tensor, w_hh_t: torch.Tensor, reverse: bool = False):
    """Plain version of ``lstm_train_bwd``: (dx_proj, dW_hh^T)."""
    return _backward_plain(h, gates, c, dout, w_hh_t, reverse)


def lstm_revmasked_bwd_plain(h: torch.Tensor, gates: torch.Tensor, c: torch.Tensor,
                             lengths: torch.Tensor, dout: torch.Tensor,
                             w_hh_t: torch.Tensor):
    """Plain version of ``lstm_revmasked_bwd``: (dx_proj, dW_hh^T)."""
    return _backward_plain(h, gates, c, dout, w_hh_t, True, lengths.to(gates.device))


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
            h, c, _ = _cell(xw[:, t] + h.to(dtype).float() @ w, c)
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


def _train_outputs(x_proj: torch.Tensor, H: int):
    R, T, _ = x_proj.shape
    return (torch.empty((R, T, H), dtype=x_proj.dtype, device=x_proj.device),
            torch.empty((R, T, 4 * H), dtype=x_proj.dtype, device=x_proj.device),
            torch.empty((R, T, H), dtype=x_proj.dtype, device=x_proj.device))


def lstm_train_fwd(x_proj: torch.Tensor, w_hh_t: torch.Tensor, reverse: bool = False):
    """K4: ``lstm_scan`` that also returns the backward's residuals;
    (R, T, 4H) -> (h (R, T, H), gates i, f, g, o (R, T, 4H), c (R, T, H)),
    all in x_proj's dtype."""
    if x_proj.device.type == "cpu":
        return lstm_train_fwd_plain(x_proj, w_hh_t, reverse)
    R, T, G = x_proj.shape
    H = G // 4
    dtype, stream = _kernel_args(x_proj, H)
    _check("x_proj", x_proj, (R, T, 4 * H), x_proj.dtype, x_proj.device)
    _check("w_hh_t", w_hh_t, (H, 4 * H), x_proj.dtype, x_proj.device)
    out, gates, c = _train_outputs(x_proj, H)
    if R == 0 or T == 0:
        return out, gates, c
    from urgent2026_challenge_track1_tpu_torch.ops._build import load_library

    err = load_library().lstm_train_fwd(
        x_proj.data_ptr(), w_hh_t.data_ptr(), out.data_ptr(), gates.data_ptr(), c.data_ptr(),
        R, T, H, int(bool(reverse)), dtype, rows_per_block(R, 1, x_proj.device), stream,
    )
    _raise_on(err, "lstm_train_fwd")
    lstm_train_fwd.launches += 1
    return out, gates, c


def lstm_revmasked_train_fwd(x_proj: torch.Tensor, w_hh_t: torch.Tensor,
                             lengths: torch.Tensor):
    """K6: ``lstm_revmasked`` that also returns the backward's residuals
    (h and c unmasked), as ``lstm_train_fwd``."""
    if x_proj.device.type == "cpu":
        return lstm_revmasked_train_fwd_plain(x_proj, w_hh_t, lengths)
    R, T, G = x_proj.shape
    H = G // 4
    dtype, stream = _kernel_args(x_proj, H)
    _check("x_proj", x_proj, (R, T, 4 * H), x_proj.dtype, x_proj.device)
    _check("w_hh_t", w_hh_t, (H, 4 * H), x_proj.dtype, x_proj.device)
    _check("lengths", lengths, (R,), torch.int32, x_proj.device)
    out, gates, c = _train_outputs(x_proj, H)
    if R == 0 or T == 0:
        return out, gates, c
    from urgent2026_challenge_track1_tpu_torch.ops._build import load_library

    err = load_library().lstm_revmasked_train_fwd(
        x_proj.data_ptr(), w_hh_t.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        gates.data_ptr(), c.data_ptr(), R, T, H, dtype,
        rows_per_block(R, 1, x_proj.device), stream,
    )
    _raise_on(err, "lstm_revmasked_train_fwd")
    lstm_revmasked_train_fwd.launches += 1
    return out, gates, c


def _check_residuals(h, gates, c, dout, w_hh_t):
    R, T, G = gates.shape
    H = G // 4
    dtype, stream = _kernel_args(gates, H)
    _check("gates", gates, (R, T, 4 * H), gates.dtype, gates.device)
    for name, t in (("c", c), ("h", h), ("dout", dout)):
        _check(name, t, (R, T, H), gates.dtype, gates.device)
    _check("w_hh_t", w_hh_t, (H, 4 * H), gates.dtype, gates.device)
    dxp = torch.empty((R, T, 4 * H), dtype=gates.dtype, device=gates.device)
    dw = torch.empty((H, 4 * H), dtype=torch.float32, device=gates.device)
    # W_hh in its (4H, H) layout: the dh product reads it coalesced over units
    return R, T, H, dtype, stream, w_hh_t.t().contiguous(), dxp, dw


def lstm_train_bwd(h: torch.Tensor, gates: torch.Tensor, c: torch.Tensor,
                   dout: torch.Tensor, w_hh_t: torch.Tensor, reverse: bool = False):
    """K5: the backward of ``lstm_train_fwd`` from its outputs (h, gates, c) and the
    incoming dh (R, T, H) -> (dx_proj (R, T, 4H), dW_hh^T (H, 4H)), dW
    summed in f32 by the kernel and returned in w_hh_t's dtype."""
    if gates.device.type == "cpu":
        return lstm_train_bwd_plain(h, gates, c, dout, w_hh_t, reverse)
    R, T, H, dtype, stream, w4h, dxp, dw = _check_residuals(h, gates, c, dout, w_hh_t)
    if R == 0 or T == 0:
        return dxp, dw.to(w_hh_t.dtype)
    from urgent2026_challenge_track1_tpu_torch.ops._build import load_library

    err = load_library().lstm_train_bwd(
        gates.data_ptr(), c.data_ptr(), h.data_ptr(), dout.data_ptr(), w4h.data_ptr(),
        dxp.data_ptr(), dw.data_ptr(), R, T, H, int(bool(reverse)), dtype,
        rows_per_block(R, 1, gates.device), stream,
    )
    _raise_on(err, "lstm_train_bwd")
    lstm_train_bwd.launches += 1
    return dxp, dw.to(w_hh_t.dtype)


def lstm_revmasked_bwd(h: torch.Tensor, gates: torch.Tensor, c: torch.Tensor,
                       lengths: torch.Tensor, dout: torch.Tensor, w_hh_t: torch.Tensor):
    """K7: the backward of ``lstm_revmasked_train_fwd``, as ``lstm_train_bwd``."""
    if gates.device.type == "cpu":
        return lstm_revmasked_bwd_plain(h, gates, c, lengths, dout, w_hh_t)
    R, T, H, dtype, stream, w4h, dxp, dw = _check_residuals(h, gates, c, dout, w_hh_t)
    _check("lengths", lengths, (R,), torch.int32, gates.device)
    if R == 0 or T == 0:
        return dxp, dw.to(w_hh_t.dtype)
    from urgent2026_challenge_track1_tpu_torch.ops._build import load_library

    err = load_library().lstm_revmasked_bwd(
        gates.data_ptr(), c.data_ptr(), h.data_ptr(), lengths.data_ptr(), dout.data_ptr(),
        w4h.data_ptr(), dxp.data_ptr(), dw.data_ptr(), R, T, H, dtype,
        rows_per_block(R, 1, gates.device), stream,
    )
    _raise_on(err, "lstm_revmasked_bwd")
    lstm_revmasked_bwd.launches += 1
    return dxp, dw.to(w_hh_t.dtype)


# ---------------------------------------------------------------------------
# Differentiable recurrences (the custom VJPs of pallas_lstm.py)
# ---------------------------------------------------------------------------


class LSTMDirTrain(torch.autograd.Function):
    """One direction over a hoisted projection, (R, T, 4H), (H, 4H) ->
    (R, T, H); forward K4, backward K5 (``lstm_pallas_train``'s VJP)."""

    @staticmethod
    def forward(ctx, x_proj, w_hh_t, reverse):
        out, gates, c = lstm_train_fwd(x_proj, w_hh_t, reverse)
        ctx.save_for_backward(out, gates, c, w_hh_t)
        ctx.reverse = reverse
        return out

    @staticmethod
    def backward(ctx, dout):
        out, gates, c, w_hh_t = ctx.saved_tensors
        dxp, dw = lstm_train_bwd(out, gates, c, dout.to(out.dtype).contiguous(), w_hh_t,
                                 ctx.reverse)
        return dxp, dw, None


class LSTMRevMaskedTrain(torch.autograd.Function):
    """The length-masked reverse walk, (R, T, 4H), (H, 4H), (R,) int32 ->
    (R, T, H); forward K6, backward K7 (``lstm_pallas_train_revmasked``'s
    VJP).  ``lengths`` gets no gradient."""

    @staticmethod
    def forward(ctx, x_proj, w_hh_t, lengths):
        out, gates, c = lstm_revmasked_train_fwd(x_proj, w_hh_t, lengths)
        ctx.save_for_backward(out, gates, c, w_hh_t, lengths)
        return out

    @staticmethod
    def backward(ctx, dout):
        out, gates, c, w_hh_t, lengths = ctx.saved_tensors
        dxp, dw = lstm_revmasked_bwd(out, gates, c, lengths,
                                     dout.to(out.dtype).contiguous(), w_hh_t)
        return dxp, dw, None


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd records an op on any of ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def lstm_dir(x_proj: torch.Tensor, w_hh_t: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """One direction, differentiable: ``LSTMDirTrain`` (K4, K5) when autograd
    records, the lean ``lstm_scan`` (K2) otherwise."""
    if needs_grad(x_proj, w_hh_t):
        return LSTMDirTrain.apply(x_proj, w_hh_t, reverse)
    return lstm_scan(x_proj, w_hh_t, reverse)


def lstm_dir_revmasked(x_proj: torch.Tensor, w_hh_t: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
    """The masked reverse walk, differentiable: ``LSTMRevMaskedTrain`` (K6,
    K7) when autograd records, the lean ``lstm_revmasked`` (K3) otherwise."""
    if needs_grad(x_proj, w_hh_t):
        return LSTMRevMaskedTrain.apply(x_proj, w_hh_t, lengths)
    return lstm_revmasked(x_proj, w_hh_t, lengths)


KERNELS = (fusedin_bilstm, lstm_scan, lstm_revmasked, lstm_train_fwd, lstm_train_bwd,
           lstm_revmasked_train_fwd, lstm_revmasked_bwd)
for _fn in KERNELS:
    _fn.launches = 0


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNELS}
