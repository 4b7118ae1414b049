"""The limits that hold K1p-K8p and K10p against their plain versions, and
the planted barrier faults that the limits must see.

A persistent kernel exchanges h between CTAs through its output, one
barrier per step.  A barrier that lets a step read the exchange buffer
before the previous step's writes land feeds the cell h one step stale
(h_{t-2} where h_{t-1} is due).  The ``*_stale_h`` functions are the plain
walks with exactly that fault (``lstm_train_fwd_streamin_stale_h``: K8p's),
and ``lstm_train_bwd_stale_dg`` the plain backward whose exchange (the
dgates in dx_proj) is one step stale (K10p's, per direction); a check
passes only if the kernel is within ``ulp_limit`` (bfloat16) or
``F32_LIMIT`` (the float32 routes K2p-f32 - K6p-f32, K1p-f32, K8p-f32) of the
plain version and the faulty walk is not; ``persistent_limit`` picks the
one for the output's dtype.  ``lstm_scan_tf32``, the plain walk whose
product is one TF32 product, is the float32 limit's control (and
``fusedin_bilstm_tf32``, ``lstm_train_fwd_streamin_tf32`` for K1p-f32 and
K8p-f32, whose input and recurrent products are each one TF32 product): it
must exceed ``F32_LIMIT`` too, so the check tells the 3xTF32 kernel from
one that computes below float32.  The float32
backwards (K5p-f32, K7p-f32) are held within ``F32_BWD_LIMIT`` of max|plain
dx_proj| (``bwd_limit``), with ``lstm_train_bwd_tf32``, the plain
backward whose dh product is one TF32 product, as that limit's control.
K2 with a carry (K2p, K2p-f32 and the walk) is held by
``scan_carry_report``: h at every step, hT and cT against the plain
version's last state within ``carry_limit`` (``ulp_limit`` on K2p,
``F32_LIMIT`` on K2p-f32, ``WALK_F32_TOL`` on the float32 walk, the K2
walk's limit), hT equal to the kernel's own last h, and
``lstm_scan_dropped_carry``, the plain walk that drops (h0, c0) and starts
from zeros, beyond the limit.
Used by ``chip_smoke.py`` and the card tests
(tests/test_torch_cuda_kernels.py).
"""

from __future__ import annotations

import math

import torch

from urgent2026_challenge_track1_tpu_torch.ops.cuda_lstm import (
    _cell, lstm_bwd_dw_plain, lstm_scan_plain)

__all__ = ["PERSISTENT_ULPS", "F32_LIMIT", "F32_BWD_LIMIT", "DW_F32_BOUND", "WALK_F32_TOL",
           "ulp_limit", "persistent_limit", "bwd_limit", "carry_limit", "tf32",
           "fusedin_bilstm_stale_h", "lstm_train_fwd_streamin_stale_h",
           "fusedin_bilstm_tf32", "lstm_train_fwd_streamin_tf32",
           "lstm_scan_stale_h", "lstm_scan_tf32",
           "lstm_scan_dropped_carry", "scan_carry_report", "carry_failures",
           "lstm_train_bwd_stale_dg", "lstm_train_bwd_tf32"]

# bf16 ulps at the plain output's largest magnitude
PERSISTENT_ULPS = 4
# float32 outputs, absolute.  On an H100 the 3xTF32 kernels read at most
# 5.8e-7 against their plain versions at the train steps' shapes, and the
# same walk with one TF32 product (lstm_scan_tf32) 2.4e-5 to 8e-5 in every
# output (PERF.md); the limit sits between, so it refuses the latter
F32_LIMIT = 1e-5
# float32 dx_proj of K5p-f32 / K7p-f32, relative to max|plain dx_proj|: the
# dgates feed back through every step, and their magnitude varies with the
# inputs, so the limit scales with the plain output's peak.  On an H100, at
# the train steps' shapes, K5p-f32 / K7p-f32 read 1.7e-7 to 3.0e-7 of the
# peak, the plain backward with one TF32 product (lstm_train_bwd_tf32)
# 4.3e-5 to 6.4e-5 (PERF.md); the limit sits between
F32_BWD_LIMIT = 1e-5
# the float32 dW kernel (K5p-f32 / K7p-f32) against the float64 product of
# its own operands, |dW - P| / (|h_prev|^T |dx_proj|) elementwise.  On an
# H100 the kernel reads 4.0e-8 to 2.1e-7 at the train steps' shapes, the
# product of TF32-rounded operands 1.6e-5 to 1.1e-4 (PERF.md); the bound
# sits between
DW_F32_BOUND = 2e-6
# the float32 walks against their plain versions, absolute
# (scripts/check_pallas_tpu.py:29-34); chip_smoke.py holds every walk to it
WALK_F32_TOL = 2e-4


def ulp_limit(ref: torch.Tensor) -> float:
    """PERSISTENT_ULPS bf16 ulps at max|ref| (bf16 keeps 8 significant bits)."""
    return PERSISTENT_ULPS * 2.0 ** (math.floor(math.log2(float(ref.float().abs().max()))) - 7)


def persistent_limit(ref: torch.Tensor) -> float:
    """The limit of a persistent kernel's output against its plain output
    ``ref``: F32_LIMIT in float32, ``ulp_limit(ref)`` in bfloat16."""
    return F32_LIMIT if ref.dtype == torch.float32 else ulp_limit(ref)


def bwd_limit(ref: torch.Tensor) -> float:
    """The limit of K5p/K7p's dx_proj against the plain dx_proj ``ref``:
    F32_BWD_LIMIT of max|ref| in float32, ``ulp_limit(ref)`` in bfloat16."""
    if ref.dtype == torch.float32:
        return F32_BWD_LIMIT * float(ref.abs().max())
    return ulp_limit(ref)


def carry_limit(ref: torch.Tensor, walk: bool = False) -> float:
    """The limit of K2 with a carry against its plain output ``ref`` (h, or
    the float32 c): ``ulp_limit(ref)`` on K2p (bfloat16), F32_LIMIT on
    K2p-f32, WALK_F32_TOL on the float32 walk (``walk``)."""
    if ref.dtype != torch.float32:
        return ulp_limit(ref)
    return WALK_F32_TOL if walk else F32_LIMIT


def lstm_scan_dropped_carry(x_proj: torch.Tensor, w_hh_t: torch.Tensor, reverse: bool = False):
    """K2's plain version with its carry dropped: the walk starts from zeros
    instead of the given (h0, c0) -> (h, (hT, cT))."""
    return lstm_scan_plain(x_proj, w_hh_t, reverse, None, True)


def scan_carry_report(got: torch.Tensor, state, x_proj: torch.Tensor, w_hh_t: torch.Tensor,
                      reverse: bool, initial_state, walk: bool = False) -> dict:
    """K2's output ``got`` and last state ``state`` (hT, cT) from a launch
    with ``initial_state`` against the plain version: max abs differences
    of h (every step), hT and cT; whether hT is the kernel's own last h;
    the limits (``carry_limit``, ``walk`` for the float32 walk; cT's in
    float32, at the scale of the plain cT on K2p: 4 bf16 ulps); the
    dropped-carry fault's difference."""
    ref, (rh, rc) = lstm_scan_plain(x_proj, w_hh_t, reverse, initial_state, True)
    dropped, _ = lstm_scan_dropped_carry(x_proj, w_hh_t, reverse)
    last = 0 if reverse else got.shape[1] - 1

    def err(a, b):
        return float((a.float() - b.float()).abs().max())

    limit = carry_limit(ref, walk)
    return {"h": err(got, ref), "hT": err(state[0], rh), "cT": err(state[1], rc),
            "hT_is_last_h": bool(torch.equal(state[0], got[:, last])),
            "limit": limit,
            "c_limit": limit if ref.dtype == torch.float32 else ulp_limit(rc),
            "dropped_carry": err(dropped, ref)}


def carry_failures(report: dict) -> list[str]:
    """The checks of a ``scan_carry_report`` that fail (empty: it holds)."""
    bad = [f"{k} {report[k]:.3e} >= {report['limit']:.3e}" for k in ("h", "hT")
           if not report[k] < report["limit"]]
    if not report["cT"] < report["c_limit"]:
        bad.append(f"cT {report['cT']:.3e} >= {report['c_limit']:.3e}")
    if not report["hT_is_last_h"]:
        bad.append("hT is not the kernel's own last h")
    if not report["dropped_carry"] >= report["limit"]:
        bad.append(f"a dropped carry moves h by {report['dropped_carry']:.3e}, under the limit "
                   f"{report['limit']:.3e}: the check cannot see it")
    return bad


def _fusedin_faulty(x, w_ih_t, w_hh_t, bias, stale, operand):
    """K1's plain walk (``fusedin_bilstm_plain``) whose products take each
    operand through ``operand`` (h first rounded to x's dtype) and, with
    ``stale``, read h one step stale (h_{t-2} where h_{t-1} is due)."""
    R, T, _ = x.shape
    H = w_hh_t.shape[1]
    outs = []
    for d in range(2):
        xw = operand(x) @ operand(w_ih_t[d]) + bias[d].float()
        w = operand(w_hh_t[d])
        prev = h = xw.new_zeros((R, H))
        c = torch.zeros_like(h)
        out = x.new_empty((R, T, H))
        for s in range(T):
            t = T - 1 - s if d else s
            h_new, c, _ = _cell(xw[:, t] + operand((prev if stale else h).to(x.dtype)) @ w, c)
            prev, h = h, h_new
            out[:, t] = h_new.to(x.dtype)
        outs.append(out)
        del xw
    return torch.cat(outs, dim=-1)


def fusedin_bilstm_stale_h(x: torch.Tensor, w_ih_t: torch.Tensor, w_hh_t: torch.Tensor,
                           bias: torch.Tensor) -> torch.Tensor:
    """K1's plain version (``fusedin_bilstm_plain``) fed h one step stale."""
    return _fusedin_faulty(x, w_ih_t, w_hh_t, bias, True, lambda v: v.float())


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x in float32 rounded to TF32 (10 mantissa bits), to nearest, ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def fusedin_bilstm_tf32(x: torch.Tensor, w_ih_t: torch.Tensor, w_hh_t: torch.Tensor,
                        bias: torch.Tensor) -> torch.Tensor:
    """K1's plain version in float32 whose products x W_ih^T and h W_hh^T
    are each one TF32 product: both operands rounded to TF32, the sums in
    float32 (exact products; TF32 off in the matmul), as K1p-f32 without
    the 3xTF32 split computes them."""
    return _fusedin_faulty(x, w_ih_t, w_hh_t, bias, False, tf32)


def _scan_faulty(x_proj, w_hh_t, reverse, lengths, residuals, product, bias=None, dtype=None):
    """The plain walk of K2 (K3 with ``lengths``; with ``residuals`` K4's,
    K6's: (h, gates, c), c unmasked) whose recurrent product is
    ``product(h_prev, h, W_hh^T)``, h_prev the carried h of the step
    before; ``bias`` (f32) added after the product, outputs stored in
    ``dtype`` (x_proj's by default), as K8's walk."""
    R, T, G = x_proj.shape
    dtype = dtype or x_proj.dtype
    w = w_hh_t.float()
    stale = h = torch.zeros((R, G // 4), device=x_proj.device)
    c = torch.zeros_like(h)
    out = x_proj.new_empty((R, T, G // 4), dtype=dtype)
    gates = x_proj.new_empty((R, T, G), dtype=dtype)
    cs = x_proj.new_empty((R, T, G // 4), dtype=dtype)
    for s in range(T):
        t = T - 1 - s if reverse else s
        pre = x_proj[:, t].float() + product(stale, h, w)
        h_new, c, act = _cell(pre if bias is None else pre + bias, c)
        out[:, t] = h_new.to(dtype)
        gates[:, t], cs[:, t] = act.to(dtype), c.to(dtype)
        if lengths is not None:
            m = (t < lengths).float()[:, None]
            h_new, c = h_new * m, c * m
        stale, h = h, h_new
    return (out, gates, cs) if residuals else out


def lstm_scan_stale_h(x_proj: torch.Tensor, w_hh_t: torch.Tensor, reverse: bool,
                      lengths: torch.Tensor | None = None, residuals: bool = False):
    """K2's plain version (``lstm_scan_plain``; K3's, ``lstm_revmasked_plain``,
    with ``lengths``) fed h one step stale; with ``residuals`` the training
    forward's (K4's, K6's with ``lengths``): (h, gates, c), c unmasked."""
    return _scan_faulty(x_proj, w_hh_t, reverse, lengths, residuals,
                        lambda stale, h, w: stale.to(x_proj.dtype).float() @ w)


def lstm_train_fwd_streamin_stale_h(x: torch.Tensor, w_ih_t: torch.Tensor, bias: torch.Tensor,
                                    w_hh_t: torch.Tensor, reverse: bool = False):
    """K8's plain version (``lstm_train_fwd_streamin_plain``) fed h one step
    stale -> (h, gates, c): equal to it at the walk's first step, off it
    from the second on."""
    return _scan_faulty(x.float() @ w_ih_t.float(), w_hh_t, reverse, None, True,
                        lambda stale, h, w: stale.to(x.dtype).float() @ w,
                        bias=bias.to(x.dtype).float(), dtype=x.dtype)


def lstm_train_fwd_streamin_tf32(x: torch.Tensor, w_ih_t: torch.Tensor, bias: torch.Tensor,
                                 w_hh_t: torch.Tensor, reverse: bool = False):
    """K8's plain version in float32 (``lstm_train_fwd_streamin_plain``)
    whose products x W_ih^T and h W_hh^T are each one TF32 product, as
    K8p-f32 without the 3xTF32 split computes them -> (h, gates, c)."""
    return _scan_faulty(tf32(x) @ tf32(w_ih_t), w_hh_t, reverse, None, True,
                        lambda stale, h, w: tf32(h) @ tf32(w), bias=bias.float(),
                        dtype=x.dtype)


def lstm_scan_tf32(x_proj: torch.Tensor, w_hh_t: torch.Tensor, reverse: bool,
                   lengths: torch.Tensor | None = None, residuals: bool = False):
    """K2's plain version in float32 (K3's with ``lengths``; with
    ``residuals`` K4's, K6's) whose product h W_hh^T is one TF32 product:
    both operands rounded to TF32, the sums in float32 (exact products; TF32
    off in the matmul), as a kernel without the 3xTF32 split computes it."""
    return _scan_faulty(x_proj, w_hh_t, reverse, lengths, residuals,
                        lambda stale, h, w: tf32(h) @ tf32(w))


def _backward_faulty(h, gates, c, dout, w_hh_t, reverse, lengths, product):
    """The plain backward of K5 (K7 with ``lengths``) whose dh is
    ``product(stale, prev, W_hh)``: ``prev`` the dgates of the step visited
    before, ``stale`` those of the step before that -> (dx_proj, dW_hh^T)."""
    R, T, G = gates.shape
    H = G // 4
    w4h = w_hh_t.float().t()
    dc = torch.zeros((R, H), device=gates.device)
    stale = dg_prev = torch.zeros((R, G), dtype=gates.dtype, device=gates.device)
    dxp = gates.new_empty((R, T, G))
    one = torch.ones((R, 1), device=gates.device)
    for s in range(T):
        t = s if reverse else T - 1 - s
        tp = t + 1 if reverse else t - 1
        i, f, g, o = gates[:, t].float().chunk(4, dim=-1)
        m = one if lengths is None else (t < lengths).float()[:, None]
        mp = one if lengths is None else (tp < lengths).float()[:, None]
        cp = c[:, tp].float() * mp if 0 <= tp < T else torch.zeros_like(dc)
        tc = torch.tanh(f * cp + i * g)
        dhv = dout[:, t].float() + product(stale, dg_prev, w4h) * m
        dcv = dc * m + dhv * o * (1.0 - tc * tc)
        dg = torch.cat([dcv * g * i * (1.0 - i), dcv * cp * f * (1.0 - f),
                        dcv * i * (1.0 - g * g), dhv * tc * o * (1.0 - o)], dim=-1).to(gates.dtype)
        dxp[:, t] = dg
        stale, dg_prev = dg_prev, dg
        dc = dcv * f
    return dxp, lstm_bwd_dw_plain(h, dxp, reverse, lengths).to(w_hh_t.dtype)


def lstm_train_bwd_stale_dg(h: torch.Tensor, gates: torch.Tensor, c: torch.Tensor,
                            dout: torch.Tensor, w_hh_t: torch.Tensor, reverse: bool = False,
                            lengths: torch.Tensor | None = None):
    """K5's plain version (``lstm_train_bwd_plain``; K7's,
    ``lstm_revmasked_bwd_plain``, with ``lengths``: then ``reverse`` is
    True) whose dh comes from the dgates one step stale (those of two steps
    back where the previous step's are due) -> (dx_proj, dW_hh^T)."""
    return _backward_faulty(h, gates, c, dout, w_hh_t, reverse, lengths,
                            lambda stale, prev, w: stale.float() @ w)


def lstm_train_bwd_tf32(h: torch.Tensor, gates: torch.Tensor, c: torch.Tensor,
                        dout: torch.Tensor, w_hh_t: torch.Tensor, reverse: bool = False,
                        lengths: torch.Tensor | None = None):
    """K5's plain version in float32 (K7's with ``lengths``) whose dh product
    dgates W_hh is one TF32 product: both operands rounded to TF32, the sums
    in float32 (exact products; TF32 off in the matmul), as a kernel without
    the 3xTF32 split computes it -> (dx_proj, dW_hh^T)."""
    return _backward_faulty(h, gates, c, dout, w_hh_t, reverse, lengths,
                            lambda stale, prev, w: tf32(prev) @ tf32(w))
