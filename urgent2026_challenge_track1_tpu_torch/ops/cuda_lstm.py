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
                  on one of two routes, fixed before launch by ``k1_route``:
                  K1p (``fusedin_bilstm_persistent``, csrc/lstm_persistent.cu)
                  for bfloat16 where ``plan_persistent`` finds a plan, and
                  K1p-f32 for float32 (3xTF32 products) where a float32 plan
                  (elem = 4) fits: one grid for both directions, else one
                  launch a direction (the flow width); else the walk
                  (``fusedin_bilstm_walk``, csrc/lstm_kernels.cu)
  lstm_scan       x_proj (R, T, 4H), w_hh_t (H, 4H)   -> (R, T, H)
                  [initial_state (h0 (R, H), c0 (R, H) f32), return_state
                  -> (R, T, H), (hT, cT): the carry of a chunked stream]
  lstm_revmasked  x_proj (R, T, 4H), w_hh_t (H, 4H),
                  lengths (R,) int32                   -> (R, T, H)
                  each on one of two routes, fixed before launch by
                  ``scan_route``: K2p / K3p (``lstm_scan_persistent``,
                  ``lstm_revmasked_persistent``, csrc/lstm_persistent.cu) for
                  bfloat16 where ``plan_persistent`` finds a one-direction
                  plan, and K2p-f32 / K3p-f32 for float32 (3xTF32 products)
                  where its float32 plan (elem = 4) fits, else the walk
                  (``lstm_scan_walk``, ``lstm_revmasked_walk``,
                  csrc/lstm_kernels.cu; float32 at H = 1020)

  lstm_train_fwd            (K4) as lstm_scan      -> h, gates (R, T, 4H), c
  lstm_revmasked_train_fwd  (K6) as lstm_revmasked -> h, gates, c
                  each on one of two routes, fixed before launch by
                  ``scan_route``, on K2's and K3's plans: K4p / K6p
                  (``lstm_train_fwd_persistent``,
                  ``lstm_revmasked_train_fwd_persistent``, K2p's kernel
                  that also stores the residuals) for bfloat16 with a
                  one-direction plan and for float32 with a float32 plan
                  (``plan_persistent(..., elem=4)``: 3xTF32 products), else
                  the walk (``lstm_train_fwd_walk``,
                  ``lstm_revmasked_train_fwd_walk``)
  lstm_train_bwd            (K5) h, gates, c, dout (R, T, H), w_hh_t
                                                   -> dx_proj, dW_hh^T (H, 4H)
  lstm_revmasked_bwd        (K7) as K5, with lengths
                  each on one of two routes, fixed before launch by
                  ``backward_route``: K5p / K7p (``lstm_train_bwd_persistent``,
                  ``lstm_revmasked_bwd_persistent``, csrc/lstm_persistent_bwd.cu:
                  a persistent reverse walk, then the dW kernel
                  ``lstm_bwd_dw`` on the tensor cores) for bfloat16 where
                  ``plan_backward`` finds a plan, else the walk and
                  ``dw_kernel`` (``lstm_train_bwd_walk``,
                  ``lstm_revmasked_bwd_walk``)
  lstm_train_fwd_streamin   (K8) x (R, T, N), w_ih_t (N, 4H), bias (4H,),
                                 w_hh_t            -> h, gates, c as K4
                  on one of two routes, fixed before launch by
                  ``streamin_route``: K8p (``lstm_train_fwd_streamin_persistent``,
                  K1p's kernel for one direction that also stores the
                  residuals) for bfloat16 where ``plan_persistent(..., dirs=1)``
                  finds a plan and K8p-f32 for float32 where its float32
                  plan (elem = 4) does, else the walk
                  (``lstm_train_fwd_streamin_walk``; float32 at H = 1020)
  lstm_train_fwd2           (K9) K4 for both directions: K4's own route
                  once a direction, forward then reverse (``scan_route``:
                  K4p / K4p-f32, or K4's walk at float32 H = 1020), so bit
                  for bit ``lstm_train_fwd`` per direction; counted as K9
  lstm_train_bwd2           (K10) K5 for both directions,
                  on one of three routes, fixed before launch by
                  ``backward2_route``: K10p (``lstm_train_bwd2_persistent``:
                  K5p for both directions in one cooperative grid, then
                  K5p's dW kernel once a direction) for bfloat16 and
                  float32 where ``plan_backward(..., dirs=2)`` finds a
                  plan; else, on ``backward_route``'s one-direction plan,
                  one K5p / K5p-f32 launch and its dW kernel a direction
                  (the same wrapper; float32 at the flow band and at
                  H = 1020); else the walk (``lstm_train_bwd2_walk``)

Index 0 of the stacked K1 weights is the forward direction, 1 the backward.
``route_counts(name)`` reads the launches per route ("persistent", "walk"; for
K1 and K10 also "persistent_split", each launch of a one-direction pair) of
K1-K10; ``reset_launch_counts`` zeroes them with the launch counts.
``LSTMDirTrain`` (K4/K5) and ``LSTMRevMaskedTrain`` (K6/K7) are the autograd
Functions of the training path; ``lstm_dir`` and ``lstm_dir_revmasked``
route to them when autograd records and to the lean K2/K3 otherwise (under
remat too: the checkpoint records in its first pass).
``BiLSTMTrain`` is the differentiable bidirectional layer of the band path
and ``LSTMDirStreamIn`` the differentiable raw-input direction; both read
the two experiment toggles below at call time, as the JAX VJP rules read
``pallas_lstm.STREAM_INPUT_TRAIN`` and ``FUSED_BIDIR_TRAIN``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from urgent2026_challenge_track1_tpu_torch import tracing

__all__ = [
    "fusedin_bilstm",
    "fusedin_bilstm_walk",
    "fusedin_bilstm_persistent",
    "fusedin_bilstm_sliced_plain",
    "PersistentPlan",
    "plan_persistent",
    "pack_persistent_weights",
    "k1_route",
    "lstm_scan",
    "lstm_revmasked",
    "lstm_scan_walk",
    "lstm_revmasked_walk",
    "lstm_scan_persistent",
    "lstm_revmasked_persistent",
    "lstm_scan_sliced_plain",
    "lstm_revmasked_sliced_plain",
    "pack_scan_weights",
    "scan_route",
    "fusedin_bilstm_plain",
    "lstm_scan_plain",
    "lstm_revmasked_plain",
    "lstm_train_fwd",
    "lstm_train_bwd",
    "lstm_revmasked_train_fwd",
    "lstm_revmasked_bwd",
    "lstm_train_fwd_walk",
    "lstm_revmasked_train_fwd_walk",
    "lstm_train_fwd_persistent",
    "lstm_revmasked_train_fwd_persistent",
    "lstm_train_fwd_sliced_plain",
    "lstm_revmasked_train_fwd_sliced_plain",
    "lstm_train_fwd_plain",
    "lstm_train_bwd_plain",
    "lstm_revmasked_train_fwd_plain",
    "lstm_revmasked_bwd_plain",
    "lstm_train_bwd_walk",
    "lstm_revmasked_bwd_walk",
    "lstm_train_bwd_persistent",
    "lstm_revmasked_bwd_persistent",
    "lstm_train_bwd_sliced_plain",
    "lstm_revmasked_bwd_sliced_plain",
    "lstm_bwd_dw",
    "lstm_bwd_dw_plain",
    "BackwardPlan",
    "plan_backward",
    "pack_backward_weights",
    "backward_route",
    "lstm_train_fwd_streamin",
    "lstm_train_fwd2",
    "lstm_train_bwd2",
    "lstm_train_fwd_streamin_walk",
    "lstm_train_fwd_streamin_persistent",
    "lstm_train_fwd_streamin_sliced_plain",
    "streamin_route",
    "lstm_train_bwd2_walk",
    "lstm_train_bwd2_persistent",
    "lstm_train_bwd2_sliced_plain",
    "backward2_route",
    "lstm_train_fwd_streamin_plain",
    "lstm_train_fwd2_plain",
    "lstm_train_bwd2_plain",
    "LSTMDirTrain",
    "LSTMRevMaskedTrain",
    "LSTMDirStreamIn",
    "BiLSTMTrain",
    "lstm_dir",
    "lstm_dir_revmasked",
    "lstm_dir_streamin",
    "STREAM_INPUT_TRAIN",
    "FUSED_BIDIR_TRAIN",
    "needs_grad",
    "KERNELS",
    "reset_launch_counts",
    "launch_counts",
    "route_counts",
]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HIDDEN = 1024  # at most 512 threads a block, each owning 1 or 2 units
WIDE_HIDDEN = 512  # above it each thread owns 2 units (twice the registers)
WIDE_MAX_ROWS = 4  # the largest row tile that fits without spilling there

# Experiment toggles (the port's copies of pallas_lstm.py's), off by default
# and read at call time.  STREAM_INPUT_TRAIN: the training forward of the
# band layer (BiLSTMTrain) and both directions of ``ops/lstm.bilstm_masked``
# stream the raw input into K8 (in-kernel x W_ih^T, no (R, T, 4H)
# projection); the backward is K5 per direction.  FUSED_BIDIR_TRAIN: the
# band layer's training forward runs both directions in one K9 call and,
# unless STREAM_INPUT_TRAIN is set, its backward in one K10 call.
STREAM_INPUT_TRAIN = False
FUSED_BIDIR_TRAIN = False


# ---------------------------------------------------------------------------
# Plain versions (the arithmetic of the kernels, one step at a time)
# ---------------------------------------------------------------------------


def _cell(gates: torch.Tensor, c: torch.Tensor):
    """One cell update in f32: returns (h, c, post-activation gates i, f, g, o)."""
    i, f, g, o = gates.chunk(4, dim=-1)
    i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
    c = f * c + i * g
    return o * torch.tanh(c), c, torch.cat([i, f, g, o], dim=-1)


def _walk_plain(x_proj, w_hh_t, reverse, lengths=None, bias=None, dtype=None,
                initial_state=None, return_state=False):
    """Shared loop of K2/K3, K4/K6 and K8: gates = x_proj_t + round(h) W_hh^T
    (+ bias) in f32; returns h, the post-activation gates and c, stored in
    ``dtype`` (x_proj's by default; h and c unmasked).  ``initial_state``
    (h0 (R, H) in ``dtype``, c0 (R, H) float32) starts the walk from a
    carried state instead of zeros; ``return_state`` appends the last
    step's (h in ``dtype``, c float32).  Differentiable by autograd."""
    R, T, G = x_proj.shape
    H = G // 4
    dtype = dtype or x_proj.dtype
    w = w_hh_t.float()
    if initial_state is None:
        h = x_proj.new_zeros((R, H), dtype=torch.float32)
        c = torch.zeros_like(h)
    else:
        h, c = initial_state[0].float(), initial_state[1].float()
    out = x_proj.new_empty((R, T, H), dtype=dtype)
    gates = x_proj.new_empty((R, T, G), dtype=dtype)
    cs = x_proj.new_empty((R, T, H), dtype=dtype)
    for s in range(T):
        t = T - 1 - s if reverse else s
        pre = x_proj[:, t].float() + h.to(dtype).float() @ w
        h, c, act = _cell(pre if bias is None else pre + bias, c)
        out[:, t] = h.to(dtype)
        gates[:, t] = act.to(dtype)
        cs[:, t] = c.to(dtype)
        if lengths is not None:
            m = (t < lengths).to(torch.float32)[:, None]
            h, c = h * m, c * m
    if return_state:
        return out, gates, cs, (h.to(dtype), c)
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


def lstm_scan_plain(x_proj: torch.Tensor, w_hh_t: torch.Tensor, reverse: bool = False,
                    initial_state=None, return_state: bool = False):
    """Plain version of ``lstm_scan``: h, or (h, (hT, cT)) with
    ``return_state``; ``initial_state`` (h0, c0) continues a carried walk."""
    res = _walk_plain(x_proj, w_hh_t, reverse, initial_state=initial_state,
                      return_state=return_state)
    return (res[0], res[3]) if return_state else res[0]


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


def lstm_train_fwd_streamin_plain(x: torch.Tensor, w_ih_t: torch.Tensor, bias: torch.Tensor,
                                  w_hh_t: torch.Tensor, reverse: bool = False):
    """Plain version of ``lstm_train_fwd_streamin``: (h, gates, c) of the walk
    whose step is (x_t W_ih^T + round(h) W_hh^T) + b, the input product kept
    in f32 (not rounded to x's dtype as a hoisted projection is)."""
    return _walk_plain(x.float() @ w_ih_t.float(), w_hh_t, reverse,
                       bias=bias.to(x.dtype).float(), dtype=x.dtype)


def lstm_train_fwd2_plain(xp_f: torch.Tensor, xp_b: torch.Tensor, w_hh_f_t: torch.Tensor,
                          w_hh_b_t: torch.Tensor):
    """Plain version of ``lstm_train_fwd2``: K4's plain version forward on
    xp_f and reverse on xp_b -> (h_f, gates_f, c_f, h_b, gates_b, c_b)."""
    return (*_walk_plain(xp_f, w_hh_f_t, False), *_walk_plain(xp_b, w_hh_b_t, True))


def lstm_train_bwd2_plain(res_f, res_b, dout_f: torch.Tensor, dout_b: torch.Tensor,
                          w_hh_f_t: torch.Tensor, w_hh_b_t: torch.Tensor):
    """Plain version of ``lstm_train_bwd2``: K5's plain version per direction
    -> (dx_proj_f, dW_hh_f^T, dx_proj_b, dW_hh_b^T)."""
    return (*_backward_plain(*res_f, dout_f, w_hh_f_t, False),
            *_backward_plain(*res_b, dout_b, w_hh_b_t, True))


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
# K1p, K2p, K3p: the partition, the packed weight layouts and the plain
# sliced walks
# ---------------------------------------------------------------------------

SMEM_LIMIT = 232448  # dynamic shared memory of one block on an H100 (227 KB)
MAX_CHUNK = 64       # rows a chunk walks at once: at most 4 row blocks of 16
MAX_ACC_BLOCKS = 16  # 16 x 8 accumulator blocks a warp holds (row blocks x ceil(U / 8))
MAX_ACC_BLOCKS_TF32 = 8  # the float32 route's: its 3xTF32 products also hold hi and lo fragments
MAX_CELLS = 2048     # (row, unit) cells of a chunk: 256 threads x 8 each
MAX_CELLS_F32 = 1024  # and x 4 each on the float32 route (registers for the f32 residuals)
GROUP_ROWS = 64      # rows per group the planner aims for before widening S


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _pad16(n: int) -> int:
    return _ceil(n, 16) * 16


def persistent_smem(N: int, H: int, U: int, chunk: int, rows: int = 0,
                    c_in_smem: bool = False, elem: int = 2) -> int:
    """Shared-memory bytes of one persistent CTA (csrc/lstm_persistent.cu
    ``Plan::smem_bytes``): the weight slice (Kx + Kh) x (4U + 8) elements, a
    chunk of staged inputs chunk x (max(Kx, Kh) + 16 bytes) elements, its
    accumulators chunk x (4U + 4) f32 and, when it lives there, c (rows x U
    f32); then K1p's bias (4U f32) or, for the walks over a hoisted
    projection (N = 0: K2p-K6p), a double buffer of the projection's 4U
    columns (2 x chunk x 4U elements).  ``elem``: the element's bytes, 2
    (bfloat16) or 4 (float32: K2p-K6p's float32 routes with N = 0, K1p-f32
    and K8p-f32 with N > 0), which doubles the slice, the staged chunk and
    the projection's buffer.  The pads spread rows over the banks: a staged
    row is an odd multiple of 16 bytes (kh + 8 bf16, kh + 4 f32), a slice
    row 4U + 8 elements; K1p-f32's and K8p-f32's slice has no pad (4U
    floats a row in fragment order, ``frag_index`` in the kernel)."""
    kx, kh = _pad16(N), _pad16(H)
    extra = 4 * 4 * U if N else elem * 2 * chunk * 4 * U
    ldw = 4 * U if N and elem == 4 else 4 * U + 8
    return (elem * (kx + kh) * ldw + elem * chunk * (max(kx, kh) + 16 // elem)
            + 4 * chunk * (4 * U + 4) + extra + (4 * rows * U if c_in_smem else 0))


@dataclasses.dataclass(frozen=True)
class PersistentPlan:
    """A persistent partition: dirs x G x S CTAs; CTA (d, g, s) owns hidden
    units [s U, min((s + 1) U, H)) of direction d for rows [g rows, min((g +
    1) rows, R)), walked ``chunk`` rows at a time; c in shared memory or in
    a global buffer.  K1p: dirs = 2 over N inputs (K1p-f32 also dirs = 1:
    one launch a direction); K8p: dirs = 1 over N inputs; K2p-K6p: dirs =
    1, N = 0 (the input projection is hoisted).  ``elem``: the element's
    bytes, 2 (bfloat16) or 4 (float32: K2p-K6p's, K1p's and K8p's float32
    routes)."""
    R: int
    N: int
    H: int
    S: int
    G: int
    U: int
    rows: int
    chunk: int
    c_in_smem: bool
    smem: int
    dirs: int = 2
    elem: int = 2

    @property
    def kx(self) -> int:
        return _pad16(self.N)

    @property
    def kh(self) -> int:
        return _pad16(self.H)

    @property
    def ctas(self) -> int:
        return self.dirs * self.G * self.S


@functools.lru_cache(maxsize=256)
def plan_persistent(R: int, N: int, H: int, sms: int, smem_bytes: int = SMEM_LIMIT,
                    dirs: int = 2, elem: int = 2) -> PersistentPlan | None:
    """The persistent partition of R rows, N inputs (0: a hoisted
    projection) and H units over ``dirs`` directions on ``sms`` SMs, with
    elements of ``elem`` bytes (2, bfloat16, or 4, float32), or None when
    no slice fits in ``smem_bytes`` or the grid exceeds the SMs.

    L2 traffic per step (the staged h) grows with S, not with G, so: the
    smallest S whose slice fits beside one 16-row chunk; then rows spread
    over G = max(1, min(sms // (dirs S), ceil(R / 64))) groups; then S
    widened to the SMs left over (U, a multiple of 4, shrinks with it);
    then the largest chunk that fits, and c in shared memory if it fits
    too.  On the float32 routes a warp holds at most MAX_ACC_BLOCKS_TF32
    accumulator blocks and a chunk at most MAX_CELLS_F32 cells.  K1p-f32
    and K8p-f32 (N > 0, elem = 4) start from the smallest S whose slice
    fits beside a 32-row chunk where that grid fits the SMs: the f32
    [W_ih; W_hh] slice that fits beside 16 rows fills shared memory and
    leaves 16-row chunks (nine a step at 401 x 34)."""
    if elem not in (2, 4):
        raise ValueError(f"no persistent route for {elem}-byte elements")
    if min(R, H, sms, dirs) <= 0 or N < 0:
        return None
    max_blocks, max_cells = ((MAX_ACC_BLOCKS, MAX_CELLS) if elem == 2
                             else (MAX_ACC_BLOCKS_TF32, MAX_CELLS_F32))

    def units(S):  # ceil(H / S) rounded up to a multiple of 4
        return _ceil(_ceil(H, S), 4) * 4

    def fits(U, chunk, rows=0, c_in_smem=False):
        blocks = chunk // 16 * _ceil(U, 8)  # a warp's: its column blocks of every row block
        return (chunk <= MAX_CHUNK and U <= 64 and blocks <= max_blocks
                and chunk * U <= max_cells
                and persistent_smem(N, H, U, chunk, rows, c_in_smem, elem) <= smem_bytes)

    def smallest_s(chunk):  # of a slice that fits beside ``chunk`` rows, or None
        S = 1
        while not fits(units(S), chunk):
            if units(S) == 4:
                return None
            S += 1
        return _ceil(H, units(S))

    S = smallest_s(16)
    if S is None or dirs * S > sms:
        return None
    if elem == 4 and N:
        S32 = smallest_s(min(32, _pad16(R)))
        S = S32 if S32 is not None and dirs * S32 <= sms else S
    G = max(1, min(sms // (dirs * S), _ceil(R, GROUP_ROWS)))
    U = units(min(sms // (dirs * G), _ceil(H, 4)))
    S = _ceil(H, U)
    rows = _ceil(R, G)
    G = _ceil(R, rows)
    chunk = next(c for c in range(min(_pad16(rows), MAX_CHUNK), 0, -16) if fits(U, c))
    c_in_smem = fits(U, chunk, rows, True)
    return PersistentPlan(R, N, H, S, G, U, rows, chunk, c_in_smem,
                          persistent_smem(N, H, U, chunk, rows, c_in_smem, elem), dirs, elem)


@functools.lru_cache(maxsize=64)
def _packed_columns(H: int, S: int, U: int, device: torch.device) -> torch.Tensor:
    """Column q H + s U + j of a stacked weight for packed column (s, q U +
    j), or 4H (a zero column) past H; flat (S 4U,)."""
    units = torch.arange(S * U).reshape(S, 1, U)
    cols = torch.arange(4).reshape(1, 4, 1) * H + units
    return torch.where(units < H, cols, 4 * H).reshape(-1).to(device)


def pack_persistent_weights(w_ih_t: torch.Tensor, w_hh_t: torch.Tensor, bias: torch.Tensor,
                            plan: PersistentPlan):
    """K1's stacked weights (D = 2 directions; K8p's: D = 1, one direction's
    weights with a leading axis of 1) in K1p's layout: (D, S, Kx + Kh, 4U)
    with rows [0, N) of W_ih^T and [Kx, Kx + H) of W_hh^T (zero rows
    between) and column q U + j = gate q of unit s U + j (zero past H); the
    bias (D, S, 4U) in the same columns.  Slice s of direction d is one
    contiguous block, which its CTA copies into shared memory once."""
    N, H, S, U = plan.N, plan.H, plan.S, plan.U
    D = w_ih_t.shape[0]
    cols = _packed_columns(H, S, U, w_ih_t.device)
    z = w_ih_t.new_zeros(())
    # [W_ih^T; 0; W_hh^T; 0] with a zero column 4H appended: one gather
    k = torch.cat([w_ih_t, z.expand(D, plan.kx - N, 4 * H), w_hh_t,
                   z.expand(D, plan.kh - H, 4 * H)], dim=1)
    k = torch.cat([k, z.expand(D, plan.kx + plan.kh, 1)], dim=2)
    w = k.index_select(2, cols).reshape(D, plan.kx + plan.kh, S, 4 * U).transpose(1, 2)
    b = torch.cat([bias, z.expand(D, 1)], dim=1).index_select(1, cols).reshape(D, S, 4 * U)
    return w.contiguous(), b


def _fusedin_sliced_plain(x, packed, plan, reverses, store=False):
    """The walk of K1p (``reverses`` = (False, True); the directions walk
    the same (group, slice) schedule in one grid or a launch each) or K8p
    (one direction) over ``plan``'s schedule, reading only the
    packed slices: h_{t-1} read back from the output (rounded to x's
    dtype), c kept per (row, direction, unit), f32 sums of the packed
    columns, the packed bias added last.  With ``store`` (K8p) also the
    residuals as the kernel writes them, in x's dtype: the post-activation
    gates (R, T, 4H) at q H + u and c (R, T, H); returns (h, gates, c),
    else h (R, T, D H)."""
    w, b = packed
    R, T, N = x.shape
    H, U = plan.H, plan.U
    out = x.new_zeros((R, T, len(reverses) * H))
    c = torch.zeros((R, len(reverses), H), dtype=torch.float32, device=x.device)
    if store:
        gates, cs = x.new_zeros((R, T, 4 * H)), x.new_zeros((R, T, H))
    for step in range(T):
        for d, rev in enumerate(reverses):
            t = T - 1 - step if rev else step
            for g in range(plan.G):
                rows = slice(g * plan.rows, min((g + 1) * plan.rows, R))
                xr = x[rows, t].float()
                hr = out[rows, t + 1 if rev else t - 1, d * H:(d + 1) * H].float() if step else None
                for s in range(plan.S):
                    u0, nu = s * U, min(U, H - s * U)
                    ws = w[d, s].float()
                    pre = xr @ ws[:N]
                    if hr is not None:
                        pre = pre + hr @ ws[plan.kx:plan.kx + H]
                    pre = (pre + b[d, s].float()).reshape(-1, 4, U)[..., :nu]
                    act = (torch.sigmoid(pre[:, 0]), torch.sigmoid(pre[:, 1]),
                           torch.tanh(pre[:, 2]), torch.sigmoid(pre[:, 3]))
                    cu = act[1] * c[rows, d, u0:u0 + nu] + act[0] * act[2]
                    c[rows, d, u0:u0 + nu] = cu
                    out[rows, t, d * H + u0:d * H + u0 + nu] = (act[3] * torch.tanh(cu)).to(x.dtype)
                    if store:
                        for q in range(4):
                            gates[rows, t, q * H + u0:q * H + u0 + nu] = act[q].to(x.dtype)
                        cs[rows, t, u0:u0 + nu] = cu.to(x.dtype)
    return (out, gates, cs) if store else out


def fusedin_bilstm_sliced_plain(x: torch.Tensor, packed, plan: PersistentPlan) -> torch.Tensor:
    """Plain version of K1p and K1p-f32: reads only the packed slices
    (``packed`` = ``pack_persistent_weights``'s pair) and walks the
    (direction, group, slice) schedule step by step as the kernel does, on
    a two-direction plan or, a launch a direction, a one-direction one:
    h_{t-1} read back from the output (rounded to x's dtype; float32 as
    it is), c kept per (row, direction, unit), f32 sums."""
    return _fusedin_sliced_plain(x, packed, plan, (False, True))


def lstm_train_fwd_streamin_sliced_plain(x: torch.Tensor, packed, plan: PersistentPlan,
                                         reverse: bool = False):
    """Plain version of K8p and K8p-f32: K1p's sliced walk for one direction
    (``packed`` = ``pack_persistent_weights`` of the direction's weights
    with a leading axis of 1, ``plan`` a dirs = 1 plan, bfloat16 or float32)
    that also returns the residuals -> (h, gates, c), as
    ``lstm_train_fwd_streamin_plain`` does."""
    return _fusedin_sliced_plain(x, packed, plan, (reverse,), store=True)


def pack_scan_weights(w_hh_t: torch.Tensor, plan: PersistentPlan) -> torch.Tensor:
    """One direction's W_hh^T (H, 4H) in K2p/K3p's layout: (S, Kh, 4U), rows
    [0, H) of W_hh^T (zero rows to Kh) and column q U + j = gate q of unit
    s U + j (zero past H), as ``pack_persistent_weights`` lays out K1p's
    W_hh segment.  Slice s is one contiguous block."""
    H, S, U = plan.H, plan.S, plan.U
    cols = _packed_columns(H, S, U, w_hh_t.device)
    k = torch.cat([w_hh_t, w_hh_t.new_zeros(plan.kh - H, 4 * H)], dim=0)
    k = torch.cat([k, k.new_zeros(plan.kh, 1)], dim=1)
    return k.index_select(1, cols).reshape(plan.kh, S, 4 * U).transpose(0, 1).contiguous()


def _scan_sliced_plain(x_proj, w, plan, reverse, lengths=None, store=False,
                       initial_state=None, return_state=False):
    """The walk of K2p/K3p over ``plan``'s (group, slice) schedule: h_{t-1}
    read back from the output (rounded to x_proj's dtype) and, with
    ``lengths``, zeroed for rows where t - 1 (reverse: t + 1) >= lengths[r];
    c kept per (row, unit) and zeroed after step t >= lengths[r]; gates =
    x_proj_t + h W_hh (f32 sums of the packed slice's columns).  With
    ``store`` (K4p/K6p) also the residuals, as the kernel writes them: the
    post-activation gates (R, T, 4H) at q H + u and the step's unmasked c
    (R, T, H), in x_proj's dtype; returns (h, gates, c), else h.  K2p's
    carry: ``initial_state`` (h0 (R, H) in x_proj's dtype, c0 (R, H) f32) is
    step 0's h_{t-1} and c; ``return_state`` appends the last step's (h, c)
    as the owning CTAs write them."""
    R, T, _ = x_proj.shape
    H, U = plan.H, plan.U
    out = x_proj.new_zeros((R, T, H))
    c = torch.zeros((R, H), dtype=torch.float32, device=x_proj.device)
    h0 = None
    if initial_state is not None:
        h0, c = initial_state[0], initial_state[1].float().clone()
    if store:
        gates, cs = x_proj.new_zeros((R, T, 4 * H)), x_proj.new_zeros((R, T, H))
    for step in range(T):
        t = T - 1 - step if reverse else step
        tp = t + 1 if reverse else t - 1
        for g in range(plan.G):
            rows = slice(g * plan.rows, min((g + 1) * plan.rows, R))
            xr = x_proj[rows, t].float().reshape(-1, 4, H)
            hr = out[rows, tp].float() if step else None if h0 is None else h0[rows].float()
            keep = None if lengths is None else lengths[rows].to(x_proj.device)[:, None]
            if hr is not None and keep is not None:
                hr = hr * (tp < keep)
            for s in range(plan.S):
                u0, nu = s * U, min(U, H - s * U)
                pre = xr[..., u0:u0 + nu]
                if hr is not None:
                    pre = pre + (hr @ w[s, :H].float()).reshape(-1, 4, U)[..., :nu]
                act = torch.cat([torch.sigmoid(pre[:, :2]), torch.tanh(pre[:, 2:3]),
                                 torch.sigmoid(pre[:, 3:])], dim=1)
                cu = act[:, 1] * c[rows, u0:u0 + nu] + act[:, 0] * act[:, 2]
                out[rows, t, u0:u0 + nu] = (act[:, 3] * torch.tanh(cu)).to(x_proj.dtype)
                c[rows, u0:u0 + nu] = cu if keep is None else cu * (t < keep)
                if store:  # the unmasked c, not the carried one
                    for q in range(4):
                        gates[rows, t, q * H + u0:q * H + u0 + nu] = act[:, q].to(x_proj.dtype)
                    cs[rows, t, u0:u0 + nu] = cu.to(x_proj.dtype)
    res = (out, gates, cs) if store else out
    if not return_state:
        return res
    last = out[:, 0 if reverse else T - 1] if T else (
        x_proj.new_zeros((R, H)) if h0 is None else h0)
    return res, (last.clone(), c)


def lstm_scan_sliced_plain(x_proj: torch.Tensor, w_packed: torch.Tensor, plan: PersistentPlan,
                           reverse: bool = False, initial_state=None,
                           return_state: bool = False):
    """Plain version of K2p: reads only the packed slices (``w_packed`` =
    ``pack_scan_weights``'s) and walks the kernel's schedule step by step;
    with the carry arguments of ``lstm_scan``."""
    return _scan_sliced_plain(x_proj, w_packed, plan, reverse, initial_state=initial_state,
                              return_state=return_state)


def lstm_revmasked_sliced_plain(x_proj: torch.Tensor, w_packed: torch.Tensor,
                                lengths: torch.Tensor, plan: PersistentPlan) -> torch.Tensor:
    """Plain version of K3p: the masked reverse walk over the packed slices;
    the output equals ``lstm_revmasked_plain``'s at every step, padded ones
    included (h is masked where it is read, not where it is written)."""
    return _scan_sliced_plain(x_proj, w_packed, plan, True, lengths)


def lstm_train_fwd_sliced_plain(x_proj: torch.Tensor, w_packed: torch.Tensor,
                                plan: PersistentPlan, reverse: bool = False):
    """Plain version of K4p: K2p's sliced walk that also returns the
    residuals -> (h, gates, c), as ``lstm_train_fwd_plain`` does."""
    return _scan_sliced_plain(x_proj, w_packed, plan, reverse, store=True)


def lstm_revmasked_train_fwd_sliced_plain(x_proj: torch.Tensor, w_packed: torch.Tensor,
                                          lengths: torch.Tensor, plan: PersistentPlan):
    """Plain version of K6p: K3p's sliced walk that also returns the
    residuals (h and c unmasked) -> (h, gates, c), equal to
    ``lstm_revmasked_train_fwd_plain``'s at every step."""
    return _scan_sliced_plain(x_proj, w_packed, plan, True, lengths, store=True)


# ---------------------------------------------------------------------------
# K5p, K7p: the backward partition, its packed weights and the plain sliced
# reverse walks; the dW kernel's plain version
# ---------------------------------------------------------------------------

WARPS = 8            # warps of a persistent CTA; the backward splits K over all of them
BWD_TILE = 512       # the K tile of the staged dgates the backward planner aims for
BWD_MIN_TILE = 256   # and the narrowest it takes (each tile costs two block barriers)
DW_TILE = 128        # the dW kernel's output tile (rows and columns)
DW_K = 64            # and the (row, step) pairs of one of its K stages
DW_SLOTS_PER_SM = 2  # dW CTAs resident on one SM
DW_SLOTS_PER_SM_F32 = 1  # and in float32 (3xTF32: the accumulators take the registers)
DW_MAX_SPLIT = 4     # parts of the dW kernel's K (split-K), summed in a fixed order


def backward_smem(H: int, U: int, chunk: int, kt: int, rows: int = 0,
                  dc_in_smem: bool = False, elem: int = 2) -> int:
    """Shared-memory bytes of one K5p/K7p CTA (csrc/lstm_persistent_bwd.cu
    ``BwdPlan::smem_bytes``): the slice of W_hh^T rows [s U, s U + U) padded
    to Up = ceil(U / 8) 8 rows of Kp + 16 bytes (Kp = 4H padded to 16); the
    staged dgates, chunk x (kt + 16 bytes), one buffer when one K tile holds
    Kp, else two; the eight warps' partial dh, 8 x chunk x Up f32; a double
    buffer of the cell's inputs (gates 4U, c_prev U, dout U: 2 x chunk x
    6U); dc (rows x U f32) when it lives there.  ``elem``: the element's
    bytes, 2 (bfloat16) or 4 (float32, which doubles the slice, the staged
    dgates and the cell inputs).  The 16-byte pads make a row an odd
    multiple of 16 bytes, so ldmatrix is free of bank conflicts."""
    up, kp, pad = _ceil(U, 8) * 8, _pad16(4 * H), 16 // elem
    nbuf = 1 if kt >= kp else 2
    return (elem * up * (kp + pad) + elem * nbuf * chunk * (kt + pad) + 4 * WARPS * chunk * up
            + elem * 2 * chunk * 6 * U + (4 * rows * U if dc_in_smem else 0))


@dataclasses.dataclass(frozen=True)
class BackwardPlan:
    """The partition of K5p/K7p: G x S CTAs; CTA (g, s) owns hidden units
    [s U, min((s + 1) U, H)) for rows [g rows, min((g + 1) rows, R)), walked
    ``chunk`` rows at a time, its dh product over K = 4H staged ``kt``
    columns at a time; dc in shared memory or in a global buffer.
    ``dw_split``: the parts of the dW kernel's K (R T) summed in order.
    ``elem``: the element's bytes, 2 (bfloat16) or 4 (float32: 3xTF32
    products, the float32 dW kernel).  ``dirs``: the directions one grid
    walks (K10p: 2, direction d on the grid's z axis, each a K5p grid of G
    x S CTAs)."""
    R: int
    H: int
    S: int
    G: int
    U: int
    rows: int
    chunk: int
    kt: int
    dc_in_smem: bool
    smem: int
    dw_split: int
    elem: int = 2
    dirs: int = 1

    @property
    def up(self) -> int:
        return _ceil(self.U, 8) * 8

    @property
    def kp(self) -> int:
        return _pad16(4 * self.H)

    @property
    def ntiles(self) -> int:
        return _ceil(self.kp, self.kt)

    @property
    def ctas(self) -> int:
        return self.dirs * self.G * self.S


def _backward_tile(H, U, chunk, rows, dc_in_smem, smem_bytes, elem=2) -> int | None:
    """The widest K tile up to BWD_TILE (Kp split into equal tiles, each a
    multiple of 16 and at least BWD_MIN_TILE) with which the CTA fits, or
    None."""
    kp = _pad16(4 * H)
    for n in range(_ceil(kp, BWD_TILE), _ceil(kp, 16) + 1):
        kt = _pad16(_ceil(kp, n))
        if kt < min(BWD_MIN_TILE, kp):
            return None
        if backward_smem(H, U, chunk, kt, rows, dc_in_smem, elem) <= smem_bytes:
            return kt
    return None


def dw_split(H: int, sms: int, elem: int = 2) -> int:
    """The dW kernel's split of K: the parts (1..DW_MAX_SPLIT) that fill the
    card's CTA slots (DW_SLOTS_PER_SM a SM in bfloat16, DW_SLOTS_PER_SM_F32
    in float32) with DW_TILE x DW_TILE output tiles in the fewest waves per
    part (the fewer parts on a tie)."""
    tiles = _ceil(H, DW_TILE) * _ceil(4 * H, DW_TILE)
    slots = (DW_SLOTS_PER_SM if elem == 2 else DW_SLOTS_PER_SM_F32) * max(sms, 1)
    return min(range(1, DW_MAX_SPLIT + 1), key=lambda k: (_ceil(tiles * k, slots) / k, k))


@functools.lru_cache(maxsize=256)
def plan_backward(R: int, H: int, sms: int, smem_bytes: int = SMEM_LIMIT,
                  elem: int = 2, dirs: int = 1) -> BackwardPlan | None:
    """The persistent partition of K5p/K7p (``dirs`` = 1) or K10p (2: both
    directions in one grid) for R rows and H units on ``sms`` SMs with
    elements of ``elem`` bytes (2: bfloat16; 4: float32), or None when no
    slice fits in ``smem_bytes`` or the grid exceeds the SMs.
    ``plan_persistent``'s search with the backward's own bytes: the
    smallest S whose slice fits beside one 16-row chunk; G = max(1,
    min(sms // (dirs S), ceil(R / 64))) groups; S widened to the SMs left
    over; the largest chunk that fits (a warp holds the accumulators of
    every output block of the chunk, at most MAX_ACC_BLOCKS,
    MAX_ACC_BLOCKS_TF32 in float32; a chunk at most MAX_CELLS cells,
    MAX_CELLS_F32 in float32); dc in shared memory if it fits; then the
    widest K tile that fits beside all that.  With dirs = 2, dc moves to
    global memory where that leaves room for fewer K tiles."""
    if elem not in (2, 4):
        raise ValueError(f"no backward route for {elem}-byte elements")
    if min(R, H, sms, dirs) <= 0:
        return None
    max_blocks, max_cells = ((MAX_ACC_BLOCKS, MAX_CELLS) if elem == 2
                             else (MAX_ACC_BLOCKS_TF32, MAX_CELLS_F32))

    def units(S):
        return _ceil(_ceil(H, S), 4) * 4

    def fits(U, chunk, rows=0, dc_in_smem=False):
        blocks = chunk // 16 * _ceil(U, 8)
        return (chunk <= MAX_CHUNK and U <= 64 and blocks <= max_blocks
                and chunk * U <= max_cells
                and _backward_tile(H, U, chunk, rows, dc_in_smem, smem_bytes, elem) is not None)

    S = 1
    while not fits(units(S), 16):
        if units(S) == 4:
            return None
        S += 1
    S = _ceil(H, units(S))
    if dirs * S > sms:
        return None
    G = max(1, min(sms // (dirs * S), _ceil(R, GROUP_ROWS)))
    U = units(min(sms // (dirs * G), _ceil(H, 4)))
    S = _ceil(H, U)
    rows = _ceil(R, G)
    G = _ceil(R, rows)
    chunk = next(c for c in range(min(_pad16(rows), MAX_CHUNK), 0, -16) if fits(U, c))
    dc_in_smem = fits(U, chunk, rows, True)
    kt = _backward_tile(H, U, chunk, rows, dc_in_smem, smem_bytes, elem)
    if dirs > 1 and dc_in_smem:
        # K10p: each CTA walks twice K5p's chunks a step, and a step costs
        # about one round of two barriers per (chunk, K tile), so dc goes
        # to global memory where that frees a wider tile (fewer tiles)
        kt_global = _backward_tile(H, U, chunk, rows, False, smem_bytes, elem)
        if _ceil(_pad16(4 * H), kt_global) < _ceil(_pad16(4 * H), kt):
            dc_in_smem, kt = False, kt_global
    return BackwardPlan(R, H, S, G, U, rows, chunk, kt, dc_in_smem,
                        backward_smem(H, U, chunk, kt, rows, dc_in_smem, elem),
                        dw_split(H, sms, elem), elem, dirs)


def pack_backward_weights(w_hh_t: torch.Tensor, plan: BackwardPlan) -> torch.Tensor:
    """One direction's W_hh^T (H, 4H) in K5p/K7p's layout: (S, Up, Kp), slice
    s holding rows [s U, s U + U) of W_hh^T (unit u's weights over the 4H
    gate columns, the dh product's B operand column u), zero rows past H
    and past U, zero columns past 4H.  Slice s is one contiguous block."""
    H, S, U = plan.H, plan.S, plan.U
    w = torch.nn.functional.pad(w_hh_t, (0, plan.kp - 4 * H, 0, S * U - H))
    return torch.nn.functional.pad(w.reshape(S, U, plan.kp), (0, 0, 0, plan.up - U)).contiguous()


def _h_prev(h: torch.Tensor, reverse: bool, lengths=None) -> torch.Tensor:
    """The h that entered each step of the scan, (R, T, H) f32: h at t - 1
    (t + 1 when reverse), zero at the scan's first step and, with
    ``lengths``, where that step is padded (t + 1 >= lengths[r])."""
    hf = h.float()
    z = torch.zeros_like(hf[:, :1])
    hp = torch.cat([hf[:, 1:], z], dim=1) if reverse else torch.cat([z, hf[:, :-1]], dim=1)
    if lengths is not None:
        T = h.shape[1]
        tp = torch.arange(T, device=h.device) + (1 if reverse else -1)
        hp = hp * (tp[None, :] < lengths.to(h.device)[:, None]).to(hp.dtype)[..., None]
    return hp


def lstm_bwd_dw_plain(h: torch.Tensor, dxp: torch.Tensor, reverse: bool = False,
                      lengths: torch.Tensor | None = None, split: int = 1) -> torch.Tensor:
    """Plain version of ``lstm_bwd_dw``: dW_hh^T (H, 4H) f32 = sum over (r, t)
    of h_prev(r, t)^T dxp(r, t) (``_h_prev``), K = R T cut into ``split``
    parts of whole DW_K-row stages, summed in part order as the kernel does."""
    R, T, G = dxp.shape
    hp = _h_prev(h, reverse, lengths).reshape(R * T, -1)
    d = dxp.float().reshape(R * T, G)
    kc = _ceil(_ceil(R * T, split), DW_K) * DW_K
    dw = hp.new_zeros((hp.shape[1], G))
    for k0 in range(0, R * T, kc):
        dw = dw + hp[k0:k0 + kc].t() @ d[k0:k0 + kc]
    return dw


def _k_owner(plan: BackwardPlan) -> torch.Tensor:
    """The warp that sums each column k of the dh product in K5p/K7p: in K
    tile k // kt, its k16 step j (k8 step on the float32 route, whose TF32
    products are 8 deep) goes to warp j % 8."""
    k = torch.arange(plan.kp)
    return (k % plan.kt) // (32 // plan.elem) % WARPS


def _backward_sliced_plain(h, gates, c, dout, w, plan, reverse, lengths=None):
    """The walk of K5p/K7p over ``plan``'s schedule: at each step the group's
    dgates of the previous step (rounded, read back from dx_proj) times the
    packed slices, as eight per-warp partial sums over the kernel's K split
    added in warp order (with ``lengths``, multiplied by m_t after the
    product); the cell in f32 as ``_backward_plain``; then dW as the dW
    kernel sums it.  Returns (dx_proj, dW_hh^T f32)."""
    R, T, G = gates.shape
    H, U = plan.H, plan.U
    dtype = gates.dtype
    owner = _k_owner(plan).to(gates.device)
    wf = w.float().reshape(plan.S * plan.up, plan.kp)
    cols = torch.cat([torch.arange(s * plan.up, s * plan.up + min(U, H - s * U))
                      for s in range(plan.S)]).to(gates.device)
    dxp = gates.new_zeros((R, T, G))
    dc = torch.zeros((R, H), dtype=torch.float32, device=gates.device)
    for step in range(T):
        t = step if reverse else T - 1 - step
        te = t - 1 if reverse else t + 1  # the step visited before: its dgates give dh
        tp = t + 1 if reverse else t - 1  # the scan's previous step
        for g in range(plan.G):
            rows = slice(g * plan.rows, min((g + 1) * plan.rows, R))
            n = rows.stop - rows.start
            ones = torch.ones((n, 1), device=gates.device)
            keep = None if lengths is None else lengths[rows].to(gates.device)[:, None]
            m = ones if keep is None else (t < keep).float()
            mp = ones if keep is None else (tp < keep).float()
            dh = torch.zeros((n, H), device=gates.device)
            if step:
                a = torch.nn.functional.pad(dxp[rows, te].float(), (0, plan.kp - G))
                part = None
                for wp in range(WARPS):
                    own = owner == wp
                    p = a[:, own] @ wf[:, own].t()
                    part = p if part is None else part + p
                dh = part[:, cols]
            i, f, gg, o = gates[rows, t].float().chunk(4, dim=-1)
            cp = c[rows, tp].float() * mp if 0 <= tp < T else torch.zeros_like(dh)
            tc = torch.tanh(f * cp + i * gg)
            dhv = dout[rows, t].float() + dh * m
            dcv = dc[rows] * m + dhv * o * (1.0 - tc * tc)
            dxp[rows, t] = torch.cat([dcv * gg * i * (1.0 - i), dcv * cp * f * (1.0 - f),
                                      dcv * i * (1.0 - gg * gg),
                                      dhv * tc * o * (1.0 - o)], dim=-1).to(dtype)
            dc[rows] = dcv * f
    return dxp, lstm_bwd_dw_plain(h, dxp, reverse, lengths, plan.dw_split)


def lstm_train_bwd_sliced_plain(h: torch.Tensor, gates: torch.Tensor, c: torch.Tensor,
                                dout: torch.Tensor, w_packed: torch.Tensor,
                                plan: BackwardPlan, reverse: bool = False):
    """Plain version of K5p and its dW kernel: reads only the packed slices
    (``w_packed`` = ``pack_backward_weights``'s) and walks the kernel's
    schedule step by step -> (dx_proj, dW_hh^T f32)."""
    return _backward_sliced_plain(h, gates, c, dout, w_packed, plan, reverse)


def lstm_revmasked_bwd_sliced_plain(h: torch.Tensor, gates: torch.Tensor, c: torch.Tensor,
                                    lengths: torch.Tensor, dout: torch.Tensor,
                                    w_packed: torch.Tensor, plan: BackwardPlan):
    """Plain version of K7p and its dW kernel: the masked backward over the
    packed slices; dx_proj equals ``lstm_revmasked_bwd_plain``'s at every
    step, padded ones included."""
    return _backward_sliced_plain(h, gates, c, dout, w_packed, plan, True, lengths)


def lstm_train_bwd2_sliced_plain(res_f, res_b, dout_f: torch.Tensor, dout_b: torch.Tensor,
                                 w_packed_f: torch.Tensor, w_packed_b: torch.Tensor,
                                 plan: BackwardPlan):
    """Plain version of K10p and its dW kernels: K5p's sliced walk per
    direction over the one (dirs = 2) plan, the forward scan's backward on
    ``res_f`` (h, gates, c) and the reverse scan's on ``res_b``, each over
    its own packed slices -> (dx_proj_f, dW_f^T f32, dx_proj_b, dW_b^T f32)."""
    return (*_backward_sliced_plain(*res_f, dout_f, w_packed_f, plan, False),
            *_backward_sliced_plain(*res_b, dout_b, w_packed_b, plan, True))


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


def rows_per_block(R: int, grid_y: int, device: torch.device, H: int) -> int:
    """The largest row tile (8, 4, 2, 1) whose grid still covers every SM:
    few rows (the batch-1 time path) go to many small blocks, many rows to
    fewer blocks that share each weight read over more rows.  Above
    ``WIDE_HIDDEN`` units the tile is at most ``WIDE_MAX_ROWS``: each thread
    holds the accumulators of two units, and the larger tile spills."""
    sms = _sm_count(device.index if device.index is not None else torch.cuda.current_device())
    cap = WIDE_MAX_ROWS if H > WIDE_HIDDEN else 8
    for rows in (8, 4, 2):
        if rows <= cap and -(-R // rows) * grid_y >= sms:
            return rows
    return 1


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def _device_index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def k1_route(dtype: torch.dtype, R: int, N: int, H: int, sms: int) -> PersistentPlan | None:
    """K1's route, a fixed rule decided before launch from the dtype and the
    shape: for bfloat16 the K1p plan ``plan_persistent`` finds on ``sms``
    SMs; for float32 the two-direction K1p-f32 plan (elem = 4, 3xTF32
    products, one launch) where one fits, else the one-direction plan (two
    launches, one a direction: the flow width); else None (the walk: no
    plan)."""
    if dtype == torch.bfloat16:
        return plan_persistent(R, N, H, sms)
    if dtype == torch.float32:
        return (plan_persistent(R, N, H, sms, elem=4)
                or plan_persistent(R, N, H, sms, dirs=1, elem=4))
    return None


def fusedin_bilstm(x: torch.Tensor, w_ih_t: torch.Tensor, w_hh_t: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """K1: bidirectional LSTM on the raw input; (R, T, N) -> (R, T, 2H), on
    the route ``k1_route`` picks (K1p, K1p-f32 in one launch or two, or the
    walk)."""
    if x.device.type == "cpu":
        return fusedin_bilstm_plain(x, w_ih_t, w_hh_t, bias)
    R, _, N = x.shape
    plan = k1_route(x.dtype, R, N, w_hh_t.shape[1], _sm_count(_device_index(x.device)))
    if plan is None:
        return fusedin_bilstm_walk(x, w_ih_t, w_hh_t, bias)
    return fusedin_bilstm_persistent(x, w_ih_t, w_hh_t, bias, plan)


def _check_k1(x, w_ih_t, w_hh_t, bias):
    R, T, N = x.shape
    H = w_hh_t.shape[1]
    _check("x", x, (R, T, N), x.dtype, x.device)
    _check("w_ih_t", w_ih_t, (2, N, 4 * H), x.dtype, x.device)
    _check("w_hh_t", w_hh_t, (2, H, 4 * H), x.dtype, x.device)
    _check("bias", bias, (2, 4 * H), x.dtype, x.device)
    return R, T, N, H, torch.empty((R, T, 2 * H), dtype=x.dtype, device=x.device)


def fusedin_bilstm_walk(x: torch.Tensor, w_ih_t: torch.Tensor, w_hh_t: torch.Tensor,
                        bias: torch.Tensor) -> torch.Tensor:
    """K1's walk (csrc/lstm_kernels.cu ``fusedin_kernel``), float32 or
    bfloat16; counted in ``fusedin_bilstm.launches`` and ``.routes["walk"]``."""
    if x.device.type == "cpu":
        return fusedin_bilstm_plain(x, w_ih_t, w_hh_t, bias)
    dtype, stream = _kernel_args(x, w_hh_t.shape[1])
    R, T, N, H, out = _check_k1(x, w_ih_t, w_hh_t, bias)
    if R == 0 or T == 0:
        return out
    from urgent2026_challenge_track1_tpu_torch.ops._build import load_library

    err = load_library().lstm_fusedin_bilstm(
        x.data_ptr(), w_ih_t.data_ptr(), w_hh_t.data_ptr(), bias.data_ptr(),
        out.data_ptr(), R, T, N, H, dtype, rows_per_block(R, 2, x.device, H), stream,
    )
    _raise_on(err, "fusedin_bilstm")
    _count(fusedin_bilstm, "walk")
    return out


def fusedin_bilstm_persistent(x: torch.Tensor, w_ih_t: torch.Tensor, w_hh_t: torch.Tensor,
                              bias: torch.Tensor, plan: PersistentPlan | None = None,
                              library=None) -> torch.Tensor:
    """K1p (csrc/lstm_persistent.cu), bfloat16, or K1p-f32, float32 (3xTF32
    products): packs the weights for ``plan`` (``k1_route``'s by default)
    and launches from ``library`` (the plain build by default) one
    cooperative grid for both directions, or, on a one-direction float32
    plan (dirs = 1), one grid a direction, each into its half of the
    output; a grid the card cannot hold resident raises.  Counted in
    ``fusedin_bilstm.launches`` and ``.routes["persistent"]`` (one grid) or
    ``.routes["persistent_split"]`` (each launch of the pair)."""
    if x.device.type == "cpu":
        return fusedin_bilstm_plain(x, w_ih_t, w_hh_t, bias)
    R, T, N = x.shape
    H = w_hh_t.shape[1]
    if x.device.type != "cuda":
        raise ValueError(f"kernel input on unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"K1p takes bfloat16 or float32 inputs, not {x.dtype}")
    elem = x.element_size()
    out = _check_k1(x, w_ih_t, w_hh_t, bias)[-1]
    plan = plan or k1_route(x.dtype, R, N, H, _sm_count(_device_index(x.device)))
    if plan is None:
        raise ValueError(f"no K1p plan for R={R}, N={N}, H={H}, {x.dtype}")
    if (plan.R, plan.N, plan.H, plan.elem) != (R, N, H, elem) or plan.dirs not in (
            (1, 2) if elem == 4 else (2,)):
        raise ValueError(f"plan for {(plan.R, plan.N, plan.H, plan.elem, plan.dirs)}, "
                         f"inputs {(R, N, H, elem)}")
    if T == 0:
        return out
    if library is None:
        from urgent2026_challenge_track1_tpu_torch.ops._build import load_library

        library = load_library()
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    w, b = pack_persistent_weights(w_ih_t, w_hh_t, bias, plan)
    # one grid for both directions, or one a direction (its slices, c and counters)
    launches = ((None, 2),) if plan.dirs == 2 else ((0, 1), (1, 1))
    for d, dirs in launches:
        c = None if plan.c_in_smem else torch.empty((R, dirs, H), dtype=torch.float32,
                                                     device=x.device)
        counters = torch.zeros((dirs, plan.G), dtype=torch.int32, device=x.device)
        wd, bd = (w, b) if d is None else (w[d], b[d])
        err = library.lstm_fusedin_persistent(
            x.data_ptr(), wd.data_ptr(), bd.data_ptr(), out.data_ptr(), _ptr(c),
            counters.data_ptr(), R, T, N, H, plan.S, plan.G, plan.U, plan.rows, plan.chunk,
            int(plan.c_in_smem), dirs, d or 0, elem, stream,
        )
        _raise_on(err, "fusedin_bilstm_persistent")
        _count(fusedin_bilstm, "persistent" if d is None else "persistent_split")
    return out


def scan_route(dtype: torch.dtype, R: int, H: int, sms: int) -> PersistentPlan | None:
    """The route of K2, K3 and the training forwards K4 and K6 (whose
    persistent kernels K4p / K6p are K2p's and K3p's with the residual
    stores, on the same plans): a fixed rule decided before launch from the
    dtype and the shape.  bfloat16 takes the one-direction plan
    ``plan_persistent`` finds on ``sms`` SMs; float32 takes the float32
    plan (elem = 4, 3xTF32 products: K2p-f32, K3p-f32, K4p-f32, K6p-f32);
    anything else, or no plan, is None (the walk: float32 at H = 1020)."""
    if dtype == torch.bfloat16:
        return plan_persistent(R, 0, H, sms, dirs=1)
    if dtype == torch.float32:
        return plan_persistent(R, 0, H, sms, dirs=1, elem=4)
    return None


def _routed(plain, walk, persistent, x_proj: torch.Tensor, *args, **kwargs):
    """The dispatch of K2, K3, K4 and K6 on ``(x_proj, *args)``:
    the plain version on the CPU, else the route ``scan_route`` picks (the
    persistent kernel with its plan, or the walk)."""
    if x_proj.device.type == "cpu":
        return plain(x_proj, *args, **kwargs)
    R, _, G = x_proj.shape
    plan = scan_route(x_proj.dtype, R, G // 4, _sm_count(_device_index(x_proj.device)))
    if plan is None:
        return walk(x_proj, *args, **kwargs)
    return persistent(x_proj, *args, plan, **kwargs)


def lstm_scan(x_proj: torch.Tensor, w_hh_t: torch.Tensor, reverse: bool = False,
              initial_state=None, return_state: bool = False):
    """K2: one direction over a hoisted projection; (R, T, 4H) -> (R, T, H),
    on the route ``scan_route`` picks (K2p, K2p-f32 or the walk).  The
    carry of a chunked stream (JAX ``_scan_dir``'s): ``initial_state`` (h0
    (R, H) in x_proj's dtype, c0 (R, H) float32) starts the walk there
    instead of at zeros, and ``return_state`` returns (h, (hT, cT)), the
    last step's state in the same dtypes."""
    return _routed(lstm_scan_plain, lstm_scan_walk, lstm_scan_persistent,
                   x_proj, w_hh_t, reverse, initial_state=initial_state,
                   return_state=return_state)


def lstm_revmasked(x_proj: torch.Tensor, w_hh_t: torch.Tensor,
                   lengths: torch.Tensor) -> torch.Tensor:
    """K3: length-masked reverse walk; (R, T, 4H), (R,) -> (R, T, H), on the
    route ``scan_route`` picks (K3p, K3p-f32 or the walk).  Outputs at t <
    lengths[r] equal a fresh reverse scan of the valid prefix; outputs at t
    >= lengths[r] are unspecified to callers (both routes write the plain
    version's)."""
    return _routed(lstm_revmasked_plain, lstm_revmasked_walk, lstm_revmasked_persistent,
                   x_proj, w_hh_t, lengths)


def _count(fn, route: str) -> None:
    fn.launches += 1
    fn.routes[route] += 1


def _carry_buffers(x_proj: torch.Tensor, initial_state, return_state: bool):
    """K2's carry as kernel pointers: (h0, c0) checked (h0 (R, H) in
    x_proj's dtype, c0 (R, H) float32, contiguous, on x_proj's device) and
    fresh (hT, cT) when ``return_state``; each None where absent."""
    R, _, G = x_proj.shape
    H = G // 4
    h0 = c0 = hT = cT = None
    if initial_state is not None:
        h0, c0 = initial_state
        _check("h0", h0, (R, H), x_proj.dtype, x_proj.device)
        _check("c0", c0, (R, H), torch.float32, x_proj.device)
    if return_state:
        hT = torch.empty((R, H), dtype=x_proj.dtype, device=x_proj.device)
        cT = torch.empty((R, H), dtype=torch.float32, device=x_proj.device)
    return h0, c0, hT, cT


def _ptr(t):
    return None if t is None else t.data_ptr()


def _empty_walk_state(x_proj: torch.Tensor, initial_state):
    """(hT, cT) of a walk over no steps or rows: the initial state, or zeros."""
    if initial_state is not None:
        return initial_state[0].clone(), initial_state[1].clone()
    R, _, G = x_proj.shape
    return (x_proj.new_zeros((R, G // 4)),
            torch.zeros((R, G // 4), dtype=torch.float32, device=x_proj.device))


def _check_scan(x_proj, w_hh_t, lengths):
    R, T, G = x_proj.shape
    H = G // 4
    _check("x_proj", x_proj, (R, T, 4 * H), x_proj.dtype, x_proj.device)
    _check("w_hh_t", w_hh_t, (H, 4 * H), x_proj.dtype, x_proj.device)
    if lengths is not None:
        _check("lengths", lengths, (R,), torch.int32, x_proj.device)
    return R, T, H, torch.empty((R, T, H), dtype=x_proj.dtype, device=x_proj.device)


def lstm_scan_walk(x_proj: torch.Tensor, w_hh_t: torch.Tensor, reverse: bool = False,
                   initial_state=None, return_state: bool = False):
    """K2's walk (csrc/lstm_kernels.cu ``recurrence_kernel``), float32 or
    bfloat16, with ``lstm_scan``'s carry; counted in ``lstm_scan.launches``
    and ``.routes["walk"]``."""
    if x_proj.device.type == "cpu":
        return lstm_scan_plain(x_proj, w_hh_t, reverse, initial_state, return_state)
    dtype, stream = _kernel_args(x_proj, x_proj.shape[-1] // 4)
    R, T, H, out = _check_scan(x_proj, w_hh_t, None)
    h0, c0, hT, cT = _carry_buffers(x_proj, initial_state, return_state)
    if R == 0 or T == 0:
        return (out, _empty_walk_state(x_proj, initial_state)) if return_state else out
    from urgent2026_challenge_track1_tpu_torch.ops._build import load_library

    err = load_library().lstm_scan(
        x_proj.data_ptr(), w_hh_t.data_ptr(), out.data_ptr(), _ptr(h0), _ptr(c0), _ptr(hT),
        _ptr(cT), R, T, H, int(bool(reverse)), dtype, rows_per_block(R, 1, x_proj.device, H),
        stream,
    )
    _raise_on(err, "lstm_scan")
    _count(lstm_scan, "walk")
    return (out, (hT, cT)) if return_state else out


def lstm_revmasked_walk(x_proj: torch.Tensor, w_hh_t: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """K3's walk (csrc/lstm_kernels.cu ``recurrence_kernel``), float32 or
    bfloat16; counted in ``lstm_revmasked.launches`` and ``.routes["walk"]``."""
    if x_proj.device.type == "cpu":
        return lstm_revmasked_plain(x_proj, w_hh_t, lengths)
    dtype, stream = _kernel_args(x_proj, x_proj.shape[-1] // 4)
    R, T, H, out = _check_scan(x_proj, w_hh_t, lengths)
    if R == 0 or T == 0:
        return out
    from urgent2026_challenge_track1_tpu_torch.ops._build import load_library

    err = load_library().lstm_revmasked(
        x_proj.data_ptr(), w_hh_t.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        R, T, H, dtype, rows_per_block(R, 1, x_proj.device, H), stream,
    )
    _raise_on(err, "lstm_revmasked")
    _count(lstm_revmasked, "walk")
    return out


def _scan_persistent(fn, x_proj, w_hh_t, reverse, lengths, plan, store=False,
                     initial_state=None, return_state=False):
    """Launch K2p (``lengths`` None) or K3p, or with ``store`` K4p or K6p
    (then returns h, gates, c): one cooperative grid of G x S CTAs over
    ``plan`` (``plan_persistent``'s for one direction by default); a grid
    the card cannot hold resident raises.  bfloat16 or float32 (the float32
    routes K2p-f32 - K6p-f32: f32 throughout, 3xTF32 products).  K2p only
    (either dtype): ``lstm_scan``'s carry (``initial_state``,
    ``return_state``)."""
    name = fn.__name__ + "_persistent"
    if (initial_state is not None or return_state) and (store or lengths is not None):
        raise ValueError(f"{name} takes no carry: only K2p carries (h, c)")
    if x_proj.device.type != "cuda":
        raise ValueError(f"kernel input on unsupported device {x_proj.device}")
    if x_proj.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name} takes bfloat16 or float32 inputs, not {x_proj.dtype}")
    elem = x_proj.element_size()
    R, T, H, out = _check_scan(x_proj, w_hh_t, lengths)
    plan = plan or plan_persistent(R, 0, H, _sm_count(_device_index(x_proj.device)), dirs=1,
                                   elem=elem)
    if plan is None:
        raise ValueError(f"no {name} plan for R={R}, H={H}, {x_proj.dtype}")
    if (plan.R, plan.N, plan.H, plan.dirs, plan.elem) != (R, 0, H, 1, elem):
        raise ValueError(f"plan for {(plan.R, plan.N, plan.H, plan.dirs, plan.elem)}, "
                         f"inputs {(R, 0, H, 1, elem)}")
    # K4p/K6p's residuals: gates (R, T, 4H) and c (R, T, H)
    res = tuple(torch.empty((R, T, n), dtype=x_proj.dtype, device=x_proj.device)
                for n in ((4 * H, H) if store else ()))
    h0, c0, hT, cT = _carry_buffers(x_proj, initial_state, return_state)
    if T == 0:
        if return_state:
            return out, _empty_walk_state(x_proj, initial_state)
        return (out, *res) if store else out
    w = pack_scan_weights(w_hh_t, plan)
    c = None if plan.c_in_smem else torch.empty((R, H), dtype=torch.float32,
                                                 device=x_proj.device)
    counters = torch.zeros((plan.G,), dtype=torch.int32, device=x_proj.device)
    from urgent2026_challenge_track1_tpu_torch.ops._build import load_library

    err = load_library().lstm_scan_persistent(
        x_proj.data_ptr(), w.data_ptr(), None if lengths is None else lengths.data_ptr(),
        out.data_ptr(), *([t.data_ptr() for t in res] or [None, None]),
        _ptr(h0), _ptr(c0), _ptr(hT), _ptr(cT),
        None if c is None else c.data_ptr(), counters.data_ptr(), R, T, H,
        int(bool(reverse)), plan.S, plan.G, plan.U, plan.rows, plan.chunk,
        int(plan.c_in_smem), elem,
        ctypes.c_void_p(torch.cuda.current_stream(x_proj.device).cuda_stream),
    )
    _raise_on(err, name)
    _count(fn, "persistent")
    if return_state:
        return out, (hT, cT)
    return (out, *res) if store else out


def lstm_scan_persistent(x_proj: torch.Tensor, w_hh_t: torch.Tensor, reverse: bool = False,
                         plan: PersistentPlan | None = None, initial_state=None,
                         return_state: bool = False):
    """K2p (csrc/lstm_persistent.cu ``scan_persistent_kernel<T, REVERSE,
    false, false>``), bfloat16, or K2p-f32, float32 (T = float: 3xTF32
    products, the plan's elem = 4): packs W_hh for ``plan`` and launches one
    cooperative grid; with ``lstm_scan``'s carry (h0 and hT in x_proj's
    dtype).  Counted in ``lstm_scan.launches`` and ``.routes["persistent"]``."""
    if x_proj.device.type == "cpu":
        return lstm_scan_plain(x_proj, w_hh_t, reverse, initial_state, return_state)
    return _scan_persistent(lstm_scan, x_proj, w_hh_t, reverse, None, plan,
                            initial_state=initial_state, return_state=return_state)


def lstm_revmasked_persistent(x_proj: torch.Tensor, w_hh_t: torch.Tensor,
                              lengths: torch.Tensor,
                              plan: PersistentPlan | None = None) -> torch.Tensor:
    """K3p (``scan_persistent_kernel<T, true, true, false>``), bfloat16, or
    K3p-f32, float32, as ``lstm_scan_persistent``; its output equals the
    plain version's at every step.  Counted in ``lstm_revmasked.launches``
    and ``.routes["persistent"]``."""
    if x_proj.device.type == "cpu":
        return lstm_revmasked_plain(x_proj, w_hh_t, lengths)
    return _scan_persistent(lstm_revmasked, x_proj, w_hh_t, True, lengths, plan)


def _train_outputs(x_proj: torch.Tensor, H: int):
    R, T, _ = x_proj.shape
    return (torch.empty((R, T, H), dtype=x_proj.dtype, device=x_proj.device),
            torch.empty((R, T, 4 * H), dtype=x_proj.dtype, device=x_proj.device),
            torch.empty((R, T, H), dtype=x_proj.dtype, device=x_proj.device))


def lstm_train_fwd(x_proj: torch.Tensor, w_hh_t: torch.Tensor, reverse: bool = False):
    """K4: ``lstm_scan`` that also returns the backward's residuals;
    (R, T, 4H) -> (h (R, T, H), gates i, f, g, o (R, T, 4H), c (R, T, H)),
    all in x_proj's dtype, on the route ``scan_route`` picks (K4p,
    bfloat16 or float32, or the walk)."""
    return _routed(lstm_train_fwd_plain, lstm_train_fwd_walk, lstm_train_fwd_persistent,
                   x_proj, w_hh_t, reverse)


def lstm_revmasked_train_fwd(x_proj: torch.Tensor, w_hh_t: torch.Tensor,
                             lengths: torch.Tensor):
    """K6: ``lstm_revmasked`` that also returns the backward's residuals
    (h and c unmasked), as ``lstm_train_fwd``, on the route ``scan_route``
    picks (K6p, bfloat16 or float32, or the walk)."""
    return _routed(lstm_revmasked_train_fwd_plain, lstm_revmasked_train_fwd_walk,
                   lstm_revmasked_train_fwd_persistent, x_proj, w_hh_t, lengths)


def lstm_train_fwd_walk(x_proj: torch.Tensor, w_hh_t: torch.Tensor, reverse: bool = False,
                        fn=lstm_train_fwd):
    """K4's walk (csrc/lstm_kernels.cu ``recurrence_kernel<false, true>``),
    float32 or bfloat16; counted in ``fn.launches`` and ``.routes["walk"]``
    (``lstm_train_fwd``'s, or K9's for its launches)."""
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
        R, T, H, int(bool(reverse)), dtype, rows_per_block(R, 1, x_proj.device, H), stream,
    )
    _raise_on(err, "lstm_train_fwd")
    _count(fn, "walk")
    return out, gates, c


def lstm_revmasked_train_fwd_walk(x_proj: torch.Tensor, w_hh_t: torch.Tensor,
                                  lengths: torch.Tensor):
    """K6's walk (csrc/lstm_kernels.cu ``recurrence_kernel<true, true>``),
    float32 or bfloat16; counted in ``lstm_revmasked_train_fwd.launches``
    and ``.routes["walk"]``."""
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
        rows_per_block(R, 1, x_proj.device, H), stream,
    )
    _raise_on(err, "lstm_revmasked_train_fwd")
    _count(lstm_revmasked_train_fwd, "walk")
    return out, gates, c


def lstm_train_fwd_persistent(x_proj: torch.Tensor, w_hh_t: torch.Tensor, reverse: bool = False,
                              plan: PersistentPlan | None = None):
    """K4p (csrc/lstm_persistent.cu ``scan_persistent_kernel<T, REVERSE,
    false, true>``), bfloat16 or float32 (T = float: 3xTF32 products, the
    plan's elem = 4): K2p that also stores the residuals -> (h, gates, c).
    Counted in ``lstm_train_fwd.launches`` and ``.routes["persistent"]``."""
    if x_proj.device.type == "cpu":
        return lstm_train_fwd_plain(x_proj, w_hh_t, reverse)
    return _scan_persistent(lstm_train_fwd, x_proj, w_hh_t, reverse, None, plan, True)


def lstm_revmasked_train_fwd_persistent(x_proj: torch.Tensor, w_hh_t: torch.Tensor,
                                        lengths: torch.Tensor,
                                        plan: PersistentPlan | None = None):
    """K6p (``scan_persistent_kernel<T, true, true, true>``), bfloat16 or
    float32, as ``lstm_train_fwd_persistent``: K3p that also stores the
    residuals (h and c unmasked) -> (h, gates, c), equal to the plain
    version's at every step.  Counted in ``lstm_revmasked_train_fwd.launches``
    and ``.routes["persistent"]``."""
    if x_proj.device.type == "cpu":
        return lstm_revmasked_train_fwd_plain(x_proj, w_hh_t, lengths)
    return _scan_persistent(lstm_revmasked_train_fwd, x_proj, w_hh_t, True, lengths, plan, True)


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


def backward_route(dtype: torch.dtype, R: int, H: int, sms: int) -> BackwardPlan | None:
    """The route of K5 and K7, a fixed rule decided before launch from the
    dtype and the shape: the K5p/K7p plan ``plan_backward`` finds on ``sms``
    SMs, in bfloat16 (elem = 2) or in float32 (elem = 4: 3xTF32 products and
    the float32 dW kernel); anything else, or no plan, is None (the walk and
    ``dw_kernel``)."""
    if dtype == torch.bfloat16:
        return plan_backward(R, H, sms)
    if dtype == torch.float32:
        return plan_backward(R, H, sms, elem=4)
    return None


def _routed_bwd(plain, walk, persistent, h, gates, *args):
    """The dispatch of K5 and K7 on ``(h, gates, *args)``: the plain version
    on the CPU, else the route ``backward_route`` picks."""
    if gates.device.type == "cpu":
        return plain(h, gates, *args)
    R, _, G = gates.shape
    plan = backward_route(gates.dtype, R, G // 4, _sm_count(_device_index(gates.device)))
    if plan is None:
        return walk(h, gates, *args)
    return persistent(h, gates, *args, plan)


def lstm_train_bwd(h: torch.Tensor, gates: torch.Tensor, c: torch.Tensor,
                   dout: torch.Tensor, w_hh_t: torch.Tensor, reverse: bool = False):
    """K5: the backward of ``lstm_train_fwd`` from its outputs (h, gates, c) and the
    incoming dh (R, T, H) -> (dx_proj (R, T, 4H), dW_hh^T (H, 4H)), dW
    summed in f32 by the kernel and returned in w_hh_t's dtype, on the route
    ``backward_route`` picks (K5p, bfloat16 or float32, or the walk)."""
    return _routed_bwd(lstm_train_bwd_plain, lstm_train_bwd_walk, lstm_train_bwd_persistent,
                       h, gates, c, dout, w_hh_t, reverse)


def lstm_revmasked_bwd(h: torch.Tensor, gates: torch.Tensor, c: torch.Tensor,
                       lengths: torch.Tensor, dout: torch.Tensor, w_hh_t: torch.Tensor):
    """K7: the backward of ``lstm_revmasked_train_fwd``, as ``lstm_train_bwd``,
    on the route ``backward_route`` picks (K7p, bfloat16 or float32, or the
    walk)."""
    return _routed_bwd(lstm_revmasked_bwd_plain, lstm_revmasked_bwd_walk,
                       lstm_revmasked_bwd_persistent, h, gates, c, lengths, dout, w_hh_t)


def lstm_train_bwd_walk(h: torch.Tensor, gates: torch.Tensor, c: torch.Tensor,
                        dout: torch.Tensor, w_hh_t: torch.Tensor, reverse: bool = False):
    """K5's walk and ``dw_kernel`` (csrc/lstm_kernels.cu), float32 or
    bfloat16; counted in ``lstm_train_bwd.launches`` and ``.routes["walk"]``."""
    if gates.device.type == "cpu":
        return lstm_train_bwd_plain(h, gates, c, dout, w_hh_t, reverse)
    R, T, H, dtype, stream, w4h, dxp, dw = _check_residuals(h, gates, c, dout, w_hh_t)
    if R == 0 or T == 0:
        return dxp, dw.to(w_hh_t.dtype)
    from urgent2026_challenge_track1_tpu_torch.ops._build import load_library

    err = load_library().lstm_train_bwd(
        gates.data_ptr(), c.data_ptr(), h.data_ptr(), dout.data_ptr(), w4h.data_ptr(),
        dxp.data_ptr(), dw.data_ptr(), R, T, H, int(bool(reverse)), dtype,
        rows_per_block(R, 1, gates.device, H), stream,
    )
    _raise_on(err, "lstm_train_bwd")
    _count(lstm_train_bwd, "walk")
    return dxp, dw.to(w_hh_t.dtype)


def lstm_revmasked_bwd_walk(h: torch.Tensor, gates: torch.Tensor, c: torch.Tensor,
                            lengths: torch.Tensor, dout: torch.Tensor, w_hh_t: torch.Tensor):
    """K7's walk and ``dw_kernel<MASKED>`` (csrc/lstm_kernels.cu), float32 or
    bfloat16; counted in ``lstm_revmasked_bwd.launches`` and
    ``.routes["walk"]``."""
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
        rows_per_block(R, 1, gates.device, H), stream,
    )
    _raise_on(err, "lstm_revmasked_bwd")
    _count(lstm_revmasked_bwd, "walk")
    return dxp, dw.to(w_hh_t.dtype)


def lstm_bwd_dw(h: torch.Tensor, dxp: torch.Tensor, reverse: bool = False,
                lengths: torch.Tensor | None = None, split: int | None = None) -> torch.Tensor:
    """The dW kernel of K5p and K7p (csrc/lstm_persistent_bwd.cu: ``dw_tc_kernel``
    in bfloat16, ``dw_tf32_kernel`` in float32, 3xTF32): dW_hh^T (H, 4H) f32
    = sum over (r, t) of h_prev(r, t)^T dxp(r, t) on the tensor cores,
    h_prev read with the scan's shift (and, with ``lengths``, K7's mask) by
    the kernel's loader; K = R T in ``split`` parts (``dw_split``'s by
    default) summed in a fixed order, so a launch is deterministic.  Counted
    in ``lstm_bwd_dw.launches``."""
    if dxp.device.type == "cpu":
        return lstm_bwd_dw_plain(h, dxp, reverse, lengths, split or 1)
    R, T, G = dxp.shape
    H = G // 4
    if dxp.device.type != "cuda":
        raise ValueError(f"kernel input on unsupported device {dxp.device}")
    if dxp.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"lstm_bwd_dw takes bfloat16 or float32 inputs, not {dxp.dtype}")
    _check("dxp", dxp, (R, T, 4 * H), dxp.dtype, dxp.device)
    _check("h", h, (R, T, H), dxp.dtype, dxp.device)
    if lengths is not None:
        _check("lengths", lengths, (R,), torch.int32, dxp.device)
    elem = dxp.element_size()
    split = split or dw_split(H, _sm_count(_device_index(dxp.device)), elem)
    dw = torch.empty((H, 4 * H), dtype=torch.float32, device=dxp.device)
    if R == 0 or T == 0:
        return dw.zero_()
    ws = (torch.empty((split, H, 4 * H), dtype=torch.float32, device=dxp.device)
          if split > 1 else None)
    from urgent2026_challenge_track1_tpu_torch.ops._build import load_library

    err = load_library().lstm_bwd_dw(
        h.data_ptr(), dxp.data_ptr(), None if lengths is None else lengths.data_ptr(),
        dw.data_ptr(), None if ws is None else ws.data_ptr(), R, T, H, int(bool(reverse)),
        split, elem, ctypes.c_void_p(torch.cuda.current_stream(dxp.device).cuda_stream),
    )
    _raise_on(err, "lstm_bwd_dw")
    lstm_bwd_dw.launches += 1
    return dw


def _check_bwd_persistent(name, h, gates, c, dout, w_hh_t, lengths=None):
    """The persistent backwards' input checks (bfloat16 or float32 on the
    card, contiguous, of one shape) -> (R, T, H, elem)."""
    if gates.device.type != "cuda":
        raise ValueError(f"kernel input on unsupported device {gates.device}")
    if gates.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name} takes bfloat16 or float32 inputs, not {gates.dtype}")
    R, T, G = gates.shape
    H = G // 4
    _check("gates", gates, (R, T, 4 * H), gates.dtype, gates.device)
    for arg, t in (("c", c), ("h", h), ("dout", dout)):
        _check(arg, t, (R, T, H), gates.dtype, gates.device)
    _check("w_hh_t", w_hh_t, (H, 4 * H), gates.dtype, gates.device)
    if lengths is not None:
        _check("lengths", lengths, (R,), torch.int32, gates.device)
    return R, T, H, gates.element_size()


def _bwd_persistent(fn, h, gates, c, dout, w_hh_t, reverse, lengths, plan,
                    route="persistent"):
    """Launch K5p (``lengths`` None) or K7p: one cooperative grid of G x S
    CTAs over ``plan`` (``plan_backward``'s for the inputs' dtype by
    default; a K10p plan runs one direction of its grid), then the dW
    kernel; a grid the card cannot hold resident raises.  bfloat16, or
    float32 (the float32 route: f32 throughout, 3xTF32 products).  Counted
    in ``fn``'s ``route``.  Returns (dx_proj, dW_hh^T in w_hh_t's dtype)."""
    name = fn.__name__ + "_persistent"
    R, T, H, elem = _check_bwd_persistent(name, h, gates, c, dout, w_hh_t, lengths)
    plan = plan or plan_backward(R, H, _sm_count(_device_index(gates.device)), elem=elem)
    if plan is None:
        raise ValueError(f"no {name} plan for R={R}, H={H}, {gates.dtype}")
    if (plan.R, plan.H, plan.elem) != (R, H, elem):
        raise ValueError(f"plan for {(plan.R, plan.H, plan.elem)}, inputs {(R, H, elem)}")
    dxp = torch.empty((R, T, 4 * H), dtype=gates.dtype, device=gates.device)
    if T == 0:
        return dxp, torch.zeros((H, 4 * H), dtype=w_hh_t.dtype, device=gates.device)
    w = pack_backward_weights(w_hh_t, plan)
    dc = None if plan.dc_in_smem else torch.empty((R, H), dtype=torch.float32,
                                                   device=gates.device)
    counters = torch.zeros((plan.G,), dtype=torch.int32, device=gates.device)
    from urgent2026_challenge_track1_tpu_torch.ops._build import load_library

    err = load_library().lstm_bwd_persistent(
        gates.data_ptr(), c.data_ptr(), dout.data_ptr(), w.data_ptr(),
        None if lengths is None else lengths.data_ptr(), dxp.data_ptr(),
        None if dc is None else dc.data_ptr(), counters.data_ptr(), R, T, H,
        int(bool(reverse)), plan.S, plan.G, plan.U, plan.rows, plan.chunk, plan.kt,
        int(plan.dc_in_smem), elem,
        ctypes.c_void_p(torch.cuda.current_stream(gates.device).cuda_stream),
    )
    _raise_on(err, name)
    dw = lstm_bwd_dw(h, dxp, reverse, lengths, plan.dw_split)
    _count(fn, route)
    return dxp, dw.to(w_hh_t.dtype)


def lstm_train_bwd_persistent(h: torch.Tensor, gates: torch.Tensor, c: torch.Tensor,
                              dout: torch.Tensor, w_hh_t: torch.Tensor, reverse: bool = False,
                              plan: BackwardPlan | None = None):
    """K5p (csrc/lstm_persistent_bwd.cu ``bwd_persistent_kernel<T, false>``) and
    the dW kernel, bfloat16 or float32 (T = float: 3xTF32 products, the
    plan's elem = 4) -> (dx_proj, dW_hh^T).  Counted in
    ``lstm_train_bwd.launches`` and ``.routes["persistent"]``."""
    if gates.device.type == "cpu":
        return lstm_train_bwd_plain(h, gates, c, dout, w_hh_t, reverse)
    return _bwd_persistent(lstm_train_bwd, h, gates, c, dout, w_hh_t, reverse, None, plan)


def lstm_revmasked_bwd_persistent(h: torch.Tensor, gates: torch.Tensor, c: torch.Tensor,
                                  lengths: torch.Tensor, dout: torch.Tensor,
                                  w_hh_t: torch.Tensor, plan: BackwardPlan | None = None):
    """K7p (``bwd_persistent_kernel<T, true>``) and the dW kernel, bfloat16
    or float32, as ``lstm_train_bwd_persistent``; dx_proj equals the plain
    version's at every step.  Counted in
    ``lstm_revmasked_bwd.launches`` and ``.routes["persistent"]``."""
    if gates.device.type == "cpu":
        return lstm_revmasked_bwd_plain(h, gates, c, lengths, dout, w_hh_t)
    return _bwd_persistent(lstm_revmasked_bwd, h, gates, c, dout, w_hh_t, True, lengths, plan)


def streamin_route(dtype: torch.dtype, R: int, N: int, H: int,
                   sms: int) -> PersistentPlan | None:
    """K8's route, a fixed rule decided before launch from the dtype and the
    shape: the one-direction plan ``plan_persistent(R, N, H, sms, dirs=1)``
    for bfloat16 (K8p) and its float32 plan (elem = 4: K8p-f32, 3xTF32
    products), else None (the walk: no plan, e.g. float32 at H = 1020)."""
    if N <= 0 or dtype not in (torch.bfloat16, torch.float32):
        return None
    return plan_persistent(R, N, H, sms, dirs=1, elem=2 if dtype == torch.bfloat16 else 4)


def lstm_train_fwd_streamin(x: torch.Tensor, w_ih_t: torch.Tensor, bias: torch.Tensor,
                            w_hh_t: torch.Tensor, reverse: bool = False):
    """K8: ``lstm_train_fwd`` on the raw input, the input product inside the
    kernel; x (R, T, N), w_ih_t (N, 4H), bias (4H,), w_hh_t (H, 4H) ->
    (h, gates, c) in x's dtype, on the route ``streamin_route`` picks (K8p
    or the walk)."""
    if x.device.type == "cpu":
        return lstm_train_fwd_streamin_plain(x, w_ih_t, bias, w_hh_t, reverse)
    R, _, N = x.shape
    plan = streamin_route(x.dtype, R, N, w_hh_t.shape[0], _sm_count(_device_index(x.device)))
    if plan is None:
        return lstm_train_fwd_streamin_walk(x, w_ih_t, bias, w_hh_t, reverse)
    return lstm_train_fwd_streamin_persistent(x, w_ih_t, bias, w_hh_t, reverse, plan)


def _check_streamin(x, w_ih_t, bias, w_hh_t):
    R, T, N = x.shape
    H = w_hh_t.shape[0]
    _check("x", x, (R, T, N), x.dtype, x.device)
    _check("w_ih_t", w_ih_t, (N, 4 * H), x.dtype, x.device)
    _check("bias", bias, (4 * H,), x.dtype, x.device)
    _check("w_hh_t", w_hh_t, (H, 4 * H), x.dtype, x.device)
    return R, T, N, H


def lstm_train_fwd_streamin_walk(x: torch.Tensor, w_ih_t: torch.Tensor, bias: torch.Tensor,
                                 w_hh_t: torch.Tensor, reverse: bool = False):
    """K8's walk (csrc/lstm_kernels.cu ``fusedin_kernel<true>``), float32 or
    bfloat16; counted in ``lstm_train_fwd_streamin.launches`` and
    ``.routes["walk"]``."""
    if x.device.type == "cpu":
        return lstm_train_fwd_streamin_plain(x, w_ih_t, bias, w_hh_t, reverse)
    dtype, stream = _kernel_args(x, w_hh_t.shape[0])
    R, T, N, H = _check_streamin(x, w_ih_t, bias, w_hh_t)
    out, gates, c = _train_outputs(x, H)
    if R == 0 or T == 0:
        return out, gates, c
    from urgent2026_challenge_track1_tpu_torch.ops._build import load_library

    err = load_library().lstm_train_fwd_streamin(
        x.data_ptr(), w_ih_t.data_ptr(), bias.data_ptr(), w_hh_t.data_ptr(), out.data_ptr(),
        gates.data_ptr(), c.data_ptr(), R, T, N, H, int(bool(reverse)), dtype,
        rows_per_block(R, 1, x.device, H), stream,
    )
    _raise_on(err, "lstm_train_fwd_streamin")
    _count(lstm_train_fwd_streamin, "walk")
    return out, gates, c


def lstm_train_fwd_streamin_persistent(x: torch.Tensor, w_ih_t: torch.Tensor,
                                       bias: torch.Tensor, w_hh_t: torch.Tensor,
                                       reverse: bool = False,
                                       plan: PersistentPlan | None = None):
    """K8p (csrc/lstm_persistent.cu ``fusedin_persistent_kernel<T, true>``),
    bfloat16, or K8p-f32, float32 (3xTF32 products): packs [W_ih; W_hh] and
    the bias for ``plan`` (``streamin_route``'s by default) and launches one
    cooperative grid of G x S CTAs that walks one direction and stores the
    residuals -> (h, gates, c); a grid the card cannot hold resident
    raises.  Counted in ``lstm_train_fwd_streamin.launches`` and
    ``.routes["persistent"]``."""
    if x.device.type == "cpu":
        return lstm_train_fwd_streamin_plain(x, w_ih_t, bias, w_hh_t, reverse)
    if x.device.type != "cuda":
        raise ValueError(f"kernel input on unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"K8p takes bfloat16 or float32 inputs, not {x.dtype}")
    elem = x.element_size()
    R, T, N, H = _check_streamin(x, w_ih_t, bias, w_hh_t)
    plan = plan or streamin_route(x.dtype, R, N, H, _sm_count(_device_index(x.device)))
    if plan is None:
        raise ValueError(f"no K8p plan for R={R}, N={N}, H={H}, {x.dtype}")
    if (plan.R, plan.N, plan.H, plan.dirs, plan.elem) != (R, N, H, 1, elem):
        raise ValueError(f"plan for {(plan.R, plan.N, plan.H, plan.dirs, plan.elem)}, "
                         f"inputs {(R, N, H, 1, elem)}")
    out, gates, c_res = _train_outputs(x, H)
    if T == 0:
        return out, gates, c_res
    w, b = pack_persistent_weights(w_ih_t[None], w_hh_t[None], bias[None], plan)
    c = None if plan.c_in_smem else torch.empty((R, H), dtype=torch.float32, device=x.device)
    counters = torch.zeros((plan.G,), dtype=torch.int32, device=x.device)
    from urgent2026_challenge_track1_tpu_torch.ops._build import load_library

    err = load_library().lstm_streamin_persistent(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), gates.data_ptr(),
        c_res.data_ptr(), _ptr(c), counters.data_ptr(), R, T, N, H, int(bool(reverse)),
        plan.S, plan.G, plan.U, plan.rows, plan.chunk, int(plan.c_in_smem), elem,
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
    )
    _raise_on(err, "lstm_train_fwd_streamin_persistent")
    _count(lstm_train_fwd_streamin, "persistent")
    return out, gates, c_res


def lstm_train_fwd2(xp_f: torch.Tensor, xp_b: torch.Tensor, w_hh_f_t: torch.Tensor,
                    w_hh_b_t: torch.Tensor):
    """K9: ``lstm_train_fwd`` forward on xp_f, then reverse on xp_b ->
    (h_f, gates_f, c_f, h_b, gates_b, c_b): K4's route once a direction on
    ``scan_route``'s plan (K4p, K4p-f32, or the walk where no plan fits),
    bit for bit ``lstm_train_fwd``'s.  Each launch is counted in
    ``lstm_train_fwd2.launches`` and its route, two a call, not in
    ``lstm_train_fwd``'s."""
    if xp_f.device.type == "cpu":
        return lstm_train_fwd2_plain(xp_f, xp_b, w_hh_f_t, w_hh_b_t)
    R, T, G = xp_f.shape
    H = G // 4
    for name, t, shape in (("xp_f", xp_f, (R, T, G)), ("xp_b", xp_b, (R, T, G)),
                           ("w_hh_f_t", w_hh_f_t, (H, G)), ("w_hh_b_t", w_hh_b_t, (H, G))):
        _check(name, t, shape, xp_f.dtype, xp_f.device)
    plan = scan_route(xp_f.dtype, R, H, _sm_count(_device_index(xp_f.device)))
    out = []
    for xp, w_hh_t, reverse in ((xp_f, w_hh_f_t, False), (xp_b, w_hh_b_t, True)):
        if plan is None:
            out += lstm_train_fwd_walk(xp, w_hh_t, reverse, fn=lstm_train_fwd2)
        else:
            out += _scan_persistent(lstm_train_fwd2, xp, w_hh_t, reverse, None, plan, True)
    return tuple(out)


def backward2_route(dtype: torch.dtype, R: int, H: int, sms: int) -> BackwardPlan | None:
    """K10's route, a fixed rule decided before launch from the dtype and
    the shape: the two-direction plan ``plan_backward(R, H, sms, dirs=2)``
    (K10p) in bfloat16 (elem = 2) or float32 (elem = 4); where none fits,
    ``backward_route``'s one-direction plan (one K5p launch a direction:
    float32 at the flow band and at H = 1020); anything else, or no plan,
    is None (the walk)."""
    if dtype not in (torch.bfloat16, torch.float32):
        return None
    elem = 2 if dtype == torch.bfloat16 else 4
    return plan_backward(R, H, sms, elem=elem, dirs=2) or backward_route(dtype, R, H, sms)


def lstm_train_bwd2(res_f, res_b, dout_f: torch.Tensor, dout_b: torch.Tensor,
                    w_hh_f_t: torch.Tensor, w_hh_b_t: torch.Tensor):
    """K10: ``lstm_train_bwd`` for both directions; res_* = (h, gates, c)
    of the forward (K9's or K4's) and reverse direction -> (dx_proj_f,
    dW_hh_f^T, dx_proj_b, dW_hh_b^T), on the route ``backward2_route``
    picks (K10p in one grid or a K5p launch a direction, or the walk)."""
    if res_f[1].device.type == "cpu":
        return lstm_train_bwd2_plain(res_f, res_b, dout_f, dout_b, w_hh_f_t, w_hh_b_t)
    R, _, G = res_f[1].shape
    plan = backward2_route(res_f[1].dtype, R, G // 4, _sm_count(_device_index(res_f[1].device)))
    if plan is None:
        return lstm_train_bwd2_walk(res_f, res_b, dout_f, dout_b, w_hh_f_t, w_hh_b_t)
    return lstm_train_bwd2_persistent(res_f, res_b, dout_f, dout_b, w_hh_f_t, w_hh_b_t, plan)


def lstm_train_bwd2_walk(res_f, res_b, dout_f: torch.Tensor, dout_b: torch.Tensor,
                         w_hh_f_t: torch.Tensor, w_hh_b_t: torch.Tensor):
    """K10's walk (csrc/lstm_kernels.cu ``backward_kernel`` with the
    direction on grid.y, then ``dw_kernel``), float32 or bfloat16, bitwise
    the K5 walk's per direction (``lstm_train_bwd_walk``; the same device
    code); counted in ``lstm_train_bwd2.launches`` and ``.routes["walk"]``."""
    if res_f[1].device.type == "cpu":
        return lstm_train_bwd2_plain(res_f, res_b, dout_f, dout_b, w_hh_f_t, w_hh_b_t)
    R, T, H, dtype, stream, w4h_f, dxp_f, dw_f = _check_residuals(*res_f, dout_f, w_hh_f_t)
    _, _, _, _, _, w4h_b, dxp_b, dw_b = _check_residuals(*res_b, dout_b, w_hh_b_t)
    if res_b[1].dtype != res_f[1].dtype or res_b[1].shape != res_f[1].shape:
        raise ValueError("the two directions' residuals differ in dtype or shape")
    if R == 0 or T == 0:
        return dxp_f, dw_f.to(w_hh_f_t.dtype), dxp_b, dw_b.to(w_hh_b_t.dtype)
    from urgent2026_challenge_track1_tpu_torch.ops._build import load_library

    (h_f, g_f, c_f), (h_b, g_b, c_b) = res_f, res_b
    err = load_library().lstm_train_bwd2(
        g_f.data_ptr(), c_f.data_ptr(), h_f.data_ptr(), dout_f.data_ptr(), w4h_f.data_ptr(),
        dxp_f.data_ptr(), dw_f.data_ptr(),
        g_b.data_ptr(), c_b.data_ptr(), h_b.data_ptr(), dout_b.data_ptr(), w4h_b.data_ptr(),
        dxp_b.data_ptr(), dw_b.data_ptr(),
        R, T, H, dtype, rows_per_block(R, 2, g_f.device, H), stream,
    )
    _raise_on(err, "lstm_train_bwd2")
    _count(lstm_train_bwd2, "walk")
    return dxp_f, dw_f.to(w_hh_f_t.dtype), dxp_b, dw_b.to(w_hh_b_t.dtype)


def lstm_train_bwd2_persistent(res_f, res_b, dout_f: torch.Tensor, dout_b: torch.Tensor,
                               w_hh_f_t: torch.Tensor, w_hh_b_t: torch.Tensor,
                               plan: BackwardPlan | None = None):
    """K10p (csrc/lstm_persistent_bwd.cu ``bwd2_persistent_kernel<T>``): K5p
    for both directions (the forward scan's backward on ``res_f``, the
    reverse scan's on ``res_b``) in one cooperative grid of 2 x G x S CTAs
    over a two-direction ``plan`` (``backward2_route``'s by default), then
    ``lstm_bwd_dw`` once per direction; on a one-direction plan (dirs = 1)
    one K5p launch and its dW kernel a direction instead
    (``lstm_train_bwd_persistent``'s launches); bfloat16 or float32 (3xTF32
    products); a grid the card cannot hold resident raises.  Either way it
    equals ``lstm_train_bwd_persistent`` per direction with the same plan,
    bit for bit.  Returns (dx_proj_f, dW_hh_f^T, dx_proj_b, dW_hh_b^T), dW
    in the weights' dtype.  Counted in ``lstm_train_bwd2.launches`` and
    ``.routes["persistent"]`` (one grid) or ``.routes["persistent_split"]``
    (each launch of the pair)."""
    if res_f[1].device.type == "cpu":
        return lstm_train_bwd2_plain(res_f, res_b, dout_f, dout_b, w_hh_f_t, w_hh_b_t)
    name = "lstm_train_bwd2_persistent"
    R, T, H, elem = _check_bwd_persistent(name, *res_f, dout_f, w_hh_f_t)
    _check_bwd_persistent(name, *res_b, dout_b, w_hh_b_t)
    if res_b[1].dtype != res_f[1].dtype or res_b[1].shape != res_f[1].shape:
        raise ValueError("the two directions' residuals differ in dtype or shape")
    device = res_f[1].device
    plan = plan or backward2_route(res_f[1].dtype, R, H, _sm_count(_device_index(device)))
    if plan is None:
        raise ValueError(f"no K10p plan for R={R}, H={H}, {res_f[1].dtype}")
    if (plan.R, plan.H, plan.elem) != (R, H, elem) or plan.dirs not in (1, 2):
        raise ValueError(f"plan for {(plan.R, plan.H, plan.elem, plan.dirs)}, "
                         f"inputs {(R, H, elem)}")
    if plan.dirs == 1:
        return (*_bwd_persistent(lstm_train_bwd2, *res_f, dout_f, w_hh_f_t, False, None, plan,
                                 "persistent_split"),
                *_bwd_persistent(lstm_train_bwd2, *res_b, dout_b, w_hh_b_t, True, None, plan,
                                 "persistent_split"))
    dxp = [torch.empty((R, T, 4 * H), dtype=res_f[1].dtype, device=device) for _ in range(2)]
    if T == 0:
        return (dxp[0], torch.zeros((H, 4 * H), dtype=w_hh_f_t.dtype, device=device),
                dxp[1], torch.zeros((H, 4 * H), dtype=w_hh_b_t.dtype, device=device))
    w = [pack_backward_weights(w_hh_f_t, plan), pack_backward_weights(w_hh_b_t, plan)]
    dc = (None, None) if plan.dc_in_smem else torch.empty((2, R, H), dtype=torch.float32,
                                                          device=device)
    counters = torch.zeros((2, plan.G), dtype=torch.int32, device=device)
    from urgent2026_challenge_track1_tpu_torch.ops._build import load_library

    args = []
    for d, (h, g, c), dout in ((0, res_f, dout_f), (1, res_b, dout_b)):
        args += [g.data_ptr(), c.data_ptr(), dout.data_ptr(), w[d].data_ptr(),
                 dxp[d].data_ptr(), _ptr(dc[d]), counters[d].data_ptr()]
    err = load_library().lstm_bwd2_persistent(
        *args, R, T, H, plan.S, plan.G, plan.U, plan.rows, plan.chunk, plan.kt,
        int(plan.dc_in_smem), elem, ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream),
    )
    _raise_on(err, name)
    dw_f = lstm_bwd_dw(res_f[0], dxp[0], False, None, plan.dw_split)
    dw_b = lstm_bwd_dw(res_b[0], dxp[1], True, None, plan.dw_split)
    _count(lstm_train_bwd2, "persistent")
    return dxp[0], dw_f.to(w_hh_f_t.dtype), dxp[1], dw_b.to(w_hh_b_t.dtype)


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
    @tracing.spanned(tracing.LSTM_OP)
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
    @tracing.spanned(tracing.LSTM_OP)
    def backward(ctx, dout):
        out, gates, c, w_hh_t, lengths = ctx.saved_tensors
        dxp, dw = lstm_revmasked_bwd(out, gates, c, lengths,
                                     dout.to(out.dtype).contiguous(), w_hh_t)
        return dxp, dw, None


def _input_grads(x: torch.Tensor, dxps, w_ih_ts):
    """VJP of the input projections x W_ih^T + b of one or two directions
    (pallas_lstm.py:340-346, plain GEMMs in x's dtype): dx = sum_d dxp_d
    W_ih_d and, per direction, (dW_ih_d^T = x^T dxp_d, db_d = sum dxp_d)."""
    x2 = x.reshape(-1, x.shape[-1])
    dx, grads = None, []
    for dxp, w_ih_t in zip(dxps, w_ih_ts):
        d2 = dxp.reshape(-1, dxp.shape[-1])
        term = d2 @ w_ih_t.t()
        dx = term if dx is None else dx + term
        grads.append((x2.t() @ d2, d2.sum(0)))
    return dx.reshape(x.shape), grads


class LSTMDirStreamIn(torch.autograd.Function):
    """One forward direction on the raw input, x (R, T, N), w_ih_t (N, 4H),
    bias (4H,), w_hh_t (H, 4H) -> (R, T, H); forward K8, backward K5 and the
    input-projection GEMMs (``lstm_dir_pallas_streamin``'s VJP)."""

    @staticmethod
    def forward(ctx, x, w_ih_t, bias, w_hh_t):
        out, gates, c = lstm_train_fwd_streamin(x, w_ih_t, bias, w_hh_t)
        ctx.save_for_backward(x, out, gates, c, w_ih_t, w_hh_t)
        return out

    @staticmethod
    @tracing.spanned(tracing.LSTM_OP)
    def backward(ctx, dout):
        x, out, gates, c, w_ih_t, w_hh_t = ctx.saved_tensors
        dxp, dw_hh = lstm_train_bwd(out, gates, c, dout.to(out.dtype).contiguous(), w_hh_t)
        dx, ((dw_ih, db),) = _input_grads(x, (dxp,), (w_ih_t,))
        return dx, dw_ih, db, dw_hh


class BiLSTMTrain(torch.autograd.Function):
    """Bidirectional layer on the raw input under autograd (the VJP of
    ``lstm_pallas_bidir_fusedin``: ``_fusedin_fwd`` / ``_fusedin_bwd``).
    x (R, T, N), w_ih_*_t (N, 4H), w_hh_*_t (H, 4H), b_* (4H,), all in x's
    dtype -> (R, T, 2H), forward || backward.

    Forward: K8 per direction under ``STREAM_INPUT_TRAIN``, else the hoisted
    projections and K9 under ``FUSED_BIDIR_TRAIN``, else K4 per direction.
    Backward: K10 under ``FUSED_BIDIR_TRAIN and not STREAM_INPUT_TRAIN``,
    else K5 per direction; then the input-projection GEMMs."""

    @staticmethod
    def forward(ctx, x, w_ih_f_t, w_ih_b_t, w_hh_f_t, w_hh_b_t, b_f, b_b):
        if STREAM_INPUT_TRAIN:
            res_f = lstm_train_fwd_streamin(x, w_ih_f_t, b_f, w_hh_f_t, False)
            res_b = lstm_train_fwd_streamin(x, w_ih_b_t, b_b, w_hh_b_t, True)
        else:
            x2 = x.reshape(-1, x.shape[-1])
            xp_f = torch.addmm(b_f, x2, w_ih_f_t).reshape(x.shape[:-1] + (-1,))
            xp_b = torch.addmm(b_b, x2, w_ih_b_t).reshape(x.shape[:-1] + (-1,))
            if FUSED_BIDIR_TRAIN:
                both = lstm_train_fwd2(xp_f, xp_b, w_hh_f_t, w_hh_b_t)
                res_f, res_b = both[:3], both[3:]
            else:
                res_f = lstm_train_fwd(xp_f, w_hh_f_t, False)
                res_b = lstm_train_fwd(xp_b, w_hh_b_t, True)
        ctx.save_for_backward(x, *res_f, *res_b, w_ih_f_t, w_ih_b_t, w_hh_f_t, w_hh_b_t)
        return torch.cat([res_f[0], res_b[0]], dim=-1)

    @staticmethod
    @tracing.spanned(tracing.LSTM_OP)
    def backward(ctx, dout):
        x, h_f, g_f, c_f, h_b, g_b, c_b, w_ih_f_t, w_ih_b_t, w_hh_f_t, w_hh_b_t = \
            ctx.saved_tensors
        H = h_f.shape[-1]
        dout = dout.to(h_f.dtype)
        do_f, do_b = dout[..., :H].contiguous(), dout[..., H:].contiguous()
        if FUSED_BIDIR_TRAIN and not STREAM_INPUT_TRAIN:
            dxp_f, dw_hh_f, dxp_b, dw_hh_b = lstm_train_bwd2(
                (h_f, g_f, c_f), (h_b, g_b, c_b), do_f, do_b, w_hh_f_t, w_hh_b_t)
        else:
            dxp_f, dw_hh_f = lstm_train_bwd(h_f, g_f, c_f, do_f, w_hh_f_t, False)
            dxp_b, dw_hh_b = lstm_train_bwd(h_b, g_b, c_b, do_b, w_hh_b_t, True)
        dx, ((dw_ih_f, db_f), (dw_ih_b, db_b)) = _input_grads(
            x, (dxp_f, dxp_b), (w_ih_f_t, w_ih_b_t))
        return dx, dw_ih_f, dw_ih_b, dw_hh_f, dw_hh_b, db_f, db_b


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


def lstm_dir_streamin(x: torch.Tensor, w_ih_t: torch.Tensor, bias: torch.Tensor,
                      w_hh_t: torch.Tensor) -> torch.Tensor:
    """One forward direction on the raw input, K8 with or without autograd
    (``LSTMDirStreamIn`` when autograd records), as the JAX primal
    ``lstm_dir_pallas_streamin`` runs the residual-storing kernel too."""
    if needs_grad(x, w_ih_t, bias, w_hh_t):
        return LSTMDirStreamIn.apply(x, w_ih_t, bias, w_hh_t)
    return lstm_train_fwd_streamin(x, w_ih_t, bias, w_hh_t)[0]


KERNELS = (fusedin_bilstm, lstm_scan, lstm_revmasked, lstm_train_fwd, lstm_train_bwd,
           lstm_revmasked_train_fwd, lstm_revmasked_bwd, lstm_train_fwd_streamin,
           lstm_train_fwd2, lstm_train_bwd2)


# K1-K10: a persistent route and a walk
ROUTED = (fusedin_bilstm, lstm_scan, lstm_revmasked, lstm_train_fwd, lstm_revmasked_train_fwd,
          lstm_train_bwd, lstm_revmasked_bwd, lstm_train_fwd_streamin, lstm_train_fwd2,
          lstm_train_bwd2)


def reset_launch_counts() -> None:
    """Zero the launch and route counts, and the count of the dW kernel of
    K5p, K7p and K10p (``lstm_bwd_dw.launches``, one launch inside each
    K5p or K7p launch and two inside each K10 call on a persistent route;
    not in ``KERNELS``)."""
    for fn in KERNELS + (lstm_bwd_dw,):
        fn.launches = 0
    for fn in ROUTED:
        fn.routes = {"persistent": 0, "walk": 0}
    for fn in (fusedin_bilstm, lstm_train_bwd2):  # their one-direction pairs
        fn.routes["persistent_split"] = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNELS}


def route_counts(kernel: str = "fusedin_bilstm") -> dict[str, int]:
    """The launches per route of ``kernel`` (K1 ``fusedin_bilstm``, K2
    ``lstm_scan``, K3 ``lstm_revmasked``, K4 ``lstm_train_fwd``, K5
    ``lstm_train_bwd``, K6 ``lstm_revmasked_train_fwd``, K7
    ``lstm_revmasked_bwd``, K8 ``lstm_train_fwd_streamin``, K9
    ``lstm_train_fwd2`` or K10 ``lstm_train_bwd2``) since the last reset:
    "persistent" (one grid; K9's K4p launches, two a call), "walk" (K9's
    K4 walks, two a call), and for K1 and K10 also "persistent_split" (each
    launch of K1p-f32's or K10's one-direction pair, two a call)."""
    return dict(next(fn for fn in ROUTED if fn.__name__ == kernel).routes)


reset_launch_counts()
