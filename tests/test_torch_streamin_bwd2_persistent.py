"""K8p, K9p and K10p, the persistent routes of K8 (the input-streaming
training forward, bfloat16, and K8p-f32 in float32), K9 (both directions'
training forward: two K4p launches on K4p's plan) and K10 (both
directions' training backward in one launch, bfloat16 and float32, or a
K5p launch a direction where no two-direction plan fits), on the CPU: the
two-direction backward planner, the route rules, the plain sliced walks
that read only the packed slices (K8p: K1p's walk for one direction with
the residual stores; K9p: K4p's per direction; K10p: K5p's walk per
direction over the one two-direction plan, or over K5p's plan), the
planted K8 fault and the dispatch of CPU tensors.  The kernels themselves
(csrc/lstm_persistent.cu, lstm_persistent_bwd.cu) are held against the same plain versions on the
card (tests/test_torch_cuda_kernels.py and chip_smoke.py).

Tolerances: the sliced walks against the unsliced plain versions 1e-6 in
float32 (the same products summed in another order) and 5e-2 in bfloat16
(scripts/check_pallas_tpu.py:29-34); against the Pallas kernels in
interpret mode, float32: forward 2e-4 abs, gradients 1e-3 relative (max|d|
/ max|ref|), as tests/test_torch_lstm_streamin_fused.py holds K8-K10;
the models of K9p and of K10's one-direction pair 1e-5 (abs; relative for
the backward)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from urgent2026_challenge_track1_tpu.ops import pallas_lstm as jpl
from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K
from urgent2026_challenge_track1_tpu_torch.ops import persistent_checks as PC

torch.set_num_threads(1)
SMS = 132  # one H100
FWD_ATOL, GRAD_RTOL = 2e-4, 1e-3
# (R, H) where K10 runs under FUSED_BIDIR_TRAIN (the band paths of the disc
# and flow train steps, the bench width) and an odd H
BWD2_SHAPES = [(804, 392), (502, 768), (804, 384), (20, 197)]
# their two-direction plans on 132 SMs, (S, G, U, rows, chunk, kt,
# dc_in_smem, smem) per element size; None: no plan (the walk).  At the
# band paths dc lives in global memory, which leaves room for fewer K tiles
# (804 x 392 bf16: 4 tiles of 400, where dc in shared memory leaves 6 of 272)
BWD2_PLANS = {
    ((804, 392), 2): (9, 7, 44, 115, 16, 400, False, 218880),
    ((804, 392), 4): (20, 3, 20, 268, 16, 400, False, 230272),
    ((502, 768), 2): (32, 2, 24, 251, 32, 288, False, 228736),
    ((502, 768), 4): None,
    ((804, 384), 2): (8, 8, 48, 101, 16, 512, False, 224512),
    ((804, 384), 4): (16, 4, 24, 201, 16, 384, False, 228224),
    ((20, 197), 2): (50, 1, 4, 20, 32, 400, True, 76736),
    ((20, 197), 4): (50, 1, 4, 20, 32, 400, True, 143808),
}
# (R, N, H) where K8 runs under STREAM_INPUT_TRAIN (the disc and flow time
# and band paths, the bench width) and their one-direction plans, (S, G, U,
# rows, chunk, c_in_smem, smem)
STREAMIN_PLANS = {(136, 196, 392): (33, 3, 12, 46, 48, True, 119648),
                  (804, 196, 392): (10, 13, 40, 62, 16, False, 228480),
                  (96, 384, 768): (64, 2, 12, 48, 48, True, 216000),
                  (502, 384, 768): (64, 2, 12, 251, 48, True, 225744),
                  (136, 192, 384): (32, 3, 12, 46, 48, True, 114528)}
# and their float32 plans (K8p-f32: a slice of 4U floats a row, no pad)
STREAMIN_F32_PLANS = {(136, 196, 392): (33, 3, 12, 46, 48, True, 206688),
                      (804, 196, 392): (25, 5, 16, 161, 32, True, 226624),
                      (96, 384, 768): (96, 1, 8, 96, 16, True, 202368),
                      (502, 384, 768): (96, 1, 8, 502, 16, True, 215360),
                      (136, 192, 384): (32, 3, 12, 46, 48, True, 197472)}
# (R, T, N, H, sms): partitions with G > 1 and S > 1 for the sliced walks
SLICED_K8 = [(70, 6, 20, 24, 6), (130, 5, 33, 40, 12), (150, 4, 16, 17, 9)]
SLICED_K10 = [(70, 6, 40, 48), (130, 5, 17, 120), (150, 4, 24, 12)]


def _rel(got, ref):
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max() / (ref.abs().max() + 1e-12))


def _abs(got, ref):
    return float((got.float() - ref.float()).abs().max())


def _streamin_inputs(R, T, N, H, dtype, seed):
    rng = np.random.default_rng(seed)
    w = H ** -0.5
    return tuple(torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)
                                  ).to(dtype)
                 for shape, scale in (((R, T, N), 0.5), ((N, 4 * H), w), ((4 * H,), w),
                                      ((H, 4 * H), w)))


def _bwd2_inputs(R, T, H, dtype, seed):
    """Both directions' plain residuals, dout and W_hh^T (f32 made, then
    cast)."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=0.5):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(dtype)

    xf, xb = t(R, T, 4 * H), t(R, T, 4 * H)
    wf, wb = t(H, 4 * H, scale=H ** -0.5), t(H, 4 * H, scale=H ** -0.5)
    df, db = t(R, T, H, scale=1.0), t(R, T, H, scale=1.0)
    res = K.lstm_train_fwd2_plain(xf, xb, wf, wb)
    return res[:3], res[3:], df, db, wf, wb


def _spans(n, size, count):
    return [(i * size, min((i + 1) * size, n)) for i in range(count)]


def _covers_once(n, size, count):
    covered = np.zeros(n, int)
    for lo, hi in _spans(n, size, count):
        assert lo < hi  # no slice or group is empty
        covered[lo:hi] += 1
    return bool((covered == 1).all())


# --- the two-direction backward planner -----------------------------------


@pytest.mark.parametrize("elem", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", BWD2_SHAPES, ids=str)
def test_bwd2_plan_covers_every_row_and_unit_once(shape, elem):
    """A dirs = 2 plan covers the rows and the units exactly once, holds the
    route's limits, fits the shared memory it reckons with the kernel's
    formula and keeps its two grids within the SMs (dirs G S <= sms);
    pinned, so that a change of the planner shows."""
    R, H = shape
    plan = K.plan_backward(R, H, SMS, elem=elem, dirs=2)
    want = BWD2_PLANS[shape, elem]
    if want is None:
        assert plan is None
        return
    assert (plan.R, plan.H, plan.elem, plan.dirs) == (R, H, elem, 2)
    assert plan.ctas == 2 * plan.G * plan.S <= SMS
    assert _covers_once(H, plan.U, plan.S) and _covers_once(R, plan.rows, plan.G)
    assert plan.U % 4 == 0 and plan.chunk % 16 == 0 and plan.chunk <= K.MAX_CHUNK
    blocks, cells = ((K.MAX_ACC_BLOCKS, K.MAX_CELLS) if elem == 2
                     else (K.MAX_ACC_BLOCKS_TF32, K.MAX_CELLS_F32))
    assert plan.chunk // 16 * plan.up // 8 <= blocks and plan.chunk * plan.U <= cells
    assert plan.smem == K.backward_smem(H, plan.U, plan.chunk, plan.kt, plan.rows,
                                        plan.dc_in_smem, elem) <= K.SMEM_LIMIT
    assert plan.dw_split == K.dw_split(H, SMS, elem)
    assert (plan.S, plan.G, plan.U, plan.rows, plan.chunk, plan.kt, plan.dc_in_smem,
            plan.smem) == want


@pytest.mark.parametrize("sms", [2, 7, 24, 66, 132])
@pytest.mark.parametrize("elem", [2, 4], ids=["bf16", "f32"])
def test_bwd2_plan_stays_within_the_sms(sms, elem):
    """On any SM count the two grids fit together, or there is no plan;
    dirs = 1 keeps K5p's plan (its fields unchanged)."""
    for R, H in ((70, 40), (300, 136), (804, 392)):
        plan = K.plan_backward(R, H, sms, elem=elem, dirs=2)
        assert plan is None or (plan.ctas <= sms and _covers_once(H, plan.U, plan.S)
                                and _covers_once(R, plan.rows, plan.G))
        one = K.plan_backward(R, H, sms, elem=elem)
        assert one is None or (one.dirs == 1 and one.ctas == one.G * one.S <= sms)


def test_bwd2_plan_trades_dc_in_shared_memory_for_fewer_k_tiles():
    """With two directions dc leaves shared memory exactly where that gives
    fewer K tiles; the one-direction plans keep dc there."""
    for R, H in BWD2_SHAPES:
        for elem in (2, 4):
            plan = K.plan_backward(R, H, SMS, elem=elem, dirs=2)
            if plan is None:
                continue
            in_smem = K._backward_tile(H, plan.U, plan.chunk, plan.rows, True, K.SMEM_LIMIT,
                                       elem)
            fits = K.backward_smem(H, plan.U, plan.chunk, 16, plan.rows, True,
                                   elem) <= K.SMEM_LIMIT
            if plan.dc_in_smem:
                assert plan.kt == in_smem
            elif fits and in_smem is not None:
                assert -(-plan.kp // plan.kt) < -(-plan.kp // in_smem)
    assert K.plan_backward(804, 392, SMS).dc_in_smem  # K5p's plan is unchanged


def test_bwd2_planner_takes_no_empty_grid():
    assert K.plan_backward(10, 64, SMS, dirs=0) is None
    assert K.plan_backward(10, 64, 1, dirs=2) is None  # two directions need two SMs


# --- the route rules -----------------------------------------------------


def test_route_rules():
    """K8: bfloat16 takes its one-direction plan (K8p), float32 its
    one-direction float32 plan (K8p-f32), other dtypes and shapes without a
    plan the walk (float32 at H = 1020); K10: bfloat16 and float32 take
    their two-direction plans (K10p), else their one-direction plans (a K5p
    launch a direction: float32 at the flow band), other dtypes and shapes
    without a plan the walk."""
    for (R, N, H), want in STREAMIN_PLANS.items():
        plan = K.streamin_route(torch.bfloat16, R, N, H, SMS)
        assert plan == K.plan_persistent(R, N, H, SMS, dirs=1) and plan.dirs == 1
        assert (plan.S, plan.G, plan.U, plan.rows, plan.chunk, plan.c_in_smem,
                plan.smem) == want
        assert plan.ctas <= SMS
        f32 = K.streamin_route(torch.float32, R, N, H, SMS)
        assert f32 == K.plan_persistent(R, N, H, SMS, dirs=1, elem=4)
        assert (f32.dirs, f32.elem) == (1, 4) and f32.ctas <= SMS
        assert (f32.S, f32.G, f32.U, f32.rows, f32.chunk, f32.c_in_smem,
                f32.smem) == STREAMIN_F32_PLANS[R, N, H]
        assert f32.chunk // 16 * -(-f32.U // 8) <= K.MAX_ACC_BLOCKS_TF32
        assert f32.chunk * f32.U <= K.MAX_CELLS_F32 and f32.smem <= K.SMEM_LIMIT
        assert K.streamin_route(torch.float16, R, N, H, SMS) is None
    assert K.streamin_route(torch.bfloat16, 10, 8000, 64, SMS) is None
    assert K.streamin_route(torch.bfloat16, 10, 0, 64, SMS) is None
    assert K.streamin_route(torch.float32, 4, 510, 1020, SMS) is None  # no f32 slice fits
    for R, H in BWD2_SHAPES:
        for dtype, elem in ((torch.bfloat16, 2), (torch.float32, 4)):
            two = K.plan_backward(R, H, SMS, elem=elem, dirs=2)
            assert K.backward2_route(dtype, R, H, SMS) == (
                two or K.backward_route(dtype, R, H, SMS))
        assert K.backward2_route(torch.float16, R, H, SMS) is None
    split = K.backward2_route(torch.float32, 502, 768, SMS)  # the flow band in f32
    assert split.dirs == 1 and split == K.backward_route(torch.float32, 502, 768, SMS)
    assert K.backward2_route(torch.bfloat16, 10, 8000, SMS) is None


def test_k1p_plans_keep_two_directions():
    """K8p's plans are dirs = 1; K1p's stay dirs = 2 with their own
    partition (the K1 shapes' plans are pinned in test_torch_scan_persistent)."""
    for R, N, H in STREAMIN_PLANS:
        k1p, k8p = K.plan_persistent(R, N, H, SMS), K.plan_persistent(R, N, H, SMS, dirs=1)
        assert k1p.dirs == 2 and k8p.dirs == 1 and k1p.ctas <= SMS and k8p.ctas <= SMS


def test_one_direction_pack_is_a_slice_of_the_stacked_pack():
    """``pack_persistent_weights`` of one direction (a leading axis of 1)
    equals that direction's block of the two-direction pack."""
    R, N, H = 21, 20, 24
    plan = K.plan_persistent(R, N, H, 6, dirs=1)
    rng = np.random.default_rng(3)
    wi, wh, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((2, N, 4 * H), (2, H, 4 * H), (2, 4 * H)))
    w2, b2 = K.pack_persistent_weights(wi, wh, b, plan)
    for d in range(2):
        w1, b1 = K.pack_persistent_weights(wi[d:d + 1], wh[d:d + 1], b[d:d + 1], plan)
        assert w1.shape == (1, plan.S, plan.kx + plan.kh, 4 * plan.U)
        assert torch.equal(w1[0], w2[d]) and torch.equal(b1[0], b2[d])


# --- K8p's sliced walk -----------------------------------------------------


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6), (torch.bfloat16, 5e-2)],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("R,T,N,H,sms", SLICED_K8, ids=str)
def test_sliced_streamin_matches_plain(R, T, N, H, sms, dtype, tol):
    """K8p's sliced walk (groups and slices of a one-direction plan) against
    K8's plain version in h, gates and c at every step, both directions."""
    plan = K.plan_persistent(R, N, H, sms, dirs=1)
    assert plan.S > 1 and plan.G > 1
    x, wi, b, wh = _streamin_inputs(R, T, N, H, dtype, R + T)
    packed = K.pack_persistent_weights(wi[None], wh[None], b[None], plan)
    for reverse in (False, True):
        got = K.lstm_train_fwd_streamin_sliced_plain(x, packed, plan, reverse)
        ref = K.lstm_train_fwd_streamin_plain(x, wi, b, wh, reverse)
        for g, r in zip(got, ref):
            assert g.shape == r.shape and g.dtype == dtype
            assert _abs(g, r) < tol


# (R, T, N, H, sms): float32 one-direction plans with G > 1 and S > 1, odd N
# and H (the 4-, 8- and 16-byte staging on the card)
SLICED_K8_F32 = [(70, 5, 37, 46, 20), (130, 4, 38, 20, 15), (90, 3, 40, 72, 36)]


@pytest.mark.parametrize("R,T,N,H,sms", SLICED_K8_F32, ids=str)
def test_sliced_f32_streamin_matches_plain(R, T, N, H, sms):
    """K8p-f32's sliced walk over a float32 plan (elem = 4) against K8's
    plain version in h, gates and c at every step, both directions, 1e-6."""
    plan = K.plan_persistent(R, N, H, sms, dirs=1, elem=4)
    assert plan.S > 1 and plan.G > 1 and plan.elem == 4
    x, wi, b, wh = _streamin_inputs(R, T, N, H, torch.float32, R + N)
    packed = K.pack_persistent_weights(wi[None], wh[None], b[None], plan)
    for reverse in (False, True):
        got = K.lstm_train_fwd_streamin_sliced_plain(x, packed, plan, reverse)
        ref = K.lstm_train_fwd_streamin_plain(x, wi, b, wh, reverse)
        for g, r in zip(got, ref):
            assert g.shape == r.shape and g.dtype == torch.float32
            assert _abs(g, r) < 1e-6


@pytest.mark.parametrize("reverse", [False, True])
def test_sliced_f32_streamin_matches_pallas(reverse):
    """K8p-f32's sliced walk at odd N and H against the Pallas
    ``_train_forward_streamin`` (interpret mode), float32, 1e-5: h, gates
    and c at every step."""
    R, T, N, H = 70, 5, 37, 46
    plan = K.plan_persistent(R, N, H, 20, dirs=1, elem=4)
    assert plan.S > 1 and plan.G > 1
    x, wi, b, wh = _streamin_inputs(R, T, N, H, torch.float32, 12)
    ref = jpl._train_forward_streamin(jnp.asarray(x.numpy()), jnp.asarray(wi.numpy()),
                                      jnp.asarray(b.numpy())[None], jnp.asarray(wh.numpy()),
                                      reverse, 0, True)
    packed = K.pack_persistent_weights(wi[None], wh[None], b[None], plan)
    got = K.lstm_train_fwd_streamin_sliced_plain(x, packed, plan, reverse)
    for g, r in zip(got, ref):  # time-major in the Pallas kernel
        np.testing.assert_allclose(g.numpy(), np.swapaxes(np.asarray(r), 0, 1), atol=1e-5, rtol=0)


@pytest.mark.parametrize("reverse", [False, True])
def test_f32_streamin_controls_exceed_the_limit(reverse):
    """K8p-f32's controls in float32: the stale-h fault and the walk with
    one TF32 product each (``lstm_train_fwd_streamin_tf32``) leave h, gates
    and c by at least F32_LIMIT of the plain version; the stale-h fault
    equals it at the walk's first step."""
    R, T, N, H = 21, 9, 37, 46
    x, wi, b, wh = _streamin_inputs(R, T, N, H, torch.float32, 13)
    ref = K.lstm_train_fwd_streamin_plain(x, wi, b, wh, reverse)
    stale = PC.lstm_train_fwd_streamin_stale_h(x, wi, b, wh, reverse)
    one = PC.lstm_train_fwd_streamin_tf32(x, wi, b, wh, reverse)
    first = T - 1 if reverse else 0
    for f, o, r in zip(stale, one, ref):
        assert f.dtype == o.dtype == torch.float32
        assert torch.equal(f[:, first], r[:, first])
        assert _abs(f, r) >= PC.F32_LIMIT and _abs(o, r) >= PC.F32_LIMIT


@pytest.mark.parametrize("reverse", [False, True])
def test_sliced_streamin_matches_pallas(reverse):
    """K8p's sliced walk against the Pallas ``_train_forward_streamin``
    (interpret mode), float32: h, gates and c at every step."""
    R, T, N, H = 70, 6, 20, 24
    plan = K.plan_persistent(R, N, H, 6, dirs=1)
    assert plan.S > 1 and plan.G > 1
    x, wi, b, wh = _streamin_inputs(R, T, N, H, torch.float32, 5)
    ref = jpl._train_forward_streamin(jnp.asarray(x.numpy()), jnp.asarray(wi.numpy()),
                                      jnp.asarray(b.numpy())[None], jnp.asarray(wh.numpy()),
                                      reverse, 0, True)
    packed = K.pack_persistent_weights(wi[None], wh[None], b[None], plan)
    got = K.lstm_train_fwd_streamin_sliced_plain(x, packed, plan, reverse)
    for g, r in zip(got, ref):  # time-major in the Pallas kernel
        np.testing.assert_allclose(g.numpy(), np.swapaxes(np.asarray(r), 0, 1),
                                   atol=FWD_ATOL, rtol=0)


def test_sliced_k1p_is_the_two_direction_walk():
    """K1p's sliced walk, now the two-direction case of the walk K8p shares,
    still equals K1's plain version."""
    R, T, N, H = 70, 5, 20, 24
    plan = K.plan_persistent(R, N, H, 12)
    assert plan.dirs == 2 and plan.S > 1 and plan.G > 1
    rng = np.random.default_rng(6)
    x = torch.from_numpy((0.5 * rng.standard_normal((R, T, N))).astype(np.float32))
    wi, wh, b = (torch.from_numpy((0.2 * rng.standard_normal(s)).astype(np.float32))
                 for s in ((2, N, 4 * H), (2, H, 4 * H), (2, 4 * H)))
    got = K.fusedin_bilstm_sliced_plain(x, K.pack_persistent_weights(wi, wh, b, plan), plan)
    assert _abs(got, K.fusedin_bilstm_plain(x, wi, wh, b)) < 1e-6


@pytest.mark.parametrize("reverse", [False, True])
def test_planted_streamin_fault_exceeds_the_limit_only_after_the_first_step(reverse):
    """K8p's barrier fault (``lstm_train_fwd_streamin_stale_h``, K8's plain
    walk fed h one step stale) returns the plain outputs at the walk's first
    step and leaves each output by at least ``ulp_limit`` (4 bf16 ulps at
    its peak) over the later steps."""
    R, T, N, H = 21, 9, 20, 24
    x, wi, b, wh = _streamin_inputs(R, T, N, H, torch.bfloat16, 7)
    ref = K.lstm_train_fwd_streamin_plain(x, wi, b, wh, reverse)
    stale = PC.lstm_train_fwd_streamin_stale_h(x, wi, b, wh, reverse)
    first = T - 1 if reverse else 0
    later = slice(0, T - 1) if reverse else slice(1, T)
    for f, r in zip(stale, ref):
        assert f.dtype == torch.bfloat16 and f.shape == r.shape
        assert torch.equal(f[:, first], r[:, first])
        assert _abs(f[:, later], r[:, later]) >= PC.ulp_limit(r)


# --- K10p's sliced walk ----------------------------------------------------


@pytest.mark.parametrize("elem", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("R,T,H,sms", SLICED_K10, ids=str)
def test_sliced_bwd2_matches_plain(R, T, H, sms, elem):
    """K10p's sliced walk (K5p's per direction over one dirs = 2 plan, each
    direction on its own packed slices) against K10's plain version in
    dx_proj at every step and dW; bfloat16 5e-2, float32 1e-6."""
    dtype, tol = (torch.bfloat16, 5e-2) if elem == 2 else (torch.float32, 1e-6)
    plan = K.plan_backward(R, H, sms, elem=elem, dirs=2)
    assert plan.dirs == 2 and plan.S > 1 and plan.G > 1 and plan.ctas <= sms
    res_f, res_b, df, db, wf, wb = _bwd2_inputs(R, T, H, dtype, R + T + elem)
    got = K.lstm_train_bwd2_sliced_plain(res_f, res_b, df, db, K.pack_backward_weights(wf, plan),
                                         K.pack_backward_weights(wb, plan), plan)
    ref = (*K._backward_plain(*res_f, df, wf.float(), False),
           *K._backward_plain(*res_b, db, wb.float(), True))
    for d in range(2):
        assert got[2 * d].dtype == dtype and got[2 * d + 1].dtype == torch.float32
        assert _abs(got[2 * d], ref[2 * d]) < tol and _rel(got[2 * d + 1], ref[2 * d + 1]) < tol


def test_sliced_bwd2_matches_pallas():
    """K10p's sliced walk on the Pallas forward's residuals against the
    Pallas ``_lstm_train_bwd2`` (interpret mode), float32, every step, dW
    included."""
    R, T, H = 70, 6, 40
    plan = K.plan_backward(R, H, 48, elem=4, dirs=2)
    assert plan.S > 1 and plan.G > 1
    rng = np.random.default_rng(8)
    xf, xb = (0.5 * rng.standard_normal((2, R, T, 4 * H))).astype(np.float32)
    wf, wb = (H ** -0.5 * rng.standard_normal((2, H, 4 * H))).astype(np.float32)
    df, db = rng.standard_normal((2, R, T, H)).astype(np.float32)
    fwd = jpl._train_forward2(*map(jnp.asarray, (xf, xb, wf, wb)), 0, True)
    ref = jpl._lstm_train_bwd2(tuple(fwd[:3]) + (jnp.asarray(wf),),
                               tuple(fwd[3:]) + (jnp.asarray(wb),), jnp.asarray(df),
                               jnp.asarray(db), 0, True)
    res = [torch.from_numpy(np.swapaxes(np.asarray(r), 0, 1).copy()) for r in fwd]
    tw = [torch.from_numpy(w) for w in (wf, wb)]
    got = K.lstm_train_bwd2_sliced_plain(res[:3], res[3:], torch.from_numpy(df),
                                         torch.from_numpy(db),
                                         *(K.pack_backward_weights(w, plan) for w in tw), plan)
    for g, r in zip(got, ref):  # dxp_f, dW_f, dxp_b, dW_b
        assert _rel(g, torch.from_numpy(np.array(r))) < GRAD_RTOL


def test_planted_stale_dg_sees_both_directions():
    """The stale-dgates fault that holds K10p, per direction, leaves each
    direction's plain dx_proj by at least ``ulp_limit`` of it (bfloat16)."""
    res_f, res_b, df, db, wf, wb = _bwd2_inputs(21, 9, 24, torch.bfloat16, 9)
    ref = K.lstm_train_bwd2_plain(res_f, res_b, df, db, wf, wb)
    for d, (res, dout, w, rev) in enumerate(((res_f, df, wf, False), (res_b, db, wb, True))):
        stale = PC.lstm_train_bwd_stale_dg(*res, dout, w, rev)[0]
        assert _abs(stale, ref[2 * d]) >= PC.ulp_limit(ref[2 * d])


# --- K9p and K10's one-direction pair -------------------------------------
# K9 takes K4p's own plan (``scan_route``'s) and launches K4p once a
# direction; K10 takes K5p's plan where no two-direction plan fits and
# launches K5p once a direction.  Both are bitwise those launches on the
# card (tests/test_torch_cuda_kernels.py); here their plans are pinned and
# their sliced walks held against the Pallas kernels they replace.

# (R, H, dtype) -> K4p's plan (S, G, U, chunk, CTAs) on 132 SMs: the disc
# band, the bench width and the flow band, where FUSED_BIDIR_TRAIN runs K9;
# None: no plan (the walk)
FWD2_PLANS = {
    (804, 392, "bf16"): (10, 13, 40, 32, 130), (804, 384, "bf16"): (10, 13, 40, 48, 130),
    (502, 768, "bf16"): (32, 4, 24, 16, 128), (804, 392, "f32"): (17, 7, 24, 16, 119),
    (804, 384, "f32"): (14, 9, 28, 16, 126), (502, 768, "f32"): (64, 2, 12, 16, 128),
    (804, 1020, "f32"): None,
}
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


@pytest.mark.parametrize("R,H,dt", list(FWD2_PLANS), ids=str)
def test_fwd2_route_is_k4p_plan(R, H, dt, monkeypatch):
    """K9's dispatch on device tensors (meta tensors here, the launches
    recorded instead of made): K4's route once a direction, forward then
    reverse, each counted as K9 -- K4p on ``scan_route``'s one-direction
    plan (pinned; elem 4 in float32), or K4's walk twice where that plan is
    None (float32 at H = 1020)."""
    calls = []
    monkeypatch.setattr(K, "_sm_count", lambda index: SMS)
    monkeypatch.setattr(K, "_device_index", lambda device: 0)
    monkeypatch.setattr(K, "_scan_persistent", lambda fn, x, w, rev, lengths, plan, store: (
        calls.append(("persistent", fn, x, w, rev, lengths, plan, store)) or (x,) * 3))
    monkeypatch.setattr(K, "lstm_train_fwd_walk", lambda x, w, rev, fn: (
        calls.append(("walk", fn, x, w, rev)) or (x,) * 3))
    xf, xb = (torch.empty((R, 3, 4 * H), dtype=DTYPES[dt], device="meta") for _ in range(2))
    wf, wb = (torch.empty((H, 4 * H), dtype=DTYPES[dt], device="meta") for _ in range(2))
    got = K.lstm_train_fwd2(xf, xb, wf, wb)
    assert len(got) == 6 and all(g is xf for g in got[:3]) and all(g is xb for g in got[3:])
    plan = K.scan_route(DTYPES[dt], R, H, SMS)
    if FWD2_PLANS[R, H, dt] is None:
        assert plan is None
        assert calls == [("walk", K.lstm_train_fwd2, xf, wf, False),
                         ("walk", K.lstm_train_fwd2, xb, wb, True)]
        return
    assert calls == [("persistent", K.lstm_train_fwd2, xf, wf, False, None, plan, True),
                     ("persistent", K.lstm_train_fwd2, xb, wb, True, None, plan, True)]
    assert (plan.dirs, plan.elem) == (1, 2 if dt == "bf16" else 4)
    assert (plan.S, plan.G, plan.U, plan.chunk, plan.ctas) == FWD2_PLANS[R, H, dt]


@pytest.mark.parametrize("elem", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", BWD2_SHAPES, ids=str)
def test_bwd2_route_splits_only_without_a_two_direction_plan(shape, elem):
    """K10's rule keeps K10p's pinned dirs = 2 plan wherever one fits; at the
    flow band in float32 (one direction's grid alone takes 96 CTAs) it
    takes K5p's one-direction plan, S 96, G 1, U 8, chunk 48."""
    R, H = shape
    plan = K.backward2_route(torch.bfloat16 if elem == 2 else torch.float32, R, H, SMS)
    want = BWD2_PLANS[shape, elem]
    if want is not None:
        assert plan.dirs == 2 and (plan.S, plan.G, plan.U, plan.rows, plan.chunk, plan.kt,
                                   plan.dc_in_smem, plan.smem) == want
        return
    assert plan == K.plan_backward(R, H, SMS, elem=elem) and plan.dirs == 1
    assert (plan.S, plan.G, plan.U, plan.chunk, plan.ctas) == (96, 1, 8, 48, 96)


def _fwd2_pallas_case(R, T, H, seed):
    rng = np.random.default_rng(seed)
    xf, xb = (0.5 * rng.standard_normal((2, R, T, 4 * H))).astype(np.float32)
    wf, wb = (H ** -0.5 * rng.standard_normal((2, H, 4 * H))).astype(np.float32)
    return xf, xb, wf, wb


@pytest.mark.parametrize("sms", [4, 6])
def test_sliced_fwd2_matches_pallas(sms):
    """K9p's model, K4p's sliced walk forward on xp_f and reverse on xp_b
    over one float32 plan with S > 1 and G > 1, against the Pallas
    ``_train_forward2`` (interpret mode): h, gates and c of both
    directions at every step within 1e-5."""
    R, T, H = 70, 5, 12
    plan = K.scan_route(torch.float32, R, H, sms)
    assert plan.S > 1 and plan.G > 1 and (plan.dirs, plan.elem) == (1, 4)
    xf, xb, wf, wb = _fwd2_pallas_case(R, T, H, sms)
    ref = jpl._train_forward2(*map(jnp.asarray, (xf, xb, wf, wb)), 0, True)
    got = []
    for x, w, reverse in ((xf, wf, False), (xb, wb, True)):
        wt = torch.from_numpy(w)
        got += K.lstm_train_fwd_sliced_plain(torch.from_numpy(x),
                                             K.pack_scan_weights(wt, plan), plan, reverse)
    for g, r in zip(got, ref):  # time-major in the Pallas kernel
        np.testing.assert_allclose(g.numpy(), np.swapaxes(np.asarray(r), 0, 1), atol=1e-5, rtol=0)


def test_split_bwd2_matches_pallas():
    """The model of K10's one-direction pair, K5p's sliced backward per
    direction on the plan ``backward2_route`` takes where no dirs = 2 plan
    fits (4 SMs, H = 128: one direction needs 3 slices), against the Pallas
    ``_lstm_train_bwd2`` (interpret mode) on its own forward's residuals:
    dx_proj and dW of both directions within 1e-5 of max|ref|."""
    R, T, H, sms = 6, 4, 128, 4
    assert K.plan_backward(R, H, sms, elem=4, dirs=2) is None
    plan = K.backward2_route(torch.float32, R, H, sms)
    assert plan.dirs == 1 and plan.S > 1 and plan == K.backward_route(torch.float32, R, H, sms)
    xf, xb, wf, wb = _fwd2_pallas_case(R, T, H, 14)
    df, db = np.random.default_rng(15).standard_normal((2, R, T, H)).astype(np.float32)
    fwd = jpl._train_forward2(*map(jnp.asarray, (xf, xb, wf, wb)), 0, True)
    ref = jpl._lstm_train_bwd2(tuple(fwd[:3]) + (jnp.asarray(wf),),
                               tuple(fwd[3:]) + (jnp.asarray(wb),), jnp.asarray(df),
                               jnp.asarray(db), 0, True)
    res = [torch.from_numpy(np.swapaxes(np.asarray(r), 0, 1).copy()) for r in fwd]
    got = []
    for r3, d, w, reverse in ((res[:3], df, wf, False), (res[3:], db, wb, True)):
        got += K.lstm_train_bwd_sliced_plain(*r3, torch.from_numpy(d),
                                             K.pack_backward_weights(torch.from_numpy(w), plan),
                                             plan, reverse)
    for g, r in zip(got, ref):  # dxp_f, dW_f, dxp_b, dW_b
        assert _rel(g, torch.from_numpy(np.array(r))) < 1e-5


# --- CPU dispatch ----------------------------------------------------------


def test_cpu_takes_the_plain_versions_without_counting():
    """Every K8 and K10 wrapper, routed, walk and persistent, and K9, takes
    the plain version for CPU tensors and counts no launch on any route."""
    x, wi, b, wh = _streamin_inputs(13, 5, 20, 24, torch.bfloat16, 10)
    args = _bwd2_inputs(13, 5, 24, torch.bfloat16, 11)
    K.reset_launch_counts()
    for reverse in (False, True):
        ref = K.lstm_train_fwd_streamin_plain(x, wi, b, wh, reverse)
        for fn in (K.lstm_train_fwd_streamin, K.lstm_train_fwd_streamin_walk,
                   K.lstm_train_fwd_streamin_persistent):
            assert all(torch.equal(g, r) for g, r in zip(fn(x, wi, b, wh, reverse), ref))
    fwd2 = (x[..., :1].expand(13, 5, 96).contiguous(), x[..., 1:2].expand(13, 5, 96).contiguous(),
            wh, wh.flip(0).contiguous())
    ref = K.lstm_train_fwd2_plain(*fwd2)
    assert all(torch.equal(g, r) for g, r in zip(K.lstm_train_fwd2(*fwd2), ref))
    ref = K.lstm_train_bwd2_plain(*args)
    for fn in (K.lstm_train_bwd2, K.lstm_train_bwd2_walk, K.lstm_train_bwd2_persistent):
        assert all(torch.equal(g, r) for g, r in zip(fn(*args), ref))
    assert set(K.launch_counts().values()) == {0} and K.lstm_bwd_dw.launches == 0
    for name in ("lstm_train_fwd_streamin", "lstm_train_fwd2"):
        assert K.route_counts(name) == {"persistent": 0, "walk": 0}
    assert K.route_counts("lstm_train_bwd2") == {"persistent": 0, "walk": 0,
                                                 "persistent_split": 0}


@pytest.mark.parametrize("name,group", [
    ("_ZN12_GLOBAL__N_125fusedin_persistent_kernelILb1EEEvNS_4ArgsE",
     "K8p lstm_train_fwd_streamin_persistent"),
    ("(anonymous namespace)::fusedin_persistent_kernel<true>((anonymous namespace)::Args)",
     "K8p lstm_train_fwd_streamin_persistent"),
    ("_ZN12_GLOBAL__N_125fusedin_persistent_kernelILb0EEEvNS_4ArgsE", "K1p fusedin_persistent"),
    ("(anonymous namespace)::fusedin_persistent_kernel<false>((anonymous namespace)::Args)",
     "K1p fusedin_persistent"),
    ("_ZN12_GLOBAL__N_122bwd2_persistent_kernelI13__nv_bfloat16EEvNS_7BwdArgsIT_EES4_",
     "K10p lstm_train_bwd2_persistent"),
    ("(anonymous namespace)::bwd2_persistent_kernel<float>((anonymous namespace)::"
     "BwdArgs<float>, (anonymous namespace)::BwdArgs<float>)",
     "K10p-f32 lstm_train_bwd2_persistent"),
    ("_ZN12_GLOBAL__N_114fusedin_kernelILb1EEEvNS_4ArgsIT_EE", "K8 lstm_train_fwd_streamin"),
    ("_ZN12_GLOBAL__N_125fusedin_persistent_kernelI13__nv_bfloat16Lb1EEEvNS_4ArgsIT_EE",
     "K8p lstm_train_fwd_streamin_persistent"),
    ("_ZN12_GLOBAL__N_125fusedin_persistent_kernelIfLb1EEEvNS_4ArgsIT_EE",
     "K8p-f32 lstm_train_fwd_streamin_persistent"),
    ("(anonymous namespace)::fusedin_persistent_kernel<float, true>((anonymous namespace)::"
     "Args<float>)", "K8p-f32 lstm_train_fwd_streamin_persistent"),
    ("_ZN12_GLOBAL__N_125fusedin_persistent_kernelI13__nv_bfloat16Lb0EEEvNS_4ArgsIT_EE",
     "K1p fusedin_persistent"),
    ("_ZN12_GLOBAL__N_125fusedin_persistent_kernelIfLb0EEEvNS_4ArgsIT_EE",
     "K1p-f32 fusedin_persistent"),
    ("(anonymous namespace)::fusedin_persistent_kernel<float, false>((anonymous namespace)::"
     "Args<float>)", "K1p-f32 fusedin_persistent"),
])
def test_profiler_groups_k8p_and_k10p(name, group):
    """profile_forward files K1p's and K8p's instances of
    fusedin_persistent_kernel<T, STORE> (bf16 and f32; the names of the
    instances before T was a parameter too) and K10p's bwd2_persistent_kernel<T>
    under their own kernels, from mangled and demangled names; K8's walk
    keeps its group."""
    from urgent2026_challenge_track1_tpu_torch.profile_forward import _group

    assert _group(name) == group
