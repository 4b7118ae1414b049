"""K1p, the persistent weight-stationary route of K1, and K1p-f32, its
float32 route (3xTF32 on the card; one grid, or a launch a direction where
no two-direction plan fits), on the CPU: the partition planner, its float32
plans, the packed weight layout, the plain sliced walk that reads only the
packed slices, and the route rule.  The kernel itself
(csrc/lstm_persistent.cu) is held against the same plain versions on the
card (tests/test_torch_cuda_kernels.py and chip_smoke.py).

Tolerances: the sliced walk against the unsliced plain version 1e-6 in
float32 (the same products summed in another order) and 5e-2 in bfloat16
(scripts/check_pallas_tpu.py:29-34; h rounded at other places); against the
Pallas kernel in interpret mode 1e-5 (test_torch_lstm.py's)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from urgent2026_challenge_track1_tpu.ops import pallas_lstm as jpl
from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K

torch.set_num_threads(1)
SMS = 132  # one H100
# (R, N, H) of the route table: disc band (one utterance, a B=4 CLI batch),
# the bench forward's band and time paths, the flow model's band (a B=2
# batch), enhance band and enhance time paths, a causal streaming step's band
# path (8 frames, B = 1)
ROUTE_SHAPES = [(401, 196, 392), (804, 196, 392), (25664, 192, 384), (2176, 192, 384),
                (502, 384, 768), (501, 384, 768), (48, 384, 768), (8, 196, 392)]
RAGGED = [(13, 40, 392), (100, 40, 8), (1, 196, 392), (37, 20, 24), (1, 8, 8), (5, 48, 768)]
# the float32 plans (K1p-f32) at the route shapes, (dirs, S, G, U, rows,
# chunk, c_in_smem, smem): one two-direction grid at the disc and bench
# widths, one direction a launch at the flow width (no two-direction slice
# fits: 2 x 96 CTAs of U = 8)
F32_PLANS = {(401, 196, 392): (2, 33, 2, 12, 201, 48, True, 214128),
             (804, 196, 392): (2, 33, 2, 12, 402, 48, True, 223776),
             (25664, 192, 384): (2, 32, 2, 12, 12832, 64, False, 223424),
             (2176, 192, 384): (2, 32, 2, 12, 1088, 64, False, 223424),
             (502, 384, 768): (1, 96, 1, 8, 502, 16, True, 215360),
             (501, 384, 768): (1, 96, 1, 8, 501, 16, True, 215328),
             (48, 384, 768): (1, 96, 1, 8, 48, 16, True, 200832),
             (8, 196, 392): (2, 49, 1, 8, 8, 16, True, 106368),
             (34, 196, 392): (2, 49, 1, 8, 34, 48, True, 163520)}


def _spans(n, size, count):
    return [(i * size, min((i + 1) * size, n)) for i in range(count)]


@pytest.mark.parametrize("R,N,H", ROUTE_SHAPES + RAGGED,
                         ids=lambda v: str(v))
def test_plan_fits_and_covers_every_row_and_unit_once(R, N, H):
    plan = K.plan_persistent(R, N, H, SMS)
    assert plan is not None and (plan.R, plan.N, plan.H) == (R, N, H)
    assert plan.smem == K.persistent_smem(N, H, plan.U, plan.chunk, plan.rows, plan.c_in_smem)
    assert plan.smem <= 227 * 1024 and plan.ctas <= SMS
    assert plan.U % 4 == 0 and plan.chunk % 16 == 0
    assert plan.chunk <= K.MAX_CHUNK and plan.chunk * plan.U <= K.MAX_CELLS
    assert plan.chunk // 16 * -(-plan.U // 8) <= K.MAX_ACC_BLOCKS
    for n, size, count in ((H, plan.U, plan.S), (R, plan.rows, plan.G)):
        spans = _spans(n, size, count)
        assert all(lo < hi for lo, hi in spans)  # no slice or group is empty
        covered = np.zeros(n, int)
        for lo, hi in spans:
            covered[lo:hi] += 1
        assert (covered == 1).all()


@pytest.mark.parametrize("R,N,H,sms", [(10, 8000, 64, SMS), (10, 40, 64, 1), (0, 40, 64, SMS),
                                       (4, 40, 1024, 8)])
def test_plan_is_none_where_nothing_fits(R, N, H, sms):
    assert K.plan_persistent(R, N, H, sms) is None


def test_route_rule():
    """bfloat16 takes K1p's plan; float32 the two-direction float32 plan
    where one fits, else the one-direction one (two launches), else the
    walk (None: H = 1020, or no slice at all)."""
    for R, N, H in ROUTE_SHAPES:
        assert K.k1_route(torch.bfloat16, R, N, H, SMS) == K.plan_persistent(R, N, H, SMS)
        two = K.plan_persistent(R, N, H, SMS, elem=4)
        one = K.plan_persistent(R, N, H, SMS, dirs=1, elem=4)
        assert K.k1_route(torch.float32, R, N, H, SMS) == (two or one) is not None
    assert K.k1_route(torch.bfloat16, 10, 8000, 64, SMS) is None
    assert K.k1_route(torch.float32, 10, 8000, 64, SMS) is None
    assert K.k1_route(torch.float32, 4, 510, 1020, SMS) is None  # no f32 slice fits
    for R in (502, 501, 48):  # the flow width: no two-direction f32 grid fits the SMs
        assert K.plan_persistent(R, 384, 768, SMS, elem=4) is None
    assert K.k1_route(torch.float16, 401, 196, 392, SMS) is None


@pytest.mark.parametrize("shape", sorted(F32_PLANS), ids=str)
def test_f32_plans_are_pinned(shape):
    """K1p-f32's plans: the route's plan at each shape where float32 K1
    runs, within SMEM_LIMIT, the SMs and the float32 limits
    (MAX_ACC_BLOCKS_TF32, MAX_CELLS_F32), covering every row and unit once;
    the slice is (Kx + Kh) x 4U floats, no pad."""
    R, N, H = shape
    plan = K.k1_route(torch.float32, R, N, H, SMS)
    assert (plan.dirs, plan.S, plan.G, plan.U, plan.rows, plan.chunk, plan.c_in_smem,
            plan.smem) == F32_PLANS[shape]
    assert plan.elem == 4 and plan.smem <= K.SMEM_LIMIT and plan.dirs * plan.S * plan.G <= SMS
    assert plan.chunk // 16 * -(-plan.U // 8) <= K.MAX_ACC_BLOCKS_TF32
    assert plan.chunk * plan.U <= K.MAX_CELLS_F32
    U, chunk = plan.U, plan.chunk
    assert plan.smem == (4 * (plan.kx + plan.kh) * 4 * U + 4 * chunk * (max(plan.kx, plan.kh) + 4)
                         + 4 * chunk * (4 * U + 4) + 4 * 4 * U
                         + (4 * plan.rows * U if plan.c_in_smem else 0))
    for n, size, count in ((H, plan.U, plan.S), (R, plan.rows, plan.G)):
        covered = np.zeros(n, int)
        for lo, hi in _spans(n, size, count):
            assert lo < hi
            covered[lo:hi] += 1
        assert (covered == 1).all()


def _weights(rng, N, H, dtype=torch.float32):
    s = H ** -0.5
    return [torch.from_numpy((s * rng.standard_normal(shape)).astype(np.float32)).to(dtype)
            for shape in ((2, N, 4 * H), (2, H, 4 * H), (2, 4 * H))]


@pytest.mark.parametrize("R,N,H,sms", [(37, 20, 24, SMS), (200, 20, 22, 40), (3, 9, 30, 12)])
def test_pack_matches_a_hand_written_gather(R, N, H, sms):
    plan = K.plan_persistent(R, N, H, sms)
    w_ih, w_hh, b = _weights(np.random.default_rng(0), N, H)
    w, bp = K.pack_persistent_weights(w_ih, w_hh, b, plan)
    w_ih, w_hh, b = w_ih.numpy(), w_hh.numpy(), b.numpy()
    assert w.shape == (2, plan.S, plan.kx + plan.kh, 4 * plan.U)
    assert bp.shape == (2, plan.S, 4 * plan.U)
    want = np.zeros(w.shape, np.float32)
    want_b = np.zeros(bp.shape, np.float32)
    for d in range(2):
        for s in range(plan.S):
            for q in range(4):
                for j in range(plan.U):
                    u = s * plan.U + j
                    if u >= H:
                        continue
                    col = q * H + u
                    want[d, s, :N, q * plan.U + j] = w_ih[d, :, col]
                    want[d, s, plan.kx:plan.kx + H, q * plan.U + j] = w_hh[d, :, col]
                    want_b[d, s, q * plan.U + j] = b[d, col]
    np.testing.assert_array_equal(w.numpy(), want)
    np.testing.assert_array_equal(bp.numpy(), want_b)


# (R, T, N, H, sms): SM counts small enough that the planner splits both the
# rows (G > 1) and the units (S > 1)
SLICED = [(200, 5, 20, 24, 40), (70, 4, 12, 40, 24), (130, 3, 33, 17, 60)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6), (torch.bfloat16, 5e-2)],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("R,T,N,H,sms", SLICED, ids=lambda v: str(v))
def test_sliced_walk_matches_plain(R, T, N, H, sms, dtype, tol):
    plan = K.plan_persistent(R, N, H, sms)
    assert plan.S > 1 and plan.G > 1
    rng = np.random.default_rng(R + T)
    x = torch.from_numpy((0.5 * rng.standard_normal((R, T, N))).astype(np.float32)).to(dtype)
    w_ih, w_hh, b = _weights(rng, N, H, dtype)
    got = K.fusedin_bilstm_sliced_plain(x, K.pack_persistent_weights(w_ih, w_hh, b, plan), plan)
    ref = K.fusedin_bilstm_plain(x, w_ih, w_hh, b)
    assert got.dtype == dtype and got.shape == (R, T, 2 * H)
    assert float((got.float() - ref.float()).abs().max()) < tol


def test_sliced_walk_matches_pallas():
    R, T, N, H = 140, 4, 16, 20
    plan = K.plan_persistent(R, N, H, 24)
    assert plan.S > 1 and plan.G > 1
    rng = np.random.default_rng(3)
    x = (0.5 * rng.standard_normal((R, T, N))).astype(np.float32)
    w_ih, w_hh, b = _weights(rng, N, H)
    out_f, out_b = jpl._fusedin_forward(
        jnp.asarray(x), jnp.asarray(w_ih[0].numpy()), jnp.asarray(w_ih[1].numpy()),
        jnp.asarray(w_hh[0].numpy()), jnp.asarray(w_hh[1].numpy()),
        jnp.asarray(b[0:1].numpy()), jnp.asarray(b[1:2].numpy()), 0, True)
    ref = np.concatenate([np.swapaxes(np.asarray(out_f), 0, 1),
                          np.swapaxes(np.asarray(out_b), 0, 1)], axis=-1)
    got = K.fusedin_bilstm_sliced_plain(torch.from_numpy(x),
                                        K.pack_persistent_weights(w_ih, w_hh, b, plan), plan)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


# (R, T, N, H, sms): float32 plans with G > 1 and S > 1 in both direction
# counts, odd N and H (the 4-, 8- and 16-byte staging of x and h on the card)
SLICED_F32 = [(70, 5, 37, 46, 40), (130, 4, 38, 20, 30), (90, 3, 40, 72, 60)]


@pytest.mark.parametrize("dirs", [2, 1], ids=["one_grid", "a_launch_a_direction"])
@pytest.mark.parametrize("R,T,N,H,sms", SLICED_F32, ids=lambda v: str(v))
def test_sliced_f32_walk_matches_plain(R, T, N, H, sms, dirs):
    """K1p-f32's sliced walk over a float32 plan (elem = 4; two directions
    in one grid or one a launch) against the plain version, float32, 1e-6."""
    plan = K.plan_persistent(R, N, H, sms, dirs=dirs, elem=4)
    assert plan.S > 1 and plan.G > 1 and (plan.dirs, plan.elem) == (dirs, 4)
    rng = np.random.default_rng(R + N)
    x = torch.from_numpy((0.5 * rng.standard_normal((R, T, N))).astype(np.float32))
    w_ih, w_hh, b = _weights(rng, N, H)
    got = K.fusedin_bilstm_sliced_plain(x, K.pack_persistent_weights(w_ih, w_hh, b, plan), plan)
    ref = K.fusedin_bilstm_plain(x, w_ih, w_hh, b)
    assert got.dtype == torch.float32 and got.shape == (R, T, 2 * H)
    assert float((got - ref).abs().max()) < 1e-6


@pytest.mark.parametrize("dirs", [2, 1], ids=["one_grid", "a_launch_a_direction"])
def test_sliced_f32_walk_matches_pallas(dirs):
    """K1p-f32's sliced walk at odd N and H against the Pallas
    ``_fusedin_forward`` (interpret mode), float32, 1e-5."""
    R, T, N, H = 60, 4, 37, 46
    plan = K.plan_persistent(R, N, H, 12, dirs=dirs, elem=4)
    assert plan.S > 1 and plan.dirs == dirs
    rng = np.random.default_rng(8)
    x = (0.5 * rng.standard_normal((R, T, N))).astype(np.float32)
    w_ih, w_hh, b = _weights(rng, N, H)
    out_f, out_b = jpl._fusedin_forward(
        jnp.asarray(x), jnp.asarray(w_ih[0].numpy()), jnp.asarray(w_ih[1].numpy()),
        jnp.asarray(w_hh[0].numpy()), jnp.asarray(w_hh[1].numpy()),
        jnp.asarray(b[0:1].numpy()), jnp.asarray(b[1:2].numpy()), 0, True)
    ref = np.concatenate([np.swapaxes(np.asarray(out_f), 0, 1),
                          np.swapaxes(np.asarray(out_b), 0, 1)], axis=-1)
    got = K.fusedin_bilstm_sliced_plain(torch.from_numpy(x),
                                        K.pack_persistent_weights(w_ih, w_hh, b, plan), plan)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


def test_sliced_f32_pair_equals_the_one_grid_walk():
    """The one-direction pair (dirs = 1: each direction over its own
    partition, into its half of the output) equals the two-direction walk
    over the two-direction plan within 1e-6, float32."""
    R, T, N, H = 70, 5, 37, 46
    one, two = (K.plan_persistent(R, N, H, 40, dirs=d, elem=4) for d in (1, 2))
    assert (one.S, one.U) != (two.S, two.U)
    rng = np.random.default_rng(9)
    x = torch.from_numpy((0.5 * rng.standard_normal((R, T, N))).astype(np.float32))
    w_ih, w_hh, b = _weights(rng, N, H)
    pair = K.fusedin_bilstm_sliced_plain(x, K.pack_persistent_weights(w_ih, w_hh, b, one), one)
    grid = K.fusedin_bilstm_sliced_plain(x, K.pack_persistent_weights(w_ih, w_hh, b, two), two)
    assert float((pair - grid).abs().max()) < 1e-6


def test_cpu_takes_the_plain_versions_without_counting():
    R, T, N, H = 37, 4, 20, 24
    rng = np.random.default_rng(4)
    x = torch.from_numpy((0.5 * rng.standard_normal((R, T, N))).astype(np.float32)).bfloat16()
    w_ih, w_hh, b = _weights(rng, N, H, torch.bfloat16)
    K.reset_launch_counts()
    assert torch.equal(K.fusedin_bilstm(x, w_ih, w_hh, b), K.fusedin_bilstm_plain(x, w_ih, w_hh, b))
    assert torch.equal(K.fusedin_bilstm_walk(x, w_ih, w_hh, b),
                       K.fusedin_bilstm_plain(x, w_ih, w_hh, b))
    assert torch.equal(K.fusedin_bilstm_persistent(x, w_ih, w_hh, b),
                       K.fusedin_bilstm_plain(x, w_ih, w_hh, b))
    assert set(K.launch_counts().values()) == {0}
    assert K.route_counts() == {"persistent": 0, "walk": 0, "persistent_split": 0}
