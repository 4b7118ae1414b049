"""K2p and K3p, the persistent weight-stationary routes of K2 and K3, and
their float32 routes K2p-f32 and K3p-f32, on the CPU: the planner
generalised to one direction over a hoisted projection (and K1p's plans
unchanged by it), the float32 plans pinned, the packed W_hh slice, the plain
sliced walks that read only the packed slices (with K2's carry), and the
route rule, also on a mocked card.  The kernels
themselves (csrc/lstm_persistent.cu) are held against the same plain versions
on the card (tests/test_torch_cuda_kernels.py and chip_smoke.py).

Tolerances: the sliced walks against the unsliced plain versions 1e-6 in
float32 (the same products summed in another order) and 5e-2 in bfloat16
(scripts/check_pallas_tpu.py:29-34; a sum in another order can move a
rounding of h), at every step, padded ones included; against the Pallas
kernels in interpret mode 1e-5 (test_torch_lstm.py's), K3 at the valid steps
(the Pallas kernel's padded outputs are unspecified)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from urgent2026_challenge_track1_tpu.ops import lstm as jlstm
from urgent2026_challenge_track1_tpu.ops import pallas_lstm as jpl
from urgent2026_challenge_track1_tpu_torch.models.bsrnn import BSRNNConfig, band_count
from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K
from urgent2026_challenge_track1_tpu_torch.ops import persistent_checks as PC

torch.set_num_threads(1)
SMS = 132  # one H100
# 16 kHz: n_fft 320, 161 bins, the band count of the 48 kHz layout there
LOW_RATE_K = band_count(BSRNNConfig().input_dim, 48000, 16000, 161)
# (R, H) where K2 and K3 run on the bfloat16 CLI: one utterance at 48 kHz
# (34 bands), a B = 4 batch, one utterance at 16 kHz, the flow model's
# time path (48 bands at H = 768); an odd H
SCAN_SHAPES = [(34, 392), (136, 392), (LOW_RATE_K, 392), (48, 768), (20, 197)]
# K1p's plans at the eight shapes where K1 runs (R, N, H) -> (S, G, U, rows,
# chunk, c_in_smem, smem), as the two-direction planner has always planned them
# (the last: a causal streaming step's band path, 8 rows)
K1P_PLANS = {(401, 196, 392): (11, 6, 36, 67, 32, False, 230464),
             (804, 196, 392): (11, 6, 36, 134, 32, False, 230464),
             (25664, 192, 384): (11, 6, 36, 4278, 32, False, 219712),
             (2176, 192, 384): (11, 6, 36, 363, 32, False, 219712),
             (502, 384, 768): (64, 1, 12, 502, 48, False, 213696),
             (501, 384, 768): (64, 1, 12, 501, 48, False, 213696),
             (48, 384, 768): (64, 1, 12, 48, 48, True, 216000),
             (8, 196, 392): (49, 1, 8, 8, 16, True, 64384)}


def test_low_rate_band_count():
    assert LOW_RATE_K == 27


def _spans(n, size, count):
    return [(i * size, min((i + 1) * size, n)) for i in range(count)]


@pytest.mark.parametrize("R,H", SCAN_SHAPES + [(2176, 392), (1, 8), (37, 24)],
                         ids=lambda v: str(v))
def test_scan_plan_fits_and_covers_every_row_and_unit_once(R, H):
    plan = K.plan_persistent(R, 0, H, SMS, dirs=1)
    assert plan is not None and (plan.R, plan.N, plan.H, plan.dirs) == (R, 0, H, 1)
    assert plan.kx == 0 and plan.ctas == plan.G * plan.S <= SMS
    assert plan.smem == K.persistent_smem(0, H, plan.U, plan.chunk, plan.rows, plan.c_in_smem)
    assert plan.smem <= K.SMEM_LIMIT
    assert plan.U % 4 == 0 and plan.chunk % 16 == 0
    assert plan.chunk <= K.MAX_CHUNK and plan.chunk * plan.U <= K.MAX_CELLS
    assert plan.chunk // 16 * -(-plan.U // 8) <= K.MAX_ACC_BLOCKS
    for n, size, count in ((H, plan.U, plan.S), (R, plan.rows, plan.G)):
        spans = _spans(n, size, count)
        assert all(lo < hi for lo, hi in spans)
        covered = np.zeros(n, int)
        for lo, hi in spans:
            covered[lo:hi] += 1
        assert (covered == 1).all()


def test_scan_smem_counts_the_projection_buffer_not_a_bias():
    """N = 0: no W_ih rows and no bias, a double buffer of 4U projection
    columns for a chunk instead; N > 0 keeps K1p's reckoning."""
    U, chunk, H = 12, 48, 392
    kh = 400
    want = (2 * kh * (4 * U + 8) + 2 * chunk * (kh + 8) + 4 * chunk * (4 * U + 4)
            + 2 * 2 * chunk * 4 * U)
    assert K.persistent_smem(0, H, U, chunk) == want
    assert K.persistent_smem(0, H, U, chunk, 34, True) == want + 4 * 34 * U
    assert K.persistent_smem(196, H, U, chunk) - K.persistent_smem(0, H, U, chunk) == (
        2 * 208 * (4 * U + 8) + 4 * 4 * U - 2 * 2 * chunk * 4 * U)


@pytest.mark.parametrize("shape", sorted(K1P_PLANS), ids=str)
def test_k1p_plans_are_unchanged(shape):
    plan = K.plan_persistent(*shape, SMS)
    assert plan.dirs == 2 and plan.ctas == 2 * plan.G * plan.S
    assert (plan.S, plan.G, plan.U, plan.rows, plan.chunk, plan.c_in_smem,
            plan.smem) == K1P_PLANS[shape]


@pytest.mark.parametrize("R,H,sms", [(10, 8000, SMS), (0, 64, SMS), (4, 1024, 4),
                                     (10, 64, 0)])
def test_scan_plan_is_none_where_nothing_fits(R, H, sms):
    assert K.plan_persistent(R, 0, H, sms, dirs=1) is None


def test_scan_route_rule():
    """bfloat16 takes the one-direction plan, float32 the float32 one
    (K2p-f32 / K3p-f32); no plan is the walk (float32 at H = 1020)."""
    for R, H in SCAN_SHAPES:
        f32 = K.scan_route(torch.float32, R, H, SMS)
        assert f32 == K.plan_persistent(R, 0, H, SMS, dirs=1, elem=4) is not None
        assert f32.elem == 4 and f32.ctas <= SMS
        assert K.scan_route(torch.bfloat16, R, H, SMS) == K.plan_persistent(R, 0, H, SMS,
                                                                              dirs=1)
    assert K.scan_route(torch.bfloat16, 10, 8000, SMS) is None
    assert K.scan_route(torch.float32, 34, 1020, SMS) is None
    assert K.scan_route(torch.float16, 34, 392, SMS) is None


# K2p-f32's and K3p-f32's plans where float32 K2 and K3 run, (R, H) -> (S, G,
# U, rows, chunk, c_in_smem, smem): one utterance at 48 kHz (34 bands), the
# disc validation and CLI batch (4 x 34), one flow utterance (48 bands at H
# = 768: 16-row chunks, three a step), the flow validation batch (2 x 48:
# 16-row chunks, c in global memory), an odd H; None at H = 1020 (the wide
# step: the walks stay)
F32_SCAN_PLANS = {(34, 392): (98, 1, 4, 34, 48, True, 126496),
                  (136, 392): (33, 3, 12, 46, 48, True, 197792),
                  (48, 768): (96, 1, 8, 48, 16, True, 180224),
                  (96, 768): (64, 2, 12, 48, 16, False, 230912),
                  (20, 197): (50, 1, 4, 20, 32, True, 54080),
                  (34, 1020): None}


@pytest.mark.parametrize("shape", sorted(F32_SCAN_PLANS), ids=str)
def test_f32_scan_plans_are_pinned(shape):
    """The float32 route's plan at each shape, within SMEM_LIMIT, the SMs
    and the float32 limits, its bytes ``persistent_smem(..., elem=4)``
    (the kernel's ``Plan::smem_bytes``), covering every row and unit once."""
    R, H = shape
    plan = K.scan_route(torch.float32, R, H, SMS)
    want = F32_SCAN_PLANS[shape]
    if want is None:
        assert plan is None and K.plan_persistent(R, 0, H, SMS, dirs=1, elem=4) is None
        return
    assert (plan.S, plan.G, plan.U, plan.rows, plan.chunk, plan.c_in_smem, plan.smem) == want
    assert (plan.elem, plan.dirs, plan.N) == (4, 1, 0) and plan.ctas <= SMS
    assert plan.smem == K.persistent_smem(0, H, plan.U, plan.chunk, plan.rows, plan.c_in_smem,
                                          4) <= K.SMEM_LIMIT
    assert plan.chunk // 16 * -(-plan.U // 8) <= K.MAX_ACC_BLOCKS_TF32
    assert plan.chunk * plan.U <= K.MAX_CELLS_F32
    for n, size, count in ((H, plan.U, plan.S), (R, plan.rows, plan.G)):
        covered = np.zeros(n, int)
        for lo, hi in _spans(n, size, count):
            assert lo < hi
            covered[lo:hi] += 1
        assert (covered == 1).all()


def test_f32_scan_smem_doubles_the_elements():
    """elem = 4: the slice (Kh x (4U + 8)), the staged h chunk (Kh + 4 f32 a
    row) and the projection's double buffer in 4-byte elements; the
    accumulators and c are f32 either way."""
    U, chunk, H, rows = 4, 48, 392, 34
    kh = 400
    want = (4 * kh * (4 * U + 8) + 4 * chunk * (kh + 4) + 4 * chunk * (4 * U + 4)
            + 4 * 2 * chunk * 4 * U + 4 * rows * U)
    assert K.persistent_smem(0, H, U, chunk, rows, True, 4) == want == 126496


def _w_hh(rng, H, dtype=torch.float32):
    return torch.from_numpy((H ** -0.5 * rng.standard_normal((H, 4 * H))).astype(
        np.float32)).to(dtype)


@pytest.mark.parametrize("R,H,sms", [(37, 24, SMS), (200, 22, 40), (3, 30, 12)])
def test_scan_pack_matches_a_hand_written_gather(R, H, sms):
    plan = K.plan_persistent(R, 0, H, sms, dirs=1)
    w_hh = _w_hh(np.random.default_rng(0), H)
    w = K.pack_scan_weights(w_hh, plan)
    assert w.shape == (plan.S, plan.kh, 4 * plan.U) and w.is_contiguous()
    w_hh = w_hh.numpy()
    want = np.zeros(w.shape, np.float32)
    for s in range(plan.S):
        for q in range(4):
            for j in range(plan.U):
                u = s * plan.U + j
                if u < H:
                    want[s, :H, q * plan.U + j] = w_hh[:, q * H + u]
    np.testing.assert_array_equal(w.numpy(), want)


# (R, T, H, sms): SM counts small enough that the planner splits both the
# rows (G > 1) and the units (S > 1); the last has more rows per group than a
# chunk holds
SLICED = [(70, 6, 40, 24), (130, 5, 17, 60), (150, 4, 24, 6)]


def _inputs(R, T, H, dtype, seed):
    rng = np.random.default_rng(seed)
    xp = torch.from_numpy((0.5 * rng.standard_normal((R, T, 4 * H))).astype(np.float32))
    lengths = rng.integers(1, T + 1, R).astype(np.int32)
    lengths[0], lengths[-1] = 1, T
    return xp.to(dtype), _w_hh(rng, H, dtype), torch.from_numpy(lengths)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6), (torch.bfloat16, 5e-2)],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("R,T,H,sms", SLICED, ids=lambda v: str(v))
def test_sliced_walks_match_plain_at_every_step(R, T, H, sms, dtype, tol):
    plan = K.plan_persistent(R, 0, H, sms, dirs=1)
    assert plan.S > 1 and plan.G > 1
    xp, w_hh, lengths = _inputs(R, T, H, dtype, R + T)
    w = K.pack_scan_weights(w_hh, plan)
    for reverse in (False, True):
        got = K.lstm_scan_sliced_plain(xp, w, plan, reverse)
        ref = K.lstm_scan_plain(xp, w_hh, reverse)
        assert got.dtype == dtype and got.shape == (R, T, H)
        assert float((got.float() - ref.float()).abs().max()) < tol
    got = K.lstm_revmasked_sliced_plain(xp, w, lengths, plan)
    ref = K.lstm_revmasked_plain(xp, w_hh, lengths)
    assert float((got.float() - ref.float()).abs().max()) < tol


def test_sliced_walks_need_the_mask_at_padded_steps():
    """The masked walk differs from the unmasked one exactly where a row's
    padded steps feed its valid ones: the mask is not a no-op here."""
    R, T, H = 70, 6, 40
    plan = K.plan_persistent(R, 0, H, 24, dirs=1)
    xp, w_hh, lengths = _inputs(R, T, H, torch.float32, 1)
    w = K.pack_scan_weights(w_hh, plan)
    masked = K.lstm_revmasked_sliced_plain(xp, w, lengths, plan)
    unmasked = K.lstm_scan_sliced_plain(xp, w, plan, True)
    short = lengths < T
    assert float((masked[short] - unmasked[short]).abs().max()) > 1e-2
    assert torch.equal(masked[~short], unmasked[~short])


@pytest.mark.parametrize("reverse", [False, True])
def test_sliced_scan_matches_pallas(reverse):
    R, T, H = 70, 6, 40
    plan = K.plan_persistent(R, 0, H, 24, dirs=1)
    assert plan.S > 1 and plan.G > 1
    xp, w_hh, _ = _inputs(R, T, H, torch.float32, 2)
    ref = jpl.lstm_scan_pallas(jnp.asarray(xp.numpy()), jnp.asarray(w_hh.numpy()),
                               reverse=reverse, interpret=True)
    got = K.lstm_scan_sliced_plain(xp, K.pack_scan_weights(w_hh, plan), plan, reverse)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_sliced_revmasked_matches_pallas():
    R, T, H = 70, 6, 40
    plan = K.plan_persistent(R, 0, H, 24, dirs=1)
    xp, w_hh, lengths = _inputs(R, T, H, torch.float32, 3)
    ref = jpl._lean_forward_revmasked(jnp.asarray(xp.numpy()), jnp.asarray(w_hh.numpy()),
                                      jnp.asarray(lengths.numpy()), b_block=0, interpret=True)
    got = K.lstm_revmasked_sliced_plain(xp, K.pack_scan_weights(w_hh, plan), lengths, plan)
    valid = np.arange(T)[None, :] < lengths.numpy()[:, None]
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(ref)[valid], atol=1e-5, rtol=0)


def test_cpu_takes_the_plain_versions_without_counting():
    R, T, H = 37, 4, 24
    xp, w_hh, lengths = _inputs(R, T, H, torch.bfloat16, 4)
    K.reset_launch_counts()
    for reverse in (False, True):
        ref = K.lstm_scan_plain(xp, w_hh, reverse)
        for fn in (K.lstm_scan, K.lstm_scan_walk, K.lstm_scan_persistent):
            assert torch.equal(fn(xp, w_hh, reverse), ref)
    ref = K.lstm_revmasked_plain(xp, w_hh, lengths)
    for fn in (K.lstm_revmasked, K.lstm_revmasked_walk, K.lstm_revmasked_persistent):
        assert torch.equal(fn(xp, w_hh, lengths), ref)
    assert set(K.launch_counts().values()) == {0}
    assert K.route_counts("fusedin_bilstm") == {"persistent": 0, "walk": 0,
                                                "persistent_split": 0}
    for name in ("lstm_scan", "lstm_revmasked"):
        assert K.route_counts(name) == {"persistent": 0, "walk": 0}


@pytest.mark.parametrize("peak,limit", [(1.0, 2.0 ** -5), (0.75, 2.0 ** -6), (3.0, 2.0 ** -4)])
def test_ulp_limit_is_four_bf16_ulps_at_the_peak(peak, limit):
    ref = torch.tensor([[0.1, -peak], [0.0, 0.2]], dtype=torch.bfloat16)
    assert PC.PERSISTENT_ULPS == 4 and PC.ulp_limit(ref) == limit


def test_planted_stale_h_exceeds_the_limit_only_after_the_first_step():
    """The barrier faults that the card checks must catch: the plain walks
    fed h one step stale equal the plain versions at the first step and
    leave them by more than ``ulp_limit`` over the walk (bfloat16)."""
    R, T, H = 21, 9, 24
    xp, w_hh, lengths = _inputs(R, T, H, torch.bfloat16, 5)
    lengths[0] = T
    for reverse in (False, True):
        ref = K.lstm_scan_plain(xp, w_hh, reverse)
        stale = PC.lstm_scan_stale_h(xp, w_hh, reverse)
        first = T - 1 if reverse else 0
        assert torch.equal(stale[:, first], ref[:, first])
        assert float((stale.float() - ref.float()).abs().max()) >= PC.ulp_limit(ref)
    ref = K.lstm_revmasked_plain(xp, w_hh, lengths)
    stale = PC.lstm_scan_stale_h(xp, w_hh, True, lengths)
    assert torch.equal(stale[:, T - 1], ref[:, T - 1])
    assert float((stale.float() - ref.float()).abs().max()) >= PC.ulp_limit(ref)
    rng = np.random.default_rng(6)
    x, wi, wh, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(torch.bfloat16)
                    for s in ((R, T, 16), (2, 16, 4 * H), (2, H, 4 * H), (2, 4 * H)))
    ref = K.fusedin_bilstm_plain(x, wi, wh, b)
    stale = PC.fusedin_bilstm_stale_h(x, wi, wh, b)
    assert torch.equal(stale[:, 0, :H], ref[:, 0, :H])
    assert torch.equal(stale[:, T - 1, H:], ref[:, T - 1, H:])
    assert float((stale.float() - ref.float()).abs().max()) >= PC.ulp_limit(ref)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6), (torch.bfloat16, 5e-2)],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("R,T,H,sms", SLICED, ids=lambda v: str(v))
def test_sliced_scan_carry_matches_plain(R, T, H, sms, dtype, tol):
    """K2p's carry over the plan's schedule: step 0 reads h0 as its h_{t-1}
    and c0 as its c, the owners hand on the last step's (h, c); against the
    plain walk with the same carry, at every step, both directions; the
    last h is the output's last column; a dropped carry lands far off."""
    plan = K.plan_persistent(R, 0, H, sms, dirs=1)
    xp, w_hh, _ = _inputs(R, T, H, dtype, R + T + 7)
    rng = np.random.default_rng(R)
    h0 = torch.from_numpy((0.5 * rng.standard_normal((R, H))).astype(np.float32)).to(dtype)
    c0 = torch.from_numpy((0.5 * rng.standard_normal((R, H))).astype(np.float32))
    w = K.pack_scan_weights(w_hh, plan)
    for reverse in (False, True):
        got, (hT, cT) = K.lstm_scan_sliced_plain(xp, w, plan, reverse, (h0, c0), True)
        ref, (rh, rc) = K.lstm_scan_plain(xp, w_hh, reverse, (h0, c0), True)
        assert hT.dtype == dtype and cT.dtype == torch.float32
        assert torch.equal(hT, got[:, 0 if reverse else T - 1])
        for a, b in ((got, ref), (hT, rh), (cT, rc)):
            assert float((a.float() - b.float()).abs().max()) < tol
        dropped, _ = PC.lstm_scan_dropped_carry(xp, w_hh, reverse)
        assert float((dropped.float() - ref.float()).abs().max()) > 0.1


def test_sliced_scan_carry_chains_chunks_exactly():
    """Chunks of 2 steps chained through the carry equal one walk over all
    steps, bitwise: the schedule's arithmetic per step does not depend on
    T, and the carry is what the next step would read."""
    R, T, H, sms = 70, 7, 40, 24
    plan = K.plan_persistent(R, 0, H, sms, dirs=1)
    xp, w_hh, _ = _inputs(R, T, H, torch.bfloat16, 8)
    w = K.pack_scan_weights(w_hh, plan)
    one = K.lstm_scan_sliced_plain(xp, w, plan)
    state, outs = None, []
    for t0 in range(0, T, 2):
        y, state = K.lstm_scan_sliced_plain(xp[:, t0:t0 + 2], w, plan, False, state, True)
        outs.append(y)
    assert torch.equal(torch.cat(outs, dim=1), one)
    K.reset_launch_counts()
    for fn in (K.lstm_scan, K.lstm_scan_walk, K.lstm_scan_persistent):  # the CPU: plain
        y, (h, c) = fn(xp, w_hh, initial_state=state, return_state=True)
        ref, (rh, rc) = K.lstm_scan_plain(xp, w_hh, False, state, True)
        assert torch.equal(y, ref) and torch.equal(h, rh) and torch.equal(c, rc)
    assert K.route_counts("lstm_scan") == {"persistent": 0, "walk": 0}


# --- K2p-f32 and K3p-f32: the sliced walks over float32 plans (elem = 4) ---


def _f32_plan(R, H, sms):
    plan = K.scan_route(torch.float32, R, H, sms)
    assert plan is not None and plan.elem == 4 and plan.S > 1 and plan.G > 1
    return plan


@pytest.mark.parametrize("R,T,H,sms", SLICED, ids=lambda v: str(v))
def test_sliced_f32_walks_match_plain_at_every_step(R, T, H, sms):
    """K2p-f32 (both directions) and K3p-f32 over their float32 plans
    against the plain versions within 1e-6, padded steps included."""
    plan = _f32_plan(R, H, sms)
    xp, w_hh, lengths = _inputs(R, T, H, torch.float32, R + T + 11)
    w = K.pack_scan_weights(w_hh, plan)
    for reverse in (False, True):
        got = K.lstm_scan_sliced_plain(xp, w, plan, reverse)
        ref = K.lstm_scan_plain(xp, w_hh, reverse)
        assert got.dtype == torch.float32 and got.shape == (R, T, H)
        assert float((got - ref).abs().max()) < 1e-6
    got = K.lstm_revmasked_sliced_plain(xp, w, lengths, plan)
    assert float((got - K.lstm_revmasked_plain(xp, w_hh, lengths)).abs().max()) < 1e-6


@pytest.mark.parametrize("kind", ["forward", "reverse", "masked"])
@pytest.mark.parametrize("R,T,H,sms", SLICED, ids=lambda v: str(v))
def test_sliced_f32_scan_matches_pallas(R, T, H, sms, kind):
    """The float32 sliced walks against the Pallas kernels they port, in f32
    and interpret mode: K2p-f32 against ``lstm_scan_pallas`` (both
    directions), K3p-f32 against ``_lean_forward_revmasked`` at the valid
    steps, within 1e-5."""
    plan = _f32_plan(R, H, sms)
    xp, w_hh, lengths = _inputs(R, T, H, torch.float32, R + T + 12)
    w = K.pack_scan_weights(w_hh, plan)
    jx, jw = jnp.asarray(xp.numpy()), jnp.asarray(w_hh.numpy())
    if kind == "masked":
        ref = jpl._lean_forward_revmasked(jx, jw, jnp.asarray(lengths.numpy()), b_block=0,
                                          interpret=True)
        got = K.lstm_revmasked_sliced_plain(xp, w, lengths, plan)
        valid = np.arange(T)[None, :] < lengths.numpy()[:, None]
        np.testing.assert_allclose(got.numpy()[valid], np.asarray(ref)[valid], atol=1e-5,
                                   rtol=0)
    else:
        ref = jpl.lstm_scan_pallas(jx, jw, reverse=kind == "reverse", interpret=True)
        got = K.lstm_scan_sliced_plain(xp, w, plan, kind == "reverse")
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("R,T,H,sms", SLICED, ids=lambda v: str(v))
def test_sliced_f32_scan_carry_matches_jax(R, T, H, sms, reverse):
    """K2p-f32's carry over its float32 plan against the JAX package's
    ``_scan_dir`` with the same (h0, c0) (the streaming step's time path):
    h at every step and the last (h, c) within 1e-5; hT is the output's
    last column."""
    plan = _f32_plan(R, H, sms)
    xp, w_hh, _ = _inputs(R, T, H, torch.float32, R + T + 13)
    rng = np.random.default_rng(R + 1)
    h0, c0 = (torch.from_numpy((0.5 * rng.standard_normal((R, H))).astype(np.float32))
              for _ in range(2))
    got, (hT, cT) = K.lstm_scan_sliced_plain(xp, K.pack_scan_weights(w_hh, plan), plan,
                                             reverse, (h0, c0), True)
    ref, (rh, rc) = jlstm._scan_dir(
        jnp.asarray(xp.numpy()), jnp.asarray(w_hh.numpy()), H, reverse,
        initial_state=(jnp.asarray(h0.numpy()), jnp.asarray(c0.numpy())), return_state=True)
    assert hT.dtype == cT.dtype == torch.float32
    assert torch.equal(hT, got[:, 0 if reverse else T - 1])
    for a, b in ((got, ref), (hT, rh), (cT, rc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)


def test_sliced_f32_scan_carry_chains_chunks_exactly():
    """Float32 chunks of 2 steps chained through the carry equal one walk
    over the float32 plan, bitwise, as in bfloat16."""
    R, T, H, sms = 70, 7, 40, 24
    plan = _f32_plan(R, H, sms)
    xp, w_hh, _ = _inputs(R, T, H, torch.float32, 9)
    w = K.pack_scan_weights(w_hh, plan)
    one = K.lstm_scan_sliced_plain(xp, w, plan)
    state, outs = None, []
    for t0 in range(0, T, 2):
        y, state = K.lstm_scan_sliced_plain(xp[:, t0:t0 + 2], w, plan, False, state, True)
        outs.append(y)
    assert torch.equal(torch.cat(outs, dim=1), one)


@pytest.mark.parametrize("sms", [SMS, 24, 6])
def test_f32_route_follows_the_plan_on_a_mocked_card(monkeypatch, sms):
    """K2 (with and without the carry) and K3 in float32 on a card of
    ``sms`` SMs: each call takes the persistent wrapper with
    ``scan_route``'s float32 plan for that SM count, the carry passed on;
    at H = 1020, where no float32 plan fits, the walk.  The card is mocked:
    tensors on the meta device reach the route rule, and the wrappers are
    recorders."""
    calls = []

    def recorder(route):
        def fn(x_proj, *args, **kwargs):
            calls.append((route, args, kwargs))
        return fn

    monkeypatch.setattr(K, "_device_index", lambda device: 0)
    monkeypatch.setattr(K, "_sm_count", lambda index: sms)
    for name in ("lstm_scan", "lstm_revmasked"):
        monkeypatch.setattr(K, f"{name}_persistent", recorder("persistent"))
        monkeypatch.setattr(K, f"{name}_walk", recorder("walk"))
    for R, H in [(70, 40), (34, 392), (96, 768), (34, 1020)]:
        xp = torch.empty((R, 5, 4 * H), device="meta")
        w = torch.empty((H, 4 * H), device="meta")
        lengths = torch.empty((R,), dtype=torch.int32, device="meta")
        carry = (torch.empty((R, H), device="meta"), torch.empty((R, H), device="meta"))
        plan = K.plan_persistent(R, 0, H, sms, dirs=1, elem=4)
        assert plan == K.scan_route(torch.float32, R, H, sms)
        calls.clear()
        K.lstm_scan(xp, w, True)
        K.lstm_scan(xp, w, False, initial_state=carry, return_state=True)
        K.lstm_revmasked(xp, w, lengths)
        route = "walk" if plan is None else "persistent"
        assert [c[0] for c in calls] == [route] * 3
        if plan is not None:
            assert [c[1][-1] for c in calls] == [plan] * 3
        assert calls[1][2] == {"initial_state": carry, "return_state": True}
