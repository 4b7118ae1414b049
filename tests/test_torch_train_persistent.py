"""K4p and K6p, the persistent weight-stationary routes of the training
forwards K4 and K6, in bfloat16 and in float32 (the float32 route: plans of
4-byte elements, 3xTF32 products on the card), on the CPU: the route rule,
the planner's float32 plans and the bfloat16 plans it leaves unchanged, the
plain sliced walks that read only the packed W_hh slices and return the
residuals (h, gates, c), the mask trap of K6p (the stored c is the step's
unmasked c, not the masked one it carries) and the planted stale-h fault
that the card checks must see.
The kernels themselves (csrc/lstm_persistent.cu) are held against the same
plain versions on the card (tests/test_torch_cuda_kernels.py and
chip_smoke.py).

Tolerances: the sliced walks against the unsliced plain versions 1e-6 in
float32 (the same products summed in another order) and 5e-2 in bfloat16
(scripts/check_pallas_tpu.py:29-34; a sum in another order can move a
rounding of h), at every step, padded ones included; against the Pallas
kernels in interpret mode 1e-5 (test_torch_lstm.py's), K6 at the valid steps
(the Pallas kernel's padded outputs are unspecified)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from urgent2026_challenge_track1_tpu.ops import pallas_lstm as jpl
from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as K
from urgent2026_challenge_track1_tpu_torch.ops import persistent_checks as PC

torch.set_num_threads(1)
SMS = 132  # one H100
# (R, H) where K4 and K6 run in a bf16 train step: the disc time and band
# paths (B = 4, 2 s at 48 kHz), the flow model's (B = 2, H = 768); an odd H
TRAIN_SHAPES = [(136, 392), (804, 392), (96, 768), (502, 768), (20, 197)]
# (R, T, H, sms): SM counts small enough that the planner splits both the
# rows (G > 1) and the units (S > 1); the last has more rows per group than a
# chunk holds
SLICED = [(70, 6, 40, 24), (130, 5, 17, 60), (150, 4, 24, 6)]
RESIDUALS = ("h", "gates", "c")


def _inputs(R, T, H, dtype, seed):
    rng = np.random.default_rng(seed)
    xp = torch.from_numpy((0.5 * rng.standard_normal((R, T, 4 * H))).astype(np.float32))
    w_hh = torch.from_numpy((H ** -0.5 * rng.standard_normal((H, 4 * H))).astype(np.float32))
    lengths = rng.integers(1, T + 1, R).astype(np.int32)
    lengths[0], lengths[-1] = 1, T
    return xp.to(dtype), w_hh.to(dtype), torch.from_numpy(lengths)


def _max_err(got, ref):
    return max(float((g.float() - r.float()).abs().max()) for g, r in zip(got, ref))


def test_train_route_rule():
    """K4 and K6 take ``scan_route``, K2's and K3's rule (one plan for the
    storing and the lean kernels): bf16 with a one-direction plan and
    float32 with a float32 plan (elem = 4) take the persistent route,
    shapes without a plan the walk."""
    for R, H in TRAIN_SHAPES:
        plan = K.scan_route(torch.bfloat16, R, H, SMS)
        assert plan == K.plan_persistent(R, 0, H, SMS, dirs=1) and plan.ctas <= SMS
        f32 = K.scan_route(torch.float32, R, H, SMS)
        assert f32 == K.plan_persistent(R, 0, H, SMS, dirs=1, elem=4)
        assert f32.elem == 4 and f32.ctas <= SMS
    assert K.scan_route(torch.bfloat16, 10, 8000, SMS) is None
    assert K.scan_route(torch.float32, 10, 1020, SMS) is None  # no f32 slice fits
    assert K.scan_route(torch.float16, 10, 64, SMS) is None


# the bfloat16 one-direction plans (K2p-K6p) at the shapes of PERF.md's
# kernel table, (R, H) -> (S, G, U, rows, chunk, c_in_smem, smem), as the
# planner planned them before it knew the element size
BF16_PLANS = {(34, 392): (98, 1, 4, 34, 48, True, 65824),
              (136, 392): (33, 3, 12, 46, 48, True, 105376),
              (804, 392): (10, 13, 40, 62, 32, True, 211904),
              (48, 768): (96, 1, 8, 48, 48, True, 150528),
              (96, 768): (64, 2, 12, 48, 48, True, 182016),
              (502, 768): (32, 4, 24, 126, 16, True, 209216),
              (20, 197): (50, 1, 4, 20, 32, True, 28736)}
# the float32 plans of the train steps' shapes (PERF.md's predictions)
F32_PLANS = {(136, 392): (33, 3, 12, 46, 48, True, 197792),
             (804, 392): (17, 7, 24, 115, 16, True, 221984),
             (96, 768): (64, 2, 12, 48, 16, False, 230912),
             (502, 768): (64, 2, 12, 251, 16, False, 230912),
             (20, 197): (50, 1, 4, 20, 32, True, 54080)}


def _plan_tuple(plan):
    return (plan.S, plan.G, plan.U, plan.rows, plan.chunk, plan.c_in_smem, plan.smem)


@pytest.mark.parametrize("shape", sorted(BF16_PLANS), ids=str)
def test_bf16_plans_are_unchanged(shape):
    plan = K.plan_persistent(*shape[:1], 0, shape[1], SMS, dirs=1)
    assert plan.elem == 2 and _plan_tuple(plan) == BF16_PLANS[shape]


@pytest.mark.parametrize("shape", sorted(F32_PLANS), ids=str)
def test_f32_plans_fit_and_double_the_slice(shape):
    """A float32 plan fits SMEM_LIMIT and the planner's limits; its bytes
    are the bf16 reckoning with the slice, the staged h chunk (rows padded
    to 16 bytes) and the projection's double buffer in 4-byte elements; a
    slice split once into resident hi and lo halves (one more slice) would
    not fit beside it."""
    R, H = shape
    plan = K.plan_persistent(R, 0, H, SMS, dirs=1, elem=4)
    assert plan.elem == 4 and _plan_tuple(plan) == F32_PLANS[shape]
    assert plan.smem <= K.SMEM_LIMIT and plan.ctas <= SMS
    assert plan.chunk // 16 * -(-plan.U // 8) <= K.MAX_ACC_BLOCKS_TF32
    assert plan.chunk * plan.U <= K.MAX_CELLS_F32
    kh, U, chunk = plan.kh, plan.U, plan.chunk
    slice16 = 2 * kh * (4 * U + 8)
    bf16 = K.persistent_smem(0, H, U, chunk, plan.rows, plan.c_in_smem)
    assert bf16 == (slice16 + 2 * chunk * (kh + 8) + 4 * chunk * (4 * U + 4) + 2 * 2 * chunk * 4 * U
                    + (4 * plan.rows * U if plan.c_in_smem else 0))
    assert plan.smem - bf16 == (2 * slice16 - slice16) + (4 * chunk * (kh + 4) - 2 * chunk * (kh + 8)) \
        + (4 * 2 * chunk * 4 * U - 2 * 2 * chunk * 4 * U)
    if H != 197:  # the train steps' shapes (the odd H is a test shape)
        assert plan.smem + 2 * slice16 > K.SMEM_LIMIT


def test_f32_plans_need_no_inputs_the_kernel_lacks():
    """The planner takes 2- and 4-byte elements only; a float32 plan with N
    > 0 is K1p-f32's (the fused-input slice of 4U floats a row, no pad)."""
    plan = K.plan_persistent(10, 196, 392, SMS, elem=4)
    assert (plan.elem, plan.dirs, plan.N) == (4, 2, 196) and plan.ctas <= SMS
    assert plan.smem == K.persistent_smem(196, 392, plan.U, plan.chunk, plan.rows,
                                          plan.c_in_smem, 4)
    with pytest.raises(ValueError):
        K.plan_persistent(10, 0, 392, SMS, dirs=1, elem=8)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6), (torch.bfloat16, 5e-2)],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("R,T,H,sms", SLICED, ids=lambda v: str(v))
def test_sliced_training_walks_match_plain_at_every_step(R, T, H, sms, dtype, tol):
    plan = K.plan_persistent(R, 0, H, sms, dirs=1)
    assert plan.S > 1 and plan.G > 1
    xp, w_hh, lengths = _inputs(R, T, H, dtype, R + T)
    w = K.pack_scan_weights(w_hh, plan)
    for reverse in (False, True):
        got = K.lstm_train_fwd_sliced_plain(xp, w, plan, reverse)
        ref = K.lstm_train_fwd_plain(xp, w_hh, reverse)
        assert [t.shape for t in got] == [(R, T, H), (R, T, 4 * H), (R, T, H)]
        assert all(t.dtype == dtype for t in got)
        assert _max_err(got, ref) < tol
        # h is K2p's sliced walk's
        assert torch.equal(got[0], K.lstm_scan_sliced_plain(xp, w, plan, reverse))
    got = K.lstm_revmasked_train_fwd_sliced_plain(xp, w, lengths, plan)
    ref = K.lstm_revmasked_train_fwd_plain(xp, w_hh, lengths)
    assert _max_err(got, ref) < tol
    assert torch.equal(got[0], K.lstm_revmasked_sliced_plain(xp, w, lengths, plan))


@pytest.mark.parametrize("R,T,H,sms", SLICED, ids=lambda v: str(v))
def test_sliced_f32_training_walks_match_plain_at_every_step(R, T, H, sms):
    """The sliced walks over a float32 plan (its narrower chunks) against
    the unsliced plain versions, 1e-6 at every step."""
    plan = K.plan_persistent(R, 0, H, sms, dirs=1, elem=4)
    assert plan.S > 1 and plan.G > 1 and plan.elem == 4
    xp, w_hh, lengths = _inputs(R, T, H, torch.float32, R + T + 1)
    w = K.pack_scan_weights(w_hh, plan)
    for reverse in (False, True):
        got = K.lstm_train_fwd_sliced_plain(xp, w, plan, reverse)
        assert _max_err(got, K.lstm_train_fwd_plain(xp, w_hh, reverse)) < 1e-6
    got = K.lstm_revmasked_train_fwd_sliced_plain(xp, w, lengths, plan)
    assert _max_err(got, K.lstm_revmasked_train_fwd_plain(xp, w_hh, lengths)) < 1e-6


@pytest.mark.parametrize("reverse", [False, True])
def test_sliced_f32_train_fwd_matches_pallas(reverse):
    """The float32 plan's sliced K4p walk against the Pallas training
    forward in interpret mode, 1e-5, every residual at every step."""
    R, T, H = 70, 6, 40
    plan = K.plan_persistent(R, 0, H, 24, dirs=1, elem=4)
    assert plan.elem == 4 and plan.S > 1 and plan.G > 1
    xp, w_hh, _ = _inputs(R, T, H, torch.float32, 12)
    ref = jpl._train_forward(jnp.asarray(xp.numpy()), jnp.asarray(w_hh.numpy()), reverse, 0,
                             True)
    got = K.lstm_train_fwd_sliced_plain(xp, K.pack_scan_weights(w_hh, plan), plan, reverse)
    for g, r in zip(got, ref):  # the Pallas residuals are time-major
        np.testing.assert_allclose(g.numpy(), np.swapaxes(np.asarray(r), 0, 1), atol=1e-5,
                                   rtol=0)


def test_sliced_f32_revmasked_train_fwd_matches_pallas():
    """The float32 plan's sliced K6p walk against the Pallas masked training
    forward in interpret mode, 1e-5 at the valid steps."""
    R, T, H = 70, 6, 40
    plan = K.plan_persistent(R, 0, H, 24, dirs=1, elem=4)
    xp, w_hh, lengths = _inputs(R, T, H, torch.float32, 13)
    ref = jpl._train_forward_revmasked(jnp.asarray(xp.numpy()), jnp.asarray(w_hh.numpy()),
                                       jnp.asarray(lengths.numpy()), 0, True)
    got = K.lstm_revmasked_train_fwd_sliced_plain(xp, K.pack_scan_weights(w_hh, plan), lengths,
                                                  plan)
    valid = np.arange(T)[None, :] < lengths.numpy()[:, None]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy()[valid], np.swapaxes(np.asarray(r), 0, 1)[valid],
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("reverse", [False, True])
def test_sliced_train_fwd_matches_pallas(reverse):
    R, T, H = 70, 6, 40
    plan = K.plan_persistent(R, 0, H, 24, dirs=1)
    xp, w_hh, _ = _inputs(R, T, H, torch.float32, 7)
    ref = jpl._train_forward(jnp.asarray(xp.numpy()), jnp.asarray(w_hh.numpy()), reverse, 0,
                             True)
    got = K.lstm_train_fwd_sliced_plain(xp, K.pack_scan_weights(w_hh, plan), plan, reverse)
    for g, r in zip(got, ref):  # the Pallas residuals are time-major
        np.testing.assert_allclose(g.numpy(), np.swapaxes(np.asarray(r), 0, 1), atol=1e-5,
                                   rtol=0)


def test_sliced_revmasked_train_fwd_matches_pallas():
    R, T, H = 70, 6, 40
    plan = K.plan_persistent(R, 0, H, 24, dirs=1)
    xp, w_hh, lengths = _inputs(R, T, H, torch.float32, 8)
    ref = jpl._train_forward_revmasked(jnp.asarray(xp.numpy()), jnp.asarray(w_hh.numpy()),
                                       jnp.asarray(lengths.numpy()), 0, True)
    got = K.lstm_revmasked_train_fwd_sliced_plain(xp, K.pack_scan_weights(w_hh, plan), lengths,
                                                  plan)
    valid = np.arange(T)[None, :] < lengths.numpy()[:, None]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy()[valid], np.swapaxes(np.asarray(r), 0, 1)[valid],
                                   atol=1e-5, rtol=0)


def _stores_masked_c(res, lengths):
    """A sliced K6 that stores the value it carries (c zeroed after each
    step t >= lengths[r]) where the step's unmasked c is due."""
    h, gates, c = res
    T = c.shape[1]
    keep = (torch.arange(T)[None, :] < lengths[:, None]).to(c.dtype)
    return h, gates, c * keep[..., None]


def test_mask_trap_shows_only_at_padded_steps():
    """The K6p fault the card checks compare every step for: storing the
    masked c equals the plain version at the valid steps, so a check of the
    valid steps alone passes it, and misses it by far at the padded ones."""
    R, T, H = 70, 6, 40
    plan = K.plan_persistent(R, 0, H, 24, dirs=1)
    xp, w_hh, lengths = _inputs(R, T, H, torch.float32, 9)
    ref = K.lstm_revmasked_train_fwd_plain(xp, w_hh, lengths)
    good = K.lstm_revmasked_train_fwd_sliced_plain(xp, K.pack_scan_weights(w_hh, plan), lengths,
                                                   plan)
    bad = _stores_masked_c(good, lengths)
    valid = torch.arange(T)[None, :] < lengths[:, None]
    assert float((bad[2] - ref[2])[valid].abs().max()) < 1e-6
    assert float((bad[2] - ref[2])[~valid].abs().max()) > 1e-2
    assert _max_err(good, ref) < 1e-6


def test_planted_stale_h_exceeds_the_limit_only_after_the_first_step():
    """The training forwards' barrier fault: the plain walk fed h one step
    stale returns the plain residuals at the first step and leaves them by
    more than ``ulp_limit`` of each plain output over the walk (bfloat16);
    its h is the inference fault's."""
    R, T, H = 21, 9, 24
    xp, w_hh, lengths = _inputs(R, T, H, torch.bfloat16, 10)
    lengths[0] = T
    for reverse in (False, True):
        ref = K.lstm_train_fwd_plain(xp, w_hh, reverse)
        stale = PC.lstm_scan_stale_h(xp, w_hh, reverse, residuals=True)
        assert torch.equal(stale[0], PC.lstm_scan_stale_h(xp, w_hh, reverse))
        first = T - 1 if reverse else 0
        for name, s, r in zip(RESIDUALS, stale, ref):
            assert torch.equal(s[:, first], r[:, first]), name
            assert float((s.float() - r.float()).abs().max()) >= PC.ulp_limit(r), name
    ref = K.lstm_revmasked_train_fwd_plain(xp, w_hh, lengths)
    stale = PC.lstm_scan_stale_h(xp, w_hh, True, lengths, residuals=True)
    for name, s, r in zip(RESIDUALS, stale, ref):
        assert torch.equal(s[:, T - 1], r[:, T - 1]), name
        assert float((s.float() - r.float()).abs().max()) >= PC.ulp_limit(r), name


def test_tf32_rounds_to_nearest_ties_away():
    """``persistent_checks.tf32`` keeps 10 mantissa bits, rounding as
    ``cvt.rna.tf32.f32``: to nearest, ties away from zero."""
    u = 2.0 ** -10  # one TF32 ulp at 1
    x = torch.tensor([1 + u / 2, 1 + u / 4, 1 + 3 * u / 4, -(1 + u / 2), 1 + 3 * u / 2, 0.0,
                      3.0e-3 * (1 + u / 2)])
    want = torch.tensor([1 + u, 1.0, 1 + u, -(1 + u), 1 + 2 * u, 0.0, 3.0e-3 * (1 + u / 2)])
    got = PC.tf32(x)
    assert torch.equal(got[:6], want[:6])
    assert float((got[6] - want[6]).abs()) <= 3.0e-3 * u / 2
    assert not (got.view(torch.int32) & 0x1FFF).any()


def _split_tf32(x):
    """The kernel's operand split: hi = x with its low 13 mantissa bits
    cleared, lo = x - hi cleared the same way."""
    def head(v):
        return (v.contiguous().view(torch.int32) & -0x2000).view(torch.float32)
    hi = head(x)
    return hi, head(x - hi)


def _three_tf32(stale, h, w):
    """K4p-f32's product on the CPU: a_lo b_hi + a_hi b_lo summed apart,
    then added to a_hi b_hi (each TF32 product exact in float32)."""
    (ah, al), (bh, bl) = _split_tf32(h), _split_tf32(w)
    return (al @ bh + ah @ bl) + ah @ bh


@pytest.mark.parametrize("kind", ["fwd", "rev", "masked"])
@pytest.mark.parametrize("R,T,H", [(20, 64, 197), (24, 201, 392)], ids=str)
def test_f32_limit_holds_3xtf32_and_refuses_one_tf32_product(R, T, H, kind):
    """F32_LIMIT between the float32 route's arithmetic and one TF32 product:
    the walk with the kernel's 3xTF32 product stays within it of the plain
    version in h, gates and c, the walk with one TF32 product
    (``persistent_checks.lstm_scan_tf32``, the card checks' control) leaves
    it in each."""
    xp, w_hh, lengths = _inputs(R, T, H, torch.float32, 12)
    reverse, lens = kind != "fwd", (lengths if kind == "masked" else None)
    if lens is None:
        ref = K.lstm_train_fwd_plain(xp, w_hh, reverse)
    else:
        ref = K.lstm_revmasked_train_fwd_plain(xp, w_hh, lens)
    three = PC._scan_faulty(xp, w_hh, reverse, lens, True, _three_tf32)
    one = PC.lstm_scan_tf32(xp, w_hh, reverse, lens, residuals=True)
    for name, a, b, r in zip(RESIDUALS, three, one, ref):
        assert float((a - r).abs().max()) < PC.F32_LIMIT / 10, name
        assert float((b - r).abs().max()) >= PC.F32_LIMIT, name


def test_cpu_takes_the_plain_versions_without_counting():
    R, T, H = 37, 4, 24
    xp, w_hh, lengths = _inputs(R, T, H, torch.bfloat16, 11)
    K.reset_launch_counts()
    for reverse in (False, True):
        ref = K.lstm_train_fwd_plain(xp, w_hh, reverse)
        for fn in (K.lstm_train_fwd, K.lstm_train_fwd_walk, K.lstm_train_fwd_persistent):
            assert all(torch.equal(g, r) for g, r in zip(fn(xp, w_hh, reverse), ref))
    ref = K.lstm_revmasked_train_fwd_plain(xp, w_hh, lengths)
    for fn in (K.lstm_revmasked_train_fwd, K.lstm_revmasked_train_fwd_walk,
               K.lstm_revmasked_train_fwd_persistent):
        assert all(torch.equal(g, r) for g, r in zip(fn(xp, w_hh, lengths), ref))
    assert set(K.launch_counts().values()) == {0}
    for name in ("lstm_train_fwd", "lstm_revmasked_train_fwd"):
        assert K.route_counts(name) == {"persistent": 0, "walk": 0}


def _kernel_names(flags, mangled_t, demangled_t):
    mangled = ("_ZN12_GLOBAL__N_122scan_persistent_kernelI" + mangled_t
               + "".join(f"Lb{f}E" for f in flags) + "EEvNS_8ScanArgsIT_EE")
    demangled = (f"(anonymous namespace)::scan_persistent_kernel<{demangled_t}, "
                 + ", ".join("true" if f else "false" for f in flags)
                 + f">((anonymous namespace)::ScanArgs<{demangled_t}>)")
    return mangled, demangled


@pytest.mark.parametrize("flags,group", [
    ((0, 0, 0), "K2p lstm_scan_persistent"), ((1, 0, 0), "K2p lstm_scan_persistent"),
    ((1, 1, 0), "K3p lstm_revmasked_persistent"), ((0, 0, 1), "K4p lstm_train_fwd_persistent"),
    ((1, 0, 1), "K4p lstm_train_fwd_persistent"),
    ((1, 1, 1), "K6p lstm_revmasked_train_fwd_persistent")])
def test_profiler_groups_each_persistent_instance(flags, group):
    """profile_forward files scan_persistent_kernel<bf16, REVERSE, MASKED,
    STORE> under its own kernel, from the mangled name and the demangled
    one."""
    from urgent2026_challenge_track1_tpu_torch.profile_forward import _group

    mangled, demangled = _kernel_names(flags, "13__nv_bfloat16", "__nv_bfloat16")
    assert _group(mangled) == _group(demangled) == group


@pytest.mark.parametrize("flags,group", [
    ((0, 0, 1), "K4p-f32 lstm_train_fwd_persistent"),
    ((1, 0, 1), "K4p-f32 lstm_train_fwd_persistent"),
    ((1, 1, 1), "K6p-f32 lstm_revmasked_train_fwd_persistent")])
def test_profiler_groups_the_f32_instances(flags, group):
    """The float32 route's instances (K4p and K6p only) under their own
    names."""
    from urgent2026_challenge_track1_tpu_torch.profile_forward import _group

    mangled, demangled = _kernel_names(flags, "f", "float")
    assert _group(mangled) == _group(demangled) == group
