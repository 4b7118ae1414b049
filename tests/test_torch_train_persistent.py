"""K4p and K6p, the persistent weight-stationary routes of the training
forwards K4 and K6, on the CPU: the route rule, the plain sliced walks that
read only the packed W_hh slices and return the residuals (h, gates, c), the
mask trap of K6p (the stored c is the step's unmasked c, not the masked one
it carries) and the planted stale-h fault that the card checks must see.
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
    """K4 and K6 take K2p's rule, ``scan_route``: bf16 with a one-direction
    plan takes the persistent route, float32 and shapes without a plan the
    walk."""
    for R, H in TRAIN_SHAPES:
        assert K.scan_route(torch.float32, R, H, SMS) is None
        plan = K.scan_route(torch.bfloat16, R, H, SMS)
        assert plan == K.plan_persistent(R, 0, H, SMS, dirs=1) and plan.ctas <= SMS
    assert K.scan_route(torch.bfloat16, 10, 8000, SMS) is None


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


@pytest.mark.parametrize("flags,group", [
    ((0, 0, 0), "K2p lstm_scan_persistent"), ((1, 0, 0), "K2p lstm_scan_persistent"),
    ((1, 1, 0), "K3p lstm_revmasked_persistent"), ((0, 0, 1), "K4p lstm_train_fwd_persistent"),
    ((1, 0, 1), "K4p lstm_train_fwd_persistent"),
    ((1, 1, 1), "K6p lstm_revmasked_train_fwd_persistent")])
def test_profiler_groups_each_persistent_instance(flags, group):
    """profile_forward files scan_persistent_kernel<REVERSE, MASKED, STORE>
    under its own kernel, from the mangled name and the demangled one."""
    from urgent2026_challenge_track1_tpu_torch.profile_forward import _group

    mangled = ("_ZN12_GLOBAL__N_122scan_persistent_kernelI"
               + "".join(f"Lb{f}E" for f in flags) + "EEvNS_8ScanArgsE")
    demangled = ("(anonymous namespace)::scan_persistent_kernel<"
                 + ", ".join("true" if f else "false" for f in flags)
                 + ">((anonymous namespace)::ScanArgs)")
    assert _group(mangled) == _group(demangled) == group
