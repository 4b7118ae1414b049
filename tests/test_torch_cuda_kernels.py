"""The port's CUDA kernels on the card: each against its plain version, the
launch counters, the wrappers' input checks and a small forward, card vs
CPU.  Every test needs an NVIDIA GPU and skips without one.  The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm
from urgent2026_challenge_track1_tpu_torch.ops.persistent_checks import (
    DW_F32_BOUND, F32_LIMIT, bwd_limit, carry_failures, fusedin_bilstm_stale_h,
    fusedin_bilstm_tf32, lstm_scan_stale_h, lstm_scan_tf32, lstm_train_bwd_stale_dg,
    lstm_train_bwd_tf32, lstm_train_fwd_streamin_stale_h, lstm_train_fwd_streamin_tf32,
    persistent_limit, scan_carry_report, tf32, ulp_limit)

torch.set_num_threads(1)
R, T, N, H = 13, 11, 40, 72  # H not a multiple of 32, R not of any row tile
TOLS = {torch.float32: 2e-4, torch.bfloat16: 5e-2}  # scripts/check_pallas_tpu.py:29-34

pytestmark = pytest.mark.cuda


@pytest.fixture(params=[1, 2, 4, 8], ids=lambda r: f"rows{r}")
def rows(request, monkeypatch):
    """Force each row tile of the kernels (the wrapper's own choice depends
    on R and the card's SM count)."""
    monkeypatch.setattr(cuda_lstm, "rows_per_block", lambda *_: request.param)
    return request.param


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _t(rng, dev, dtype, *shape, scale=0.3):
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(
        dev, dtype)


def _lengths(dev):
    return torch.tensor([1, T, 4, 7, T - 1, 2, 3, 5, 6, 8, 9, 10, 11], dtype=torch.int32,
                        device=dev)


def _err(a, b):
    torch.cuda.synchronize()
    return float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fusedin_matches_plain(dev, dtype, rows):
    """K1's walk at every row tile (bfloat16 takes K1p by default)."""
    rng = np.random.default_rng(0)
    x, wi, wh, b = (_t(rng, dev, dtype, R, T, N), _t(rng, dev, dtype, 2, N, 4 * H),
                    _t(rng, dev, dtype, 2, H, 4 * H), _t(rng, dev, dtype, 2, 4 * H))
    got = cuda_lstm.fusedin_bilstm_walk(x, wi, wh, b)
    assert got.shape == (R, T, 2 * H) and got.dtype == dtype
    assert _err(got, cuda_lstm.fusedin_bilstm_plain(x, wi, wh, b)) < TOLS[dtype]


# --- K1p: the persistent route of K1 (bfloat16) -----------------------------
# K1p, K2p and K3p are held within ulp_limit (4 bf16 ulps at the plain
# output's largest magnitude, as in chip_smoke.py), a limit that a planted
# stale h (persistent_checks) must exceed


def _k1_inputs(dev, R_, T_, N_, H_, seed, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    w = H_ ** -0.5  # the LSTM init's scale
    return (_t(rng, dev, dtype, R_, T_, N_),
            _t(rng, dev, dtype, 2, N_, 4 * H_, scale=w),
            _t(rng, dev, dtype, 2, H_, 4 * H_, scale=w),
            _t(rng, dev, dtype, 2, 4 * H_, scale=w))


@pytest.mark.parametrize("shape", [(R, T, N, H), (13, 7, 33, 20), (21, 5, 34, 44),
                                   (401, 34, 196, 392), (48, 501, 384, 768)],
                         ids=["small", "odd_n", "n_mod4", "disc_band", "flow_time"])
def test_persistent_matches_plain(dev, shape):
    """K1p against the plain version in bfloat16 within 4 ulps at the
    outputs' scale, a limit that a stale h exceeds: ragged small shapes
    (rows whose addresses allow 16-, 4- or 2-byte staging), the
    discriminative band path (401 x 34) and the flow time path (48 x 501)."""
    x, wi, wh, b = _k1_inputs(dev, *shape, seed=15)
    cuda_lstm.reset_launch_counts()
    got = cuda_lstm.fusedin_bilstm(x, wi, wh, b)
    assert cuda_lstm.route_counts() == {"persistent": 1, "walk": 0, "persistent_split": 0}
    assert got.shape == (shape[0], shape[1], 2 * shape[3]) and got.dtype == torch.bfloat16
    ref = cuda_lstm.fusedin_bilstm_plain(x, wi, wh, b)
    limit = ulp_limit(ref)
    assert _err(got, ref) < limit
    assert _err(fusedin_bilstm_stale_h(x, wi, wh, b), ref) >= limit


def test_route_follows_the_dtype(dev):
    """float32 takes K1p-f32 (one grid where a two-direction plan fits, a
    launch a direction at the flow width, the walk where no plan fits: H =
    1020), bfloat16 K1p; each launch counts as a K1 launch; K1p refuses
    float16."""
    x, wi, wh, b = _k1_inputs(dev, R, T, N, H, seed=16)
    cuda_lstm.reset_launch_counts()
    cuda_lstm.fusedin_bilstm(x.float(), wi.float(), wh.float(), b.float())
    assert cuda_lstm.route_counts() == {"persistent": 1, "walk": 0, "persistent_split": 0}
    cuda_lstm.fusedin_bilstm(x, wi, wh, b)
    assert cuda_lstm.route_counts() == {"persistent": 2, "walk": 0, "persistent_split": 0}
    flow = _k1_inputs(dev, 5, 3, 384, 768, seed=18, dtype=torch.float32)
    cuda_lstm.fusedin_bilstm(*flow)
    assert cuda_lstm.route_counts() == {"persistent": 2, "walk": 0, "persistent_split": 2}
    wide = _k1_inputs(dev, 4, 3, 510, 1020, seed=19, dtype=torch.float32)
    cuda_lstm.fusedin_bilstm(*wide)
    assert cuda_lstm.route_counts() == {"persistent": 2, "walk": 1, "persistent_split": 2}
    assert cuda_lstm.launch_counts()["fusedin_bilstm"] == 5
    with pytest.raises(TypeError):
        cuda_lstm.fusedin_bilstm_persistent(x.half(), wi.half(), wh.half(), b.half())


def test_persistent_refuses_a_grid_the_card_cannot_hold(dev):
    """A plan of more CTAs than the card holds resident is refused at launch
    (cudaErrorCooperativeLaunchTooLarge) instead of hanging in the barrier;
    the next launch runs."""
    import dataclasses

    x, wi, wh, b = _k1_inputs(dev, 400, 3, 40, 72, seed=17)
    plan = cuda_lstm.plan_persistent(400, 40, 72, 132)
    big = dataclasses.replace(plan, G=100, rows=4, S=18, U=4)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert big.ctas > sms
    cuda_lstm.reset_launch_counts()
    with pytest.raises(RuntimeError):
        cuda_lstm.fusedin_bilstm_persistent(x, wi, wh, b, big)
    torch.cuda.synchronize()
    assert cuda_lstm.route_counts() == {"persistent": 0, "walk": 0, "persistent_split": 0}
    got = cuda_lstm.fusedin_bilstm_persistent(x, wi, wh, b)
    ref = cuda_lstm.fusedin_bilstm_plain(x, wi, wh, b)
    assert _err(got, ref) < ulp_limit(ref)


# --- K1p-f32: the persistent route of K1 in float32 (3xTF32) ---------------
# held within F32_LIMIT of the plain version, a limit that the stale-h
# fault and the walk with one TF32 product (both products) must exceed.
# Shapes: small and odd N / H (x staged in 16-, 4- and 8-byte copies, h in
# 16-byte L2-only copies or plain L2 loads), the disc band (one grid), the
# SGMSE / no-lengths time path, the flow band and time path (a launch a
# direction)

K1F32_SHAPES = [(R, T, N, H), (13, 7, 37, 46), (21, 5, 38, 20), (401, 34, 196, 392),
                (34, 401, 196, 392), (502, 48, 384, 768), (48, 501, 384, 768)]
K1F32_IDS = ["small", "odd", "n_mod4", "disc_band", "disc_time", "flow_band", "flow_time"]


@pytest.mark.parametrize("shape", K1F32_SHAPES, ids=K1F32_IDS)
def test_persistent_f32_matches_plain(dev, shape):
    """K1p-f32 through the routed wrapper: within F32_LIMIT of the plain
    version at every step, which a stale h and one TF32 product exceed; one
    grid where a two-direction float32 plan fits, else two launches."""
    x, wi, wh, b = _k1_inputs(dev, *shape, seed=20, dtype=torch.float32)
    R_, _, N_, H_ = shape
    plan = cuda_lstm.k1_route(torch.float32, R_, N_, H_, cuda_lstm._sm_count(dev.index or 0))
    assert plan is not None and plan.elem == 4
    cuda_lstm.reset_launch_counts()
    got = cuda_lstm.fusedin_bilstm(x, wi, wh, b)
    split = 2 if plan.dirs == 1 else 0
    assert cuda_lstm.route_counts() == {"persistent": 1 - split // 2, "walk": 0,
                                        "persistent_split": split}
    assert got.shape == (R_, shape[1], 2 * H_) and got.dtype == torch.float32
    ref = cuda_lstm.fusedin_bilstm_plain(x, wi, wh, b)
    assert persistent_limit(ref) == F32_LIMIT
    assert _err(got, ref) < F32_LIMIT
    assert _err(fusedin_bilstm_stale_h(x, wi, wh, b), ref) >= F32_LIMIT
    assert _err(fusedin_bilstm_tf32(x, wi, wh, b), ref) >= F32_LIMIT


@pytest.mark.parametrize("shape", [(401, 34, 196, 392), (502, 48, 384, 768)],
                         ids=["disc_band", "flow_band"])
def test_persistent_f32_is_deterministic(dev, shape):
    """Two K1p-f32 calls are bitwise equal, one grid (disc band) or a
    launch a direction (flow band)."""
    x, wi, wh, b = _k1_inputs(dev, *shape, seed=21, dtype=torch.float32)
    a = cuda_lstm.fusedin_bilstm_persistent(x, wi, wh, b)
    c = cuda_lstm.fusedin_bilstm_persistent(x, wi, wh, b)
    torch.cuda.synchronize()
    assert torch.equal(a, c)


def test_persistent_f32_pair_equals_one_grid(dev):
    """At a shape with both plans, the one-direction pair (dirs = 1, its
    own partition) and the two-direction grid agree within F32_LIMIT."""
    import dataclasses

    x, wi, wh, b = _k1_inputs(dev, 34, 40, 196, 392, seed=22, dtype=torch.float32)
    two = cuda_lstm.plan_persistent(34, 196, 392, 132, elem=4)
    pair = dataclasses.replace(two, dirs=1)
    got = cuda_lstm.fusedin_bilstm_persistent(x, wi, wh, b, pair)
    want = cuda_lstm.fusedin_bilstm_persistent(x, wi, wh, b, two)
    assert _err(got, want) < F32_LIMIT


def test_f32_fusedin_plan_bytes_equal_the_kernels(dev):
    """The planner's bytes of the float32 fused-input plans (K1p-f32,
    K8p-f32: a slice of 4U floats a row, no pad) are the kernel's own."""
    from urgent2026_challenge_track1_tpu_torch.ops._build import load_library

    lib = load_library()
    for R_, N_, H_, dirs in ((401, 196, 392, 2), (34, 196, 392, 2), (502, 384, 768, 1),
                             (136, 196, 392, 1), (804, 196, 392, 1), (13, 37, 46, 2)):
        plan = cuda_lstm.plan_persistent(R_, N_, H_, 132, dirs=dirs, elem=4)
        assert lib.lstm_persistent_smem(N_, H_, plan.U, plan.rows, plan.chunk,
                                        int(plan.c_in_smem), 4) == plan.smem


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_matches_plain(dev, dtype, reverse, rows):
    """K2's walk at every row tile (bfloat16 takes K2p by default)."""
    rng = np.random.default_rng(1)
    xp, wh = _t(rng, dev, dtype, R, T, 4 * H), _t(rng, dev, dtype, H, 4 * H)
    got = cuda_lstm.lstm_scan_walk(xp, wh, reverse)
    assert _err(got, cuda_lstm.lstm_scan_plain(xp, wh, reverse)) < TOLS[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_revmasked_matches_plain_at_valid_steps(dev, dtype, rows):
    """K3's walk at every row tile (bfloat16 takes K3p by default)."""
    rng = np.random.default_rng(2)
    xp, wh = _t(rng, dev, dtype, R, T, 4 * H), _t(rng, dev, dtype, H, 4 * H)
    lengths = _lengths(dev)
    valid = torch.arange(T, device=dev)[None, :] < lengths[:, None]
    got = cuda_lstm.lstm_revmasked_walk(xp, wh, lengths)[valid]
    assert _err(got, cuda_lstm.lstm_revmasked_plain(xp, wh, lengths)[valid]) < TOLS[dtype]


# --- K2p and K3p: the persistent routes of K2 and K3 (bfloat16) -------------


def _scan_inputs(dev, R_, T_, H_, seed):
    rng = np.random.default_rng(seed)
    xp = _t(rng, dev, torch.bfloat16, R_, T_, 4 * H_, scale=0.5)
    wh = _t(rng, dev, torch.bfloat16, H_, 4 * H_, scale=H_ ** -0.5)
    lengths = torch.from_numpy(rng.integers(1, T_ + 1, R_).astype(np.int32)).to(dev)
    lengths[0], lengths[-1] = 1, T_
    return xp, wh, lengths


# (R, T, H): small, H odd (2-byte copies of x_proj and h), H = 2 mod 4
# (4-byte copies), the one-utterance time path (34 x 401 at H = 392) and the
# flow model's (48 x 251 at H = 768)
SCAN_SHAPES = [(R, T, H), (13, 9, 37), (21, 7, 46), (34, 401, 392), (48, 251, 768)]
SCAN_IDS = ["small", "odd_h", "h_mod4", "disc_time", "flow_time"]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", SCAN_SHAPES, ids=SCAN_IDS)
def test_scan_persistent_matches_plain(dev, shape, reverse):
    """K2p against the plain version at every step within 4 bf16 ulps at
    the outputs' scale, a limit that a stale h exceeds."""
    xp, wh, _ = _scan_inputs(dev, *shape, seed=18)
    cuda_lstm.reset_launch_counts()
    got = cuda_lstm.lstm_scan(xp, wh, reverse)
    assert cuda_lstm.route_counts("lstm_scan") == {"persistent": 1, "walk": 0}
    assert got.shape == (shape[0], shape[1], shape[2]) and got.dtype == torch.bfloat16
    ref = cuda_lstm.lstm_scan_plain(xp, wh, reverse)
    limit = ulp_limit(ref)
    assert _err(got, ref) < limit
    assert _err(lstm_scan_stale_h(xp, wh, reverse), ref) >= limit


@pytest.mark.parametrize("shape", SCAN_SHAPES, ids=SCAN_IDS)
def test_revmasked_persistent_matches_plain_at_every_step(dev, shape):
    """K3p against the plain version at every step, padded ones included
    (the reader masks h, so out holds the plain version's unmasked h), within
    4 bf16 ulps; a stale h exceeds the limit."""
    xp, wh, lengths = _scan_inputs(dev, *shape, seed=19)
    cuda_lstm.reset_launch_counts()
    got = cuda_lstm.lstm_revmasked(xp, wh, lengths)
    assert cuda_lstm.route_counts("lstm_revmasked") == {"persistent": 1, "walk": 0}
    ref = cuda_lstm.lstm_revmasked_plain(xp, wh, lengths)
    limit = ulp_limit(ref)
    assert _err(got, ref) < limit
    assert _err(lstm_scan_stale_h(xp, wh, True, lengths), ref) >= limit


# --- K2p-f32 and K3p-f32: the float32 routes of K2 and K3 (3xTF32) -------
# Held within F32_LIMIT of the plain version at every step, a limit that the
# stale-h fault and the walk with one TF32 product (lstm_scan_tf32) exceed;
# K2p's shapes and the flow validation pass's time path (2 x 48 bands over
# 251 frames at H = 768: 16-row chunks, c in global memory)
SCAN_F32_SHAPES = SCAN_SHAPES + [(96, 251, 768)]
SCAN_F32_IDS = SCAN_IDS + ["flow_valid"]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", SCAN_F32_SHAPES, ids=SCAN_F32_IDS)
def test_scan_persistent_f32_matches_plain(dev, shape, reverse):
    """K2p-f32 through the routed wrapper against the plain version at
    every step within F32_LIMIT; a stale h and one TF32 product exceed it."""
    xp, wh = _f32(*_scan_inputs(dev, *shape, seed=44)[:2])
    cuda_lstm.reset_launch_counts()
    got = cuda_lstm.lstm_scan(xp, wh, reverse)
    assert cuda_lstm.route_counts("lstm_scan") == {"persistent": 1, "walk": 0}
    assert got.shape == tuple(shape) and got.dtype == torch.float32
    ref = cuda_lstm.lstm_scan_plain(xp, wh, reverse)
    assert persistent_limit(ref) == F32_LIMIT
    assert _err(got, ref) < F32_LIMIT
    assert _err(lstm_scan_stale_h(xp, wh, reverse), ref) >= F32_LIMIT
    assert _err(lstm_scan_tf32(xp, wh, reverse), ref) >= F32_LIMIT


@pytest.mark.parametrize("shape", SCAN_F32_SHAPES, ids=SCAN_F32_IDS)
def test_revmasked_persistent_f32_matches_plain_at_every_step(dev, shape):
    """K3p-f32 through the routed wrapper at every step, padded ones
    included, within F32_LIMIT; a stale h and one TF32 product exceed it."""
    xp, wh, lengths = _scan_inputs(dev, *shape, seed=45)
    xp, wh = _f32(xp, wh)
    cuda_lstm.reset_launch_counts()
    got = cuda_lstm.lstm_revmasked(xp, wh, lengths)
    assert cuda_lstm.route_counts("lstm_revmasked") == {"persistent": 1, "walk": 0}
    ref = cuda_lstm.lstm_revmasked_plain(xp, wh, lengths)
    assert _err(got, ref) < F32_LIMIT
    assert _err(lstm_scan_stale_h(xp, wh, True, lengths), ref) >= F32_LIMIT
    assert _err(lstm_scan_tf32(xp, wh, True, lengths), ref) >= F32_LIMIT


def test_scan_persistent_f32_is_deterministic(dev):
    """Two launches of K2p-f32 (both directions) and of K3p-f32 at the flow
    validation shape are bitwise equal."""
    xp, wh, lengths = _scan_inputs(dev, 96, 251, 768, seed=46)
    xp, wh = _f32(xp, wh)
    for run in (lambda: cuda_lstm.lstm_scan_persistent(xp, wh, False),
                lambda: cuda_lstm.lstm_scan_persistent(xp, wh, True),
                lambda: cuda_lstm.lstm_revmasked_persistent(xp, wh, lengths)):
        a, b = run(), run()
        torch.cuda.synchronize()
        assert torch.equal(a, b)


# --- K2 with a carry: (h0, c0) in, (hT, cT) out (the streaming step's time
# path); the streaming step (34 rows x 8 frames at H = 392), the offline
# causal time path (34 x 401) and the odd-H shapes; K2p (bfloat16) and
# K2p-f32 through the routed wrapper, the float32 walk called by name
CARRY_SHAPES = [(34, 8, 392), (34, 401, 392), (13, 9, 37), (21, 7, 46)]
CARRY_IDS = ["stream_step", "offline_causal", "odd_h", "h_mod4"]


def _carry_inputs(dev, shape, dtype, seed):
    xp, wh, _ = _scan_inputs(dev, *shape, seed=seed)
    rng = np.random.default_rng(seed + 1)
    h0 = _t(rng, dev, dtype, shape[0], shape[2], scale=0.5)
    c0 = _t(rng, dev, torch.float32, shape[0], shape[2], scale=0.5)
    return xp.to(dtype), wh.to(dtype), (h0, c0)


# (route id, dtype, K2 with a carry): the routed wrapper (K2p, K2p-f32) or
# the float32 walk by name
CARRY_ROUTES = {"k2p": (torch.bfloat16, cuda_lstm.lstm_scan),
                "walk_f32": (torch.float32, cuda_lstm.lstm_scan_walk),
                "k2p_f32": (torch.float32, cuda_lstm.lstm_scan)}


@pytest.mark.parametrize("route", list(CARRY_ROUTES))
@pytest.mark.parametrize("shape", CARRY_SHAPES, ids=CARRY_IDS)
def test_scan_carry_matches_plain(dev, shape, route):
    """K2p (bfloat16), K2p-f32 and the float32 walk started from (h0, c0):
    h at every step, hT and cT within the limits of ``scan_carry_report``
    (F32_LIMIT on K2p-f32, the walk's 2e-4 on the walk), hT the kernel's
    own last h, and a dropped carry beyond the limit."""
    dtype, fn = CARRY_ROUTES[route]
    xp, wh, carry = _carry_inputs(dev, shape, dtype, 40)
    cuda_lstm.reset_launch_counts()
    got, state = fn(xp, wh, False, initial_state=carry, return_state=True)
    kind = "walk" if route == "walk_f32" else "persistent"
    assert cuda_lstm.route_counts("lstm_scan") == {"persistent": 0, "walk": 0, kind: 1}
    assert state[0].dtype == dtype and state[1].dtype == torch.float32
    report = scan_carry_report(got, state, xp, wh, False, carry, walk=kind == "walk")
    if route == "k2p_f32":
        assert report["limit"] == report["c_limit"] == F32_LIMIT
    assert not carry_failures(report), report


@pytest.mark.parametrize("route", list(CARRY_ROUTES))
def test_scan_zero_carry_equals_no_carry(dev, route):
    """A zero carry in is the launch without one, bitwise; the carried
    launch's return_state alone leaves h unchanged."""
    dtype, fn = CARRY_ROUTES[route]
    xp, wh, (h0, c0) = _carry_inputs(dev, (34, 33, 392), dtype, 42)
    plain = fn(xp, wh)
    zero = (torch.zeros_like(h0), torch.zeros_like(c0))
    got, _ = fn(xp, wh, initial_state=zero, return_state=True)
    assert torch.equal(got, plain)
    assert torch.equal(fn(xp, wh, return_state=True)[0], plain)


@pytest.mark.parametrize("route", list(CARRY_ROUTES))
def test_scan_carry_chained_chunks_equal_one_launch(dev, route):
    """8-frame chunks chained through the carry against one launch over all
    frames (the offline causal time path): within the kernel's limit
    against the plain version, and bitwise on K2p-f32 (its plan depends on
    R and H only, so each step's arithmetic is one launch's)."""
    dtype, fn = CARRY_ROUTES[route]
    xp, wh, _ = _carry_inputs(dev, (34, 41, 392), dtype, 43)
    one = fn(xp, wh)
    state, outs = None, []
    for t0 in range(0, 41, 8):
        y, state = fn(xp[:, t0:t0 + 8].contiguous(), wh, initial_state=state,
                      return_state=True)
        outs.append(y)
    ref = cuda_lstm.lstm_scan_plain(xp, wh)
    limit = ulp_limit(ref) if dtype == torch.bfloat16 else TOLS[torch.float32]
    assert _err(torch.cat(outs, dim=1), one) < limit
    if route == "k2p_f32":
        assert torch.equal(torch.cat(outs, dim=1), one)


def test_scan_route_follows_the_dtype(dev):
    """float32 takes K2p-f32 / K3p-f32 where a plan fits and the walks where
    none does (H = 1020), bfloat16 K2p/K3p; each counts as a K2 or K3
    launch."""
    xp, wh, lengths = _scan_inputs(dev, R, T, H, seed=20)
    wide, wide_w, wide_len = _scan_inputs(dev, 3, 4, 1020, seed=21)
    assert cuda_lstm.scan_route(torch.float32, 3, 1020, cuda_lstm._sm_count(dev.index or 0)) \
        is None
    cuda_lstm.reset_launch_counts()
    cuda_lstm.lstm_scan(xp.float(), wh.float())
    cuda_lstm.lstm_revmasked(xp.float(), wh.float(), lengths)
    cuda_lstm.lstm_scan(xp, wh)
    cuda_lstm.lstm_revmasked(xp, wh, lengths)
    cuda_lstm.lstm_scan(wide.float(), wide_w.float())
    cuda_lstm.lstm_revmasked(wide.float(), wide_w.float(), wide_len)
    for name in ("lstm_scan", "lstm_revmasked"):
        assert cuda_lstm.route_counts(name) == {"persistent": 2, "walk": 1}
        assert cuda_lstm.launch_counts()[name] == 3


def test_scan_persistent_refuses_a_grid_the_card_cannot_hold(dev):
    """A K2p/K3p plan of more CTAs than the card holds resident is refused
    at launch instead of hanging in the barrier; the next launch runs."""
    import dataclasses

    xp, wh, lengths = _scan_inputs(dev, 400, 3, 72, seed=21)
    plan = cuda_lstm.plan_persistent(400, 0, 72, 132, dirs=1)
    big = dataclasses.replace(plan, G=100, rows=4, S=18, U=4)
    assert big.ctas > torch.cuda.get_device_properties(dev).multi_processor_count
    cuda_lstm.reset_launch_counts()
    with pytest.raises(RuntimeError):
        cuda_lstm.lstm_scan_persistent(xp, wh, False, big)
    with pytest.raises(RuntimeError):
        cuda_lstm.lstm_revmasked_persistent(xp, wh, lengths, big)
    torch.cuda.synchronize()
    assert cuda_lstm.route_counts("lstm_scan") == {"persistent": 0, "walk": 0}
    assert cuda_lstm.route_counts("lstm_revmasked") == {"persistent": 0, "walk": 0}
    got = cuda_lstm.lstm_revmasked_persistent(xp, wh, lengths)
    ref = cuda_lstm.lstm_revmasked_plain(xp, wh, lengths)
    assert _err(got, ref) < ulp_limit(ref)


def _train_inputs(rng, dev, dtype):
    return (_t(rng, dev, dtype, R, T, 4 * H), _t(rng, dev, dtype, H, 4 * H),
            _t(rng, dev, dtype, R, T, H))


def _rel(a, b):
    torch.cuda.synchronize()
    return float((a.float() - b.float()).abs().max() / (b.float().abs().max() + 1e-12))


# --- K4p and K6p: the persistent routes of K4 and K6 (bfloat16) -----------

# (R, T, H): small, H odd, H = 2 mod 4, the disc train step's time and band
# paths (136 x 201, 804 x 34 at H = 392) and the flow train step's (96 x 251,
# 502 x 48 at H = 768); K6 runs on the time paths only
TRAIN_SHAPES = [(R, T, H), (13, 9, 37), (21, 7, 46), (136, 201, 392), (804, 34, 392),
                (96, 251, 768), (502, 48, 768)]
TRAIN_IDS = ["small", "odd_h", "h_mod4", "disc_time", "disc_band", "flow_time", "flow_band"]
MASKED_SHAPES = [s for s, i in zip(TRAIN_SHAPES, TRAIN_IDS) if "band" not in i]
MASKED_IDS = [i for i in TRAIN_IDS if "band" not in i]


def _hold_residuals(got, ref, stale):
    """h, gates and c each within 4 bf16 ulps of its plain output at every
    step, a limit that the stale-h fault exceeds."""
    for g, r, f in zip(got, ref, stale):
        assert g.shape == r.shape and g.dtype == torch.bfloat16
        limit = ulp_limit(r)
        assert _err(g, r) < limit
        assert _err(f, r) >= limit


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", TRAIN_SHAPES, ids=TRAIN_IDS)
def test_train_fwd_persistent_matches_plain(dev, shape, reverse):
    """K4p against the plain version at every step; K5 on its residuals
    within bf16's tolerance of K5's plain version on the plain ones."""
    xp, wh, _ = _scan_inputs(dev, *shape, seed=22)
    dout = _t(np.random.default_rng(23), dev, torch.bfloat16, *shape)
    cuda_lstm.reset_launch_counts()
    got = cuda_lstm.lstm_train_fwd(xp, wh, reverse)
    assert cuda_lstm.route_counts("lstm_train_fwd") == {"persistent": 1, "walk": 0}
    ref = cuda_lstm.lstm_train_fwd_plain(xp, wh, reverse)
    _hold_residuals(got, ref, lstm_scan_stale_h(xp, wh, reverse, residuals=True))
    for g, r in zip(cuda_lstm.lstm_train_bwd(*got, dout, wh, reverse),
                    cuda_lstm.lstm_train_bwd_plain(*ref, dout, wh, reverse)):
        assert _rel(g, r) < TOLS[torch.bfloat16]


@pytest.mark.parametrize("shape", MASKED_SHAPES, ids=MASKED_IDS)
def test_revmasked_train_fwd_persistent_matches_plain_at_every_step(dev, shape):
    """K6p against the plain version at every step, padded ones included:
    the stored c is the step's unmasked c, not the masked one it carries;
    K7 on its residuals within bf16's tolerance of the plain chain."""
    xp, wh, lengths = _scan_inputs(dev, *shape, seed=24)
    valid = torch.arange(shape[1], device=dev)[None, :] < lengths[:, None]
    dout = _t(np.random.default_rng(25), dev, torch.bfloat16, *shape) * valid[..., None]
    cuda_lstm.reset_launch_counts()
    got = cuda_lstm.lstm_revmasked_train_fwd(xp, wh, lengths)
    assert cuda_lstm.route_counts("lstm_revmasked_train_fwd") == {"persistent": 1, "walk": 0}
    ref = cuda_lstm.lstm_revmasked_train_fwd_plain(xp, wh, lengths)
    _hold_residuals(got, ref, lstm_scan_stale_h(xp, wh, True, lengths, residuals=True))
    for g, r in zip(cuda_lstm.lstm_revmasked_bwd(*got, lengths, dout, wh),
                    cuda_lstm.lstm_revmasked_bwd_plain(*ref, lengths, dout, wh)):
        assert _rel(g, r) < TOLS[torch.bfloat16]


def test_train_persistent_is_deterministic(dev):
    """Two launches of K4p and of K6p are bitwise equal: bf16 remat runs the
    training forward twice and needs the same residuals."""
    xp, wh, lengths = _scan_inputs(dev, 136, 201, 392, seed=26)
    for run in (lambda: cuda_lstm.lstm_train_fwd_persistent(xp, wh, False),
                lambda: cuda_lstm.lstm_train_fwd_persistent(xp, wh, True),
                lambda: cuda_lstm.lstm_revmasked_train_fwd_persistent(xp, wh, lengths)):
        a, b = run(), run()
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_train_route_follows_the_dtype(dev):
    """K4 and K6 take K4p/K6p in bfloat16 and in float32 (the float32
    route), and the walks in float32 where no float32 plan fits (H = 1020);
    each counts as a K4 or K6 launch."""
    xp, wh, lengths = _scan_inputs(dev, R, T, H, seed=27)
    cuda_lstm.reset_launch_counts()
    cuda_lstm.lstm_train_fwd(xp.float(), wh.float())
    cuda_lstm.lstm_revmasked_train_fwd(xp.float(), wh.float(), lengths)
    cuda_lstm.lstm_train_fwd(xp, wh)
    cuda_lstm.lstm_revmasked_train_fwd(xp, wh, lengths)
    for name in ("lstm_train_fwd", "lstm_revmasked_train_fwd"):
        assert cuda_lstm.route_counts(name) == {"persistent": 2, "walk": 0}
        assert cuda_lstm.launch_counts()[name] == 2
    wide, wwide, lwide = _scan_inputs(dev, 3, 2, 1020, seed=27)
    assert cuda_lstm.scan_route(torch.float32, 3, 1020, 132) is None
    cuda_lstm.reset_launch_counts()
    cuda_lstm.lstm_train_fwd(wide.float(), wwide.float())
    cuda_lstm.lstm_revmasked_train_fwd(wide.float(), wwide.float(), lwide)
    for name in ("lstm_train_fwd", "lstm_revmasked_train_fwd"):
        assert cuda_lstm.route_counts(name) == {"persistent": 0, "walk": 1}


def test_train_persistent_refuses_a_grid_the_card_cannot_hold(dev):
    """A K4p/K6p plan of more CTAs than the card holds resident is refused
    at launch instead of hanging in the barrier; the next launch runs."""
    import dataclasses

    xp, wh, lengths = _scan_inputs(dev, 400, 3, 72, seed=28)
    plan = cuda_lstm.plan_persistent(400, 0, 72, 132, dirs=1)
    big = dataclasses.replace(plan, G=100, rows=4, S=18, U=4)
    assert big.ctas > torch.cuda.get_device_properties(dev).multi_processor_count
    cuda_lstm.reset_launch_counts()
    with pytest.raises(RuntimeError):
        cuda_lstm.lstm_train_fwd_persistent(xp, wh, False, big)
    with pytest.raises(RuntimeError):
        cuda_lstm.lstm_revmasked_train_fwd_persistent(xp, wh, lengths, big)
    torch.cuda.synchronize()
    assert cuda_lstm.route_counts("lstm_train_fwd") == {"persistent": 0, "walk": 0}
    assert cuda_lstm.route_counts("lstm_revmasked_train_fwd") == {"persistent": 0, "walk": 0}
    got = cuda_lstm.lstm_revmasked_train_fwd_persistent(xp, wh, lengths)
    ref = cuda_lstm.lstm_revmasked_train_fwd_plain(xp, wh, lengths)
    assert max(_err(g, r) / ulp_limit(r) for g, r in zip(got, ref)) < 1


# --- K4p and K6p's float32 route (3xTF32 products) ------------------------
# Held within F32_LIMIT (1e-5) of the plain version at every step, a limit
# that the stale-h fault exceeds, and at the train steps' shapes the walk
# with one TF32 product (lstm_scan_tf32) too; the small
# shapes stage the projection in 16-, 8- and 4-byte copies (H = 72, 46, 37)
# and h in 16-byte L2-only copies or plain L2 loads.


def _f32(*ts):
    return tuple(t.float() for t in ts)


def _hold_f32(got, ref, stale):
    for g, r, f in zip(got, ref, stale):
        assert g.shape == r.shape and g.dtype == torch.float32
        assert persistent_limit(r) == F32_LIMIT
        assert _err(g, r) < F32_LIMIT
        assert _err(f, r) >= F32_LIMIT


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", TRAIN_SHAPES, ids=TRAIN_IDS)
def test_train_fwd_persistent_f32_matches_plain(dev, shape, reverse):
    """K4p in float32 against the plain version at every step; K5 (its
    float32 walk) on its residuals within 1e-3 (relative) of the plain
    chain."""
    xp, wh = _f32(*_scan_inputs(dev, *shape, seed=35)[:2])
    dout = _t(np.random.default_rng(36), dev, torch.float32, *shape)
    cuda_lstm.reset_launch_counts()
    got = cuda_lstm.lstm_train_fwd(xp, wh, reverse)
    assert cuda_lstm.route_counts("lstm_train_fwd") == {"persistent": 1, "walk": 0}
    ref = cuda_lstm.lstm_train_fwd_plain(xp, wh, reverse)
    _hold_f32(got, ref, lstm_scan_stale_h(xp, wh, reverse, residuals=True))
    for g, r in zip(cuda_lstm.lstm_train_bwd(*got, dout, wh, reverse),
                    cuda_lstm.lstm_train_bwd_plain(*ref, dout, wh, reverse)):
        assert _rel(g, r) < 1e-3


@pytest.mark.parametrize("shape", MASKED_SHAPES, ids=MASKED_IDS)
def test_revmasked_train_fwd_persistent_f32_matches_plain_at_every_step(dev, shape):
    """K6p in float32 at every step, padded ones included (the mask trap:
    the stored c is the step's unmasked c); K7 on its residuals within 1e-3
    of the plain chain."""
    xp, wh, lengths = _scan_inputs(dev, *shape, seed=37)
    xp, wh = _f32(xp, wh)
    valid = torch.arange(shape[1], device=dev)[None, :] < lengths[:, None]
    dout = _t(np.random.default_rng(38), dev, torch.float32, *shape) * valid[..., None]
    cuda_lstm.reset_launch_counts()
    got = cuda_lstm.lstm_revmasked_train_fwd(xp, wh, lengths)
    assert cuda_lstm.route_counts("lstm_revmasked_train_fwd") == {"persistent": 1, "walk": 0}
    ref = cuda_lstm.lstm_revmasked_train_fwd_plain(xp, wh, lengths)
    _hold_f32(got, ref, lstm_scan_stale_h(xp, wh, True, lengths, residuals=True))
    masked_c = got[2] * valid[..., None]  # what a kernel storing the carried c would give
    assert _err(masked_c, ref[2]) >= F32_LIMIT
    for g, r in zip(cuda_lstm.lstm_revmasked_bwd(*got, lengths, dout, wh),
                    cuda_lstm.lstm_revmasked_bwd_plain(*ref, lengths, dout, wh)):
        assert _rel(g, r) < 1e-3


def test_train_persistent_f32_is_deterministic(dev):
    """Two float32 launches of K4p and of K6p are bitwise equal: float32
    remat runs the training forward in both passes."""
    xp, wh, lengths = _scan_inputs(dev, 96, 251, 768, seed=39)
    xp, wh = _f32(xp, wh)
    for run in (lambda: cuda_lstm.lstm_train_fwd_persistent(xp, wh, False),
                lambda: cuda_lstm.lstm_train_fwd_persistent(xp, wh, True),
                lambda: cuda_lstm.lstm_revmasked_train_fwd_persistent(xp, wh, lengths)):
        a, b = run(), run()
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(a, b))


# the train steps' shapes, each run as K4p forward, K4p reverse and K6p
TF32_CONTROL = [(shape, kind) for shape, i in zip(TRAIN_SHAPES[3:], TRAIN_IDS[3:])
                for kind in ("fwd", "rev", "masked") if kind != "masked" or "band" not in i]


@pytest.mark.parametrize("shape,kind", TF32_CONTROL,
                         ids=[f"{s[0]}x{s[1]}x{s[2]}-{k}" for s, k in TF32_CONTROL])
def test_f32_limit_refuses_one_tf32_product(dev, shape, kind):
    """The control of F32_LIMIT: where K4p-f32 / K6p-f32 (3xTF32) hold it,
    the plain walk with one TF32 product exceeds it in each output (h,
    gates, c), so the check tells 3xTF32 from a kernel below float32."""
    xp, wh, lengths = _scan_inputs(dev, *shape, seed=41)
    xp, wh = _f32(xp, wh)
    if kind == "masked":
        got = cuda_lstm.lstm_revmasked_train_fwd_persistent(xp, wh, lengths)
        ref = cuda_lstm.lstm_revmasked_train_fwd_plain(xp, wh, lengths)
        one = lstm_scan_tf32(xp, wh, True, lengths, residuals=True)
    else:
        got = cuda_lstm.lstm_train_fwd_persistent(xp, wh, kind == "rev")
        ref = cuda_lstm.lstm_train_fwd_plain(xp, wh, kind == "rev")
        one = lstm_scan_tf32(xp, wh, kind == "rev", residuals=True)
    for g, r, f in zip(got, ref, one):
        assert _err(g, r) < F32_LIMIT <= _err(f, r)


def test_f32_plan_bytes_equal_the_kernels(dev):
    """The planner's float32 shared-memory bytes are the kernel's own
    (``Plan::smem_bytes`` with elem = 4), and a bfloat16 plan's too."""
    from urgent2026_challenge_track1_tpu_torch.ops._build import load_library

    lib = load_library()
    for R_, H_ in ((136, 392), (804, 392), (96, 768), (502, 768), (13, 37)):
        for elem in (2, 4):
            plan = cuda_lstm.plan_persistent(R_, 0, H_, 132, dirs=1, elem=elem)
            assert lib.lstm_persistent_smem(0, H_, plan.U, plan.rows, plan.chunk,
                                            int(plan.c_in_smem), elem) == plan.smem


def test_persistent_refuses_f32_for_k2p_and_k3p(dev):
    """K2p-f32 and K3p-f32 take float32 only on a float32 plan and K2p-f32's
    carry only with h0 in float32; K3p takes no carry; no route takes
    float16."""
    xp, wh, lengths = _scan_inputs(dev, R, T, H, seed=40)
    xp, wh = _f32(xp, wh)
    bf16_plan = cuda_lstm.plan_persistent(R, 0, H, 132, dirs=1)
    with pytest.raises(ValueError):
        cuda_lstm.lstm_scan_persistent(xp, wh, False, bf16_plan)
    with pytest.raises(ValueError):
        cuda_lstm.lstm_revmasked_persistent(xp, wh, lengths, bf16_plan)
    h0, c0 = torch.zeros((R, H), device=dev), torch.zeros((R, H), device=dev)
    with pytest.raises(TypeError):
        cuda_lstm.lstm_scan_persistent(xp, wh, initial_state=(h0.bfloat16(), c0))
    with pytest.raises(ValueError):
        cuda_lstm._scan_persistent(cuda_lstm.lstm_revmasked, xp, wh, True, lengths, None,
                                   initial_state=(h0, c0))
    with pytest.raises(TypeError):
        cuda_lstm.lstm_scan_persistent(xp.half(), wh.half())


# --- K5p and K7p: the persistent routes of K5 and K7 (bfloat16) -----------


def _bwd_case(dev, shape, seed):
    """x_proj, W_hh^T, lengths (with 1 and T) and dout at one shape."""
    xp, wh, lengths = _scan_inputs(dev, *shape, seed=seed)
    return xp, wh, lengths, _t(np.random.default_rng(seed + 1), dev, torch.bfloat16, *shape)


def _masked_case(dev, shape, seed):
    """K6's plain residuals on the card, dout zero past each length, W_hh^T
    and the lengths."""
    xp, wh, lengths, dout = _bwd_case(dev, shape, seed)
    valid = torch.arange(shape[1], device=dev)[None, :] < lengths[:, None]
    return (cuda_lstm.lstm_revmasked_train_fwd_plain(xp, wh, lengths), dout * valid[..., None],
            wh, lengths)


def _hold_backward(got, ref, stale, h, reverse, lengths=None):
    """dx_proj within 4 bf16 ulps of the plain version's at every step, a
    limit that the stale-dgates fault exceeds; dW of the dW kernel alone (f32)
    on the kernel's own dx_proj within 1e-4 |h_prev|^T |dx_proj| of their
    float64 product, elementwise; the routed dW its rounding, within bf16's
    tolerance of the plain dW."""
    dxp, dw = got
    limit = ulp_limit(ref[0])
    assert dxp.dtype == torch.bfloat16 and dxp.shape == ref[0].shape
    assert _err(dxp, ref[0]) < limit
    assert _err(stale[0], ref[0]) >= limit
    dw32 = cuda_lstm.lstm_bwd_dw(h, dxp, reverse, lengths)
    hp = cuda_lstm._h_prev(h, reverse, lengths).double().reshape(-1, h.shape[-1])
    d = dxp.double().reshape(-1, dxp.shape[-1])
    assert bool(((dw32.double() - hp.t() @ d).abs() <= 1e-4 * (hp.abs().t() @ d.abs())).all())
    assert torch.equal(dw, dw32.to(dw.dtype))
    assert _rel(dw, ref[1]) < TOLS[torch.bfloat16]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", TRAIN_SHAPES, ids=TRAIN_IDS)
def test_train_bwd_persistent_matches_plain(dev, shape, reverse):
    """K5p and the dW kernel against the plain version at every step."""
    xp, wh, _, dout = _bwd_case(dev, shape, 30)
    res = cuda_lstm.lstm_train_fwd_plain(xp, wh, reverse)
    cuda_lstm.reset_launch_counts()
    got = cuda_lstm.lstm_train_bwd(*res, dout, wh, reverse)
    assert cuda_lstm.route_counts("lstm_train_bwd") == {"persistent": 1, "walk": 0}
    assert cuda_lstm.lstm_bwd_dw.launches == 1
    ref = cuda_lstm.lstm_train_bwd_plain(*res, dout, wh, reverse)
    _hold_backward(got, ref, lstm_train_bwd_stale_dg(*res, dout, wh, reverse), res[0], reverse)


@pytest.mark.parametrize("shape", MASKED_SHAPES, ids=MASKED_IDS)
def test_revmasked_bwd_persistent_matches_plain_at_every_step(dev, shape):
    """K7p and the dW kernel against the plain version at every step, padded
    ones included."""
    res, dout, wh, lengths = _masked_case(dev, shape, 31)
    cuda_lstm.reset_launch_counts()
    got = cuda_lstm.lstm_revmasked_bwd(*res, lengths, dout, wh)
    assert cuda_lstm.route_counts("lstm_revmasked_bwd") == {"persistent": 1, "walk": 0}
    ref = cuda_lstm.lstm_revmasked_bwd_plain(*res, lengths, dout, wh)
    _hold_backward(got, ref, lstm_train_bwd_stale_dg(*res, dout, wh, True, lengths), res[0],
                   True, lengths)


def test_bwd_persistent_is_deterministic(dev):
    """Two launches of K5p and of K7p (with the dW kernel's split sums) are
    bitwise equal."""
    res, dout, wh, lengths = _masked_case(dev, (136, 201, 392), 32)
    for run in (lambda: cuda_lstm.lstm_train_bwd_persistent(*res, dout, wh, False),
                lambda: cuda_lstm.lstm_train_bwd_persistent(*res, dout, wh, True),
                lambda: cuda_lstm.lstm_revmasked_bwd_persistent(*res, lengths, dout, wh)):
        a, b = run(), run()
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_bwd_route_follows_the_dtype(dev):
    """bfloat16 takes K5p/K7p and float32 K5p-f32/K7p-f32 (each with its dW
    kernel); each counts as a K5 or K7 launch; the walks run only when
    called; the persistent wrappers and the dW kernel refuse float16."""
    res, dout, wh, lengths = _masked_case(dev, (R, T, H), 33)
    f32 = [t.float() for t in res]
    cuda_lstm.reset_launch_counts()
    cuda_lstm.lstm_train_bwd(*f32, dout.float(), wh.float())
    cuda_lstm.lstm_revmasked_bwd(*f32, lengths, dout.float(), wh.float())
    cuda_lstm.lstm_train_bwd(*res, dout, wh)
    cuda_lstm.lstm_revmasked_bwd(*res, lengths, dout, wh)
    for name in ("lstm_train_bwd", "lstm_revmasked_bwd"):
        assert cuda_lstm.route_counts(name) == {"persistent": 2, "walk": 0}
        assert cuda_lstm.launch_counts()[name] == 2
    assert cuda_lstm.lstm_bwd_dw.launches == 4
    cuda_lstm.lstm_train_bwd_walk(*f32, dout.float(), wh.float())
    assert cuda_lstm.route_counts("lstm_train_bwd") == {"persistent": 2, "walk": 1}
    assert cuda_lstm.lstm_bwd_dw.launches == 4
    f16 = [t.half() for t in res]
    with pytest.raises(TypeError):
        cuda_lstm.lstm_train_bwd_persistent(*f16, dout.half(), wh.half())
    with pytest.raises(TypeError):
        cuda_lstm.lstm_revmasked_bwd_persistent(*f16, lengths, dout.half(), wh.half())
    with pytest.raises(TypeError):
        cuda_lstm.lstm_bwd_dw(f16[0], f16[1])


def test_bwd_persistent_refuses_a_grid_the_card_cannot_hold(dev):
    """A K5p/K7p plan of more CTAs than the card holds resident is refused
    at launch instead of hanging in the barrier; the next launch runs."""
    import dataclasses

    res, dout, wh, lengths = _masked_case(dev, (400, 3, 72), 34)
    plan = cuda_lstm.plan_backward(400, 72, 132)
    big = dataclasses.replace(plan, G=100, rows=4, S=18, U=4)
    assert big.ctas > torch.cuda.get_device_properties(dev).multi_processor_count
    cuda_lstm.reset_launch_counts()
    with pytest.raises(RuntimeError):
        cuda_lstm.lstm_train_bwd_persistent(*res, dout, wh, False, big)
    with pytest.raises(RuntimeError):
        cuda_lstm.lstm_revmasked_bwd_persistent(*res, lengths, dout, wh, big)
    torch.cuda.synchronize()
    assert cuda_lstm.route_counts("lstm_train_bwd") == {"persistent": 0, "walk": 0}
    assert cuda_lstm.route_counts("lstm_revmasked_bwd") == {"persistent": 0, "walk": 0}
    got = cuda_lstm.lstm_revmasked_bwd_persistent(*res, lengths, dout, wh)
    ref = cuda_lstm.lstm_revmasked_bwd_plain(*res, lengths, dout, wh)
    assert _err(got[0], ref[0]) < ulp_limit(ref[0])


# --- K5p and K7p's float32 route (3xTF32 products) ------------------------
# dx_proj within F32_BWD_LIMIT of max|plain dx_proj| at every step, a limit
# that the stale-dgates fault and, at the train steps' shapes, the backward
# with one TF32 product (lstm_train_bwd_tf32) exceed; the small shapes stage
# the cell inputs in 16-, 8- and 4-byte copies (H = 72, 46, 37).  The
# float32 dW kernel within DW_F32_BOUND |h_prev|^T |dx_proj| of the float64
# product of its own operands, which the product of TF32-rounded operands
# exceeds.


def _dw_f32_reading(dw, hp, d):
    """max over elements of |dw - P| / (|hp|^T |d|), P = hp^T d in float64
    (0 / 0 read as 0)."""
    P = hp.double().t() @ d.double()
    scale = hp.double().abs().t() @ d.double().abs()
    e = (dw.double() - P).abs()
    return float(torch.where(scale > 0, e / scale.clamp_min(1e-300),
                             torch.where(e > 0, float("inf"), 0.0)).max())


def _hold_backward_f32(got, ref, stale, h, reverse, lengths=None):
    """dx_proj within F32_BWD_LIMIT of max|plain| at every step, a limit the
    stale-dgates fault exceeds; the float32 dW kernel alone within
    DW_F32_BOUND of the float64 product, which the product of TF32-rounded
    operands exceeds; the routed dW is that kernel's, near the plain dW."""
    dxp, dw = got
    limit = bwd_limit(ref[0])
    assert dxp.dtype == torch.float32 and dxp.shape == ref[0].shape
    assert _err(dxp, ref[0]) < limit <= _err(stale[0], ref[0])
    dw32 = cuda_lstm.lstm_bwd_dw(h, dxp, reverse, lengths)
    hp = cuda_lstm._h_prev(h, reverse, lengths).reshape(-1, h.shape[-1])
    d = dxp.reshape(-1, dxp.shape[-1])
    assert _dw_f32_reading(dw32, hp, d) <= DW_F32_BOUND
    assert _dw_f32_reading(tf32(hp).t() @ tf32(d), hp, d) > DW_F32_BOUND
    assert torch.equal(dw, dw32)
    assert _rel(dw, ref[1]) < 1e-5


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", TRAIN_SHAPES, ids=TRAIN_IDS)
def test_train_bwd_persistent_f32_matches_plain(dev, shape, reverse):
    """K5p-f32 and the float32 dW kernel against the plain version at every
    step."""
    xp, wh, _, dout = _bwd_case(dev, shape, 42)
    xp, wh, dout = _f32(xp, wh, dout)
    res = cuda_lstm.lstm_train_fwd_plain(xp, wh, reverse)
    cuda_lstm.reset_launch_counts()
    got = cuda_lstm.lstm_train_bwd(*res, dout, wh, reverse)
    assert cuda_lstm.route_counts("lstm_train_bwd") == {"persistent": 1, "walk": 0}
    assert cuda_lstm.lstm_bwd_dw.launches == 1
    ref = cuda_lstm.lstm_train_bwd_plain(*res, dout, wh, reverse)
    _hold_backward_f32(got, ref, lstm_train_bwd_stale_dg(*res, dout, wh, reverse), res[0],
                       reverse)


@pytest.mark.parametrize("shape", MASKED_SHAPES, ids=MASKED_IDS)
def test_revmasked_bwd_persistent_f32_matches_plain_at_every_step(dev, shape):
    """K7p-f32 and the float32 dW kernel at every step, padded ones
    included; the mask trap: dx_proj of padded steps is written too, and a
    kernel that dropped m_t after the product would miss the plain
    version there."""
    xp, wh, lengths, dout = _bwd_case(dev, shape, 43)
    xp, wh, dout = _f32(xp, wh, dout)
    valid = torch.arange(shape[1], device=dev)[None, :] < lengths[:, None]
    res = cuda_lstm.lstm_revmasked_train_fwd_plain(xp, wh, lengths)
    dout = dout * valid[..., None]
    cuda_lstm.reset_launch_counts()
    got = cuda_lstm.lstm_revmasked_bwd(*res, lengths, dout, wh)
    assert cuda_lstm.route_counts("lstm_revmasked_bwd") == {"persistent": 1, "walk": 0}
    ref = cuda_lstm.lstm_revmasked_bwd_plain(*res, lengths, dout, wh)
    _hold_backward_f32(got, ref, lstm_train_bwd_stale_dg(*res, dout, wh, True, lengths), res[0],
                       True, lengths)
    unmasked = cuda_lstm.lstm_train_bwd_plain(*res, dout, wh, True)[0]
    assert _err(unmasked, ref[0]) >= bwd_limit(ref[0])


def test_bwd_persistent_f32_is_deterministic(dev):
    """Two float32 launches of K5p and of K7p (with the float32 dW kernel's
    split sums) are bitwise equal."""
    res, dout, wh, lengths = _masked_case(dev, (96, 251, 768), 44)
    res, dout, wh = [t.float() for t in res], dout.float(), wh.float()
    for run in (lambda: cuda_lstm.lstm_train_bwd_persistent(*res, dout, wh, False),
                lambda: cuda_lstm.lstm_train_bwd_persistent(*res, dout, wh, True),
                lambda: cuda_lstm.lstm_revmasked_bwd_persistent(*res, lengths, dout, wh)):
        a, b = run(), run()
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("shape,kind", TF32_CONTROL,
                         ids=[f"{s[0]}x{s[1]}x{s[2]}-{k}" for s, k in TF32_CONTROL])
def test_f32_bwd_limit_refuses_one_tf32_product(dev, shape, kind):
    """The control of F32_BWD_LIMIT: where K5p-f32 / K7p-f32 (3xTF32) hold
    it, the plain backward with one TF32 product in dh exceeds it."""
    if kind == "masked":
        res, dout, wh, lengths = _masked_case(dev, shape, 45)
        res, dout, wh = [t.float() for t in res], dout.float(), wh.float()
        got = cuda_lstm.lstm_revmasked_bwd_persistent(*res, lengths, dout, wh)
        ref = cuda_lstm.lstm_revmasked_bwd_plain(*res, lengths, dout, wh)
        one = lstm_train_bwd_tf32(*res, dout, wh, True, lengths)
    else:
        xp, wh, _, dout = _bwd_case(dev, shape, 45)
        xp, wh, dout = _f32(xp, wh, dout)
        res = cuda_lstm.lstm_train_fwd_plain(xp, wh, kind == "rev")
        got = cuda_lstm.lstm_train_bwd_persistent(*res, dout, wh, kind == "rev")
        ref = cuda_lstm.lstm_train_bwd_plain(*res, dout, wh, kind == "rev")
        one = lstm_train_bwd_tf32(*res, dout, wh, kind == "rev")
    assert _err(got[0], ref[0]) < bwd_limit(ref[0]) <= _err(one[0], ref[0])


@pytest.mark.parametrize("shape", [(R, T, H), (13, 9, 37), (136, 201, 392), (502, 48, 768)],
                         ids=["small", "odd_h", "disc_time", "flow_band"])
def test_dw_f32_matches_the_float64_product(dev, shape):
    """The float32 dW kernel alone (each split the planner may take) against
    torch.mm in float64 on the same shifted (and masked) operands, and two
    launches bitwise equal."""
    Rs, Ts, Hs = shape
    rng = np.random.default_rng(46)
    h = _t(rng, dev, torch.float32, Rs, Ts, Hs, scale=0.5)
    dxp = _t(rng, dev, torch.float32, Rs, Ts, 4 * Hs, scale=0.05)
    lengths = torch.from_numpy(rng.integers(1, Ts + 1, Rs).astype(np.int32)).to(dev)
    for reverse, lens in ((False, None), (True, None), (True, lengths)):
        hp = cuda_lstm._h_prev(h, reverse, lens).reshape(-1, Hs)
        d = dxp.reshape(-1, 4 * Hs)
        for split in (1, 2, 3, 4):
            a = cuda_lstm.lstm_bwd_dw(h, dxp, reverse, lens, split)
            b = cuda_lstm.lstm_bwd_dw(h, dxp, reverse, lens, split)
            torch.cuda.synchronize()
            assert torch.equal(a, b)
            assert _dw_f32_reading(a, hp, d) <= DW_F32_BOUND


def test_bwd_f32_plan_bytes_equal_the_kernels(dev):
    """The planner's float32 backward shared-memory bytes are the kernel's
    own (``BwdPlan::smem_bytes`` with elem = 4), and a bfloat16 plan's
    too."""
    from urgent2026_challenge_track1_tpu_torch.ops._build import load_library

    lib = load_library()
    for R_, H_ in ((136, 392), (804, 392), (96, 768), (502, 768), (13, 37), (34, 1020)):
        for elem in (2, 4):
            plan = cuda_lstm.plan_backward(R_, H_, 132, elem=elem)
            assert lib.lstm_persistent_bwd_smem(H_, plan.U, plan.rows, plan.chunk, plan.kt,
                                                int(plan.dc_in_smem), elem) == plan.smem


# --- the walks of K4-K7 --------------------------------------------------


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_fwd_bwd_match_plain(dev, dtype, reverse, rows):
    """K4's walk (h, gates, c) and K5's walk (dxp, dW) at every row tile
    (bfloat16 takes K4p and K5p by default) against their plain versions;
    K5 runs on the plain forward's residuals so that each kernel is held
    alone."""
    rng = np.random.default_rng(6)
    xp, wh, dout = _train_inputs(rng, dev, dtype)
    got = cuda_lstm.lstm_train_fwd_walk(xp, wh, reverse)
    ref = cuda_lstm.lstm_train_fwd_plain(xp, wh, reverse)
    for g, r in zip(got, ref):
        assert g.dtype == dtype and _err(g, r) < TOLS[dtype]
    dxp, dw = cuda_lstm.lstm_train_bwd_walk(*ref, dout, wh, reverse)
    rdxp, rdw = cuda_lstm.lstm_train_bwd_plain(*ref, dout, wh, reverse)
    grad_tol = 1e-3 if dtype == torch.float32 else TOLS[dtype]
    assert dxp.dtype == dtype and dw.dtype == dtype
    assert _rel(dxp, rdxp) < grad_tol and _rel(dw, rdw) < grad_tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_revmasked_train_fwd_bwd_match_plain(dev, dtype, rows):
    """K6's walk and K7's walk at every row tile (bfloat16 takes K6p and
    K7p by default)."""
    rng = np.random.default_rng(7)
    xp, wh, dout = _train_inputs(rng, dev, dtype)
    lengths = _lengths(dev)
    valid = torch.arange(T, device=dev)[None, :] < lengths[:, None]
    dout = dout * valid[..., None]
    got = cuda_lstm.lstm_revmasked_train_fwd_walk(xp, wh, lengths)
    ref = cuda_lstm.lstm_revmasked_train_fwd_plain(xp, wh, lengths)
    for g, r in zip(got, ref):
        assert _err(g[valid], r[valid]) < TOLS[dtype]
    dxp, dw = cuda_lstm.lstm_revmasked_bwd_walk(*ref, lengths, dout, wh)
    rdxp, rdw = cuda_lstm.lstm_revmasked_bwd_plain(*ref, lengths, dout, wh)
    grad_tol = 1e-3 if dtype == torch.float32 else TOLS[dtype]
    assert _rel(dxp, rdxp) < grad_tol and _rel(dw, rdw) < grad_tol


def test_train_backward_is_deterministic(dev):
    """The dW reduction sums in one fixed order: two runs are bitwise equal."""
    rng = np.random.default_rng(8)
    xp, wh, dout = _train_inputs(rng, dev, torch.float32)
    res = cuda_lstm.lstm_train_fwd(xp, wh)
    a = cuda_lstm.lstm_train_bwd(*res, dout, wh)
    b = cuda_lstm.lstm_train_bwd(*res, dout, wh)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_autograd_functions_launch_the_training_kernels(dev):
    rng = np.random.default_rng(9)
    xp, wh, dout = _train_inputs(rng, dev, torch.float32)
    lengths = _lengths(dev)
    cuda_lstm.reset_launch_counts()
    x1, w1 = xp.clone().requires_grad_(), wh.clone().requires_grad_()
    cuda_lstm.lstm_dir(x1, w1, True).backward(dout)
    x2, w2 = xp.clone().requires_grad_(), wh.clone().requires_grad_()
    cuda_lstm.lstm_dir_revmasked(x2, w2, lengths).backward(dout)
    with torch.no_grad():
        cuda_lstm.lstm_dir(x1, w1)
        cuda_lstm.lstm_dir_revmasked(x2, w2, lengths)
    assert cuda_lstm.launch_counts() == {
        "fusedin_bilstm": 0, "lstm_scan": 1, "lstm_revmasked": 1, "lstm_train_fwd": 1,
        "lstm_train_bwd": 1, "lstm_revmasked_train_fwd": 1, "lstm_revmasked_bwd": 1,
        "lstm_train_fwd_streamin": 0, "lstm_train_fwd2": 0, "lstm_train_bwd2": 0}
    ref = xp.cpu().clone().requires_grad_()
    cuda_lstm.lstm_dir(ref, wh.cpu(), True).backward(dout.cpu())
    assert _rel(x1.grad.cpu(), ref.grad) < 1e-3


def test_each_launch_counts_once(dev):
    rng = np.random.default_rng(3)
    xp, wh = _t(rng, dev, torch.float32, R, T, 4 * H), _t(rng, dev, torch.float32, H, 4 * H)
    cuda_lstm.reset_launch_counts()
    cuda_lstm.lstm_scan(xp, wh)
    cuda_lstm.lstm_scan(xp, wh, True)
    cuda_lstm.lstm_revmasked(xp, wh, _lengths(dev))
    cuda_lstm.lstm_scan_plain(xp, wh)  # the plain version is no launch
    counts = cuda_lstm.launch_counts()
    assert counts.pop("lstm_scan") == 2 and counts.pop("lstm_revmasked") == 1
    assert set(counts.values()) == {0}


def test_wrappers_reject_bad_inputs(dev):
    rng = np.random.default_rng(4)
    xp, wh = _t(rng, dev, torch.float32, R, T, 4 * H), _t(rng, dev, torch.float32, H, 4 * H)
    with pytest.raises(TypeError):
        cuda_lstm.lstm_scan(xp, wh.to(torch.bfloat16))
    with pytest.raises(ValueError):
        cuda_lstm.lstm_scan(xp, wh.t().contiguous().t())  # not contiguous
    with pytest.raises(ValueError):
        cuda_lstm.lstm_scan(xp, wh.cpu())
    with pytest.raises(TypeError):
        cuda_lstm.lstm_revmasked(xp, wh, _lengths(dev).long())
    big = _t(rng, dev, torch.float32, 2, 3, 4 * 1040)
    with pytest.raises(ValueError):
        cuda_lstm.lstm_scan(big, _t(rng, dev, torch.float32, 1040, 4 * 1040))


def test_small_forward_card_matches_cpu(dev):
    import copy

    from urgent2026_challenge_track1_tpu_torch.dsp.stft import STFTConfig
    from urgent2026_challenge_track1_tpu_torch.models.bsrnn import (
        BSRNNConfig, bsrnn_se_apply, init_bsrnn)

    cpu_model = init_bsrnn(BSRNNConfig(num_channel=16, num_layer=2), seed=0, device="cpu")
    card_model = copy.deepcopy(cpu_model).to(dev)
    x = torch.from_numpy((0.1 * np.random.default_rng(5).standard_normal((2, 16000))
                          ).astype(np.float32))
    lengths = torch.tensor([16000, 11000], dtype=torch.int32)
    with torch.inference_mode():
        ref, _ = bsrnn_se_apply(cpu_model, STFTConfig(), x, 16000, lengths)
        cuda_lstm.reset_launch_counts()
        got, _ = bsrnn_se_apply(card_model, STFTConfig(), x.to(dev), 16000, lengths.to(dev))
    counts = cuda_lstm.launch_counts()
    inference = {k: counts.pop(k) for k in ("fusedin_bilstm", "lstm_scan", "lstm_revmasked")}
    assert set(inference.values()) == {2} and set(counts.values()) == {0}  # one per layer
    for b, n in enumerate(lengths.tolist()):
        assert _err(got[b, :n].cpu(), ref[b, :n]) < 1e-4


# --- H = 768 (two units per thread), the flow model's width ---------------

RW, TW, NW, HW = 5, 6, 48, 768


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_kernels_match_plain(dev, dtype, rows):
    """K1-K7 at H = 768 against their plain versions, every row tile (the
    walks of K2-K4 and K6; bfloat16 K1 takes K1p)."""
    rng = np.random.default_rng(10)
    x, wi, wh, b = (_t(rng, dev, dtype, RW, TW, NW), _t(rng, dev, dtype, 2, NW, 4 * HW),
                    _t(rng, dev, dtype, 2, HW, 4 * HW), _t(rng, dev, dtype, 2, 4 * HW))
    xp, dout = _t(rng, dev, dtype, RW, TW, 4 * HW), _t(rng, dev, dtype, RW, TW, HW)
    lengths = torch.tensor([1, TW, 3, 4, 2], dtype=torch.int32, device=dev)
    valid = torch.arange(TW, device=dev)[None, :] < lengths[:, None]
    tol, grad_tol = TOLS[dtype], (1e-3 if dtype == torch.float32 else TOLS[dtype])
    assert _err(cuda_lstm.fusedin_bilstm(x, wi, wh, b),
                cuda_lstm.fusedin_bilstm_plain(x, wi, wh, b)) < tol
    assert _err(cuda_lstm.lstm_scan_walk(xp, wh[0], True),
                cuda_lstm.lstm_scan_plain(xp, wh[0], True)) < tol
    assert _err(cuda_lstm.lstm_revmasked_walk(xp, wh[1], lengths)[valid],
                cuda_lstm.lstm_revmasked_plain(xp, wh[1], lengths)[valid]) < tol
    ref = cuda_lstm.lstm_train_fwd_plain(xp, wh[0])
    for g, r in zip(cuda_lstm.lstm_train_fwd_walk(xp, wh[0]), ref):
        assert _err(g, r) < tol
    for g, r in zip(cuda_lstm.lstm_train_bwd(*ref, dout, wh[0]),
                    cuda_lstm.lstm_train_bwd_plain(*ref, dout, wh[0])):
        assert _rel(g, r) < grad_tol
    ref = cuda_lstm.lstm_revmasked_train_fwd_plain(xp, wh[1], lengths)
    for g, r in zip(cuda_lstm.lstm_revmasked_train_fwd_walk(xp, wh[1], lengths), ref):
        assert _err(g[valid], r[valid]) < tol
    dmask = dout * valid[..., None]
    for g, r in zip(cuda_lstm.lstm_revmasked_bwd(*ref, lengths, dmask, wh[1]),
                    cuda_lstm.lstm_revmasked_bwd_plain(*ref, lengths, dmask, wh[1])):
        assert _rel(g, r) < grad_tol


# --- K8-K10 --------------------------------------------------------------


@pytest.mark.parametrize("hid", [H, HW])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_streamin_matches_plain(dev, dtype, reverse, hid, rows):
    """K8's walk at every row tile (bfloat16 K8 takes K8p by default)."""
    rng = np.random.default_rng(11)
    w = hid ** -0.5  # the LSTM init's scale: 4H-wide sums of N + H products
    x, wi = _t(rng, dev, dtype, R, T, N), _t(rng, dev, dtype, N, 4 * hid, scale=w)
    b, wh = _t(rng, dev, dtype, 4 * hid, scale=w), _t(rng, dev, dtype, hid, 4 * hid, scale=w)
    got = cuda_lstm.lstm_train_fwd_streamin_walk(x, wi, b, wh, reverse)
    ref = cuda_lstm.lstm_train_fwd_streamin_plain(x, wi, b, wh, reverse)
    for g, r in zip(got, ref):
        assert g.dtype == dtype and g.shape == r.shape and _err(g, r) < TOLS[dtype]


def _two_directions(rng, dev, dtype, hid):
    return (_t(rng, dev, dtype, R, T, 4 * hid), _t(rng, dev, dtype, R, T, 4 * hid),
            _t(rng, dev, dtype, hid, 4 * hid), _t(rng, dev, dtype, hid, 4 * hid),
            _t(rng, dev, dtype, R, T, hid), _t(rng, dev, dtype, R, T, hid))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_bidir_matches_plain(dev, dtype, rows):
    """K9 (K4's route once a direction: K4p here) and K10's walk at every
    row tile (K10 takes K10p by default)."""
    rng = np.random.default_rng(12)
    xf, xb, wf, wb, df, db = _two_directions(rng, dev, dtype, H)
    ref = cuda_lstm.lstm_train_fwd2_plain(xf, xb, wf, wb)
    for g, r in zip(cuda_lstm.lstm_train_fwd2(xf, xb, wf, wb), ref):
        assert _err(g, r) < TOLS[dtype]
    grad_tol = 1e-3 if dtype == torch.float32 else TOLS[dtype]
    got = cuda_lstm.lstm_train_bwd2_walk(ref[:3], ref[3:], df, db, wf, wb)
    want = cuda_lstm.lstm_train_bwd2_plain(ref[:3], ref[3:], df, db, wf, wb)
    for g, r in zip(got, want):
        assert _rel(g, r) < grad_tol


@pytest.mark.parametrize("hid", [H, HW])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_bidir_equals_per_direction_bitwise(dev, dtype, hid):
    """The routed K9 = two K4p launches (forward, reverse) on
    ``scan_route``'s plan where one exists, else K4's walk per direction;
    K10's walk = K5's walk per direction, bit for bit (the same device
    code), at the wrapper's own row tiles (bfloat16 K5 takes K5p and K10
    K10p by default, other kernels)."""
    rng = np.random.default_rng(13)
    xf, xb, wf, wb, df, db = _two_directions(rng, dev, dtype, hid)
    plan = cuda_lstm.scan_route(dtype, R, hid, cuda_lstm._sm_count(dev.index or 0))
    fused = cuda_lstm.lstm_train_fwd2(xf, xb, wf, wb)
    if plan is None:
        pair = (*cuda_lstm.lstm_train_fwd_walk(xf, wf, False),
                *cuda_lstm.lstm_train_fwd_walk(xb, wb, True))
    else:
        pair = (*cuda_lstm.lstm_train_fwd_persistent(xf, wf, False, plan),
                *cuda_lstm.lstm_train_fwd_persistent(xb, wb, True, plan))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(fused, pair))
    single = (*cuda_lstm.lstm_train_fwd_walk(xf, wf, False),
              *cuda_lstm.lstm_train_fwd_walk(xb, wb, True))
    fused = cuda_lstm.lstm_train_bwd2_walk(single[:3], single[3:], df, db, wf, wb)
    single = (*cuda_lstm.lstm_train_bwd_walk(*single[:3], df, wf, False),
              *cuda_lstm.lstm_train_bwd_walk(*single[3:], db, wb, True))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(fused, single))


@pytest.mark.parametrize("stream,fused,expect", [
    (False, False, {"lstm_train_fwd": 2, "lstm_train_bwd": 2}),
    (False, True, {"lstm_train_fwd2": 2, "lstm_train_bwd2": 1}),  # K9p: K4p a direction
    (True, False, {"lstm_train_fwd_streamin": 2, "lstm_train_bwd": 2}),
    (True, True, {"lstm_train_fwd_streamin": 2, "lstm_train_bwd": 2}),
])
def test_bilstm_train_follows_the_toggles(dev, monkeypatch, stream, fused, expect):
    """BiLSTMTrain's launches under each toggle setting (K9 on K9p, two
    launches a call), and its gradients against the CPU (plain versions)."""
    from urgent2026_challenge_track1_tpu_torch.ops import lstm as tlstm

    monkeypatch.setattr(cuda_lstm, "STREAM_INPUT_TRAIN", stream)
    monkeypatch.setattr(cuda_lstm, "FUSED_BIDIR_TRAIN", fused)
    rng = np.random.default_rng(14)
    names = [f"{w}{s}" for s in ("", "_reverse") for w in ("w_ih", "w_hh", "b_ih", "b_hh")]
    shapes = {"w_ih": (4 * H, N), "w_hh": (4 * H, H), "b_ih": (4 * H,), "b_hh": (4 * H,)}
    params = {k: torch.from_numpy((0.2 * rng.standard_normal(shapes[k.split("_r")[0]])
                                   ).astype(np.float32)) for k in names}
    x = torch.from_numpy((0.5 * rng.standard_normal((R, T, N))).astype(np.float32))
    cot = torch.from_numpy(rng.standard_normal((R, T, 2 * H)).astype(np.float32))
    grads = []
    for device in (dev, torch.device("cpu")):
        tp = {k: v.to(device).requires_grad_() for k, v in params.items()}
        xt = x.to(device).requires_grad_()
        cuda_lstm.reset_launch_counts()
        tlstm.bilstm(tp, xt).backward(cot.to(device))
        if device == dev:
            counts = {k: v for k, v in cuda_lstm.launch_counts().items() if v}
            assert counts == expect
            fwd2 = expect.get("lstm_train_fwd2", 0)
            assert cuda_lstm.route_counts("lstm_train_fwd2") == {"persistent": fwd2, "walk": 0}
        grads.append([xt.grad.cpu()] + [tp[k].grad.cpu() for k in names])
    for g, r in zip(*grads):
        assert _rel(g, r) < 1e-3


# --- K8p and K10p: the persistent routes of K8 (bfloat16) and K10 ---------
# K8p within 4 bf16 ulps at max|plain| in h, gates and c at every step, a
# limit the stale-h fault exceeds; K10p's dx_proj within bwd_limit per
# direction (the stale-dgates fault and, in float32, one TF32 product
# exceed it) and equal to K5p launched per direction with its plan, bit for
# bit

# (R, T, N, H): small, odd N and H, the disc and flow training steps' time
# paths (where the masked time path runs K8 under STREAM_INPUT_TRAIN) and
# the bench width
K8P_SHAPES = [(R, T, N, H), (13, 9, 33, 37), (136, 201, 196, 392), (804, 34, 196, 392),
              (96, 251, 384, 768), (136, 201, 192, 384)]
K8P_IDS = ["small", "odd", "disc_time", "disc_band", "flow_time", "bench"]
# (R, T, H): small, odd H, the band paths where FUSED_BIDIR_TRAIN runs K10
# (disc, flow, bench width)
K10P_SHAPES = [(R, T, H), (13, 9, 37), (804, 34, 392), (502, 48, 768), (804, 34, 384)]
K10P_IDS = ["small", "odd_h", "disc_band", "flow_band", "bench"]


def _streamin_case(dev, shape, seed, dtype=torch.bfloat16):
    R_, T_, N_, H_ = shape
    rng = np.random.default_rng(seed)
    w = H_ ** -0.5
    return (_t(rng, dev, dtype, R_, T_, N_),
            _t(rng, dev, dtype, N_, 4 * H_, scale=w),
            _t(rng, dev, dtype, 4 * H_, scale=w),
            _t(rng, dev, dtype, H_, 4 * H_, scale=w))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", K8P_SHAPES, ids=K8P_IDS)
def test_streamin_persistent_matches_plain(dev, shape, reverse):
    """K8p through the routed wrapper against the plain version at every
    step: h, gates and c within 4 bf16 ulps, which the stale-h fault
    exceeds."""
    x, wi, b, wh = _streamin_case(dev, shape, 50)
    cuda_lstm.reset_launch_counts()
    got = cuda_lstm.lstm_train_fwd_streamin(x, wi, b, wh, reverse)
    assert cuda_lstm.route_counts("lstm_train_fwd_streamin") == {"persistent": 1, "walk": 0}
    ref = cuda_lstm.lstm_train_fwd_streamin_plain(x, wi, b, wh, reverse)
    _hold_residuals(got, ref, lstm_train_fwd_streamin_stale_h(x, wi, b, wh, reverse))


@pytest.mark.parametrize("shape", [(136, 201, 196, 392), (804, 34, 196, 392)],
                         ids=["disc_time", "disc_band"])
def test_streamin_persistent_is_deterministic(dev, shape):
    """Two K8p launches are bitwise equal, also at the disc band, whose
    plan walks several chunks a group (the residual stores of a group's
    earlier chunks) with c in global memory."""
    R_, _, N_, H_ = shape
    plan = cuda_lstm.streamin_route(torch.bfloat16, R_, N_, H_,
                                    cuda_lstm._sm_count(dev.index or 0))
    assert plan is not None
    if R_ == 804:
        assert plan.rows > plan.chunk and not plan.c_in_smem
    x, wi, b, wh = _streamin_case(dev, shape, 51)
    for reverse in (False, True):
        a = cuda_lstm.lstm_train_fwd_streamin_persistent(x, wi, b, wh, reverse)
        c = cuda_lstm.lstm_train_fwd_streamin_persistent(x, wi, b, wh, reverse)
        torch.cuda.synchronize()
        assert all(torch.equal(u, v) for u, v in zip(a, c))


def test_streamin_route_follows_the_dtype(dev):
    """bfloat16 K8 takes K8p, float32 K8p-f32, float32 without a plan (H =
    1020) the walk; each counts as a K8 launch; K8p refuses float16 and a
    grid the card cannot hold resident."""
    import dataclasses

    x, wi, b, wh = _streamin_case(dev, (R, T, N, H), 52)
    cuda_lstm.reset_launch_counts()
    cuda_lstm.lstm_train_fwd_streamin(x.float(), wi.float(), b.float(), wh.float())
    cuda_lstm.lstm_train_fwd_streamin(x, wi, b, wh)
    assert cuda_lstm.route_counts("lstm_train_fwd_streamin") == {"persistent": 2, "walk": 0}
    wide = _streamin_case(dev, (4, 3, 510, 1020), 56, torch.float32)
    cuda_lstm.lstm_train_fwd_streamin(*wide)
    assert cuda_lstm.route_counts("lstm_train_fwd_streamin") == {"persistent": 2, "walk": 1}
    assert cuda_lstm.launch_counts()["lstm_train_fwd_streamin"] == 3
    with pytest.raises(TypeError):
        cuda_lstm.lstm_train_fwd_streamin_persistent(x.half(), wi.half(), b.half(), wh.half())
    x4 = _streamin_case(dev, (400, 3, N, H), 53)[0]
    plan = cuda_lstm.plan_persistent(400, N, H, 132, dirs=1)
    big = dataclasses.replace(plan, G=100, rows=4, S=18, U=4)
    assert big.ctas > torch.cuda.get_device_properties(dev).multi_processor_count
    with pytest.raises(RuntimeError):
        cuda_lstm.lstm_train_fwd_streamin_persistent(x4, wi, b, wh, False, big)
    torch.cuda.synchronize()
    assert cuda_lstm.route_counts("lstm_train_fwd_streamin") == {"persistent": 2, "walk": 1}


# --- K8p-f32: the persistent route of K8 in float32 (3xTF32) ---------------

K8F32_SHAPES = K8P_SHAPES + [(13, 7, 37, 46), (21, 5, 38, 20), (502, 48, 384, 768)]
K8F32_IDS = K8P_IDS + ["odd_n4", "n_mod4", "flow_band"]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", K8F32_SHAPES, ids=K8F32_IDS)
def test_streamin_persistent_f32_matches_plain(dev, shape, reverse):
    """K8p-f32 through the routed wrapper against the plain version at
    every step: h, gates and c within F32_LIMIT, which the stale-h fault
    and the walk with one TF32 product (both products) exceed."""
    x, wi, b, wh = _streamin_case(dev, shape, 57, torch.float32)
    cuda_lstm.reset_launch_counts()
    got = cuda_lstm.lstm_train_fwd_streamin(x, wi, b, wh, reverse)
    assert cuda_lstm.route_counts("lstm_train_fwd_streamin") == {"persistent": 1, "walk": 0}
    ref = cuda_lstm.lstm_train_fwd_streamin_plain(x, wi, b, wh, reverse)
    _hold_f32(got, ref, lstm_train_fwd_streamin_stale_h(x, wi, b, wh, reverse))
    for g, r, f in zip(got, ref, lstm_train_fwd_streamin_tf32(x, wi, b, wh, reverse)):
        assert _err(g, r) < F32_LIMIT <= _err(f, r)


@pytest.mark.parametrize("shape", [(136, 201, 196, 392), (804, 34, 196, 392),
                                   (96, 251, 384, 768)],
                         ids=["disc_time", "disc_band", "flow_time"])
def test_streamin_persistent_f32_is_deterministic(dev, shape):
    """Two K8p-f32 launches are bitwise equal, each direction."""
    x, wi, b, wh = _streamin_case(dev, shape, 58, torch.float32)
    for reverse in (False, True):
        a = cuda_lstm.lstm_train_fwd_streamin_persistent(x, wi, b, wh, reverse)
        c = cuda_lstm.lstm_train_fwd_streamin_persistent(x, wi, b, wh, reverse)
        torch.cuda.synchronize()
        assert all(torch.equal(u, v) for u, v in zip(a, c))


def _bwd2_case(dev, shape, dtype, seed):
    """Both directions' plain residuals, dout and W_hh^T."""
    R_, T_, H_ = shape
    rng = np.random.default_rng(seed)
    xf, xb = _t(rng, dev, dtype, R_, T_, 4 * H_), _t(rng, dev, dtype, R_, T_, 4 * H_)
    wf, wb = (_t(rng, dev, dtype, H_, 4 * H_, scale=H_ ** -0.5) for _ in range(2))
    df, db = (_t(rng, dev, dtype, R_, T_, H_, scale=0.1) for _ in range(2))
    res = cuda_lstm.lstm_train_fwd2_plain(xf, xb, wf, wb)
    return res[:3], res[3:], df, db, wf, wb


def _hold_bwd2(got, ref, args, f32):
    """Per direction: dx_proj within bwd_limit of the plain one, which the
    stale-dgates fault (and in float32 one TF32 product) exceeds; the dW
    kernel on the kernel's dx_proj within 1e-4 (bfloat16) or DW_F32_BOUND
    (float32, which the product of TF32-rounded operands exceeds) |h_prev|^T
    |dx_proj| of their float64 product, the routed dW its rounding."""
    res_f, res_b, df, db, wf, wb = args
    for d, (res, dout, w, rev) in enumerate(((res_f, df, wf, False), (res_b, db, wb, True))):
        dxp, dw, rdxp, rdw = got[2 * d], got[2 * d + 1], ref[2 * d], ref[2 * d + 1]
        limit = bwd_limit(rdxp)
        assert dxp.shape == rdxp.shape and dxp.dtype == rdxp.dtype
        assert _err(dxp, rdxp) < limit <= _err(lstm_train_bwd_stale_dg(*res, dout, w, rev)[0],
                                                rdxp)
        if f32:
            assert _err(lstm_train_bwd_tf32(*res, dout, w, rev)[0], rdxp) >= limit
        dw32 = cuda_lstm.lstm_bwd_dw(res[0], dxp, rev)
        hp = cuda_lstm._h_prev(res[0], rev).reshape(-1, res[0].shape[-1])
        dd = dxp.reshape(-1, dxp.shape[-1])
        assert _dw_f32_reading(dw32, hp, dd) <= (DW_F32_BOUND if f32 else 1e-4)
        if f32:
            assert _dw_f32_reading(tf32(hp).t() @ tf32(dd), hp, dd) > DW_F32_BOUND
        assert torch.equal(dw, dw32.to(dw.dtype))
        assert _rel(dw, rdw) < (1e-5 if f32 else TOLS[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", K10P_SHAPES, ids=K10P_IDS)
def test_bwd2_persistent_matches_plain(dev, shape, dtype):
    """The routed K10: K10p where backward2_route has a two-direction plan,
    else (float32 at the flow band) a K5p-f32 launch a direction on K5p's
    plan, each with one dW launch a direction; against the plain version
    per direction and equal to K5p launched per direction with the route's
    plan, bit for bit."""
    args = _bwd2_case(dev, shape, dtype, 53)
    R_, _, H_ = shape
    plan = cuda_lstm.backward2_route(dtype, R_, H_, cuda_lstm._sm_count(dev.index or 0))
    cuda_lstm.reset_launch_counts()
    got = cuda_lstm.lstm_train_bwd2(*args)
    split = int(plan.dirs == 1)
    assert split == (shape == (502, 48, 768) and dtype == torch.float32)
    assert cuda_lstm.route_counts("lstm_train_bwd2") == {
        "persistent": 1 - split, "walk": 0, "persistent_split": 2 * split}
    assert cuda_lstm.launch_counts()["lstm_train_bwd"] == 0
    assert cuda_lstm.lstm_bwd_dw.launches == 2  # one a direction
    ref = cuda_lstm.lstm_train_bwd2_plain(*args)
    _hold_bwd2(got, ref, args, dtype == torch.float32)
    res_f, res_b, df, db, wf, wb = args
    single = (*cuda_lstm.lstm_train_bwd_persistent(*res_f, df, wf, False, plan),
              *cuda_lstm.lstm_train_bwd_persistent(*res_b, db, wb, True, plan))
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(got, single))


def test_bwd2_route_follows_the_plan(dev):
    """K10 takes K10p in bfloat16 and float32 where a two-direction plan
    fits, K5p's plan where none does (float32 at the flow band), and the
    persistent wrapper refuses float16 and a grid the card cannot hold
    resident."""
    import dataclasses

    sms = cuda_lstm._sm_count(dev.index or 0)
    assert cuda_lstm.backward2_route(torch.bfloat16, 502, 768, sms).dirs == 2
    assert cuda_lstm.backward2_route(torch.float32, 804, 392, sms).dirs == 2
    assert cuda_lstm.backward2_route(torch.float32, 502, 768, sms).dirs == 1
    args = _bwd2_case(dev, (R, T, H), torch.bfloat16, 54)
    f16 = [[t.half() for t in a] if isinstance(a, tuple) else a.half() for a in args]
    with pytest.raises(TypeError):
        cuda_lstm.lstm_train_bwd2_persistent(*f16)
    plan = cuda_lstm.plan_backward(400, H, 132, dirs=2)
    big = dataclasses.replace(plan, G=100, rows=4, S=18, U=4)
    assert big.ctas > torch.cuda.get_device_properties(dev).multi_processor_count
    cuda_lstm.reset_launch_counts()
    with pytest.raises(RuntimeError):
        cuda_lstm.lstm_train_bwd2_persistent(*_bwd2_case(dev, (400, 3, H), torch.bfloat16, 55),
                                             big)
    torch.cuda.synchronize()
    assert cuda_lstm.route_counts("lstm_train_bwd2") == {"persistent": 0, "walk": 0,
                                                         "persistent_split": 0}
    got = cuda_lstm.lstm_train_bwd2(*args)
    ref = cuda_lstm.lstm_train_bwd2_plain(*args)
    assert _err(got[0], ref[0]) < ulp_limit(ref[0])


# --- K9p and K10's one-direction pair --------------------------------------
# K9 on K9p: two K4p (K4p-f32) launches on scan_route's plan, bit for bit
# lstm_train_fwd_persistent per direction, held like K4p (ulp_limit in
# bfloat16, F32_LIMIT in float32; the stale-h fault with the residuals and,
# in float32, one TF32 product exceed them); K10 where no two-direction plan
# fits: a K5p launch a direction, held like K10p

# (R, T, H): the band paths where FUSED_BIDIR_TRAIN runs K9 (disc, bench
# width, flow)
K9P_SHAPES = [(804, 34, 392), (804, 34, 384), (502, 48, 768)]
K9P_IDS = ["disc_band", "bench", "flow_band"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", K9P_SHAPES, ids=K9P_IDS)
def test_fwd2_persistent_matches_plain(dev, shape, dtype):
    """The routed K9 takes K9p (two launches, counted in K9's persistent
    route, none in K4's), equals K4p launched per direction on the route's
    plan bit for bit, and holds each direction's h, gates and c against the
    plain version at every step."""
    rng = np.random.default_rng(60)
    R_, T_, H_ = shape
    xf, xb = (_t(rng, dev, dtype, R_, T_, 4 * H_, scale=0.5) for _ in range(2))
    wf, wb = (_t(rng, dev, dtype, H_, 4 * H_, scale=H_ ** -0.5) for _ in range(2))
    plan = cuda_lstm.scan_route(dtype, R_, H_, cuda_lstm._sm_count(dev.index or 0))
    cuda_lstm.reset_launch_counts()
    got = cuda_lstm.lstm_train_fwd2(xf, xb, wf, wb)
    assert cuda_lstm.route_counts("lstm_train_fwd2") == {"persistent": 2, "walk": 0}
    assert cuda_lstm.launch_counts()["lstm_train_fwd"] == 0
    pair = (*cuda_lstm.lstm_train_fwd_persistent(xf, wf, False, plan),
            *cuda_lstm.lstm_train_fwd_persistent(xb, wb, True, plan))
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(got, pair))
    ref = cuda_lstm.lstm_train_fwd2_plain(xf, xb, wf, wb)
    for d, (x, w, rev) in enumerate(((xf, wf, False), (xb, wb, True))):
        mine, plain = got[3 * d:3 * d + 3], ref[3 * d:3 * d + 3]
        stale = lstm_scan_stale_h(x, w, rev, residuals=True)
        if dtype == torch.bfloat16:
            _hold_residuals(mine, plain, stale)
            continue
        _hold_f32(mine, plain, stale)
        for g, r, f in zip(mine, plain, lstm_scan_tf32(x, w, rev, residuals=True)):
            assert _err(g, r) < F32_LIMIT <= _err(f, r)


def test_fwd2_route_follows_the_plan(dev):
    """K9 takes K9p in bfloat16 and float32 where K4p has a plan, K4's
    walk once a direction where none does (float32 at H = 1020); each
    launch counts in K9's routes, none in K4's."""
    rng = np.random.default_rng(61)
    for dtype in (torch.bfloat16, torch.float32):
        xf, xb, wf, wb = _two_directions(rng, dev, dtype, H)[:4]
        cuda_lstm.reset_launch_counts()
        cuda_lstm.lstm_train_fwd2(xf, xb, wf, wb)
        assert cuda_lstm.route_counts("lstm_train_fwd2") == {"persistent": 2, "walk": 0}
    assert cuda_lstm.scan_route(torch.float32, 3, 1020, 132) is None
    xf, xb = (_t(rng, dev, torch.float32, 3, 2, 4 * 1020) for _ in range(2))
    wf, wb = (_t(rng, dev, torch.float32, 1020, 4 * 1020, scale=1020 ** -0.5) for _ in range(2))
    cuda_lstm.reset_launch_counts()
    got = cuda_lstm.lstm_train_fwd2(xf, xb, wf, wb)
    assert cuda_lstm.route_counts("lstm_train_fwd2") == {"persistent": 0, "walk": 2}
    assert cuda_lstm.launch_counts()["lstm_train_fwd"] == 0
    single = (*cuda_lstm.lstm_train_fwd_walk(xf, wf, False),
              *cuda_lstm.lstm_train_fwd_walk(xb, wb, True))
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(got, single))


@pytest.mark.parametrize("dtype,sms", [(torch.bfloat16, 2), (torch.float32, 3)],
                         ids=["bf16", "f32"])
def test_bwd2_split_route_on_few_sms(dev, monkeypatch, dtype, sms):
    """Where the SMs hold one direction's grid but not two (H = 128 on 2 or
    3 SMs, as the flow band in float32 on 132), the routed K10 takes K5p's
    plan with one launch a direction: two launches in
    ``route_counts(...)["persistent_split"]``, none in K5's, and bitwise
    two lstm_train_bwd_persistent launches; held against the plain version."""
    monkeypatch.setattr(cuda_lstm, "_sm_count", lambda _: sms)
    shape = (13, 9, 128)
    assert cuda_lstm.plan_backward(13, 128, sms, elem=dtype.itemsize, dirs=2) is None
    plan = cuda_lstm.backward2_route(dtype, 13, 128, sms)
    assert plan.dirs == 1 and plan.S > 1
    args = _bwd2_case(dev, shape, dtype, 62)
    cuda_lstm.reset_launch_counts()
    got = cuda_lstm.lstm_train_bwd2(*args)
    assert cuda_lstm.route_counts("lstm_train_bwd2") == {"persistent": 0, "walk": 0,
                                                         "persistent_split": 2}
    assert cuda_lstm.launch_counts()["lstm_train_bwd"] == 0
    assert cuda_lstm.lstm_bwd_dw.launches == 2
    res_f, res_b, df, db, wf, wb = args
    single = (*cuda_lstm.lstm_train_bwd_persistent(*res_f, df, wf, False, plan),
              *cuda_lstm.lstm_train_bwd_persistent(*res_b, db, wb, True, plan))
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(got, single))
    _hold_bwd2(got, cuda_lstm.lstm_train_bwd2_plain(*args), args, dtype == torch.float32)
