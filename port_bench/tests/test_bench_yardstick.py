"""The counters of the yardstick against hand counts, and the trace
reduction on a hand-made trace."""

from __future__ import annotations

import pytest

from port_bench import trace, yardstick as Y

DISC = {"N": 8, "layers": 2, "n_fft": 960, "hop": 480, "input_dim": 481, "sub_channel": None}
FLOW = {"N": 8, "layers": 1, "n_fft": 1536, "hop": 384, "input_dim": 769, "sub_channel": 16}


def test_utterance_shape_at_48k():
    # 0.5 s at 48 kHz: 24000 + 960 padding -> 1 + (24960 - 960) // 480 = 51 frames, 34 bands
    T, K, subs = Y.utterance_shape(DISC, 48000, 24000)
    assert (T, K, sum(subs)) == (51, 34, 481)


def test_model_flops_by_hand():
    T, K, N, H = 51, 34, 8, 16
    bands = 2 * T * N * 2 * 481
    lstm = 2 * 4 * H * (N + H)
    layer = 2 * 2 * K * T * lstm + 2 * 2 * K * T * 2 * H * N
    heads = 2 * (K * 2 * T * N * 4 * N + 2 * 2 * T * 4 * N * 2 * 481)
    assert Y.model_flops(DISC, 48000, 24000) == bands + 2 * layer + heads


def test_flow_flops_by_hand():
    # 8 kHz, 0.25 s: n_fft 256, hop 64: 1 + (2000 + 256 - 256) // 64 = 32 frames; 29 bands
    T, K, subs = Y.utterance_shape(FLOW, 8000, 2000)
    assert (T, K) == (32, 29)
    N, H, sc, F = 8, 16, 16, sum(subs)
    expect = (2 * 2 * T * N * 2 * F + 2 * T * K * 2 * N * N
              + 2 * 2 * K * T * 2 * 4 * H * (N + H) + 2 * 2 * K * T * 2 * H * N
              + 2 * (2 * T * N * sc * F + 2 * T * F * 25 * sc * 4))
    assert Y.model_flops(FLOW, 8000, 2000) == expect


def test_lstm_least_time_by_hand():
    T, K, N, H = 51, 34, 8, 16
    steps = K * T
    ops = 2 * steps * 2 * 4 * H * (N + H)
    w = 2 * (4 * H * (N + H) + 4 * H)
    nbytes = 2 * (steps * (N + 2 * H) + w)
    one = max(ops / Y.PEAK_BF16_FLOPS, nbytes / Y.PEAK_BYTES)
    assert Y.lstm_least_s(DISC, 48000, [24000], False, "bfloat16") == pytest.approx(4 * one)
    ops3, nb3 = 3 * ops, 4 * (steps * (N + 2 * H) + w) + 4 * steps * (2 * H + N) + 4 * w
    one3 = max(ops3 / Y.PEAK_TF32_FLOPS, nb3 / Y.PEAK_BYTES)
    assert Y.lstm_least_s(DISC, 48000, [24000], True, "float32") == pytest.approx(4 * one3)


def test_copied_bounds_and_union():
    t, by = Y._bound(2 * 989e9, 1.0)
    assert by == "operations" and t == pytest.approx(2.0)
    assert Y._union_us([(0, 2), (1, 3), (5, 6)]) == 4.0
    assert Y._group("void (anonymous namespace)::bwd_persistent_kernel<float, true>(x)") \
        == "K7p-f32 lstm_revmasked_bwd_persistent"


def _hand_trace():
    E = trace.Ev
    return [
        E("bench.window", "span", 0, 1000, thread=1, corr=1),
        E("bench.lstm", "span", 100, 200, thread=1, corr=2),
        E("aten::addmm", "op", 110, 120, thread=1, corr=3, seq=7),
        E("BiLSTMTrain", "op", 130, 190, thread=1, corr=4, seq=8),
        E("aten::mul", "op", 300, 320, thread=1, corr=5, seq=9),          # outside the span
        E("bench.optimizer", "span", 600, 700, thread=1, corr=6),
        E("aten::_foreach_add", "op", 610, 690, thread=1, corr=7),
        E(trace.BACKWARD_PREFIX + ": BiLSTMTrainBackward", "op", 400, 500, thread=2,
          corr=8, seq=8, fwd_thread=1),
        E(trace.BACKWARD_PREFIX + ": MulBackward0", "op", 510, 540, thread=2, corr=9,
          seq=9, fwd_thread=1),
        E("cudaLaunchKernel", "runtime", 112, 113, thread=99, corr=101),
        E("cudaLaunchKernel", "runtime", 140, 141, thread=99, corr=102),
        E("cudaLaunchKernel", "runtime", 305, 306, thread=99, corr=103),
        E("cudaLaunchKernel", "runtime", 420, 421, thread=99, corr=104),
        E("cudaLaunchKernel", "runtime", 520, 521, thread=99, corr=105),
        E("cudaLaunchKernel", "runtime", 620, 621, thread=99, corr=106),
        E("gemm", "device", 150, 160, corr=101, linked=3),
        E("void (anonymous namespace)::scan_persistent_kernel<float, false, false, true>(int)", "device", 160, 260, corr=102,
          linked=4),
        E("mul_kernel", "device", 330, 340, corr=103, linked=5),
        E("bwd_persistent_kernel<float, false>", "device", 430, 480, corr=104, linked=8),
        E("mul_bwd", "device", 525, 530, corr=105, linked=9),
        E("adam", "device", 640, 660, corr=106, linked=7),
        # a kernel launched through ctypes inside the span: no linked op
        E("cudaLaunchCooperativeKernel", "runtime", 180, 181, thread=99, corr=107),
        E("void (anonymous namespace)::fusedin_persistent_kernel<__nv_bfloat16, false>(x)",
          "device", 270, 290, corr=107, linked=0),
    ]


def test_reduce_attributes_kernels_to_spans_and_backward_nodes():
    r = trace.reduce(_hand_trace(), (0, 1000))
    assert r.span_s["bench.lstm"] == pytest.approx((10 + 100 + 50 + 20) / 1e9)
    assert r.span_s["bench.optimizer"] == pytest.approx(20 / 1e9)
    assert r.busy_s == pytest.approx((110 + 20 + 10 + 50 + 5 + 20) / 1e9)
    assert r.device_s == pytest.approx(215 / 1e9) and r.n_device == 7
    assert r.by_group["K4p-f32 lstm_train_fwd_persistent"] == pytest.approx(100 / 1e9)
    assert r.by_group["K1p fusedin_persistent"] == pytest.approx(20 / 1e9)
    gaps = dict(r.gaps)
    assert sum(gaps.values()) == pytest.approx((1000 - 215) / 1e9)
    assert gaps["bench.window"] > 0  # nothing inside the window covers [0, 150)
