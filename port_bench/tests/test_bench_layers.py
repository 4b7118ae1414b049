"""The traced round by the port's own spans (``layers.py``): its
reduction on a hand-made trace, the launch counters read over the traced
round, and a tiny run of each cell with the port's spans on."""

from __future__ import annotations

import time

import pytest

from port_bench import layers, trace

E = trace.Ev
BWD = trace.BACKWARD_PREFIX


def _hand_trace():
    """One training step: thread 1 the caller, 2 autograd's; runtime calls
    on 99 (thread 1's) and 98 (thread 2's)."""
    return [
        E("bench.window", "span", 0, 1000, thread=1, corr=1),
        E("train.forward", "span", 0, 300, thread=1, corr=20),
        E("model.forward", "span", 10, 290, thread=1, corr=21),
        E("model.band_split", "span", 20, 60, thread=1, corr=22),
        E("aten::einsum", "op", 25, 35, thread=1, corr=3, seq=5),
        E("model.layer", "span", 70, 250, thread=1, corr=23),
        E("lstm.op", "span", 80, 240, thread=1, corr=24),
        E("aten::addmm", "op", 90, 100, thread=1, corr=4, seq=6),
        E("BiLSTMTrain", "op", 110, 230, thread=1, corr=5, seq=7),
        E("train.backward", "span", 300, 700, thread=1, corr=25),
        E(BWD + ": EinsumBackward0", "op", 400, 500, thread=2, corr=8, seq=5, fwd_thread=1),
        E("aten::mm", "op", 410, 440, thread=2, corr=9),
        E(BWD + ": BiLSTMTrainBackward", "op", 500, 650, thread=2, corr=10, seq=7,
          fwd_thread=1),
        E("lstm.op", "span", 520, 640, thread=2, corr=26),
        E("train.adamw", "span", 700, 800, thread=1, corr=27),
        E("aten::_foreach_add", "op", 710, 790, thread=1, corr=11),
        E("cudaLaunchKernel", "runtime", 26, 27, thread=99, corr=101),
        E("cudaLaunchKernel", "runtime", 91, 92, thread=99, corr=102),
        E("cudaLaunchKernel", "runtime", 111, 112, thread=99, corr=103),
        E("cudaLaunchKernel", "runtime", 415, 416, thread=98, corr=104),
        E("cuLaunchKernel", "runtime", 525, 526, thread=98, corr=105),
        E("cudaLaunchKernel", "runtime", 711, 712, thread=99, corr=106),
        E("einsum_kernel", "device", 40, 50, corr=101, linked=3),
        E("gemm", "device", 100, 120, corr=102, linked=4),
        E("scan_persistent_kernel<float, false, false, true>", "device", 150, 260, corr=103,
          linked=5),
        E("mm_bwd", "device", 420, 445, corr=104, linked=9),
        # launched through ctypes: no linked op, the runtime call's thread mapped
        E("bwd_persistent_kernel<float, false>", "device", 530, 600, corr=105, linked=0),
        E("adam", "device", 720, 760, corr=106, linked=11),
    ]


def test_idle_goes_to_the_innermost_span_and_nodes_to_their_forward_op():
    idle = layers.reduce_layers(_hand_trace(), (0, 1000)).idle_s
    # [0, 40): inside model.band_split; [50, 100): model.layer; [445, 530): the
    # einsum's backward node, whose forward op ran in model.band_split
    assert idle["model"] == pytest.approx((40 + 50 + 85) / 1e9)
    # [120, 150): BiLSTMTrain inside lstm.op inside model.layer inside model.forward
    assert idle["lstm"] == pytest.approx(30 / 1e9)
    # [260, 420) and [600, 720): in train.backward, no node open
    assert idle["entry"] == pytest.approx((160 + 120) / 1e9)
    assert idle["none"] == pytest.approx(240 / 1e9)  # after every span


def test_a_gap_in_a_backward_node_without_its_own_span_takes_its_forward_span():
    evs = [e for e in _hand_trace() if e.name != "model.band_split"]
    idle = layers.reduce_layers(evs, (0, 1000)).idle_s
    # the einsum now ran in model.forward alone: the node's gap stays in the model
    # layer; [0, 40) falls to model.forward
    assert idle["model"] == pytest.approx((40 + 50 + 85) / 1e9)
    no_nodes = [e for e in evs if not e.name.startswith(BWD)]
    idle = layers.reduce_layers(no_nodes, (0, 1000)).idle_s
    assert idle["entry"] == pytest.approx((160 + 85 + 120) / 1e9)  # train.backward's


def test_device_time_per_span_with_backward_nodes():
    r = layers.reduce_layers(_hand_trace(), (0, 1000))
    s = r.span_s
    assert s["model.band_split"] == pytest.approx((10 + 25) / 1e9)
    assert s["lstm.op"] == pytest.approx((20 + 110 + 70) / 1e9)  # nested lstm.op once
    assert s["model.layer"] == s["lstm.op"]
    assert s["model.forward"] == pytest.approx(235 / 1e9) == s["train.forward"]
    assert s["train.adamw"] == pytest.approx(40 / 1e9)
    assert s["train.backward"] == 0.0  # its kernels ran in autograd's nodes
    assert r.counts == {"train.forward": 1, "model.forward": 1, "model.band_split": 1,
                        "model.layer": 1, "lstm.op": 2, "train.backward": 1,
                        "train.adamw": 1}


def test_the_port_spans_leave_the_benchmark_reduction_as_it_was():
    evs = _hand_trace()
    bench_only = [e for e in evs if not layers.port_layer(e.name)]
    a, b = trace.reduce(evs, (0, 1000)), trace.reduce(bench_only, (0, 1000))
    assert (a.busy_s, a.device_s, a.by_group, a.span_s) == (b.busy_s, b.device_s, b.by_group,
                                                            b.span_s)
    assert layers.reduce_layers(bench_only, (0, 1000)).counts == {}


def test_the_launch_counters_are_read_over_the_traced_round(tiny):
    from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm as cl

    def counting(prog):
        step = prog.step

        def counted(*a, **k):
            cl.lstm_scan.launches += 2
            cl.lstm_scan.routes["walk"] += 1
            cl.lstm_bwd_dw.launches += 1
            return step(*a, **k)
        prog.step = counted

    cell = layers.LayerCell(tiny, "bsrnn196.train", 2 ** 31 + 5, 0.0, True, "cpu",
                            time.perf_counter(), hook=counting)
    try:
        out = cell.run()
    finally:
        cl.reset_launch_counts()
    steps = len(tiny.traffic("train")["rates"])
    summary = cell.summary(out)
    assert summary["lstm_launches"] == 3 * steps
    assert summary["lstm_launches_per_forward"] == 3.0
    assert summary["lstm_walk_launches"] == steps


@pytest.mark.parametrize("cell,spans", [
    ("bsrnn196.train", {"train.h2d": 0, "train.forward": 1, "train.backward": 1,
                        "train.grad_norm": 1, "train.clip": 1, "train.adamw": 1,
                        "model.forward": 1, "model.loss": 1, "lstm.op": 1}),
    ("flowse384.enhance", {"entry.pad": 1, "entry.h2d": 1, "entry.d2h": 1,
                           "entry.normalize": 1, "flow.prior": 1, "flow.step": 1,
                           "model.forward": 1, "lstm.op": 1})])
def test_a_traced_round_with_the_port_spans_on(tiny, cell, spans):
    """Every span the cell's path records is there at least once (the
    benchmark copies a training batch itself, so ``train.h2d`` is not), the
    idle time falls to the port's layers, and the spans are off again."""
    from urgent2026_challenge_track1_tpu_torch import tracing

    c = layers.LayerCell(tiny, cell, 2 ** 31 + 11, 0.0, True, "cpu", time.perf_counter())
    out = c.run()
    assert out["correct"], out["checks"]
    assert not tracing.enabled()
    counts = c.summary(out)["span_counts"]
    assert {n: min(counts.get(n, 0), 1) for n in spans} == spans
    idle = c.layers.idle_s
    assert idle.get("none", 0.0) < 0.5 * sum(idle.values())
