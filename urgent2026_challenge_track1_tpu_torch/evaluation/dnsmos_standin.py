"""Stand-in DNSMOS graphs: ONNX models with the real predictors' inputs and
outputs, written with ``utils/onnx_lite`` from a seed.

The DNS-Challenge models are not distributed with the project.  These two
graphs take their place to exercise the executor and ``dnsmos.score_one``
at the real shapes: the primary takes ``(1, 144160)`` raw audio and gives
three scores, the P808 model takes the ``(1, 900, 120)`` log-mel and gives
one.  After ``scores`` each graph also outputs its logits and the features
the head reads, which are not squashed into [1, 5]: a check of the
executor reads those too.  They are small CNNs of the ops that DNSMOS-era exports use (opset
12): Conv with ``auto_pad`` (SAME_UPPER pads asymmetrically at stride 2),
BatchNormalization, Relu, MaxPool with ``ceil_mode``, the exporters'
``Shape -> Gather -> Concat -> Reshape`` idiom, GlobalAveragePool, Gemm,
the opset-12 Softmax and, in the P808 graph, one LSTM.  Their scores lie in
[1, 5]; the numbers mean nothing.
"""

from __future__ import annotations

import numpy as np

from urgent2026_challenge_track1_tpu_torch.utils import onnx_lite

__all__ = ["PRIMARY_SHAPE", "P808_SHAPE", "primary_graph", "p808_graph"]

PRIMARY_SHAPE = (1, 144160)  # int(9.01 * 16000) samples
P808_SHAPE = (1, 900, 120)   # log-mel frames x bands of the window minus 160 samples
OPSET = 12


def _conv_block(nodes, inits, rng, x, c_in, c_out, name, auto_pad):
    """Conv 3x3 stride 2 -> BatchNormalization -> Relu -> MaxPool 3x3 stride
    2 with ceil_mode; returns the block's output name."""
    fan = c_in * 9
    inits[f"{name}_w"] = (rng.standard_normal((c_out, c_in, 3, 3)) / np.sqrt(fan)).astype(
        np.float32)
    inits[f"{name}_b"] = (0.1 * rng.standard_normal(c_out)).astype(np.float32)
    inits[f"{name}_s"] = rng.uniform(0.5, 1.5, c_out).astype(np.float32)
    inits[f"{name}_t"] = (0.1 * rng.standard_normal(c_out)).astype(np.float32)
    inits[f"{name}_m"] = (0.1 * rng.standard_normal(c_out)).astype(np.float32)
    inits[f"{name}_v"] = rng.uniform(0.5, 2.0, c_out).astype(np.float32)
    nodes += [
        ("Conv", [x, f"{name}_w", f"{name}_b"], [f"{name}_c"],
         {"kernel_shape": [3, 3], "strides": [2, 2], "auto_pad": auto_pad}),
        ("BatchNormalization", [f"{name}_c", f"{name}_s", f"{name}_t", f"{name}_m", f"{name}_v"],
         [f"{name}_n"], {"epsilon": 1e-3}),
        ("Relu", [f"{name}_n"], [f"{name}_r"], {}),
        ("MaxPool", [f"{name}_r"], [f"{name}_p"],
         {"kernel_shape": [3, 3], "strides": [2, 2], "ceil_mode": 1}),
    ]
    return f"{name}_p"


def _scores(nodes, inits, rng, feat, n_in, n_out):
    """Gemm -> the opset-12 Softmax over the outputs -> 1 + 4 * a blend of
    the softmax and a sigmoid: scores in [1, 5]."""
    inits["head_w"] = (rng.standard_normal((n_out, n_in)) / np.sqrt(n_in)).astype(np.float32)
    inits["head_b"] = (0.1 * rng.standard_normal(n_out)).astype(np.float32)
    inits["four"] = np.array(4.0, np.float32)
    inits["one"] = np.array(1.0, np.float32)
    inits["half"] = np.array(0.5, np.float32)
    nodes += [
        ("Gemm", [feat, "head_w", "head_b"], ["logits"], {"transB": 1}),
        ("Softmax", ["logits"], ["sm"], {"axis": 1}),
        ("Sigmoid", ["logits"], ["sg"], {}),
        ("Add", ["sm", "sg"], ["blend"], {}),
        ("Mul", ["blend", "half"], ["unit"], {}),
        ("Mul", ["unit", "four"], ["scaled"], {}),
        ("Add", ["scaled", "one"], ["scores"], {}),
    ]


def _model(nodes, inits, shape, feat) -> bytes:
    g = onnx_lite.Graph(nodes=[onnx_lite.Node(*n) for n in nodes], initializers=inits,
                        inputs=["input_1"], outputs=["scores", "logits", feat],
                        input_shapes={"input_1": shape})
    return onnx_lite.dumps(onnx_lite.Model(graph=g, opset=OPSET))


def primary_graph(seed: int = 0, auto_pad: str = "SAME_UPPER") -> bytes:
    """(1, 144160) audio -> (1, 3) scores (then the logits and the (1, 16)
    pooled features): the waveform folded to 901 x 160
    by the Shape idiom, two conv blocks, GlobalAveragePool, Flatten, the
    head.  ``auto_pad`` of the first conv ("SAME_LOWER" mirrors its pads)."""
    rng = np.random.default_rng(seed)
    nodes, inits = [], {"zero": np.array(0, np.int64), "fold": np.array([1, 901, 160], np.int64)}
    nodes += [
        ("Shape", ["input_1"], ["shp"], {}),
        ("Gather", ["shp", "zero"], ["batch"], {"axis": 0}),
        ("Unsqueeze", ["batch"], ["batch1"], {"axes": [0]}),
        ("Concat", ["batch1", "fold"], ["tgt"], {"axis": 0}),
        ("Reshape", ["input_1", "tgt"], ["frames"], {}),       # (1, 1, 901, 160)
        ("Mul", ["frames", "gain"], ["x0"], {}),
    ]
    inits["gain"] = np.array(8.0, np.float32)
    x = _conv_block(nodes, inits, rng, "x0", 1, 8, "b1", auto_pad)
    x = _conv_block(nodes, inits, rng, x, 8, 16, "b2", "SAME_UPPER")
    nodes += [("GlobalAveragePool", [x], ["gap"], {}), ("Flatten", ["gap"], ["feat"], {})]
    _scores(nodes, inits, rng, "feat", 16, 3)
    return _model(nodes, inits, PRIMARY_SHAPE, "feat")


def p808_graph(seed: int = 1, auto_pad: str = "SAME_UPPER") -> bytes:
    """(1, 900, 120) log-mel -> (1, 1) score (then the logit and the (1, 16)
    mean LSTM output): one conv block, the frames as
    an LSTM sequence (Transpose, then the Shape idiom to (T, 1, C * F)),
    the mean over time, the head."""
    rng = np.random.default_rng(seed)
    nodes, inits = [("Unsqueeze", ["input_1"], ["x0"], {"axes": [1]})], {}
    x = _conv_block(nodes, inits, rng, "x0", 1, 8, "b1", auto_pad)  # (1, 8, 225, 30)
    hid, n_in = 16, 8 * 30
    inits["zero"] = np.array(0, np.int64)
    inits["rest"] = np.array([1, -1], np.int64)
    inits["lstm_w"] = (rng.standard_normal((1, 4 * hid, n_in)) / np.sqrt(n_in)).astype(np.float32)
    inits["lstm_r"] = (rng.standard_normal((1, 4 * hid, hid)) / np.sqrt(hid)).astype(np.float32)
    inits["lstm_b"] = (0.1 * rng.standard_normal((1, 8 * hid))).astype(np.float32)
    nodes += [
        ("Transpose", [x], ["tbcf"], {"perm": [2, 0, 1, 3]}),     # (225, 1, 8, 30)
        ("Shape", ["tbcf"], ["shp"], {}),
        ("Gather", ["shp", "zero"], ["steps"], {"axis": 0}),
        ("Unsqueeze", ["steps"], ["steps1"], {"axes": [0]}),
        ("Concat", ["steps1", "rest"], ["tgt"], {"axis": 0}),
        ("Reshape", ["tbcf", "tgt"], ["seq"], {}),                # (225, 1, 240)
        ("LSTM", ["seq", "lstm_w", "lstm_r", "lstm_b"], ["y", "hn", "cn"],
         {"hidden_size": hid}),                                  # y (225, 1, 1, 16)
        ("ReduceMean", ["y"], ["ym"], {"axes": [0, 1], "keepdims": 0}),  # (1, 16)
    ]
    _scores(nodes, inits, rng, "ym", hid, 1)
    return _model(nodes, inits, P808_SHAPE, "ym")
