"""The port's ONNX executor (``ops/onnx_torch.py``) against the JAX package's
(``ops/onnx_jax.py``) on the CPU.

Every graph is written by both packages' ``onnx_lite.dumps`` (the bytes must
be equal), then run by ``onnx_jax.InferenceSession(jit=False)`` and by the
port's session on ``device="cpu"``.  Tolerance: float outputs within 1e-5
of max|JAX| (float32 arithmetic in both; only summation order differs),
integer and bool outputs equal, dtypes and shapes equal.  The cases are
those of ``tests/test_onnx_jax.py`` plus the places where torch and jnp
differ: negative slice steps, negative Gather indices, 64-bit operands,
Pad on a leading axis, asymmetric conv and pool padding.
"""

import struct

import numpy as np
import pytest
import torch

from urgent2026_challenge_track1_tpu.ops import onnx_jax
from urgent2026_challenge_track1_tpu.utils import onnx_lite as jlite
from urgent2026_challenge_track1_tpu_torch.ops import onnx_torch
from urgent2026_challenge_track1_tpu_torch.utils import onnx_lite as tlite

torch.set_num_threads(1)
REL_TOL = 1e-5
INT32_MAX = np.iinfo(np.int32).max


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _bytes(nodes, inits, inputs, outputs, shapes=None, opset=17):
    """The serialized model, written by both packages' writers (equal)."""
    def dumps(lite):
        g = lite.Graph(nodes=[lite.Node(*n) for n in nodes], initializers=dict(inits),
                       inputs=list(inputs), outputs=list(outputs), input_shapes=shapes or {})
        return lite.dumps(lite.Model(graph=g, opset=opset))

    data = dumps(tlite)
    assert data == dumps(jlite)
    return data


def _assert_match(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype, (g.shape, g.dtype, r.shape, r.dtype)
        if np.issubdtype(r.dtype, np.floating):
            assert np.all(np.isfinite(g) == np.isfinite(r))
            fin = np.isfinite(r)
            err = np.max(np.abs(g[fin] - r[fin]), initial=0.0)
            assert err <= REL_TOL * np.max(np.abs(r[fin]), initial=0.0), err
        else:
            np.testing.assert_array_equal(g, r)


def _run_both(data, feed, names=None):
    ref = onnx_jax.InferenceSession(data, jit=False).run(names, feed)
    got = onnx_torch.InferenceSession(data, device="cpu").run(names, feed)
    _assert_match(got, ref)
    return got, ref


# -- graph cases: (nodes, initializers, inputs, outputs, feed[, opset]) ------


def _gemm():
    rng = _rng(1)
    return ([("Gemm", ["x", "w", "b"], ["y"], {"transB": 1, "alpha": 1.5, "beta": 0.5})],
            {"w": _f32(rng, 4, 3), "b": _f32(rng, 4)}, ["x"], ["y"], {"x": _f32(rng, 2, 3)})


def _conv(pads, strides, group):
    def case():
        rng = _rng(2)
        return ([("Conv", ["x", "w", "b"], ["y"], {"pads": pads, "strides": strides,
                                                  "group": group})],
                {"w": _f32(rng, 6, 4 // group, 3, 3), "b": _f32(rng, 6)}, ["x"], ["y"],
                {"x": _f32(rng, 1, 4, 9, 8)})
    return case


def _conv_asym(attrs, rank):
    """Asymmetric padding: explicit (lo, hi) and SAME_UPPER / SAME_LOWER at
    stride 2 on even sizes, where the total pad is odd."""
    def case():
        rng = _rng(20)
        spatial = (10, 8, 6)[:rank]
        return ([("Conv", ["x", "w", "b"], ["y"], attrs)],
                {"w": _f32(rng, 5, 3, *(3,) * rank), "b": _f32(rng, 5)}, ["x"], ["y"],
                {"x": _f32(rng, 2, 3, *spatial)})
    return case


def _small_cnn():
    rng = _rng(3)
    inits = {"w1": _f32(rng, 3, 1, 3, 3), "bns": rng.uniform(0.5, 1.5, 3).astype(np.float32),
             "bnb": _f32(rng, 3), "bnm": _f32(rng, 3),
             "bnv": rng.uniform(0.5, 2.0, 3).astype(np.float32),
             "w2": _f32(rng, 1, 3), "b2": _f32(rng, 1)}
    return ([("Conv", ["x", "w1"], ["c"], {"pads": [1, 1, 1, 1]}),
             ("BatchNormalization", ["c", "bns", "bnb", "bnm", "bnv"], ["n"], {"epsilon": 1e-5}),
             ("Relu", ["n"], ["r"], {}),
             ("MaxPool", ["r"], ["p"], {"kernel_shape": [2, 2], "strides": [2, 2]}),
             ("GlobalAveragePool", ["p"], ["g"], {}),
             ("Flatten", ["g"], ["f"], {}),
             ("Gemm", ["f", "w2", "b2"], ["l"], {"transB": 1}),
             ("Sigmoid", ["l"], ["y"], {})],
            inits, ["x"], ["y"], {"x": _f32(rng, 2, 1, 12, 10)})


def _avgpool(attrs, width=4):
    def case():
        x = _f32(_rng(21), 1, 2, 5, width) if width != 4 else np.ones((1, 1, 4, 4), np.float32)
        return ([("AveragePool", ["x"], ["y"], attrs)], {}, ["x"], ["y"], {"x": x})
    return case


def _reshape_concat():
    rng = _rng(4)
    return ([("Reshape", ["x", "tgt"], ["f"], {}), ("Concat", ["f", "f"], ["y"], {"axis": 1})],
            {"tgt": np.array([2, 12], np.int64)}, ["x"], ["y"], {"x": _f32(rng, 2, 3, 4)})


def _lstm(direction, with_state=False):
    def case():
        rng = _rng(5)
        T, B, I, H = 5, 2, 3, 4
        nd = 2 if direction == "bidirectional" else 1
        inits = {"w": _f32(rng, nd, 4 * H, I, scale=0.4), "r": _f32(rng, nd, 4 * H, H, scale=0.4),
                 "b": _f32(rng, nd, 8 * H, scale=0.1)}
        ins = ["x", "w", "r", "b"]
        feed = {"x": _f32(rng, T, B, I)}
        if with_state:
            ins += ["", "h0", "c0"]
            feed.update(h0=_f32(rng, nd, B, H, scale=0.5), c0=_f32(rng, nd, B, H, scale=0.5))
        return ([("LSTM", ins, ["y", "hn", "cn"], {"hidden_size": H, "direction": direction})],
                inits, [k for k in feed], ["y", "hn", "cn"], feed)
    return case


def _gru(lbr, direction):
    def case():
        rng = _rng(8)
        T, B, I, H = 5, 2, 3, 4
        nd = 2 if direction == "bidirectional" else 1
        inits = {"w": _f32(rng, nd, 3 * H, I, scale=0.4), "r": _f32(rng, nd, 3 * H, H, scale=0.4),
                 "b": _f32(rng, nd, 6 * H, scale=0.1)}
        return ([("GRU", ["x", "w", "r", "b"], ["y", "hn"],
                  {"hidden_size": H, "linear_before_reset": lbr, "direction": direction})],
                inits, ["x"], ["y", "hn"], {"x": _f32(rng, T, B, I)})
    return case


def _slice_gather_reduce():
    rng = _rng(6)
    return ([("Slice", ["x", "st", "en", "ax"], ["s"], {}),
             ("ReduceMean", ["s"], ["y"], {"axes": [1], "keepdims": 0})],
            {"st": np.array([2], np.int64), "en": np.array([6], np.int64),
             "ax": np.array([1], np.int64)}, ["x"], ["y"], {"x": _f32(rng, 3, 8)})


def _relu_facade():
    return ([("Relu", ["input_1"], ["out"], {})], {}, ["input_1"], ["out"],
            {"input_1": np.array([[-1.0, 2.0, -3.0, 4.0, 0.0]], np.float32)})


def _shape_idiom():
    rng = _rng(7)
    return ([("Shape", ["x"], ["shp"], {}),
             ("Gather", ["shp", "zero"], ["b"], {"axis": 0}),
             ("Unsqueeze", ["b"], ["bu"], {"axes": [0]}),
             ("Concat", ["bu", "minus1"], ["tgt"], {"axis": 0}),
             ("Reshape", ["x", "tgt"], ["y"], {})],
            {"zero": np.array(0, np.int64), "minus1": np.array([-1], np.int64)},
            ["x"], ["y"], {"x": _f32(rng, 2, 3, 4)})


def _maxpool(attrs, x):
    def case():
        return ([("MaxPool", ["x"], ["y"], attrs)], {}, ["x"], ["y"], {"x": x})
    return case


def _split():
    return ([("Split", ["x"], ["a", "b", "c"], {"axis": 0})], {}, ["x"], ["a", "b", "c"],
            {"x": np.arange(10, dtype=np.float32)})


def _softmax(opset, axis=None):
    def case():
        attrs = {} if axis is None else {"axis": axis}
        return ([("Softmax", ["x"], ["y"], attrs)], {}, ["x"], ["y"],
                {"x": _f32(_rng(9), 2, 2, 3)}, opset)
    return case


def _shape_attrs(attrs):
    def case():
        return ([("Shape", ["x"], ["s"], attrs)], {}, ["x"], ["s"], {"x": _f32(_rng(11), 2, 3, 4)})
    return case


def _reduce_empty(noop):
    def case():
        attrs = {"keepdims": 0, "noop_with_empty_axes": noop} if noop else {"keepdims": 0}
        return ([("ReduceSum", ["x", "ax"], ["y"], attrs)], {"ax": np.array([], np.int64)},
                ["x"], ["y"], {"x": _f32(_rng(12), 2, 3)})
    return case


def _reduceprod_numel():
    return ([("Shape", ["x"], ["s"], {}), ("ReduceProd", ["s"], ["n"], {"keepdims": 1}),
             ("Reshape", ["x", "n"], ["y"], {})], {}, ["x"], ["y"], {"x": _f32(_rng(13), 2, 3, 4)})


def _pad(pads, attrs, axes=None, shape=(2, 5)):
    def case():
        inits = {"p": np.array(pads, np.int64)}
        ins = ["x", "p"]
        if axes is not None:
            inits["ax"] = np.array(axes, np.int64)
            ins += ["", "ax"]
        return ([("Pad", ins, ["y"], attrs)], inits, ["x"], ["y"],
                {"x": _f32(_rng(14), *shape)})
    return case


def _pad_value():
    return ([("Pad", ["x", "p", "v"], ["y"], {})],
            {"p": np.array([1, 0, 2, 1, 0, 0], np.int64), "v": np.array(-2.5, np.float32)},
            ["x"], ["y"], {"x": _f32(_rng(22), 2, 3, 4)})


def _negative_slice(starts, ends, axes, steps):
    """Negative steps: x[::-1] on a tensor is refused by torch."""
    def case():
        inits = {k: np.array(v, np.int64) for k, v in
                 (("st", starts), ("en", ends), ("ax", axes), ("sp", steps))}
        return ([("Slice", ["x", "st", "en", "ax", "sp"], ["y"], {})], inits, ["x"], ["y"],
                {"x": _f32(_rng(15), 4, 7, 3)})
    return case


def _negative_gather():
    rng = _rng(16)
    return ([("Gather", ["x", "i"], ["y"], {"axis": 1}),
             ("Gather", ["x", "j"], ["z"], {"axis": 0})],
            {"i": np.array([[-1, 0], [2, -3]], np.int64), "j": np.array(-2, np.int64)},
            ["x"], ["y", "z"], {"x": _f32(rng, 3, 4, 2)})


def _float64_operands():
    """A float64 initializer meeting a float32 input: JAX (64-bit off)
    computes and returns float32, where torch would promote to float64."""
    rng = _rng(17)
    return ([("Add", ["x", "b64"], ["s"], {}),
             ("MatMul", ["s", "w64"], ["y"], {}),
             ("Mul", ["y", "half"], ["z"], {})],
            {"b64": rng.standard_normal(3), "w64": rng.standard_normal((3, 2)),
             "half": np.array(0.5)}, ["x"], ["z"], {"x": _f32(rng, 4, 3)})


def _int_ops():
    """Integer tensors: int64 inputs compute in int32 in both packages."""
    return ([("Add", ["a", "b"], ["s"], {}),
             ("ReduceSum", ["s"], ["r"], {"axes": [1], "keepdims": 0}),
             ("Cast", ["r"], ["f"], {"to": 1}),
             ("Gather", ["a", "i"], ["g"], {"axis": 1}),
             ("Shape", ["a"], ["shp"], {}),
             ("Greater", ["a", "b"], ["gt"], {})],
            {"b": np.array([[1, -2, 3]], np.int64), "i": np.array([2, -1], np.int64)},
            ["a"], ["r", "f", "g", "shp", "gt"],
            {"a": np.arange(12, dtype=np.int64).reshape(4, 3) - 5})


def _op_zoo(part):
    """Every remaining op of the executor's set, chained on one tensor, in
    two parts: the elementwise ops, then the norms, reductions and shapes."""
    rng = _rng(18)
    inits = {"lns": _f32(rng, 4), "lnb": _f32(rng, 4),
             "ins": _f32(rng, 3), "inb": _f32(rng, 3), "lo": np.array(-0.5, np.float32),
             "hi": np.array(0.8, np.float32), "two": np.array(2.0, np.float32),
             "shape4": np.array([2, 3, 4, 1], np.int64), "cshape": np.array([2, 3], np.int64),
             "ax0": np.array([0], np.int64), "sizes": np.array([1, 2], np.int64)}
    nodes = [
        ("Transpose", ["x"], ["t"], {"perm": [0, 2, 1]}),          # (2, 4, 3)
        ("Transpose", ["t"], ["tt"], {}),                          # (3, 4, 2)
        ("LeakyRelu", ["x"], ["lr"], {"alpha": 0.2}),
        ("Elu", ["lr"], ["el"], {"alpha": 0.7}),
        ("Gelu", ["el"], ["ge"], {}),
        ("Gelu", ["el"], ["get"], {"approximate": "tanh"}),
        ("Clip", ["get", "lo", "hi"], ["cl"], {}),
        ("Dropout", ["cl"], ["dr"], {}),
        ("Erf", ["dr"], ["er"], {}),
        ("Softplus", ["er"], ["sp"], {}),
        ("Abs", ["x"], ["ab"], {}),
        ("Sqrt", ["ab"], ["sq"], {}),
        ("Log", ["sq"], ["lg"], {}),
        ("Exp", ["er"], ["ex"], {}),
        ("Neg", ["ex"], ["ng"], {}),
        ("Floor", ["x"], ["fl"], {}),
        ("Ceil", ["x"], ["ce"], {}),
        ("Pow", ["sq", "two"], ["pw"], {}),
        ("Div", ["pw", "ex"], ["dv"], {}),
        ("Sub", ["dv", "ng"], ["sb"], {}),
        ("Max", ["sb", "fl"], ["mx"], {}),
        ("Min", ["mx", "ce"], ["mn"], {}),
        ("Less", ["x", "lo"], ["ls"], {}),
        ("Equal", ["fl", "ce"], ["eq"], {}),
        ("Where", ["ls", "mn", "lg"], ["wh"], {}),
    ] if part == "elementwise" else [
        ("LayerNormalization", ["x", "lns", "lnb"], ["ln"], {"epsilon": 1e-5}),
        ("InstanceNormalization", ["ln", "ins", "inb"], ["inn"], {"epsilon": 1e-5}),
        ("Reshape", ["inn", "shape4"], ["r4"], {}),
        ("GlobalMaxPool", ["r4"], ["gm"], {}),
        ("Squeeze", ["gm"], ["sqz"], {"axes": [2, 3]}),
        ("Unsqueeze", ["sqz", "ax0"], ["usq"], {}),
        ("Expand", ["usq", "cshape"], ["exp"], {}),
        ("ReduceMax", ["inn"], ["rmax"], {"axes": [2], "keepdims": 0}),
        ("ReduceMin", ["inn"], ["rmin"], {"axes": [-1], "keepdims": 1}),
        ("ReduceProd", ["inn"], ["rprod"], {"axes": [1, 2], "keepdims": 0}),
        ("ReduceSum", ["inn"], ["rsum"], {"axes": [0, 2], "keepdims": 1}),
        ("Identity", ["inn"], ["idn"], {}),
        ("Split", ["inn", "sizes"], ["s1", "s2"], {"axis": 1}),
        ("ConstantOfShape", ["cshape"], ["cos"], {"value": np.array([1.5], np.float32)}),
        ("Add", ["cos", "rmax"], ["cadd"], {}),
        ("Constant", [], ["k"], {"value": np.array([0.25, -1.0, 2.0, 0.5], np.float32)}),
        ("Mul", ["s1", "k"], ["km"], {}),
    ]
    outs = (["tt", "eq", "sp", "wh"] if part == "elementwise" else
            ["exp", "rmin", "rprod", "rsum", "idn", "s2", "cadd", "km"])
    used = {i for n in nodes for i in n[1]}
    return (nodes, {k: v for k, v in inits.items() if k in used}, ["x"], outs,
            {"x": _f32(rng, 2, 3, 4)})


CASES = {
    "gemm": _gemm,
    "conv pads 1": _conv([1, 1, 1, 1], [1, 1], 1),
    "conv stride 2": _conv([0, 0, 0, 0], [2, 2], 1),
    "conv groups": _conv([2, 1, 2, 1], [1, 2], 2),
    "conv explicit lo != hi": _conv_asym({"pads": [0, 2, 1, 0], "strides": [2, 1]}, 2),
    "conv SAME_UPPER stride 2": _conv_asym({"auto_pad": "SAME_UPPER", "strides": [2, 2]}, 2),
    "conv SAME_LOWER dilated": _conv_asym({"auto_pad": "SAME_LOWER", "strides": [2, 1],
                                           "dilations": [1, 2]}, 2),
    "conv1d SAME_UPPER": _conv_asym({"auto_pad": "SAME_UPPER", "strides": [2]}, 1),
    "conv3d pads": _conv_asym({"pads": [1, 0, 2, 0, 1, 1]}, 3),
    "small cnn": _small_cnn,
    "avgpool count exclude": _avgpool({"kernel_shape": [3, 3], "strides": [1, 1],
                                       "pads": [1, 1, 1, 1]}),
    "avgpool ceil crop exclude": _avgpool({"kernel_shape": [2, 2], "strides": [2, 3],
                                           "pads": [0, 0, 1, 2], "ceil_mode": 1}, width=5),
    "avgpool ceil crop include": _avgpool({"kernel_shape": [2, 2], "strides": [2, 3],
                                           "pads": [0, 0, 1, 2], "ceil_mode": 1,
                                           "count_include_pad": 1}, width=5),
    "reshape concat": _reshape_concat,
    "lstm iofc": _lstm("forward"),
    "lstm reverse": _lstm("reverse"),
    "lstm bidirectional with state": _lstm("bidirectional", with_state=True),
    "gru lbr 0": _gru(0, "forward"),
    "gru lbr 1": _gru(1, "forward"),
    "gru bidirectional": _gru(1, "bidirectional"),
    "slice gather reduce": _slice_gather_reduce,
    "relu facade": _relu_facade,
    "shape gather concat reshape": _shape_idiom,
    "maxpool ceil": _maxpool({"kernel_shape": [1, 2], "strides": [1, 2], "ceil_mode": 1},
                             np.arange(7, dtype=np.float32).reshape(1, 1, 1, 7)),
    "maxpool dilations": _maxpool({"kernel_shape": [1, 2], "strides": [1, 1],
                                   "dilations": [1, 2]},
                                  np.arange(6, dtype=np.float32).reshape(1, 1, 1, 6)),
    "maxpool ceil ignores padding windows": _maxpool(
        {"kernel_shape": [1, 2], "strides": [1, 3], "pads": [0, 0, 0, 2], "ceil_mode": 1},
        np.arange(5, dtype=np.float32).reshape(1, 1, 1, 5)),
    "maxpool SAME_UPPER ceil": _maxpool(
        {"kernel_shape": [3, 2], "strides": [2, 2], "auto_pad": "SAME_UPPER", "ceil_mode": 1},
        _f32(_rng(23), 2, 3, 7, 5)),
    "maxpool1d pads": _maxpool({"kernel_shape": [3], "strides": [2], "pads": [1, 2]},
                               _f32(_rng(24), 1, 2, 9)),
    "split uneven": _split,
    "softmax opset 11": _softmax(11),
    "softmax opset 11 axis 2": _softmax(11, axis=2),
    "softmax opset 17": _softmax(17),
    "shape start": _shape_attrs({"start": 1}),
    "shape end": _shape_attrs({"end": -1}),
    "reduce empty axes": _reduce_empty(0),
    "reduce empty axes noop": _reduce_empty(1),
    "reduceprod numel": _reduceprod_numel,
    "pad crop": _pad([0, -1, 0, -2], {}),
    "pad wrap": _pad([0, 2, 0, 0], {"mode": "wrap"}),
    "pad axes": _pad([1, 2], {}, axes=[1]),
    "pad value": _pad_value,
    "pad reflect axis 1": _pad([0, 2, 0, 0, 1, 0], {"mode": "reflect"}, shape=(2, 3, 4)),
    "pad edge axis 1": _pad([0, 3, 1, 0, 2, 0], {"mode": "edge"}, shape=(2, 3, 4)),
    "pad reflect wider than axis": _pad([0, 4, 0, 0, 5, 0], {"mode": "reflect"},
                                        shape=(2, 3, 4)),
    "slice step -1 to start": _negative_slice([-1], [-INT32_MAX - 1], [1], [-1]),
    "slice step -2 int32 max end": _negative_slice([5, 3], [INT32_MAX, 0], [1, 0], [-2, -1]),
    "slice step -1 and +2": _negative_slice([2, 0], [-6, 10], [1, 2], [-1, 2]),
    "gather negative indices": _negative_gather,
    "float64 initializer with float32 input": _float64_operands,
    "int64 inputs": _int_ops,
    "op zoo elementwise": lambda: _op_zoo("elementwise"),
    "op zoo norms and shapes": lambda: _op_zoo("shapes"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_session_matches_jax(name):
    nodes, inits, inputs, outputs, feed, *opset = CASES[name]()
    data = _bytes(nodes, inits, inputs, outputs, opset=opset[0] if opset else 17)
    got, _ = _run_both(data, feed)
    if name == "float64 initializer with float32 input":
        assert got[0].dtype == np.float32  # not torch's promotion to float64


def test_session_facade_matches_jax():
    data = _bytes([("Relu", ["input_1"], ["out"], {}), ("Neg", ["input_1"], ["neg"], {})],
                  {}, ["input_1"], ["out", "neg"], {"input_1": (1, 5)})
    jsess = onnx_jax.InferenceSession(data, jit=False)
    sess = onnx_torch.InferenceSession(data, device="cpu")
    assert [(i.name, i.shape) for i in sess.get_inputs()] == [
        (i.name, i.shape) for i in jsess.get_inputs()] == [("input_1", (1, 5))]
    assert [o.name for o in sess.get_outputs()] == [o.name for o in jsess.get_outputs()]
    x = np.array([[-1.0, 2.0, -3.0, 4.0, 0.0]], np.float32)
    for names in (None, ["neg", "out"], ["out"]):
        _assert_match(sess.run(names, {"input_1": x}), jsess.run(names, {"input_1": x}))
    with pytest.raises(KeyError, match="input_1"):
        sess.run(None, {"x": x})


def test_initializers_are_uploaded_once(monkeypatch):
    """Each initializer (and Constant, and a fold of them) that a compute op
    reads is on the device from the build on; a call uploads only its
    feed."""
    nodes, inits, inputs, outputs, feed = _small_cnn()
    nodes = [("Transpose", ["w2"], ["w2t"], {}),
             ("Constant", [], ["k"], {"value": np.array(2.0, np.float32)})] + [
        ("Gemm", ["f", "w2t", "b2"], ["l"], {"transB": 1}) if n[0] == "Gemm" else n
        for n in nodes
    ] + [("Mul", ["y", "k"], ["y2"], {})]
    inits = {**inits, "w2": inits["w2"].T.copy()}
    data = _bytes(nodes, inits, inputs, ["y2"])
    sess = onnx_torch.InferenceSession(data, device="cpu")
    uploaded = {id(t) for _, t in sess._exec._uploaded.values()}
    assert len(uploaded) == len(inits) + 1  # the weights, the folded w2^T, k; not w2
    calls = []
    real = onnx_torch.OnnxGraphExecutor._upload
    monkeypatch.setattr(onnx_torch.OnnxGraphExecutor, "_upload",
                        lambda self, arr: calls.append(np.shape(arr)) or real(self, arr))
    ref = onnx_jax.InferenceSession(data, jit=False).run(None, feed)
    for _ in range(2):
        _assert_match(sess.run(None, feed), ref)
    assert calls == [feed["x"].shape] * 2


def test_float32_scope_turns_tf32_off_and_restores(monkeypatch):
    """The session's convs and products run with TF32 off; the flags the
    caller had are back after the call, also after a failing one."""
    nodes, inits, inputs, outputs, feed = _small_cnn()
    sess = onnx_torch.InferenceSession(_bytes(nodes, inits, inputs, outputs), device="cpu")
    seen = []
    real = torch.nn.functional.conv2d

    def conv2d(*a, **k):
        seen.append((torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32))
        return real(*a, **k)

    monkeypatch.setattr(onnx_torch.F, "conv2d", conv2d)
    before = (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32)
    try:
        torch.set_float32_matmul_precision("high")
        torch.backends.cudnn.allow_tf32 = True
        sess.run(None, feed)
        assert seen == [("highest", False)]
        assert (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32) == (
            "high", True)
        with pytest.raises(KeyError):
            sess.run(None, {})
        assert (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32) == (
            "high", True)
    finally:
        torch.set_float32_matmul_precision(before[0])
        torch.backends.cudnn.allow_tf32 = before[1]


def test_unsigned_wide_ints_raise():
    """torch has no arithmetic on uint16/32/64: refused with a clear error,
    where a silent cast could change the values."""
    data = _bytes([("Add", ["x", "u"], ["y"], {})], {"u": np.array([1, 2], np.uint32)},
                  ["x"], ["y"])
    sess = onnx_torch.InferenceSession(data, device="cpu")
    with pytest.raises(TypeError, match="uint"):
        sess.run(None, {"x": np.array([1, 2], np.int32)})


def test_unsupported_op_fails_actionably():
    data = _bytes([("NonMaxSuppression", ["x"], ["y"], {}), ("Relu", ["y"], ["z"], {})],
                  {}, ["x"], ["z"])
    with pytest.raises(NotImplementedError, match="NonMaxSuppression"):
        onnx_jax.InferenceSession(data)
    with pytest.raises(NotImplementedError, match=r"\['NonMaxSuppression'\]"):
        onnx_torch.InferenceSession(data, device="cpu")


@pytest.mark.parametrize("rnn, attrs, msg", [
    ("LSTM", {"layout": 1}, "layout"),
    ("LSTM", {"clip": 3.0}, "clip"),
    ("LSTM", {"activations": ["Relu", "Tanh", "Tanh"]}, "activations"),
    ("GRU", {"layout": 1}, "layout"),
    ("GRU", {"activations": ["Sigmoid", "Relu"]}, "activations"),
])
def test_rnn_rejects_semantics_changing_attrs(rnn, attrs, msg):
    rng = _rng(15)
    G = 4 if rnn == "LSTM" else 3
    data = _bytes([(rnn, ["x", "w", "r"], ["y"], {"hidden_size": 2, **attrs})],
                  {"w": _f32(rng, 1, G * 2, 2), "r": _f32(rng, 1, G * 2, 2)}, ["x"], ["y"])
    x = {"x": _f32(rng, 3, 1, 2)}
    for sess in (onnx_jax.InferenceSession(data, jit=False),
                 onnx_torch.InferenceSession(data, device="cpu")):
        with pytest.raises(ValueError, match=msg):
            sess.run(None, x)


def test_rnn_default_activations_pass_case_insensitive():
    rng = _rng(15)
    data = _bytes([("LSTM", ["x", "w", "r"], ["y"],
                    {"hidden_size": 2, "activations": ["Sigmoid", "Tanh", "Tanh"]})],
                  {"w": _f32(rng, 1, 8, 2), "r": _f32(rng, 1, 8, 2)}, ["x"], ["y"])
    _run_both(data, {"x": _f32(rng, 3, 1, 2)})


@pytest.mark.parametrize("seed", range(4))
def test_parser_rejects_garbage_without_crashing(seed):
    junk = _rng(seed).integers(0, 256, 512, dtype=np.uint8).tobytes()
    with pytest.raises((ValueError, KeyError, struct.error, IndexError, TypeError)):
        tlite.loads(junk)


def test_parser_rejects_truncated_model():
    data = _bytes([("Relu", ["x"], ["y"], {})], {}, ["x"], ["y"])
    for cut in (1, len(data) // 2, len(data) - 1):
        with pytest.raises(Exception):
            mm = tlite.loads(data[:cut])
            # a prefix that still parses must at least not invent a graph
            if mm.graph.nodes:
                raise ValueError("parsed garbage graph")


def test_external_data_fails_loudly():
    t = tlite._encode_tensor("w", np.zeros(2, np.float32))
    t += tlite._tag(13, 2) + tlite._write_varint(0)
    with pytest.raises(ValueError, match="external"):
        tlite._decode_tensor(memoryview(t))


def test_parsed_graph_equals_jax_parse():
    """The port's parser reads the same graph as the JAX package's from the
    same bytes: nodes, attributes, initializers, inputs, outputs, opset."""
    nodes, inits, inputs, outputs, feed = _op_zoo("shapes")
    data = _bytes(nodes + _op_zoo("elementwise")[0], {**inits, **_op_zoo("elementwise")[1]},
                  inputs, outputs, {"x": (2, "t", 4)}, opset=12)
    a, b = tlite.loads(data), jlite.loads(data)
    assert (a.opset, a.ir_version) == (b.opset, b.ir_version) == (12, 8)
    assert (a.graph.inputs, a.graph.outputs, a.graph.input_shapes) == (
        b.graph.inputs, b.graph.outputs, b.graph.input_shapes)
    assert [(n.op_type, n.inputs, n.outputs, sorted(n.attrs)) for n in a.graph.nodes] == [
        (n.op_type, n.inputs, n.outputs, sorted(n.attrs)) for n in b.graph.nodes]
    for k, v in b.graph.initializers.items():
        assert a.graph.initializers[k].dtype == v.dtype
        np.testing.assert_array_equal(a.graph.initializers[k], v)
