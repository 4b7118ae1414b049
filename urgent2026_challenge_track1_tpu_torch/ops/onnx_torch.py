"""ONNX graph executor in torch (counterpart of ``ops/onnx_jax.py``).

The reference runs DNSMOS (and other ONNX metric models) through the
onnxruntime C++ runtime.  Here the graph parsed by ``utils/onnx_lite.py``
runs with torch ops on the card (or on the CPU when the caller asks for
it): the metric models need only their ``.onnx`` files.

The op set, the ``NotImplementedError`` for a missing op and the
refusals of RNN attributes are the JAX executor's.  As there, initializers
stay numpy and the shape-pipeline ops fold in numpy when every operand is
numpy, so the exporters' ``Shape -> Gather -> Concat -> Reshape`` idiom
stays static.  The Constants and the folds whose operands are all
initializers or Constants are computed once, when the executor is built,
and each of these values that a compute op reads is uploaded to the
executor's device then: a call copies only its feed to the device.
Values follow the JAX package's dtypes (64-bit off): a float64 operand
computes in float32 and an int64 one in int32.  torch has no arithmetic on
uint16/32/64, so such a tensor reaching a compute op raises.

The session runs eagerly (JAX's ``jit=`` has no counterpart), its convs
and products at full float32: TF32 is off for the call and the flags are
restored after it.  The LSTM and GRU ops are per-step torch loops.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from urgent2026_challenge_track1_tpu_torch import resolve_device
from urgent2026_challenge_track1_tpu_torch.utils import onnx_lite

__all__ = ["OnnxGraphExecutor", "InferenceSession", "full_float32"]

# 64-bit off, as the JAX package's executor runs: jnp.asarray gives these
_CANON = {np.dtype(np.float64): np.dtype(np.float32), np.dtype(np.int64): np.dtype(np.int32)}
_NO_TORCH_ARITH = (np.dtype(np.uint16), np.dtype(np.uint32), np.dtype(np.uint64))
_TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32, np.dtype(np.float16): torch.float16,
    np.dtype(np.int32): torch.int32, np.dtype(np.int16): torch.int16,
    np.dtype(np.int8): torch.int8, np.dtype(np.uint8): torch.uint8,
    np.dtype(np.bool_): torch.bool,
}


def _canon(dtype) -> np.dtype:
    return _CANON.get(np.dtype(dtype), np.dtype(dtype))


def _torch_dtype(dtype) -> torch.dtype:
    dt = _canon(dtype)
    if dt in _NO_TORCH_ARITH:
        raise TypeError(f"ONNX tensor of dtype {dt} reaches a compute op: torch has no "
                        "arithmetic on uint16/uint32/uint64")
    return _TORCH_DTYPES[dt]


@contextlib.contextmanager
def full_float32():
    """Convs and products at full float32 (TF32 off) for the block; the
    process's flags are restored after it."""
    matmul = torch.get_float32_matmul_precision()
    cudnn = torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(matmul)
        torch.backends.cudnn.allow_tf32 = cudnn


def _auto_pads(auto_pad, spatial_in, kernel, strides, dilations):
    """Resolve ONNX auto_pad to explicit per-dimension (lo, hi) pairs."""
    pads = []
    for s_in, k, s, d in zip(spatial_in, kernel, strides, dilations):
        eff = (k - 1) * d + 1
        if auto_pad == "VALID":
            pads.append((0, 0))
            continue
        out = -(-s_in // s)  # ceil
        total = max(0, (out - 1) * s + eff - s_in)
        if auto_pad == "SAME_UPPER":
            pads.append((total // 2, total - total // 2))
        else:  # SAME_LOWER
            pads.append((total - total // 2, total // 2))
    return pads


def _conv_pads(node, spatial_in, kernel, strides, dilations):
    auto_pad = node.attrs.get("auto_pad", "NOTSET")
    if auto_pad not in ("", "NOTSET"):
        return _auto_pads(auto_pad, spatial_in, kernel, strides, dilations)
    pads = node.attrs.get("pads")
    if pads is None:
        return [(0, 0)] * len(kernel)
    n = len(pads) // 2
    return list(zip(pads[:n], pads[n:]))


def _torch_pad(pads):
    """Per-dimension (lo, hi) pairs, first dimension first -> F.pad's flat
    tuple, last dimension first."""
    return tuple(p for lo_hi in reversed(pads) for p in lo_hi)


def _static_ints(v, what):
    """Shape-like operand -> python ints.  The session runs eagerly, so a
    tensor operand is read back from its device."""
    if isinstance(v, torch.Tensor):
        return [int(x) for x in v.detach().cpu().reshape(-1).tolist()]
    return [int(x) for x in np.asarray(v).reshape(-1)]


def _check_rnn_attrs(node, name, default_acts):
    """Reject semantics-changing RNN attributes we do not implement — running
    past them would produce silently wrong numbers, not an error."""
    if node.attrs.get("layout", 0) != 0:
        raise ValueError(f"{name} layout=1 (batch-first) is not supported")
    if node.attrs.get("clip") is not None:
        raise ValueError(f"{name} cell clipping is not supported")
    acts = node.attrs.get("activations")
    if acts is not None:
        acts = [a.lower() for a in acts]
        num_dir = 2 if node.attrs.get("direction", "forward") == "bidirectional" else 1
        if acts != default_acts * num_dir:
            raise ValueError(
                f"{name} non-default activations {acts} are not supported"
            )


def _slice_index(st, en, sp):
    return slice(st, None if en >= np.iinfo(np.int32).max else en, sp)


def _slice_tensor(x, ax, sl):
    """``x[..., sl, ...]`` on axis ``ax``; a negative step (which torch
    indexing refuses) slices the flipped axis."""
    start, stop, step = sl.indices(x.shape[ax])
    if step < 0:
        n = x.shape[ax]
        x, start, stop, step = x.flip(ax), n - 1 - start, n - 1 - stop, -step
    idx = [slice(None)] * x.ndim
    idx[ax] = slice(start, stop, step)
    return x[tuple(idx)]


def _op_slice(node, x, starts=None, ends=None, axes=None, steps=None):
    if starts is None:  # opset-1 attribute form
        starts = node.attrs["starts"]
        ends = node.attrs["ends"]
        axes = node.attrs.get("axes")
    starts = _static_ints(starts, "Slice")
    ends = _static_ints(ends, "Slice")
    axes = list(range(len(starts))) if axes is None else _static_ints(axes, "Slice")
    steps = [1] * len(starts) if steps is None else _static_ints(steps, "Slice")
    if isinstance(x, np.ndarray):  # the numpy fold: numpy indexing stays numpy
        idx = [slice(None)] * x.ndim
        for st, en, ax, sp in zip(starts, ends, axes, steps):
            idx[ax] = _slice_index(st, en, sp)
        return x[tuple(idx)]
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        x = _slice_tensor(x, ax % x.ndim, _slice_index(st, en, sp))
    return x


def _op_reshape(node, x, shape):
    tgt = _static_ints(shape, "Reshape")
    out = []
    for i, d in enumerate(tgt):
        if d == 0 and not node.attrs.get("allowzero", 0):
            out.append(x.shape[i])
        else:
            out.append(d)
    return x.reshape(out)


def _reduce_axes(node, axes_in):
    """The axes tuple of a Reduce node, or None for all; the string "noop"
    where empty axes with noop_with_empty_axes make it an identity."""
    axes = node.attrs.get("axes", axes_in)
    if axes is not None:
        axes = tuple(_static_ints(axes, "Reduce"))
        if len(axes) == 0:
            # empty axes input: ONNX default (noop_with_empty_axes=0) reduces
            # over ALL axes; the opt-in attribute makes it an identity
            return "noop" if node.attrs.get("noop_with_empty_axes", 0) else None
    return axes


class OnnxGraphExecutor:
    """Executes a parsed ONNX graph with torch on ``device`` (the card
    unless the caller asks for the CPU).  Instances are callable with
    keyword arrays (numpy or tensors) matching the graph inputs and return
    the list of graph outputs: tensors on the device, or numpy arrays
    where an output folded in numpy."""

    def __init__(self, model: onnx_lite.Model, device="cuda"):
        self.model = model
        self.graph = model.graph
        self.device = resolve_device(device)
        missing = sorted(
            {n.op_type for n in self.graph.nodes if not self._supported(n.op_type)}
        )
        if missing:
            raise NotImplementedError(
                f"unsupported ONNX op(s): {missing} — extend ops/onnx_torch.py"
            )
        # initializers, Constant values and the numpy folds of nodes whose
        # operands are all such values (the folds the JAX executor makes on
        # every call give the same arrays), computed once; each one a
        # compute op reads is uploaded once (keyed by the array's identity)
        self._static: Dict[str, np.ndarray] = dict(self.graph.initializers)
        self._prefolded = set()
        for i, node in enumerate(self.graph.nodes):
            if node.op_type == "Constant":
                self._static[node.outputs[0]] = self._constant(node)
            elif node.op_type in self._FOLDABLE and node.inputs and all(
                    not n or n in self._static for n in node.inputs):
                out = self._fold_numpy(node, [np.asarray(self._static[n]) if n else None
                                              for n in node.inputs])
                if out is None:
                    continue
                self._static[node.outputs[0]] = np.asarray(out)
            else:
                continue
            self._prefolded.add(i)
        read = {n for i, node in enumerate(self.graph.nodes) if i not in self._prefolded
                for n in node.inputs}
        self._uploaded = {
            id(arr): (arr, self._upload(arr)) for name, arr in self._static.items()
            if name in read and _canon(arr.dtype) not in _NO_TORCH_ARITH
        }

    def _supported(self, op: str) -> bool:
        return (
            op in _UNARY
            or op in _BINARY
            or op
            in (
                "Conv",
                "Gemm",
                "MatMul",
                "BatchNormalization",
                "MaxPool",
                "AveragePool",
                "GlobalAveragePool",
                "GlobalMaxPool",
                "Reshape",
                "Transpose",
                "Concat",
                "Squeeze",
                "Unsqueeze",
                "Flatten",
                "Softmax",
                "LeakyRelu",
                "Elu",
                "Clip",
                "Dropout",
                "Constant",
                "Shape",
                "Cast",
                "Slice",
                "Gather",
                "ReduceMean",
                "ReduceSum",
                "ReduceMax",
                "ReduceMin",
                "ReduceProd",
                "LSTM",
                "GRU",
                "Pad",
                "Expand",
                "Split",
                "ConstantOfShape",
                "Where",
                "Gelu",
                "LayerNormalization",
                "InstanceNormalization",
            )
        )

    def _upload(self, arr) -> torch.Tensor:
        arr = np.asarray(arr)
        dtype = _torch_dtype(arr.dtype)  # raises for uint16/32/64
        return torch.from_numpy(np.array(arr, _canon(arr.dtype), order="C")).to(self.device,
                                                                              dtype)

    def _t(self, v) -> torch.Tensor:
        """An operand as a tensor on the device: a tensor as it is (moved
        if it lies elsewhere), an initializer or Constant from the upload
        made when the executor was built, any other numpy value now."""
        if isinstance(v, torch.Tensor):
            return v.to(self.device)
        hit = self._uploaded.get(id(v))
        if hit is not None and hit[0] is v:
            return hit[1]
        return self._upload(v)

    def __call__(self, **inputs) -> List[object]:
        g = self.graph
        env: Dict[str, object] = dict(self._static)  # numpy: shape operands stay static
        for k in g.inputs:
            if k not in inputs:
                raise KeyError(f"missing graph input '{k}' (have {sorted(inputs)})")
            env[k] = self._t(inputs[k])
        for i, node in enumerate(g.nodes):
            if i in self._prefolded:
                continue  # its value is in env since the executor was built
            args = [env[i] if i else None for i in node.inputs]
            outs = self._run_node(node, args)
            if not isinstance(outs, (tuple, list)):
                outs = (outs,)
            for name, val in zip(node.outputs, outs):
                if name:
                    env[name] = val
        return [env[o] for o in g.outputs]

    # -- dispatch -----------------------------------------------------------

    # Shape-pipeline ops constant-folded with numpy when every operand is
    # numpy, as the JAX executor folds them (its jnp ops would make tracers
    # of them under jit); Reshape/Slice/Expand then read static values.
    _FOLDABLE = {
        "Gather", "Concat", "Unsqueeze", "Squeeze", "Slice", "Cast",
        "Add", "Sub", "Mul", "Div", "Neg", "Abs", "Floor", "Ceil",
        "Equal", "Greater", "Less", "Where", "Max", "Min",
        "ReduceProd", "ReduceSum", "ReduceMax", "ReduceMin",
        "Reshape", "Transpose", "Identity", "ConstantOfShape", "Expand",
    }

    @staticmethod
    def _constant(node):
        for key in ("value", "value_float", "value_int", "value_floats", "value_ints"):
            if key in node.attrs:
                return np.asarray(node.attrs[key])
        raise ValueError("Constant node without value")

    def _fold_numpy(self, node, args):
        """Evaluate a foldable node on all-numpy operands; None = not handled
        (falls through to the torch path)."""
        op = node.op_type
        a = args[0]
        if op == "Gather":
            return np.take(a, np.asarray(args[1]), axis=node.attrs.get("axis", 0))
        if op == "Concat":
            return np.concatenate(args, axis=node.attrs["axis"])
        if op == "Unsqueeze":
            axes = node.attrs.get("axes")
            if axes is None:
                axes = _static_ints(args[1], "Unsqueeze")
            for ax in sorted(axes):
                a = np.expand_dims(a, ax)
            return a
        if op == "Squeeze":
            axes = node.attrs.get("axes")
            if axes is None and len(args) > 1 and args[1] is not None:
                axes = _static_ints(args[1], "Squeeze")
            return np.squeeze(a, tuple(axes) if axes else None)
        if op == "Slice":
            return _op_slice(node, *args)
        if op == "Cast":
            return a.astype(onnx_lite._DTYPES[node.attrs["to"]])
        if op == "Reshape":
            return _op_reshape(node, a, args[1])
        if op == "Transpose":
            return np.transpose(a, node.attrs.get("perm"))
        if op == "Identity":
            return a
        if op == "ConstantOfShape":
            val = node.attrs.get("value")
            fill = np.asarray(val).reshape(-1)[0] if val is not None else np.float32(0)
            return np.full(_static_ints(a, "ConstantOfShape"), fill, fill.dtype)
        if op == "Expand":
            return np.broadcast_to(
                a, np.broadcast_shapes(a.shape, tuple(_static_ints(args[1], "Expand")))
            )
        if op == "Where":
            return np.where(args[0], args[1], args[2])
        np_binary = {
            "Add": np.add, "Sub": np.subtract, "Mul": np.multiply,
            "Div": np.divide, "Equal": np.equal, "Greater": np.greater,
            "Less": np.less, "Max": np.maximum, "Min": np.minimum,
        }
        if op in np_binary:
            return np_binary[op](args[0], args[1])
        np_unary = {"Neg": np.negative, "Abs": np.abs, "Floor": np.floor, "Ceil": np.ceil}
        if op in np_unary:
            return np_unary[op](a)
        np_reduce = {
            "ReduceProd": np.prod, "ReduceSum": np.sum,
            "ReduceMax": np.max, "ReduceMin": np.min,
        }
        if op in np_reduce:
            axes = _reduce_axes(node, args[1] if len(args) > 1 else None)
            if axes == "noop":
                return a
            return np_reduce[op](a, axis=axes, keepdims=bool(node.attrs.get("keepdims", 1)))
        return None

    def _run_node(self, node, args):
        op = node.op_type
        if (
            op in self._FOLDABLE
            and args
            and all(x is None or isinstance(x, (np.ndarray, np.generic)) for x in args)
        ):
            out = self._fold_numpy(node, [
                np.asarray(x) if x is not None else None for x in args
            ])
            if out is not None:
                return np.asarray(out)
        out = self._run_torch(node, args)
        if isinstance(out, (tuple, list)):
            return [_canon_tensor(o) for o in out]
        return _canon_tensor(out)

    def _run_torch(self, node, args):
        op, t = node.op_type, self._t
        if op in _UNARY:
            return _UNARY[op](t(args[0]))
        if op in _BINARY:
            return _BINARY[op](t(args[0]), t(args[1]))
        if op == "Conv":
            return self._conv(node, *[None if a is None else t(a) for a in args])
        if op == "Gemm":
            return self._gemm(node, *[None if a is None else t(a) for a in args])
        if op == "MatMul":
            return torch.matmul(t(args[0]), t(args[1]))
        if op == "BatchNormalization":
            x, scale, bias, mean, var = (t(a) for a in args[:5])
            eps = node.attrs.get("epsilon", 1e-5)
            shape = (1, -1) + (1,) * (x.ndim - 2)
            return (x - mean.reshape(shape)) / torch.sqrt(var.reshape(shape) + eps) * scale.reshape(
                shape
            ) + bias.reshape(shape)
        if op in ("MaxPool", "AveragePool"):
            return self._pool(node, t(args[0]), is_avg=op == "AveragePool")
        if op == "GlobalAveragePool":
            x = t(args[0])
            return torch.mean(x, dim=tuple(range(2, x.ndim)), keepdim=True)
        if op == "GlobalMaxPool":
            x = t(args[0])
            return torch.amax(x, dim=tuple(range(2, x.ndim)), keepdim=True)
        if op == "Reshape":
            return _op_reshape(node, t(args[0]), args[1])
        if op == "Transpose":
            x = t(args[0])
            perm = node.attrs.get("perm")
            return x.permute(*(perm if perm is not None else reversed(range(x.ndim))))
        if op == "Concat":
            return torch.cat([t(a) for a in args], dim=node.attrs["axis"])
        if op == "Squeeze":
            axes = node.attrs.get("axes")
            if axes is None and len(args) > 1 and args[1] is not None:
                axes = _static_ints(args[1], "Squeeze")
            x = t(args[0])
            return x.squeeze(tuple(axes)) if axes else x.squeeze()
        if op == "Unsqueeze":
            axes = node.attrs.get("axes")
            if axes is None:
                axes = _static_ints(args[1], "Unsqueeze")
            out = t(args[0])
            for ax in sorted(axes):
                out = out.unsqueeze(ax)
            return out
        if op == "Flatten":
            x = t(args[0])
            ax = node.attrs.get("axis", 1)
            lead = int(np.prod(x.shape[:ax])) if ax else 1
            return x.reshape(lead, -1)
        if op == "Softmax":
            x = t(args[0])
            if self.model.opset and self.model.opset < 13:
                # opset <=12 semantics: coerce to 2D at axis (default 1) and
                # softmax over the flattened trailing block — older exported
                # metric models (DNSMOS-era) rely on this
                ax = node.attrs.get("axis", 1) % max(x.ndim, 1)
                lead = int(np.prod(x.shape[:ax])) if ax else 1
                return torch.softmax(x.reshape(lead, -1), dim=-1).reshape(x.shape)
            return torch.softmax(x, dim=node.attrs.get("axis", -1))
        if op == "LeakyRelu":
            return F.leaky_relu(t(args[0]), node.attrs.get("alpha", 0.01))
        if op == "Elu":
            return F.elu(t(args[0]), node.attrs.get("alpha", 1.0))
        if op == "Gelu":
            approx = "tanh" if node.attrs.get("approximate", "none") == "tanh" else "none"
            return F.gelu(t(args[0]), approximate=approx)
        if op == "Clip":
            lo = args[1] if len(args) > 1 and args[1] is not None else node.attrs.get("min")
            hi = args[2] if len(args) > 2 and args[2] is not None else node.attrs.get("max")
            x = t(args[0])
            if lo is None and hi is None:
                return x
            bound = [None if v is None else t(np.float32(v) if isinstance(v, float) else v)
                     .to(x.dtype) for v in (lo, hi)]
            return torch.clamp(x, *bound)
        if op == "Dropout":
            return t(args[0])  # inference
        if op == "Shape":
            shp = np.asarray(args[0].shape, np.int64)  # static
            # opset-15 start/end slice the shape vector (negatives wrap)
            return shp[node.attrs.get("start", 0): node.attrs.get("end")]
        if op == "Cast":
            return t(args[0]).to(_torch_dtype(onnx_lite._DTYPES[node.attrs["to"]]))
        if op == "Slice":
            return _op_slice(node, t(args[0]), *args[1:])
        if op == "Gather":
            x, idx = t(args[0]), t(args[1]).long()
            ax = node.attrs.get("axis", 0) % x.ndim
            idx = torch.where(idx < 0, idx + x.shape[ax], idx)  # jnp.take wraps negatives
            out = x.index_select(ax, idx.reshape(-1))
            return out.reshape(x.shape[:ax] + idx.shape + x.shape[ax + 1:])
        if op in _REDUCE:
            x = t(args[0])
            axes = _reduce_axes(node, args[1] if len(args) > 1 else None)
            if axes == "noop":
                return x
            return _REDUCE[op](x, axes, bool(node.attrs.get("keepdims", 1)))
        if op == "LSTM":
            return self._lstm(node, *[None if a is None else t(a) for a in args])
        if op == "GRU":
            return self._gru(node, *[None if a is None else t(a) for a in args])
        if op == "Pad":
            return self._pad(node, t(args[0]), *args[1:])
        if op == "Expand":
            x = t(args[0])
            return x.broadcast_to(
                np.broadcast_shapes(tuple(x.shape), tuple(_static_ints(args[1], "Expand"))))
        if op == "Split":
            x = t(args[0])
            ax = node.attrs.get("axis", 0)
            if "split" in node.attrs:
                sizes = node.attrs["split"]
            elif len(args) > 1 and args[1] is not None:
                sizes = _static_ints(args[1], "Split")
            else:
                # ONNX: equal ceil-sized chunks, last one possibly smaller
                k = len(node.outputs)
                dim = x.shape[ax]
                chunk = -(-dim // k)
                sizes = [chunk] * (k - 1) + [dim - chunk * (k - 1)]
            return list(torch.split(x, list(sizes), dim=ax))
        if op == "ConstantOfShape":
            val = node.attrs.get("value")
            fill = np.asarray(val).reshape(-1)[0] if val is not None else np.float32(0)
            return torch.full(_static_ints(args[0], "ConstantOfShape"), fill.item(),
                              dtype=_torch_dtype(fill.dtype), device=self.device)
        if op == "Where":
            return torch.where(t(args[0]).bool(), t(args[1]), t(args[2]))
        if op == "LayerNormalization":
            x = t(args[0])
            ax = node.attrs.get("axis", -1)
            eps = node.attrs.get("epsilon", 1e-5)
            axes = tuple(range(ax % x.ndim, x.ndim))
            mu = torch.mean(x, dim=axes, keepdim=True)
            c = x - mu
            var = torch.mean(c * c, dim=axes, keepdim=True)
            out = c / torch.sqrt(var + eps) * t(args[1])
            if len(args) > 2 and args[2] is not None:
                out = out + t(args[2])
            return out
        if op == "InstanceNormalization":
            x = t(args[0])
            eps = node.attrs.get("epsilon", 1e-5)
            axes = tuple(range(2, x.ndim))
            mu = torch.mean(x, dim=axes, keepdim=True)
            c = x - mu
            var = torch.mean(c * c, dim=axes, keepdim=True)
            shape = (1, -1) + (1,) * (x.ndim - 2)
            return c / torch.sqrt(var + eps) * t(args[1]).reshape(shape) + t(
                args[2]).reshape(shape)
        raise NotImplementedError(f"ONNX op {op}")

    # -- compute ops -----------------------------------------------------

    @staticmethod
    def _conv(node, x, w, b=None):
        rank = x.ndim - 2  # spatial rank
        strides = node.attrs.get("strides", [1] * rank)
        dilations = node.attrs.get("dilations", [1] * rank)
        group = node.attrs.get("group", 1)
        pads = _conv_pads(node, x.shape[2:], w.shape[2:], strides, dilations)
        if all(lo == hi for lo, hi in pads):
            padding = [lo for lo, _ in pads]
        else:  # F.conv*d pads both sides alike: pad (lo, hi) first
            x, padding = F.pad(x, _torch_pad(pads)), 0
        conv = (F.conv1d, F.conv2d, F.conv3d)[rank - 1]
        return conv(x, w, b, stride=strides, padding=padding, dilation=dilations,
                    groups=group)

    @staticmethod
    def _gemm(node, a, b, c=None):
        if node.attrs.get("transA", 0):
            a = a.T
        if node.attrs.get("transB", 0):
            b = b.T
        out = node.attrs.get("alpha", 1.0) * (a @ b)
        if c is not None:
            out = out + node.attrs.get("beta", 1.0) * c
        return out

    @staticmethod
    def _pool(node, x, is_avg=False):
        kernel = list(node.attrs["kernel_shape"])
        rank = len(kernel)
        strides = list(node.attrs.get("strides", [1] * rank))
        dilations = list(node.attrs.get("dilations", [1] * rank))
        if is_avg and any(d != 1 for d in dilations):
            raise NotImplementedError("AveragePool dilations != 1")
        auto_pad = node.attrs.get("auto_pad", "NOTSET")
        if auto_pad not in ("", "NOTSET"):
            pads = _auto_pads(auto_pad, x.shape[2:], kernel, strides, dilations)
        else:
            p = node.attrs.get("pads", [0] * (2 * rank))
            pads = list(zip(p[:rank], p[rank:]))
        if node.attrs.get("ceil_mode", 0):
            # grow the hi pad so the pool emits ceil-count windows — but
            # windows that would START inside the right padding are ignored
            # (ONNX spec note; ORT/torch clamp the output so the last window
            # starts within input + left padding)
            for i, (k, s, d) in enumerate(zip(kernel, strides, dilations)):
                eff = (k - 1) * d + 1
                in_size = x.shape[2 + i]
                span = in_size + pads[i][0] + pads[i][1]
                out_ceil = -(-(span - eff) // s) + 1
                while out_ceil > 1 and (out_ceil - 1) * s >= in_size + pads[i][0]:
                    out_ceil -= 1
                # adjust hi pad so the pool emits exactly out_ceil windows:
                # grown for the ceil window, trimmed (a negative pad: F.pad
                # crops) when excess explicit padding would add
                # spec-ignored windows beyond every kept one
                need = (out_ceil - 1) * s + eff - span
                pads[i] = (pads[i][0], pads[i][1] + need)
        # F.*_pool*d pad both sides alike: pad first (-inf for max, 0 for
        # average), then pool the padded input without padding
        if not is_avg:
            xp = F.pad(x, _torch_pad(pads), value=float("-inf"))
            pool = (F.max_pool1d, F.max_pool2d, F.max_pool3d)[rank - 1]
            return pool(xp, kernel, strides, 0, dilations)

        def window_sums(v):
            if rank == 1:  # avg_pool1d has no divisor_override: pool a 1 x k window
                return F.avg_pool2d(v.unsqueeze(-2), [1] + kernel, [1] + strides,
                                    divisor_override=1).squeeze(-2)
            pool = (None, F.avg_pool2d, F.avg_pool3d)[rank - 1]
            return pool(v, kernel, strides, divisor_override=1)

        sums = window_sums(F.pad(x, _torch_pad(pads)))
        if node.attrs.get("count_include_pad", 0):
            return sums / np.prod(kernel)
        ones = torch.ones(x.shape[2:], dtype=x.dtype, device=x.device)[None, None]
        return sums / window_sums(F.pad(ones, _torch_pad(pads)))

    @staticmethod
    def _lstm(node, x, w, r, b=None, seq_lens=None, h0=None, c0=None, p=None):
        """ONNX LSTM (iofc gate order), layout=0: x is (T, B, I)."""
        if seq_lens is not None:
            raise ValueError("LSTM sequence_lens input is not supported")
        if p is not None:
            raise ValueError("LSTM peephole weights are not supported")
        _check_rnn_attrs(node, "LSTM", ["sigmoid", "tanh", "tanh"])
        hidden = node.attrs["hidden_size"]
        direction = node.attrs.get("direction", "forward")
        num_dir = 2 if direction == "bidirectional" else 1
        T, B, _ = x.shape
        zeros = torch.zeros((num_dir, B, hidden), dtype=x.dtype, device=x.device)
        b = torch.zeros((num_dir, 8 * hidden), dtype=x.dtype, device=x.device) if b is None else b
        h0 = zeros if h0 is None else h0
        c0 = zeros if c0 is None else c0

        def run_dir(xd, wd, rd, bd, h, c):
            wb, rb = bd[: 4 * hidden], bd[4 * hidden:]
            pre_x = xd @ wd.T + (wb + rb)  # (T, B, 4H)
            hs = []
            for px in pre_x:
                g = px + h @ rd.T
                i, o, f, cc = torch.chunk(g, 4, dim=-1)
                i, o, f = torch.sigmoid(i), torch.sigmoid(o), torch.sigmoid(f)
                c = f * c + i * torch.tanh(cc)
                h = o * torch.tanh(c)
                hs.append(h)
            return torch.stack(hs), h, c

        outs, hts, cts = [], [], []
        for d in range(num_dir):
            rev = d == 1 or direction == "reverse"
            hs, ht, ct = run_dir(x.flip(0) if rev else x, w[d], r[d], b[d], h0[d], c0[d])
            outs.append(hs.flip(0) if rev else hs)
            hts.append(ht)
            cts.append(ct)
        y = torch.stack(outs, dim=1)  # (T, num_dir, B, H)
        return y, torch.stack(hts), torch.stack(cts)

    @staticmethod
    def _gru(node, x, w, r, b=None, seq_lens=None, h0=None):
        """ONNX GRU (zrh gate order), layout=0: x is (T, B, I)."""
        if seq_lens is not None:
            raise ValueError("GRU sequence_lens input is not supported")
        _check_rnn_attrs(node, "GRU", ["sigmoid", "tanh"])
        H = node.attrs["hidden_size"]
        direction = node.attrs.get("direction", "forward")
        lbr = node.attrs.get("linear_before_reset", 0)
        num_dir = 2 if direction == "bidirectional" else 1
        T, B, _ = x.shape
        b = torch.zeros((num_dir, 6 * H), dtype=x.dtype, device=x.device) if b is None else b
        if h0 is None:
            h0 = torch.zeros((num_dir, B, H), dtype=x.dtype, device=x.device)

        def run_dir(xd, wd, rd, bd, h):
            wb, rb = bd[: 3 * H], bd[3 * H:]
            pre_x = xd @ wd.T + wb  # (T, B, 3H)
            hs = []
            for px in pre_x:
                if lbr:
                    rec = h @ rd.T + rb  # (B, 3H)
                    rt = torch.sigmoid(px[:, H: 2 * H] + rec[:, H: 2 * H])
                    ht = torch.tanh(px[:, 2 * H:] + rt * rec[:, 2 * H:])
                else:
                    # only z/r need the plain recurrent product here — the
                    # candidate uses (rt * h) @ Rh
                    rec = h @ rd[: 2 * H].T + rb[: 2 * H]
                    rt = torch.sigmoid(px[:, H: 2 * H] + rec[:, H: 2 * H])
                    ht = torch.tanh(px[:, 2 * H:] + (rt * h) @ rd[2 * H:].T + rb[2 * H:])
                z = torch.sigmoid(px[:, :H] + rec[:, :H])
                h = (1.0 - z) * ht + z * h
                hs.append(h)
            return torch.stack(hs), h

        outs, hts = [], []
        for d in range(num_dir):
            rev = d == 1 or direction == "reverse"
            hs, ht = run_dir(x.flip(0) if rev else x, w[d], r[d], b[d], h0[d])
            outs.append(hs.flip(0) if rev else hs)
            hts.append(ht)
        return torch.stack(outs, dim=1), torch.stack(hts)

    def _pad(self, node, x, pads=None, value=None, axes=None):
        if pads is None:
            pads = node.attrs["pads"]
        pads = _static_ints(pads, "Pad")
        mode = node.attrs.get("mode", "constant")
        n = x.ndim
        if axes is not None:
            # opset-18: pads apply only to the listed axes, in order
            ax = [a % n for a in _static_ints(axes, "Pad")]
            full = [0] * (2 * n)
            for i, a in enumerate(ax):
                full[a] = pads[i]
                full[n + a] = pads[len(ax) + i]
            pads = full
        widths = list(zip(pads[:n], pads[n:]))
        # negative pads crop (opset>=11)
        if any(b < 0 or e < 0 for b, e in widths):
            x = x[tuple(
                slice(max(-b, 0), x.shape[d] + e if e < 0 else None)
                for d, (b, e) in enumerate(widths)
            )]
            widths = [(max(b, 0), max(e, 0)) for b, e in widths]
        if mode == "constant":
            cv = 0.0 if value is None else float(_static_value(value))
            return F.pad(x, _torch_pad(widths), value=cv)
        if mode not in ("reflect", "edge", "wrap"):
            raise ValueError(f"Pad mode '{mode}' is not supported")
        # F.pad's reflect/circular modes take trailing dims only and pads
        # below the dim: gather each axis by numpy's padded index instead
        # (jnp.pad's semantics on any axis and for any pad)
        for d, (lo, hi) in enumerate(widths):
            if lo or hi:
                idx = np.pad(np.arange(x.shape[d]), (lo, hi), mode=mode)
                x = x.index_select(d, torch.from_numpy(idx).to(x.device))
        return x


def _static_value(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().reshape(-1)[0].item()
    return np.asarray(v).reshape(-1)[0]


def _canon_tensor(v):
    """A node's torch result in the JAX package's dtypes (int64 -> int32,
    float64 -> float32); numpy results (Shape) stay as they are."""
    if isinstance(v, torch.Tensor) and v.dtype in (torch.int64, torch.float64):
        return v.to(torch.int32 if v.dtype == torch.int64 else torch.float32)
    return v


def _reduce_fn(fn):
    def op(x, axes, keep):
        if axes is None:
            out = fn(x, tuple(range(x.ndim)))
            return out.reshape((1,) * x.ndim) if keep else out.reshape(())
        dims = tuple(a % x.ndim for a in axes)
        out = fn(x, dims)
        if keep:
            for d in sorted(dims):
                out = out.unsqueeze(d)
        return out

    return op


def _prod(x, dims):
    for d in sorted(dims, reverse=True):
        x = torch.prod(x, dim=d)
    return x


_REDUCE = {
    "ReduceMean": _reduce_fn(lambda x, d: torch.mean(x, dim=d)),
    "ReduceSum": _reduce_fn(lambda x, d: torch.sum(x, dim=d)),
    "ReduceMax": _reduce_fn(lambda x, d: torch.amax(x, dim=d)),
    "ReduceMin": _reduce_fn(lambda x, d: torch.amin(x, dim=d)),
    "ReduceProd": _reduce_fn(_prod),
}

_UNARY = {
    "Relu": torch.relu,
    "Sigmoid": torch.sigmoid,
    "Tanh": torch.tanh,
    "Exp": torch.exp,
    "Log": torch.log,
    "Sqrt": torch.sqrt,
    "Neg": torch.neg,
    "Abs": torch.abs,
    "Floor": torch.floor,
    "Ceil": torch.ceil,
    "Erf": torch.erf,
    "Softplus": lambda x: torch.logaddexp(x, torch.zeros_like(x)),  # jax.nn.softplus
    "Identity": lambda x: x,
}

_BINARY = {
    "Add": torch.add,
    "Sub": torch.sub,
    "Mul": torch.mul,
    "Div": torch.true_divide,  # jnp.divide
    "Pow": torch.pow,
    "Greater": torch.gt,
    "Less": torch.lt,
    "Equal": torch.eq,
    "Max": torch.maximum,
    "Min": torch.minimum,
}


class _IOInfo:
    def __init__(self, name, shape):
        self.name = name
        self.shape = shape


class InferenceSession:
    """onnxruntime.InferenceSession facade over OnnxGraphExecutor (the slice
    used by the metric CLIs: run(None, feed), get_inputs(), get_outputs()),
    on ``device``: the card unless the caller asks for the CPU."""

    def __init__(self, path_or_bytes, device="cuda"):
        if isinstance(path_or_bytes, (bytes, bytearray)):
            model = onnx_lite.loads(bytes(path_or_bytes))
        else:
            model = onnx_lite.load(path_or_bytes)
        self._exec = OnnxGraphExecutor(model, device)

    @property
    def device(self) -> torch.device:
        return self._exec.device

    def get_inputs(self):
        g = self._exec.graph
        return [_IOInfo(n, g.input_shapes.get(n)) for n in g.inputs]

    def get_outputs(self):
        return [_IOInfo(n, None) for n in self._exec.graph.outputs]

    def run_tensors(self, output_names, feed: Dict[str, object]) -> List[object]:
        """``run`` without the copy to the host: tensors on the device (numpy
        where an output folded in numpy)."""
        with torch.inference_mode(), full_float32():
            outs = self._exec(**feed)
        if output_names:
            order = {n: i for i, n in enumerate(self._exec.graph.outputs)}
            outs = [outs[order[n]] for n in output_names]
        return outs

    def run(self, output_names, feed: Dict[str, np.ndarray]):
        return [o.cpu().numpy() if isinstance(o, torch.Tensor)
                else np.asarray(o).astype(_canon(np.asarray(o).dtype))
                for o in self.run_tensors(output_names, feed)]
