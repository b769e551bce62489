"""ONNX export of layer graphs: ``paddle_tpu/onnx/export.py``.

``export(layer, path, input_spec)`` runs the model once on zeros of the
spec (``core.graph_trace.trace_layer_graph``: a ``"layer"`` event per
leaf module call, an ``"op"`` event per torch function between them) and
writes ``<path>.onnx``, a ModelProto in protobuf wire format
(``_proto``), with the JAX exporter's nodes, attributes, initializers,
names and opset rules, so both packages write the same bytes for the
same model and weights.

Leaf layers with an emitter: ``models/_layers.py``'s (``Linear``,
``Conv2D``, ``BatchNorm2D``, ``Hardswish``, ``Hardsigmoid``,
``AvgPool2D``, ``Dropout``) and ``torch.nn``'s ``Linear``, ``Conv2d``,
the BatchNorms, ``LayerNorm``, ``Embedding``, ``ReLU`` / ``ReLU6`` /
``Sigmoid`` / ``Tanh`` / ``GELU`` / ``LeakyReLU`` / ``Hardswish`` /
``Hardsigmoid`` / ``Softmax``, ``MaxPool2d`` / ``AvgPool2d`` /
``AdaptiveAvgPool2d`` (global), ``Flatten``, the Dropouts and
``Identity``. A layer is keyed by its class name as the JAX emitter is
(the node's name is that name in lower case, which Paddle's and torch's
names share: ``Conv2D`` / ``Conv2d`` -> ``conv2d``). torch's ``Linear``
keeps its weight ``[out, in]``: its initializer is the transpose, the
``[in, out]`` B of Gemm that Paddle's layout gives.

The glue between layers is recorded as torch functions
(``Tensor.add``, ``torch.flatten``, ``Tensor.view``, ``F.relu``); each is
mapped onto the JAX registry op it corresponds to (``_registry_op``),
whose emitter then writes the JAX nodes: the elementwise four with their
scalar constants in the output's dtype, relu, erf, matmul, softmax,
transpose / permute, gelu, an integer ``getitem``, and
flatten / reshape / view as ``Reshape`` keeping the batch dim. Ops that
only change the memory format (``contiguous``, ``to(memory_format=...)``)
write no node. ``scaled_dot_product_attention`` has no emitter: the
JAX package reaches it only from ERNIE, which waits for the port's
``nn``.

Initializers are contiguous f32 bytes of the tensors as they are on
their device (a channels-last weight in OIHW order, bf16 or f16 widened
to f32), a 0-d tensor stays 0-d, integers keep int32 / int64.

A graph with a layer or an op without an emitter warns and falls back
to ``jit.save``, which writes the ``torch.export`` program
``<path>.pdmodel`` that ``inference.create_predictor`` serves (the JAX
package writes StableHLO under the same name). A model folded by
``analysis.fold_conv_bn`` takes that path: its ``ConvBnAct`` sites have
no emitter, as no leaf layer without an emitter has in the JAX rule.
"""
from __future__ import annotations

import struct
import warnings
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from . import _proto as P

__all__ = ["export"]

# onnx.proto field numbers (public spec)
_IR_VERSION = 8
_OPSET = 13

# TensorProto.DataType
_F32 = 1
_I32 = 6
_I64 = 7

_NP = {torch.int64: np.int64, torch.int32: np.int32, torch.int16: np.int16,
       torch.int8: np.int8, torch.uint8: np.uint8, torch.bool: np.bool_,
       torch.float64: np.float64}


def _np_dtype(dtype: torch.dtype):
    """numpy's counterpart of a torch dtype; the low-precision floats
    (which ``_tensor_proto`` widens to f32 anyway) are f32."""
    return np.dtype(_NP.get(dtype, np.float32))


def _np(t: torch.Tensor) -> np.ndarray:
    """A tensor's values on the host, contiguous, bf16 / f16 as f32."""
    t = t.detach().to("cpu")
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.contiguous().numpy()


def _elem_type(dtype) -> int:
    dt = np.dtype(dtype)
    if dt == np.int64:
        return _I64
    if dt in (np.int32, np.int16, np.int8, np.uint8):
        return _I32
    return _F32


def _tensor_proto(name: str, arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)
    if arr.ndim:  # ascontiguousarray PROMOTES 0-d to 1-d
        arr = np.ascontiguousarray(arr)
    dt = _elem_type(arr.dtype)
    arr = arr.astype({_F32: np.float32, _I32: np.int32,
                      _I64: np.int64}[dt])
    msg = b"".join([
        *(P.field_varint(1, int(d)) for d in arr.shape),   # dims
        P.field_varint(2, dt),                             # data_type
        P.field_string(8, name),                           # name
        P.field_bytes(9, arr.tobytes()),                   # raw_data
    ])
    return msg


def _value_info(name: str, shape, elem=_F32) -> bytes:
    dims = b"".join(
        P.field_message(1, P.field_varint(1, int(d)) if d is not None
                        else P.field_string(2, "N"))
        for d in shape)
    tensor_type = (P.field_varint(1, elem)
                   + P.field_message(2, dims))              # shape
    type_proto = P.field_message(1, tensor_type)            # tensor_type
    return P.field_string(1, name) + P.field_message(2, type_proto)


def _attr_int(name: str, v: int) -> bytes:
    return (P.field_string(1, name) + P.field_varint(3, v)
            + P.field_varint(20, 2))                        # type=INT


def _attr_ints(name: str, vs) -> bytes:
    return (P.field_string(1, name)
            + b"".join(P.field_varint(8, int(v)) for v in vs)
            + P.field_varint(20, 7))                        # type=INTS


def _attr_string(name: str, v: str) -> bytes:
    return (P.field_string(1, name) + P.field_bytes(4, v.encode())
            + P.field_varint(20, 3))                        # type=STRING


def _attr_float(name: str, v: float) -> bytes:
    return (P.field_string(1, name)
            + P._varint(2 << 3 | 5) + struct.pack("<f", v)
            + P.field_varint(20, 1))                        # type=FLOAT


def _node(op_type: str, inputs, outputs, attrs: List[bytes] = (),
          name: str = "") -> bytes:
    return b"".join([
        *(P.field_string(1, i) for i in inputs),
        *(P.field_string(2, o) for o in outputs),
        P.field_string(3, name or outputs[0]),
        P.field_string(4, op_type),
        *(P.field_message(5, a) for a in attrs),
    ])


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


_OP_MIN_OPSET = {"Gelu": 20, "HardSwish": 14}


def _onnx_pads(pa):
    """paddle / torch padding spec -> onnx pads (h0, w0, h1, w1); None
    when the spec (a string: SAME / VALID, same / valid) has no static
    equivalent."""
    if isinstance(pa, str):
        return None
    if isinstance(pa, (tuple, list)) and len(pa) == 4:
        # paddle [h_lo, h_hi, w_lo, w_hi] -> onnx [h0, w0, h1, w1]
        return (pa[0], pa[2], pa[1], pa[3])
    if isinstance(pa, (tuple, list)) and len(pa) == 2 and \
            isinstance(pa[0], (tuple, list)):
        return (pa[0][0], pa[1][0], pa[0][1], pa[1][1])
    ph, pw = _pair(pa)
    return (ph, pw, ph, pw)


def _bn_parts(layer):
    """(weight, bias, mean, var, eps) of a batch norm, or None when it
    keeps no running statistics."""
    from ..models._layers import BatchNorm2D
    if isinstance(layer, BatchNorm2D):
        return (layer.weight, layer.bias, layer._mean, layer._variance,
                layer.epsilon)
    if layer.running_mean is None:
        return None
    return (layer.weight, layer.bias, layer.running_mean,
            layer.running_var, layer.eps)


def _perm_of_transpose(ndim: int, d0: int, d1: int):
    perm = list(range(ndim))
    perm[d0], perm[d1] = perm[d1], perm[d0]
    return perm


def _is_layout_only(name, args, kwargs) -> bool:
    """An op that only changes the memory format: it writes no node."""
    if name == "contiguous":
        return True
    if name == "to":
        src = args[0]
        rest = [a for a in args[1:]] + [v for k, v in kwargs.items()
                                         if k != "memory_format"]
        return "memory_format" in kwargs and all(
            (isinstance(a, torch.dtype) and a == src.dtype)
            or (isinstance(a, (torch.device, str))
                and torch.device(a) == src.device)
            or isinstance(a, bool) for a in rest)
    return False


def _registry_op(name, args, kwargs):
    """A recorded torch function as the JAX registry op it corresponds
    to: ``(opname, args, kwargs)`` in the JAX emitter's conventions, or
    None when it has no counterpart there."""
    binary = {"__add__": "add", "add": "add", "__sub__": "subtract",
              "sub": "subtract", "subtract": "subtract",
              "__mul__": "multiply", "mul": "multiply",
              "multiply": "multiply", "__truediv__": "divide",
              "div": "divide", "divide": "divide", "true_divide": "divide",
              "__matmul__": "matmul", "matmul": "matmul"}
    # torch records ``1 + x`` as add(x, 1), ``1 - x`` as __rsub__(x, 1)
    reflected = {"__radd__": "add", "__rsub__": "subtract",
                 "__rmul__": "multiply", "__rtruediv__": "divide",
                 "__rdiv__": "divide", "__rmatmul__": "matmul"}
    if name in binary:
        if name in ("add", "sub", "subtract") and kwargs.get("alpha",
                                                             1) != 1:
            return None
        if kwargs.get("rounding_mode") is not None:
            return None
        return binary[name], (args[0], args[1]), {}
    if name in reflected:
        return reflected[name], (args[1], args[0]), {}
    if name in ("relu", "erf"):
        return name, (args[0],), {}
    if name == "softmax":
        dim = kwargs.get("dim", args[1] if len(args) > 1 else None)
        if dim is None or kwargs.get("dtype") is not None:
            return None
        return "softmax", (args[0],), {"axis": dim}
    if name == "permute":
        dims = kwargs.get("dims", args[1:])
        dims = dims[0] if len(dims) == 1 and isinstance(
            dims[0], (tuple, list)) else dims
        return "transpose", (args[0],), {"perm": list(dims)}
    if name == "transpose":
        d0 = kwargs.get("dim0", args[1] if len(args) > 1 else None)
        d1 = kwargs.get("dim1", args[2] if len(args) > 2 else None)
        if d0 is None or d1 is None:
            return None
        return "transpose", (args[0],), {
            "perm": _perm_of_transpose(args[0].ndim, d0, d1)}
    if name == "gelu":
        approx = kwargs.get("approximate",
                            args[1] if len(args) > 1 else "none")
        return "gelu", (args[0],), {"approximate": approx == "tanh"}
    if name == "__getitem__":
        return "getitem", (args[0], args[1]), {}
    if name == "flatten":
        return "flatten", (args[0],), {}
    if name in ("reshape", "view"):
        return "reshape", (args[0],), {}
    return None


class _Emitter:
    def __init__(self, names=None, traced_ids=None):
        self.nodes: List[bytes] = []
        self.inits: List[bytes] = []
        self.counter = 0
        self.min_opset = 7
        # id(tensor) -> graph value name, and the set of ids PRODUCED
        # during the trace (an unnamed produced tensor aborts export;
        # a tensor predating the trace is a genuine initializer)
        self.names = names if names is not None else {}
        self.traced_ids = traced_ids if traced_ids is not None else set()

    def in_name(self, v, out_t=None) -> Optional[str]:
        """Graph name for an op input: a traced name, a baked
        initializer for pre-trace constants (dtype-faithful: an int32
        ids tensor must not become a float32 initializer; a Python
        scalar takes the output's dtype, rounded to it), or None when
        the value is an unnamed traced intermediate."""
        if isinstance(v, torch.Tensor):
            nm = self.names.get(id(v))
            if nm is not None:
                return nm
            if id(v) in self.traced_ids:
                return None
            return self.add_init("const", _np(v))
        if isinstance(out_t, torch.Tensor):
            dt = out_t.dtype
            if not (dt.is_floating_point or dt == torch.bool):
                dt = torch.int64 if dt == torch.int64 else torch.int32
            return self.add_init("const", _np(torch.tensor(v, dtype=dt)))
        return self.add_init("const", np.asarray(v, np.float32))

    def tname(self, base):
        self.counter += 1
        return f"{base}_{self.counter}"

    def add_init(self, base, arr):
        name = self.tname(base)
        self.inits.append(_tensor_proto(name, np.asarray(arr)))
        return name

    def _param(self, base, t, ones_like: Optional[int] = None,
               fill: float = 0.0):
        if t is None:
            return self.add_init(base, np.full(ones_like, fill, np.float32))
        return self.add_init(base, _np(t))

    def emit(self, layer, x_name: str) -> Optional[str]:
        """Emit node(s) for ``layer`` consuming x_name; returns output
        name, or None if the layer type is unsupported."""
        from ..models import _layers as L
        t = type(layer).__name__
        out = self.tname(t.lower())
        if isinstance(layer, (L.Linear, nn.Linear)):
            wt = layer.weight if isinstance(layer, L.Linear) \
                else layer.weight.t()
            w = self.add_init("weight", _np(wt))
            ins = [x_name, w]
            if layer.bias is not None:
                ins.append(self.add_init("bias", _np(layer.bias)))
            # [in, out] = Gemm's B untransposed
            self.nodes.append(_node("Gemm", ins, [out]))
            return out
        if isinstance(layer, nn.Conv2d):
            if layer.padding_mode != "zeros":
                return None
            w = self.add_init("weight", _np(layer.weight))
            ins = [x_name, w]
            if layer.bias is not None:
                ins.append(self.add_init("bias", _np(layer.bias)))
            st = _pair(layer.stride)
            pads = _onnx_pads(layer.padding)
            if pads is None:
                return None  # same / valid: shape math differs; jit.save
            di = _pair(layer.dilation)
            attrs = [_attr_ints("strides", st),
                     _attr_ints("pads", pads),
                     _attr_ints("dilations", di),
                     _attr_int("group", layer.groups)]
            self.nodes.append(_node("Conv", ins, [out], attrs))
            return out
        if isinstance(layer, (L.BatchNorm2D, nn.modules.batchnorm._BatchNorm)):
            parts = _bn_parts(layer)
            if parts is None:
                return None  # batch statistics at inference: jit.save
            weight, bias, mean, var, eps = parts
            nf = layer.num_features
            scale = self._param("scale", weight, nf, 1.0)
            b = self._param("b", bias, nf, 0.0)
            mean = self.add_init("mean", _np(mean))
            var = self.add_init("var", _np(var))
            self.nodes.append(_node(
                "BatchNormalization", [x_name, scale, b, mean, var],
                [out], [_attr_float("epsilon", float(eps))]))
            return out
        if isinstance(layer, nn.Embedding):
            w = self.add_init("embed", _np(layer.weight))
            self.nodes.append(_node("Gather", [w, x_name], [out],
                                    [_attr_int("axis", 0)]))
            return out
        if isinstance(layer, nn.LayerNorm):
            if len(layer.normalized_shape) != 1:
                return None  # multi-axis norm: jit.save
            nf = layer.normalized_shape[0]
            scale = self._param("scale", layer.weight, nf, 1.0)
            b = self._param("b", layer.bias, nf, 0.0)
            self.nodes.append(_node(
                "LayerNormalization", [x_name, scale, b], [out],
                [_attr_int("axis", -1),
                 _attr_float("epsilon", float(layer.eps))]))
            self.min_opset = max(self.min_opset, 17)
            return out
        simple = {"ReLU": "Relu", "Sigmoid": "Sigmoid", "Tanh": "Tanh",
                  "Hardswish": "HardSwish", "Hardsigmoid": "HardSigmoid"}
        if t in simple:
            self.nodes.append(_node(simple[t], [x_name], [out]))
            self.min_opset = max(self.min_opset, _OP_MIN_OPSET.get(
                simple[t], 7))
            return out
        if isinstance(layer, nn.GELU):
            self.nodes.append(_node(
                "Gelu", [x_name], [out],
                [_attr_string("approximate", layer.approximate)]))
            self.min_opset = max(self.min_opset, 20)
            return out
        if isinstance(layer, nn.Softmax):
            if layer.dim is None:
                return None
            self.nodes.append(_node("Softmax", [x_name], [out],
                                    [_attr_int("axis", int(layer.dim))]))
            self.min_opset = max(self.min_opset, 13)  # axis semantics
            return out
        if isinstance(layer, nn.Flatten):
            if layer.end_dim != -1:
                return None  # ONNX Flatten has only a start axis
            self.nodes.append(_node(
                "Flatten", [x_name], [out],
                [_attr_int("axis", int(layer.start_dim))]))
            return out
        if isinstance(layer, nn.ReLU6):
            self.nodes.append(_node("Clip", [
                x_name, self.add_init("min", np.float32(0.0)),
                self.add_init("max", np.float32(6.0))], [out]))
            self.min_opset = max(self.min_opset, 11)  # min/max as inputs
            return out
        if isinstance(layer, nn.LeakyReLU):
            self.nodes.append(_node(
                "LeakyRelu", [x_name], [out],
                [_attr_float("alpha", float(layer.negative_slope))]))
            return out
        if isinstance(layer, (L.Dropout, nn.Dropout, nn.Dropout2d,
                              nn.Dropout3d, nn.Identity)):
            self.nodes.append(_node("Identity", [x_name], [out]))
            return out
        if isinstance(layer, (nn.MaxPool2d, nn.AvgPool2d, L.AvgPool2D)):
            if isinstance(layer, nn.MaxPool2d):
                if layer.ceil_mode or _pair(layer.dilation) != (1, 1):
                    return None
                op = "MaxPool"
            else:
                op = "AveragePool"
                if isinstance(layer, nn.AvgPool2d) and (
                        layer.ceil_mode or layer.divisor_override
                        or (layer.count_include_pad
                            and _pair(layer.padding) != (0, 0))):
                    return None  # ONNX's AveragePool excludes the padding
            pads = _onnx_pads(layer.padding)
            if pads is None:
                return None
            k = _pair(layer.kernel_size)
            st = _pair(layer.stride if layer.stride is not None
                       else layer.kernel_size)
            self.nodes.append(_node(
                op, [x_name], [out],
                [_attr_ints("kernel_shape", k), _attr_ints("strides", st),
                 _attr_ints("pads", pads)]))
            return out
        if isinstance(layer, nn.AdaptiveAvgPool2d):
            if tuple(np.atleast_1d(layer.output_size)) in ((1,), (1, 1)):
                self.nodes.append(_node("GlobalAveragePool", [x_name],
                                        [out]))
                return out
            return None
        return None

    _ELTWISE = {"add": "Add", "subtract": "Sub", "multiply": "Mul",
                "divide": "Div"}

    def _n(self, op_type, inputs, base, attrs=()):
        o = self.tname(base)
        self.nodes.append(_node(op_type, inputs, [o], list(attrs)))
        return o

    def emit_functional(self, opname, args, kwargs, out_t):
        """Emit node(s) for a registry op (``_registry_op``) recorded
        between layer calls. Returns the output name, or None when
        unsupported (the caller falls back to ``jit.save``).

        Unnamed traced intermediates (see in_name) abort the export:
        baking them would freeze a zeros-derived activation into the
        model. Tensors predating the trace are genuine initializers.
        """
        in_name = lambda v: self.in_name(v, out_t)  # noqa: E731
        o = self.tname(opname)
        if opname in self._ELTWISE:
            an, bn = in_name(args[0]), in_name(args[1])
            if an is None or bn is None:
                return None
            self.nodes.append(_node(self._ELTWISE[opname], [an, bn], [o]))
            return o
        if opname == "relu":
            an = in_name(args[0])
            if an is None:
                return None
            self.nodes.append(_node("Relu", [an], [o]))
            return o
        if opname == "erf":
            an = in_name(args[0])
            if an is None:
                return None
            self.nodes.append(_node("Erf", [an], [o]))
            self.min_opset = max(self.min_opset, 9)
            return o
        if opname == "matmul":
            an, bn = in_name(args[0]), in_name(args[1])
            if an is None or bn is None:
                return None
            self.nodes.append(_node("MatMul", [an, bn], [o]))
            return o
        if opname == "softmax":
            an = in_name(args[0])
            if an is None:
                return None
            self.nodes.append(_node("Softmax", [an], [o],
                                    [_attr_int("axis", int(kwargs["axis"]))]))
            self.min_opset = max(self.min_opset, 13)
            return o
        if opname == "transpose":
            an = in_name(args[0])
            if an is None:
                return None
            self.nodes.append(_node(
                "Transpose", [an], [o],
                [_attr_ints("perm", [int(p) for p in kwargs["perm"]])]))
            return o
        if opname == "gelu":
            an = in_name(args[0])
            if an is None:
                return None
            c = lambda v: self.add_init("c", np.float32(v))  # noqa: E731
            if kwargs["approximate"]:
                # 0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))
                x3 = self._n("Mul", [an, self._n(
                    "Mul", [an, an], "x2")], "x3")
                inner = self._n("Add", [an, self._n(
                    "Mul", [x3, c(0.044715)], "sx3")], "inner")
                th = self._n("Tanh", [self._n(
                    "Mul", [inner, c(float(np.sqrt(2.0 / np.pi)))],
                    "si")], "th")
                one = self._n("Add", [th, c(1.0)], "one_p")
                half = self._n("Mul", [an, c(0.5)], "halfx")
                self.nodes.append(_node("Mul", [half, one], [o]))
                return o
            # exact: 0.5 x (1 + erf(x / sqrt(2)))
            er = self._n("Erf", [self._n(
                "Div", [an, c(float(np.sqrt(2.0)))], "xs")], "erf")
            one = self._n("Add", [er, c(1.0)], "one_p")
            half = self._n("Mul", [an, c(0.5)], "halfx")
            self.nodes.append(_node("Mul", [half, one], [o]))
            self.min_opset = max(self.min_opset, 9)
            return o
        if opname == "getitem":
            # single integer index on one axis (seq[:, 0] pooling):
            # Gather with a scalar index drops that axis, like numpy
            src, key = args
            if not isinstance(src, torch.Tensor):
                return None
            key = key if isinstance(key, tuple) else (key,)
            ints = [(i, k) for i, k in enumerate(key)
                    if isinstance(k, int)]
            full = all(isinstance(k, int)
                       or (isinstance(k, slice)
                           and k == slice(None, None, None))
                       for k in key)
            if len(ints) != 1 or not full:
                return None
            an = in_name(src)
            if an is None:
                return None
            axis, idx = ints[0]
            gi = self.add_init("idx", np.asarray(idx, np.int64))
            self.nodes.append(_node("Gather", [an, gi], [o],
                                    [_attr_int("axis", axis)]))
            self.min_opset = max(self.min_opset, 13)  # negative indices
            return o
        if opname in ("flatten", "reshape"):
            # static re-shape with a dynamic batch: Reshape with 0 in
            # dim 0 (ONNX: copy the input's dim), only valid when the
            # op PRESERVES dim 0 (flatten(start_dim=0) / reshape([-1])
            # fold the batch in and must fall back)
            src = args[0]
            if not (isinstance(src, torch.Tensor) and src.ndim >= 1
                    and out_t.ndim >= 1
                    and src.shape[0] == out_t.shape[0]):
                return None
            an = in_name(src)
            if an is None:
                return None
            tgt = [0] + [int(d) for d in out_t.shape[1:]]
            shp = self.add_init("shape", np.asarray(tgt, np.int64))
            self.nodes.append(_node("Reshape", [an, shp], [o]))
            return o
        return None


def export(layer, path: str, input_spec=None, opset_version: int = _OPSET,
           **configs) -> str:
    """Export a module's traced graph (DAG, residual adds included) to
    ``<path>.onnx`` and return that path; a graph beyond the emitters
    warns and returns ``jit.save``'s ``<path>.pdmodel`` (module
    docstring). The trace runs where the module's parameters are."""
    from .. import jit
    from ..core.graph_trace import trace_layer_graph

    if input_spec is None:
        raise ValueError("onnx.export needs input_spec=[InputSpec(shape)] "
                         "to trace the model")
    spec = input_spec[0]
    decl_shape = [d if (d or 0) > 0 else None for d in spec.shape]
    shape = [d if d is not None else 1 for d in decl_shape]
    in_dtype = jit.torch_dtype(getattr(spec, "dtype", "float32"))
    x = torch.zeros(shape, dtype=in_dtype, device=jit._module_device(layer))
    tr = trace_layer_graph(layer, x)
    events, traced_ids, y = tr.events, tr.traced_ids, tr.y

    obj_to_name = {id(x): "input"}
    em = _Emitter(names=obj_to_name, traced_ids=traced_ids)
    supported = bool(events)
    for ev in events:
        if ev[0] == "layer":
            _, mod, inputs, output = ev
            src = inputs[0] if isinstance(inputs, tuple) else inputs
            # in_name also bakes PRE-trace constants as initializers
            x_name = em.in_name(src)
            nm = None if x_name is None else em.emit(mod, x_name)
        else:
            _, name, args, kwargs, output = ev
            if _is_layout_only(name, args, kwargs):
                nm = em.in_name(args[0])
            else:
                op = _registry_op(name, args, kwargs)
                nm = None if op is None else em.emit_functional(*op, output)
        if nm is None or not isinstance(output, torch.Tensor):
            supported = False
            break
        obj_to_name[id(output)] = nm
    # the model's return value must BE a traced output, or forward()
    # post-processing would be dropped
    if not (supported and isinstance(y, torch.Tensor)
            and id(y) in obj_to_name):
        jit.save(layer, path, input_spec=input_spec)
        warnings.warn(
            "onnx.export covers DAGs of Linear/Conv/BN/activation/pool "
            "layers plus elementwise/reshape glue; this model uses layers "
            "or ops without an ONNX mapping: wrote the torch.export "
            f"program {path}.pdmodel instead (inference.create_predictor "
            "loads it)")
        return path + ".pdmodel"
    out_name = obj_to_name[id(y)]

    graph = b"".join([
        *(P.field_message(1, n) for n in em.nodes),
        P.field_string(2, type(layer).__name__),
        *(P.field_message(5, t) for t in em.inits),
        P.field_message(11, _value_info("input", decl_shape,
                                        _elem_type(_np_dtype(in_dtype)))),
        P.field_message(12, _value_info(
            out_name, [None if decl_shape[0] is None and i == 0 else int(d)
                       for i, d in enumerate(y.shape)],
            _elem_type(_np_dtype(y.dtype)))),
    ])
    final_opset = max(opset_version, em.min_opset)
    opset = P.field_string(1, "") + P.field_varint(2, final_opset)
    model = b"".join([
        P.field_varint(1, _IR_VERSION),
        P.field_string(2, "paddle_tpu"),
        P.field_string(3, "0.3"),
        P.field_message(7, graph),
        P.field_message(8, opset),
    ])
    out_path = path if path.endswith(".onnx") else path + ".onnx"
    with open(out_path, "wb") as f:
        f.write(model)
    return out_path
