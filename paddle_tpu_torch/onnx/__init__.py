"""paddle.onnx namespace (port of ``paddle_tpu/onnx``): ``export`` writes
an ONNX ModelProto in protobuf wire format (``_proto``) for DAGs of
Linear / Conv / BN / activation / pool layers and the elementwise and
reshape glue between them, the vision zoo's graphs among them, and
falls back to ``jit.save``'s ``torch.export`` program, with a warning,
for a graph beyond that set (a folded model's ``ConvBnAct`` among them).
"""
from __future__ import annotations

from .export import export  # noqa: F401

__all__ = ["export"]
