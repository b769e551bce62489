"""Minimal protobuf wire-format writer/reader for ONNX emission: a copy
of ``paddle_tpu/onnx/_proto.py``.

No ``onnx`` package is needed: ``onnx.export`` serializes ModelProto
directly in protobuf wire format (varints + length-delimited
submessages, the stable part of protobuf). Field numbers follow the
public onnx.proto (onnx/onnx.proto, IR version 8).
"""
from __future__ import annotations

from typing import List, Tuple, Union


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def field_varint(num: int, value: int) -> bytes:
    return _varint(num << 3 | 0) + _varint(value)


def field_bytes(num: int, payload: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def field_string(num: int, s: str) -> bytes:
    return field_bytes(num, s.encode("utf-8"))


def field_message(num: int, encoded: bytes) -> bytes:
    return field_bytes(num, encoded)


# -- reader (for round-trip tests) -----------------------------------------

def parse(buf: bytes) -> List[Tuple[int, int, Union[int, bytes]]]:
    """[(field_number, wire_type, value)] — value is int for varint
    fields, bytes for length-delimited."""
    out = []
    i = 0
    n = len(buf)
    while i < n:
        tag, i = _read_varint(buf, i)
        fnum, wt = tag >> 3, tag & 7
        if wt == 0:
            v, i = _read_varint(buf, i)
            out.append((fnum, wt, v))
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            out.append((fnum, wt, buf[i:i + ln]))
            i += ln
        elif wt == 5:  # 32-bit
            out.append((fnum, wt, buf[i:i + 4]))
            i += 4
        elif wt == 1:  # 64-bit
            out.append((fnum, wt, buf[i:i + 8]))
            i += 8
        else:
            raise ValueError(f"unsupported wire type {wt}")
    return out


def _read_varint(buf: bytes, i: int):
    shift = 0
    val = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def fields(buf: bytes, num: int):
    return [v for f, _, v in parse(buf) if f == num]
