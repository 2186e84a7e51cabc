"""Dependency-free ONNX serializer and parser (the port's copy of the JAX
package's ``export/onnx_writer.py``, byte for byte in what it writes).

ONNX files are plain protobuf, and the subset these graphs need (Conv /
BatchNormalization / activations / Add / Concat / Upsample / MaxPool / Pad
and float initializers) is a small, stable schema, so the ModelProto wire
format is written directly and needs no ``onnx`` package. Field numbers
follow onnx.proto3. The parser is a generic tag-length-value decoder over
the same subset: :func:`parse_model` feeds ``export/onnx_eval.py`` and the
round-trip checks.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# TensorProto.DataType
FLOAT = 1
INT64 = 7

# AttributeProto.AttributeType
ATTR_FLOAT, ATTR_INT, ATTR_STRING, ATTR_TENSOR = 1, 2, 3, 4
ATTR_FLOATS, ATTR_INTS, ATTR_STRINGS = 6, 7, 8


# ---------------------------------------------------------------------------
# low-level protobuf encoding
# ---------------------------------------------------------------------------

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


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_varint(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value)


def _f_bytes(field: int, data: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(data)) + data


def _f_string(field: int, s: str) -> bytes:
    return _f_bytes(field, s.encode("utf-8"))


def _f_packed_int64(field: int, values: Sequence[int]) -> bytes:
    payload = b"".join(_varint(v) for v in values)
    return _f_bytes(field, payload)


def _f_packed_float(field: int, values: np.ndarray) -> bytes:
    return _f_bytes(field, np.asarray(values, "<f4").tobytes())


def _f_float(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", value)


# ---------------------------------------------------------------------------
# ONNX message builders (each returns serialized bytes)
# ---------------------------------------------------------------------------

def make_tensor(name: str, array: np.ndarray) -> bytes:
    """TensorProto with raw_data (float32 or int64)."""
    array = np.asarray(array)
    if array.dtype in (np.float32, np.float64):
        array = array.astype("<f4")
        dtype = FLOAT
    elif array.dtype in (np.int64, np.int32):
        array = array.astype("<i8")
        dtype = INT64
    else:
        raise TypeError(f"unsupported dtype {array.dtype}")
    msg = b""
    msg += _f_packed_int64(1, list(array.shape))        # dims
    msg += _f_varint(2, dtype)                          # data_type
    msg += _f_string(8, name)                           # name
    msg += _f_bytes(9, array.tobytes())                 # raw_data
    return msg


def _make_attribute(name: str, value) -> bytes:
    msg = _f_string(1, name)
    if isinstance(value, bool):
        msg += _f_varint(3, int(value)) + _f_varint(20, ATTR_INT)
    elif isinstance(value, int):
        msg += _f_varint(3, value) + _f_varint(20, ATTR_INT)
    elif isinstance(value, float):
        msg += _f_float(2, value) + _f_varint(20, ATTR_FLOAT)
    elif isinstance(value, str):
        msg += _f_bytes(4, value.encode()) + _f_varint(20, ATTR_STRING)
    elif isinstance(value, np.ndarray):
        msg += _f_bytes(5, make_tensor(name + "_t", value)) + _f_varint(20, ATTR_TENSOR)
    elif isinstance(value, (list, tuple)):
        if all(isinstance(v, int) for v in value):
            msg += _f_packed_int64(8, list(value)) + _f_varint(20, ATTR_INTS)
        elif all(isinstance(v, (int, float)) for v in value):
            msg += _f_packed_float(7, np.asarray(value, np.float32))
            msg += _f_varint(20, ATTR_FLOATS)
        else:
            raise TypeError(f"attribute list {name}: {value}")
    else:
        raise TypeError(f"attribute {name}: {type(value)}")
    return msg


def make_node(op_type: str, inputs: Sequence[str], outputs: Sequence[str],
              name: str = "", **attrs) -> bytes:
    msg = b""
    for i in inputs:
        msg += _f_string(1, i)
    for o in outputs:
        msg += _f_string(2, o)
    if name:
        msg += _f_string(3, name)
    msg += _f_string(4, op_type)
    for k in sorted(attrs):
        msg += _f_bytes(5, _make_attribute(k, attrs[k]))
    return msg


def make_value_info(name: str, shape: Sequence[Optional[int]],
                    elem_type: int = FLOAT) -> bytes:
    dims = b""
    for d in shape:
        if d is None:
            # TensorShapeProto.Dimension.dim_param is field 2 (field 3 is
            # the denotation string)
            dims += _f_bytes(1, _f_string(2, "N"))
        else:
            dims += _f_bytes(1, _f_varint(1, int(d)))
    tensor_type = _f_varint(1, elem_type) + _f_bytes(2, dims)
    type_proto = _f_bytes(1, tensor_type)
    return _f_string(1, name) + _f_bytes(2, type_proto)


def make_graph(name: str, nodes: Sequence[bytes], inputs: Sequence[bytes],
               outputs: Sequence[bytes], initializers: Sequence[bytes]) -> bytes:
    # joined once: appending each initializer to a growing message copies
    # the message again and again (quadratic in a YOLOv3's 237 MiB)
    return b"".join([*(_f_bytes(1, n) for n in nodes), _f_string(2, name),
                     *(_f_bytes(5, t) for t in initializers),
                     *(_f_bytes(11, i) for i in inputs),
                     *(_f_bytes(12, o) for o in outputs)])


def make_model(graph: bytes, opset: int = 9,
               producer_name: str = "mit-driverless-cv-traininginfra-tpu",
               ir_version: int = 6) -> bytes:
    opset_msg = _f_string(1, "") + _f_varint(2, opset)
    msg = _f_varint(1, ir_version)
    msg += _f_string(2, producer_name)
    msg += _f_bytes(7, graph)
    msg += _f_bytes(8, opset_msg)
    return msg


def save_model(path: str, model_bytes: bytes) -> None:
    with open(path, "wb") as f:
        f.write(model_bytes)


# ---------------------------------------------------------------------------
# minimal decoder (round-trip verification)
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def parse_message(buf: bytes) -> Dict[int, List]:
    """Generic TLV decode: field number → list of raw values (int for
    varint/fixed, bytes for length-delimited)."""
    out: Dict[int, List] = {}
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wire == 5:
            val = struct.unpack("<f", buf[pos : pos + 4])[0]
            pos += 4
        elif wire == 1:
            val = struct.unpack("<d", buf[pos : pos + 8])[0]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        out.setdefault(field, []).append(val)
    return out


def parse_model(buf: bytes) -> dict:
    """Decode a model produced by :func:`make_model` into a friendly dict."""
    m = parse_message(buf)
    g = parse_message(m[7][0])
    nodes = []
    for nb in g.get(1, []):
        n = parse_message(nb)
        attrs = {}
        for ab in n.get(5, []):
            a = parse_message(ab)
            aname = a[1][0].decode()
            atype = a.get(20, [0])[0]
            if atype == ATTR_INT:
                attrs[aname] = a[3][0]
            elif atype == ATTR_FLOAT:
                attrs[aname] = a[2][0]
            elif atype == ATTR_STRING:
                attrs[aname] = a[4][0].decode()
            elif atype == ATTR_INTS:
                vals, p = [], 0
                raw = a[8][0]
                while p < len(raw):
                    v, p = _read_varint(raw, p)
                    vals.append(v)
                attrs[aname] = vals
            elif atype == ATTR_FLOATS:
                attrs[aname] = list(np.frombuffer(a[7][0], "<f4"))
        nodes.append({
            "op_type": n[4][0].decode(),
            "inputs": [x.decode() for x in n.get(1, [])],
            "outputs": [x.decode() for x in n.get(2, [])],
            "name": n.get(3, [b""])[0].decode(),
            "attrs": attrs,
        })
    inits = {}
    for tb in g.get(5, []):
        t = parse_message(tb)
        dims_raw = t.get(1, [b""])[0]
        dims, p = [], 0
        if isinstance(dims_raw, (bytes, bytearray)):
            while p < len(dims_raw):
                v, p = _read_varint(dims_raw, p)
                dims.append(v)
        else:  # single unpacked dim
            dims = t.get(1, [])
        dtype = t.get(2, [FLOAT])[0]
        raw = t.get(9, [b""])[0]
        arr = np.frombuffer(raw, "<f4" if dtype == FLOAT else "<i8")
        inits[t[8][0].decode()] = arr.reshape(dims)

    def vi(b):
        v = parse_message(b)
        tp = parse_message(v[2][0])
        tt = parse_message(tp[1][0])
        shape = []
        for db in parse_message(tt.get(2, [b""])[0]).get(1, []):
            d = parse_message(db)
            shape.append(d.get(1, [None])[0])
        return {"name": v[1][0].decode(), "shape": shape}

    return {
        "producer": m.get(2, [b""])[0].decode(),
        "opset": parse_message(m[8][0])[2][0],
        "graph_name": g[2][0].decode(),
        "nodes": nodes,
        "initializers": inits,
        "inputs": [vi(b) for b in g.get(11, [])],
        "outputs": [vi(b) for b in g.get(12, [])],
    }
