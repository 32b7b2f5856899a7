"""Minimal protobuf wire-format reader/writer, pure Python (the port's own
copy of opencv_tpu/dnn/proto.py; the port imports nothing of the JAX
package).

The reference vendors a full protobuf runtime (3rdparty/protobuf) to
parse Caffe/TF/ONNX models. The importers need exactly four wire
primitives — varint, 64-bit, length-delimited, 32-bit — applied to field
numbers taken from the PUBLIC .proto specifications. The writer half
exists for round-trip tests and for emitting small fixture models.

Wire format (protobuf encoding spec): each record is a varint key
(field_number << 3 | wire_type) followed by a payload. Wire types:
0 varint, 1 fixed64, 2 length-delimited, 5 fixed32.
"""

from __future__ import annotations

import struct


def read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def parse(buf: bytes) -> dict[int, list]:
    """Decode one message into {field_number: [payload, ...]}.

    varint fields -> int; fixed64 -> 8 bytes; length-delimited -> bytes;
    fixed32 -> 4 bytes. Submessages/strings/packed arrays stay bytes —
    the caller knows the schema."""
    fields: dict[int, list] = {}
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = read_varint(buf, pos)
        fnum, wtype = key >> 3, key & 7
        if wtype == 0:
            val, pos = read_varint(buf, pos)
        elif wtype == 1:
            val = buf[pos:pos + 8]
            pos += 8
        elif wtype == 2:
            ln, pos = read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wtype == 5:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype} at {pos}")
        fields.setdefault(fnum, []).append(val)
    return fields


# -- typed accessors ------------------------------------------------------

def _signed64(x: int) -> int:
    """Varint payload -> signed int64 (two's complement). All int fields
    in the importer schemas are int32/int64; e.g. ONNX axis: -1 arrives
    as 2^64 - 1 on the wire."""
    return x - (1 << 64) if x >= (1 << 63) else x


def get_int(fields, num, default=None):
    v = fields.get(num)
    return _signed64(v[-1]) if v else default


def get_ints(fields, num):
    """Repeated varint field, accepting both packed and unpacked forms."""
    out = []
    for v in fields.get(num, []):
        if isinstance(v, int):
            out.append(_signed64(v))
        else:  # packed
            pos = 0
            while pos < len(v):
                x, pos = read_varint(v, pos)
                out.append(_signed64(x))
    return out


def get_bytes(fields, num, default=b""):
    v = fields.get(num)
    return v[-1] if v else default


def get_str(fields, num, default=""):
    v = fields.get(num)
    return v[-1].decode("utf-8") if v else default


def get_strs(fields, num):
    return [v.decode("utf-8") for v in fields.get(num, [])]


def get_float(fields, num, default=None):
    v = fields.get(num)
    if not v:
        return default
    return struct.unpack("<f", v[-1])[0]


def get_floats_packed(fields, num):
    """Repeated float field (packed or unpacked)."""
    out = []
    for v in fields.get(num, []):
        if isinstance(v, bytes):
            out.extend(struct.unpack(f"<{len(v) // 4}f", v))
        else:
            out.append(v)
    return out


def get_messages(fields, num):
    return [parse(v) for v in fields.get(num, [])]


# -- writer (fixtures / round-trip tests) --------------------------------

def write_varint(x: int) -> bytes:
    # negative ints are encoded as their 64-bit two's complement
    # (10-byte varint), per the protobuf spec — e.g. axis: -1 in ONNX
    if x < 0:
        x &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def field_varint(num: int, val: int) -> bytes:
    return write_varint(num << 3 | 0) + write_varint(val)


def field_bytes(num: int, val: bytes) -> bytes:
    return write_varint(num << 3 | 2) + write_varint(len(val)) + val


def field_str(num: int, val: str) -> bytes:
    return field_bytes(num, val.encode("utf-8"))


def field_float(num: int, val: float) -> bytes:
    return write_varint(num << 3 | 5) + struct.pack("<f", val)


def field_floats_packed(num: int, vals) -> bytes:
    payload = struct.pack(f"<{len(vals)}f", *vals)
    return field_bytes(num, payload)
