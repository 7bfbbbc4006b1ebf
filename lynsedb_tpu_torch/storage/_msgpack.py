"""A pure-Python codec for the msgpack subset the storage layer writes.

The WAL, the id map and the field store persist nil, bool, int, float, str,
bin, array and map values. This module encodes exactly as
``msgpack.packb(obj, use_bin_type=True)`` does for those types (smallest
integer width, unsigned for non-negative ints, float64 for every float,
str8/bin8 allowed) and decodes as ``msgpack.unpackb(data, raw=False,
strict_map_key=False)``, so a root directory written by either package opens
in the other. Extension types and float32 encoding are outside the subset;
float32 is still accepted when decoding.
"""

from __future__ import annotations

import struct

_F64 = struct.Struct(">d")
_F32 = struct.Struct(">f")


def packb(obj, use_bin_type: bool = True) -> bytes:
    if not use_bin_type:
        raise ValueError("only use_bin_type=True is supported")
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack_len(n: int, small_tag: int, small_max: int, tag8, tag16: int, tag32: int, out: bytearray) -> None:
    if n <= small_max:
        out.append(small_tag | n)
    elif tag8 is not None and n < 0x100:
        out += bytes((tag8, n))
    elif n < 0x10000:
        out.append(tag16)
        out += n.to_bytes(2, "big")
    elif n < 0x100000000:
        out.append(tag32)
        out += n.to_bytes(4, "big")
    else:
        raise ValueError(f"length {n} exceeds the msgpack limit")


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -0x20 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for tag, width in ((0xCC, 1), (0xCD, 2), (0xCE, 4), (0xCF, 8)):
            if v < 1 << (8 * width):
                out.append(tag)
                out += v.to_bytes(width, "big")
                return
        raise OverflowError("Integer value out of range")
    else:
        for tag, width in ((0xD0, 1), (0xD1, 2), (0xD2, 4), (0xD3, 8)):
            if v >= -(1 << (8 * width - 1)):
                out.append(tag)
                out += v.to_bytes(width, "big", signed=True)
                return
        raise OverflowError("Integer value out of range")


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += _F64.pack(obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(len(raw), 0xA0, 31, 0xD9, 0xDA, 0xDB, out)
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _pack_len(len(raw), 0, -1, 0xC4, 0xC5, 0xC6, out)  # bin has no fix form
        out += raw
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 15, None, 0xDC, 0xDD, out)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 15, None, 0xDE, 0xDF, out)
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def unpackb(data, raw: bool = False, strict_map_key: bool = True):
    if raw:
        raise ValueError("only raw=False is supported")
    buf = memoryview(bytes(data))
    obj, pos = _unpack(buf, 0, strict_map_key)
    if pos != len(buf):
        raise ValueError(f"extra data after the msgpack object ({len(buf) - pos} bytes)")
    return obj


def _read(buf: memoryview, pos: int, n: int):
    end = pos + n
    if end > len(buf):
        raise ValueError("truncated msgpack data")
    return buf[pos:end], end


def _unpack(buf: memoryview, pos: int, strict_map_key: bool):
    if pos >= len(buf):
        raise ValueError("truncated msgpack data")
    tag = buf[pos]
    pos += 1
    if tag < 0x80:
        return tag, pos
    if tag >= 0xE0:
        return tag - 0x100, pos
    if 0xA0 <= tag <= 0xBF:
        return _str(buf, pos, tag & 0x1F)
    if 0x90 <= tag <= 0x9F:
        return _array(buf, pos, tag & 0x0F, strict_map_key)
    if 0x80 <= tag <= 0x8F:
        return _map(buf, pos, tag & 0x0F, strict_map_key)
    if tag == 0xC0:
        return None, pos
    if tag == 0xC2:
        return False, pos
    if tag == 0xC3:
        return True, pos
    if tag in _UINT:
        raw, pos = _read(buf, pos, _UINT[tag])
        return int.from_bytes(raw, "big"), pos
    if tag in _SINT:
        raw, pos = _read(buf, pos, _SINT[tag])
        return int.from_bytes(raw, "big", signed=True), pos
    if tag == 0xCB:
        raw, pos = _read(buf, pos, 8)
        return _F64.unpack(raw)[0], pos
    if tag == 0xCA:
        raw, pos = _read(buf, pos, 4)
        return _F32.unpack(raw)[0], pos
    if tag in _LEN:
        kind, width = _LEN[tag]
        raw, pos = _read(buf, pos, width)
        n = int.from_bytes(raw, "big")
        if kind == "str":
            return _str(buf, pos, n)
        if kind == "bin":
            raw, pos = _read(buf, pos, n)
            return bytes(raw), pos
        if kind == "array":
            return _array(buf, pos, n, strict_map_key)
        return _map(buf, pos, n, strict_map_key)
    raise ValueError(f"msgpack type 0x{tag:02x} is outside the supported subset")


_UINT = {0xCC: 1, 0xCD: 2, 0xCE: 4, 0xCF: 8}
_SINT = {0xD0: 1, 0xD1: 2, 0xD2: 4, 0xD3: 8}
_LEN = {
    0xD9: ("str", 1), 0xDA: ("str", 2), 0xDB: ("str", 4),
    0xC4: ("bin", 1), 0xC5: ("bin", 2), 0xC6: ("bin", 4),
    0xDC: ("array", 2), 0xDD: ("array", 4),
    0xDE: ("map", 2), 0xDF: ("map", 4),
}


def _str(buf: memoryview, pos: int, n: int):
    raw, pos = _read(buf, pos, n)
    return str(raw, "utf-8"), pos


def _array(buf: memoryview, pos: int, n: int, strict_map_key: bool):
    items = []
    for _ in range(n):
        item, pos = _unpack(buf, pos, strict_map_key)
        items.append(item)
    return items, pos


def _map(buf: memoryview, pos: int, n: int, strict_map_key: bool):
    out = {}
    for _ in range(n):
        key, pos = _unpack(buf, pos, strict_map_key)
        if strict_map_key and type(key) not in (str, bytes):
            raise ValueError(f"{type(key).__name__} is not allowed for map key")
        value, pos = _unpack(buf, pos, strict_map_key)
        out[key] = value
    return out, pos
