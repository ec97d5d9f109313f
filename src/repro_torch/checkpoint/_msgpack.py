"""A small MessagePack codec for checkpoint manifests, in pure Python.

The JAX package writes ``manifest.msgpack`` with the ``msgpack`` package.
The port reads and writes the same files without it: :func:`packb` gives
the bytes of ``msgpack.packb(obj)`` at its defaults for the types a
manifest holds (dict, list, tuple, str, bytes, int, float, bool, None), and
:func:`unpackb` reads them back as ``msgpack.unpackb`` does:

* ints take their smallest form (positive fixint, uint 8-64 for the other
  non-negative values, negative fixint, int 8-64 for the other negative
  ones);
* floats are float64; str is fixstr/str8/str16/str32 of its UTF-8 bytes,
  bytes (and bytearray, memoryview) bin8/16/32; lists and tuples arrays,
  dicts maps in insertion order;
* ``unpackb`` returns lists for arrays, reads float32 too, and refuses map
  keys other than str and bytes unless ``strict_map_key=False``.

Anything else (another type on the way in, an ext type, a reserved byte,
truncated or trailing input on the way out) raises ``TypeError`` or
``ValueError``.
"""

from __future__ import annotations

import struct

__all__ = ["packb", "unpackb"]


def packb(obj) -> bytes:
    """``obj`` as MessagePack bytes, as ``msgpack.packb(obj)`` gives them."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack_len(n: int, out: bytearray, fix_base, fix_max, codes) -> None:
    """A length header: the fixed form below ``fix_max``, else the first of
    ``codes`` (8-, 16- or 32-bit length) that holds ``n``."""
    if fix_base is not None and n < fix_max:
        out.append(fix_base | n)
        return
    for code, fmt, limit in codes:
        if code is not None and n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"object too large for MessagePack: length {n}")


_STR_CODES = ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32))
_BIN_CODES = ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16), (0xC6, ">I", 1 << 32))
_ARRAY_CODES = ((None, "", 0), (0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32))
_MAP_CODES = ((None, "", 0), (0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32))


def _pack_int(v: int, out: bytearray) -> None:
    if v >= 0:
        if v < 0x80:
            out.append(v)
        elif v < 1 << 8:
            out += b"\xcc" + struct.pack(">B", v)
        elif v < 1 << 16:
            out += b"\xcd" + struct.pack(">H", v)
        elif v < 1 << 32:
            out += b"\xce" + struct.pack(">I", v)
        elif v < 1 << 64:
            out += b"\xcf" + struct.pack(">Q", v)
        else:
            raise OverflowError(f"int too big for MessagePack: {v}")
    elif v >= -32:
        out.append(v & 0xFF)
    elif v >= -(1 << 7):
        out += b"\xd0" + struct.pack(">b", v)
    elif v >= -(1 << 15):
        out += b"\xd1" + struct.pack(">h", v)
    elif v >= -(1 << 31):
        out += b"\xd2" + struct.pack(">i", v)
    elif v >= -(1 << 63):
        out += b"\xd3" + struct.pack(">q", v)
    else:
        raise OverflowError(f"int too small for MessagePack: {v}")


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
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(len(raw), out, 0xA0, 32, _STR_CODES)
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _pack_len(len(raw), out, None, 0, _BIN_CODES)
        out += raw
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), out, 0x90, 16, _ARRAY_CODES)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), out, 0x80, 16, _MAP_CODES)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def unpackb(data, *, strict_map_key: bool = True):
    """The one object MessagePack ``data`` holds, as ``msgpack.unpackb``
    reads it (arrays as lists, str as str, bin as bytes)."""
    reader = _Reader(bytes(data), strict_map_key)
    obj = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError(
            f"extra data after the MessagePack object: "
            f"{len(reader.buf) - reader.pos} byte(s)"
        )
    return obj


class _Reader:
    def __init__(self, buf: bytes, strict_map_key: bool):
        self.buf = buf
        self.pos = 0
        self.strict_map_key = strict_map_key

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("truncated MessagePack data")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b < 0x90:
            return self.read_map(b & 0x0F)
        if b < 0xA0:
            return self.read_array(b & 0x0F)
        if b < 0xC0:
            return self.read_str(b & 0x1F)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        fixed = _FIXED.get(b)
        if fixed is not None:
            return self.unpack(fixed)
        sized = _SIZED.get(b)
        if sized is None:
            raise ValueError(f"unsupported MessagePack byte 0x{b:02x}")
        kind, fmt = sized
        n = self.unpack(fmt)
        if kind == "str":
            return self.read_str(n)
        if kind == "bin":
            return self.take(n)
        if kind == "array":
            return self.read_array(n)
        return self.read_map(n)

    def read_str(self, n: int) -> str:
        return self.take(n).decode("utf-8")

    def read_array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def read_map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            if self.strict_map_key and not isinstance(k, (str, bytes)):
                raise ValueError(
                    f"{type(k).__name__} is not allowed for map key when "
                    f"strict_map_key=True"
                )
            out[k] = self.read()
        return out


# fixed-width scalars: type byte -> struct format
_FIXED = {
    0xCA: ">f", 0xCB: ">d",
    0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}
# length-prefixed containers: type byte -> (kind, length format)
_SIZED = {
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
}
