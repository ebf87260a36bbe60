"""PMT analog: polymorphic metadata values + binary serialization.

Reference parity: gnuradio-runtime/lib/pmt/ (pmt.cc, pmt_serialize.cc) — a
lisp-style immutable value system (bool, symbol, numbers, pairs, tuples,
dicts, uniform numeric vectors) used for stream tags, messages/PDUs, and the
ZMQ wire format. This build keeps metadata on the HOST (device arrays
carry only samples), so "PMT" here is plain Python values plus a
self-describing binary codec with the same type coverage:

    None, bool, int (64-bit), float (f64), complex (c128), str (symbol),
    bytes (u8 vector), tuple, list (vector of pmts), dict,
    numpy arrays of u8/s8/u16/s16/u32/s32/u64/s64/f32/f64/c64/c128
    (uniform vectors, pmt_unv.cc analog)

The wire format is NOT GNU Radio's (we don't interop with its sockets); it
is a compact tag-length-value codec with the same round-trip guarantees the
reference QA asserts (lib/pmt/qa_pmt_prims.cc serialization round-trips).
A PDU is the pair (metadata_dict, numpy_vector), as in the reference.
"""
from __future__ import annotations

import struct
from typing import Any

import numpy as np

# type tags
_NIL, _TRUE, _FALSE, _INT, _REAL, _CPLX, _SYM, _BYTES = range(8)
_TUPLE, _LIST, _DICT, _UVEC, _PAIR = range(8, 13)

_UVEC_DTYPES = ["u1", "i1", "u2", "i2", "u4", "i4", "u8", "i8",
                "f4", "f8", "c8", "c16"]
_DT_CODE = {np.dtype(d): i for i, d in enumerate(_UVEC_DTYPES)}


def serialize(obj: Any) -> bytes:
    out = bytearray()
    _ser(obj, out)
    return bytes(out)


def _ser(o, out: bytearray):
    if o is None:
        out.append(_NIL)
    elif o is True:
        out.append(_TRUE)
    elif o is False:
        out.append(_FALSE)
    elif isinstance(o, int):
        out.append(_INT)
        out += struct.pack(">q", o)
    elif isinstance(o, float):
        out.append(_REAL)
        out += struct.pack(">d", o)
    elif isinstance(o, complex):
        out.append(_CPLX)
        out += struct.pack(">dd", o.real, o.imag)
    elif isinstance(o, str):
        b = o.encode()
        out.append(_SYM)
        out += struct.pack(">I", len(b)) + b
    elif isinstance(o, bytes):
        out.append(_BYTES)
        out += struct.pack(">I", len(o)) + o
    elif isinstance(o, tuple):
        out.append(_TUPLE)
        out += struct.pack(">I", len(o))
        for x in o:
            _ser(x, out)
    elif isinstance(o, list):
        out.append(_LIST)
        out += struct.pack(">I", len(o))
        for x in o:
            _ser(x, out)
    elif isinstance(o, dict):
        out.append(_DICT)
        out += struct.pack(">I", len(o))
        for k, v in o.items():
            _ser(k, out)
            _ser(v, out)
    elif isinstance(o, np.ndarray):
        a = np.ascontiguousarray(o)
        if a.dtype not in _DT_CODE:
            raise TypeError(f"unsupported uniform vector dtype {a.dtype}")
        out.append(_UVEC)
        out.append(_DT_CODE[a.dtype])
        out += struct.pack(">I", a.size)
        out += a.tobytes()
    elif (isinstance(o, np.generic)):
        _ser(o.item(), out)
    else:
        raise TypeError(f"cannot serialize {type(o)} as pmt")


def deserialize(buf: bytes) -> Any:
    obj, off = _deser(buf, 0)
    if off != len(buf):
        raise ValueError("trailing bytes after pmt")
    return obj


def _deser(buf, off):
    t = buf[off]
    off += 1
    if t == _NIL:
        return None, off
    if t == _TRUE:
        return True, off
    if t == _FALSE:
        return False, off
    if t == _INT:
        return struct.unpack_from(">q", buf, off)[0], off + 8
    if t == _REAL:
        return struct.unpack_from(">d", buf, off)[0], off + 8
    if t == _CPLX:
        re, im = struct.unpack_from(">dd", buf, off)
        return complex(re, im), off + 16
    if t == _SYM:
        n = struct.unpack_from(">I", buf, off)[0]
        off += 4
        return buf[off:off + n].decode(), off + n
    if t == _BYTES:
        n = struct.unpack_from(">I", buf, off)[0]
        off += 4
        return bytes(buf[off:off + n]), off + n
    if t in (_TUPLE, _LIST):
        n = struct.unpack_from(">I", buf, off)[0]
        off += 4
        items = []
        for _ in range(n):
            x, off = _deser(buf, off)
            items.append(x)
        return (tuple(items) if t == _TUPLE else items), off
    if t == _DICT:
        n = struct.unpack_from(">I", buf, off)[0]
        off += 4
        d = {}
        for _ in range(n):
            k, off = _deser(buf, off)
            v, off = _deser(buf, off)
            d[k] = v
        return d, off
    if t == _UVEC:
        dt = np.dtype(_UVEC_DTYPES[buf[off]])
        off += 1
        n = struct.unpack_from(">I", buf, off)[0]
        off += 4
        nb = n * dt.itemsize
        a = np.frombuffer(buf[off:off + nb], dtype=dt).copy()
        return a, off + nb
    raise ValueError(f"bad pmt type tag {t}")


def make_pdu(meta: dict | None, data: np.ndarray):
    """A PDU is (metadata-dict, uniform vector) — pmt cons analog."""
    return (dict(meta or {}), np.asarray(data))


def is_pdu(o) -> bool:
    return (isinstance(o, tuple) and len(o) == 2 and isinstance(o[0], dict)
            and isinstance(o[1], np.ndarray))
