"""A reader of flax's msgpack checkpoints (``variables.msgpack``).

The JAX package writes a model's variables with
``flax.serialization.to_bytes``: msgpack of the variables' state dict, where
each array is msgpack's extension type 1 holding the msgpack of ``(shape,
dtype name, C-order bytes)``, a numpy scalar is type 3 (the same payload,
rank 0), and a Python complex is type 2 (``(real, imag)``). Lists and tuples
were turned into maps with the keys ``"0"``, ``"1"``, ...; those keys stay
strings here, as ``flax.serialization.msgpack_restore`` leaves them.

``msgpack_restore(data)`` decodes such bytes with the standard library and
numpy into the nested dict of numpy arrays that flax's function returns:
arrays are read-only ``np.frombuffer`` views of ``data``. Whatever it
cannot read exactly it refuses with a ``ValueError``: a dtype numpy lacks
(``bfloat16``), flax's chunked arrays (``__msgpack_chunked_array__``, written
for arrays above 2^30 bytes), an extension code flax does not write, and
truncated or trailing bytes.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED_KEY = "__msgpack_chunked_array__"

_FIXED = {  # type byte -> (struct format, size) of the fixed-width scalars
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LENGTH = {1: ">B", 2: ">H", 4: ">I"}
# type byte -> width of the length of a str, bin, array, map or ext
_STR = {0xD9: 1, 0xDA: 2, 0xDB: 4}
_BIN = {0xC4: 1, 0xC5: 2, 0xC6: 4}
_ARRAY = {0xDC: 2, 0xDD: 4}
_MAP = {0xDE: 2, 0xDF: 4}
_EXT = {0xC7: 1, 0xC8: 2, 0xC9: 4}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Decoder:
    """One pass over a msgpack buffer. ``raw`` (how flax reads an array's
    payload) leaves str as bytes and bin as a view of the buffer."""

    def __init__(self, data, raw: bool = False):
        self.view = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.view):
            raise ValueError(f"msgpack data truncated: need {n} bytes at offset {self.pos}")
        out = self.view[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self.take(n))[0]

    def length(self, width: int) -> int:
        return self.unpack(_LENGTH[width], width)

    def string(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def decode(self) -> Any:
        t = self.unpack(">B", 1)
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.decode() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return self.string(t & 0x1F)
        if t == 0xC0:
            return None
        if t in (0xC2, 0xC3):
            return t == 0xC3
        if t in _FIXED:
            return self.unpack(*_FIXED[t])
        if t in _STR:
            return self.string(self.length(_STR[t]))
        if t in _BIN:
            data = self.take(self.length(_BIN[t]))
            return data if self.raw else bytes(data)
        if t in _ARRAY:
            return [self.decode() for _ in range(self.length(_ARRAY[t]))]
        if t in _MAP:
            return self.map(self.length(_MAP[t]))
        if t in _EXT:
            n = self.length(_EXT[t])
            return self.ext(self.unpack(">b", 1), n)
        if t in _FIXEXT:
            return self.ext(self.unpack(">b", 1), _FIXEXT[t])
        raise ValueError(f"msgpack type byte 0x{t:02x} at offset {self.pos - 1} is not valid msgpack")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.decode()
            if not isinstance(key, (str, bytes)):
                raise ValueError(f"msgpack map key {key!r} is not a string")
            out[key] = self.decode()
        return out

    def ext(self, code: int, n: int):
        payload = self.take(n)
        if code == EXT_NDARRAY:
            return _ndarray(payload)
        if code == EXT_NPSCALAR:
            return _ndarray(payload)[()]
        if code == EXT_COMPLEX:
            real, imag = _decode_all(payload)
            return complex(real, imag)
        raise ValueError(f"msgpack extension type {code} is not one flax writes (1, 2, 3)")


def _decode_all(data, raw: bool = False) -> Any:
    dec = _Decoder(data, raw=raw)
    out = dec.decode()
    if dec.pos != len(dec.view):
        raise ValueError(f"{len(dec.view) - dec.pos} trailing bytes after the msgpack object")
    return out


def _dtype(name: bytes) -> np.dtype:
    text = name.decode("ascii") if isinstance(name, bytes) else str(name)
    try:
        dtype = np.dtype(text)
    except TypeError:
        dtype = None
    # numpy's own booleans and numbers only: bfloat16 and the other
    # ml_dtypes types register with numpy (isbuiltin 2) only where that
    # package is imported.
    if dtype is None or dtype.isbuiltin != 1 or dtype.kind not in "biufc" or dtype.name != text:
        raise ValueError(f"array dtype {text!r} is not one of numpy's own number types "
                         "(bfloat16 needs ml_dtypes); it cannot be read exactly")
    return dtype


def _ndarray(payload: memoryview) -> np.ndarray:
    """flax's ``_ndarray_from_bytes``: ``(shape, dtype name, bytes)``."""
    fields = _decode_all(payload, raw=True)
    if not (isinstance(fields, list) and len(fields) == 3):
        raise ValueError("an ndarray extension must hold (shape, dtype, bytes)")
    shape, name, buffer = fields
    dtype = _dtype(name)
    shape: Tuple[int, ...] = tuple(int(s) for s in shape)
    if len(buffer) != dtype.itemsize * int(np.prod(shape, dtype=np.int64)):
        raise ValueError(f"ndarray of shape {shape} and dtype {dtype} has {len(buffer)} bytes")
    return np.frombuffer(buffer, dtype=dtype).reshape(shape)


def _refuse_chunks(tree: Any) -> None:
    if isinstance(tree, dict):
        if CHUNKED_KEY in tree:
            raise ValueError("flax chunked arrays (leaves above 2^30 bytes) are not read")
        for value in tree.values():
            _refuse_chunks(value)


def msgpack_restore(data: bytes) -> Any:
    """The state dict ``flax.serialization.msgpack_restore(data)`` gives:
    nested dicts (and lists) with numpy array, numpy scalar and Python
    leaves."""
    out = _decode_all(data)
    _refuse_chunks(out)
    return out


def read_msgpack(path: str) -> Any:
    """``msgpack_restore`` of the file at ``path``."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())
