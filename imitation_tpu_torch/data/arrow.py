"""A reader of the Arrow IPC stream format, with the standard library and numpy.

HuggingFace ``datasets`` saves a dataset as Arrow IPC streams
(``data-00000-of-0000N.arrow``), as the repo's expert demos under
``output/experts/<env>/rollouts`` are. A stream is a sequence of
messages, each the continuation word ``0xFFFFFFFF``, the int32 length of a
flatbuffer ``Message``, the message (padded to 8 bytes), then its body of
``bodyLength`` bytes; a zero length ends the stream. The first message is
the ``Schema``, the rest ``RecordBatch``es.

``read_stream(data)`` returns a ``Table``: the schema's fields, its custom
metadata (``{key: value}`` strings) and one ``ChunkedArray`` per column, a
chunk per record batch. Types read: ``Int`` (8-64 bits, signed or not),
``FloatingPoint`` (half, single, double), ``Bool`` (bit-packed, LSB first),
``Utf8`` and ``LargeUtf8``, ``List`` and ``LargeList`` of any of these.
Validity bitmaps are honoured (a zero-length bitmap when ``null_count`` is
0), as are offsets that do not start at 0. Numeric buffers are
``np.frombuffer`` views of ``data``.

It refuses, with the reason: body compression (LZ4 or ZSTD), dictionary
batches and dictionary-encoded fields, big-endian data, the pre-0.15 format
without the continuation word, other types, and truncated streams.
"""

from __future__ import annotations

import bisect
import dataclasses
import struct
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

CONTINUATION = 0xFFFFFFFF
HEADER_SCHEMA, HEADER_DICTIONARY_BATCH, HEADER_RECORD_BATCH = 1, 2, 3
HEADER_NAMES = {1: "Schema", 2: "DictionaryBatch", 3: "RecordBatch", 4: "Tensor", 5: "SparseTensor"}
# Schema.fbs's ``union Type`` codes of the types read here.
TYPE_INT, TYPE_FLOAT, TYPE_UTF8, TYPE_BOOL, TYPE_LIST = 2, 3, 5, 6, 12
TYPE_LARGE_UTF8, TYPE_LARGE_LIST = 20, 21
FLOAT_DTYPES = {0: np.float16, 1: np.float32, 2: np.float64}  # Precision HALF, SINGLE, DOUBLE
CODECS = {0: "LZ4_FRAME", 1: "ZSTD"}


class _Table:
    """A flatbuffer table at ``pos`` of ``buf``: its vtable sits at ``pos``
    minus the signed int32 stored at ``pos``; each field's entry in the
    vtable is its offset from ``pos``, or 0 when the field is absent."""

    def __init__(self, buf: memoryview, pos: int):
        self.buf, self.pos = buf, pos
        self.vtable = pos - struct.unpack_from("<i", buf, pos)[0]
        self.vtable_size = struct.unpack_from("<H", buf, self.vtable)[0]

    def _offset(self, field: int) -> int:
        entry = 4 + 2 * field
        return struct.unpack_from("<H", self.buf, self.vtable + entry)[0] if entry < self.vtable_size else 0

    def scalar(self, field: int, fmt: str, default=0):
        off = self._offset(field)
        return struct.unpack_from("<" + fmt, self.buf, self.pos + off)[0] if off else default

    def _target(self, field: int) -> Optional[int]:
        """Where the uoffset stored in ``field`` points (tables, strings,
        vectors), or None."""
        off = self._offset(field)
        if not off:
            return None
        at = self.pos + off
        return at + struct.unpack_from("<I", self.buf, at)[0]

    def table(self, field: int) -> Optional["_Table"]:
        at = self._target(field)
        return None if at is None else _Table(self.buf, at)

    def string(self, field: int) -> Optional[str]:
        at = self._target(field)
        if at is None:
            return None
        n = struct.unpack_from("<I", self.buf, at)[0]
        return bytes(self.buf[at + 4:at + 4 + n]).decode("utf-8")

    def _vector(self, field: int) -> Tuple[int, int]:
        at = self._target(field)
        if at is None:
            return 0, 0
        return at + 4, struct.unpack_from("<I", self.buf, at)[0]

    def tables(self, field: int) -> List["_Table"]:
        start, n = self._vector(field)
        return [_Table(self.buf, start + 4 * i + struct.unpack_from("<I", self.buf, start + 4 * i)[0])
                for i in range(n)]

    def structs(self, field: int, fmt: str) -> List[tuple]:
        start, n = self._vector(field)
        size = struct.calcsize("<" + fmt)
        return [struct.unpack_from("<" + fmt, self.buf, start + size * i) for i in range(n)]


@dataclasses.dataclass(frozen=True)
class DataType:
    """A column's type: ``kind`` is ``int``, ``float``, ``bool``, ``utf8``,
    ``large_utf8``, ``list`` or ``large_list``; ``dtype`` the numpy dtype of
    a number; ``child`` a list's item type."""

    kind: str
    dtype: Optional[np.dtype] = None
    child: Optional["DataType"] = None

    def __str__(self) -> str:
        if self.child is not None:
            return f"{self.kind}<{self.child}>"
        return self.kind if self.dtype is None else f"{self.kind}:{self.dtype}"


@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    type: DataType
    nullable: bool


def _metadata(table: _Table, field: int) -> Dict[str, str]:
    return {kv.string(0): kv.string(1) for kv in table.tables(field)}


def _field(t: _Table) -> Field:
    name = t.string(0) or ""
    if t.table(4) is not None:
        raise ValueError(f"field {name!r} is dictionary-encoded; dictionary batches are not read")
    code, spec = t.scalar(2, "B"), t.table(3)
    children = [_field(c) for c in t.tables(5)]
    if code == TYPE_INT:
        bits, signed = spec.scalar(0, "i"), bool(spec.scalar(1, "?"))
        if bits not in (8, 16, 32, 64):
            raise ValueError(f"field {name!r}: Int of {bits} bits")
        dtype = DataType("int", np.dtype(f"{'i' if signed else 'u'}{bits // 8}").newbyteorder("<"))
    elif code == TYPE_FLOAT:
        dtype = DataType("float", np.dtype(FLOAT_DTYPES[spec.scalar(0, "h")]).newbyteorder("<"))
    elif code == TYPE_BOOL:
        dtype = DataType("bool")
    elif code in (TYPE_UTF8, TYPE_LARGE_UTF8):
        dtype = DataType("utf8" if code == TYPE_UTF8 else "large_utf8")
    elif code in (TYPE_LIST, TYPE_LARGE_LIST):
        if len(children) != 1:
            raise ValueError(f"list field {name!r} has {len(children)} children, not 1")
        dtype = DataType("list" if code == TYPE_LIST else "large_list", child=children[0].type)
    else:
        raise ValueError(f"field {name!r}: Arrow type code {code} is not read (Int, FloatingPoint, Bool, "
                         "Utf8, LargeUtf8, List and LargeList are)")
    return Field(name, dtype, bool(t.scalar(1, "?")))


@dataclasses.dataclass
class Array:
    """One column of one record batch. ``validity`` is None when no value
    is null; ``values`` holds numbers and bools, ``offsets`` bound a list's
    or a string's items in ``child`` or ``data``."""

    type: DataType
    length: int
    validity: Optional[np.ndarray] = None
    values: Optional[np.ndarray] = None
    offsets: Optional[np.ndarray] = None
    data: Optional[memoryview] = None
    child: Optional["Array"] = None

    def __len__(self) -> int:
        return self.length

    def is_null(self, i: int) -> bool:
        return self.validity is not None and not self.validity[i]

    def _dense_numbers(self, start: int, stop: int) -> Optional[np.ndarray]:
        """Items ``start:stop`` of a numeric or bool array without nulls as
        a view, or of a list of such lists of one length as an
        ``[n, length]`` view; None otherwise."""
        if self.values is not None:
            if self.validity is None or self.validity[start:stop].all():
                return self.values[start:stop]
            return None
        if self.type.kind in ("list", "large_list") and self.child.values is not None:
            if self.validity is not None and not self.validity[start:stop].all():
                return None
            offs = self.offsets[start:stop + 1]
            widths = np.diff(offs)
            if widths.size and (widths != widths[0]).any():
                return None
            flat = self.child._dense_numbers(int(offs[0]), int(offs[-1]))
            if flat is None:
                return None
            return flat.reshape(stop - start, int(widths[0]) if widths.size else 0)
        return None

    def value(self, i: int) -> Any:
        """Row ``i``: None if null; a numpy scalar; a str; a list's items as
        a numpy view where they are numbers (``[n]``, or ``[n, k]`` for
        lists of lists of one length ``k``) and as a Python list otherwise."""
        if self.is_null(i):
            return None
        if self.values is not None:
            return self.values[i]
        start, stop = int(self.offsets[i]), int(self.offsets[i + 1])
        if self.data is not None:
            return bytes(self.data[start:stop]).decode("utf-8")
        dense = self.child._dense_numbers(start, stop)
        if dense is not None:
            return dense
        return [self.child.value(j) for j in range(start, stop)]

    def to_pylist(self) -> List[Any]:
        """Every row as Python values (pyarrow's ``to_pylist``)."""
        return [_python(self.value(i)) for i in range(self.length)]


def _python(value: Any) -> Any:
    if isinstance(value, (np.ndarray, np.generic)):
        return value.tolist()
    if isinstance(value, list):
        return [_python(v) for v in value]
    return value


class ChunkedArray:
    """A column over every record batch: a chunk per batch."""

    def __init__(self, type: DataType, chunks: Sequence[Array]):
        self.type = type
        self.chunks = list(chunks)
        self._starts = np.cumsum([0] + [len(c) for c in self.chunks]).tolist()

    def __len__(self) -> int:
        return self._starts[-1]

    def value(self, i: int) -> Any:
        if not 0 <= i < len(self):
            raise IndexError(f"row {i} of {len(self)}")
        k = bisect.bisect_right(self._starts, i) - 1
        return self.chunks[k].value(i - self._starts[k])

    def to_pylist(self) -> List[Any]:
        return [v for c in self.chunks for v in c.to_pylist()]


@dataclasses.dataclass
class Table:
    fields: List[Field]
    metadata: Dict[str, str]
    columns: Dict[str, ChunkedArray]
    num_rows: int
    num_batches: int

    @property
    def column_names(self) -> List[str]:
        return [f.name for f in self.fields]

    def column(self, name: str) -> ChunkedArray:
        return self.columns[name]

    def __len__(self) -> int:
        return self.num_rows


def _bits(body: memoryview, offset: int, length: int, n: int) -> np.ndarray:
    """``n`` LSB-first bits from a bitmap of ``length`` bytes at ``offset``."""
    if length * 8 < n:
        raise ValueError(f"bitmap of {length} bytes holds fewer than {n} bits")
    raw = np.frombuffer(body, np.uint8, count=(n + 7) // 8, offset=offset)
    return np.unpackbits(raw, bitorder="little", count=n).astype(bool)


def _offsets(body: memoryview, buf: Tuple[int, int], dtype: str, n: int) -> np.ndarray:
    offset, length = buf
    if n == 0 and length == 0:
        return np.zeros(1, dtype)
    itemsize = np.dtype(dtype).itemsize
    if length < itemsize * (n + 1):
        raise ValueError(f"offsets buffer of {length} bytes for {n} items")
    offs = np.frombuffer(body, np.dtype(dtype).newbyteorder("<"), count=n + 1, offset=offset)
    if (np.diff(offs) < 0).any():
        raise ValueError("offsets decrease")
    return offs


def _read_array(dtype: DataType, nodes: Iterator, buffers: Iterator, body: memoryview) -> Array:
    """The next array in pre-order: its node, its validity buffer, then the
    type's own buffers and children."""
    length, null_count = next(nodes)
    v_off, v_len = next(buffers)
    if max(v_off + v_len, 0) > len(body):
        raise ValueError("a buffer runs past the message body")
    arr = Array(dtype, length)
    if null_count:
        arr.validity = _bits(body, v_off, v_len, length)
        if int((~arr.validity).sum()) != null_count:
            raise ValueError(f"validity bitmap has {int((~arr.validity).sum())} nulls, node says {null_count}")
    if dtype.kind in ("int", "float"):
        off, n = next(buffers)
        if n < dtype.dtype.itemsize * length:
            raise ValueError(f"{dtype} buffer of {n} bytes for {length} values")
        arr.values = np.frombuffer(body, dtype.dtype, count=length, offset=off)
    elif dtype.kind == "bool":
        off, n = next(buffers)
        arr.values = _bits(body, off, n, length)
    elif dtype.kind in ("utf8", "large_utf8"):
        arr.offsets = _offsets(body, next(buffers), "i4" if dtype.kind == "utf8" else "i8", length)
        off, n = next(buffers)
        if int(arr.offsets[-1]) > n:
            raise ValueError("string offsets run past the data buffer")
        arr.data = body[off:off + n]
    else:  # list, large_list
        arr.offsets = _offsets(body, next(buffers), "i4" if dtype.kind == "list" else "i8", length)
        arr.child = _read_array(dtype.child, nodes, buffers, body)
        if int(arr.offsets[-1]) > len(arr.child):
            raise ValueError("list offsets run past the child array")
    return arr


def _messages(data: memoryview) -> Iterator[Tuple[_Table, memoryview]]:
    pos = 0
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError(f"stream truncated at byte {pos}")
        word, size = struct.unpack_from("<Ii", data, pos)
        if word != CONTINUATION:
            raise ValueError("message without the 0xFFFFFFFF continuation word: the pre-0.15 IPC format "
                             "is not read (or this is not an Arrow stream)")
        if size == 0:
            return  # end of stream
        start = pos + 8
        if start + size > len(data):
            raise ValueError(f"message metadata truncated at byte {start}")
        message = _Table(data, start + struct.unpack_from("<I", data, start)[0])
        body_len = message.scalar(3, "q")
        body_start = start + size
        if body_start + body_len > len(data):
            raise ValueError(f"message body truncated at byte {body_start}")
        yield message, data[body_start:body_start + body_len]
        pos = body_start + body_len


def read_stream(data) -> Table:
    """The ``Table`` an Arrow IPC stream holds (``data``: bytes or any
    buffer; arrays are views of it)."""
    data = memoryview(data).cast("B")
    fields: Optional[List[Field]] = None
    metadata: Dict[str, str] = {}
    chunks: List[List[Array]] = []
    n_rows = n_batches = 0
    for message, body in _messages(data):
        kind = message.scalar(1, "B")
        header = message.table(2)
        if kind == HEADER_SCHEMA:
            if fields is not None:
                raise ValueError("a second Schema message in one stream")
            if header.scalar(0, "h") != 0:
                raise ValueError("big-endian Arrow data is not read")
            fields = [_field(f) for f in header.tables(1)]
            metadata = _metadata(header, 2)
            chunks = [[] for _ in fields]
        elif kind == HEADER_RECORD_BATCH:
            if fields is None:
                raise ValueError("a RecordBatch before the Schema")
            compression = header.table(3)
            if compression is not None:
                codec = compression.scalar(0, "b")
                raise ValueError(f"record batch body is compressed ({CODECS.get(codec, codec)}); "
                                 "compressed IPC bodies are not read")
            nodes = iter(header.structs(1, "qq"))
            buffers = iter(header.structs(2, "qq"))
            length = header.scalar(0, "q")
            for field, column in zip(fields, chunks):
                arr = _read_array(field.type, nodes, buffers, body)
                if len(arr) != length:
                    raise ValueError(f"column {field.name!r} has {len(arr)} rows, the batch {length}")
                column.append(arr)
            if next(nodes, None) is not None or next(buffers, None) is not None:
                raise ValueError("record batch has more nodes or buffers than its schema reads")
            n_rows += length
            n_batches += 1
        elif kind == HEADER_DICTIONARY_BATCH:
            raise ValueError("dictionary batches are not read")
        else:
            raise ValueError(f"message header {HEADER_NAMES.get(kind, kind)} is not read")
    if fields is None:
        raise ValueError("stream holds no Schema message")
    columns = {f.name: ChunkedArray(f.type, c) for f, c in zip(fields, chunks)}
    return Table(fields, metadata, columns, n_rows, n_batches)


def read_file(path: str) -> Table:
    """``read_stream`` of the file at ``path`` (read into memory once)."""
    with open(path, "rb") as f:
        return read_stream(f.read())


def concat_tables(tables: Sequence[Table]) -> Table:
    """The rows of ``tables`` (one schema) one after another; the first
    table's metadata."""
    if not tables:
        raise ValueError("no tables to concatenate")
    first = tables[0]
    for t in tables[1:]:
        if [(f.name, f.type) for f in t.fields] != [(f.name, f.type) for f in first.fields]:
            raise ValueError("tables of different schemas cannot be concatenated")
    columns = {f.name: ChunkedArray(f.type, [c for t in tables for c in t.columns[f.name].chunks])
               for f in first.fields}
    return Table(list(first.fields), dict(first.metadata), columns,
                 sum(t.num_rows for t in tables), sum(t.num_batches for t in tables))
