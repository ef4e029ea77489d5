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

``write_stream(fields, columns, metadata)`` writes the same subset: a
``Schema`` message with the custom metadata, one ``RecordBatch`` and the end
of the stream, little-endian and uncompressed, each buffer padded to 8
bytes, a validity bitmap only where a column has nulls. ``numbers``,
``strings``, ``lists`` and ``nested_lists`` build the columns from numpy.
The flatbuffers are laid out front to back (a table's vtable just before
it, its children after it, every scalar at its own alignment), which is
what the reader above and pyarrow's verifier accept.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
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


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------

METADATA_V5 = 4
INT32_MAX = 2**31 - 1


class _Structs:
    """A flatbuffer vector of structs of format ``fmt`` (8-byte aligned)."""

    def __init__(self, fmt: str, items: Sequence[tuple]):
        self.fmt, self.items = fmt, list(items)


class _FlatTable:
    """A flatbuffer table to write: field index -> ``(fmt, value)`` for a
    scalar (a ``struct`` format), or the child (``_FlatTable``, ``str``, a
    list of tables or ``_Structs``) an offset points to."""

    def __init__(self, fields: Dict[int, Any]):
        self.fields = fields


class _FlatWriter:
    """Lays out a flatbuffer front to back: the root offset, then each
    object before the objects it points to, so every uoffset is positive."""

    def __init__(self):
        self.buf = bytearray(4)

    def _pad(self, align: int, extra: int = 0) -> None:
        """Pads so that what is written ``extra`` bytes on is aligned."""
        self.buf.extend(b"\0" * (-(len(self.buf) + extra) % align))

    def _point(self, at: int, child: Any) -> None:
        pos = self._write(child)
        struct.pack_into("<I", self.buf, at, pos - at)

    def _write(self, obj: Any) -> int:
        buf = self.buf
        if isinstance(obj, str):
            data = obj.encode("utf-8")
            self._pad(4)
            pos = len(buf)
            buf.extend(struct.pack("<I", len(data)) + data + b"\0")
            return pos
        if isinstance(obj, _Structs):
            self._pad(8, extra=4)  # the items 8-aligned after the length
            pos = len(buf)
            buf.extend(struct.pack("<I", len(obj.items)))
            for item in obj.items:
                buf.extend(struct.pack("<" + obj.fmt, *item))
            return pos
        if isinstance(obj, list):  # a vector of tables
            self._pad(4)
            pos = len(buf)
            buf.extend(struct.pack("<I", len(obj)) + b"\0" * (4 * len(obj)))
            for i, child in enumerate(obj):
                self._point(pos + 4 + 4 * i, child)
            return pos
        # A table: its soffset, then its fields at their own alignment,
        # largest first, after an 8-aligned start.
        sizes = {i: struct.calcsize("<" + v[0]) if isinstance(v, tuple) else 4 for i, v in obj.fields.items()}
        offsets, end = {}, 4
        for i in sorted(sizes, key=lambda i: (-sizes[i], i)):
            end += -end % sizes[i]
            offsets[i] = end
            end += sizes[i]
        end += -end % 4
        n_slots = max(obj.fields, default=-1) + 1
        self._pad(2)
        vtable = len(buf)
        buf.extend(struct.pack(f"<{2 + n_slots}H", 4 + 2 * n_slots, end,
                               *(offsets.get(i, 0) for i in range(n_slots))))
        self._pad(8)
        pos = len(buf)
        buf.extend(b"\0" * end)
        struct.pack_into("<i", buf, pos, pos - vtable)
        for i, v in obj.fields.items():
            if isinstance(v, tuple):
                struct.pack_into("<" + v[0], buf, pos + offsets[i], v[1])
        for i, v in obj.fields.items():
            if not isinstance(v, tuple):
                self._point(pos + offsets[i], v)
        return pos

    def finish(self, root: _FlatTable) -> bytes:
        struct.pack_into("<I", self.buf, 0, self._write(root))
        self._pad(8)
        return bytes(self.buf)


def _type_table(dtype: DataType) -> Tuple[int, _FlatTable]:
    """The ``Type`` union's code and table of ``dtype``."""
    if dtype.kind == "int":
        return TYPE_INT, _FlatTable({0: ("i", dtype.dtype.itemsize * 8), 1: ("?", dtype.dtype.kind == "i")})
    if dtype.kind == "float":
        precision = {np.dtype(v).itemsize: k for k, v in FLOAT_DTYPES.items()}[dtype.dtype.itemsize]
        return TYPE_FLOAT, _FlatTable({0: ("h", precision)})
    code = {"bool": TYPE_BOOL, "utf8": TYPE_UTF8, "large_utf8": TYPE_LARGE_UTF8, "list": TYPE_LIST,
            "large_list": TYPE_LARGE_LIST}.get(dtype.kind)
    if code is None:
        raise ValueError(f"Arrow type {dtype} is not written")
    return code, _FlatTable({})


def _field_table(field: Field) -> _FlatTable:
    code, spec = _type_table(field.type)
    children = [] if field.type.child is None else [_field_table(Field("item", field.type.child, True))]
    return _FlatTable({0: field.name, 1: ("?", field.nullable), 2: ("B", code), 3: spec, 5: children})


def _message(header_type: int, header: _FlatTable, body_length: int) -> bytes:
    """A framed message: the continuation word, the metadata's length and
    the metadata, padded so that the body that follows starts 8-aligned."""
    meta = _FlatWriter().finish(_FlatTable({0: ("h", METADATA_V5), 1: ("B", header_type), 2: header,
                                         3: ("q", body_length)}))
    meta += b"\0" * (-len(meta) % 8)
    return struct.pack("<Ii", CONTINUATION, len(meta)) + meta


def _le(values: np.ndarray) -> bytes:
    return np.ascontiguousarray(values, values.dtype.newbyteorder("<")).tobytes()


def _packed(bits: np.ndarray) -> bytes:
    return np.packbits(np.asarray(bits, bool), bitorder="little").tobytes()


def _flatten(arr: Array, nodes: List[tuple], buffers: List[bytes]) -> None:
    """``arr``'s node and buffers in pre-order, as ``_read_array`` reads them."""
    nulls = 0 if arr.validity is None else int((~np.asarray(arr.validity, bool)).sum())
    nodes.append((arr.length, nulls))
    buffers.append(_packed(arr.validity) if nulls else b"")
    kind = arr.type.kind
    if kind in ("int", "float"):
        buffers.append(_le(np.asarray(arr.values, arr.type.dtype)))
    elif kind == "bool":
        buffers.append(_packed(arr.values))
    else:
        large = kind in ("large_utf8", "large_list")
        offsets = np.asarray(arr.offsets, np.int64)
        if not large and offsets[-1] > INT32_MAX:
            raise ValueError(f"{offsets[-1]} items overflow a {kind}'s int32 offsets; use its large form")
        buffers.append(_le(offsets.astype("<i8" if large else "<i4")))
        if kind in ("utf8", "large_utf8"):
            buffers.append(bytes(arr.data))
        else:
            _flatten(arr.child, nodes, buffers)


def write_stream(fields: Sequence[Field], columns: Sequence[Array],
                 metadata: Optional[Dict[str, str]] = None) -> bytes:
    """An Arrow IPC stream of one record batch: ``columns[i]`` is the column
    of ``fields[i]`` (all of one length); ``metadata`` the schema's custom
    key-value strings."""
    if len(fields) != len(columns):
        raise ValueError(f"{len(fields)} fields for {len(columns)} columns")
    lengths = {len(c) for c in columns}
    if len(lengths) > 1:
        raise ValueError(f"columns of different lengths {sorted(lengths)}")
    for f, c in zip(fields, columns):
        if f.type != c.type:
            raise ValueError(f"field {f.name!r} is {f.type}, its column {c.type}")
    schema = _FlatTable({0: ("h", 0), 1: [_field_table(f) for f in fields],
                         2: [_FlatTable({0: k, 1: v}) for k, v in (metadata or {}).items()]})
    nodes: List[tuple] = []
    buffers: List[bytes] = []
    for c in columns:
        _flatten(c, nodes, buffers)
    spans, body = [], bytearray()
    for b in buffers:
        spans.append((len(body), len(b)))
        body.extend(b + b"\0" * (-len(b) % 8))
    batch = _FlatTable({0: ("q", lengths.pop() if lengths else 0), 1: _Structs("qq", nodes),
                        2: _Structs("qq", spans)})
    return b"".join([_message(HEADER_SCHEMA, schema, 0), _message(HEADER_RECORD_BATCH, batch, len(body)),
                     bytes(body), struct.pack("<Ii", CONTINUATION, 0)])


def numbers(values: np.ndarray) -> Array:
    """A column of the 1-D numeric or bool array ``values``."""
    values = np.asarray(values)
    if values.ndim != 1:
        raise ValueError(f"numbers takes a 1-D array, not {values.shape}")
    if values.dtype == np.bool_:
        return Array(DataType("bool"), len(values), values=values)
    if values.dtype.kind in "iu":
        return Array(DataType("int", values.dtype.newbyteorder("<")), len(values), values=values)
    if values.dtype.kind == "f":
        return Array(DataType("float", values.dtype.newbyteorder("<")), len(values), values=values)
    raise TypeError(f"no Arrow number type for numpy {values.dtype}")


def strings(items: Sequence[str]) -> Array:
    """A ``utf8`` column of ``items``."""
    data = [s.encode("utf-8") for s in items]
    offsets = np.concatenate([[0], np.cumsum([len(d) for d in data], dtype=np.int64)])
    return Array(DataType("utf8"), len(data), offsets=offsets, data=memoryview(b"".join(data)))


def lists(child: Array, lengths: Sequence[int], large: bool = False) -> Array:
    """A column whose row ``i`` holds the next ``lengths[i]`` items of ``child``."""
    offsets = np.concatenate([[0], np.cumsum(np.asarray(lengths, np.int64))]).astype(np.int64)
    if offsets[-1] != len(child):
        raise ValueError(f"lengths sum to {offsets[-1]}, the child has {len(child)} items")
    return Array(DataType("large_list" if large else "list", child=child.type), len(lengths),
                 offsets=offsets, child=child)


def nested_lists(arrays: Sequence[np.ndarray]) -> Array:
    """A column whose row ``i`` is the array ``arrays[i]`` (``[n_i, *shape]``,
    one ``shape`` and dtype for all) as lists nested one level per axis, as
    ``datasets`` stores a list of numpy arrays."""
    if not arrays:
        raise ValueError("nested_lists needs at least one array")
    first = np.asarray(arrays[0])
    if first.ndim == 0:
        raise ValueError("nested_lists takes arrays of at least one axis")
    shape = first.shape[1:]
    for a in arrays:
        if np.asarray(a).shape[1:] != shape:
            raise ValueError(f"arrays of trailing shapes {shape} and {np.asarray(a).shape[1:]}")
    flat = np.concatenate([np.asarray(a, first.dtype).reshape(-1, *shape) for a in arrays])
    column = numbers(flat.reshape(-1))
    for k in reversed(range(len(shape))):  # innermost axis first: n * prod(shape[:k]) lists of shape[k]
        column = lists(column, np.full(len(flat) * math.prod(shape[:k]), shape[k], np.int64))
    return lists(column, [np.asarray(a).shape[0] for a in arrays])
