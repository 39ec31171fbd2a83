"""Read the JAX package's Orbax checkpoints with numpy and zstd alone.

The JAX package saves through Orbax into tensorstore's OCDBT key-value
store (``checkpoints/r4_synth_bf16`` and ``r5_ms_bf16`` are two), and each
array is a zarr v2 array in it.  A machine without JAX, Orbax or
tensorstore reads them here.  The layout, worked out from the files and
held against tensorstore's own reads by ``tests/test_torch_orbax.py``:

* **Files.**  ``manifest.ocdbt`` at the root and the b-tree nodes under
  ``d/`` share a frame: a 4-byte big-endian magic (``0cdb3a2a`` for a
  manifest, ``0cdb20de`` for a node), the file's length as 8 bytes little
  endian, a version varint (0), a compression varint (0 none, 1 zstd),
  the body (one zstd frame when compressed), and a CRC32C of all bytes
  before it as 4 bytes little endian.  A node is a byte range of a data
  file; the large data files hold values (zarr chunks) back to back.
* **Manifest body.**  The config: a 16-byte uuid, the manifest kind
  (varint; 0, a single manifest, is the one read here), the largest
  inline value, the largest decoded node, the version tree's arity (log2,
  one byte), the compression method (varint; 1 is zstd, followed by its
  level as 4 bytes).  Then the newest versions: a data file table, their
  count, and per field one array of varints: generation, root height (one
  byte each), the root node's data file, offset and length, keys, tree
  bytes, indirect value bytes, then the commit times (8 bytes each); then
  the count of older version-tree nodes, which this reader does not need.
* **Data file table.**  A count n, the bytes each path shares with the
  one before (n - 1 varints), each path's remaining length (n), each
  path's base length (n), then the remaining bytes of every path in turn.
  Paths are relative to the checkpoint directory.
* **B-tree node body.**  Its height (one byte), a data file table, the
  entry count n, then the keys prefix-compressed as the paths are (n - 1
  shared lengths, n suffix lengths; an interior node adds each child's
  common key prefix length), the key bytes.  A leaf then has each value's
  length (n), its kind (n; 0 stored inline, 1 a byte range of a data
  file), each indirect value's data file and offset, then the inline
  values' bytes in turn.  An interior node has each child's data file,
  offset and length, then its key count, tree bytes and indirect value
  bytes; a child's keys leave out the parent's key prefix and the common
  prefix.
* **Arrays.**  Orbax keys a leaf of the saved tree by its path joined
  with ``.``; ``<path>/.zarray`` holds zarr v2 metadata
  (``"compressor": {"id": "zstd"}``, ``"order": "C"``) and
  ``<path>/<i>.<j>...`` the chunks, each one zstd frame.  ``_METADATA``
  lists the tree's paths and which keys index a list.

zstd comes from ``libzstd.so.1`` through ``ctypes`` (:data:`ZSTD_LIBRARY`
names the library loaded).  bfloat16 leaves come back as arrays of :data:`BFLOAT16`, a numpy
dtype that holds the raw 16-bit words (numpy has no bfloat16);
:func:`as_float32` widens them exactly.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import json
import os
import struct
from typing import Any, Callable, Dict, Iterable, List, Tuple

import numpy as np

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
HEADER_BYTES = 14          # magic, length, version, compression
BFLOAT16 = np.dtype([("bfloat16", "<u2")])

ZSTD_LIBRARY = ctypes.util.find_library("zstd") or "libzstd.so.1"


class FormatError(ValueError):
    """The bytes are not the layout this reader knows."""


# ---------------------------------------------------------------------------
# zstd
# ---------------------------------------------------------------------------
_ZSTD_CONTENTSIZE_UNKNOWN = 2 ** 64 - 1
_ZSTD_CONTENTSIZE_ERROR = 2 ** 64 - 2


def _libzstd() -> ctypes.CDLL:
    lib = ctypes.CDLL(ZSTD_LIBRARY)
    size_t = ctypes.c_size_t
    lib.ZSTD_findFrameCompressedSize.argtypes = [ctypes.c_char_p, size_t]
    lib.ZSTD_findFrameCompressedSize.restype = size_t
    lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_char_p, size_t]
    lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
    lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, size_t,
                                    ctypes.c_char_p, size_t]
    lib.ZSTD_decompress.restype = size_t
    lib.ZSTD_isError.argtypes = [size_t]
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_getErrorName.argtypes = [size_t]
    lib.ZSTD_getErrorName.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def decompressor() -> Callable[[bytes, int], bytes]:
    """``decompress(src, size_hint) -> bytes`` for one or more zstd frames
    laid end to end, by ``libzstd`` through ``ctypes``; ``size_hint`` is
    the expected size where a frame does not record its own."""
    lib = _libzstd()

    def check(code: int) -> int:
        if lib.ZSTD_isError(code):
            raise FormatError("zstd: "
                              + lib.ZSTD_getErrorName(code).decode())
        return code

    def frame(src: bytes, size_hint: int) -> bytes:
        size = lib.ZSTD_getFrameContentSize(src, len(src))
        if size == _ZSTD_CONTENTSIZE_ERROR:
            raise FormatError("zstd: not a frame")
        cap = size if size != _ZSTD_CONTENTSIZE_UNKNOWN else max(
            size_hint, 4 * len(src), 1024)
        while True:
            buf = ctypes.create_string_buffer(max(cap, 1))
            code = lib.ZSTD_decompress(buf, cap, src, len(src))
            if not lib.ZSTD_isError(code):
                return buf.raw[:code]
            if (size != _ZSTD_CONTENTSIZE_UNKNOWN
                    or b"too small" not in lib.ZSTD_getErrorName(code)):
                check(code)
            cap *= 2

    def decompress(src: bytes, size_hint: int) -> bytes:
        out: List[bytes] = []
        pos = 0
        while pos < len(src):     # frames laid end to end
            n = check(lib.ZSTD_findFrameCompressedSize(src[pos:],
                                                       len(src) - pos))
            out.append(frame(src[pos:pos + n], size_hint))
            pos += n
        return b"".join(out)

    return decompress


# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven
# ---------------------------------------------------------------------------
def _crc_table() -> np.ndarray:
    table = np.zeros(256, np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table[i] = c
    return table


_CRC_TABLE = _crc_table().tolist()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for byte in data:
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# ---------------------------------------------------------------------------
# encoded structures
# ---------------------------------------------------------------------------
class _Reader:
    """A cursor over decoded bytes."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise FormatError(f"{self.what}: truncated at byte {self.pos}")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value = shift = 0
        while True:
            b = self.byte()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise FormatError(f"{self.what}: varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def done(self) -> None:
        if self.pos != len(self.data):
            raise FormatError(f"{self.what}: {len(self.data) - self.pos} "
                              "bytes left over")


def _prefixed(r: _Reader, n: int, shared: List[int], lengths: List[int]
              ) -> List[bytes]:
    """n strings, each sharing ``shared[i - 1]`` bytes with the one before
    and adding ``lengths[i]`` bytes read in turn."""
    out: List[bytes] = []
    prev = b""
    for i in range(n):
        keep = shared[i - 1] if i else 0
        if keep > len(prev):
            raise FormatError(f"{r.what}: shared prefix {keep} longer than "
                              f"the string before it")
        prev = prev[:keep] + r.take(lengths[i])
        out.append(prev)
    return out


def _data_file_table(r: _Reader) -> List[str]:
    n = r.varint()
    if n == 0:
        return []
    shared = r.varints(n - 1)
    lengths = r.varints(n)
    base = r.varints(n)
    paths = _prefixed(r, n, shared, lengths)
    if any(b > len(p) for b, p in zip(base, paths)):
        raise FormatError(f"{r.what}: base path longer than its path")
    return [p.decode() for p in paths]


def _unframe(raw: bytes, magic: int, what: str, decompress) -> bytes:
    """Check a manifest or node frame (magic, length, CRC32C) and return
    its decoded body."""
    if len(raw) < HEADER_BYTES + 4:
        raise FormatError(f"{what}: {len(raw)} bytes, shorter than a frame")
    got_magic, length = struct.unpack(">I", raw[:4])[0], struct.unpack(
        "<Q", raw[4:12])[0]
    if got_magic != magic:
        raise FormatError(f"{what}: magic {got_magic:08x}, expected "
                          f"{magic:08x}")
    if length != len(raw):
        raise FormatError(f"{what}: header says {length} bytes, the file "
                          f"holds {len(raw)}")
    stored = struct.unpack("<I", raw[-4:])[0]
    if crc32c(raw[:-4]) != stored:
        raise FormatError(f"{what}: CRC32C mismatch")
    r = _Reader(raw[:-4], what)
    r.take(12)
    if r.varint() != 0:
        raise FormatError(f"{what}: unknown format version")
    compression = r.varint()
    body = raw[r.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return decompress(body, 4 * len(body))
    raise FormatError(f"{what}: unknown compression {compression}")


class _Store:
    """The key-value pairs of one OCDBT directory."""

    def __init__(self, root: str, decompress):
        self.root = root
        self.decompress = decompress
        self._files: Dict[str, bytes] = {}

    def _bytes(self, path: str, offset: int, length: int) -> bytes:
        if path not in self._files:
            full = os.path.join(self.root, path)
            if os.path.commonpath([os.path.abspath(full), self.root]) \
                    != self.root:
                raise FormatError(f"data file {path!r} outside the "
                                  "checkpoint")
            with open(full, "rb") as f:
                self._files[path] = f.read()
        data = self._files[path]
        if offset + length > len(data):
            raise FormatError(f"{path}: range {offset}+{length} past its "
                              f"{len(data)} bytes")
        return data[offset:offset + length]

    def root_node(self) -> Tuple[str, int, int, int]:
        """(data file, offset, length, height) of the newest version's
        root node."""
        with open(os.path.join(self.root, "manifest.ocdbt"), "rb") as f:
            raw = f.read()
        r = _Reader(_unframe(raw, MANIFEST_MAGIC, "manifest.ocdbt",
                             self.decompress), "manifest.ocdbt")
        r.take(16)                                   # uuid
        kind = r.varint()
        if kind != 0:
            raise FormatError(f"manifest kind {kind}: only a single "
                              "manifest (0) is read here")
        r.varint()                                   # max inline value
        r.varint()                                   # max decoded node
        r.byte()                                     # version tree arity
        method = r.varint()
        if method == 1:
            r.take(4)                                # zstd level
        elif method != 0:
            raise FormatError(f"unknown compression method {method}")
        files = _data_file_table(r)
        n = r.varint()
        if n == 0:
            raise FormatError("manifest lists no version")
        generation = r.varints(n)
        height = [r.byte() for _ in range(n)]
        file_id, offset, length = r.varints(n), r.varints(n), r.varints(n)
        r.varints(3 * n)              # keys, tree bytes, indirect bytes
        r.take(8 * n)                 # commit times
        # what follows references older versions' nodes, not read here
        i = max(range(n), key=generation.__getitem__)
        if file_id[i] >= len(files):
            raise FormatError("manifest: root in an unlisted data file")
        return files[file_id[i]], offset[i], length[i], height[i]

    def items(self) -> Dict[bytes, Tuple[str, ...]]:
        """key -> ("inline", bytes) or ("file", path, offset, length)."""
        out: Dict[bytes, Tuple] = {}
        path, offset, length, height = self.root_node()
        self._walk(path, offset, length, height, b"", out)
        return out

    def _walk(self, path: str, offset: int, length: int, height: int,
              prefix: bytes, out: Dict[bytes, Tuple]) -> None:
        what = f"b-tree node {path}@{offset}"
        r = _Reader(_unframe(self._bytes(path, offset, length), NODE_MAGIC,
                             what, self.decompress), what)
        if r.byte() != height:
            raise FormatError(f"{what}: height differs from its reference")
        files = _data_file_table(r)
        n = r.varint()
        shared = r.varints(max(n - 1, 0))
        lengths = r.varints(n)
        common = r.varints(n) if height else None
        keys = _prefixed(r, n, shared, lengths)

        def file_of(i: int) -> str:
            if i >= len(files):
                raise FormatError(f"{what}: data file {i} not in its table")
            return files[i]

        if height:
            ids, offsets, sizes = r.varints(n), r.varints(n), r.varints(n)
            r.varints(3 * n)          # keys, tree bytes, indirect bytes
            r.done()
            for key, c, i, o, s in zip(keys, common, ids, offsets, sizes):
                self._walk(file_of(i), o, s, height - 1, prefix + key[:c],
                           out)
            return
        sizes = r.varints(n)
        kinds = r.varints(n)
        indirect = [i for i, k in enumerate(kinds) if k == 1]
        if any(k not in (0, 1) for k in kinds):
            raise FormatError(f"{what}: unknown value kind")
        ids, offsets = r.varints(len(indirect)), r.varints(len(indirect))
        refs = dict(zip(indirect, zip(ids, offsets)))
        for i, key in enumerate(keys):
            if kinds[i] == 0:
                out[prefix + key] = ("inline", r.take(sizes[i]))
            else:
                fid, off = refs[i]
                out[prefix + key] = ("file", file_of(fid), off, sizes[i])
        r.done()

    def value(self, ref: Tuple) -> bytes:
        if ref[0] == "inline":
            return ref[1]
        return self._bytes(*ref[1:])


# ---------------------------------------------------------------------------
# zarr arrays and the checkpoint's tree
# ---------------------------------------------------------------------------
def _zarr_dtype(name: str) -> np.dtype:
    if name == "bfloat16":
        return BFLOAT16
    dtype = np.dtype(name)
    if dtype.kind not in "biuf":
        raise FormatError(f"zarr dtype {name!r} is not read here")
    return dtype


def _read_array(store: _Store, items: Dict[bytes, Tuple], key: str
                ) -> np.ndarray:
    ref = items.get(f"{key}/.zarray".encode())
    if ref is None:
        raise FormatError(f"no array {key!r} in the checkpoint")
    meta = json.loads(store.value(ref))
    if meta.get("zarr_format") != 2 or meta.get("order", "C") != "C" \
            or meta.get("filters"):
        raise FormatError(f"{key}: zarr metadata {meta} is not read here")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise FormatError(f"{key}: compressor {compressor}")
    dtype = _zarr_dtype(meta["dtype"])
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    fill = meta.get("fill_value") or 0
    out = np.zeros(shape, dtype)
    if fill and dtype != BFLOAT16:
        out[...] = fill
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    for idx in np.ndindex(*grid):
        name = sep.join(map(str, idx)) if idx else "0"
        ref = items.get(f"{key}/{name}".encode())
        if ref is None:
            continue                                  # fill value
        raw = store.value(ref)
        if compressor is not None:
            raw = store.decompress(raw, chunk_bytes)
        if len(raw) != chunk_bytes:
            raise FormatError(f"{key}/{name}: {len(raw)} bytes, expected "
                              f"{chunk_bytes}")
        chunk = np.frombuffer(raw, dtype).reshape(chunks)
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(idx, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start)
                                  for r in region)]
    return out


def _tree_paths(root: str) -> List[List[Tuple[str, int]]]:
    """The saved tree's leaf paths from ``_METADATA``: each a list of
    (key, key type), type 1 indexing a list."""
    with open(os.path.join(root, "_METADATA"), encoding="utf-8") as f:
        meta = json.load(f)
    paths = []
    for entry in meta["tree_metadata"].values():
        paths.append([(k["key"], int(k["key_type"]))
                      for k in entry["key_metadata"]])
    return paths


def _insert(tree: Dict, path: List[Tuple[str, int]], value: Any) -> None:
    for key, _ in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1][0]] = value


def read_checkpoint(path: str, groups: Iterable[str] = ("params",
                                                        "model_state")
                    ) -> Dict[str, Any]:
    """The arrays of an Orbax checkpoint directory under its top-level
    ``groups``, as the saved tree: nested dicts, lists where the tree had
    lists, ``np.ndarray`` leaves in the saved dtypes (bfloat16 as
    :data:`BFLOAT16` words).  Raises :class:`FormatError` on bytes it
    does not know, and ``FileNotFoundError`` on a missing file."""
    root = os.path.abspath(path)
    store = _Store(root, decompressor())
    items = store.items()
    groups = tuple(groups)
    out: Dict[str, Any] = {}
    lists = set()
    for leaf in _tree_paths(root):
        if leaf[0][0] not in groups:
            continue
        for depth, (_, key_type) in enumerate(leaf):
            if key_type == 1:
                lists.add(tuple(k for k, _ in leaf[:depth]))
        _insert(out, leaf, _read_array(store, items,
                                       ".".join(k for k, _ in leaf)))

    def to_lists(tree: Any, at: Tuple[str, ...]) -> Any:
        if not isinstance(tree, dict):
            return tree
        items_ = {k: to_lists(v, at + (k,)) for k, v in tree.items()}
        if at in lists:
            return [items_[str(i)] for i in range(len(items_))]
        return items_

    return {g: to_lists(out[g], (g,)) for g in groups if g in out}


def as_float32(a: np.ndarray) -> np.ndarray:
    """A leaf widened to fp32, exactly for bfloat16 words."""
    if a.dtype == BFLOAT16:
        words = a.view(np.uint16).astype(np.uint32) << 16
        return words.view(np.float32)
    return np.asarray(a, np.float32)


def map_leaves(fn: Callable[[np.ndarray], Any], tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_leaves(fn, v) for v in tree]
    return fn(tree)


def is_orbax_checkpoint(path: str) -> bool:
    return (os.path.isdir(path)
            and os.path.isfile(os.path.join(path, "manifest.ocdbt"))
            and os.path.isfile(os.path.join(path, "_METADATA")))
