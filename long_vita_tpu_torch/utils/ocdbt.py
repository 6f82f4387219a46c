"""A read-only OCDBT key-value store, as orbax writes its array data.

OCDBT is tensorstore's "Optionally-Cooperative Distributed B+Tree"; this
module reads the layout set out in tensorstore's published "OCDBT binary
format" document, without tensorstore:

  - ``manifest.ocdbt`` at the store's root: a header (the magic 0x0cdb3a2a,
    big-endian; the file's length, u64 little-endian; the format version and
    the body's compression, varints), the body (a zstd frame when the
    compression is 1) and a CRC-32C of everything before it, u32
    little-endian. The body holds the configuration (uuid, manifest kind,
    inline-value limit, node-size limit, version-tree arity, compression),
    then the newest versions of the tree, each with its root node's
    reference, then references to older version-tree nodes, which no read
    of the newest version needs;
  - B+tree nodes (magic 0x0cdb20de, the same header and CRC-32C): a height,
    a data-file table, then per entry a key (prefix-compressed against the
    entry before it) and either a child reference (data file, offset,
    length, with the bytes of its keys' common prefix) or a value, inline or
    indirect (a data file, an offset and the value's length);
  - a data-file table: prefix-compressed paths, each split into a base path
    and a relative path; a path is resolved against the base path of the
    file that holds the node, so the merged store that orbax makes over
    several processes (the top ``manifest.ocdbt`` whose root node refers
    into ``ocdbt.process_N/d/...``) reads as one tree.

Every node and manifest's CRC-32C is checked. Values are not checksummed by
the format (orbax's zarr chunks carry their own compression framing).
"""
from __future__ import annotations

import dataclasses
import struct
from pathlib import Path
from typing import Optional

from long_vita_tpu_torch.utils import zstd

MANIFEST = "manifest.ocdbt"
MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_SINGLE, _NUMBERED = 0, 1  # manifest kinds


def _crc32c_table() -> list:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as tensorstore computes it over a node."""
    c = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Reader:
    """A cursor over a decoded body."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def _need(self, n: int) -> None:
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.what}: truncated at byte {self.pos} of {len(self.data)}")

    def varint(self) -> int:
        shift = value = 0
        while True:
            self._need(1)
            b = self.data[self.pos]
            self.pos += 1
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                return value
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: a varint longer than 64 bits")

    def varints(self, n: int) -> list:
        return [self.varint() for _ in range(n)]

    def u8(self) -> int:
        self._need(1)
        self.pos += 1
        return self.data[self.pos - 1]

    def fixed(self, fmt: str):
        size = struct.calcsize(fmt)
        self._need(size)
        value = struct.unpack_from(fmt, self.data, self.pos)[0]
        self.pos += size
        return value

    def take(self, n: int) -> bytes:
        self._need(n)
        self.pos += n
        return self.data[self.pos - n:self.pos]


def _decode(encoded: bytes, magic: int, what: str) -> bytes:
    """Check an encoded manifest or node's header and CRC-32C -> its body."""
    if len(encoded) < 18:
        raise ValueError(f"{what}: {len(encoded)} bytes are too few for a header")
    (got,) = struct.unpack_from(">I", encoded, 0)
    if got != magic:
        raise ValueError(f"{what}: magic {got:#010x}, expected {magic:#010x}")
    (length,) = struct.unpack_from("<Q", encoded, 4)
    if length != len(encoded):
        raise ValueError(f"{what}: the header says {length} bytes, the file holds {len(encoded)}")
    (crc,) = struct.unpack_from("<I", encoded, len(encoded) - 4)
    if crc32c(encoded[:-4]) != crc:
        raise ValueError(f"{what}: CRC-32C mismatch (the bytes are corrupt)")
    head = _Reader(encoded[:-4], what)
    head.pos = 12
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise ValueError(f"{what}: format version {version}, this reader knows 0")
    body = encoded[head.pos:-4]
    if compression == 1:
        return zstd.decompress(body)
    if compression != 0:
        raise ValueError(f"{what}: compression format {compression} (0 raw, 1 zstd)")
    return body


@dataclasses.dataclass(frozen=True)
class Value:
    """Where a key's value lies: ``inline`` bytes, or ``length`` bytes at
    ``offset`` in the data file ``path``."""

    length: int
    inline: Optional[bytes] = None
    path: Optional[Path] = None
    offset: int = 0


def _prefixed(r: _Reader, n: int) -> tuple:
    """The length columns of n prefix-compressed byte strings: the prefix
    lengths (of every entry but the first, which has none) and the suffix
    lengths. The suffixes follow, after any other columns (``_join``)."""
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    return prefix, suffix


def _join(r: _Reader, prefix: list, suffix: list) -> list:
    """The suffixes read in turn, each after its prefix of the string
    before it -> the whole strings."""
    out, prev = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            raise ValueError(f"{r.what}: a key prefix of {p} bytes after a {len(prev)}-byte key")
        prev = prev[:p] + r.take(s)
        out.append(prev)
    return out


def _data_files(r: _Reader, base: str) -> list:
    """A data-file table -> each file's (base path, relative path)."""
    n = r.varint()
    prefix, suffix = _prefixed(r, n)
    base_len = r.varints(n)
    out = []
    for path, b in zip(_join(r, prefix, suffix), base_len):
        path = path.decode()
        out.append((base + path[:b], path[b:]))
    return out


@dataclasses.dataclass(frozen=True)
class _NodeRef:
    file: tuple  # (base path, relative path)
    offset: int
    length: int
    prefix: bytes  # the bytes every key under it starts with


class OcdbtStore:
    """The newest version of the OCDBT store in ``root`` (a directory that
    holds ``manifest.ocdbt``): ``list()`` its keys, ``read(key)`` a value,
    ``locate(key)`` where a value lies (a zarr reader maps an indirect value
    from its data file)."""

    def __init__(self, root):
        self.root = Path(root)
        self._entries: dict[str, Value] = {}
        self.bytes_read = 0
        root_ref = self._manifest()
        if root_ref is not None:
            self._walk(root_ref)

    def _file_bytes(self, file: tuple, offset: int, length: int) -> bytes:
        path = self.root / (file[0] + file[1])
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise ValueError(f"{path}: {length} bytes at {offset} reach past its end")
        self.bytes_read += length
        return data

    def _manifest(self) -> Optional[tuple]:
        path = self.root / MANIFEST
        what = str(path)
        encoded = path.read_bytes()
        self.bytes_read += len(encoded)
        r = _Reader(_decode(encoded, MANIFEST_MAGIC, what), what)
        r.take(16)  # uuid
        kind = r.varint()
        if kind == _NUMBERED:
            raise ValueError(f"{what}: a numbered manifest (manifest.<generation> files); "
                             "orbax writes single manifests, and this reader reads those alone")
        if kind != _SINGLE:
            raise ValueError(f"{what}: manifest kind {kind}")
        r.varint()  # max_inline_value_bytes
        r.varint()  # max_decoded_node_bytes
        r.u8()  # version_tree_arity_log2
        if r.varint() == 1:  # zstd: its level
            r.fixed("<i")
        files = _data_files(r, "")
        n = r.varint()
        generation = r.varints(n)
        height = [r.u8() for _ in range(n)]
        file_id, offset, length = r.varints(n), r.varints(n), r.varints(n)
        num_keys = r.varints(n)
        r.varints(n)  # num_tree_bytes
        r.varints(n)  # num_indirect_value_bytes
        for _ in range(n):
            r.fixed("<Q")  # commit_time
        if not n:
            if r.varint():
                raise ValueError(f"{what}: the newest version lies in a version-tree node")
            return None
        i = max(range(n), key=generation.__getitem__)
        if not num_keys[i]:
            return None
        return height[i], _NodeRef(files[file_id[i]], offset[i], length[i], b"")

    def _walk(self, top: tuple) -> None:
        stack = [top]
        while stack:
            want_height, ref = stack.pop()
            what = f"{ref.file[0] + ref.file[1]}@{ref.offset}"
            body = _decode(self._file_bytes(ref.file, ref.offset, ref.length), NODE_MAGIC, what)
            r = _Reader(body, what)
            height = r.u8()
            if height != want_height:
                raise ValueError(f"{what}: a node of height {height} where {want_height} is due")
            files = _data_files(r, ref.file[0])
            n = r.varint()
            prefix, suffix = _prefixed(r, n)
            if height:
                common = r.varints(n)
                keys = _join(r, prefix, suffix)
                fid, off, ln = r.varints(n), r.varints(n), r.varints(n)
                r.varints(n), r.varints(n), r.varints(n)  # num_keys, tree and indirect bytes
                for i in range(n):
                    stack.append((height - 1, _NodeRef(files[fid[i]], off[i], ln[i],
                                                       ref.prefix + keys[i][:common[i]])))
                continue
            keys = _join(r, prefix, suffix)
            lengths = r.varints(n)
            kinds = [r.u8() for _ in range(n)]
            indirect = [i for i in range(n) if kinds[i] == 1]
            if any(k not in (0, 1) for k in kinds):
                raise ValueError(f"{what}: value kinds {sorted(set(kinds))} (0 inline, 1 indirect)")
            fid, off = r.varints(len(indirect)), r.varints(len(indirect))
            where = dict(zip(indirect, zip(fid, off)))
            for i in range(n):
                key = (ref.prefix + keys[i]).decode()
                if i in where:
                    f, o = where[i]
                    base, rel = files[f]
                    self._entries[key] = Value(lengths[i], path=self.root / (base + rel), offset=o)
                else:
                    self._entries[key] = Value(lengths[i], inline=r.take(lengths[i]))

    def list(self, prefix: str = "") -> list:
        """The keys that start with ``prefix``, sorted."""
        return sorted(k for k in self._entries if k.startswith(prefix))

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def locate(self, key: str) -> Value:
        try:
            return self._entries[key]
        except KeyError:
            raise KeyError(f"{key!r} is not in the OCDBT store {self.root}") from None

    def read(self, key: str) -> bytes:
        v = self.locate(key)
        if v.inline is not None:
            return v.inline
        with open(v.path, "rb") as f:
            f.seek(v.offset)
            data = f.read(v.length)
        if len(data) != v.length:
            raise ValueError(f"{v.path}: {key!r}'s {v.length} bytes reach past its end")
        self.bytes_read += v.length
        return data
