"""Versioned, tagged-stream container format (the GBATC wire layout).

A container is a self-describing byte blob::

    magic "GBTC" (4) | version u16 | n_streams u16
    stream table: n_streams x { name_len u8 | name (ascii) | length u64 }
    payloads, concatenated in table order

Every stream is an opaque byte string addressed by name; nothing about the
layout is implicit, so a fresh process can enumerate and slice a container
without any codec state. :class:`ContainerReader` enforces the format
strictly — bad magic, unknown version, a truncated table, truncated
payloads, *and trailing garbage* all raise :class:`ContainerFormatError` —
which is what lets the codec assert ``len(blob)`` equals the sum of the
header and the stream table's lengths exactly (the byte accounting is a
view over this table, not an estimate).

Containers nest: a stream's payload may itself be a container (the codec
stores each species' guarantee artifact that way), and the framing overhead
of every level is measurable, so "metadata bytes" in the breakdown is a
real number rather than a ``8*S + 64`` guess.

Five versions share this byte layout; the version field declares the
*schema of the stream set* so readers pick the right interpretation:

* version 1 — the original GBATC layout: one nested ``guarantee<s>``
  container per species;
* version 2 — the selective-decode layout: a single combined ``guarantee``
  stream (CSR-of-CSR directory over species; see ``repro_torch.codec``) whose
  per-species byte extents are addressable from the directory alone;
* version 3 — the time-sharded layout: v2's guarantee stream plus a
  segmented ``latent`` stream — the time axis partitioned into block-row
  shards, each an independently decodable Huffman chain under one shared
  codebook, fronted by a byte-extent directory — so a time-window decode
  entropy-decodes only the shards covering the window;
* version 4 — the integrity layout: v3's stream set plus an ``integrity``
  stream of CRC32 digests — one per sibling stream, plus fine-grained
  digests matching the random-access units (one per latent shard, one per
  species' guarantee byte-extent), plus a digest of this outer header —
  so a decoder verifies exactly the bytes it reads and no more (see
  ``repro_torch.codec.format`` for the wire layout);
* version 5 — the encoder-family layout: v4's stream set, with the
  ``meta`` stream prefixed by a one-byte family tag (see
  ``repro_torch.codec.families``) selecting which encoder family's decoder the
  remaining meta bytes configure. Below v5 the family is implicitly the
  conv block autoencoder; a conv-family v5 blob's payload streams are
  byte-identical to the v4 encoding of the same fit apart from that tag.

:class:`ContainerReader` accepts all five and exposes ``.version``;
anything else raises :class:`ContainerFormatError`.
"""

from __future__ import annotations

import struct

MAGIC = b"GBTC"
FORMAT_VERSION = 1
FORMAT_VERSION_SELECTIVE = 2
FORMAT_VERSION_SHARDED = 3
FORMAT_VERSION_INTEGRITY = 4
FORMAT_VERSION_FAMILY = 5
SUPPORTED_VERSIONS = (
    FORMAT_VERSION, FORMAT_VERSION_SELECTIVE, FORMAT_VERSION_SHARDED,
    FORMAT_VERSION_INTEGRITY, FORMAT_VERSION_FAMILY,
)

_HEAD = struct.Struct("<4sHH")  # magic, version, n_streams
_LEN = struct.Struct("<Q")

_MAX_NAME = 255


class ContainerFormatError(ValueError):
    """Raised when a blob is not a well-formed container of a known version.

    Carries structured context alongside the message, so salvage decode
    and tests consume the same facts the message states:

    * ``stream`` — name of the stream the failure was localized to
      (``None`` when the outer framing itself is at fault);
    * ``offset`` — byte offset of the failing region *within that
      stream's payload* (blob-absolute when ``stream`` is ``None``), or
      ``None`` when the failure has no single position;
    * ``unit`` — random-access unit index inside the stream (latent
      shard index, species index), or ``None``.
    """

    def __init__(self, message: str, *, stream: "str | None" = None,
                 offset: "int | None" = None, unit: "int | None" = None):
        super().__init__(message)
        self.stream = stream
        self.offset = offset
        self.unit = unit


class ContainerWriter:
    """Accumulates named streams; ``to_bytes`` emits header + table + payloads."""

    def __init__(self, version: int = FORMAT_VERSION):
        self.version = version
        self._streams: list[tuple[str, bytes]] = []

    def add(self, name: str, payload: bytes) -> None:
        if any(n == name for n, _ in self._streams):
            raise ValueError(f"duplicate stream name {name!r}")
        encoded = name.encode("ascii")
        if not 0 < len(encoded) <= _MAX_NAME:
            raise ValueError(f"stream name {name!r} must be 1..{_MAX_NAME} ascii bytes")
        self._streams.append((name, bytes(payload)))

    def to_bytes(self) -> bytes:
        head = pack_header(
            self.version, [(n, len(p)) for n, p in self._streams]
        )
        return head + b"".join(payload for _, payload in self._streams)


def pack_header(version: int, entries: "list[tuple[str, int]]") -> bytes:
    """The exact header + stream-table bytes :class:`ContainerWriter`
    emits for ``entries`` of (name, payload length) — exposed so the v4
    integrity stream can digest the outer framing it will be framed by
    (the table depends on the integrity payload's *length* only, which is
    computable before its content)."""
    parts = [_HEAD.pack(MAGIC, version, len(entries))]
    for name, length in entries:
        encoded = name.encode("ascii")
        parts.append(struct.pack("<B", len(encoded)))
        parts.append(encoded)
        parts.append(_LEN.pack(length))
    return b"".join(parts)


class ContainerReader:
    """Parses and validates a container blob; streams accessed by name."""

    def __init__(self, blob: bytes):
        blob = bytes(blob)
        if len(blob) < _HEAD.size:
            raise ContainerFormatError(
                f"truncated container: {len(blob)} bytes, header needs {_HEAD.size}",
                offset=0,
            )
        magic, version, n_streams = _HEAD.unpack_from(blob, 0)
        if magic != MAGIC:
            raise ContainerFormatError(
                f"bad magic {magic!r} (expected {MAGIC!r})", offset=0
            )
        if version not in SUPPORTED_VERSIONS:
            raise ContainerFormatError(
                f"unsupported container version {version} "
                f"(this reader speaks versions {SUPPORTED_VERSIONS})",
                offset=4,
            )
        off = _HEAD.size
        names: list[str] = []
        lengths: list[int] = []
        for _ in range(n_streams):
            if off + 1 > len(blob):
                raise ContainerFormatError("truncated stream table", offset=off)
            (name_len,) = struct.unpack_from("<B", blob, off)
            off += 1
            if off + name_len + _LEN.size > len(blob):
                raise ContainerFormatError("truncated stream table", offset=off)
            try:
                name = blob[off : off + name_len].decode("ascii")
            except UnicodeDecodeError as e:
                raise ContainerFormatError(
                    "non-ascii stream name", offset=off
                ) from e
            off += name_len
            (length,) = _LEN.unpack_from(blob, off)
            off += _LEN.size
            if name in names:
                raise ContainerFormatError(
                    f"duplicate stream name {name!r}", offset=off
                )
            names.append(name)
            lengths.append(length)
        header_end = off
        expected = header_end + sum(lengths)
        if len(blob) != expected:
            kind = "truncated" if len(blob) < expected else "trailing bytes in"
            raise ContainerFormatError(
                f"{kind} container: stream table declares {expected} bytes, "
                f"blob has {len(blob)}",
                offset=min(expected, len(blob)),
            )
        self.version = version
        self.header_bytes = header_end
        self._blob = blob
        self._offsets: dict[str, tuple[int, int]] = {}
        for name, length in zip(names, lengths):
            self._offsets[name] = (off, length)
            off += length
        self.names = names

    def __contains__(self, name: str) -> bool:
        return name in self._offsets

    def __getitem__(self, name: str) -> bytes:
        try:
            off, length = self._offsets[name]
        except KeyError:
            raise ContainerFormatError(
                f"missing stream {name!r}", stream=name
            ) from None
        return self._blob[off : off + length]

    def stream_extent(self, name: str) -> tuple[int, int]:
        """Blob-absolute ``[lo, hi)`` byte extent of one stream's payload
        (the fault-injection harness addresses corruption through this)."""
        try:
            off, length = self._offsets[name]
        except KeyError:
            raise ContainerFormatError(
                f"missing stream {name!r}", stream=name
            ) from None
        return off, off + length

    def get(self, name: str, default: bytes | None = None) -> bytes | None:
        return self[name] if name in self._offsets else default

    def stream_sizes(self) -> dict[str, int]:
        """Name -> payload length, from the stream table (measured, not estimated)."""
        return {name: length for name, (_, length) in self._offsets.items()}

    @property
    def total_bytes(self) -> int:
        return len(self._blob)
