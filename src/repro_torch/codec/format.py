"""GBATC container schemas: the wire layout layer of :mod:`repro_torch.codec`.

Everything byte-layout lives here — the fixed ``meta`` struct, the
combined (container v2+) ``guarantee`` stream's CSR-of-CSR directory, the
time-sharded (container v3) ``latent`` stream, and the measured byte
accounting (:func:`stream_breakdown`). No model state, no torch: parsing a
directory slices bytes and validates framing, nothing more, which is what
lets the runtime/partial layers address any species or time shard without
touching sibling payloads.

Container v3's ``latent`` stream::

    magic "LAT3" | n_shards u32 | shard_rows u32 | n_rows u64 | n_cols u32
    codebook: k u32 | symbols k x i64 | code lengths k x u1
    shard table: n_shards x payload_len u64
    shard payloads, concatenated

The time axis is partitioned into fixed block-row shards (``shard_rows``
rows each, ragged tail allowed); every shard payload is an independently
decodable Huffman chain over ``rows * n_cols`` quantized latents under
the ONE shared codebook stored in the stream head — mirroring the
guarantee directory, every shard's byte extent follows from the table by
prefix sums, so a time-window decode entropy-decodes only the shards
covering the window (the O(window) latent path).

Container v4's ``integrity`` stream (appended to the v3 stream set)::

    magic "ITG1" | n_streams u16
    per sibling stream, table order: name_len u8 | name (ascii) | crc u32
    latent units:    head_len u32 | head_crc u32 | n_shards  u32 | n_shards  x crc u32
    guarantee units: dir_len  u32 | dir_crc  u32 | n_species u32 | n_species x crc u32
    outer_crc u32
    self_crc  u32

All digests are CRC32 (which detects *every* single-bit flip within a
region). The whole-stream digests cover each sibling stream's full
payload; the unit digests match the random-access units — the latent
stream's head region (framing + codebook + shard table, whose length is
stored explicitly so verification never depends on possibly-corrupt
framing), each shard's chain payload, the guarantee stream's directory
region, and each species' byte extent (its coeff/index/basis payloads,
CRC-chained in that order) — so :class:`~repro_torch.codec.PartialDecoder`
verifies exactly the bytes a selection reads and no more. ``outer_crc``
digests the *outer* container header + stream table (computable before
the integrity payload exists because the table stores only this stream's
length); ``self_crc`` digests every preceding integrity byte, so a flip
inside the integrity stream itself is detected rather than mistaken for
payload corruption.
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from repro_torch.codec import families
from repro_torch.core import blocking, entropy
from repro_torch.core import container as container_format
from repro_torch.core.container import ContainerFormatError, ContainerReader

_FLAG_CORRECTION = 1

# flags, param_dtype_bytes, latent, bt, ph, pw, n_arch
_META_HEAD = struct.Struct("<BBHHHHH")
_META_SHAPE = struct.Struct("<IIIId")  # S, T, H, W, latent_bin
# container v5 prefixes the legacy meta body with ONE family-tag byte
# (see repro_torch.codec.families); a conv-family v5 meta body is therefore
# byte-identical to the v4 meta of the same fit
_META_FAMILY = struct.Struct("<B")


def expected_stream_set(version: int, n_species: int,
                        has_correction: bool) -> frozenset:
    """The exact stream-name set a well-formed container of *version*
    carries. Strictness contract: every stream must be accounted
    for by purpose — decode rejects blobs with stray or absent streams."""
    names = {"meta", "latent", "decoder"}
    if has_correction:
        names.add("correction")
    if version >= container_format.FORMAT_VERSION_SELECTIVE:
        names.add("guarantee")
    else:
        names.update(f"guarantee{sidx}" for sidx in range(n_species))
    if version >= container_format.FORMAT_VERSION_INTEGRITY:
        names.add("integrity")
    return frozenset(names)


# ---------------------------------------------------------------------------
# meta stream
# ---------------------------------------------------------------------------
def _pack_meta(artifact, version: int = container_format.FORMAT_VERSION
               ) -> bytes:
    scfg = families.structural(artifact.cfg)
    fam = families.get(scfg.family)
    geom = scfg.geometry
    if (version < container_format.FORMAT_VERSION_FAMILY
            and fam.name != "conv"):
        raise ValueError(
            f"container v{version} predates encoder families: only the "
            f"conv family is representable (artifact is {fam.name!r}; "
            f"use version {container_format.FORMAT_VERSION_FAMILY}+)"
        )
    flags = _FLAG_CORRECTION if artifact.corr_params is not None else 0
    u16_fields = {
        "latent": scfg.latent,
        "bt": geom.bt,
        "ph": geom.ph,
        "pw": geom.pw,
        **{f"arch[{i}]": c for i, c in enumerate(scfg.arch)},
    }
    bad = {k: v for k, v in u16_fields.items() if not 0 < v <= 0xFFFF}
    if bad:
        raise ValueError(f"meta fields not representable as u16: {bad}")
    parts = []
    if version >= container_format.FORMAT_VERSION_FAMILY:
        parts.append(_META_FAMILY.pack(fam.tag))
    parts += [
        _META_HEAD.pack(
            flags,
            scfg.param_dtype_bytes,
            scfg.latent,
            geom.bt,
            geom.ph,
            geom.pw,
            len(scfg.arch),
        ),
        np.asarray(scfg.arch, dtype="<u2").tobytes(),
        _META_SHAPE.pack(*artifact.shape, artifact.latent_bin),
        np.ascontiguousarray(artifact.norm_min.astype("<f4")).tobytes(),
        np.ascontiguousarray(artifact.norm_range.astype("<f4")).tobytes(),
    ]
    return b"".join(parts)


def _unpack_meta(buf: bytes,
                 version: int = container_format.FORMAT_VERSION):
    base = 0
    fam = families.CONV  # below v5 the family is implicit
    if version >= container_format.FORMAT_VERSION_FAMILY:
        if len(buf) < _META_FAMILY.size:
            raise ContainerFormatError("meta stream truncated", stream="meta")
        (tag,) = _META_FAMILY.unpack_from(buf, 0)
        fam = families.by_tag(tag)
        if fam is None:
            raise ContainerFormatError(
                f"unknown encoder family tag {tag} "
                f"(registered: {families.registered()})",
                stream="meta", offset=0,
            )
        base = _META_FAMILY.size
    if len(buf) < base + _META_HEAD.size:
        raise ContainerFormatError("meta stream truncated", stream="meta")
    flags, pdb, latent, bt, ph, pw, n_arch = _META_HEAD.unpack_from(buf, base)
    if flags & ~_FLAG_CORRECTION:
        # unknown flag bits mean a newer writer (or corruption) — refuse
        # rather than decode under old-flag semantics
        raise ContainerFormatError(
            f"unknown meta flags 0x{flags:02x}", stream="meta", offset=base
        )
    off = base + _META_HEAD.size
    if len(buf) < off + 2 * n_arch + _META_SHAPE.size:
        raise ContainerFormatError("meta stream truncated", stream="meta")
    arch = tuple(
        int(c) for c in np.frombuffer(buf, dtype="<u2", count=n_arch, offset=off)
    )
    off += 2 * n_arch
    s, t, h, w, latent_bin = _META_SHAPE.unpack_from(buf, off)
    off += _META_SHAPE.size
    if len(buf) != off + 8 * s:
        raise ContainerFormatError(
            f"meta stream is {len(buf)} bytes, expected {off + 8 * s} "
            f"for {s} species",
            stream="meta",
        )
    if pdb not in (2, 4):
        raise ContainerFormatError(
            f"bad param dtype byte {pdb} (expected 2 or 4)", stream="meta"
        )
    if min(bt, ph, pw, latent, n_arch, s, t, h, w) < 1 or min(arch) < 1:
        raise ContainerFormatError(
            f"meta stream carries degenerate structure: geometry "
            f"({bt},{ph},{pw}), latent {latent}, arch {arch}, shape "
            f"({s},{t},{h},{w})",
            stream="meta",
        )
    arch_err = fam.validate_arch(arch)
    if arch_err:
        raise ContainerFormatError(
            f"meta stream carries bad {fam.name} arch: {arch_err}",
            stream="meta",
        )
    norm_min = np.frombuffer(buf, dtype="<f4", count=s, offset=off).copy()
    norm_range = np.frombuffer(buf, dtype="<f4", count=s, offset=off + 4 * s).copy()
    if not (np.isfinite(latent_bin) and latent_bin > 0):
        raise ContainerFormatError(
            f"bad latent bin {latent_bin!r}", stream="meta"
        )
    if not (
        np.isfinite(norm_min).all()
        and np.isfinite(norm_range).all()
        and (norm_range > 0).all()
    ):
        raise ContainerFormatError(
            "non-finite or non-positive normalization", stream="meta"
        )
    cfg = families.StructuralConfig(
        family=fam.name,
        geometry=blocking.BlockGeometry(bt=bt, ph=ph, pw=pw),
        latent=latent,
        arch=arch,
        use_correction=bool(flags & _FLAG_CORRECTION),
        param_dtype_bytes=pdb,
    )
    return cfg, (s, t, h, w), float(latent_bin), norm_min, norm_range


# ---------------------------------------------------------------------------
# combined guarantee stream (container v2+): CSR-of-CSR over species
# ---------------------------------------------------------------------------
_GDIR_HEAD = struct.Struct("<I")  # species count
# per species: tau f64, coeff_bin f64, D u32, n_store u32,
#              coeff_len u64, index_len u64, basis_len u64
_GDIR_REC = struct.Struct("<ddIIQQQ")


def pack_guarantee_stream(arts) -> bytes:
    """Pack all species' guarantee artifacts into ONE combined stream.

    Layout: ``S u32 | S x directory record | coeff payloads | index
    payloads | basis payloads`` — the outer offset table (directory) over
    species plus type-grouped sub-streams. Per-species framing collapses
    from a nested container (~60 bytes of magic/table per species) to one
    fixed 48-byte record, and every species' byte extents follow from the
    directory by prefix sums, so a reader can slice one species without
    parsing any sibling payload.
    """
    parts = [_GDIR_HEAD.pack(len(arts))]
    coeffs: list[bytes] = []
    indexes: list[bytes] = []
    bases: list[bytes] = []
    for g in arts:
        c, i, b = g.wire_parts()
        parts.append(
            _GDIR_REC.pack(g.tau, g.coeff_bin, *g.basis.shape,
                           len(c), len(i), len(b))
        )
        coeffs.append(c)
        indexes.append(i)
        bases.append(b)
    return b"".join(parts + coeffs + indexes + bases)


class GuaranteeDirectory:
    """Parsed directory of a combined ``guarantee`` stream (container v2+).

    Holds the per-species metadata and byte extents; payload access is
    pure slicing — no sibling species' stream is ever parsed to reach
    another's. Raises :class:`ContainerFormatError` when the directory
    and the payload bytes disagree.
    """

    def __init__(self, payload: bytes):
        payload = bytes(payload)
        if len(payload) < _GDIR_HEAD.size:
            raise ContainerFormatError(
                "guarantee stream truncated: no species directory",
                stream="guarantee", offset=0,
            )
        (s,) = _GDIR_HEAD.unpack_from(payload, 0)
        dir_end = _GDIR_HEAD.size + s * _GDIR_REC.size
        if len(payload) < dir_end:
            raise ContainerFormatError(
                f"guarantee directory truncated: {len(payload)} bytes "
                f"cannot hold {s} species records",
                stream="guarantee", offset=0,
            )
        recs = list(_GDIR_REC.iter_unpack(payload[_GDIR_HEAD.size:dir_end]))
        self._meta = [(r[0], r[1], r[2], r[3]) for r in recs]
        coeff_lens = [r[4] for r in recs]
        index_lens = [r[5] for r in recs]
        basis_lens = [r[6] for r in recs]
        # per-type payload offsets by prefix sum (python ints: a corrupt
        # u64 length must overflow into a clean mismatch, not wrap)
        off = dir_end
        self._extents: list[list[tuple[int, int]]] = []
        for lens in (coeff_lens, index_lens, basis_lens):
            spans = []
            for ln in lens:
                spans.append((off, off + ln))
                off += ln
            self._extents.append(spans)
        if off != len(payload):
            raise ContainerFormatError(
                f"guarantee stream is {len(payload)} bytes but its "
                f"directory declares {off}",
                stream="guarantee", offset=min(off, len(payload)),
            )
        self.dir_bytes = dir_end
        self.coeff_total = sum(coeff_lens)
        self.index_total = sum(index_lens)
        self.basis_total = sum(basis_lens)
        self._payload = payload

    @property
    def n_species(self) -> int:
        return len(self._meta)

    def _slice(self, kind: int, sidx: int) -> bytes:
        lo, hi = self._extents[kind][sidx]
        return self._payload[lo:hi]

    def coeff_stream(self, sidx: int) -> bytes:
        return self._slice(0, sidx)

    def coeff_len(self, sidx: int) -> int:
        lo, hi = self._extents[0][sidx]
        return hi - lo

    def species_parts(self, sidx: int):
        """(tau, coeff_bin, d, n_store, coeff, index, basis) for one species."""
        return (*self._meta[sidx], self._slice(0, sidx),
                self._slice(1, sidx), self._slice(2, sidx))

    def species_extent_bytes(self, sidx: int) -> int:
        """Payload bytes one species' decode touches (coeff+index+basis)."""
        return sum(hi - lo for lo, hi in
                   (self._extents[k][sidx] for k in range(3)))

    def species_spans(self, sidx: int) -> tuple[tuple[int, int], ...]:
        """Payload-relative (lo, hi) byte spans of one species' coeff,
        index, and basis payloads — the unit a v4 species digest covers
        (CRC-chained in this order) and the fault harness addresses."""
        return tuple(self._extents[k][sidx] for k in range(3))


# ---------------------------------------------------------------------------
# time-sharded latent stream (container v3)
# ---------------------------------------------------------------------------
_LAT3_MAGIC = b"LAT3"
_LAT3_HEAD = struct.Struct("<4sIIQI")  # magic, n_shards, shard_rows, n_rows, n_cols
_LAT3_CB = struct.Struct("<I")  # codebook symbol count
_LAT3_LEN = struct.Struct("<Q")  # per-shard payload byte length

#: default shard granularity: one time block-group (``bt`` frames) per
#: shard — the finest window a block-row decode can address anyway; the
#: per-shard cost is one u64 table entry plus sub-byte chain padding.
DEFAULT_SHARD_TGROUPS = 1

_POOL: Optional[ThreadPoolExecutor] = None


def _pool() -> ThreadPoolExecutor:
    """Shared workers for per-shard entropy packing (numpy releases the
    GIL on the vectorized pack passes, so shards genuinely overlap)."""
    global _POOL
    if _POOL is None:
        _POOL = ThreadPoolExecutor(max_workers=min(os.cpu_count() or 1, 8))
    return _POOL


def pack_latent_stream(
    latent_q, shard_rows: int, *, parallel: Optional[bool] = None
) -> bytes:
    """Pack quantized latents as the v3 time-sharded segmented stream.

    One canonical codebook is built over ALL latents and stored once;
    each shard of ``shard_rows`` block rows (ragged tail allowed) packs
    its own independent Huffman chain under it, so any shard decodes
    without touching the others. Shard chains are independent by
    construction, so they encode in parallel on the shared worker pool
    (``parallel=None`` decides by size; the output bytes are identical
    either way — each shard's payload is a pure function of its rows).

    ``latent_q`` is one (NB, latent) array, or — from a sharded fit — a
    *sequence of per-shard row blocks* sharing the column count. The
    parts path never concatenates the full matrix on host: the codebook
    merges per-part symbol counts (:func:`entropy.huffman_codebook_parts`)
    and each Huffman chain assembles only its own shard's rows, so the
    emitted bytes are identical to packing the concatenated array.
    """
    if hasattr(latent_q, "ndim"):  # one (NB, latent) array (np or device)
        latent_q = np.ascontiguousarray(np.asarray(latent_q, dtype=np.int64))
        if latent_q.ndim != 2 or latent_q.size == 0:
            raise ValueError(
                f"latent_q must be a non-empty (NB, latent) array, "
                f"got shape {latent_q.shape}"
            )
        parts = [latent_q]
    else:
        parts = [np.ascontiguousarray(np.asarray(p, dtype=np.int64))
                 for p in latent_q]
        if not parts or any(p.ndim != 2 or p.shape[0] == 0 for p in parts):
            raise ValueError(
                "latent_q parts must be non-empty 2-D row blocks, got "
                f"shapes {[getattr(p, 'shape', None) for p in parts]}"
            )
        if len({p.shape[1] for p in parts}) != 1:
            raise ValueError(
                "latent_q parts disagree on the latent width: "
                f"{sorted({p.shape[1] for p in parts})}"
            )
    bounds = []
    row = 0
    for p in parts:
        bounds.append((row, row + p.shape[0]))
        row += p.shape[0]
    nb, n_cols = row, parts[0].shape[1]
    if nb == 0 or n_cols == 0:
        raise ValueError("latent_q must cover at least one row and column")
    shard_rows = int(min(max(int(shard_rows), 1), nb))
    if len(parts) == 1:
        symbols, lengths = entropy.huffman_codebook(parts[0])
    else:
        symbols, lengths = entropy.huffman_codebook_parts(parts)
    # canonical codes are shard-invariant: build the (python-loop) table
    # once here rather than once per shard inside the workers
    codes = entropy._canonical_codes(lengths)
    extents = [(r0, min(r0 + shard_rows, nb))
               for r0 in range(0, nb, shard_rows)]

    def rows_for(ext):
        r0, r1 = ext
        picked = [
            p[max(r0, p0) - p0:min(r1, p1) - p0]
            for (p0, p1), p in zip(bounds, parts)
            if max(r0, p0) < min(r1, p1)
        ]
        # O(shard) concat only when a chain crosses a part boundary
        return picked[0] if len(picked) == 1 else np.concatenate(picked)

    def pack(ext):
        return entropy.huffman_payload(rows_for(ext), symbols, lengths, codes)

    total_size = nb * n_cols
    if parallel is None:
        parallel = len(extents) > 1 and total_size >= (1 << 15)
    if parallel and len(extents) > 1:
        payloads = list(_pool().map(pack, extents))
    else:
        payloads = [pack(e) for e in extents]
    parts = [
        _LAT3_HEAD.pack(_LAT3_MAGIC, len(extents), shard_rows, nb, n_cols),
        _LAT3_CB.pack(len(symbols)),
        symbols.astype("<i8").tobytes(),
        lengths.astype("<u1").tobytes(),
    ]
    parts.extend(_LAT3_LEN.pack(len(p)) for p in payloads)
    return b"".join(parts + payloads)


class LatentShardDirectory:
    """Parsed head of a v3 ``latent`` stream: codebook + shard extents.

    Parsing touches only the fixed head — no entropy decode happens here;
    shard payload access is pure slicing, and which shards a block-row
    window needs is arithmetic on the directory alone.
    """

    def __init__(self, payload: bytes):
        payload = bytes(payload)
        if len(payload) < _LAT3_HEAD.size + _LAT3_CB.size:
            raise ContainerFormatError(
                "latent shard stream truncated", stream="latent", offset=0
            )
        magic, n_shards, shard_rows, n_rows, n_cols = \
            _LAT3_HEAD.unpack_from(payload, 0)
        if magic != _LAT3_MAGIC:
            raise ContainerFormatError(
                f"bad latent shard magic {magic!r} (expected {_LAT3_MAGIC!r})",
                stream="latent", offset=0,
            )
        if min(n_shards, shard_rows, n_rows, n_cols) < 1:
            raise ContainerFormatError(
                f"degenerate latent shard geometry: {n_shards} shards of "
                f"{shard_rows} rows for ({n_rows}, {n_cols}) latents",
                stream="latent", offset=0,
            )
        if n_shards != -(-n_rows // shard_rows):
            raise ContainerFormatError(
                f"latent shard directory declares {n_shards} shards but "
                f"{n_rows} rows / {shard_rows} per shard needs "
                f"{-(-n_rows // shard_rows)}",
                stream="latent", offset=0,
            )
        off = _LAT3_HEAD.size
        (k,) = _LAT3_CB.unpack_from(payload, off)
        off += _LAT3_CB.size
        table_end = off + 9 * k + _LAT3_LEN.size * n_shards
        if k < 1 or len(payload) < table_end:
            raise ContainerFormatError(
                f"latent shard stream truncated: {len(payload)} bytes "
                f"cannot hold a {k}-symbol codebook + {n_shards} records",
                stream="latent", offset=0,
            )
        self.symbols = np.frombuffer(
            payload, dtype="<i8", count=k, offset=off
        ).astype(np.int64)
        off += 8 * k
        self.lengths = np.frombuffer(
            payload, dtype="<u1", count=k, offset=off
        ).astype(np.int64)
        off += k
        if not ((self.lengths >= 1) & (self.lengths <= 32)).all():
            raise ContainerFormatError(
                "latent codebook carries bad code lengths",
                stream="latent", offset=0,
            )
        lens = [
            _LAT3_LEN.unpack_from(payload, off + i * _LAT3_LEN.size)[0]
            for i in range(n_shards)
        ]
        off += _LAT3_LEN.size * n_shards
        self.header_bytes = off  # framing + codebook + shard table
        self._extents: list[tuple[int, int]] = []
        for ln in lens:  # python ints: corrupt u64 must mismatch, not wrap
            self._extents.append((off, off + ln))
            off += ln
        if off != len(payload):
            raise ContainerFormatError(
                f"latent shard stream is {len(payload)} bytes but its "
                f"directory declares {off}",
                stream="latent", offset=min(off, len(payload)),
            )
        self.n_shards = n_shards
        self.shard_rows = shard_rows
        self.n_rows = n_rows
        self.n_cols = n_cols
        self.payload_total = sum(lens)
        self._payload = payload

    def shard_payload(self, k: int) -> bytes:
        lo, hi = self._extents[k]
        return self._payload[lo:hi]

    def shard_payload_len(self, k: int) -> int:
        lo, hi = self._extents[k]
        return hi - lo

    def shard_extent(self, k: int) -> tuple[int, int]:
        """Payload-relative (lo, hi) byte span of shard ``k``'s chain —
        the unit a v4 shard digest covers and the fault harness addresses."""
        return self._extents[k]

    def shard_row_extent(self, k: int) -> tuple[int, int]:
        r0 = k * self.shard_rows
        return r0, min(r0 + self.shard_rows, self.n_rows)

    def shard_count(self, k: int) -> int:
        r0, r1 = self.shard_row_extent(k)
        return (r1 - r0) * self.n_cols

    def shards_for_rows(self, b0: int, b1: int) -> tuple[int, int]:
        """Half-open shard range covering block rows ``[b0, b1)``."""
        if not 0 <= b0 < b1 <= self.n_rows:
            raise ValueError(
                f"block-row window ({b0}, {b1}) outside [0, {self.n_rows})"
            )
        return b0 // self.shard_rows, -(-b1 // self.shard_rows)

    def window_payload_bytes(self, b0: int, b1: int) -> int:
        """Chain payload bytes a ``[b0, b1)`` row decode entropy-decodes."""
        k0, k1 = self.shards_for_rows(b0, b1)
        return sum(self.shard_payload_len(k) for k in range(k0, k1))


# ---------------------------------------------------------------------------
# integrity stream (container v4): CRC32 digests per stream + per unit
# ---------------------------------------------------------------------------
_ITG_MAGIC = b"ITG1"
_ITG_HEAD = struct.Struct("<4sH")  # magic, n_streams
_ITG_CRC = struct.Struct("<I")
_ITG_UNITS = struct.Struct("<III")  # region_len, region_crc, n_units


def _chained_crc(payload: bytes, spans) -> int:
    """CRC32 chained across (possibly non-contiguous) payload spans."""
    crc = 0
    for lo, hi in spans:
        crc = zlib.crc32(payload[lo:hi], crc)
    return crc


def pack_integrity_stream(streams: "list[tuple[str, bytes]]") -> bytes:
    """Pack the v4 ``integrity`` stream over the sibling ``streams``
    (every (name, payload) pair of the container *except* integrity
    itself, in table order). The ``outer_crc`` field is left zero —
    :func:`finalize_integrity_stream` patches it once the outer header
    is known (the header depends only on this payload's length, which
    the patch preserves)."""
    by_name = dict(streams)
    parts = [_ITG_HEAD.pack(_ITG_MAGIC, len(streams))]
    for name, payload in streams:
        enc = name.encode("ascii")
        parts.append(struct.pack("<B", len(enc)))
        parts.append(enc)
        parts.append(_ITG_CRC.pack(zlib.crc32(payload)))
    lat_payload = by_name["latent"]
    lat = LatentShardDirectory(lat_payload)
    parts.append(_ITG_UNITS.pack(
        lat.header_bytes,
        zlib.crc32(lat_payload[: lat.header_bytes]),
        lat.n_shards,
    ))
    parts.extend(
        _ITG_CRC.pack(zlib.crc32(lat.shard_payload(k)))
        for k in range(lat.n_shards)
    )
    g_payload = by_name["guarantee"]
    gdir = GuaranteeDirectory(g_payload)
    parts.append(_ITG_UNITS.pack(
        gdir.dir_bytes,
        zlib.crc32(g_payload[: gdir.dir_bytes]),
        gdir.n_species,
    ))
    parts.extend(
        _ITG_CRC.pack(_chained_crc(g_payload, gdir.species_spans(sidx)))
        for sidx in range(gdir.n_species)
    )
    parts.append(_ITG_CRC.pack(0))  # outer_crc placeholder
    body = b"".join(parts)
    return body + _ITG_CRC.pack(zlib.crc32(body))


def finalize_integrity_stream(payload: bytes, outer_header: bytes) -> bytes:
    """Patch ``outer_crc`` with the digest of the outer container header
    + stream table, and recompute ``self_crc`` accordingly. Length is
    unchanged, so the header the caller packed stays exact."""
    body = payload[: -2 * _ITG_CRC.size] + _ITG_CRC.pack(
        zlib.crc32(outer_header)
    )
    return body + _ITG_CRC.pack(zlib.crc32(body))


class IntegrityDirectory:
    """Parsed (and self-verified) v4 ``integrity`` stream.

    Construction runs the self-check first — ``self_crc`` over every
    preceding byte — so a flip *inside* the integrity stream is reported
    against the integrity stream itself, never misattributed to a sibling
    payload. All ``verify_*`` methods raise :class:`ContainerFormatError`
    with structured context (stream, offset, unit) on mismatch and are
    no-ops on success.
    """

    def __init__(self, payload: bytes):
        payload = bytes(payload)

        def bad(msg: str, off: int = 0):
            raise ContainerFormatError(msg, stream="integrity", offset=off)

        floor = _ITG_HEAD.size + 2 * _ITG_CRC.size + 2 * _ITG_UNITS.size
        if len(payload) < floor:
            bad(f"integrity stream truncated: {len(payload)} bytes")
        magic, n_streams = _ITG_HEAD.unpack_from(payload, 0)
        if magic != _ITG_MAGIC:
            bad(f"bad integrity magic {magic!r} (expected {_ITG_MAGIC!r})")
        (self_crc,) = _ITG_CRC.unpack_from(payload, len(payload) - _ITG_CRC.size)
        if zlib.crc32(payload[: -_ITG_CRC.size]) != self_crc:
            bad("integrity stream fails its own digest",
                len(payload) - _ITG_CRC.size)
        off = _ITG_HEAD.size
        self.stream_crcs: dict[str, int] = {}
        for _ in range(n_streams):
            if off + 1 > len(payload):
                bad("integrity stream table truncated", off)
            (name_len,) = struct.unpack_from("<B", payload, off)
            off += 1
            if off + name_len + _ITG_CRC.size > len(payload):
                bad("integrity stream table truncated", off)
            name = payload[off : off + name_len].decode("ascii")
            off += name_len
            (crc,) = _ITG_CRC.unpack_from(payload, off)
            off += _ITG_CRC.size
            self.stream_crcs[name] = crc
        if off + 2 * _ITG_UNITS.size + 2 * _ITG_CRC.size > len(payload):
            bad("integrity unit sections truncated", off)
        self.latent_head_len, self.latent_head_crc, n_shards = \
            _ITG_UNITS.unpack_from(payload, off)
        off += _ITG_UNITS.size
        if off + n_shards * _ITG_CRC.size > len(payload):
            bad("integrity shard digests truncated", off)
        self.shard_crcs = [
            _ITG_CRC.unpack_from(payload, off + k * _ITG_CRC.size)[0]
            for k in range(n_shards)
        ]
        off += n_shards * _ITG_CRC.size
        if off + _ITG_UNITS.size > len(payload):
            bad("integrity unit sections truncated", off)
        self.gdir_len, self.gdir_crc, n_species = \
            _ITG_UNITS.unpack_from(payload, off)
        off += _ITG_UNITS.size
        tail = off + n_species * _ITG_CRC.size + 2 * _ITG_CRC.size
        if tail != len(payload):
            bad(f"integrity stream is {len(payload)} bytes but its "
                f"sections declare {tail}", off)
        self.species_crcs = [
            _ITG_CRC.unpack_from(payload, off + s * _ITG_CRC.size)[0]
            for s in range(n_species)
        ]
        off += n_species * _ITG_CRC.size
        (self.outer_crc,) = _ITG_CRC.unpack_from(payload, off)

    def verify_outer(self, blob: bytes, header_bytes: int) -> None:
        """Digest-check the outer container header + stream table."""
        if zlib.crc32(bytes(blob[:header_bytes])) != self.outer_crc:
            raise ContainerFormatError(
                "container header fails its integrity digest", offset=0
            )

    def verify_stream(self, name: str, payload: bytes) -> None:
        """Digest-check one sibling stream's whole payload."""
        want = self.stream_crcs.get(name)
        if want is None:
            raise ContainerFormatError(
                f"integrity stream carries no digest for {name!r}",
                stream="integrity",
            )
        if zlib.crc32(payload) != want:
            raise ContainerFormatError(
                f"stream {name!r} fails its integrity digest",
                stream=name, offset=0,
            )

    def verify_latent_head(self, payload: bytes) -> None:
        """Digest-check the latent stream's head region (framing +
        codebook + shard table) using the *stored* region length, so the
        check never depends on possibly-corrupt framing fields."""
        n = self.latent_head_len
        if n > len(payload) or zlib.crc32(payload[:n]) != self.latent_head_crc:
            raise ContainerFormatError(
                "latent stream head fails its integrity digest",
                stream="latent", offset=0,
            )

    def verify_shard(self, k: int, chain_payload: bytes) -> None:
        """Digest-check one latent shard's chain payload."""
        if not 0 <= k < len(self.shard_crcs):
            raise ContainerFormatError(
                f"integrity stream carries {len(self.shard_crcs)} shard "
                f"digests, shard {k} requested",
                stream="integrity", unit=k,
            )
        if zlib.crc32(chain_payload) != self.shard_crcs[k]:
            raise ContainerFormatError(
                f"latent shard {k}: fails its integrity digest",
                stream="latent", unit=k,
            )

    def verify_gdir(self, payload: bytes) -> None:
        """Digest-check the guarantee stream's directory region using the
        stored region length."""
        n = self.gdir_len
        if n > len(payload) or zlib.crc32(payload[:n]) != self.gdir_crc:
            raise ContainerFormatError(
                "guarantee directory fails its integrity digest",
                stream="guarantee", offset=0,
            )

    def verify_species(self, sidx: int, payload: bytes, spans) -> None:
        """Digest-check one species' guarantee byte extent (its coeff,
        index, and basis spans of the combined stream, CRC-chained)."""
        if not 0 <= sidx < len(self.species_crcs):
            raise ContainerFormatError(
                f"integrity stream carries {len(self.species_crcs)} species "
                f"digests, species {sidx} requested",
                stream="integrity", unit=sidx,
            )
        if _chained_crc(payload, spans) != self.species_crcs[sidx]:
            raise ContainerFormatError(
                f"guarantee stream {sidx}: fails its integrity digest",
                stream="guarantee", unit=sidx,
                offset=spans[0][0] if spans else None,
            )


# ---------------------------------------------------------------------------
# measured byte accounting
# ---------------------------------------------------------------------------
def stream_breakdown(blob: bytes) -> dict:
    """Byte breakdown as a view over the container's measured stream lengths.

    ``latent/decoder/correction/coeff/index/basis`` are payload bytes;
    ``meta`` is everything else that is really on the wire — the outer
    header + stream table, the meta stream, and per-version framing (v1
    nested guarantee containers, the v2+ guarantee directory, the v3
    latent shard head: codebook + shard table, the v4 integrity stream)
    — so the parts always sum to ``len(blob)`` exactly.
    """
    r = ContainerReader(blob)
    sizes = r.stream_sizes()
    coeff = index = basis = 0
    if r.version >= container_format.FORMAT_VERSION_SELECTIVE:
        if "guarantee" in r:
            gdir = GuaranteeDirectory(r["guarantee"])
            coeff, index, basis = (
                gdir.coeff_total, gdir.index_total, gdir.basis_total
            )
    else:
        for name in sizes:
            if name.startswith("guarantee"):
                sub = ContainerReader(r[name]).stream_sizes()
                coeff += sub.get("coeff", 0)
                index += sub.get("index", 0)
                basis += sub.get("basis", 0)
    latent = sizes.get("latent", 0)
    if r.version >= container_format.FORMAT_VERSION_SHARDED and "latent" in r:
        # chain payloads count as latent data; the shard head (codebook +
        # extents table) is framing and lands in the meta bucket below
        latent = LatentShardDirectory(r["latent"]).payload_total
    out = {
        "latent": latent,
        "decoder": sizes.get("decoder", 0),
        "correction": sizes.get("correction", 0),
        "coeff": coeff,
        "index": index,
        "basis": basis,
    }
    out["meta"] = r.total_bytes - sum(out.values())
    out["total"] = r.total_bytes
    return out
