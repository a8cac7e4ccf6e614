"""Deterministic fault injection for container blobs.

The v4 integrity contract — *detected or harmless, never a silent wrong
decode* — is only worth shipping if it is exercised by corruption the
codec did not choose. This module is that adversary: it maps a blob into
addressable :class:`Region`\\ s (the outer header, every stream, and on
v2+/v3+ the fine-grained random-access units the digests cover — each
latent shard's chain, each species' guarantee extent, the directory
heads) and mutates them with seeded, reproducible faults.

Every injector is pure: it returns a **new** blob plus a :class:`Fault`
record naming exactly what it did (kind, region, byte/bit), so a failing
sweep case replays from its seed alone. The harness addresses corruption
the same way the decoder reports it (``stream``/``unit``), which lets
property tests assert not just *that* corruption was detected but that
the error indicts the right unit.

Usage::

    regions = blob_regions(blob)
    inj = FaultInjector(seed=0)
    bad, fault = inj.flip_bit(blob, regions[3])
    # ... assert decompress(bad) raises naming fault.stream/fault.unit,
    #     or decodes bitwise-equal to clean (header padding etc.)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.analysis.wire_schema import GUARANTEE_PARTS, RegionKind
from repro_torch.codec import format as wire
from repro_torch.core import container as container_format
from repro_torch.core.container import ContainerReader


@dataclasses.dataclass(frozen=True)
class Region:
    """A blob-absolute half-open byte extent ``[lo, hi)`` a fault can
    target, labeled with the decoder's own vocabulary: ``stream`` and
    ``unit`` match the :class:`~repro_torch.core.container.ContainerFormatError`
    fields a decode of the corrupted region should carry."""

    label: str
    lo: int
    hi: int
    stream: Optional[str] = None
    unit: Optional[int] = None

    def __len__(self) -> int:
        return self.hi - self.lo


@dataclasses.dataclass(frozen=True)
class Fault:
    """One injected corruption: which region, what was done, where."""

    kind: str          # "flip_bit" | "zero_run" | "splice" | "truncate"
    region: Region
    offset: int        # blob-absolute byte offset of the mutation start
    detail: str        # human-readable specifics (bit index, run length…)


def blob_regions(blob: bytes, *, fine: bool = True) -> list:
    """Map a container blob into fault-addressable :class:`Region`\\ s.

    Always includes the outer header (magic + version + stream table) and
    one region per stream payload. With ``fine=True`` (default), streams
    with internal random-access structure are additionally split into the
    units the v4 digests cover:

    * ``meta`` (v5+): the one-byte encoder-family tag prefixing the
      stream (a flipped tag must fail as provable meta corruption, never
      decode through the wrong family);
    * ``latent`` (v3+): the head (framing + codebook + shard table) and
      each shard's chain payload (``unit=k``);
    * ``guarantee`` (v2+): the species directory and each species' spans
      (coeff+index+basis, as one region per contiguous span, ``unit=s``).

    The coarse whole-stream regions are kept alongside the fine ones, so
    a sweep can target either granularity.
    """
    blob = bytes(blob)
    r = ContainerReader(blob)
    regions = [Region(RegionKind.HEADER.label(), 0, r.header_bytes)]
    for name in r.names:
        lo, hi = r.stream_extent(name)
        regions.append(
            Region(RegionKind.STREAM.label(name=name), lo, hi, stream=name)
        )
    if not fine:
        return regions
    if r.version >= container_format.FORMAT_VERSION_FAMILY:
        lo, _ = r.stream_extent("meta")
        regions.append(Region(
            RegionKind.META_FAMILY.label(), lo, lo + wire._META_FAMILY.size,
            stream="meta",
        ))
    if r.version >= container_format.FORMAT_VERSION_SHARDED:
        lo, _ = r.stream_extent("latent")
        d = wire.LatentShardDirectory(r["latent"])
        regions.append(Region(
            RegionKind.LATENT_HEAD.label(), lo, lo + d.header_bytes,
            stream="latent",
        ))
        for k in range(d.n_shards):
            slo, shi = d.shard_extent(k)
            regions.append(Region(
                RegionKind.LATENT_SHARD.label(unit=k), lo + slo, lo + shi,
                stream="latent", unit=k,
            ))
    if r.version >= container_format.FORMAT_VERSION_SELECTIVE:
        lo, _ = r.stream_extent("guarantee")
        g = wire.GuaranteeDirectory(r["guarantee"])
        regions.append(Region(
            RegionKind.GUARANTEE_DIR.label(), lo, lo + g.dir_bytes,
            stream="guarantee",
        ))
        for s in range(g.n_species):
            for part, (plo, phi) in zip(
                GUARANTEE_PARTS, g.species_spans(s)
            ):
                regions.append(Region(
                    RegionKind.GUARANTEE_SPECIES_PART.label(unit=s, part=part),
                    lo + plo, lo + phi,
                    stream="guarantee", unit=s,
                ))
    return [reg for reg in regions if len(reg) > 0]


class FaultInjector:
    """Seeded source of reproducible blob corruptions.

    All mutation draws come from one ``numpy`` generator, so a sweep's
    entire fault sequence replays from ``seed`` alone; every injector
    returns ``(mutated_blob, fault_record)`` and never touches its input.
    """

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)

    def _offset(self, region: Region) -> int:
        return int(self._rng.integers(region.lo, region.hi))

    def flip_bit(self, blob: bytes, region: Region,
                 offset: Optional[int] = None,
                 bit: Optional[int] = None) -> tuple:
        """XOR one bit inside ``region`` (random byte/bit unless given)."""
        buf = bytearray(blob)
        off = self._offset(region) if offset is None else int(offset)
        b = int(self._rng.integers(0, 8)) if bit is None else int(bit)
        buf[off] ^= 1 << b
        return bytes(buf), Fault(
            "flip_bit", region, off, f"bit {b} of byte {off}"
        )

    def zero_run(self, blob: bytes, region: Region,
                 length: int = 8) -> tuple:
        """Overwrite a run of ``length`` bytes in ``region`` with zeros
        (clipped to the region; a no-op run re-rolls is NOT attempted —
        zeroing already-zero bytes is a legitimately harmless fault)."""
        buf = bytearray(blob)
        off = self._offset(region)
        hi = min(off + max(1, int(length)), region.hi)
        buf[off:hi] = bytes(hi - off)
        return bytes(buf), Fault(
            "zero_run", region, off, f"{hi - off} bytes zeroed at {off}"
        )

    def splice(self, blob: bytes, dst: Region, src: Region) -> tuple:
        """Copy ``src``'s leading bytes over ``dst``'s (clipped to the
        shorter) — models a mis-seeked read stitching valid-looking bytes
        from the wrong unit, the corruption CRCs exist to catch and
        length checks cannot."""
        buf = bytearray(blob)
        n = min(len(dst), len(src))
        buf[dst.lo : dst.lo + n] = blob[src.lo : src.lo + n]
        return bytes(buf), Fault(
            "splice", dst, dst.lo, f"{n} bytes from {src.label} ({src.lo})"
        )

    def truncate(self, blob: bytes, n: Optional[int] = None) -> tuple:
        """Drop the last ``n`` bytes (random ``1..len//4`` if omitted) —
        the torn-write / short-read case the atomic file path prevents
        and the structural parse must still catch when handed one."""
        if n is None:
            n = int(self._rng.integers(1, max(2, len(blob) // 4)))
        n = max(1, min(int(n), len(blob) - 1))
        whole = Region(RegionKind.BLOB.label(), 0, len(blob))
        return bytes(blob[:-n]), Fault(
            "truncate", whole, len(blob) - n, f"last {n} bytes dropped"
        )
