"""Public codec API of the port: GBATC as *bytes in, bytes out*.

:class:`GBATCCodec` wraps the fit/compress orchestration and returns a
**self-describing container blob**; module-level :func:`decompress`
reconstructs the field from the blob alone — no fitted pipeline, no
original data, no config object. The wire format is the reference
package's container, byte for byte, at every version (v1-v5): a blob
written by either package parses under the other. Streams of v5, the
default:

==============  ====================================================
``meta``        one-byte encoder-family tag, geometry, encoder
                structure, shape, latent bin, per-species
                normalization (min/range) — fixed-layout struct
``latent``      time-sharded segmented stream: ONE shared Huffman
                codebook + a byte-extent directory over fixed
                block-row shards, each an independently decodable chain
``decoder``     AE decoder parameters, packed fp32/fp16 little-endian
                in the reference's layouts and sorted-path leaf order
``correction``  tensor-correction network parameters (GBATC only)
``guarantee``   ONE combined CSR-of-CSR stream for all species
``integrity``   CRC32 digests over everything else, self-checked first
==============  ====================================================

Older versions: v4 is v5 without the family tag (conv only); v3 is v4
without the ``integrity`` stream; v2 carries the latent stream as ONE
sequential Huffman chain; v1 carries one nested ``guarantee{s}``
container per species in place of the combined stream. ``encode(artifact,
version=...)`` writes each, :func:`decompress` reads each.

Beyond the full decode: ``decompress(blob, species=..., time_range=...)``
and :class:`PartialDecoder` decode a slice randomly-accessed, bitwise the
slice of the full decode; :func:`verify_blob` digest-checks every byte of
a v4+ blob; ``decompress(blob, on_error="salvage")`` /
:func:`salvage_decompress` quarantine corrupt units and return a
:class:`DecodeReport`; :func:`write` / :func:`read` publish and read files
atomically; :func:`decompress_reference` / :func:`reconstruct_reference`
keep the reference's staged decode orchestration as the fused path's
bit-identity oracle.

Layers, mirroring the reference by path: :mod:`.families` (encoder-family
registry; conv only yet), :mod:`.format` (wire schemas), :mod:`.params`
(parameter-tree packing), :mod:`.artifact` (:class:`CompressedArtifact`),
:mod:`.encode` (artifact -> streams, file pair), :mod:`.latents` (chain
and sharded latent stores), :mod:`.cache` (byte-budgeted LRU tiers),
:mod:`.runtime` (cached decode runtimes, head parsing, fused decode),
:mod:`.decode` (full-field decode entry points), :mod:`.partial`
(selective decode), :mod:`.integrity` (verification and salvage).

Every decode entry point takes ``device=None``, which means the GPU and
raises without CUDA; ``device="cpu"`` runs the plain PyTorch versions.
"""

from repro_torch.codec import families
from repro_torch.codec.artifact import CompressedArtifact
from repro_torch.codec.decode import (
    decode_artifact,
    decode_artifact_reference,
    decompress,
    decompress_reference,
    reconstruct,
    reconstruct_reference,
)
from repro_torch.codec.encode import encode, read, write
from repro_torch.codec.format import (
    DEFAULT_SHARD_TGROUPS,
    GuaranteeDirectory,
    LatentShardDirectory,
    pack_guarantee_stream,
    pack_latent_stream,
    stream_breakdown,
)
from repro_torch.codec.integrity import (
    DecodeReport,
    IntegrityFailure,
    SpeciesReport,
    salvage_decompress,
    verify_blob,
)
from repro_torch.codec.params import (
    pack_artifact_params,
    pack_params,
    unpack_params,
)
from repro_torch.codec.partial import PartialDecoder
from repro_torch.codec.runtime import (
    _fused_vecs,
    _runtime,
    cache_stats,
    clear_decode_cache,
    configure_decode_cache,
    make_fused_decode,
)
from repro_torch.core.container import ContainerFormatError


def __getattr__(name: str):
    # GBATCCodec owns a fit, so it lives with the orchestration layer in
    # repro_torch.core.pipeline; resolved lazily (PEP 562) so nothing under
    # codec/ imports the pipeline at module scope.
    if name == "GBATCCodec":
        import importlib

        return importlib.import_module("repro_torch.core.pipeline").GBATCCodec
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "GBATCCodec",
    "CompressedArtifact",
    "families",
    "ContainerFormatError",
    "DecodeReport",
    "GuaranteeDirectory",
    "IntegrityFailure",
    "LatentShardDirectory",
    "PartialDecoder",
    "SpeciesReport",
    "DEFAULT_SHARD_TGROUPS",
    "cache_stats",
    "clear_decode_cache",
    "configure_decode_cache",
    "encode",
    "read",
    "salvage_decompress",
    "verify_blob",
    "write",
    "pack_guarantee_stream",
    "pack_latent_stream",
    "pack_params",
    "unpack_params",
    "pack_artifact_params",
    "decode_artifact",
    "decode_artifact_reference",
    "decompress",
    "decompress_reference",
    "reconstruct",
    "reconstruct_reference",
    "make_fused_decode",
    "stream_breakdown",
]
