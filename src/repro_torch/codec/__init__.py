"""Public codec API of the port: GBATC as *bytes in, bytes out*.

:class:`GBATCCodec` wraps the fit/compress orchestration and returns a
**self-describing container blob**; module-level :func:`decompress`
reconstructs the field from the blob alone — no fitted pipeline, no
original data, no config object. The wire format is the reference
package's container v5, byte for byte: a blob written by either package
parses under the other. Streams:

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

The port reads and writes v5 only; v1-v4, selective decode, salvage
decode and the file pair ``write``/``read`` are still to be ported.

Layers, mirroring the reference by path: :mod:`.families` (encoder-family
registry; conv only yet), :mod:`.format` (wire schemas), :mod:`.params`
(parameter-tree packing), :mod:`.artifact` (:class:`CompressedArtifact`),
:mod:`.encode` (artifact -> streams), :mod:`.latents` (sharded latent
store), :mod:`.cache` (byte-budgeted LRU tiers), :mod:`.runtime` (cached
decode runtimes, head parsing, fused decode), :mod:`.decode` (full-field
decode entry points).

Every decode entry point takes ``device=None``, which means the GPU and
raises without CUDA; ``device="cpu"`` runs the plain PyTorch versions.
"""

from repro_torch.codec import families
from repro_torch.codec.artifact import CompressedArtifact
from repro_torch.codec.decode import (
    decode_artifact,
    decompress,
    reconstruct,
)
from repro_torch.codec.encode import encode
from repro_torch.codec.format import (
    DEFAULT_SHARD_TGROUPS,
    GuaranteeDirectory,
    LatentShardDirectory,
    pack_guarantee_stream,
    pack_latent_stream,
    stream_breakdown,
)
from repro_torch.codec.params import (
    pack_artifact_params,
    pack_params,
    unpack_params,
)
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
    "GuaranteeDirectory",
    "LatentShardDirectory",
    "DEFAULT_SHARD_TGROUPS",
    "cache_stats",
    "clear_decode_cache",
    "configure_decode_cache",
    "encode",
    "pack_guarantee_stream",
    "pack_latent_stream",
    "pack_params",
    "unpack_params",
    "pack_artifact_params",
    "decode_artifact",
    "decompress",
    "reconstruct",
    "make_fused_decode",
    "stream_breakdown",
]
