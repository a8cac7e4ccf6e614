"""Full-field decode paths: blob/artifact -> (S, T, H, W) float32.

The hot path (:func:`decompress`) is device-resident: the container head
(meta, latents, parameters) parses first — served from the content-keyed
head cache on repeat blobs — and the fused decode (dequantized latents → AE
decoder → pointwise correction → (S, NB, D) vectors) is launched
asynchronously; the per-species guarantee streams entropy-decode on the
host while the NN decode runs, and a single batched launch of the
hand-written correction kernel replays the stored corrections. The
reference's staged orchestration is kept as :func:`reconstruct_reference`
/ :func:`decompress_reference` — the fused path must match it **bit for
bit**. ``species=`` / ``time_range=`` dispatch to
:class:`~repro_torch.codec.partial.PartialDecoder`, ``on_error="salvage"``
to :func:`~repro_torch.codec.integrity.salvage_decompress`.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.codec.artifact import CompressedArtifact
from repro_torch.codec.runtime import (
    _FUSED_CHUNK,
    _as_state,
    _cached_head,
    _decode_guarantees,
    _decode_head,
    _evict_head,
    _fused_vecs,
    _latents32,
    _runtime,
)
from repro_torch.core import blocking, correction, entropy, gae
from repro_torch.core.container import ContainerFormatError
from repro_torch.core.quantization import dequantize
from repro_torch.device import DeviceLike, resolve_device, strict_fp32


def _finish_artifact(head, *, huffman=None) -> CompressedArtifact:
    return CompressedArtifact(
        latent_q=head.latents.full(),
        latent_bin=head.latent_bin,
        ae_params=head.ae_params,
        corr_params=head.corr_params,
        species_guarantees=_decode_guarantees(head, huffman=huffman),
        norm_min=head.norm_min,
        norm_range=head.norm_range,
        shape=head.shape,
        cfg=head.cfg,
        _latent_blob=head.latent_stream,
        _wire=head.blob,
    )


def decode_artifact(blob: bytes, *, device: DeviceLike = None
                    ) -> CompressedArtifact:
    """Rebuild a :class:`CompressedArtifact` from a container blob alone.

    The returned artifact carries only what the wire format does: the AE
    *decoder* parameters (the encoder never ships), the correction network
    if present, and the per-species guarantee streams (entropy-decoded
    species-parallel, decode tables memoized per codebook). Always parses
    fresh; the head cache serves :func:`decompress` and
    :class:`~repro_torch.codec.PartialDecoder`.
    """
    return _finish_artifact(_decode_head(blob, device=device))


def decode_artifact_reference(blob: bytes, *, device: DeviceLike = None
                              ) -> CompressedArtifact:
    """The reference's retained deserialize: sequential per-species
    guarantee decode with per-call table builds and the per-code-bit
    window pass. Bitwise the same artifact as :func:`decode_artifact`."""
    return _finish_artifact(
        _decode_head(blob, device=device, huffman=entropy.huffman_decode_ref),
        huffman=entropy.huffman_decode_ref,
    )


def _finalize_field(corrected: np.ndarray, artifact: CompressedArtifact
                    ) -> np.ndarray:
    """(S, NB, D) corrected vectors -> denormalized (S, T, H, W) field.

    Host numpy on the fused, the staged and the encode side: the
    multiply/add stays un-fused (no FMA contraction), keeping them
    bit-identical.
    """
    geom = artifact.cfg.geometry
    rec_blocks = blocking.vectors_as_blocks(corrected, geom)
    rec_normed = blocking.from_blocks(rec_blocks, artifact.shape, geom)
    return (
        rec_normed * artifact.norm_range[:, None, None, None]
        + artifact.norm_min[:, None, None, None]
    ).astype(np.float32)


def _apply_guarantees_and_finalize(vecs_dev: torch.Tensor,
                                   artifact: CompressedArtifact
                                   ) -> np.ndarray:
    """Post-launch tail of the fused decode: batched guarantee replay on
    the (possibly still in-flight) NN-decoded vectors, then host
    finalization. The single implementation behind both ``reconstruct``
    and ``decompress``."""
    engine = gae.default_engine(vecs_dev.device)
    arts = artifact.species_guarantees
    if any(a.coeff_q.size for a in arts):
        s, nb, d = vecs_dev.shape
        # host-side CSR scatter overlaps the in-flight async NN decode
        dense, basis = engine.dense_corrections(arts, (s, nb, d))
        vecs_dev = engine.apply_device(vecs_dev, dense, basis)
    return _finalize_field(vecs_dev.cpu().numpy(), artifact)


def reconstruct(artifact: CompressedArtifact, *, device: DeviceLike = None
                ) -> np.ndarray:
    """Decode an in-memory artifact to the full (S, T, H, W) field.

    Derives every structural decision — geometry, AE shape, whether the
    tensor-correction network runs — from the artifact itself, never from
    ambient pipeline state. Runs the fused device-resident hot path;
    :func:`reconstruct_reference` keeps the staged orchestration as the
    bit-identity oracle.
    """
    has_corr = artifact.corr_params is not None
    rt = _runtime(artifact.cfg, len(artifact.norm_min), has_corr, device)
    vecs_dev = _fused_vecs(
        rt, artifact.ae_params, artifact.corr_params,
        _latents32(artifact.latent_q, artifact.latent_bin),
    )
    return _apply_guarantees_and_finalize(vecs_dev, artifact)


def _batched(fn, arrays: np.ndarray, device: torch.device,
             batch: int) -> np.ndarray:
    """Apply ``fn`` (tensor -> tensor) over leading-axis chunks of a host
    array, with a host round trip per chunk. Chunk shapes are kept fixed:
    a ragged last chunk is padded (edge-row repeat) to the full batch size
    and the padding sliced off the result; an array of at most ``batch``
    rows runs as one call at its own length."""
    n = arrays.shape[0]
    outs = []
    with torch.no_grad(), strict_fp32():
        for i in range(0, n, batch):
            chunk = np.asarray(arrays[i : i + batch], np.float32)
            pad = batch - chunk.shape[0] if n > batch else 0
            if pad:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], pad, axis=0)])
            out = fn(torch.from_numpy(chunk).to(device)).cpu().numpy()
            outs.append(out[: out.shape[0] - pad] if pad else out)
    return np.concatenate(outs, axis=0)


def reconstruct_reference(artifact: CompressedArtifact, *,
                          device: DeviceLike = None) -> np.ndarray:
    """The reference's staged decode *orchestration*, kept as the oracle:
    host-chunked ``_batched`` stages with a numpy round trip between
    dequantize, decoder, correction, and guarantee replay (the replay
    through :func:`gae.apply_correction_batched`, one kernel launch).

    ``reconstruct`` must match it **bit for bit**, which proves the fused
    path's reorganization transparent. The stages run in the fused
    path's launch geometry — the decoder over chunks of ``_FUSED_CHUNK``
    blocks, the correction network over the same chunks' points — since
    on the GPU a library may pick another algorithm for another batch
    size. The reference's ``conv_impl="xla"`` (its seed's XLA convolution
    lowering, a timing baseline) has no counterpart here: the port has
    one convolution formulation, ``F.conv3d``, and takes no
    ``conv_impl``."""
    has_corr = artifact.corr_params is not None
    rt = _runtime(artifact.cfg, len(artifact.norm_min), has_corr, device)
    dev = rt.device
    dec_state = _as_state(artifact.ae_params, dev)
    lat = dequantize(artifact.latent_q, artifact.latent_bin)
    x_rec = _batched(lambda z: rt.model.decode(z, dec_state), lat, dev,
                     _FUSED_CHUNK)
    if has_corr:
        corr_state = _as_state(artifact.corr_params, dev)
        vecs = correction.blocks_to_pointwise(x_rec)
        points = int(np.prod(x_rec.shape[2:]))  # points a block
        fixed = _batched(lambda v: rt.corr_net(v, corr_state), vecs, dev,
                         _FUSED_CHUNK * points)
        x_rec = correction.pointwise_to_blocks(fixed, x_rec)
    vecs_rec = blocking.blocks_as_vectors(x_rec)
    corrected = gae.apply_correction_batched(
        vecs_rec, artifact.species_guarantees, device=dev
    )
    return _finalize_field(corrected, artifact)


def decompress(blob: bytes, *, species=None, time_range=None,
               on_error: str = "raise", device: DeviceLike = None):
    """Standalone decode: container bytes -> (S, T, H, W) float32 field.

    Needs no codec instance and no fitted model — everything is
    reconstructed from the blob (the acceptance contract for the wire
    format). Reads every container version the reference writes (v1-v5).
    Raises :class:`ContainerFormatError` on malformed input.

    ``device=None`` decodes on the GPU and raises without CUDA;
    ``device="cpu"`` runs the plain PyTorch versions.

    ``species`` (an index or a sequence of indices) and/or ``time_range``
    (a half-open ``(t0, t1)`` frame window) select a slice to decode
    randomly-accessed: only the requested guarantee streams are parsed and
    entropy-decoded, the fused NN decode covers only the block rows of the
    window — and on a v3+ (time-sharded) container only the latent shards
    covering the window entropy-decode — with the result bitwise equal to
    slicing a full decode: ``decompress(b, species=s, time_range=(t0, t1))
    == decompress(b)[s, t0:t1]``. An integer ``species`` drops the species
    axis, like numpy indexing.

    On a v4+ container every byte the decode reads is digest-checked
    (CRC32) before it is interpreted; a mismatch raises
    :class:`ContainerFormatError` with structured context (stream,
    offset, unit). ``on_error="salvage"`` switches to degraded-but-honest
    decoding: corrupt species/latent shards are quarantined instead of
    aborting, everything verifiable decodes (bitwise equal to the clean
    decode), damaged regions come back NaN, and the call returns a
    ``(field, DecodeReport)`` tuple — see
    :func:`repro_torch.codec.integrity.salvage_decompress`.

    Parsed container heads are served from a content-keyed bounded cache,
    so repeated (window) queries on one blob skip the head parse and every
    already-decoded stream; :func:`repro_torch.codec.clear_decode_cache`
    drops the memo. A raise-mode decode that hits corruption evicts the
    blob's cached head, and salvage never touches the cache — a salvaged
    parse can never be served later as a clean head.
    """
    if on_error not in ("raise", "salvage"):
        raise ValueError(
            f"on_error must be 'raise' or 'salvage', got {on_error!r}"
        )
    dev = resolve_device(device)
    if on_error == "salvage":
        from repro_torch.codec.integrity import salvage_decompress

        return salvage_decompress(
            blob, species=species, time_range=time_range, device=dev
        )
    if species is not None or time_range is not None:
        from repro_torch.codec.partial import PartialDecoder

        return PartialDecoder(blob, device=dev).decode(
            species=species, time_range=time_range
        )
    head = _cached_head(blob, dev)
    try:
        vecs_dev = _fused_vecs(
            head.runtime, head.dec_state, head.corr_state,
            _latents32(head.latents.full(), head.latent_bin),
        )
        # the guarantee streams entropy-decode while the launched NN runs
        artifact = _finish_artifact(head)
        return _apply_guarantees_and_finalize(vecs_dev, artifact)
    except ContainerFormatError:
        # corruption discovered after the head parse (lazy shard/species
        # digest or entropy failure): drop the poisoned cached head
        _evict_head(blob, dev)
        raise


def decompress_reference(blob: bytes, *, device: DeviceLike = None
                         ) -> np.ndarray:
    """The reference's retained standalone decode: sequential per-species
    deserialize with per-call Huffman table builds, then the staged
    host-chunked reconstruct. The fused path's bit-identity oracle."""
    return reconstruct_reference(
        decode_artifact_reference(blob, device=device), device=device
    )
