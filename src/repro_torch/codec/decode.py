"""Full-field decode paths: blob/artifact -> (S, T, H, W) float32.

The hot path (:func:`decompress`) is device-resident: the container head
(meta, latents, parameters) parses first — served from the content-keyed
head cache on repeat blobs — and the fused decode (dequantized latents → AE
decoder → pointwise correction → (S, NB, D) vectors) is launched
asynchronously; the per-species guarantee streams entropy-decode on the
host while the NN decode runs, and a single batched launch of the
hand-written correction kernel replays the stored corrections.

Not ported yet: selective decode (``species=`` / ``time_range=``), salvage
decode, and the staged reference orchestration.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.codec.artifact import CompressedArtifact
from repro_torch.codec.runtime import (
    _cached_head,
    _decode_guarantees,
    _decode_head,
    _evict_head,
    _fused_vecs,
    _latents32,
    _runtime,
)
from repro_torch.core import blocking, gae
from repro_torch.core.container import ContainerFormatError
from repro_torch.device import DeviceLike, resolve_device


def _finish_artifact(head) -> CompressedArtifact:
    return CompressedArtifact(
        latent_q=head.latents.full(),
        latent_bin=head.latent_bin,
        ae_params=head.ae_params,
        corr_params=head.corr_params,
        species_guarantees=_decode_guarantees(head),
        norm_min=head.norm_min,
        norm_range=head.norm_range,
        shape=head.shape,
        cfg=head.cfg,
        _wire=head.blob,
    )


def decode_artifact(blob: bytes, *, device: DeviceLike = None
                    ) -> CompressedArtifact:
    """Rebuild a :class:`CompressedArtifact` from a container blob alone.

    The returned artifact carries only what the wire format does: the AE
    *decoder* parameters (the encoder never ships), the correction network
    if present, and the per-species guarantee streams. Always parses fresh;
    the head cache serves :func:`decompress`.
    """
    return _finish_artifact(_decode_head(blob, device=device))


def _finalize_field(corrected: np.ndarray, artifact: CompressedArtifact
                    ) -> np.ndarray:
    """(S, NB, D) corrected vectors -> denormalized (S, T, H, W) field.

    Host numpy on both the encode and the decode side: the multiply/add
    stays un-fused (no FMA contraction), keeping the two bit-identical.
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
    ambient pipeline state.
    """
    has_corr = artifact.corr_params is not None
    rt = _runtime(artifact.cfg, len(artifact.norm_min), has_corr, device)
    vecs_dev = _fused_vecs(
        rt, artifact.ae_params, artifact.corr_params,
        _latents32(artifact.latent_q, artifact.latent_bin),
    )
    return _apply_guarantees_and_finalize(vecs_dev, artifact)


def decompress(blob: bytes, *, species=None, time_range=None,
               on_error: str = "raise", device: DeviceLike = None):
    """Standalone decode: container bytes -> (S, T, H, W) float32 field.

    Needs no codec instance and no fitted model — everything is
    reconstructed from the blob (the acceptance contract for the wire
    format). Raises :class:`ContainerFormatError` on malformed input, and
    on a container version other than 5, which the port does not read yet.
    Every byte the decode reads is digest-checked (CRC32) before it is
    interpreted.

    ``device=None`` decodes on the GPU and raises without CUDA;
    ``device="cpu"`` runs the plain PyTorch versions. Selective decode
    (``species`` / ``time_range``) and ``on_error="salvage"`` are part of
    the reference's interface that the port has not reached yet: asking for
    them raises ``NotImplementedError``.

    Parsed container heads are served from a content-keyed bounded cache,
    so repeated queries on one blob skip the head parse and every
    already-decoded stream; :func:`repro_torch.codec.clear_decode_cache`
    drops the memo. A decode that hits corruption evicts the blob's cached
    head.
    """
    if on_error not in ("raise", "salvage"):
        raise ValueError(
            f"on_error must be 'raise' or 'salvage', got {on_error!r}"
        )
    if on_error == "salvage":
        raise NotImplementedError("salvage decode is not yet ported")
    if species is not None or time_range is not None:
        raise NotImplementedError("selective decode is not yet ported")
    dev = resolve_device(device)
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
