"""Encode planner: pipeline artifacts -> container bytes.

:func:`encode` maps a fitted :class:`CompressedArtifact` onto the wire
streams of container v5: the ``meta`` stream prefixed by the
encoder-family tag (see :mod:`repro_torch.codec.families`), the
time-sharded ``latent`` stream with per-shard chains packed in parallel,
the ``decoder`` / ``correction`` parameter streams, ONE combined
``guarantee`` stream, and an ``integrity`` stream of CRC32 digests (per
stream + per random-access unit + the outer header). The bytes are
identical to the reference package's v5 encoding of the same artifact.

The port writes v5 only; the earlier layouts (v1-v4) are still to be
ported and asking for one raises ``ContainerFormatError``. The
:class:`GBATCCodec` fit/compress facade lives with the orchestration
layer in :mod:`repro_torch.core.pipeline` - nothing under ``codec/``
imports the pipeline.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.codec import families
from repro_torch.codec import format as wire
from repro_torch.codec.artifact import CompressedArtifact
from repro_torch.codec.params import pack_artifact_params
from repro_torch.core import container as container_format
from repro_torch.core.container import ContainerFormatError, ContainerWriter


def encode(artifact: CompressedArtifact,
           version: int = container_format.FORMAT_VERSION_FAMILY,
           *, shard_tgroups: Optional[int] = None) -> bytes:
    """Serialize a :class:`CompressedArtifact` into a container blob.

    ``version`` must be 5, the only layout the port writes yet.
    ``shard_tgroups`` sets the latent shard size in time block-groups
    (``bt`` frames each); the default of ``format.DEFAULT_SHARD_TGROUPS``
    gives the finest window a block-row decode can address. Oversized
    values clamp to one shard.
    """
    cfg = families.structural(artifact.cfg)
    if version not in container_format.SUPPORTED_VERSIONS:
        raise ValueError(f"unknown container version {version}")
    if version != container_format.FORMAT_VERSION_FAMILY:
        raise ContainerFormatError(
            f"the port does not write container v{version} yet "
            f"(only v{container_format.FORMAT_VERSION_FAMILY})"
        )
    w = ContainerWriter(version=version)
    w.add("meta", wire._pack_meta(artifact, version))
    geom = cfg.geometry
    _, _, h, wd = artifact.shape
    per_frame = (h // geom.ph) * (wd // geom.pw)
    tg = wire.DEFAULT_SHARD_TGROUPS if shard_tgroups is None \
        else int(shard_tgroups)
    if tg < 1:
        raise ValueError(f"shard_tgroups must be >= 1, got {tg}")
    # through the artifact so a sweep's blobs share one packed stream
    w.add("latent", artifact.sharded_latent_stream(tg * per_frame))
    packed = artifact._param_streams
    if packed is None:
        packed = pack_artifact_params(
            artifact.ae_params, artifact.corr_params, cfg.param_dtype_bytes
        )
    w.add("decoder", packed[0])
    if artifact.corr_params is not None:
        w.add("correction", packed[1])
    w.add("guarantee",
          wire.pack_guarantee_stream(artifact.species_guarantees))
    # two-pass outer digest: the integrity payload's LENGTH is fixed
    # before its content (it depends only on stream count/names and
    # unit counts), so the exact outer header+table bytes - integrity
    # entry included - are known before outer_crc is patched in
    streams = list(w._streams)
    integ = wire.pack_integrity_stream(streams)
    header = container_format.pack_header(
        version,
        [(n, len(p)) for n, p in streams] + [("integrity", len(integ))],
    )
    w.add("integrity", wire.finalize_integrity_stream(integ, header))
    return w.to_bytes()
