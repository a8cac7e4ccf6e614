"""Encode planner: pipeline artifacts -> container bytes.

:func:`encode` maps a fitted :class:`CompressedArtifact` onto the wire
streams of the requested container version — v5 (default) is v4's
stream set with the ``meta`` stream prefixed by the encoder-family tag
(see :mod:`repro_torch.codec.families`; a conv-family v5 blob differs from
the v4 encoding of the same fit by that one byte only), v4 is v3 plus
an ``integrity`` stream of CRC32 digests (per stream + per
random-access unit + the outer header), v3 shards the latent stream
along time and packs the per-shard chains in parallel, v2 writes the
single-chain selective layout, v1 the original per-species nested
guarantee containers. All five stay writable so round-trip and
back-compat gates can cover every version; non-conv families require
v5 (the legacy meta layout has no family field). Every version's bytes
are identical to the reference package's encoding of the same artifact.

:func:`write`/:func:`read` are the file-level pair: an atomic
tmp+fsync+rename publish, so a
crash mid-write can never leave a half-blob that parses, and a
digest-verifying read. The :class:`GBATCCodec` fit/compress facade
lives with the orchestration layer in :mod:`repro_torch.core.pipeline` —
this module is decode-purity scoped (nothing under ``codec/`` imports
the pipeline).
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

from repro_torch.codec import families
from repro_torch.codec import format as wire
from repro_torch.codec.artifact import CompressedArtifact
from repro_torch.codec.params import pack_artifact_params
from repro_torch.core import container as container_format
from repro_torch.core.container import ContainerWriter


def encode(artifact: CompressedArtifact,
           version: int = container_format.FORMAT_VERSION_FAMILY,
           *, shard_tgroups: Optional[int] = None) -> bytes:
    """Serialize a :class:`CompressedArtifact` into a container blob.

    ``version`` selects the layout: 5 (default) prefixes the meta
    stream with the encoder-family tag (required for non-conv
    families); 4 writes the time-sharded latent stream + combined
    guarantee stream + integrity digests; 3 the same without digests;
    2 the single-chain latent + combined guarantee; 1 the original
    per-species nested containers (all retained byte-stable so
    back-compat round-trips stay testable). ``shard_tgroups`` (v3+)
    sets the shard size in time block-groups (``bt`` frames each); the
    default of ``format.DEFAULT_SHARD_TGROUPS`` gives the finest
    window a block-row decode can address. Oversized values clamp to
    one shard.
    """
    cfg = families.structural(artifact.cfg)
    if version not in container_format.SUPPORTED_VERSIONS:
        raise ValueError(f"unknown container version {version}")
    if (shard_tgroups is not None
            and version < container_format.FORMAT_VERSION_SHARDED):
        raise ValueError(
            f"shard_tgroups applies to container v"
            f"{container_format.FORMAT_VERSION_SHARDED}+ only"
        )
    w = ContainerWriter(version=version)
    w.add("meta", wire._pack_meta(artifact, version))
    if version >= container_format.FORMAT_VERSION_SHARDED:
        geom = cfg.geometry
        _, _, h, wd = artifact.shape
        per_frame = (h // geom.ph) * (wd // geom.pw)
        tg = wire.DEFAULT_SHARD_TGROUPS if shard_tgroups is None \
            else int(shard_tgroups)
        if tg < 1:
            raise ValueError(f"shard_tgroups must be >= 1, got {tg}")
        # through the artifact so a sweep's blobs share one packed stream
        w.add("latent", artifact.sharded_latent_stream(tg * per_frame))
    else:
        w.add("latent", artifact.latent_blob())
    packed = artifact._param_streams
    if packed is None:
        packed = pack_artifact_params(
            artifact.ae_params, artifact.corr_params, cfg.param_dtype_bytes
        )
    w.add("decoder", packed[0])
    if artifact.corr_params is not None:
        w.add("correction", packed[1])
    if version >= container_format.FORMAT_VERSION_SELECTIVE:
        w.add("guarantee",
              wire.pack_guarantee_stream(artifact.species_guarantees))
    else:
        for sidx, g in enumerate(artifact.species_guarantees):
            w.add(f"guarantee{sidx}", g.to_bytes())
    if version >= container_format.FORMAT_VERSION_INTEGRITY:
        # two-pass outer digest: the integrity payload's LENGTH is fixed
        # before its content (it depends only on stream count/names and
        # unit counts), so the exact outer header+table bytes — integrity
        # entry included — are known before outer_crc is patched in
        streams = list(w._streams)
        integ = wire.pack_integrity_stream(streams)
        header = container_format.pack_header(
            version,
            [(n, len(p)) for n, p in streams] + [("integrity", len(integ))],
        )
        w.add("integrity", wire.finalize_integrity_stream(integ, header))
    return w.to_bytes()


def write(path, blob: bytes) -> None:
    """Atomically publish container bytes at ``path``.

    Write to a temp file in the same
    directory, flush + fsync, then ``os.replace`` — so a crash at any
    point leaves either the previous file or the complete new one, never
    a half-blob that parses (v4's outer digest would catch one anyway;
    this makes the failure mode impossible rather than detectable).
    """
    path = os.fspath(path)
    blob = bytes(blob)
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(
        dir=d, prefix=f".{os.path.basename(path)}.tmp"
    )
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    # fsync the directory so the rename itself is durable
    try:
        dfd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def read(path, *, verify: bool = True) -> bytes:
    """Read container bytes from ``path``; ``verify=True`` (default)
    digest-checks every payload byte on v4+ blobs (structural parse only
    below v4) before returning, raising
    :class:`~repro_torch.core.container.ContainerFormatError` on corruption."""
    with open(os.fspath(path), "rb") as f:
        blob = f.read()
    if verify:
        from repro_torch.codec.integrity import verify_blob

        verify_blob(blob)
    return blob

