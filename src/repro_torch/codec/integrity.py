"""Salvage decode + blob verification: degraded-but-honest reads.

Raise-mode decoding (the default everywhere) aborts on the first
corruption it can prove. This module is the other half of the v4
integrity contract: :func:`salvage_decompress` quarantines the corrupt
random-access units — latent shards, species' guarantee extents —
decodes everything that still verifies (bitwise equal to the clean
decode of the same selection), fills what it cannot decode with NaN,
and reports exactly what happened in a structured
:class:`DecodeReport`. Nothing is silently wrong: a value is either the
clean decode's value, or NaN with its cause listed in the report.

Fatal (non-quarantinable) corruption still raises even in salvage mode:
the outer container framing and the ``meta`` stream, without which no
output shape or denormalization can be trusted. Corruption of the
shared NN parameter streams (``decoder``/``correction``) or of the
latent stream's head poisons *every* value, so salvage returns an
all-NaN field with every species reported ``missing`` rather than
decoding garbage.

Salvage is cache-isolated by design: it never reads from or writes into
the decode head cache (``runtime._CACHE.heads``), and it evicts the
blob's key on entry — a salvaged parse can never be served later as a
clean head, and a previously cached clean head can never mask corruption
the caller asked salvage to find.

The NN decode and the correction replay run on ``device`` (``None``: the
GPU, raising without CUDA), through the same launches as a clean
selective decode of the same selection.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.codec import format as wire
from repro_torch.codec import runtime
from repro_torch.codec.partial import (
    _any_corrections,
    _normalize_species,
    _normalize_time_range,
    _window_rows,
)
from repro_torch.core import blocking, gae
from repro_torch.core import container as container_format
from repro_torch.core.container import ContainerFormatError, ContainerReader
from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class IntegrityFailure:
    """One detected corruption, in the same structured vocabulary as
    :class:`ContainerFormatError` (stream / unit / offset)."""

    reason: str
    stream: Optional[str] = None
    unit: Optional[int] = None
    offset: Optional[int] = None

    @classmethod
    def from_error(cls, e: ContainerFormatError) -> "IntegrityFailure":
        return cls(reason=str(e), stream=e.stream, unit=e.unit,
                   offset=e.offset)


@dataclasses.dataclass
class SpeciesReport:
    """Per-species outcome of a salvage decode.

    ``status`` is one of:

    * ``"verified"`` — every byte feeding this species digest-checked
      (v4); ``nrmse_bound`` carries the achieved error bound
      (``tau / sqrt(D)``, the per-block guarantee in NRMSE units);
    * ``"unverified"`` — decoded clean but the container carries no
      digests (v1–v3) or its integrity stream was itself corrupt;
    * ``"salvaged"`` — decoded, but some time block-groups were lost to
      corrupt latent shards: ``damaged_frames`` lists the NaN-filled
      half-open frame ranges (healthy frames are bitwise clean);
    * ``"missing"`` — nothing trustworthy could be decoded (the species'
      guarantee extent was corrupt, or a shared stream was): all-NaN.
    """

    status: str
    nrmse_bound: Optional[float] = None
    damaged_frames: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class DecodeReport:
    """Structured result of a salvage decode.

    ``integrity`` is True when the container carried v4 digests and they
    were usable (self-consistent), i.e. every non-quarantined value was
    positively verified rather than merely parseable. ``species`` maps
    each *selected* absolute species index to its
    :class:`SpeciesReport`; ``failures`` lists every digest/parse
    failure encountered, most specific context first.
    """

    version: int
    integrity: bool
    failures: list
    species: dict

    @property
    def ok(self) -> bool:
        """True iff nothing was corrupt (the field equals a clean decode)."""
        return not self.failures

    @property
    def quarantined(self) -> list:
        """Selected species that came back all-NaN (status ``missing``)."""
        return sorted(s for s, r in self.species.items()
                      if r.status == "missing")


def verify_blob(blob: bytes) -> int:
    """Structurally parse + (v4) digest-check every payload byte of a blob.

    One pass: outer framing, then on v4 the integrity stream's
    self-check, the outer-header digest, and every sibling stream's
    whole-payload digest — together these cover 100% of the blob's
    bytes. Raises :class:`ContainerFormatError` on any mismatch; returns
    the container version. v1–v3 blobs get the structural parse only
    (they carry no digests to check)."""
    r = ContainerReader(blob)
    if r.version >= container_format.FORMAT_VERSION_INTEGRITY:
        integ = wire.IntegrityDirectory(r["integrity"])
        integ.verify_outer(bytes(blob), r.header_bytes)
        for name in r.names:
            if name != "integrity":
                integ.verify_stream(name, r[name])
    return r.version


def _salvage_head(blob: bytes, failures: list, device: torch.device):
    """Best-effort head parse for salvage: returns ``(head, fatal)``.

    A corrupt integrity stream downgrades to a structural (v3-style)
    parse — recorded in ``failures``, never fatal by itself. Corruption
    of the shared decoder/correction/latent head regions is *fatal for
    values* (head is None) but still reportable; anything the outer
    framing or meta stream is at fault for re-raises."""
    check = True
    while True:
        try:
            return runtime._decode_head(
                blob, device=device, check_integrity=check
            ), None
        except ContainerFormatError as e:
            if check and e.stream == "integrity":
                # digests unusable: fall back to the structural parse the
                # same bytes would get as a v3 container
                failures.append(IntegrityFailure.from_error(e))
                check = False
                continue
            if e.stream in ("decoder", "correction", "latent"):
                failures.append(IntegrityFailure.from_error(e))
                return None, e
            raise


def salvage_decompress(blob: bytes, *, species=None, time_range=None,
                       device: DeviceLike = None):
    """Decode as much of a (possibly corrupt) blob as can be trusted.

    Returns ``(field, report)``: ``field`` shaped exactly like the
    corresponding raise-mode ``decompress(blob, species=...,
    time_range=...)`` output, with every value either bitwise equal to
    the clean decode or NaN; ``report`` a :class:`DecodeReport` saying
    which. On a clean blob the field is bitwise identical to the
    raise-mode decode and ``report.ok`` is True.

    Raises only when nothing honest can be produced at all: malformed
    outer framing, or a corrupt ``meta`` stream (v4 proves it; below v4
    an unparseable one), since shape and denormalization would be
    untrustworthy. See the module docstring for the quarantine rules.
    ``device=None`` decodes on the GPU and raises without CUDA.
    """
    dev = resolve_device(device)
    blob = bytes(blob)
    # cache isolation: never serve salvage from (or leave state in) the
    # clean-head cache
    runtime._evict_head(blob, dev)
    failures: list = []
    head, fatal = _salvage_head(blob, failures, dev)

    if head is None:
        # shared NN/latent state is gone: report shape from the (already
        # validated) meta stream and return an all-NaN field
        r = ContainerReader(blob)
        cfg, shape, _, _, _ = wire._unpack_meta(r["meta"], version=r.version)
        s, t, h, w = shape
        idx, squeeze = _normalize_species(species, s)
        t0, t1 = _normalize_time_range(time_range, t)
        out = np.full((len(idx), t1 - t0, h, w), np.nan, np.float32)
        report = DecodeReport(
            version=r.version,
            integrity=(
                r.version >= container_format.FORMAT_VERSION_INTEGRITY
                and not any(f.stream == "integrity" for f in failures)
            ),
            failures=failures,
            species={i: SpeciesReport(status="missing") for i in idx},
        )
        return (out[0] if squeeze else out), report

    s, t, h, w = head.shape
    idx, squeeze = _normalize_species(species, s)
    t0, t1 = _normalize_time_range(time_range, t)
    geom = head.cfg.geometry
    tg0, tg1, b0, b1 = _window_rows(head, t0, t1)
    per_frame = (h // geom.ph) * (w // geom.pw)
    verified = head.integrity is not None

    # --- latents: decode healthy shards, quarantine the rest -------------
    rows, bad_shards = head.latents.salvage_rows(b0, b1)
    for k, _, _, e in bad_shards:
        failures.append(IntegrityFailure.from_error(e))
    lat32 = runtime._latents32(rows, head.latent_bin)
    vecs_dev = runtime._fused_vecs(
        head.runtime, head.dec_state, head.corr_state, lat32,
        rows=(b0, head.nb),
    )

    # --- guarantees: per-species quarantine ------------------------------
    # the artifact-wide replay gate and the directory must parse for ANY
    # species' corrections to be locatable; if they don't, no species can
    # honestly replay -> everything selected is missing
    try:
        any_corr = _any_corrections(head)
    except ContainerFormatError as e:
        failures.append(IntegrityFailure.from_error(e))
        out = np.full((len(idx), t1 - t0, h, w), np.nan, np.float32)
        report = DecodeReport(
            version=head.version, integrity=verified, failures=failures,
            species={i: SpeciesReport(status="missing") for i in idx},
        )
        return (out[0] if squeeze else out), report

    arts = []
    quarantined = set()
    for i in idx:
        try:
            arts.append(runtime._species_guarantee(head, i))
        except ContainerFormatError as e:
            failures.append(IntegrityFailure.from_error(e))
            quarantined.add(i)
            # a shape-compatible stand-in so the batched replay runs; its
            # output rows are overwritten with NaN below
            arts.append(gae.GuaranteeArtifact.empty(
                nb=head.nb, d=geom.block_size, tau=0.0
            ))

    # --- replay + finalize: the exact PartialDecoder pipeline ------------
    vecs_sel = vecs_dev[torch.as_tensor(idx, device=vecs_dev.device)]
    if any_corr:
        engine = gae.default_engine(dev)
        dense, basis = engine.dense_corrections(
            arts, (len(idx), b1 - b0, geom.block_size),
            block_range=(b0, b1),
        )
        vecs_sel = engine.apply_device(vecs_sel, dense, basis)
    vecs_np = vecs_sel.cpu().numpy()
    # quarantined latent shards: NaN exactly the damaged block rows (the
    # AE decodes all species jointly per block, so damage is species-wide)
    if bad_shards:
        vecs_np = vecs_np.copy()
        for _, r_lo, r_hi, _ in bad_shards:
            vecs_np[:, r_lo - b0 : r_hi - b0] = np.nan
    rec_blocks = blocking.vectors_as_blocks(vecs_np, geom)
    sub_shape = (len(idx), (tg1 - tg0) * geom.bt, h, w)
    rec_normed = blocking.from_blocks(rec_blocks, sub_shape, geom)
    out = (
        rec_normed * head.norm_range[idx][:, None, None, None]
        + head.norm_min[idx][:, None, None, None]
    ).astype(np.float32)
    out = out[:, t0 - tg0 * geom.bt : t1 - tg0 * geom.bt]

    # --- per-species verdicts --------------------------------------------
    damaged_frames = _merge_frame_ranges(
        bad_shards, per_frame, geom.bt, t0, t1
    )
    species_reports: dict = {}
    for pos, i in enumerate(idx):
        if i in quarantined:
            out[pos] = np.nan
            species_reports[i] = SpeciesReport(status="missing")
        elif damaged_frames:
            species_reports[i] = SpeciesReport(
                status="salvaged", damaged_frames=list(damaged_frames)
            )
        elif verified:
            species_reports[i] = SpeciesReport(
                status="verified",
                nrmse_bound=arts[pos].tau / math.sqrt(geom.block_size),
            )
        else:
            species_reports[i] = SpeciesReport(status="unverified")

    report = DecodeReport(
        version=head.version, integrity=verified, failures=failures,
        species=species_reports,
    )
    return (out[0] if squeeze else out), report


def _merge_frame_ranges(bad_shards, per_frame: int, bt: int,
                        t0: int, t1: int) -> list:
    """Quarantined block rows -> merged half-open damaged frame ranges
    (clipped to the requested window). Block rows are time-major, so a
    damaged row maps to the time block-group ``row // per_frame`` and
    from there to ``bt`` frames."""
    frames = set()
    for _, r_lo, r_hi, _ in bad_shards:
        for tg in range(r_lo // per_frame, -(-r_hi // per_frame)):
            for f in range(max(tg * bt, t0), min((tg + 1) * bt, t1)):
                frames.add(f)
    if not frames:
        return []
    ordered = sorted(frames)
    ranges = []
    lo = prev = ordered[0]
    for f in ordered[1:]:
        if f != prev + 1:
            ranges.append((lo, prev + 1))
            lo = f
        prev = f
    ranges.append((lo, prev + 1))
    return ranges
