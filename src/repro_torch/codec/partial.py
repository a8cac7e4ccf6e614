"""Selective decode: random access by species / time window.

:class:`PartialDecoder` serves (species, window) slices of one container
blob, parsing only the header plus the requested streams. On a v3
container both the guarantee streams *and* the latent stream are
random-access — a time window entropy-decodes only the latent shards
covering it — so a window query is O(window) end to end. Every slice is
bitwise equal to slicing the full decode.

The slice pipeline is exposed in stages — :func:`plan_slice` (normalize
a request to its block-row window), :func:`replay_slice` (guarantee
decode + correction replay over selected species), and
:func:`finalize_slice` (blocks -> field, denormalize, window trim) — so
a decode service can run the middle stages once over a *union* of
coalesced requests and finalize each request from its slice of the
shared result, bit-identically to the serial path below.

Every entry point that touches the device takes ``device=None``, which
means the GPU and raises without CUDA; ``device="cpu"`` runs the plain
PyTorch versions. The selected species' corrections replay through one
launch of the hand-written correction kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.codec.runtime import (
    _cached_head,
    _decode_species_guarantees,
    _evict_head,
    _fused_vecs,
    _gdir,
    _latents32,
)
from repro_torch.core import blocking, entropy, gae
from repro_torch.core import container as container_format
from repro_torch.core.container import ContainerFormatError, ContainerReader
from repro_torch.device import DeviceLike, resolve_device


def _normalize_species(species, s: int) -> tuple[list, bool]:
    """Selection -> (index list, squeeze-species-axis?)."""
    if species is None:
        return list(range(s)), False
    if isinstance(species, (int, np.integer)):
        species, squeeze = [int(species)], True
    else:
        species, squeeze = [int(x) for x in species], False
    if not species:
        raise ValueError("empty species selection")
    idx = []
    for x in species:
        if not -s <= x < s:
            raise ValueError(
                f"species index {x} out of range for {s} species"
            )
        idx.append(x % s)
    if len(set(idx)) != len(idx):
        raise ValueError(f"duplicate species in selection {species}")
    return idx, squeeze


def _normalize_time_range(time_range, t: int) -> tuple[int, int]:
    if time_range is None:
        return 0, t
    t0, t1 = (int(time_range[0]), int(time_range[1]))
    if not 0 <= t0 < t1 <= t:
        raise ValueError(
            f"time_range {time_range!r} is not a half-open window "
            f"inside [0, {t})"
        )
    return t0, t1


def _window_rows(head, t0: int, t1: int) -> tuple[int, int, int, int]:
    """Frame window -> (tg0, tg1, b0, b1): covering time block-groups and
    their contiguous block-row range (the block index is time-major)."""
    geom = head.cfg.geometry
    _, _, h, w = head.shape
    per_frame = (h // geom.ph) * (w // geom.pw)
    tg0, tg1 = t0 // geom.bt, -(-t1 // geom.bt)
    return tg0, tg1, tg0 * per_frame, tg1 * per_frame


# an empty coefficient stream is exactly the self-describing Huffman
# header; any stream with >= 1 symbol is strictly longer (header grows by
# 9 bytes per codebook symbol before any payload bit)
_EMPTY_HUFFMAN_LEN = len(entropy.huffman_encode(np.zeros(0, np.int64)))


def _any_corrections(head) -> bool:
    """Does ANY species of the artifact carry stored corrections?

    The full decode runs the correction-replay kernel over all species
    whenever any one of them has corrections — so the selective path must
    gate its replay on the same artifact-wide bit (not just the selected
    species') to stay byte-identical to slicing the full decode. Decided
    at the wire level without entropy-decoding anything: a species is
    empty iff its coefficient stream is the bare Huffman header. Memoized
    on the head (under its lock — concurrent decode threads share cached
    heads) — the v1 recompute would copy every species' payload per
    query.
    """
    with head.lock:
        if head.any_corrections is not None:
            return head.any_corrections
        if head.version >= container_format.FORMAT_VERSION_SELECTIVE:
            gdir = _gdir(head)
            result = any(
                gdir.coeff_len(sidx) > _EMPTY_HUFFMAN_LEN
                for sidx in range(gdir.n_species)
            )
        else:
            result = False
            for sidx in range(head.shape[0]):
                try:
                    sizes = ContainerReader(
                        head.reader[f"guarantee{sidx}"]
                    ).stream_sizes()
                except ContainerFormatError:
                    # corrupt sibling: the full decode raises on this
                    # blob, so there is no full-decode output to match —
                    # skip it here and let the selected species' own
                    # parse decide
                    continue
                if sizes.get("coeff", 0) > _EMPTY_HUFFMAN_LEN:
                    result = True
                    break
        head.any_corrections = result
        return result


@dataclasses.dataclass(frozen=True)
class SlicePlan:
    """A normalized (species, window) request, resolved to block rows.

    Pure function of (head geometry, request) — no decode work happens at
    planning, so the service can plan every queued request, group plans
    that share latent rows, and batch the expensive stages over unions.
    """

    idx: "tuple[int, ...]"   # normalized species indices (unique)
    squeeze: bool            # single-int selection: squeeze species axis
    t0: int                  # frame window [t0, t1)
    t1: int
    tg0: int                 # covering time block-groups [tg0, tg1)
    tg1: int
    b0: int                  # covering block rows [b0, b1) (time-major)
    b1: int

    @property
    def key(self) -> tuple:
        """Result identity: requests with equal keys (against one head)
        decode to identical outputs and can share one computation."""
        return (self.idx, self.squeeze, self.t0, self.t1)


def plan_slice(head, species, time_range) -> SlicePlan:
    """Normalize a selective-decode request against ``head``.

    Raises ``ValueError`` for malformed selections (out-of-range species,
    duplicate species, inverted windows) — before any decode work."""
    s, t = head.shape[0], head.shape[1]
    idx, squeeze = _normalize_species(species, s)
    t0, t1 = _normalize_time_range(time_range, t)
    tg0, tg1, b0, b1 = _window_rows(head, t0, t1)
    return SlicePlan(idx=tuple(idx), squeeze=squeeze, t0=t0, t1=t1,
                     tg0=tg0, tg1=tg1, b0=b0, b1=b1)


def replay_slice(head, idx, block_range, vecs_sel):
    """Guarantee decode + correction replay for species ``idx`` over
    block rows ``block_range`` of ``vecs_sel`` (device array, species
    axis already selected down to ``idx``'s order).

    The replay is gated on the artifact-wide corrections bit, not the
    selection's: the full decode replays (x + C@U^T, C possibly
    all-zero) over every species whenever any species has corrections,
    and a selective output must be byte-identical to its slice.
    Species-batch independence makes each species' result independent of
    which others ride in the batch — this is what lets a service replay a
    coalesced species *union* once and hand each request its positions of
    the result.
    """
    idx = list(idx)
    b0, b1 = block_range
    # entropy-decodes on host while any launched device work runs
    arts = _decode_species_guarantees(head, idx)
    if not _any_corrections(head):
        return vecs_sel
    geom = head.cfg.geometry
    engine = gae.default_engine(head.runtime.device)
    dense, basis = engine.dense_corrections(
        arts, (len(idx), b1 - b0, geom.block_size), block_range=(b0, b1)
    )
    return engine.apply_device(vecs_sel, dense, basis)


def finalize_slice(head, plan: SlicePlan, vecs_sel) -> np.ndarray:
    """Corrected block vectors -> the request's field slice: reassemble
    blocks over the plan's window, denormalize with the selected species'
    ranges, trim block-group padding to the exact frame window."""
    geom = head.cfg.geometry
    _, _, h, w = head.shape
    sel = np.asarray(plan.idx)
    if isinstance(vecs_sel, torch.Tensor):
        vecs_sel = vecs_sel.cpu().numpy()
    rec_blocks = blocking.vectors_as_blocks(np.asarray(vecs_sel), geom)
    sub_shape = (len(plan.idx), (plan.tg1 - plan.tg0) * geom.bt, h, w)
    rec_normed = blocking.from_blocks(rec_blocks, sub_shape, geom)
    out = (
        rec_normed * head.norm_range[sel][:, None, None, None]
        + head.norm_min[sel][:, None, None, None]
    ).astype(np.float32)
    out = out[:, plan.t0 - plan.tg0 * geom.bt
              : plan.t1 - plan.tg0 * geom.bt]
    return out[0] if plan.squeeze else out


class PartialDecoder:
    """Random-access decoder over one GBATC container blob.

    Parses the container head exactly once — served from the shared
    content-keyed head cache, so even constructing a fresh decoder on a
    recently seen blob is cheap — then serves species/time-window slices
    on demand:

    * only the **requested species'** guarantee streams are parsed and
      entropy-decoded (lockstep-batched when several are requested at
      once, memoized across ``decode`` calls);
    * the fused NN decode runs on only the **block rows covering the
      requested time window** (species cannot shrink this stage — the AE
      decodes the species stack jointly per block), in the full decode's
      launch geometry (see :func:`~repro_torch.codec.runtime._fused_vecs`);
    * on a **v3 (time-sharded) container** only the latent shards
      covering the window entropy-decode (decoded shards memoize), so the
      latent cost is O(window) rather than O(T); v1/v2 carry one
      sequential chain and decode it whole, once;
    * only the requested species' corrections replay through one launch
      of the batched correction kernel, scattered from the CSR extents of
      the window alone.

    Every slice is bitwise equal to slicing the corresponding full
    decode. Works on v1-v5 containers; on v4+ each latent shard and
    species guarantee extent digest-checks (CRC32) immediately before its
    first decode, so a slice verifies exactly the bytes it reads. A
    corrupt species or latent shard stream raises
    :class:`ContainerFormatError` naming it (structured: stream/unit),
    and does not poison siblings requested in later calls.

    ``device=None`` decodes on the GPU and raises without CUDA.
    """

    def __init__(self, blob: bytes, device: DeviceLike = None):
        self._device = resolve_device(device)
        self._head = _cached_head(blob, self._device)

    @property
    def shape(self) -> tuple[int, int, int, int]:
        """(S, T, H, W) of the encoded field."""
        return self._head.shape

    @property
    def n_species(self) -> int:
        return self._head.shape[0]

    @property
    def version(self) -> int:
        return self._head.version

    def bytes_parsed(self, species=None, time_range=None) -> int:
        """Container bytes a ``decode(species=..., time_range=...)`` call
        touches.

        Counts the outer header/table, the selection-independent head
        streams (meta, decoder, correction, and on v4 the integrity
        stream — parsed whole at head decode), the latent extent the
        window walks (v3+: shard head + covering shard chains; v1/v2:
        the whole sequential chain regardless of the window), the
        guarantee directory, and the selected species' coeff/index/basis
        extents. With no selection this equals ``len(blob)`` on a v2+
        container — every byte is then accounted to a purpose.
        """
        head = self._head
        idx, _ = _normalize_species(species, head.shape[0])
        t0, t1 = _normalize_time_range(time_range, head.shape[1])
        _, _, b0, b1 = _window_rows(head, t0, t1)
        sizes = head.reader.stream_sizes()
        n = (
            head.reader.header_bytes
            + sizes["meta"]
            + head.latents.bytes_parsed(b0, b1)
            + sizes["decoder"]
            + sizes.get("correction", 0)
            + sizes.get("integrity", 0)
        )
        if head.version >= container_format.FORMAT_VERSION_SELECTIVE:
            gdir = _gdir(head)
            n += gdir.dir_bytes
            n += sum(gdir.species_extent_bytes(s) for s in idx)
        else:
            n += sum(sizes[f"guarantee{s}"] for s in idx)
        return n

    def latent_bytes_parsed(self, time_range=None) -> int:
        """Latent chain bytes a window decode entropy-decodes — the term
        container v3 makes O(window): only the shards covering the window
        walk, where v1/v2's single sequential chain always walks whole."""
        head = self._head
        t0, t1 = _normalize_time_range(time_range, head.shape[1])
        _, _, b0, b1 = _window_rows(head, t0, t1)
        return head.latents.entropy_bytes(b0, b1)

    def decode(self, species=None, time_range=None,
               on_error: str = "raise"):
        """Decode a (species, time-window) slice of the stored field.

        Returns ``(len(species), t1 - t0, H, W)`` float32 (the species
        axis squeezed when ``species`` is a single integer), bitwise equal
        to the same slice of the full decode.

        On a v4+ container the slice verifies exactly what it reads — the
        covering latent shards and the selected species' guarantee
        extents digest-check before decode, unread units pay nothing.
        ``on_error="salvage"`` quarantines corrupt units instead of
        raising and returns ``(field, DecodeReport)`` (see
        :func:`repro_torch.codec.integrity.salvage_decompress`); a raise-mode
        failure evicts this blob's shared cached head (healthy units
        already decoded through *this* decoder instance remain usable).
        """
        if on_error not in ("raise", "salvage"):
            raise ValueError(
                f"on_error must be 'raise' or 'salvage', got {on_error!r}"
            )
        if on_error == "salvage":
            from repro_torch.codec.integrity import salvage_decompress

            return salvage_decompress(
                self._head.blob, species=species, time_range=time_range,
                device=self._device,
            )
        try:
            return self._decode(species, time_range)
        except ContainerFormatError:
            _evict_head(self._head.blob, self._device)
            raise

    def _decode(self, species, time_range) -> np.ndarray:
        head = self._head
        plan = plan_slice(head, species, time_range)

        # fused NN decode over the window's block rows only (async
        # launches in the full decode's geometry, so the slice is
        # bit-transparent). v3+: only the latent shards covering [b0, b1)
        # entropy-decode.
        lat32 = _latents32(
            head.latents.rows(plan.b0, plan.b1), head.latent_bin
        )
        vecs_dev = _fused_vecs(
            head.runtime, head.dec_state, head.corr_state, lat32,
            rows=(plan.b0, head.nb),
        )

        # selection queues on device; the replay stage's guarantee
        # entropy decode then runs on host while the device computes
        vecs_sel = vecs_dev[torch.as_tensor(plan.idx, device=vecs_dev.device)]
        vecs_sel = replay_slice(
            head, plan.idx, (plan.b0, plan.b1), vecs_sel
        )
        return finalize_slice(head, plan, vecs_sel)
