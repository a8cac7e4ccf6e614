"""The fitted-compression artifact: the codec's in-memory unit of work.

:class:`CompressedArtifact` is everything one fitted compression produced
— quantized latents, decode-side parameters, per-species guarantee
artifacts, normalization, shape, and the structural config — plus the
memoized wire streams a ``target_nrmse`` sweep shares across blobs. It
lives under :mod:`repro_torch.codec` (not the pipeline) because it *is* the
wire object: ``to_bytes``/``from_bytes`` are its container round-trip,
``byte_breakdown`` its measured stream accounting. The fit-side
orchestration that produces artifacts stays in
:mod:`repro_torch.core.pipeline`, which re-exports this class for
compatibility.

``cfg`` is any config-shaped object the family registry's
:func:`repro_torch.codec.families.structural` normalizer accepts (a
``PipelineConfig``, a ``StructuralConfig`` unpacked from a blob, ...);
the codec never reads training hyperparameters from it.

Module-level imports here stay clear of ``repro_torch.core`` — the core
package's ``__init__`` imports the pipeline, which imports this module,
so anything heavier than stdlib/numpy at import time would be a cycle.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Optional

import numpy as np

if TYPE_CHECKING:  # annotation-only; avoids the core-package cycle
    from repro_torch.core import gae


@dataclasses.dataclass
class CompressedArtifact:
    latent_q: np.ndarray  # (NB, latent) int64
    latent_bin: float
    # reference-layout numpy parameter trees (what the wire carries; see
    # repro_torch.convert for the PyTorch layouts the models run on)
    ae_params: Any
    corr_params: Optional[Any]
    species_guarantees: "list[gae.GuaranteeArtifact]"
    norm_min: np.ndarray  # (S,)
    norm_range: np.ndarray  # (S,)
    shape: tuple[int, int, int, int]
    cfg: Any
    # memoized wire streams (immutable once built): the Huffman'd latent
    # payload, pre-packed (decoder, correction) parameter streams shared
    # across a sweep's artifacts, and the full serialized container
    _latent_blob: Optional[bytes] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    _param_streams: Optional[tuple] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    _wire: Optional[bytes] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    # shared latent wire memo: a target_nrmse sweep emits many artifacts
    # off one fitted model with bit-identical latents, so the pipeline
    # hands every artifact of a sweep key the same dict and the entropy
    # pack (single chain or sharded) is paid once per layout, not per blob
    _latent_memo: Optional[dict] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    # a mesh fit's latent_q as its shards' row blocks: the sharded stream
    # packs them as parts, byte-identical to packing latent_q whole
    _latent_parts: Optional[list] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def latent_blob(self) -> bytes:
        """Single sequential Huffman chain (the v1/v2 ``latent`` stream)."""
        if self._latent_blob is None:
            memo = self._latent_memo
            hit = memo.get("chain") if memo is not None else None
            if hit is None:
                from repro_torch.core import entropy

                hit = entropy.huffman_encode(self.latent_q)
                if memo is not None:
                    memo["chain"] = hit
            self._latent_blob = hit
        return self._latent_blob

    def sharded_latent_stream(self, shard_rows: int) -> bytes:
        """Time-sharded segmented stream (the v3+ ``latent`` stream),
        memoized per shard size across a sweep's artifacts."""
        memo = self._latent_memo
        # the packer clamps shard_rows to the row count, so clamp the key
        # too: every oversized request is the same single-shard stream
        shard_rows = min(max(int(shard_rows), 1), self.latent_q.shape[0])
        key = ("sharded", shard_rows)
        if memo is not None and key in memo:
            return memo[key]
        from repro_torch import codec

        stream = codec.pack_latent_stream(
            self.latent_q if self._latent_parts is None else self._latent_parts,
            shard_rows)
        if memo is not None:
            memo[key] = stream
        return stream

    def to_bytes(self) -> bytes:
        """Serialize to the self-describing container (see repro_torch.codec)."""
        if self._wire is None:
            from repro_torch import codec

            self._wire = codec.encode(self)
        return self._wire

    @classmethod
    def from_bytes(cls, blob: bytes) -> "CompressedArtifact":
        """Rebuild an artifact from container bytes (repro_torch.codec wire format)."""
        from repro_torch import codec

        return codec.decode_artifact(blob)

    def byte_breakdown(
        self, model: Optional[Any] = None, corr_net: Optional[Any] = None
    ) -> dict:
        """Measured per-stream byte accounting of the serialized container.

        A view over the container's stream table — every entry is the real
        on-wire length and ``breakdown["total"] == len(self.to_bytes())``
        exactly. ``model``/``corr_net`` are accepted for backward
        compatibility but unused: the container carries the parameter
        streams itself.
        """
        del model, corr_net
        from repro_torch import codec

        return codec.stream_breakdown(self.to_bytes())
